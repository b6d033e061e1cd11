"""Branch-free G1/G2 group ops in plain PyTorch, mirroring teku_tpu/ops/points.py.

Jacobian coordinates, total functions (infinity, P == Q and P == -Q
are computed and selected lane-wise), the same add-2007-bl /
dbl-2009-l formulas and selects as the reference, so Jacobian outputs
agree with it bit for bit.  Subgroup checks use the endomorphism
identities phi(P) == [-z^2]P (G1) and psi(Q) == [z]Q (G2).
"""

from typing import NamedTuple

import torch

from ..crypto.bls import fields as F
from ..crypto.bls.constants import B_G1, B_G2, P, X_ABS
from . import limbs as fp
from . import towers as T


class FieldKit(NamedTuple):
    add: callable
    sub: callable
    mul: callable
    neg: callable
    is_zero: callable
    select: callable
    const: callable       # host int (G1) / int pair (G2) -> numpy constant
    bcast: callable       # numpy constant, like-element -> element
    stack: callable
    unstack: callable
    zero_many: callable
    compress: callable


def _fp_stack(elems):
    return torch.stack(torch.broadcast_tensors(*elems), dim=-2)


def _fp_unstack(s):
    return [s[..., i, :] for i in range(s.shape[-2])]


def _fp_zero_many(elems):
    c = fp.canonical(_fp_stack(elems))
    z = torch.all(c == 0, dim=-1)
    return [z[..., i] for i in range(len(elems))]


def _fq2_zero_many(elems):
    c = fp.canonical(_fp_stack([comp for e in elems for comp in e]))
    z = torch.all(c == 0, dim=-1)
    return [z[..., 2 * i] & z[..., 2 * i + 1] for i in range(len(elems))]


_CONSTS: dict = {}


def _fp_const(v: int):
    c = _CONSTS.get(("fp", v))
    if c is None:
        c = _CONSTS[("fp", v)] = fp.int_to_mont(v)
    return c


def _fq2_const(v):
    c = _CONSTS.get(("fq2", v))
    if c is None:
        c = _CONSTS[("fq2", v)] = T.fq2_const(v)
    return c


G1_KIT = FieldKit(
    add=fp.add, sub=fp.sub, mul=fp.mont_mul, neg=fp.neg, is_zero=fp.is_zero,
    select=fp.select, const=_fp_const, bcast=fp.bcast, stack=_fp_stack,
    unstack=_fp_unstack, zero_many=_fp_zero_many, compress=fp.compress,
)

G2_KIT = FieldKit(
    add=T.fq2_add, sub=T.fq2_sub, mul=T.fq2_mul, neg=T.fq2_neg,
    is_zero=T.fq2_is_zero, select=T.fq2_select, const=_fq2_const,
    bcast=T._bcast2, stack=T._fq2s, unstack=T._fq2u,
    zero_many=_fq2_zero_many, compress=T.fq2_compress,
)


def _leaf(x):
    while isinstance(x, tuple):
        x = x[0]
    return x


def infinity_like(k: FieldKit, x):
    """Infinity (1, 1, 0) with the batch shape of field element x."""
    one = k.bcast(k.const(1 if k is G1_KIT else (1, 0)),
                  x if k is G1_KIT else x)
    zero = fp.tree_map(torch.zeros_like, one)
    return (one, one, zero)


def is_infinity(k: FieldKit, p):
    return k.is_zero(p[2])


def point_neg(k: FieldKit, p):
    return (p[0], k.neg(p[1]), p[2])


def _select_point(k: FieldKit, cond, a, b):
    return tuple(k.select(cond, x, y) for x, y in zip(a, b))


def point_double(k: FieldKit, p):
    X1, Y1, Z1 = p
    A, B, YZ = k.unstack(k.mul(k.stack([X1, Y1, Y1]),
                               k.stack([X1, Y1, Z1])))
    XB, E = k.unstack(k.compress(k.stack(
        [k.add(X1, B), k.add(k.add(A, A), A)])))
    XB2, C, Fv = k.unstack(k.mul(k.stack([XB, B, E]),
                                 k.stack([XB, B, E])))
    D = k.sub(k.sub(XB2, A), C)
    D = k.add(D, D)
    D, X3 = k.unstack(k.compress(k.stack([D, k.sub(Fv, k.add(D, D))])))
    C2 = k.add(C, C)
    C4 = k.add(C2, C2)
    C8 = k.add(C4, C4)
    Y3 = k.sub(k.mul(E, k.sub(D, X3)), C8)
    Z3 = k.add(YZ, YZ)
    X3, Y3, Z3 = k.unstack(k.compress(k.stack([X3, Y3, Z3])))
    return (X3, Y3, Z3)


def point_add(k: FieldKit, p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2, Z1Z2 = k.unstack(k.mul(k.stack([Z1, Z2, Z1]),
                                       k.stack([Z1, Z2, Z2])))
    U1, U2, Z2c, Z1c = k.unstack(k.mul(
        k.stack([X1, X2, Z2, Z1]),
        k.stack([Z2Z2, Z1Z1, Z2Z2, Z1Z1])))
    S1, S2 = k.unstack(k.mul(k.stack([Y1, Y2]), k.stack([Z2c, Z1c])))
    H = k.sub(U2, U1)
    sdiff = k.sub(S2, S1)
    H, rr = k.unstack(k.compress(k.stack([H, k.add(sdiff, sdiff)])))
    H2 = k.add(H, H)
    I, R2 = k.unstack(k.mul(k.stack([H2, rr]), k.stack([H2, rr])))
    J, V, ZZH = k.unstack(k.mul(
        k.stack([H, U1, k.add(Z1Z2, Z1Z2)]),
        k.stack([I, I, H])))
    X3 = k.sub(k.sub(R2, J), k.add(V, V))
    RVX, S1J = k.unstack(k.mul(k.stack([rr, S1]),
                               k.stack([k.sub(V, X3), J])))
    Y3 = k.sub(RVX, k.add(S1J, S1J))
    out = tuple(k.unstack(k.compress(k.stack([X3, Y3, ZZH]))))

    same_x, same_y, p_inf, q_inf = k.zero_many([H, sdiff, Z1, Z2])
    finite = (~p_inf) & (~q_inf)
    dbl = point_double(k, p)
    use_dbl = finite & same_x & same_y
    to_inf = finite & same_x & ~same_y
    out = _select_point(k, use_dbl, dbl, out)
    out = (out[0], out[1], k.select(to_inf, k.sub(out[2], out[2]), out[2]))
    out = _select_point(k, p_inf, q, out)
    out = _select_point(k, q_inf & ~p_inf, p, out)
    return out


def point_eq(k: FieldKit, p, q):
    Z1Z1, Z2Z2 = k.unstack(k.mul(k.stack([p[2], q[2]]),
                                 k.stack([p[2], q[2]])))
    Z2c, Z1c = k.unstack(k.mul(k.stack([q[2], p[2]]),
                               k.stack([Z2Z2, Z1Z1])))
    m = k.unstack(k.mul(k.stack([p[0], q[0], p[1], q[1]]),
                        k.stack([Z2Z2, Z1Z1, Z2c, Z1c])))
    x_eq, y_eq, p_inf, q_inf = k.zero_many(
        [k.sub(m[0], m[1]), k.sub(m[2], m[3]), p[2], q[2]])
    return (x_eq & y_eq & ~(p_inf ^ q_inf)) | (p_inf & q_inf)


# --------------------------------------------------------------------------
# Scalar multiplication
# --------------------------------------------------------------------------

SCALAR_WINDOW = 4


def _gather_rows(table, d):
    """table: list of points (rows); d: (...,) digit tensor -> point."""
    def pick(*leaves):
        stacked = torch.stack(torch.broadcast_tensors(*leaves), dim=0)
        idx = d[None, ..., None].expand((1,) + stacked.shape[1:])
        return torch.gather(stacked, 0, idx)[0]
    return _tree_zip(pick, table)


def _tree_zip(fn, trees):
    if isinstance(trees[0], tuple):
        return tuple(_tree_zip(fn, [t[i] for t in trees])
                     for i in range(len(trees[0])))
    return fn(*trees)


def scalar_mul_bits(k: FieldKit, bits, p, window: int = SCALAR_WINDOW):
    """[s]P for runtime scalars given as (..., NBITS) bits, MSB first:
    the reference's fixed-window ladder (table of 2^w rows built by
    successive adds from infinity, w doubles + one gathered add/digit)."""
    nbits = bits.shape[-1]
    pad = -nbits % window
    if pad:
        bits = torch.cat([torch.zeros(bits.shape[:-1] + (pad,),
                                      dtype=bits.dtype, device=bits.device),
                          bits], dim=-1)
    table = [infinity_like(k, p[0])]
    for _ in range((1 << window) - 1):
        table.append(point_add(k, table[-1], p))
    weights = torch.tensor([1 << (window - 1 - t) for t in range(window)],
                           dtype=bits.dtype, device=bits.device)
    digits = (bits.reshape(bits.shape[:-1] + (-1, window)) * weights).sum(-1)
    acc = _gather_rows(table, digits[..., 0])
    for w in range(1, digits.shape[-1]):
        for _ in range(window):
            acc = point_double(k, acc)
        acc = point_add(k, acc, _gather_rows(table, digits[..., w]))
    return acc


def scalar_mul_static(k: FieldKit, e: int, p):
    """[e]P for a static exponent with few one-bits: doubles, and an
    add only at each one-bit (the BLS parameter has weight 6)."""
    assert e >= 0
    if e == 0:
        return infinity_like(k, p[0])
    acc = p
    for c in bin(e)[3:]:
        acc = point_double(k, acc)
        if c == "1":
            acc = point_add(k, acc, p)
    return acc


def point_batch_sum(k: FieldKit, p):
    """Sum over the leading axis by log-depth pairwise adds."""
    n = _leaf(p).shape[0]
    while n > 1:
        half = n // 2
        odd = n - 2 * half
        a = fp.tree_map(lambda x: x[:half], p)
        b = fp.tree_map(lambda x: x[half:2 * half], p)
        s = point_add(k, a, b)
        if odd:
            tail = fp.tree_map(lambda x: x[2 * half:], p)
            p = fp.tree_map2(lambda x, y: torch.cat([x, y], dim=0), s, tail)
            n = half + 1
        else:
            p = s
            n = half
    return fp.tree_map(lambda x: x[0], p)


def scalar_from_uint64(vals):
    """int64 tensor of uint64 bit patterns (...,) -> (..., 64) bits MSB first."""
    shifts = torch.arange(63, -1, -1, device=vals.device)
    return (vals[..., None] >> shifts) & 1


# --------------------------------------------------------------------------
# Endomorphisms + subgroup checks
# --------------------------------------------------------------------------

BETA = pow(2, (P - 1) // 3, P)
_PSI_X = F.fq2_inv(F.FROB6_C1)
_PSI_Y = F.fq2_inv(F.fq2_mul(F.fq2_mul(F.FROB12_C1, F.FROB12_C1), F.FROB12_C1))
_BETA_M = fp.int_to_mont(BETA)
_PSI_XM = T.fq2_const(_PSI_X)
_PSI_YM = T.fq2_const(_PSI_Y)


def g1_phi(p):
    return (fp.mont_mul(p[0], fp.const(_BETA_M, p[0].device)), p[1], p[2])


def g2_psi(q):
    return (T.fq2_mul(T.fq2_conj(q[0]), T._bcast2(_PSI_XM, q[0])),
            T.fq2_mul(T.fq2_conj(q[1]), T._bcast2(_PSI_YM, q[1])),
            T.fq2_conj(q[2]))


def g1_in_subgroup(p):
    lhs = g1_phi(p)
    rhs = point_neg(G1_KIT, scalar_mul_static(G1_KIT, X_ABS * X_ABS, p))
    return point_eq(G1_KIT, lhs, rhs) | is_infinity(G1_KIT, p)


def g2_in_subgroup(q):
    lhs = g2_psi(q)
    rhs = point_neg(G2_KIT, scalar_mul_static(G2_KIT, X_ABS, q))
    return point_eq(G2_KIT, lhs, rhs) | is_infinity(G2_KIT, q)


_HALF = fp.int_to_limbs((P - 1) // 2)


def g1_recover_y(x_plain, y_is_large):
    """Batched G1 decompression from plain-form x limbs: (ok, point)."""
    x = fp.to_mont(x_plain)
    b = fp.bcast(_fp_const(B_G1), x)
    rhs = fp.mont_mul(fp.mont_sqr(x), x) + b
    y = fp.sqrt_candidate(rhs)
    ok = fp.eq(fp.mont_sqr(y), rhs)
    large = fp.gt(fp.from_mont(y), fp.const(_HALF, x.device))
    y = fp.select(large == y_is_large, y, -y)
    return ok, (x, y, fp.bcast(fp.ONE_MONT, x))


def g2_recover_y(x_plain, y_is_large):
    """Batched G2 decompression from plain Fq2 x limbs (c0, c1)."""
    x = (fp.to_mont(x_plain[0]), fp.to_mont(x_plain[1]))
    b = T._bcast2(_fq2_const(B_G2), x)
    rhs = T.fq2_add(T.fq2_mul(T.fq2_sqr(x), x), b)
    ok, y = T.fq2_sqrt(rhs)
    y = T.fq2_compress(y)
    large = T.fq2_is_large(T.fq2_from_mont(y))
    y = T.fq2_select(large == y_is_large, y, T.fq2_neg(y))
    return ok, (x, y, T._bcast2(_fq2_const((1, 0)), x))
