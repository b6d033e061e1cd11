"""BLS12-381 extension towers in plain PyTorch, mirroring teku_tpu/ops/towers.py.

Fq2 = Fq[u]/(u^2+1) as a tuple (c0, c1) of limb tensors; Fq6 =
Fq2[v]/(v^3-xi), xi = 1+u, as a 3-tuple of Fq2; Fq12 = Fq6[w]/(w^2-v)
as a 2-tuple of Fq6.  Same algorithms, same batching of independent
base-field multiplies into one wide ``mont_mul``, same compress points
as the reference, so values agree with it bit for bit.
"""

import torch

from ..crypto.bls import fields as F
from ..crypto.bls.constants import P
from . import limbs as fp


def fq2_const(c) -> tuple:
    """Host: oracle Fq2 int pair -> Montgomery limb constant pair."""
    return (fp.int_to_mont(c[0]), fp.int_to_mont(c[1]))


FQ2_ZERO_NP = fq2_const((0, 0))
FQ2_ONE_NP = fq2_const((1, 0))

FROB6_C1 = fq2_const(F.FROB6_C1)
FROB6_C2 = fq2_const(F.FROB6_C2)
FROB12_C1 = fq2_const(F.FROB12_C1)

_SQRT_M1 = F.fq2_sqrt((P - 1, 0))
_SQRT_C2 = F.fq2_sqrt(_SQRT_M1)
_SQRT_C3 = F.fq2_sqrt(F.fq2_neg(_SQRT_M1))
SQRT_EXP = (P * P + 7) // 16
_SQRT_CONSTS = [fq2_const(c) for c in (_SQRT_M1, _SQRT_C2, _SQRT_C3)]
_HALF = fp.int_to_limbs((P - 1) // 2)


def _bcast2(c, like):
    """Broadcast an Fq2 numpy constant to the batch shape of `like`."""
    return (fp.bcast(c[0], like[0]), fp.bcast(c[1], like[0]))


# --------------------------------------------------------------------------
# Lane stacking helpers
# --------------------------------------------------------------------------

def _stk(*xs):
    return torch.stack(torch.broadcast_tensors(*xs), dim=-2)


def _fq2s(elems):
    return (_stk(*[e[0] for e in elems]), _stk(*[e[1] for e in elems]))


def _fq2u(s):
    n = s[0].shape[-2]
    return [(s[0][..., i, :], s[1][..., i, :]) for i in range(n)]


def tree_stack(elems):
    """Stack nested tuples along a new LEADING axis."""
    if isinstance(elems[0], tuple):
        return tuple(tree_stack([e[i] for e in elems])
                     for i in range(len(elems[0])))
    return torch.stack(torch.broadcast_tensors(*elems), dim=0)


def tree_unstack(t, n):
    return [fp.tree_map(lambda x: x[i], t) for i in range(n)]


def _flat12(a):
    return [c for six in a for two in six for c in two]


def _nest12(out):
    return (((out[0], out[1]), (out[2], out[3]), (out[4], out[5])),
            ((out[6], out[7]), (out[8], out[9]), (out[10], out[11])))


def fq2_compress(a):
    t = fp.compress(_stk(a[0], a[1]))
    return (t[..., 0, :], t[..., 1, :])


def fq6_compress(a):
    t = fp.compress(_stk(a[0][0], a[0][1], a[1][0], a[1][1],
                         a[2][0], a[2][1]))
    return ((t[..., 0, :], t[..., 1, :]), (t[..., 2, :], t[..., 3, :]),
            (t[..., 4, :], t[..., 5, :]))


def fq12_compress(a):
    t = fp.compress(_stk(*_flat12(a)))
    return _nest12([t[..., i, :] for i in range(12)])


def fq12_reduce_value(a):
    """Re-bound each component's VALUE to (-P, 2P): multiply by R."""
    comps = _stk(*_flat12(a))
    t = fp.mont_mul(comps, fp.const(fp.ONE_MONT, comps.device))
    return _nest12([t[..., i, :] for i in range(12)])


# --------------------------------------------------------------------------
# Fq2
# --------------------------------------------------------------------------

def fq2_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def fq2_sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def fq2_neg(a):
    return (-a[0], -a[1])


def fq2_mul(a, b):
    t = fp.mont_mul(_stk(a[0], a[1], a[0] + a[1]),
                    _stk(b[0], b[1], b[0] + b[1]))
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    return (t0 - t1, (t2 - t0) - t1)


def fq2_sqr(a):
    t = fp.mont_mul(_stk(a[0] + a[1], a[0]), _stk(a[0] - a[1], a[1]))
    return (t[..., 0, :], fp.double(t[..., 1, :]))


def fq2_conj(a):
    return (a[0], -a[1])


def fq2_mul_by_xi(a):
    return (a[0] - a[1], a[0] + a[1])


def fq2_inv(a):
    """Branch-free inverse, inv(0) == 0; one batched Fermat (inv_many)."""
    sq = fp.mont_sqr(_stk(a[0], a[1]))
    norm = fp.compress(sq[..., 0, :] + sq[..., 1, :])
    ninv = fp.inv_many(norm)
    t = fp.mont_mul(_stk(a[0], a[1]), ninv[..., None, :])
    return (t[..., 0, :], -t[..., 1, :])


def fq2_is_zero(a):
    c = fp.canonical(_stk(a[0], a[1]))
    return torch.all(torch.all(c == 0, dim=-1), dim=-1)


def fq2_eq(a, b):
    return fq2_is_zero(fq2_sub(a, b))


def fq2_select(cond, a, b):
    return (fp.select(cond, a[0], b[0]), fp.select(cond, a[1], b[1]))


def fq2_pow_static(a, e: int):
    """a^e, bit-serial: 1 sqr + 1 selected mul per bit (as the reference,
    whose scan computes the discarded multiply too)."""
    assert e > 0
    a = fq2_compress(a)
    acc = a
    for bit in bin(e)[3:]:
        acc = fq2_sqr(acc)
        if bit == "1":
            acc = fq2_mul(acc, a)
    return acc


def fq2_sqrt(a):
    """Branch-free Fq2 square root (q = 9 mod 16): (ok, root)."""
    a = fq2_compress(a)
    cand = fq2_pow_static(a, SQRT_EXP)
    cands = [cand] + [fq2_mul(_bcast2(c, cand), cand) for c in _SQRT_CONSTS]
    sq = fq2_sqr(_fq2s(cands))
    d = fq2_sub(sq, (a[0][..., None, :], a[1][..., None, :]))
    zc = fp.canonical(torch.stack([d[0], d[1]], dim=-2))
    matches = torch.all(torch.all(zc == 0, dim=-1), dim=-1)
    found = torch.zeros(matches.shape[:-1], dtype=torch.bool,
                        device=matches.device)
    root = cand
    for i in range(4):
        m = matches[..., i] & ~found
        root = fq2_select(m, cands[i], root)
        found = found | m
    return found, root


def fq2_is_large(a_plain):
    """Lexicographic 'larger root' on canonical plain limbs (sign bit)."""
    half = fp.const(_HALF, a_plain[0].device)
    zero1 = torch.all(a_plain[1] == 0, dim=-1)
    large1 = fp.gt(a_plain[1], half)
    return large1 | (zero1 & fp.gt(a_plain[0], half))


def fq2_from_mont(a):
    t = fp.canonical_plain(_stk(a[0], a[1]))
    return (t[..., 0, :], t[..., 1, :])


# --------------------------------------------------------------------------
# Fq6
# --------------------------------------------------------------------------

def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    A = _fq2s([a0, a1, a2, fq2_add(a1, a2), fq2_add(a0, a1), fq2_add(a0, a2)])
    B = _fq2s([b0, b1, b2, fq2_add(b1, b2), fq2_add(b0, b1), fq2_add(b0, b2)])
    t0, t1, t2, s12, s01, s02 = _fq2u(fq2_mul(A, B))
    c0 = fq2_add(t0, fq2_mul_by_xi(fq2_sub(fq2_sub(s12, t1), t2)))
    c1 = fq2_add(fq2_sub(fq2_sub(s01, t0), t1), fq2_mul_by_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_sub(s02, t0), t2), t1)
    return (c0, c1, c2)


def fq6_sqr(a):
    a0, a1, a2 = a
    m = fq2_add(fq2_sub(a0, a1), a2)
    A = _fq2s([a0, a0, m, a1, a2])
    B = _fq2s([a0, a1, m, a2, a2])
    s0, s1, s2, s3, s4 = _fq2u(fq2_mul(A, B))
    s1 = fq2_add(s1, s1)
    s3 = fq2_add(s3, s3)
    c0 = fq2_add(s0, fq2_mul_by_xi(s3))
    c1 = fq2_add(s1, fq2_mul_by_xi(s4))
    c2 = fq2_sub(fq2_add(fq2_add(s1, s2), s3), fq2_add(s0, s4))
    return (c0, c1, c2)


def fq6_mul_by_v(a):
    return (fq2_mul_by_xi(a[2]), a[0], a[1])


def fq6_mul_by_fq2(a, s):
    t = _fq2u(fq2_mul(_fq2s([a[0], a[1], a[2]]), _fq2s([s, s, s])))
    return (t[0], t[1], t[2])


def fq6_inv(a):
    a0, a1, a2 = a
    sq0, sq2, sq1, m12, m01, m02 = _fq2u(fq2_mul(
        _fq2s([a0, a2, a1, a1, a0, a0]), _fq2s([a0, a2, a1, a2, a1, a2])))
    t0 = fq2_sub(sq0, fq2_mul_by_xi(m12))
    t1 = fq2_sub(fq2_mul_by_xi(sq2), m01)
    t2 = fq2_sub(sq1, m02)
    n3 = _fq2u(fq2_mul(_fq2s([a0, a2, a1]), _fq2s([t0, t1, t2])))
    norm = fq2_add(n3[0], fq2_mul_by_xi(fq2_add(n3[1], n3[2])))
    ninv = fq2_compress(fq2_inv(norm))
    out = _fq2u(fq2_mul(_fq2s([t0, t1, t2]), _fq2s([ninv, ninv, ninv])))
    return (out[0], out[1], out[2])


def fq6_select(cond, a, b):
    return tuple(fq2_select(cond, x, y) for x, y in zip(a, b))


def fq6_frobenius(a):
    t = _fq2u(fq2_mul(_fq2s([fq2_conj(a[1]), fq2_conj(a[2])]),
                      _fq2s([_bcast2(FROB6_C1, a[1]),
                             _bcast2(FROB6_C2, a[2])])))
    return (fq2_conj(a[0]), t[0], t[1])


# --------------------------------------------------------------------------
# Fq12 -- unit inputs, compressed outputs
# --------------------------------------------------------------------------

def fq12_ones(like):
    """Fq12 one with the batch shape of limb tensor `like` (..., L)."""
    one = (fp.bcast(FQ2_ONE_NP[0], like), fp.bcast(FQ2_ONE_NP[1], like))
    zero2 = (fp.bcast(FQ2_ZERO_NP[0], like), fp.bcast(FQ2_ZERO_NP[1], like))
    return ((one, zero2, zero2), (zero2, zero2, zero2))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    A = tree_stack([a0, a1, fq6_add(a0, a1)])
    B = tree_stack([b0, b1, fq6_add(b0, b1)])
    t0, t1, t2 = tree_unstack(fq6_mul(A, B), 3)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_sub(t2, t0), t1)
    return fq12_compress((c0, c1))


def fq12_sqr(a):
    a0, a1 = a
    A = tree_stack([a0, fq6_add(a0, a1)])
    B = tree_stack([a1, fq6_add(a0, fq6_mul_by_v(a1))])
    t, u = tree_unstack(fq6_mul(A, B), 2)
    c0 = fq6_sub(u, fq6_add(t, fq6_mul_by_v(t)))
    c1 = fq6_add(t, t)
    return fq12_compress((c0, c1))


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_cyclo_sqr(a):
    """Granger-Scott squaring for cyclotomic elements."""
    (g0, g1, g2), (h0, h1, h2) = a
    A = _fq2s([g0, g0, h1, h0, h0, g2, g1, g1, h2])
    B = _fq2s([h1, g0, h1, g2, h0, g2, h2, g1, h2])
    ta, sa, sb, tb, sc, sd, tc, se, sf = _fq2u(fq2_mul(A, B))

    def fp4(t, s_hi, s_lo):
        return (fq2_add(s_hi, fq2_mul_by_xi(s_lo)), fq2_add(t, t))

    a0, a1 = fp4(ta, sa, sb)
    b0, b1 = fp4(tb, sc, sd)
    c0, c1 = fp4(tc, se, sf)
    sc0, sc1 = fq2_mul_by_xi(c1), c0

    def triple(x):
        return fq2_add(fq2_add(x, x), x)

    def comb(s0, s1, o0, o1, sign):
        t0, t1 = triple(s0), triple(s1)
        d0 = fq2_add(o0, o0)
        d1 = fq2_add(o1, o1)
        if sign > 0:
            return (fq2_add(t0, d0), fq2_sub(t1, d1))
        return (fq2_sub(t0, d0), fq2_add(t1, d1))

    B0 = comb(a0, a1, g0, h1, -1)
    B1 = comb(sc0, sc1, h0, g2, +1)
    B2 = comb(b0, b1, g1, h2, -1)
    return fq12_reduce_value(((B0[0], B2[0], B1[1]), (B1[0], B0[1], B2[1])))


def fq12_inv(a):
    a0, a1 = a
    s0, s1 = tree_unstack(fq6_sqr(tree_stack([a0, a1])), 2)
    norm = fq6_compress(fq6_sub(s0, fq6_mul_by_v(s1)))
    ninv = fq6_compress(fq6_inv(norm))
    m0, m1 = tree_unstack(
        fq6_mul(tree_stack([a0, a1]), tree_stack([ninv, ninv])), 2)
    return fq12_compress((m0, fq6_neg(m1)))


def fq12_frobenius(a, power: int = 1):
    result = a
    for _ in range(power % 12):
        c0 = fq6_frobenius(result[0])
        c1 = fq6_frobenius(result[1])
        c1 = fq6_mul_by_fq2(c1, _bcast2(FROB12_C1, c1[0]))
        result = fq12_compress((c0, c1))
    return result


def fq12_eq(a, b):
    d = _flat12((fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1])))
    c = fp.canonical(_stk(*d))
    return torch.all(torch.all(c == 0, dim=-1), dim=-1)


def fq12_is_one(a):
    return fq12_eq(a, fq12_ones(a[0][0][0]))


def fq12_select(cond, a, b):
    return tuple(fq6_select(cond, x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------
# Host conversions (tests / boundaries)
# --------------------------------------------------------------------------

def fq2_from_device(a, index=()) -> tuple:
    return (fp.mont_to_int(a[0][index]), fp.mont_to_int(a[1][index]))


def fq12_from_device(a, index=()):
    return tuple(tuple(fq2_from_device(x, index) for x in six) for six in a)


def fq12_to_words(a):
    """Fq12 Montgomery limbs -> canonical plain words (..., 12, NW):
    component order c0.c0.c0, c0.c0.c1, c0.c1.c0, ... (the kernels')."""
    return fp.to_words(_stk(*_flat12(a)))


def fq12_from_words(w):
    t = fp.from_words(w)
    return _nest12([t[..., i, :] for i in range(12)])
