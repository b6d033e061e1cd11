"""Batched optimal ate pairing in plain PyTorch, mirroring teku_tpu/ops/pairing.py.

Miller loop in Jacobian coordinates on the twist with sparse line
multiplication (the reference's _dbl_step/_add_step/_mul_by_line
formulas, so Miller values agree with it bit for bit), a log-depth Fq12
product over rows, and the final exponentiation f^(3(p^12-1)/r): the
easy part, then the Hayashida-Hayasaka-Teruya x-chain on Granger-Scott
cyclotomic squarings.
"""

import torch

from ..crypto.bls.constants import X_ABS
from . import limbs as fp
from . import towers as T

_X_BITS = bin(X_ABS)[3:]


def _dbl_step(t, px_neg, py):
    X, Y, Z = t
    A, B, Z2 = T._fq2u(T.fq2_sqr(T._fq2s([X, Y, Z])))
    XB, E = T._fq2u(T.fq2_compress(T._fq2s(
        [T.fq2_add(X, B), T.fq2_add(T.fq2_add(A, A), A)])))
    XB2, Cc, Fv, YZ = T._fq2u(T.fq2_mul(T._fq2s([XB, B, E, Y]),
                                        T._fq2s([XB, B, E, Z])))
    D = T.fq2_sub(T.fq2_sub(XB2, A), Cc)
    D = T.fq2_add(D, D)
    Z3 = T.fq2_add(YZ, YZ)
    D, X3, Z3 = T._fq2u(T.fq2_compress(T._fq2s(
        [D, T.fq2_sub(Fv, T.fq2_add(D, D)), Z3])))
    C2 = T.fq2_add(Cc, Cc)
    C4 = T.fq2_add(C2, C2)
    C8 = T.fq2_add(C4, C4)
    EDX, Z3Z2, EX, EZ2 = T._fq2u(T.fq2_mul(
        T._fq2s([E, Z3, E, E]), T._fq2s([T.fq2_sub(D, X3), Z2, X, Z2])))
    Y3 = T.fq2_sub(EDX, C8)
    X3, Y3, Z3 = T._fq2u(T.fq2_compress(T._fq2s([X3, Y3, Z3])))
    xiz = T.fq2_mul_by_xi(Z3Z2)
    sc = fp.mont_mul(T._stk(xiz[0], xiz[1], EZ2[0], EZ2[1]),
                     T._stk(py, py, px_neg, px_neg))
    c0 = (sc[..., 0, :], sc[..., 1, :])
    c1 = T.fq2_sub(EX, T.fq2_add(B, B))
    c2 = (sc[..., 2, :], sc[..., 3, :])
    return (X3, Y3, Z3), (c0, c1, c2)


def _add_step(t, q, px_neg, py):
    X, Y, Z = t
    xq, yq = q
    Z2 = T.fq2_sqr(Z)
    U2, Z3cu = T._fq2u(T.fq2_mul(T._fq2s([xq, Z2]), T._fq2s([Z2, Z])))
    S2 = T.fq2_mul(yq, Z3cu)
    H, r = T._fq2u(T.fq2_compress(T._fq2s(
        [T.fq2_sub(U2, X), T.fq2_sub(S2, Y)])))
    H2, R2, Z3 = T._fq2u(T.fq2_mul(T._fq2s([H, r, Z]), T._fq2s([H, r, H])))
    H3, V, RXQ, YQZ3 = T._fq2u(T.fq2_mul(T._fq2s([H, X, r, yq]),
                                         T._fq2s([H2, H2, xq, Z3])))
    X3 = T.fq2_sub(T.fq2_sub(R2, H3), T.fq2_add(V, V))
    r4 = T._fq2u(T.fq2_mul(T._fq2s([r, Y]),
                           T._fq2s([T.fq2_sub(V, X3), H3])))
    Y3 = T.fq2_sub(r4[0], r4[1])
    X3, Y3, Z3 = T._fq2u(T.fq2_compress(T._fq2s([X3, Y3, Z3])))
    xiz3 = T.fq2_mul_by_xi(Z3)
    sc = fp.mont_mul(T._stk(xiz3[0], xiz3[1], r[0], r[1]),
                     T._stk(py, py, px_neg, px_neg))
    c0 = (sc[..., 0, :], sc[..., 1, :])
    c1 = T.fq2_sub(RXQ, YQZ3)
    c2 = (sc[..., 2, :], sc[..., 3, :])
    return (X3, Y3, Z3), (c0, c1, c2)


def _mul_by_line(f, line):
    """f * (c0 + (c1 v + c2 v^2) w), all 18 fq2 multiplies in one call."""
    c0, c1, c2 = line
    f0, f1 = f
    A = T._fq2s([f1[1], f1[2], f1[0], f1[2], f1[0], f1[1],
                 f0[1], f0[2], f0[0], f0[2], f0[0], f0[1],
                 f0[0], f0[1], f0[2], f1[0], f1[1], f1[2]])
    B = T._fq2s([c2, c1, c1, c2, c2, c1,
                 c2, c1, c1, c2, c2, c1,
                 c0, c0, c0, c0, c0, c0])
    p = T._fq2u(T.fq2_mul(A, B))

    def sparse_combine(m):
        return (T.fq2_mul_by_xi(T.fq2_add(m[0], m[1])),
                T.fq2_add(m[2], T.fq2_mul_by_xi(m[3])),
                T.fq2_add(m[4], m[5]))

    t1 = sparse_combine(p[0:6])
    s0 = sparse_combine(p[6:12])
    res0 = T.fq6_add((p[12], p[13], p[14]),
                     (T.fq2_mul_by_xi(t1[2]), t1[0], t1[1]))
    res1 = T.fq6_add(s0, (p[15], p[16], p[17]))
    return T.fq12_compress((res0, res1))


def miller_loop(p, q, mask=None):
    """p: affine G1 (x, y) limbs; q: affine G2 ((x0, x1), (y0, y1)).
    Lanes where mask is False give ONE.  Output conjugated (z < 0)."""
    px, py = p
    px_neg = -px
    t = (q[0], q[1], T._bcast2(T.FQ2_ONE_NP, q[0]))
    f = T.fq12_ones(px)
    for bit in _X_BITS:
        f = T.fq12_sqr(f)
        t, line = _dbl_step(t, px_neg, py)
        f = _mul_by_line(f, line)
        if bit == "1":
            t, line = _add_step(t, q, px_neg, py)
            f = _mul_by_line(f, line)
    f = T.fq12_conj(f)
    if mask is not None:
        f = T.fq12_select(mask, f, T.fq12_ones(px))
    return f


def batch_product(f):
    """Product over the leading axis by log-depth pairwise multiplies."""
    n = f[0][0][0].shape[0]
    while n > 1:
        half = n // 2
        odd = n - 2 * half
        a = fp.tree_map(lambda x: x[:half], f)
        b = fp.tree_map(lambda x: x[half:2 * half], f)
        prod = T.fq12_mul(a, b)
        if odd:
            tail = fp.tree_map(lambda x: x[2 * half:], f)
            f = fp.tree_map2(lambda x, y: torch.cat([x, y], dim=0),
                             prod, tail)
            n = half + 1
        else:
            f = prod
            n = half
    return fp.tree_map(lambda x: x[0], f)


def _cyclo_pow_abs_x(f):
    result = f
    for bit in _X_BITS:
        result = T.fq12_cyclo_sqr(result)
        if bit == "1":
            result = T.fq12_mul(result, f)
    return result


def _pow_z(f):
    return T.fq12_conj(_cyclo_pow_abs_x(f))


def final_exponentiation(f):
    """f^(3*(p^12-1)/r): the oracle's chain (crypto/bls/pairing.py)."""
    g = T.fq12_mul(T.fq12_conj(f), T.fq12_inv(f))
    g = T.fq12_mul(T.fq12_frobenius(g, 2), g)
    a = T.fq12_mul(_pow_z(g), T.fq12_conj(g))
    a = T.fq12_mul(_pow_z(a), T.fq12_conj(a))
    b = T.fq12_mul(_pow_z(a), T.fq12_frobenius(a, 1))
    c = T.fq12_mul(T.fq12_mul(_pow_z(_pow_z(b)), T.fq12_frobenius(b, 2)),
                   T.fq12_conj(b))
    return T.fq12_mul(c, T.fq12_mul(T.fq12_sqr(g), g))


def pairing_check(f):
    return T.fq12_is_one(final_exponentiation(f))
