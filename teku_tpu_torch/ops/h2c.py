"""Batched hash-to-G2 in plain PyTorch, mirroring teku_tpu/ops/h2c.py.

RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_: the host expands each message
to two Fq2 draws (SHA-256, ``messages_to_fields`` over the port's own
copy of the oracle's hash_to_field); the field math -- divisionless
projective SSWU, the 3-isogeny, one shared inversion for the affine
conversion and sgn0, Budroni-Pintore cofactor clearing -- runs batched
and branch-free here, with the reference's formulas.
"""

import numpy as np
import torch

from ..crypto.bls import fields as F
from ..crypto.bls import hash_to_curve as OH
from ..crypto.bls.constants import (DST_G2_POP, ISO3_X_DEN, ISO3_X_NUM,
                                    ISO3_Y_DEN, ISO3_Y_NUM, SSWU_A2,
                                    SSWU_B2, SSWU_Z2, X_ABS)
from . import limbs as fp
from . import points as PT
from . import towers as T

_Z3_POW_E = F.fq2_pow(F.fq2_mul(F.fq2_sqr(SSWU_Z2), SSWU_Z2), T.SQRT_EXP)

_C = {name: T.fq2_const(val) for name, val in dict(
    A=SSWU_A2, B=SSWU_B2, Z=SSWU_Z2, Z3E=_Z3_POW_E,
    R1=T._SQRT_M1, R2=T._SQRT_C2, R3=T._SQRT_C3,
).items()}
_ISO = {name: [T.fq2_const(k) for k in coeffs] for name, coeffs in dict(
    XN=ISO3_X_NUM, XD=ISO3_X_DEN, YN=ISO3_Y_NUM, YD=ISO3_Y_DEN).items()}


def _c(name, like):
    return T._bcast2(_C[name], like)


def fq2_sgn0(a):
    """RFC 9380 sgn0 of a Montgomery-form element."""
    plain = T.fq2_from_mont(a)
    a0_odd = plain[0][..., 0] & 1
    a0_zero = torch.all(plain[0] == 0, dim=-1)
    a1_odd = plain[1][..., 0] & 1
    return a0_odd | (a0_zero.to(torch.int64) & a1_odd)


def map_to_curve_sswu_proj(u):
    """Divisionless SSWU: u -> (xn, xd, yp), x = xn/xd, y = yp/xd^3."""
    one = T._bcast2(T.FQ2_ONE_NP, u)
    u2 = T.fq2_sqr(u)
    tv = T.fq2_compress(T.fq2_mul(_c("Z", u), u2))
    tv2 = T.fq2_compress(T.fq2_add(T.fq2_sqr(tv), tv))
    tv2_zero = T.fq2_is_zero(tv2)
    r1 = T._fq2u(T.fq2_mul(
        T._fq2s([_c("B", u), _c("A", u)]),
        T._fq2s([T.fq2_add(tv2, one),
                 T.fq2_select(tv2_zero, _c("Z", u), tv2)])))
    x1n = T.fq2_select(tv2_zero, _c("B", u), T.fq2_neg(r1[0]))
    xd = T.fq2_compress(r1[1])
    x1n = T.fq2_compress(x1n)

    sq = T._fq2u(T.fq2_sqr(T._fq2s([x1n, xd])))
    x1n2, xd2 = (T.fq2_compress(s) for s in sq)
    x1n3, xd3, axd2 = T._fq2u(T.fq2_mul(
        T._fq2s([x1n2, xd2, T.fq2_compress(T.fq2_mul(_c("A", u), x1n))]),
        T._fq2s([x1n, xd, xd2])))
    xd3 = T.fq2_compress(xd3)
    gx1n = T.fq2_add(T.fq2_add(x1n3, axd2), T.fq2_mul(_c("B", u), xd3))
    gval = T.fq2_compress(T.fq2_mul(T.fq2_compress(gx1n), xd3))

    cand = T.fq2_pow_static(gval, T.SQRT_EXP)
    u3 = T.fq2_compress(T.fq2_mul(u2, u))
    cand2 = T.fq2_mul(T.fq2_mul(u3, _c("Z3E", u)), cand)
    tv3 = T.fq2_compress(T.fq2_mul(T.fq2_compress(T.fq2_sqr(tv)), tv))
    gval2 = T.fq2_compress(T.fq2_mul(tv3, gval))

    found1 = torch.zeros(tv2_zero.shape, dtype=torch.bool,
                         device=tv2_zero.device)
    found2 = found1.clone()
    y1, y2 = cand, cand2
    for root in (None, "R1", "R2", "R3"):
        t1 = cand if root is None else T.fq2_mul(_c(root, u), cand)
        m1 = T.fq2_eq(T.fq2_sqr(t1), gval) & ~found1
        y1 = T.fq2_select(m1, t1, y1)
        found1 = found1 | m1
        t2 = cand2 if root is None else T.fq2_mul(_c(root, u), cand2)
        m2 = T.fq2_eq(T.fq2_sqr(t2), gval2) & ~found2
        y2 = T.fq2_select(m2, t2, y2)
        found2 = found2 | m2

    xn = T.fq2_select(found1, x1n, T.fq2_compress(T.fq2_mul(tv, x1n)))
    yp = T.fq2_select(found1, y1, y2)
    return T.fq2_compress(xn), xd, T.fq2_compress(yp)


def iso_map_proj(xn, xd, yp):
    """3-isogeny E' -> E, homogeneous: (XN, XD, YN, YD)."""
    xn2, xd2 = (T.fq2_compress(s) for s in
                T._fq2u(T.fq2_sqr(T._fq2s([xn, xd]))))
    xn3, xd3 = (T.fq2_compress(s) for s in T._fq2u(
        T.fq2_mul(T._fq2s([xn2, xd2]), T._fq2s([xn, xd]))))
    xd_pows = [None, xd, xd2, xd3]
    xn_pows = [None, xn, xn2, xn3]

    def homog(coeffs):
        d = len(coeffs) - 1
        acc = None
        for i, kc in enumerate(coeffs):
            term = T._bcast2(kc, xn)
            if i:
                term = T.fq2_mul(term, xn_pows[i])
            if d - i:
                term = T.fq2_mul(T.fq2_compress(term), xd_pows[d - i])
            acc = term if acc is None else T.fq2_add(acc, term)
        return T.fq2_compress(acc)

    XN = homog(_ISO["XN"])
    XD = T.fq2_mul(xd, homog(_ISO["XD"]))
    YN = T.fq2_mul(yp, homog(_ISO["YN"]))
    YD = T.fq2_mul(xd3, homog(_ISO["YD"]))
    return XN, T.fq2_compress(XD), T.fq2_compress(YN), T.fq2_compress(YD)


def clear_cofactor(p):
    """h_eff*P = [x^2-x-1]P + [x-1]psi(P) + psi^2(2P), x negative."""
    G2 = PT.G2_KIT

    def mul_x(q):
        return PT.point_neg(G2, PT.scalar_mul_static(G2, X_ABS, q))

    a = PT.point_add(G2, mul_x(p), PT.point_neg(G2, p))
    res = PT.point_add(G2, mul_x(a), PT.point_neg(G2, p))
    res = PT.point_add(G2, res, PT.g2_psi(a))
    dbl = PT.point_double(G2, p)
    return PT.point_add(G2, res, PT.g2_psi(PT.g2_psi(dbl)))


def hash_to_g2_device(u0, u1):
    """Two Fq2 draws per row -> G2 Jacobian point (in the subgroup)."""
    U = T.tree_stack([u0, u1])
    xn, xd, yp = map_to_curve_sswu_proj(U)
    XN, XD, YN, YD = iso_map_proj(xn, xd, yp)
    xd3 = T.fq2_compress(T.fq2_mul(T.fq2_compress(T.fq2_sqr(xd)), xd))
    xd3_XD = T.fq2_compress(T.fq2_mul(xd3, XD))
    pinv = T.fq2_inv(T.fq2_compress(T.fq2_mul(xd3_XD, YD)))
    inv_xd3, inv_XD, inv_YD = (T.fq2_compress(c) for c in T._fq2u(T.fq2_mul(
        T._fq2s([T.fq2_compress(T.fq2_mul(XD, YD)),
                 T.fq2_compress(T.fq2_mul(xd3, YD)), xd3_XD]),
        T._fq2s([pinv, pinv, pinv]))))
    y_prime, x, y = (T.fq2_compress(c) for c in T._fq2u(T.fq2_mul(
        T._fq2s([yp, XN, YN]), T._fq2s([inv_xd3, inv_XD, inv_YD]))))
    flip = fq2_sgn0(U) != fq2_sgn0(y_prime)
    y = T.fq2_compress(T.fq2_select(flip, T.fq2_neg(y), y))
    one = T._bcast2(T.FQ2_ONE_NP, x)
    (x0, y0, o0), (x1, y1, o1) = T.tree_unstack((x, y, one), 2)
    r = PT.point_add(PT.G2_KIT, (x0, y0, o0), (x1, y1, o1))
    return clear_cofactor(r)


def messages_to_fields(messages, dst: bytes = DST_G2_POP):
    """Host: message bytes -> Montgomery Fq2 draws ((u0c0, u0c1), (u1c0, u1c1))."""
    cols = [[], [], [], []]
    for msg in messages:
        (a, b), (c, d) = OH.hash_to_field_fq2(msg, 2, dst)
        for col, v in zip(cols, (a, b, c, d)):
            col.append(fp.int_to_mont(v))
    s = [np.stack(c) for c in cols]
    return (s[0], s[1]), (s[2], s[3])


def to_affine_g2(p):
    """Jacobian -> affine (one batched inversion); infinity -> garbage."""
    zinv = T.fq2_inv(p[2])
    zinv2 = T.fq2_sqr(zinv)
    x = T.fq2_mul(p[0], zinv2)
    y = T.fq2_mul(p[1], T.fq2_mul(zinv2, zinv))
    out = fp.compress(torch.stack([x[0], x[1], y[0], y[1]], dim=-2))
    return ((out[..., 0, :], out[..., 1, :]),
            (out[..., 2, :], out[..., 3, :]))
