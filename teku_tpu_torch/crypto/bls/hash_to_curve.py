"""Hash-to-curve for BLS12-381 G2 (RFC 9380, BLS12381G2_XMD:SHA-256_SSWU_RO_).

The port's own copy of teku_tpu/crypto/bls/hash_to_curve.py (teku_tpu_torch
imports nothing of teku_tpu); keep the two in step.

Pipeline: expand_message_xmd(SHA-256) -> hash_to_field(Fq2, m=2, count=2)
-> simplified SWU on the 3-isogenous curve E' -> isogeny map to E -> point
addition -> cofactor clearing.

Cofactor clearing has two implementations: multiplication by the effective
cofactor h_eff (slow, straight from the RFC — used as the validation oracle)
and the psi-endomorphism (Budroni-Pintore) method used in production and
mirrored by the JAX kernel.  The DST is the ETH2 proof-of-possession suite
(reference: infrastructure/bls/.../impl/blst/HashToCurve.java:23).
"""

import hashlib
from typing import Tuple

from . import fields as F
from .curve import (FQ2_OPS, Point, from_affine, infinity, point_add,
                    point_mul, point_neg, to_affine)
from .constants import (DST_G2_POP, H_EFF_G2, ISO3_X_DEN, ISO3_X_NUM,
                        ISO3_Y_DEN, ISO3_Y_NUM, P, SSWU_A2, SSWU_B2, SSWU_Z2,
                        X as BLS_X)

# ---------------------------------------------------------------------------
# expand_message_xmd (SHA-256)
# ---------------------------------------------------------------------------

_B_IN_BYTES = 32   # SHA-256 output size
_R_IN_BYTES = 64   # SHA-256 block size
_L = 64            # bytes per field element draw (ceil((381 + 128) / 8))


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(_R_IN_BYTES)
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = b
    prev = b
    for i in range(2, ell + 1):
        prev = hashlib.sha256(
            bytes(x ^ y for x, y in zip(b0, prev)) + bytes([i]) + dst_prime
        ).digest()
        out += prev
    return out[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes = DST_G2_POP):
    """Draw `count` elements of Fq2 from msg (m=2, L=64)."""
    len_in_bytes = count * 2 * _L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coords = []
        for j in range(2):
            off = _L * (j + i * 2)
            coords.append(int.from_bytes(uniform[off:off + _L], "big") % P)
        out.append(tuple(coords))
    return out


# ---------------------------------------------------------------------------
# Simplified SWU map on E' (y^2 = x^3 + A'x + B' over Fq2)
# ---------------------------------------------------------------------------


def _gx_prime(x):
    """g(x) = x^3 + A'x + B' on the isogenous curve."""
    x3 = F.fq2_mul(F.fq2_sqr(x), x)
    return F.fq2_add(F.fq2_add(x3, F.fq2_mul(SSWU_A2, x)), SSWU_B2)


def map_to_curve_sswu_g2(u) -> Tuple:
    """RFC 9380 6.6.2 simplified SWU; returns an affine point on E'."""
    z_u2 = F.fq2_mul(SSWU_Z2, F.fq2_sqr(u))
    tv = F.fq2_add(F.fq2_sqr(z_u2), z_u2)  # Z^2 u^4 + Z u^2
    if F.fq2_is_zero(tv):
        # exceptional case: x1 = B' / (Z * A')
        x1 = F.fq2_mul(SSWU_B2, F.fq2_inv(F.fq2_mul(SSWU_Z2, SSWU_A2)))
    else:
        # x1 = (-B'/A') * (1 + 1/tv)
        x1 = F.fq2_mul(
            F.fq2_neg(F.fq2_mul(SSWU_B2, F.fq2_inv(SSWU_A2))),
            F.fq2_add(F.FQ2_ONE, F.fq2_inv(tv)))
    gx1 = _gx_prime(x1)
    y1 = F.fq2_sqrt(gx1)
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = F.fq2_mul(z_u2, x1)
        gx2 = _gx_prime(x2)
        y2 = F.fq2_sqrt(gx2)
        if y2 is None:
            raise AssertionError("SSWU: neither gx1 nor gx2 is square")
        x, y = x2, y2
    if F.fq2_sgn0(u) != F.fq2_sgn0(y):
        y = F.fq2_neg(y)
    return (x, y)


def iso_map_g2(p_prime) -> Tuple:
    """3-isogeny E' -> E (affine in, affine out)."""
    x, y = p_prime

    def horner(coeffs):
        acc = F.FQ2_ZERO
        for c in reversed(coeffs):
            acc = F.fq2_add(F.fq2_mul(acc, x), c)
        return acc

    x_num = horner(ISO3_X_NUM)
    x_den = horner(ISO3_X_DEN)
    y_num = horner(ISO3_Y_NUM)
    y_den = horner(ISO3_Y_DEN)
    return (F.fq2_mul(x_num, F.fq2_inv(x_den)),
            F.fq2_mul(y, F.fq2_mul(y_num, F.fq2_inv(y_den))))


# ---------------------------------------------------------------------------
# psi endomorphism and cofactor clearing
# ---------------------------------------------------------------------------
# psi = twist o Frobenius o untwist on E'(Fq2):
#   psi(x, y) = (c_x * conj(x), c_y * conj(y))
# with c_x = 1/xi^((p-1)/3), c_y = 1/xi^((p-1)/2).  Validated in tests
# against multiplication by h_eff.

PSI_CX = F.fq2_inv(F.fq2_pow(F.XI, (P - 1) // 3))
PSI_CY = F.fq2_inv(F.fq2_pow(F.XI, (P - 1) // 2))


def psi(p: Point) -> Point:
    aff = to_affine(FQ2_OPS, p)
    if aff is None:
        return infinity(FQ2_OPS)
    x, y = aff
    return from_affine(FQ2_OPS,
                       F.fq2_mul(PSI_CX, F.fq2_conj(x)),
                       F.fq2_mul(PSI_CY, F.fq2_conj(y)))


def clear_cofactor_g2_slow(p: Point) -> Point:
    """Multiplication by h_eff (RFC 9380 8.8.2) — oracle path."""
    return point_mul(FQ2_OPS, H_EFF_G2, p)


def clear_cofactor_g2(p: Point) -> Point:
    """Budroni-Pintore: h_eff*P = [x^2-x-1]P + [x-1]psi(P) + psi^2(2P)."""
    a = point_add(FQ2_OPS, point_mul(FQ2_OPS, BLS_X, p), point_neg(FQ2_OPS, p))
    res = point_add(FQ2_OPS, point_mul(FQ2_OPS, BLS_X, a), point_neg(FQ2_OPS, p))
    res = point_add(FQ2_OPS, res, psi(a))
    res = point_add(FQ2_OPS, res, psi(psi(point_add(FQ2_OPS, p, p))))
    return res


# ---------------------------------------------------------------------------
# hash_to_curve
# ---------------------------------------------------------------------------


def hash_to_g2(msg: bytes, dst: bytes = DST_G2_POP) -> Point:
    """Full hash_to_curve for G2; returns a Jacobian point in the subgroup."""
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    q0 = iso_map_g2(map_to_curve_sswu_g2(u0))
    q1 = iso_map_g2(map_to_curve_sswu_g2(u1))
    r = point_add(FQ2_OPS,
                  from_affine(FQ2_OPS, *q0),
                  from_affine(FQ2_OPS, *q1))
    return clear_cofactor_g2(r)
