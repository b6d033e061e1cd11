"""BLS12-381 elliptic curve group operations (pure Python oracle).

The port's own copy of teku_tpu/crypto/bls/curve.py (teku_tpu_torch
imports nothing of teku_tpu); keep the two in step.

Generic Jacobian-coordinate point arithmetic parameterized over the base
field, instantiated for G1 (over Fq, y^2 = x^3 + 4) and G2 (over Fq2,
y^2 = x^3 + 4(1+u)).  Also implements the ZCash/ETH2 point compression
format used on the wire by the reference client (reference:
infrastructure/bls/src/main/java/tech/pegasys/teku/bls/impl/blst/
BlstPublicKey.java, BlstSignature.java — there delegated to native blst).

Points are tuples (X, Y, Z) in Jacobian coordinates (x = X/Z^2, y = Y/Z^3),
with Z == zero meaning the point at infinity.
"""

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from . import fields as F
from .constants import (B_G1, B_G2, G1_X, G1_Y, G2_X0, G2_X1, G2_Y0, G2_Y1,
                        P, R)


@dataclass(frozen=True)
class FieldOps:
    zero: Any
    one: Any
    add: Callable
    sub: Callable
    mul: Callable
    sqr: Callable
    neg: Callable
    inv: Callable
    is_zero: Callable
    eq: Callable
    sqrt: Callable
    b: Any  # curve coefficient


FQ_OPS = FieldOps(
    zero=0, one=1,
    add=F.fq_add, sub=F.fq_sub, mul=F.fq_mul,
    sqr=lambda a: (a * a) % P, neg=F.fq_neg, inv=F.fq_inv,
    is_zero=lambda a: a % P == 0, eq=lambda a, b: (a - b) % P == 0,
    sqrt=F.fq_sqrt, b=B_G1,
)

FQ2_OPS = FieldOps(
    zero=F.FQ2_ZERO, one=F.FQ2_ONE,
    add=F.fq2_add, sub=F.fq2_sub, mul=F.fq2_mul,
    sqr=F.fq2_sqr, neg=F.fq2_neg, inv=F.fq2_inv,
    is_zero=F.fq2_is_zero, eq=F.fq2_eq,
    sqrt=F.fq2_sqrt, b=B_G2,
)

Point = Tuple[Any, Any, Any]


def infinity(ops: FieldOps) -> Point:
    return (ops.one, ops.one, ops.zero)


def is_infinity(ops: FieldOps, p: Point) -> bool:
    return ops.is_zero(p[2])


def from_affine(ops: FieldOps, x, y) -> Point:
    return (x, y, ops.one)


def to_affine(ops: FieldOps, p: Point) -> Optional[Tuple[Any, Any]]:
    if is_infinity(ops, p):
        return None
    zinv = ops.inv(p[2])
    zinv2 = ops.sqr(zinv)
    return (ops.mul(p[0], zinv2), ops.mul(p[1], ops.mul(zinv2, zinv)))


def point_neg(ops: FieldOps, p: Point) -> Point:
    return (p[0], ops.neg(p[1]), p[2])


def point_double(ops: FieldOps, p: Point) -> Point:
    """Jacobian doubling (a = 0 curves)."""
    X1, Y1, Z1 = p
    if ops.is_zero(Z1):
        return p
    A = ops.sqr(X1)
    B = ops.sqr(Y1)
    C = ops.sqr(B)
    # D = 2*((X1+B)^2 - A - C)
    D = ops.sub(ops.sub(ops.sqr(ops.add(X1, B)), A), C)
    D = ops.add(D, D)
    E = ops.add(ops.add(A, A), A)
    Fv = ops.sqr(E)
    X3 = ops.sub(Fv, ops.add(D, D))
    C8 = ops.add(ops.add(ops.add(C, C), ops.add(C, C)),
                 ops.add(ops.add(C, C), ops.add(C, C)))
    Y3 = ops.sub(ops.mul(E, ops.sub(D, X3)), C8)
    Z3 = ops.mul(ops.add(Y1, Y1), Z1)
    return (X3, Y3, Z3)


def point_add(ops: FieldOps, p: Point, q: Point) -> Point:
    """General Jacobian addition."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if ops.is_zero(Z1):
        return q
    if ops.is_zero(Z2):
        return p
    Z1Z1 = ops.sqr(Z1)
    Z2Z2 = ops.sqr(Z2)
    U1 = ops.mul(X1, Z2Z2)
    U2 = ops.mul(X2, Z1Z1)
    S1 = ops.mul(Y1, ops.mul(Z2, Z2Z2))
    S2 = ops.mul(Y2, ops.mul(Z1, Z1Z1))
    if ops.eq(U1, U2):
        if ops.eq(S1, S2):
            return point_double(ops, p)
        return infinity(ops)
    H = ops.sub(U2, U1)
    I = ops.sqr(ops.add(H, H))
    J = ops.mul(H, I)
    rr = ops.sub(S2, S1)
    rr = ops.add(rr, rr)
    V = ops.mul(U1, I)
    X3 = ops.sub(ops.sub(ops.sqr(rr), J), ops.add(V, V))
    S1J = ops.mul(S1, J)
    Y3 = ops.sub(ops.mul(rr, ops.sub(V, X3)), ops.add(S1J, S1J))
    Z1Z2 = ops.mul(Z1, Z2)
    Z3 = ops.mul(ops.add(Z1Z2, Z1Z2), H)
    return (X3, Y3, Z3)


def point_mul(ops: FieldOps, k: int, p: Point) -> Point:
    """Scalar multiplication (double-and-add; oracle only, not constant time)."""
    if k < 0:
        return point_mul(ops, -k, point_neg(ops, p))
    result = infinity(ops)
    addend = p
    while k:
        if k & 1:
            result = point_add(ops, result, addend)
        addend = point_double(ops, addend)
        k >>= 1
    return result


def point_eq(ops: FieldOps, p: Point, q: Point) -> bool:
    if is_infinity(ops, p) or is_infinity(ops, q):
        return is_infinity(ops, p) and is_infinity(ops, q)
    Z1Z1 = ops.sqr(p[2])
    Z2Z2 = ops.sqr(q[2])
    if not ops.eq(ops.mul(p[0], Z2Z2), ops.mul(q[0], Z1Z1)):
        return False
    return ops.eq(ops.mul(p[1], ops.mul(q[2], Z2Z2)),
                  ops.mul(q[1], ops.mul(p[2], Z1Z1)))


def is_on_curve(ops: FieldOps, p: Point) -> bool:
    if is_infinity(ops, p):
        return True
    X1, Y1, Z1 = p
    # Y^2 = X^3 + b Z^6
    lhs = ops.sqr(Y1)
    z2 = ops.sqr(Z1)
    z6 = ops.mul(ops.sqr(z2), z2)
    rhs = ops.add(ops.mul(ops.sqr(X1), X1), ops.mul(ops.b, z6))
    return ops.eq(lhs, rhs)


# ---------------------------------------------------------------------------
# Group generators and subgroup checks
# ---------------------------------------------------------------------------

G1_GENERATOR: Point = (G1_X, G1_Y, 1)
G2_GENERATOR: Point = ((G2_X0, G2_X1), (G2_Y0, G2_Y1), F.FQ2_ONE)


def g1_in_subgroup(p: Point) -> bool:
    return is_on_curve(FQ_OPS, p) and is_infinity(FQ_OPS, point_mul(FQ_OPS, R, p))


def g2_in_subgroup(p: Point) -> bool:
    return is_on_curve(FQ2_OPS, p) and is_infinity(FQ2_OPS, point_mul(FQ2_OPS, R, p))


# ---------------------------------------------------------------------------
# ZCash/ETH2 serialization
# ---------------------------------------------------------------------------
# Flag bits live in the MSBs of the first byte:
#   0x80 compressed, 0x40 infinity, 0x20 lexicographically-largest y.

_HALF_P = (P - 1) // 2


def _fq_is_large(y: int) -> bool:
    return y > _HALF_P


def _fq2_is_large(y) -> bool:
    y0, y1 = y[0] % P, y[1] % P
    return y1 > _HALF_P or (y1 == 0 and y0 > _HALF_P)


def g1_compress(p: Point) -> bytes:
    if is_infinity(FQ_OPS, p):
        return bytes([0xC0] + [0] * 47)
    x, y = to_affine(FQ_OPS, p)
    flags = 0x80 | (0x20 if _fq_is_large(y) else 0)
    b = x.to_bytes(48, "big")
    return bytes([b[0] | flags]) + b[1:]


def g1_decompress(data: bytes) -> Point:
    """Decompress + validate a 48-byte G1 point (curve + subgroup checks)."""
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G1 encoding not supported")
    if flags & 0x40:
        if any(data[1:]) or (flags & 0x3F):
            raise ValueError("malformed infinity encoding")
        return infinity(FQ_OPS)
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("x coordinate out of range")
    y = F.fq_sqrt((x * x % P * x + B_G1) % P)
    if y is None:
        raise ValueError("point not on curve")
    if _fq_is_large(y) != bool(flags & 0x20):
        y = F.fq_neg(y)
    p = from_affine(FQ_OPS, x, y)
    if not g1_in_subgroup(p):
        raise ValueError("point not in G1 subgroup")
    return p


def g2_compress(p: Point) -> bytes:
    if is_infinity(FQ2_OPS, p):
        return bytes([0xC0] + [0] * 95)
    x, y = to_affine(FQ2_OPS, p)
    flags = 0x80 | (0x20 if _fq2_is_large(y) else 0)
    b = x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big")  # c1 first
    return bytes([b[0] | flags]) + b[1:]


def g2_decompress(data: bytes) -> Point:
    """Decompress + validate a 96-byte G2 point (curve + subgroup checks)."""
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G2 encoding not supported")
    if flags & 0x40:
        if any(data[1:]) or (flags & 0x3F):
            raise ValueError("malformed infinity encoding")
        return infinity(FQ2_OPS)
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:96], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("x coordinate out of range")
    x = (x0, x1)
    rhs = F.fq2_add(F.fq2_mul(F.fq2_sqr(x), x), B_G2)
    y = F.fq2_sqrt(rhs)
    if y is None:
        raise ValueError("point not on curve")
    if _fq2_is_large(y) != bool(flags & 0x20):
        y = F.fq2_neg(y)
    p = from_affine(FQ2_OPS, x, y)
    if not g2_in_subgroup(p):
        raise ValueError("point not in G2 subgroup")
    return p
