"""BLS12-381 field tower arithmetic (pure Python, host-side oracle).

The port's own copy of teku_tpu/crypto/bls/fields.py (teku_tpu_torch
imports nothing of teku_tpu); keep the two in step.

Fq  : integers mod P
Fq2 : Fq[u]/(u^2 + 1),      represented as tuple (c0, c1)
Fq6 : Fq2[v]/(v^3 - xi),    xi = 1 + u, represented as 3-tuple of Fq2
Fq12: Fq6[w]/(w^2 - v),     represented as 2-tuple of Fq6

This module is the correctness oracle for the JAX/TPU kernels in
teku_tpu/ops (which mirror these algorithms on fixed-width limb arrays) and
the CPU fallback implementation behind the BLS SPI — the same dual role the
reference gives its pluggable BLS12381 providers (reference:
infrastructure/bls/src/main/java/tech/pegasys/teku/bls/impl/BLS12381.java:34).

All functions are pure; elements are immutable tuples of ints.  Frobenius
coefficients are *computed* at import time from first principles rather than
hard-coded, so they cannot silently disagree with P.
"""

from .constants import P

# ---------------------------------------------------------------------------
# Fq
# ---------------------------------------------------------------------------

def fq_add(a, b):
    return (a + b) % P


def fq_sub(a, b):
    return (a - b) % P


def fq_mul(a, b):
    return (a * b) % P


def fq_neg(a):
    return (-a) % P


def fq_inv(a):
    if a % P == 0:
        raise ZeroDivisionError("inverse of 0 in Fq")
    return pow(a, -1, P)  # extended-gcd path, ~20x faster than Fermat


def fq_sqrt(a):
    """Square root in Fq (P = 3 mod 4). Returns None if a is not a square."""
    c = pow(a, (P + 1) // 4, P)
    return c if (c * c) % P == a % P else None


# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1)
# ---------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
XI = (1, 1)  # the Fq6 non-residue 1 + u


def fq2(c0, c1):
    return (c0 % P, c1 % P)


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    t2 = (a0 + a1) * (b0 + b1)
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fq2_sqr(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    a0, a1 = a
    return (((a0 + a1) * (a0 - a1)) % P, (2 * a0 * a1) % P)


def fq2_scalar_mul(a, k):
    return ((a[0] * k) % P, (a[1] * k) % P)


def fq2_conj(a):
    return (a[0], (-a[1]) % P)


def fq2_mul_by_xi(a):
    # a * (1 + u) = (a0 - a1) + (a0 + a1) u
    a0, a1 = a
    return ((a0 - a1) % P, (a0 + a1) % P)


def fq2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    ninv = fq_inv(norm)
    return ((a0 * ninv) % P, ((-a1) * ninv) % P)


def fq2_pow(a, n):
    if n < 0:
        return fq2_pow(fq2_inv(a), -n)
    result = FQ2_ONE
    base = a
    while n:
        if n & 1:
            result = fq2_mul(result, base)
        base = fq2_sqr(base)
        n >>= 1
    return result


def fq2_is_zero(a):
    return a[0] % P == 0 and a[1] % P == 0


def fq2_eq(a, b):
    return a[0] % P == b[0] % P and a[1] % P == b[1] % P


def fq2_sgn0(a):
    """RFC 9380 sgn0 for Fq2 (extension degree 2, lexicographic)."""
    a0, a1 = a[0] % P, a[1] % P
    sign_0 = a0 & 1
    zero_0 = a0 == 0
    return sign_0 | (int(zero_0) & (a1 & 1))


# Tonelli-Shanks in Fq2.  q = P^2, q - 1 = 2^S * M with S = 3 for BLS12-381.
_Q = P * P
_S = 0
_M = _Q - 1
while _M % 2 == 0:
    _M //= 2
    _S += 1
# 1 + u has norm 2, a non-residue mod P (P = 3 mod 8), so it is a QNR in Fq2.
_TS_Z = fq2_pow(XI, _M)  # generator of the 2-Sylow subgroup


def fq2_sqrt(a):
    """Square root in Fq2 via Tonelli-Shanks. Returns None if not a square."""
    if fq2_is_zero(a):
        return FQ2_ZERO
    t = fq2_pow(a, (_M - 1) // 2)
    x = fq2_mul(a, t)          # a^((M+1)/2)
    b = fq2_mul(x, t)          # a^M
    z = _TS_Z
    m = _S
    while not fq2_eq(b, FQ2_ONE):
        # find least k with b^(2^k) == 1
        k = 0
        t2 = b
        while not fq2_eq(t2, FQ2_ONE):
            t2 = fq2_sqr(t2)
            k += 1
            if k >= m:
                return None  # not a square
        # z^(2^(m-k-1))
        gs = z
        for _ in range(m - k - 1):
            gs = fq2_sqr(gs)
        x = fq2_mul(x, gs)
        z = fq2_sqr(gs)
        b = fq2_mul(b, z)
        m = k
    return x if fq2_eq(fq2_sqr(x), a) else None


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - xi)
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a, b):
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a):
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    # c0 = t0 + xi * ((a1 + a2)(b1 + b2) - t1 - t2)
    c0 = fq2_add(t0, fq2_mul_by_xi(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), t1), t2)))
    # c1 = (a0 + a1)(b0 + b1) - t0 - t1 + xi * t2
    c1 = fq2_add(fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), t0), t1),
                 fq2_mul_by_xi(t2))
    # c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1
    c2 = fq2_add(fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), t0), t2), t1)
    return (c0, c1, c2)


def fq6_sqr(a):
    # Chung-Hasan SQR2: 3 squarings + 2 multiplications instead of 6 muls.
    a0, a1, a2 = a
    s0 = fq2_sqr(a0)
    s1 = fq2_mul(a0, a1)
    s1 = fq2_add(s1, s1)
    s2 = fq2_sqr(fq2_add(fq2_sub(a0, a1), a2))
    s3 = fq2_mul(a1, a2)
    s3 = fq2_add(s3, s3)
    s4 = fq2_sqr(a2)
    c0 = fq2_add(s0, fq2_mul_by_xi(s3))
    c1 = fq2_add(s1, fq2_mul_by_xi(s4))
    c2 = fq2_sub(fq2_add(fq2_add(s1, s2), s3), fq2_add(s0, s4))
    return (c0, c1, c2)


def fq6_mul_by_v(a):
    # (a0 + a1 v + a2 v^2) * v = xi*a2 + a0 v + a1 v^2
    return (fq2_mul_by_xi(a[2]), a[0], a[1])


def fq6_mul_by_fq2(a, s):
    return (fq2_mul(a[0], s), fq2_mul(a[1], s), fq2_mul(a[2], s))


def fq6_inv(a):
    a0, a1, a2 = a
    t0 = fq2_sub(fq2_sqr(a0), fq2_mul_by_xi(fq2_mul(a1, a2)))
    t1 = fq2_sub(fq2_mul_by_xi(fq2_sqr(a2)), fq2_mul(a0, a1))
    t2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    # norm = a0 t0 + xi (a2 t1 + a1 t2)
    norm = fq2_add(fq2_mul(a0, t0),
                   fq2_mul_by_xi(fq2_add(fq2_mul(a2, t1), fq2_mul(a1, t2))))
    ninv = fq2_inv(norm)
    return (fq2_mul(t0, ninv), fq2_mul(t1, ninv), fq2_mul(t2, ninv))


def fq6_is_zero(a):
    return all(fq2_is_zero(c) for c in a)


def fq6_eq(a, b):
    return all(fq2_eq(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fq12_sqr(a):
    # Complex squaring: (a0 + a1 w)^2 with w^2 = v costs 2 Fq6 muls.
    a0, a1 = a
    t = fq6_mul(a0, a1)
    c0 = fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(a0, fq6_mul_by_v(a1))),
                 fq6_add(t, fq6_mul_by_v(t)))
    c1 = fq6_add(t, t)
    return (c0, c1)


def fq12_conj(a):
    """Conjugation = Frobenius^6 (negates the w component)."""
    return (a[0], fq6_neg(a[1]))


def _fp4_sqr(a, b):
    """(a + b s)^2 in Fq4 = Fq2[s]/(s^2 - xi); returns coefficient pair."""
    t = fq2_mul(a, b)
    return (fq2_add(fq2_sqr(a), fq2_mul_by_xi(fq2_sqr(b))), fq2_add(t, t))


def fq12_cyclo_sqr(a):
    """Granger-Scott squaring, valid ONLY for cyclotomic-subgroup elements.

    Decomposes Fq12 = Fq4[w]/(w^3 - s) with s = v*w, Fq4 = Fq2[s]/(s^2 - xi):
    coefficient pairs A0=(g0,h1), A1=(h0,g2), A2=(g1,h2).  For cyclotomic
    f = A0 + A1 w + A2 w^2,  f^2 = (3A0^2 - 2conj(A0))
    + (3 s A2^2 + 2conj(A1)) w + (3A1^2 - 2conj(A2)) w^2.
    Validated against generic fq12_sqr in tests.
    """
    (g0, g1, g2), (h0, h1, h2) = a
    a0, a1 = _fp4_sqr(g0, h1)
    b0, b1 = _fp4_sqr(h0, g2)
    c0, c1 = _fp4_sqr(g1, h2)
    sc0, sc1 = fq2_mul_by_xi(c1), c0  # s * A2^2

    def comb(s0, s1, o0, o1, sign):
        # 3*(s0,s1) + sign*2*conj(o0,o1) with conj(x,y) = (x,-y)
        t0 = fq2_add(fq2_add(s0, s0), s0)
        t1 = fq2_add(fq2_add(s1, s1), s1)
        d0 = fq2_add(o0, o0)
        d1 = fq2_add(o1, o1)
        if sign > 0:
            return (fq2_add(t0, d0), fq2_sub(t1, d1))
        return (fq2_sub(t0, d0), fq2_add(t1, d1))

    B0 = comb(a0, a1, g0, h1, -1)
    B1 = comb(sc0, sc1, h0, g2, +1)
    B2 = comb(b0, b1, g1, h2, -1)
    return ((B0[0], B2[0], B1[1]), (B1[0], B0[1], B2[1]))


def fq12_inv(a):
    a0, a1 = a
    norm = fq6_sub(fq6_sqr(a0), fq6_mul_by_v(fq6_sqr(a1)))
    ninv = fq6_inv(norm)
    return (fq6_mul(a0, ninv), fq6_neg(fq6_mul(a1, ninv)))


def fq12_pow(a, n):
    if n < 0:
        return fq12_pow(fq12_inv(a), -n)
    result = FQ12_ONE
    base = a
    while n:
        if n & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        n >>= 1
    return result


def fq12_eq(a, b):
    return fq6_eq(a[0], b[0]) and fq6_eq(a[1], b[1])


def fq12_is_one(a):
    return fq12_eq(a, FQ12_ONE)


# ---------------------------------------------------------------------------
# Frobenius endomorphism (computed, not hard-coded)
# ---------------------------------------------------------------------------
# pi(a) = a^P.  On Fq2 this is conjugation.  On the towers, v^P = g6 * v and
# w^P = g12 * w with g6 = xi^((P-1)/3) in Fq2, g12 = xi^((P-1)/6) in Fq2
# (exponents exact because P = 7 mod 12).

assert P % 12 == 7
FROB6_C1 = fq2_pow(XI, (P - 1) // 3)
FROB6_C2 = fq2_pow(XI, 2 * (P - 1) // 3)
FROB12_C1 = fq2_pow(XI, (P - 1) // 6)


def fq6_frobenius(a):
    return (fq2_conj(a[0]),
            fq2_mul(fq2_conj(a[1]), FROB6_C1),
            fq2_mul(fq2_conj(a[2]), FROB6_C2))


def fq12_frobenius(a, power=1):
    result = a
    for _ in range(power % 12):
        c0 = fq6_frobenius(result[0])
        c1 = fq6_frobenius(result[1])
        c1 = fq6_mul_by_fq2(c1, FROB12_C1)
        result = (c0, c1)
    return result
