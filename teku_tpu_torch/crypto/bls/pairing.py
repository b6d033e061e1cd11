"""Optimal ate pairing on BLS12-381 (pure Python oracle).

The port's own copy of teku_tpu/crypto/bls/pairing.py (teku_tpu_torch
imports nothing of teku_tpu); keep the two in step.

The oracle favours clarity over speed: the Miller loop runs in affine
coordinates directly in Fq12 after untwisting the G2 point, so there is no
twist-type case analysis and no sparse-multiplication trickery.  Subfield
factors (line denominators, sign conventions) are killed by the final
exponentiation, which is why they are elided.

This is the correctness reference for the batched JAX Miller-loop kernel in
teku_tpu/ops/pairing.py.  Reference client equivalent: native blst pairing
behind infrastructure/bls/.../impl/blst/BlstBLS12381.java:124-189.
"""

from typing import List, Optional, Tuple

from . import fields as F
from .constants import P, R, X, X_ABS

# ---------------------------------------------------------------------------
# Embeddings into Fq12
# ---------------------------------------------------------------------------


def fq_to_fq12(a: int):
    return (((a % P, 0), F.FQ2_ZERO, F.FQ2_ZERO), F.FQ6_ZERO)


def fq2_to_fq12(a):
    return ((a, F.FQ2_ZERO, F.FQ2_ZERO), F.FQ6_ZERO)


# w = (0, (1, 0, 0)) in our tower; w^2 = v, w^6 = xi.
FQ12_W = (F.FQ6_ZERO, F.FQ6_ONE)
FQ12_W2 = F.fq12_mul(FQ12_W, FQ12_W)
FQ12_W3 = F.fq12_mul(FQ12_W2, FQ12_W)
FQ12_W2_INV = F.fq12_inv(FQ12_W2)
FQ12_W3_INV = F.fq12_inv(FQ12_W3)


def untwist(q_affine) -> Tuple:
    """Map an affine G2 point on E'(Fq2) to E(Fq12): (x/w^2, y/w^3)."""
    x, y = q_affine
    return (F.fq12_mul(fq2_to_fq12(x), FQ12_W2_INV),
            F.fq12_mul(fq2_to_fq12(y), FQ12_W3_INV))


# ---------------------------------------------------------------------------
# Miller loop (affine, Fq12)
# ---------------------------------------------------------------------------

_X_BITS = bin(X_ABS)[3:]  # bits below the MSB, as '0'/'1' chars


def _line_eval(lam, a, p):
    """(y_P - y_A) - lam * (x_P - x_A), all in Fq12."""
    ax, ay = a
    px, py = p
    return F.fq12_sub(F.fq12_sub(py, ay),
                      F.fq12_mul(lam, F.fq12_sub(px, ax)))


def _affine_double(t):
    x, y = t
    x2 = F.fq12_sqr(x)
    lam = F.fq12_mul(F.fq12_add(F.fq12_add(x2, x2), x2),
                     F.fq12_inv(F.fq12_add(y, y)))
    x3 = F.fq12_sub(F.fq12_sqr(lam), F.fq12_add(x, x))
    y3 = F.fq12_sub(F.fq12_mul(lam, F.fq12_sub(x, x3)), y)
    return lam, (x3, y3)


def _affine_add(t, q):
    tx, ty = t
    qx, qy = q
    lam = F.fq12_mul(F.fq12_sub(ty, qy), F.fq12_inv(F.fq12_sub(tx, qx)))
    x3 = F.fq12_sub(F.fq12_sub(F.fq12_sqr(lam), tx), qx)
    y3 = F.fq12_sub(F.fq12_mul(lam, F.fq12_sub(tx, x3)), ty)
    return lam, (x3, y3)


def miller_loop_untwist(p_affine: Optional[Tuple[int, int]],
                        q_affine: Optional[Tuple]) -> Tuple:
    """Miller loop via untwisted affine arithmetic directly in Fq12.

    The clarity-first construction (inversion per step, dense Fq12 muls);
    retained as the independent cross-check for the production twist-
    coordinate loop below, which the JAX kernel mirrors.
    """
    if p_affine is None or q_affine is None:
        return F.FQ12_ONE
    p12 = (fq_to_fq12(p_affine[0]), fq_to_fq12(p_affine[1]))
    q12 = untwist(q_affine)
    t = q12
    f = F.FQ12_ONE
    for c in _X_BITS:
        # tangent line at the *current* T, evaluated at P
        prev = t
        lam, t = _affine_double(t)
        f = F.fq12_mul(F.fq12_sqr(f), _line_eval(lam, prev, p12))
        if c == "1":
            prev = t
            lam, t = _affine_add(t, q12)
            f = F.fq12_mul(f, _line_eval(lam, prev, p12))
    # BLS parameter x is negative: conjugate.
    return F.fq12_conj(f)


# ---------------------------------------------------------------------------
# Production Miller loop: Jacobian coordinates on the twist, sparse lines
# ---------------------------------------------------------------------------
# The tangent/chord line through the untwisted point, evaluated at embedded
# P = (px, py) and multiplied through by an Fq2 factor (killed by the final
# exponentiation), is the sparse Fq12 element
#     l = c0 + (c1 v + c2 v^2) w
# with c0, c1, c2 in Fq2:
#   doubling T=(X,Y,Z):  c0 = Z3*Z^2*xi*py, c1 = E*X - 2B, c2 = -E*Z^2*px
#                        (E = 3X^2, B = Y^2, Z3 = 2YZ)
#   mixed add of Q=(xq,yq): c0 = Z3*xi*py, c1 = r*xq - yq*Z3, c2 = -r*px
#                        (r = yq*Z^3 - Y, H = xq*Z^2 - X, Z3 = Z*H)
# Branch-free except for the static Miller bit pattern, so the batched JAX
# kernel (teku_tpu/ops) can mirror it 1:1; the untwist loop above is the
# independent oracle for both.


def _dbl_step(t, px, py):
    """Double T (Jacobian on E'/Fq2); return (T2, line coeffs)."""
    X, Y, Z = t
    A = F.fq2_sqr(X)
    B = F.fq2_sqr(Y)
    Cc = F.fq2_sqr(B)
    Z2 = F.fq2_sqr(Z)
    D = F.fq2_sub(F.fq2_sub(F.fq2_sqr(F.fq2_add(X, B)), A), Cc)
    D = F.fq2_add(D, D)
    E = F.fq2_add(F.fq2_add(A, A), A)
    Fv = F.fq2_sqr(E)
    X3 = F.fq2_sub(Fv, F.fq2_add(D, D))
    C8 = F.fq2_add(Cc, Cc)
    C8 = F.fq2_add(C8, C8)
    C8 = F.fq2_add(C8, C8)
    Y3 = F.fq2_sub(F.fq2_mul(E, F.fq2_sub(D, X3)), C8)
    YZ = F.fq2_mul(Y, Z)
    Z3 = F.fq2_add(YZ, YZ)
    c0 = F.fq2_scalar_mul(F.fq2_mul_by_xi(F.fq2_mul(Z3, Z2)), py)
    c1 = F.fq2_sub(F.fq2_mul(E, X), F.fq2_add(B, B))
    c2 = F.fq2_scalar_mul(F.fq2_mul(E, Z2), (-px) % P)
    return (X3, Y3, Z3), (c0, c1, c2)


def _add_step(t, q, px, py):
    """Mixed-add affine Q into Jacobian T; return (T+Q, line coeffs)."""
    X, Y, Z = t
    xq, yq = q
    Z2 = F.fq2_sqr(Z)
    U2 = F.fq2_mul(xq, Z2)
    S2 = F.fq2_mul(yq, F.fq2_mul(Z2, Z))
    H = F.fq2_sub(U2, X)
    r = F.fq2_sub(S2, Y)
    H2 = F.fq2_sqr(H)
    H3 = F.fq2_mul(H, H2)
    V = F.fq2_mul(X, H2)
    X3 = F.fq2_sub(F.fq2_sub(F.fq2_sqr(r), H3), F.fq2_add(V, V))
    Y3 = F.fq2_sub(F.fq2_mul(r, F.fq2_sub(V, X3)), F.fq2_mul(Y, H3))
    Z3 = F.fq2_mul(Z, H)
    c0 = F.fq2_scalar_mul(F.fq2_mul_by_xi(Z3), py)
    c1 = F.fq2_sub(F.fq2_mul(r, xq), F.fq2_mul(yq, Z3))
    c2 = F.fq2_scalar_mul(r, (-px) % P)
    return (X3, Y3, Z3), (c0, c1, c2)


def _fq6_mul_sparse_v(a, c1, c2):
    """(a0 + a1 v + a2 v^2) * (c1 v + c2 v^2)."""
    a0, a1, a2 = a
    return (F.fq2_mul_by_xi(F.fq2_add(F.fq2_mul(a1, c2), F.fq2_mul(a2, c1))),
            F.fq2_add(F.fq2_mul(a0, c1), F.fq2_mul_by_xi(F.fq2_mul(a2, c2))),
            F.fq2_add(F.fq2_mul(a0, c2), F.fq2_mul(a1, c1)))


def _mul_by_line(f, line):
    """f * (c0 + (c1 v + c2 v^2) w), exploiting sparsity."""
    c0, c1, c2 = line
    f0, f1 = f
    t1 = _fq6_mul_sparse_v(f1, c1, c2)
    # res0 = f0 l0 + f1 l1 v ;  (x0 + x1 v + x2 v^2) v = (xi x2, x0, x1)
    res0 = F.fq6_add(F.fq6_mul_by_fq2(f0, c0),
                     (F.fq2_mul_by_xi(t1[2]), t1[0], t1[1]))
    # res1 = f0 l1 + f1 l0
    res1 = F.fq6_add(_fq6_mul_sparse_v(f0, c1, c2), F.fq6_mul_by_fq2(f1, c0))
    return (res0, res1)


def miller_loop(p_affine: Optional[Tuple[int, int]],
                q_affine: Optional[Tuple]) -> Tuple:
    """Miller loop of the optimal ate pairing (twist coordinates).

    p_affine: affine G1 point (x, y) as ints, or None for infinity.
    q_affine: affine G2 point ((x0,x1),(y0,y1)) on E'/Fq2, or None.
    Returns an Fq12 element (un-exponentiated).  Agrees with
    miller_loop_untwist up to final exponentiation (validated in tests).
    """
    if p_affine is None or q_affine is None:
        return F.FQ12_ONE
    px, py = p_affine
    t = (q_affine[0], q_affine[1], F.FQ2_ONE)
    f = F.FQ12_ONE
    for c in _X_BITS:
        f = F.fq12_sqr(f)
        t, line = _dbl_step(t, px, py)
        f = _mul_by_line(f, line)
        if c == "1":
            t, line = _add_step(t, q_affine, px, py)
            f = _mul_by_line(f, line)
    # BLS parameter x is negative: conjugate.
    return F.fq12_conj(f)


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------

_HARD_EXP = (P ** 4 - P ** 2 + 1) // R

# Hard-part decomposition (Hayashida-Hayasaka-Teruya, validated at import):
#   3 * (p^4 - p^2 + 1)/r = (z-1)^2 * (z+p) * (z^2 + p^2 - 1) + 3
# with z the (negative) BLS parameter.  We therefore compute f^(3d) rather
# than f^d; since the target group has prime order r (and 3 does not divide
# r), f^(3d) == 1  iff  f^d == 1, and bilinearity is unaffected, so every
# consumer (verification is_one checks, property tests) is preserved.

assert 3 * _HARD_EXP == (X - 1) ** 2 * (X + P) * (X ** 2 + P ** 2 - 1) + 3


def _cyclo_pow_abs_x(f):
    """f^|z| for cyclotomic f: Granger-Scott squarings, Hamming weight 6."""
    result = f
    for c in _X_BITS:
        result = F.fq12_cyclo_sqr(result)
        if c == "1":
            result = F.fq12_mul(result, f)
    return result


def _pow_z(f):
    """f^z for cyclotomic f (z < 0, so conjugate = inverse applies)."""
    return F.fq12_conj(_cyclo_pow_abs_x(f))


def final_exponentiation(f) -> Tuple:
    """f^(3 * (p^12-1)/r): easy part then the x-chain hard part above."""
    # easy part: f^((p^6 - 1)(p^2 + 1)) — lands in the cyclotomic subgroup,
    # where inverse == conjugate (used by _pow_z).
    g = F.fq12_mul(F.fq12_conj(f), F.fq12_inv(f))
    g = F.fq12_mul(F.fq12_frobenius(g, 2), g)
    # hard part: g^(3 * (p^4 - p^2 + 1)/r) via the decomposition.
    a = F.fq12_mul(_pow_z(g), F.fq12_conj(g))            # g^(z-1)
    a = F.fq12_mul(_pow_z(a), F.fq12_conj(a))            # g^((z-1)^2)
    b = F.fq12_mul(_pow_z(a), F.fq12_frobenius(a, 1))    # a^(z+p)
    c = F.fq12_mul(F.fq12_mul(_pow_z(_pow_z(b)), F.fq12_frobenius(b, 2)),
                   F.fq12_conj(b))                       # b^(z^2+p^2-1)
    return F.fq12_mul(c, F.fq12_mul(F.fq12_sqr(g), g))   # * g^3


def pairing(p_affine, q_affine) -> Tuple:
    """Pairing check value e(P, Q)^3 (see final_exponentiation).

    NOT the canonical GT element: the exponent carries a fixed cofactor 3,
    which preserves is_one checks, equality between values produced by this
    module, bilinearity, and non-degeneracy — the only consumers here — but
    would mismatch a GT known-answer vector computed with the exact
    (p^12-1)/r exponent.
    """
    return final_exponentiation(miller_loop(p_affine, q_affine))


def multi_pairing(pairs: List[Tuple]) -> Tuple:
    """prod_i e(P_i, Q_i)^3 with a single shared final exponentiation."""
    f = F.FQ12_ONE
    for p_affine, q_affine in pairs:
        f = F.fq12_mul(f, miller_loop(p_affine, q_affine))
    return final_exponentiation(f)
