"""kzg.cu: blob evaluation, the folded 2-pairing check and the Lagrange
MSM (replace teku_tpu/ops/kzg.py:eval_blob_kernel, fold_pairing_kernel
and msm_kernel; the fourth program, g1_validate_kernel, is the body of
decompress.cu's g1_validate).

Beside the word-level wrappers sit the plain programs on limbs --
``eval_blob``, ``fold_pairing``, ``msm`` -- which mirror the JAX
functions step for step (the Fr field of ops/modfield.py, the G1 and
pairing stages of ops/points.py, verify.py and pairing.py), and which
the wrappers' plain versions call on the CPU.
"""

import torch

from .. import _build
from .. import limbs as fp
from .. import pairing as PR
from .. import points as PT
from .. import verify as V
from ..modfield import FR
from . import LONG, check_tensor, dispatch, ptr
from . import lib, on_card  # noqa: F401  (looked up by dispatch)

EVAL_PER = 16                # kzg.cu: points per thread
SCALAR_BITS = 256            # scalars cross as 8 words; Fr values < 2^255


# --------------------------------------------------------------------------
# The plain programs (limbs), as the reference's
# --------------------------------------------------------------------------

def eval_blob(poly_plain, z_mont, roots_mont):
    """Barycentric p(z) for B blobs: poly_plain (B, n, L) plain Fr limbs,
    z_mont (B, L) and roots_mont (n, L) Montgomery, n the roots' count.
    Canonical plain limbs of y = p(z), (B, L); z == w_i selects p_i."""
    n = roots_mont.shape[0]
    inv_n = FR.int_to_mont(pow(n, FR.M - 2, FR.M))
    poly = FR.to_mont(poly_plain)
    denom = z_mont[:, None, :] - roots_mont[None]
    invs = FR.inv_many(denom)
    terms = FR.mont_mul(FR.mont_mul(poly, roots_mont[None]), invs)
    acc = FR.compress(terms.sum(dim=1))
    zn = FR.pow_static(z_mont, n)
    one = fp.const(FR.ONE_MONT, z_mont.device)
    factor = FR.mont_mul(zn - one, fp.const(inv_n, z_mont.device))
    y = FR.mont_mul(acc, factor)
    hit = FR.is_zero(denom)
    special = FR.compress(torch.where(hit[..., None], poly,
                                      torch.zeros_like(poly)).sum(dim=1))
    y = FR.select(hit.any(dim=1), special, y)
    return FR.canonical_plain(y)


def _ladder_points(xs, ys, use, bits):
    """[s_i]P_i for affine Montgomery points, infinity where not `use`."""
    G1 = PT.G1_KIT
    jac = (xs, ys, fp.bcast(fp.ONE_MONT, xs))
    inf_pt = PT.infinity_like(G1, xs)
    return PT.scalar_mul_bits(G1, bits, PT._select_point(G1, use, jac,
                                                         inf_pt)), inf_pt


def fold_pairing(xs, ys, inf, valid, bits, group_b, g2x0, g2x1, g2y0, g2y1):
    """The folded 2-pairing check.  xs/ys (n, L) Montgomery affine G1;
    inf/valid/group_b (n,); bits (n, nbits) MSB first; g2* (2, L): [G2,
    sG2].  valid lanes outside group b sum into the left pairing's point,
    group b's into the right one, negated.  Returns (verdict, the two
    affine sums (x, y) of (2, L) Montgomery limbs, their infinity flags)."""
    G1 = PT.G1_KIT
    w, inf_pt = _ladder_points(xs, ys, valid & ~inf, bits)
    pa = V.point_batch_sum(G1, PT._select_point(G1, valid & ~group_b, w,
                                                inf_pt))
    pb = PT.point_neg(G1, V.point_batch_sum(
        G1, PT._select_point(G1, valid & group_b, w, inf_pt)))
    pair = fp.tree_map2(lambda a, b: torch.stack([a, b], dim=0), pa, pb)
    pair_inf = PT.is_infinity(G1, pair)
    aff = V.to_affine_g1(pair)
    ml = PR.miller_loop(aff, ((g2x0, g2x1), (g2y0, g2y1)), mask=~pair_inf)
    return PR.pairing_check(PR.batch_product(ml)), aff, pair_inf


def msm(xs, ys, present, bits):
    """sum_i [s_i]P_i over affine Montgomery points (absent = infinity):
    (is_inf, canonical plain x limbs, canonical plain y limbs)."""
    G1 = PT.G1_KIT
    w, _ = _ladder_points(xs, ys, present, bits)
    total = V.point_batch_sum(G1, w)
    aff = V.to_affine_g1(fp.tree_map(lambda x: x[None], total))
    return (PT.is_infinity(G1, total), fp.canonical_plain(aff[0][0]),
            fp.canonical_plain(aff[1][0]))


# --------------------------------------------------------------------------
# kzg_eval
# --------------------------------------------------------------------------

def kzg_eval(poly, z, roots, engine="cios"):
    """poly (B, n, 8), z (B, 8), roots (n, 8): canonical plain Fr words
    (int32 bit patterns), n a power of two >= 16.  Returns y = p(z),
    (B, 8) words."""
    b, n = poly.shape[0], roots.shape[0]
    dev = poly.device
    if n < EVAL_PER or n & (n - 1):
        raise ValueError(f"kzg_eval needs a power-of-two n >= {EVAL_PER}, "
                         f"got {n}")
    check_tensor(poly, "poly", torch.int32, (b, n, 8), dev)
    check_tensor(z, "z", torch.int32, (b, 8), dev)
    check_tensor(roots, "roots", torch.int32, (n, 8), dev)
    return dispatch(__name__, "kzg_eval", "kzg", engine, kzg_eval_plain,
                    _run_kzg_eval, poly, z, roots)


def _run_kzg_eval(library, poly, z, roots):
    b, n = poly.shape[0], roots.shape[0]
    dev = poly.device
    part = torch.empty(b * (n // EVAL_PER) * 8, dtype=torch.int32,
                       device=dev)
    hit = torch.full((b,), -1, dtype=torch.int32, device=dev)
    y = torch.empty((b, 8), dtype=torch.int32, device=dev)
    _build.check(library.kzg_eval(ptr(poly), ptr(z), ptr(roots), ptr(part),
                                  ptr(hit), ptr(y), LONG(b), LONG(n),
                                  _build.stream_ptr(poly)), "kzg_eval")
    return y


def kzg_eval_plain(poly, z, roots):
    return FR.plain_to_words(eval_blob(FR.words_to_plain(poly),
                                       FR.from_words(z), FR.from_words(roots)))


# --------------------------------------------------------------------------
# kzg_fold
# --------------------------------------------------------------------------

def kzg_fold(xs, ys, inf, valid, group_b, scalars, g2, engine="cios"):
    """xs/ys (n, 12) affine G1 words; inf/valid/group_b (n,); scalars
    (n, 8) words; g2 (2, 2, 2, 12): [G2, sG2] affine (x, y) x (c0, c1)
    words.  Returns (verdict (1,), the two affine sums (2, 2, 12) words --
    group b's negated, (0, 0) at infinity -- and their infinity flags)."""
    n = xs.shape[0]
    dev = xs.device
    for name, t, dt, shape in (
            ("xs", xs, torch.int32, (n, 12)), ("ys", ys, torch.int32, (n, 12)),
            ("inf", inf, torch.bool, (n,)), ("valid", valid, torch.bool, (n,)),
            ("group_b", group_b, torch.bool, (n,)),
            ("scalars", scalars, torch.int32, (n, 8)),
            ("g2", g2, torch.int32, (2, 2, 2, 12))):
        check_tensor(t, name, dt, shape, dev)
    if n < 1:
        raise ValueError("kzg_fold needs at least one lane")
    return dispatch(__name__, "kzg_fold", "kzg", engine, kzg_fold_plain,
                    _run_kzg_fold, xs, ys, inf, valid, group_b, scalars, g2)


def _run_kzg_fold(library, xs, ys, inf, valid, group_b, scalars, g2):
    n = xs.shape[0]
    dev = xs.device
    # 2n Jacobian G1 points (36 words, Montgomery) + the two Miller
    # values (144 canonical words each)
    scratch = torch.empty(2 * n * 36 + 2 * 144, dtype=torch.int32,
                          device=dev)
    ok = torch.empty(1, dtype=torch.bool, device=dev)
    pair = torch.empty((2, 2, 12), dtype=torch.int32, device=dev)
    pair_inf = torch.empty(2, dtype=torch.bool, device=dev)
    _build.check(library.kzg_fold(
        ptr(xs), ptr(ys), ptr(inf), ptr(valid), ptr(group_b), ptr(scalars),
        ptr(g2), ptr(scratch), ptr(ok), ptr(pair), ptr(pair_inf), LONG(n),
        _build.stream_ptr(xs)), "kzg_fold")
    return ok, pair, pair_inf


def kzg_fold_plain(xs, ys, inf, valid, group_b, scalars, g2):
    q = fp.from_words(g2)
    ok, aff, pair_inf = fold_pairing(
        fp.from_words(xs), fp.from_words(ys), inf, valid,
        fp.words_to_bits(scalars, SCALAR_BITS), group_b,
        q[:, 0, 0], q[:, 0, 1], q[:, 1, 0], q[:, 1, 1])
    return ok[None], fp.to_words(torch.stack(aff, dim=1)), pair_inf


# --------------------------------------------------------------------------
# kzg_msm
# --------------------------------------------------------------------------

def kzg_msm(xs, ys, present, scalars, engine="cios"):
    """xs/ys (n, 12) affine G1 words, present (n,), scalars (n, 8) words.
    Returns (infinity flag (1,), affine sum (2, 12) words, (0, 0) at
    infinity)."""
    n = xs.shape[0]
    dev = xs.device
    for name, t, dt, shape in (
            ("xs", xs, torch.int32, (n, 12)), ("ys", ys, torch.int32, (n, 12)),
            ("present", present, torch.bool, (n,)),
            ("scalars", scalars, torch.int32, (n, 8))):
        check_tensor(t, name, dt, shape, dev)
    if n < 1:
        raise ValueError("kzg_msm needs at least one lane")
    return dispatch(__name__, "kzg_msm", "kzg", engine, kzg_msm_plain,
                    _run_kzg_msm, xs, ys, present, scalars)


def _run_kzg_msm(library, xs, ys, present, scalars):
    n = xs.shape[0]
    dev = xs.device
    scratch = torch.empty(n * 36, dtype=torch.int32, device=dev)
    inf = torch.empty(1, dtype=torch.bool, device=dev)
    xy = torch.empty((2, 12), dtype=torch.int32, device=dev)
    _build.check(library.kzg_msm(ptr(xs), ptr(ys), ptr(present), ptr(scalars),
                                 ptr(scratch), ptr(inf), ptr(xy), LONG(n),
                                 _build.stream_ptr(xs)), "kzg_msm")
    return inf, xy


def kzg_msm_plain(xs, ys, present, scalars):
    is_inf, ax, ay = msm(fp.from_words(xs), fp.from_words(ys), present,
                         fp.words_to_bits(scalars, SCALAR_BITS))
    xy = fp.words_i32(fp.limbs_to_words(torch.stack([ax, ay], dim=0)))
    return is_inf[None], xy
