"""msm.cu: the GLV + Pippenger scalars stage (replaces
teku_tpu/ops/verify.py:stage_scalars_pippenger and the MSM programs of
teku_tpu/ops/msm.py)."""

import torch

from .. import _build
from .. import msm as MSM
from .. import verify as V
from . import INT, LONG, check_tensor, dispatch, ptr
from . import lib, on_card  # noqa: F401  (looked up by dispatch)
from .decompress import g1_from_words, g1_to_words, g2_from_words, g2_to_words

NWIN = MSM.n_windows(MSM.WINDOW)      # msm.cu is built for 4-bit digits


def scalars_msm(pk_jac, sig_jac, glv_digits, miller_mask, group_idx,
                group_present, engine="cios"):
    """pk_jac (n, 3, 12), sig_jac (n, 3, 2, 12) words; glv_digits
    (n, 2, 8) int32 4-bit digits of (k1, k2), MSB first; miller_mask
    (n,); group_idx / group_present (rows, g); n a power of two.
    Returns (agg (rows, 2, 12) affine words, u_mask (rows,), wsig
    (1, 3, 2, 12) Jacobian words of sum_i [r_i]sig_i)."""
    n = pk_jac.shape[0]
    rows, g = group_idx.shape
    dev = pk_jac.device
    for name, t, dt, shape in (
            ("pk_jac", pk_jac, torch.int32, (n, 3, 12)),
            ("sig_jac", sig_jac, torch.int32, (n, 3, 2, 12)),
            ("glv_digits", glv_digits, torch.int32, (n, 2, NWIN)),
            ("miller_mask", miller_mask, torch.bool, (n,)),
            ("group_idx", group_idx, torch.int32, (rows, g)),
            ("group_present", group_present, torch.bool, (rows, g))):
        check_tensor(t, name, dt, shape, dev)
    if n < 1 or n & (n - 1):
        raise ValueError(f"lanes {n} is not a power of two")
    return dispatch(__name__, "scalars_msm", "msm", engine, scalars_msm_plain,
                    _run_scalars_msm, pk_jac, sig_jac, glv_digits, miller_mask,
                    group_idx, group_present)


def _run_scalars_msm(library, pk_jac, sig_jac, glv_digits, miller_mask,
                     group_idx, group_present):
    n = pk_jac.shape[0]
    rows, g = group_idx.shape
    dev = pk_jac.device
    seg = min(MSM.G2_SEG, 2 * n)
    nseg = 2 * n // seg
    # Montgomery points: 36 words per G1, 72 per G2 (see msm.cu)
    words = (2 * n * 36 + 2 * n * 72 + rows * NWIN * 36
             + nseg * NWIN * 15 * 72 + NWIN * 72)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    agg = torch.empty((rows, 2, 12), dtype=torch.int32, device=dev)
    u_mask = torch.empty(rows, dtype=torch.bool, device=dev)
    wsig = torch.empty((1, 3, 2, 12), dtype=torch.int32, device=dev)
    _build.check(library.scalars_msm(
        ptr(pk_jac), ptr(sig_jac), ptr(glv_digits), ptr(miller_mask),
        ptr(group_idx), ptr(group_present), INT(g), ptr(scratch), ptr(agg),
        ptr(u_mask), ptr(wsig), LONG(n), LONG(rows), LONG(seg),
        _build.stream_ptr(pk_jac)), "scalars_msm")
    return agg, u_mask, wsig


def scalars_msm_plain(pk_jac, sig_jac, glv_digits, miller_mask, group_idx,
                      group_present):
    agg, u_mask, wsig = V.stage_scalars_pippenger(
        g1_from_words(pk_jac), g2_from_words(sig_jac), glv_digits,
        group_idx, group_present, miller_mask)
    return g1_to_words(agg), u_mask, g2_to_words(wsig)
