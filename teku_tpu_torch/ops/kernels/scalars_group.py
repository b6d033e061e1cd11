"""scalars_group.cu: the random-multiplier ladders fused with the
per-message fold (replaces teku_tpu/ops/verify.py:stage_scalars and
stage_group), and the ladders alone (``scalars``: stage_scalars of the
per-lane pipeline)."""

import torch

from .. import _build
from .. import points as PT
from .. import verify as V
from . import INT, LONG, check_tensor, dispatch, ptr
from . import lib, on_card  # noqa: F401  (looked up by dispatch)
from .decompress import g1_from_words, g1_to_words, g2_from_words, g2_to_words


def scalars_group(pk_jac, sig_jac, r, miller_mask, group_idx, group_present,
                  engine="cios"):
    """pk_jac (n, 3, 12), sig_jac (n, 3, 2, 12) words; r (n,) int64 bit
    patterns of the 64-bit multipliers; miller_mask (n,); group_idx /
    group_present (rows, g).  Returns (agg (rows, 2, 12) affine words,
    u_mask (rows,), wsig (n, 3, 2, 12) Jacobian words)."""
    n = pk_jac.shape[0]
    rows, g = group_idx.shape
    dev = pk_jac.device
    for name, t, dt, shape in (
            ("pk_jac", pk_jac, torch.int32, (n, 3, 12)),
            ("sig_jac", sig_jac, torch.int32, (n, 3, 2, 12)),
            ("r", r, torch.int64, (n,)),
            ("miller_mask", miller_mask, torch.bool, (n,)),
            ("group_idx", group_idx, torch.int32, (rows, g)),
            ("group_present", group_present, torch.bool, (rows, g))):
        check_tensor(t, name, dt, shape, dev)
    return dispatch(__name__, "scalars_group", "scalars_group", engine,
                    scalars_group_plain, _run_scalars_group, pk_jac, sig_jac,
                    r, miller_mask, group_idx, group_present)


def _run_scalars_group(library, pk_jac, sig_jac, r, miller_mask, group_idx,
                       group_present):
    n = pk_jac.shape[0]
    rows, g = group_idx.shape
    dev = pk_jac.device
    scratch = torch.empty(n * 36, dtype=torch.int32, device=dev)
    agg = torch.empty((rows, 2, 12), dtype=torch.int32, device=dev)
    u_mask = torch.empty(rows, dtype=torch.bool, device=dev)
    wsig = torch.empty((n, 3, 2, 12), dtype=torch.int32, device=dev)
    _build.check(library.scalars_group(
        ptr(pk_jac), ptr(sig_jac), ptr(r), ptr(miller_mask), ptr(group_idx),
        ptr(group_present), INT(g), ptr(scratch), ptr(agg), ptr(u_mask),
        ptr(wsig), LONG(n), LONG(rows), _build.stream_ptr(pk_jac)),
        "scalars_group")
    return agg, u_mask, wsig


def scalars_group_plain(pk_jac, sig_jac, r, miller_mask, group_idx,
                        group_present):
    bits = PT.scalar_from_uint64(r)
    pk_r, wsig = V.stage_scalars(g1_from_words(pk_jac),
                                 g2_from_words(sig_jac), bits)
    agg, u_mask = V.stage_group(pk_r, miller_mask, group_idx, group_present)
    return g1_to_words(agg), u_mask, g2_to_words(wsig)


def scalars(pk_jac, sig_jac, r, engine="cios"):
    """pk_jac (n, 3, 12), sig_jac (n, 3, 2, 12) words; r (n,) int64 bit
    patterns of the 64-bit multipliers.  Returns ([r]pk (n, 3, 12),
    [r]sig (n, 3, 2, 12)) Jacobian words."""
    n = pk_jac.shape[0]
    dev = pk_jac.device
    check_tensor(pk_jac, "pk_jac", torch.int32, (n, 3, 12), dev)
    check_tensor(sig_jac, "sig_jac", torch.int32, (n, 3, 2, 12), dev)
    check_tensor(r, "r", torch.int64, (n,), dev)
    return dispatch(__name__, "scalars", "scalars_group", engine,
                    scalars_plain, _run_scalars, pk_jac, sig_jac, r)


def _run_scalars(library, pk_jac, sig_jac, r):
    n = pk_jac.shape[0]
    pk_r = torch.empty_like(pk_jac)
    wsig = torch.empty_like(sig_jac)
    _build.check(library.scalars(ptr(pk_jac), ptr(sig_jac), ptr(r),
                                 ptr(pk_r), ptr(wsig), LONG(n),
                                 _build.stream_ptr(pk_jac)), "scalars")
    return pk_r, wsig


def scalars_plain(pk_jac, sig_jac, r):
    pk_r, wsig = V.stage_scalars(g1_from_words(pk_jac), g2_from_words(sig_jac),
                                 PT.scalar_from_uint64(r))
    return g1_to_words(pk_r), g2_to_words(wsig)
