"""shard.cu: the kernels of the mesh dispatch.

gather_hm replaces teku_tpu/ops/verify.py:stage_gather_hm, lane_affine
stage_lane_affine, shard_partials the per-shard reductions of
verify_kernel_sharded_grouped and verify_kernel_sharded, and
aggregate_points aggregate_points_kernel.
"""

import torch

from .. import _build
from .. import limbs as fp
from .. import points as PT
from .. import towers as T
from .. import verify as V
from . import INT, LONG, check_tensor, dispatch, ptr
from . import lib, on_card  # noqa: F401  (looked up by dispatch)
from .decompress import g1_from_words, g1_to_words, g2_from_words, g2_to_words


def gather_hm(hm, idx, engine="cios"):
    """hm (u, 2, 2, 12) affine G2 words, idx (rows,) int32.  Returns
    (hm[idx] (rows, 2, 2, 12), in_range (1,) bool): an index outside
    [0, u) gives a zero row and in_range False."""
    u, rows = hm.shape[0], idx.shape[0]
    check_tensor(hm, "hm", torch.int32, (u, 2, 2, 12), hm.device)
    check_tensor(idx, "idx", torch.int32, (rows,), hm.device)
    return dispatch(__name__, "gather_hm", "shard", engine, gather_hm_plain,
                    _run_gather_hm, hm, idx)


def _run_gather_hm(library, hm, idx):
    rows = idx.shape[0]
    out = torch.empty((rows, 2, 2, 12), dtype=torch.int32, device=hm.device)
    in_range = torch.ones(1, dtype=torch.bool, device=hm.device)
    _build.check(library.gather_hm(ptr(hm), LONG(hm.shape[0]), ptr(idx),
                                   ptr(out), ptr(in_range), LONG(rows),
                                   _build.stream_ptr(hm)), "gather_hm")
    return out, in_range


def gather_hm_plain(hm, idx):
    ok = (idx >= 0) & (idx < hm.shape[0])
    rows = g2_to_words(V.stage_gather_hm(g2_from_words(hm),
                                         torch.where(ok, idx, 0)))
    return rows * ok[:, None, None, None], ok.all()[None]


def lane_affine(pk_r, engine="cios"):
    """pk_r (n, 3, 12) Jacobian G1 words -> (n, 2, 12) affine words
    (infinity -> zeros)."""
    n = pk_r.shape[0]
    check_tensor(pk_r, "pk_r", torch.int32, (n, 3, 12), pk_r.device)
    return dispatch(__name__, "lane_affine", "shard", engine,
                    lane_affine_plain, _run_lane_affine, pk_r)


def _run_lane_affine(library, pk_r):
    n = pk_r.shape[0]
    out = torch.empty((n, 2, 12), dtype=torch.int32, device=pk_r.device)
    _build.check(library.lane_affine(ptr(pk_r), ptr(out), LONG(n),
                                     _build.stream_ptr(pk_r)), "lane_affine")
    return out


def lane_affine_plain(pk_r):
    return g1_to_words(V.stage_lane_affine(g1_from_words(pk_r)))


def shard_partials(ml, wsig, engine="cios"):
    """ml (rows, 12, 12) Miller words, wsig (n, 3, 2, 12) weighted
    signatures.  Returns the shard's (product (1, 12, 12), G2 Jacobian
    sum (1, 3, 2, 12))."""
    rows, n = ml.shape[0], wsig.shape[0]
    check_tensor(ml, "ml", torch.int32, (rows, 12, 12), ml.device)
    check_tensor(wsig, "wsig", torch.int32, (n, 3, 2, 12), ml.device)
    if rows < 1 or n < 1:
        raise ValueError("a shard needs at least one row and one lane")
    return dispatch(__name__, "shard_partials", "shard", engine,
                    shard_partials_plain, _run_shard_partials, ml, wsig)


def _run_shard_partials(library, ml, wsig):
    # the halving passes consume their inputs: work on copies
    ml_s, wsig_s = ml.clone(), wsig.clone()
    _build.check(library.shard_partials(ptr(ml_s), LONG(ml.shape[0]),
                                        ptr(wsig_s), LONG(wsig.shape[0]),
                                        _build.stream_ptr(ml)),
                 "shard_partials")
    return ml_s[:1], wsig_s[:1]


def _one(tree):
    return fp.tree_map(lambda x: x[None], tree)


def shard_partials_plain(ml, wsig):
    prod, ssum = V.shard_partials(T.fq12_from_words(ml), g2_from_words(wsig))
    return T.fq12_to_words(_one(prod)), g2_to_words(_one(ssum))


def aggregate_points(pts, present, engine="cios"):
    """pts (n, 2, 12) affine G1 or (n, 2, 2, 12) affine G2 words, present
    (n,).  Returns the Jacobian sum, (1, 3, 12) or (1, 3, 2, 12) words."""
    n = pts.shape[0]
    g2 = pts.dim() == 4
    check_tensor(pts, "pts", torch.int32,
                 (n, 2, 2, 12) if g2 else (n, 2, 12), pts.device)
    check_tensor(present, "present", torch.bool, (n,), pts.device)
    if n < 1:
        raise ValueError("aggregate_points needs at least one point")
    return dispatch(__name__, "aggregate_points", "shard", engine,
                    aggregate_points_plain, _run_aggregate_points, pts,
                    present)


def _run_aggregate_points(library, pts, present):
    n = pts.shape[0]
    g2 = pts.dim() == 4
    jac = torch.empty((n, 3, 2, 12) if g2 else (n, 3, 12), dtype=torch.int32,
                      device=pts.device)
    _build.check(library.aggregate_points(ptr(pts), ptr(present), INT(int(g2)),
                                          ptr(jac), LONG(n),
                                          _build.stream_ptr(pts)),
                 "aggregate_points")
    return jac[:1]


def aggregate_points_plain(pts, present):
    if pts.dim() == 4:
        x, y = g2_from_words(pts)
        return g2_to_words(_one(V.aggregate_points(PT.G2_KIT, x, y, present)))
    x, y = g1_from_words(pts)
    return g1_to_words(_one(V.aggregate_points(PT.G1_KIT, x, y, present)))
