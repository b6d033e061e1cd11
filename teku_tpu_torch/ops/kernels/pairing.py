"""pairing.cu: Miller loops per message row (replaces
teku_tpu/ops/verify.py:stage_miller) and the batch verdict (replaces
stage_finish: cross-row product, weighted-signature sum, e(-g1, sum),
final exponentiation)."""

import torch

from .. import _build
from .. import towers as T
from .. import verify as V
from . import LONG, check_tensor, dispatch, ptr
from . import lib, on_card  # noqa: F401  (looked up by dispatch)
from .decompress import g1_from_words, g2_from_words


def miller(agg, hm, mask, engine="cios"):
    """agg (n, 2, 12) affine G1 words, hm (n, 2, 2, 12) affine G2 words,
    mask (n,).  Returns the Miller values, (n, 12, 12) words (ONE where
    mask is False)."""
    n = agg.shape[0]
    check_tensor(agg, "agg", torch.int32, (n, 2, 12), agg.device)
    check_tensor(hm, "hm", torch.int32, (n, 2, 2, 12), agg.device)
    check_tensor(mask, "mask", torch.bool, (n,), agg.device)
    return dispatch(__name__, "miller", "pairing", engine, miller_plain,
                    _run_miller, agg, hm, mask)


def _run_miller(library, agg, hm, mask):
    n = agg.shape[0]
    out = torch.empty((n, 12, 12), dtype=torch.int32, device=agg.device)
    _build.check(library.miller(ptr(agg), ptr(hm), ptr(mask), ptr(out),
                                LONG(n), _build.stream_ptr(agg)), "miller")
    return out


def miller_plain(agg, hm, mask):
    p = g1_from_words(agg)
    q = g2_from_words(hm)
    return T.fq12_to_words(V.stage_miller(p, q, mask))


def finish(ml, wsig, engine="cios"):
    """ml (rows, 12, 12) Miller words, wsig (n, 3, 2, 12) weighted
    signatures.  Returns the batch verdict, a (1,) bool tensor."""
    rows, n = ml.shape[0], wsig.shape[0]
    check_tensor(ml, "ml", torch.int32, (rows, 12, 12), ml.device)
    check_tensor(wsig, "wsig", torch.int32, (n, 3, 2, 12), ml.device)
    if rows < 1 or n < 1:
        raise ValueError("finish needs at least one row and one lane")
    return dispatch(__name__, "finish", "pairing", engine, finish_plain,
                    _run_finish, ml, wsig)


def _run_finish(library, ml, wsig):
    # the halving passes consume their inputs: work on copies
    ml_s, wsig_s = ml.clone(), wsig.clone()
    ok = torch.empty(1, dtype=torch.bool, device=ml.device)
    _build.check(library.finish(ptr(ml_s), LONG(ml.shape[0]), ptr(wsig_s),
                                LONG(wsig.shape[0]), ptr(ok),
                                _build.stream_ptr(ml)), "finish")
    return ok


def finish_plain(ml, wsig):
    return V.stage_finish(T.fq12_from_words(ml), g2_from_words(wsig))[None]
