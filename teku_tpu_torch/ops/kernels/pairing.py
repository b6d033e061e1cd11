"""pairing.cu: Miller loops per message row, a block per row (replaces
teku_tpu/ops/verify.py:stage_miller) and the batch verdict (replaces
stage_finish: cross-row product, weighted-signature sum, e(-g1, sum),
final exponentiation), both on pairing.cuh's cooperative routines.
pairing_ops exposes the cooperative Fq12 operations on Fq12 words
(tests, chip_smoke.py; not a stage of the verify pipeline)."""

import torch

from .. import _build
from .. import pairing as PR
from .. import towers as T
from .. import verify as V
from . import INT, LONG, check_tensor, dispatch, ptr
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


# pairing.cu's op codes: the cooperative routines (mul takes b)
PAIRING_OPS = {"mul": 0, "sqr": 1, "cyclo_sqr": 2, "final_exp": 3}


def pairing_ops(op: str, a, b=None, reps=1, engine="cios"):
    """a, b (n, 12, 12) Fq12 words -> (n, 12, 12) words: a b^reps,
    a^(2^reps) (the square, or the cyclotomic square for a in the
    cyclotomic subgroup), or the final exponentiation of a (reps is
    ignored)."""
    if op not in PAIRING_OPS:
        raise ValueError(f"unknown pairing op {op!r}")
    n = a.shape[0]
    check_tensor(a, "a", torch.int32, (n, 12, 12), a.device)
    if op == "mul":
        check_tensor(b, "b", torch.int32, (n, 12, 12), a.device)
    return dispatch(__name__, "pairing_ops", "pairing", engine,
                    pairing_ops_plain, _run_pairing_ops, op, a, b, reps)


def _run_pairing_ops(library, op, a, b=None, reps=1):
    out = torch.empty((a.shape[0], 12, 12), dtype=torch.int32,
                      device=a.device)
    _build.check(library.pairing_ops(INT(PAIRING_OPS[op]), ptr(a),
                                     ptr(a if b is None else b), ptr(out),
                                     LONG(a.shape[0]), INT(reps),
                                     _build.stream_ptr(a)),
                 f"pairing_ops {op}")
    return out


def pairing_ops_plain(op: str, a, b=None, reps=1):
    x = T.fq12_from_words(a)
    if op == "final_exp":
        return T.fq12_to_words(PR.final_exponentiation(x))
    y = None if b is None else T.fq12_from_words(b)
    step = {"mul": lambda v: T.fq12_mul(v, y), "sqr": T.fq12_sqr,
            "cyclo_sqr": T.fq12_cyclo_sqr}[op]
    for _ in range(reps):
        x = step(x)
    return T.fq12_to_words(x)
