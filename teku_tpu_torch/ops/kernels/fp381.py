"""fp381.cu: the field and tower entry points, held against ops/limbs.py,
ops/modfield.py and ops/towers.py (not a stage of the verify pipeline).
fp_mont and fr_mont are each engine's Montgomery product alone, one an
element on words taken as Montgomery form: on the mma build, row 11's
kernel (mma_digits.cuh)."""

import torch

from .. import _build
from .. import limbs as fp
from .. import towers as T
from ..modfield import FR
from . import INT, LONG, check_tensor, dispatch, ptr
from . import lib, on_card  # noqa: F401  (looked up by dispatch)

OPS = {"fp_mul": (0, 1, 2), "fp_inv": (1, 1, 1), "fp_sqrt": (2, 1, 1),
       "fq2_mul": (3, 2, 2), "fq12_mul": (4, 12, 2),
       "fp_mont": (6, 1, 2)}                          # code, Fq per elem, args
FR_OPS = {"fr_mul": 5, "fr_mont": 7}                   # code; Fr, 2 args
# The limb products' R is 2^(W L) (Fq 2^390, Fr 2^260), the kernels'
# 2^(32 NW) (2^384, 2^256): the plain fp_mont / fr_mont take one more
# limb product, by 2^(2 W L - 32 NW) mod M, to give the kernels' a b R^-1.
_R_FIX = {"fp": pow(2, 2 * fp.W * fp.L - 32 * fp.NW, fp.P),
          "fr": pow(2, 2 * FR.W * FR.L - 32 * FR.NW, FR.M)}


def _shape(op):
    """(code, words per element, args) of an entry point."""
    if op in FR_OPS:
        return FR_OPS[op], FR.NW, 2
    code, width, nargs = OPS[op]
    return code, 12 * width, nargs


def fp381_ops(op: str, a, b=None, engine="cios"):
    """Canonical words in ((n, 12 * width) flattened per element; fr_mul
    (n, 8)), out."""
    _, words, nargs = _shape(op)
    n = a.shape[0]
    check_tensor(a, "a", torch.int32, (n, words), a.device)
    if nargs == 2:
        check_tensor(b, "b", torch.int32, (n, words), a.device)
    return dispatch(__name__, "fp381_ops", "fp381", engine, fp381_ops_plain,
                    _run, op, a, b)


def _run(library, op, a, b=None):
    code = _shape(op)[0]
    out = torch.empty_like(a)
    bb = a if b is None else b
    _build.check(library.fp381_ops(INT(code), ptr(a), ptr(bb), ptr(out),
                                   LONG(a.shape[0]), _build.stream_ptr(a)),
                 f"fp381_ops {op}")
    return out


def fp381_ops_plain(op: str, a, b=None):
    n = a.shape[0]
    if op == "fr_mont":
        x = FR.mont_mul(FR.words_to_plain(a), FR.words_to_plain(b))
        x = FR.mont_mul(x, torch.from_numpy(FR.int_to_limbs(_R_FIX["fr"])
                                            ).to(x.device))
        return FR.plain_to_words(FR.canonical_unit(x))
    if op == "fr_mul":
        return FR.to_words(FR.mont_mul(FR.from_words(a), FR.from_words(b)))
    if op == "fp_mont":
        x = fp.mont_mul(fp.plain_limbs_from_words(a),
                        fp.plain_limbs_from_words(b))
        x = fp.mont_mul(x, fp.const(fp.int_to_limbs(_R_FIX["fp"]), x.device))
        return fp.words_i32(fp.limbs_to_words(fp.canonical_unit(x)))
    width = OPS[op][1]
    x = fp.from_words(a.reshape(n, width, 12))
    y = None if b is None else fp.from_words(b.reshape(n, width, 12))
    if op == "fp_mul":
        r = fp.mont_mul(x, y)
    elif op == "fp_inv":
        r = fp.inv_many(x)
    elif op == "fp_sqrt":
        r = fp.sqrt_candidate(x)
    elif op == "fq2_mul":
        t = T.fq2_mul((x[:, 0], x[:, 1]), (y[:, 0], y[:, 1]))
        r = torch.stack(t, dim=1)
    else:
        xs = T._nest12([x[:, i] for i in range(12)])
        ys = T._nest12([y[:, i] for i in range(12)])
        r = torch.stack(T._flat12(T.fq12_mul(xs, ys)), dim=1)
    return fp.to_words(r).reshape(n, 12 * width)
