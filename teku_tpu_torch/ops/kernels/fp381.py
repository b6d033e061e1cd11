"""fp381.cu: the field and tower entry points, held against ops/limbs.py
and ops/towers.py (not a stage of the verify pipeline)."""

import torch

from .. import _build
from .. import limbs as fp
from .. import towers as T
from . import LAUNCHES, LONG, INT, check_tensor, lib, on_card, ptr

OPS = {"fp_mul": (0, 1, 2), "fp_inv": (1, 1, 1), "fp_sqrt": (2, 1, 1),
       "fq2_mul": (3, 2, 2), "fq12_mul": (4, 12, 2)}   # code, Fq per elem, args


def fp381_ops(op: str, a, b=None):
    """Canonical words in ((n, 12 * width) flattened per element), out."""
    code, width, nargs = OPS[op]
    n = a.shape[0]
    check_tensor(a, "a", torch.int32, (n, 12 * width), a.device)
    if nargs == 2:
        check_tensor(b, "b", torch.int32, (n, 12 * width), a.device)
    if not on_card(a):
        return fp381_ops_plain(op, a, b)
    LAUNCHES["fp381_ops"] += 1
    return _run(lib("fp381"), op, a, b)


def _run(library, op, a, b=None):
    code = OPS[op][0]
    out = torch.empty_like(a)
    bb = a if b is None else b
    _build.check(library.fp381_ops(INT(code), ptr(a), ptr(bb), ptr(out),
                                   LONG(a.shape[0]), _build.stream_ptr(a)),
                 f"fp381_ops {op}")
    return out


def fp381_ops_plain(op: str, a, b=None):
    n = a.shape[0]
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
