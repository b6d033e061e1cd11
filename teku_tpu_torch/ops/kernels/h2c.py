"""h2c.cu: hash-to-G2 at unique-message width (replaces
teku_tpu/ops/verify.py:stage_h2c)."""

import torch

from .. import _build
from .. import verify as V
from . import LONG, check_tensor, dispatch, ptr
from . import lib, on_card  # noqa: F401  (looked up by dispatch)
from .decompress import g2_from_words, g2_to_words


def h2c(u0, u1, engine="cios"):
    """u0, u1: (n, 2, 12) canonical words of each row's two Fq2 draws.
    Returns the affine H(m) points, (n, 2, 2, 12) words."""
    n = u0.shape[0]
    check_tensor(u0, "u0", torch.int32, (n, 2, 12), u0.device)
    check_tensor(u1, "u1", torch.int32, (n, 2, 12), u0.device)
    return dispatch(__name__, "h2c", "h2c", engine, h2c_plain,
                    _run_h2c, u0, u1)


def _run_h2c(library, u0, u1):
    n = u0.shape[0]
    out = torch.empty((n, 2, 2, 12), dtype=torch.int32, device=u0.device)
    _build.check(library.h2c(ptr(u0), ptr(u1), ptr(out), LONG(n),
                             _build.stream_ptr(u0)), "h2c")
    return out


def h2c_plain(u0, u1):
    (d0,), (d1,) = g2_from_words(u0[:, None]), g2_from_words(u1[:, None])
    return g2_to_words(V.stage_h2c(d0, d1))
