"""Wrappers of the hand-written CUDA kernels, with their plain versions.

Every wrapper takes canonical plain words (int32 bit patterns of 12
little-endian 32-bit words per Fq element, 8 per Fr element) and returns
words or bool verdicts.  On a CUDA tensor it launches its kernel (built
from this directory's sources by ops/_build.py) and adds one to its
entry in ``LAUNCHES`` (the cios build) or ``MMA_LAUNCHES`` (the mma
build); on a CPU tensor it runs its plain PyTorch version, which
converts to the 15 x 26-bit limbs of ops/limbs.py (Fr: the 10 limbs of
ops/modfield.py) and calls the staged functions that mirror the JAX
reference.  There is no fallback: a CUDA tensor never reaches the plain
version through a wrapper.

Every wrapper takes ``engine``: ``"cios"`` (the default) or ``"mma"``,
the Montgomery product its kernel is built with (``ENGINE_OF`` maps the
resolved paths of ops/mxu.py onto them: vpu -> cios, mxu -> mma).  On
the CPU its plain version runs with the matching plain product pinned
(``mxu.engine``).

Every wrapper checks its arguments and hands them to ``dispatch``, which
picks the plain version or the kernel and counts the launch.  A
wrapper's internal ``_run_*`` takes the library to call as its first
argument: the CUDA build, or (tests) the host C++ build of the same
sources.  Scratch tensors are freed when ``_run_*`` returns while the
kernel may still run: the caching allocator reuses a block only in the
order of the stream the kernel was launched on, which is PyTorch's
current stream for every launch here.

Layouts (words): G1 affine (n, 2, 12); G1 Jacobian (n, 3, 12); G2 affine
(n, 2, 2, 12); G2 Jacobian (n, 3, 2, 12); Fq12 (n, 12, 12) in the
component order c0.c0.c0, c0.c0.c1, ..., c1.c2.c1.
"""

import ctypes
import sys

import torch

from .. import _build
from .. import mxu

NAMES = ("fp381_ops", "g1_validate", "prepare", "h2c", "scalars_group",
         "scalars_msm", "miller", "finish", "kzg_eval", "kzg_fold", "kzg_msm",
         "gather_hm", "scalars", "lane_affine", "shard_partials",
         "aggregate_points")
LAUNCHES = {name: 0 for name in NAMES}          # cios-engine launches
MMA_LAUNCHES = {name: 0 for name in NAMES}      # mma-engine launches
ENGINES = _build.ENGINES
# the kernel build of each resolved Montgomery path (ops/mxu.py)
ENGINE_OF = {"vpu": "cios", "mxu": "mma"}
PATH_OF = {e: p for p, e in ENGINE_OF.items()}


def reset_launches() -> None:
    for counts in (LAUNCHES, MMA_LAUNCHES):
        for k in counts:
            counts[k] = 0


def count_launch(name: str, engine: str) -> None:
    (MMA_LAUNCHES if engine == "mma" else LAUNCHES)[name] += 1


def plain_engine(engine: str):
    """The plain versions' product for a kernel engine, pinned for a
    block on this thread."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return mxu.engine(PATH_OF[engine])


def lib_args(engine: str) -> dict:
    """The keyword arguments that select `engine`'s library from lib():
    none for cios, the default, so a ``lib`` that takes no engine (a
    test's stand-in for the host build) still serves the cios build."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return {} if engine == "cios" else {"engine": engine}


def check_tensor(t, name, dtype, shape, device):
    """Raise unless t has the dtype, shape (None = any) and device the
    kernel takes, and is contiguous."""
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes "
                         f"{shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def on_card(t) -> bool:
    """Dispatch rule: CUDA tensor -> kernel, CPU tensor -> plain version.
    A kernel launches on the current device, so a tensor on another
    card is refused."""
    if t.device.type == "cuda":
        current = torch.cuda.current_device()
        if t.device.index not in (None, current):
            raise ValueError(f"tensor on {t.device}, current device is "
                             f"cuda:{current}")
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def lib(source: str, host: bool = False, engine: str = "cios"):
    return _build.library(source, host=host, engine=engine)


def dispatch(module: str, name: str, source: str, engine: str, plain, run,
             *args):
    """The one branch of every wrapper, on its checked arguments: on the
    CPU (the first tensor of `args` lies there) `plain(*args)` with
    `engine`'s plain product pinned; on the card one launch counted for
    `name` on `engine` and `run(library, *args)` with `source`'s library
    of that engine.  `module` names the wrapper's module, whose own
    ``on_card`` and ``lib`` decide (tests point them at the host build)."""
    wrapper = sys.modules[module]
    if not wrapper.on_card(next(a for a in args if torch.is_tensor(a))):
        with plain_engine(engine):
            return plain(*args)
    count_launch(name, engine)
    return run(wrapper.lib(source, **lib_args(engine)), *args)


ptr = _build.ptr
LONG = ctypes.c_long
INT = ctypes.c_int
