"""Wrappers of the hand-written CUDA kernels, with their plain versions.

Every wrapper takes canonical plain words (int32 bit patterns of 12
little-endian 32-bit words per Fq element, 8 per Fr element) and returns
words or bool verdicts.  On a CUDA tensor it launches its kernel (built
from this directory's sources by ops/_build.py) and adds one to its
entry in ``LAUNCHES``; on a CPU tensor it runs its plain PyTorch
version, which converts to the 15 x 26-bit limbs of ops/limbs.py (Fr:
the 10 limbs of ops/modfield.py) and calls the staged functions that
mirror the JAX reference.  There is no fallback: a CUDA tensor never
reaches the plain version through a wrapper.

A wrapper's internal ``_run_*`` takes the library to call as its first
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

import torch

from .. import _build

LAUNCHES = {name: 0 for name in (
    "fp381_ops", "g1_validate", "prepare", "h2c", "scalars_group",
    "scalars_msm", "miller", "finish", "kzg_eval", "kzg_fold", "kzg_msm")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def lib(source: str, host: bool = False):
    return _build.library(source, host=host)


ptr = _build.ptr
LONG = ctypes.c_long
INT = ctypes.c_int
