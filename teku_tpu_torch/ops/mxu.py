"""The Montgomery product's engine rule and the int8 digit-split product.

The port of teku_tpu/ops/mxu.py.  Two engines build the 2L schoolbook
product columns of a Montgomery product; the field's own reduction
follows either one unchanged:

- ``vpu`` -- elementwise limb products (ops/limbs.py, ops/modfield.py);
  on the card, the CUDA-core CIOS product of kernels/fp381.cuh and
  kernels/fr255.cuh (the ``cios`` build of every kernel source);
- ``mxu`` -- the product columns as int8 digit outer products
  (``make_digit_kernels``, the plain version); on the card, the
  tensor-core ``mma`` product of kernels/mma_digits.cuh (the ``mma``
  build).

The path rule keeps the reference's names and its device rule.  The
configured path is one of ``PATHS``; ``resolve()`` gives the engine that
serves it.  The reference takes ``mxu`` only on a TPU, and the port runs
on none, so:

- ``vpu`` -> vpu;
- ``auto`` -> vpu (on the CPU and on CUDA alike);
- ``mxu`` -> vpu, with ONE warning (the reference's demotion off a TPU);
- ``mxu-force`` -> mxu (tests and A/B runs).

The path is process-global config, set by ``set_path`` / ``force`` (the
port reads no environment variable).  A provider resolves it once, when
it is built, and passes the engine down explicitly; ``engine(resolved)``
pins it for the plain calls of one block on this thread, so a
``set_path`` in the middle of a batch does not switch engines between
its stages.
"""

import contextlib
import logging
import threading

import torch

_LOG = logging.getLogger(__name__)

DIGIT_BITS = 7                        # int8 digit width (unsigned part)
PATHS = ("vpu", "mxu", "auto", "mxu-force")
RESOLVED = ("vpu", "mxu")             # what resolve() returns

# The lazy-reduction operand contract: units(a) * units(b) <= 64 means
# either operand alone is a signed sum of at most 64 units, each with
# |value| < 2M -- so |value| < 64 * 2M = 2^(UNITS_SLACK_BITS) * M.
UNITS_SLACK_BITS = 7

_lock = threading.Lock()
_state = {"path": None}               # None -> auto
_warned_fallback = [False]
_local = threading.local()            # .engine: pinned by engine()


def set_path(path) -> None:
    """Install the process-global multiplier path.  ``None`` resets to
    the default (auto)."""
    if path is not None and path not in PATHS:
        raise ValueError(
            f"unknown mont_mul path {path!r} (use one of {'/'.join(PATHS)})")
    with _lock:
        _state["path"] = path
        _warned_fallback[0] = False   # a reconfigure may warn once again


def get_path() -> str:
    """The CONFIGURED path (may be 'auto'); see resolve() for the
    effective one."""
    configured = _state["path"]
    return "auto" if configured is None else configured


def _device_is_tpu() -> bool:
    """The reference's device clause: the port dispatches to no TPU."""
    return False


def resolve(path=None) -> str:
    """The EFFECTIVE engine of the configured path (or of `path`, one of
    ``PATHS``): 'vpu' or 'mxu'.

    Explicit ``mxu`` off a TPU falls back to vpu with one warning, as
    the reference's rule does (its flight-recorder note is left out)."""
    if path is not None and path not in PATHS:
        raise ValueError(
            f"unknown mont_mul path {path!r} (use one of {'/'.join(PATHS)})")
    configured = get_path() if path is None else path
    if configured == "vpu":
        return "vpu"
    if configured == "mxu-force":
        return "mxu"
    is_tpu = _device_is_tpu()
    if configured == "auto":
        return "mxu" if is_tpu else "vpu"
    if is_tpu:
        return "mxu"
    with _lock:
        if not _warned_fallback[0]:
            _warned_fallback[0] = True
            _LOG.warning(
                "--mont-path mxu requested but the dispatch device is "
                "not a TPU; falling back to the vpu path (use mxu-force "
                "to override for A/B testing)")
    return "vpu"


def current() -> str:
    """The engine of the next plain product on this thread: the one
    pinned by ``engine()``, else the configured path's."""
    pinned = getattr(_local, "engine", None)
    return pinned if pinned is not None else resolve()


def active() -> bool:
    """True when the next plain mont_mul should take the digit path."""
    return current() == "mxu"


@contextlib.contextmanager
def engine(resolved: str):
    """Pin a resolved engine ('vpu' | 'mxu') for the plain products of
    this block on this thread."""
    if resolved not in RESOLVED:
        raise ValueError(f"unknown engine {resolved!r} (use one of "
                         f"{'/'.join(RESOLVED)})")
    prev = getattr(_local, "engine", None)
    _local.engine = resolved
    try:
        yield
    finally:
        _local.engine = prev


class force:
    """Context manager pinning the configured path (tests / A/B):

        with mxu.force("mxu-force"):
            out = limbs.mont_mul(a, b)
    """

    def __init__(self, path: str):
        self._path = path
        self._prev = None

    def __enter__(self):
        self._prev = _state["path"]
        set_path(self._path)
        return self

    def __exit__(self, *exc):
        set_path(self._prev)
        return False


# --------------------------------------------------------------------------
# The plain digit kernels (shared by ops/limbs.py and ops/modfield.py)
# --------------------------------------------------------------------------

def make_digit_kernels(L: int, W: int, modulus_bits: int,
                       compress, mont_reduce):
    """Build (mont_mul_mxu, mont_sqr_mxu) for one fixed-width field: the
    reference's digit split, int8 outer product into int32, digit-plane
    fold, limb anti-diagonal fold and plane weights, then the field's
    own `mont_reduce`.  Every column is an exact integer sum, so the
    lazy limbs out equal the reference's bit for bit.

    Column bound: digit products are < 2^14, a p+q=s plane sums at most
    nd of them (< 2^16), an anti-diagonal at most L planes (< 2^20), all
    exact in int32; the int64 columns are < L * 2^(2W + slack) < 2^60.
    """
    top_bits = modulus_bits + UNITS_SLACK_BITS + 1 - W * (L - 1)
    need_bits = max(W, top_bits)
    nd = -(-need_bits // DIGIT_BITS)
    if need_bits > DIGIT_BITS * (nd - 1) + 7:
        nd += 1  # pragma: no cover - only for exotic (W, modulus) combos
    dmask = (1 << DIGIT_BITS) - 1
    n_planes = 2 * nd - 1
    consts: dict = {}

    def _consts(device):
        key = str(device)
        c = consts.get(key)
        if c is None:
            shifts = torch.arange(nd, dtype=torch.int64,
                                  device=device) * DIGIT_BITS
            # limb anti-diagonal of each (i, j): k = i + j
            diag = torch.tensor([i + j for i in range(L) for j in range(L)],
                                dtype=torch.int64, device=device)
            c = consts[key] = (shifts, diag)
        return c

    def digit_split(a):
        """(..., L) compressed limbs -> (..., L, nd) int8 digits; the
        last digit of a limb is left unmasked (it carries the signed top
        limb's sign and overflow)."""
        shifts, _ = _consts(a.device)
        d = a[..., :, None] >> shifts
        d = torch.cat([d[..., :nd - 1] & dmask, d[..., nd - 1:]], dim=-1)
        return d.to(torch.int8)

    def _columns(da, db):
        """Digit arrays (..., L, nd) -> int64 product columns (..., 2L)."""
        _, diag = _consts(da.device)
        batch = da.shape[:-2]
        # the int8 outer product, taken in int32 (an int8 product would
        # wrap): (L nd) x (L nd) digit products per lane pair
        a2 = da.to(torch.int32).reshape(batch + (L * nd, 1))
        b2 = db.to(torch.int32).reshape(batch + (1, L * nd))
        outer = (a2 * b2).reshape(batch + (L, nd, L, nd))
        # fold digit planes p + q = s
        planes = torch.zeros(batch + (L, L, n_planes), dtype=torch.int32,
                             device=da.device)
        for p in range(nd):
            for q in range(nd):
                planes[..., p + q] += outer[..., :, p, :, q]
        # fold limb anti-diagonals i + j = k
        t = torch.zeros(batch + (2 * L, n_planes), dtype=torch.int32,
                        device=da.device)
        t.index_add_(-2, diag, planes.reshape(batch + (L * L, n_planes)))
        # weight the planes back into int64 limb columns
        t = t.to(torch.int64)
        out = t[..., 0].clone()
        for s in range(1, n_planes):
            out += t[..., s] << (DIGIT_BITS * s)
        return out

    def mont_mul_mxu(a, b):
        a, b = torch.broadcast_tensors(a, b)
        t = _columns(digit_split(compress(a)), digit_split(compress(b)))
        return mont_reduce(t)

    def mont_sqr_mxu(a):
        da = digit_split(compress(a))
        return mont_reduce(_columns(da, da))

    mont_mul_mxu.digits = mont_sqr_mxu.digits = nd
    return mont_mul_mxu, mont_sqr_mxu
