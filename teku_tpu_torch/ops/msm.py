"""GLV + Pippenger scalars stage in plain PyTorch, mirroring teku_tpu/ops/msm.py.

The r-weighted folds of a verify batch -- sum_i [r_i]pk_i per message
row and sum_i [r_i]sig_i over the batch -- are multi-scalar
multiplications.  This path replaces the per-lane 64-bit ladder with:

1. GLV sampling.  phi(x, y) = (beta x, y) acts as [LAMBDA] on G1 and
   -psi^2 as [LAMBDA] on G2 (LAMBDA = -z^2 mod r).  The multipliers are
   drawn already split, (k1, k2) in [0, 2^32)^2 minus (0, 0), with
   effective multiplier k1 + k2 LAMBDA mod r, so every scalar walk is
   32 bits.
2. Pippenger buckets.  For each (row, window) the columns' w-bit digits
   accumulate into 2^w - 1 buckets (every column does the same work,
   whatever its digit), the buckets collapse by suffix sums, and the
   windows combine Horner-style: one doubling chain per row, not one
   per lane.

Path selection (``set_path`` / ``force``, process-global, resolved per
dispatch by ``explain``): ``ladder``, ``pippenger``, or ``auto``.  The
reference's auto picks pippenger only on a TPU, the device its crossover
was tuned for; the port runs on no such device, so auto resolves to the
ladder on the CPU and on CUDA cards alike.  The path reads no
environment.

The functions below keep the reference's formulas and order on the
15 x 26-bit limbs of ops/limbs.py, so their outputs equal the JAX
functions' bit for bit; ops/kernels/msm.cu computes the same values on
the card.
"""

import numpy as np
import torch

from ..crypto.bls.constants import R, X_ABS
from . import limbs as fp
from . import points as PT
from . import towers as T

PATHS = ("ladder", "pippenger", "auto")

# half-scalar width: multipliers are sampled as (k1, k2) in [0, 2^32)^2
GLV_BITS = 32

# phi = [LAMBDA] on G1, -psi^2 = [LAMBDA] on G2 (z < 0, so z^2 = X_ABS^2)
LAMBDA = (-(X_ABS * X_ABS)) % R

WINDOW = 4            # digit width w: 2^w - 1 = 15 buckets per window
G2_SEG = 32           # G2 columns per bucket-accumulation segment
# the reference's auto crossover (lanes >= AUTO_MIN_LANES and lanes / rows
# >= AUTO_MIN_DUP), tuned on the TPU.  Unused until a crossover measured
# on an H100 (a lanes x duplication sweep of scalars_msm against
# scalars_group) gives auto a rule for the card; until then auto takes
# the ladder everywhere, as the reference does off a TPU
AUTO_MIN_LANES = 32
AUTO_MIN_DUP = 2.0

_state = {"path": "auto"}


def set_path(path) -> None:
    """Install the process-global MSM path; ``None`` resets to auto."""
    if path is not None and path not in PATHS:
        raise ValueError(
            f"unknown msm path {path!r} (use one of {'/'.join(PATHS)})")
    _state["path"] = "auto" if path is None else path


def get_path() -> str:
    """The configured path (may be 'auto'); see explain()."""
    return _state["path"]


def explain(lanes=None, rows=None, device=None, sharded: bool = False):
    """(path, why) for one dispatch: the effective path ('ladder' or
    'pippenger') and the decision context -- configured path, lanes,
    rows, dispatch device, the rule.  ``why`` mirrors the record of the
    reference's explain (its dispatch ledger stores it); the provider
    itself only calls resolve().  ``sharded=True`` is the legacy
    lane-sharded form (parallel.ShardedVerifier), whose lane shards split
    message groups: it always takes the ladder, whatever is configured.
    The group-aligned mesh resolves with sharded=False."""
    why = {"configured": get_path(), "lanes": lanes, "rows": rows}
    if sharded:
        why["rule"] = "legacy lane-sharded kernel always ladders"
        return "ladder", why
    configured = why["configured"]
    if configured in ("ladder", "pippenger"):
        why["rule"] = "explicitly configured"
        return configured, why
    why["device"] = None if device is None else torch.device(device).type
    why["tpu"] = False
    why["rule"] = "auto: dispatch device is not a TPU"
    return "ladder", why


def resolve(lanes=None, rows=None, device=None, sharded: bool = False) -> str:
    return explain(lanes=lanes, rows=rows, device=device,
                   sharded=sharded)[0]


class force:
    """Context manager pinning the path (tests, A/B runs)."""

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
# Window geometry + host-side digit packing
# --------------------------------------------------------------------------

def n_windows(window: int) -> int:
    return -(-GLV_BITS // window)


def window_for_nwin(nwin: int) -> int:
    """Invert n_windows: the digit array's shape carries the window."""
    return -(-GLV_BITS // nwin)


def effective_scalar(k1: int, k2: int) -> int:
    """The multiplier a (k1, k2) pair encodes: k1 + k2 LAMBDA mod r."""
    return (int(k1) + int(k2) * LAMBDA) % R


def glv_sample_from_uint64(raw: np.ndarray):
    """uint64 entropy (N,) -> (k1, k2) 32-bit halves; (0, 0), the only
    pair with effective multiplier 0, is nudged to (1, 0)."""
    raw = np.asarray(raw, dtype=np.uint64)
    k1 = (raw & np.uint64(0xFFFFFFFF)).copy()
    k2 = raw >> np.uint64(32)
    k1[(k1 | k2) == 0] = 1
    return k1, k2


def glv_digits_np(k1, k2, window: int = WINDOW) -> np.ndarray:
    """Half-scalars (N,) -> (N, 2, nwin) int32 w-bit digits, MSB first.
    Row [:, 0] drives the point P, row [:, 1] its image [LAMBDA]P."""
    nwin = n_windows(window)
    k1 = np.asarray(k1, dtype=np.uint64)
    k2 = np.asarray(k2, dtype=np.uint64)
    if k1.size and (int(k1.max()) >> GLV_BITS or int(k2.max()) >> GLV_BITS):
        raise ValueError("GLV half-scalars must be < 2^%d" % GLV_BITS)
    mask = np.uint64((1 << window) - 1)
    out = np.zeros(k1.shape + (2, nwin), dtype=np.int32)
    for j in range(nwin):
        shift = np.uint64((nwin - 1 - j) * window)
        out[..., 0, j] = ((k1 >> shift) & mask).astype(np.int32)
        out[..., 1, j] = ((k2 >> shift) & mask).astype(np.int32)
    return out


# --------------------------------------------------------------------------
# Bucket accumulate -> reduce -> window combine
# --------------------------------------------------------------------------

def _infinity_batch(kit, like_elem, batch_shape):
    """Infinity with an explicit batch shape, on like_elem's device."""
    template = fp.tree_map(
        lambda a: a.new_zeros(tuple(batch_shape) + a.shape[-1:]), like_elem)
    return PT.infinity_like(kit, template)


def bucket_accumulate(kit, pts, digits, include):
    """Per-(row, window, bucket) sums.

    pts: point with leaves (R, C, L); digits (R, C, nwin) in [0, 2^w);
    include (R, C).  Returns buckets with leaves (R, nwin, B, L),
    B = 2^w - 1: bucket b holds the sum of the included points whose
    digit is b + 1.  Each column gathers every (row, window)'s target
    bucket, does one batched point_add and selects it back, whatever
    the digits; digit 0 and excluded columns keep the bucket."""
    rows, cols, nwin = digits.shape
    B = (1 << window_for_nwin(nwin)) - 1
    buckets = _infinity_batch(kit, pts[0], (rows, nwin, B))
    barange = torch.arange(B, device=digits.device)
    for c in range(cols):
        p = fp.tree_map(lambda a: a[:, c], pts)           # leaves (R, L)
        d = digits[:, c].to(torch.int64)                  # (R, nwin)
        idx = torch.clamp(d - 1, min=0)

        def take(leaf):                   # (R, nwin, B, L) -> (R, nwin, L)
            i = idx[..., None, None].expand(idx.shape + (1, leaf.shape[-1]))
            return torch.gather(leaf, 2, i)[..., 0, :]

        cur = fp.tree_map(take, buckets)
        pb = fp.tree_map(lambda a: a[:, None].expand(
            (rows, nwin) + a.shape[1:]), p)
        added = PT.point_add(kit, cur, pb)
        hit = ((barange == idx[..., None]) & (d >= 1)[..., None]
               & include[:, c][:, None, None])            # (R, nwin, B)
        added_b = fp.tree_map(lambda a: a[..., None, :].expand(
            a.shape[:-1] + (B, a.shape[-1])), added)
        buckets = PT._select_point(kit, hit, added_b, buckets)
    return buckets


def bucket_reduce(kit, buckets):
    """(R, nwin, B) buckets -> (R, nwin) sums of (b + 1) B_b, by the
    top-down suffix sums (2 adds per bucket)."""
    leaf = PT._leaf(buckets)
    rows, nwin, B = leaf.shape[:3]
    acc = tot = _infinity_batch(kit, buckets[0], (rows, nwin))
    for b in reversed(range(B)):
        acc = PT.point_add(kit, acc, fp.tree_map(lambda a: a[:, :, b],
                                                 buckets))
        tot = PT.point_add(kit, tot, acc)
    return tot


def window_combine(kit, wsums, window: int):
    """Horner fold of (R, nwin) window sums, MSB first: w doublings and
    one add per window."""
    nwin = PT._leaf(wsums).shape[1]
    acc = fp.tree_map(lambda a: a[:, 0], wsums)
    for j in range(1, nwin):
        for _ in range(window):
            acc = PT.point_double(kit, acc)
        acc = PT.point_add(kit, acc, fp.tree_map(lambda a: a[:, j], wsums))
    return acc


def msm_rows(kit, pts, digits, include):
    """R independent MSMs: row r sums [s_rc]P_rc over its included
    columns, s_rc the MSB-first recomposition of digits[r, c]."""
    w = window_for_nwin(digits.shape[-1])
    buckets = bucket_accumulate(kit, pts, digits, include)
    return window_combine(kit, bucket_reduce(kit, buckets), w)


# --------------------------------------------------------------------------
# The two pipeline MSMs
# --------------------------------------------------------------------------

def g1_grouped_msm(pk_jac, digits, group_idx, group_present, miller_mask):
    """Per-row G1 fold over 2G columns [lanes | phi(lanes)]: lanes masked
    by miller_mask enter as infinity, group padding is excluded, padded
    rows come out infinity.  Returns (U,) Jacobian aggregates."""
    G1 = PT.G1_KIT
    inf = PT.infinity_like(G1, pk_jac[0])
    masked = PT._select_point(G1, miller_mask, pk_jac, inf)
    gidx = group_idx.to(torch.int64)
    grouped = fp.tree_map(lambda x: x[gidx], masked)      # (U, G, L)
    phi = PT.g1_phi(grouped)
    pts = fp.tree_map2(lambda a, b: torch.cat([a, b], dim=1), grouped, phi)
    dg = digits[gidx]                                     # (U, G, 2, nwin)
    dg = torch.cat([dg[:, :, 0], dg[:, :, 1]], dim=1)
    inc = torch.cat([group_present, group_present], dim=1)
    return msm_rows(G1, pts, dg, inc)


def g2_lambda_point(q):
    """[LAMBDA]Q = -psi(psi(Q)) on G2, coordinates compressed."""
    lam = PT.point_neg(PT.G2_KIT, PT.g2_psi(PT.g2_psi(q)))
    return tuple(T.fq2_compress(c) for c in lam)


def g2_msm(sig_jac, digits):
    """sum_i [r_i]sig_i as one MSM over 2N columns [sig | LAMBDA sig],
    in segments of G2_SEG columns whose bucket tables merge by
    point_batch_sum's pairwise order before one reduce and Horner.
    Returns a (1,)-batched Jacobian point."""
    G2 = PT.G2_KIT
    lam = g2_lambda_point(sig_jac)
    pts = fp.tree_map2(lambda a, b: torch.cat([a, b], dim=0), sig_jac, lam)
    dg = torch.cat([digits[:, 0], digits[:, 1]], dim=0)  # (2N, nwin)
    n2 = dg.shape[0]
    C = min(G2_SEG, n2)
    S = n2 // C                       # lane buckets are pow-2: exact split
    pts_r = fp.tree_map(lambda a: a.reshape((S, C) + a.shape[1:]), pts)
    dg_r = dg.reshape(S, C, dg.shape[-1])
    inc = torch.ones((S, C), dtype=torch.bool, device=dg.device)
    buckets = bucket_accumulate(G2, pts_r, dg_r, inc)
    if S > 1:
        merged = PT.point_batch_sum(G2, buckets)          # (nwin, B)
    else:
        merged = fp.tree_map(lambda a: a[0], buckets)
    merged = fp.tree_map(lambda a: a[None], merged)       # (1, nwin, B)
    wsums = bucket_reduce(G2, merged)                     # (1, nwin)
    return window_combine(G2, wsums, window_for_nwin(dg.shape[-1]))
