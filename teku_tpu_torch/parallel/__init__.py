"""Multi-device verify: a mesh of torch devices and the sharded dispatch.

The port of teku_tpu/parallel/__init__.py.  The reference's mesh is one
process over its local devices: a jax Mesh, shard_map running each shard
on its own device, and one all_gather of a per-shard Fq12 product and G2
sum before the final exponentiation.  Here one process holds an explicit
list of ``torch.device``: each shard's kernel chain is enqueued under
``torch.cuda.device(d)`` on that device's current stream (a CPU device
enters nothing and runs the plain versions), the partials come back to
the first device by ``.to()`` copies, and ``finish`` runs once there --
one process needs the verdict once.  There is no process group.  A
virtual mesh lists one device several times, as the reference's tests
run an 8-virtual-device CPU mesh.

``TorchBls12381(mesh=...)`` dispatches through ``GroupShardedVerifier``:
whole message-group rows per shard (``plan_group_shards``), so every
shard keeps the dedup pipeline (grouped Miller rows, either scalars
path).  ``ShardedVerifier`` is the legacy lane-sharded form: a Miller
row per lane, always the ladder.

Left out until the port has its infra layer: the ``bls_mesh_devices``
gauge, the flight recorder's config-demotion record and the AOT-store
kernel names.
"""

import contextlib
import logging
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build
from ..ops import mxu
from ..ops.kernels import ENGINE_OF
from ..ops.kernels import decompress as KD
from ..ops.kernels import msm as KM
from ..ops.kernels import pairing as KP
from ..ops.kernels import scalars_group as KS
from ..ops.kernels import shard as KSH
from ..ops.shapeset import floor_pow2 as _floor_pow2
from ..ops.shapeset import next_pow2 as _next_pow2

_LOG = logging.getLogger(__name__)

DEFAULT_AXIS = "dp"

# the last advertised mesh's self-description
_ACTIVE = {"devices": [], "n": 0, "axis": DEFAULT_AXIS}
_lock = threading.Lock()
_warned_demotion = [False]


class Mesh:
    """A 1-D mesh: the shards' devices in order, and the axis name."""

    __slots__ = ("devices", "axis")

    def __init__(self, devices: Sequence, axis: str = DEFAULT_AXIS):
        self.devices = [torch.device(d) for d in devices]
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)


def describe_mesh() -> dict:
    """The advertised mesh's self-description."""
    with _lock:
        return {"devices": list(_ACTIVE["devices"]),
                "n_devices": _ACTIVE["n"], "axis": _ACTIVE["axis"]}


def reset_active_mesh() -> None:
    """Clear the advertised mesh (dispatch went back to one device)."""
    with _lock:
        _ACTIVE["devices"] = []
        _ACTIVE["n"] = 0


def advertise_mesh(device_names: Sequence[str],
                   axis: str = DEFAULT_AXIS) -> None:
    """Publish the serving mesh's self-description and log it."""
    names = [str(d) for d in device_names]
    with _lock:
        _ACTIVE["devices"] = names
        _ACTIVE["n"] = len(names)
        _ACTIVE["axis"] = axis
    _LOG.info("verify mesh: %d device(s) over axis %r: %s",
              len(names), axis, ", ".join(names))


def resolve_mesh_devices(spec, available: Optional[int] = None) -> int:
    """Resolve a mesh spec (off / auto / N) to a usable device count.

    0 means no mesh.  ``auto`` takes the largest power of two <= the
    available devices; an explicit N demotes to the largest power of two
    <= min(N, available), with one warning; a spec that is none of these
    disables the mesh, with one warning."""
    if spec is None:
        return 0
    raw = str(spec).strip().lower()
    if raw in ("", "off", "0", "none", "false", "no"):
        return 0
    if available is None:
        available = torch.cuda.device_count()
    if raw == "auto":
        n = _floor_pow2(max(available, 1))
        return n if n >= 2 else 0
    try:
        requested = int(raw)
    except ValueError:
        if not _warned_demotion[0]:
            _warned_demotion[0] = True
            _LOG.warning("mesh spec %r is not off/auto/N; mesh disabled",
                         spec)
        return 0
    if requested <= 1:
        return 0
    n = _floor_pow2(min(requested, max(available, 1)))
    if n != requested and not _warned_demotion[0]:
        _warned_demotion[0] = True
        _LOG.warning(
            "mesh of %d devices unavailable (have %d, shards must be "
            "a power of two); demoting to a %d-device mesh",
            requested, available, n)
    return n if n >= 2 else 0


def make_mesh(n_devices: Optional[int] = None, axis: str = DEFAULT_AXIS,
              devices=None, advertise: bool = True) -> Mesh:
    """A mesh over the first n CUDA cards, or over an explicit device
    list (``devices=[cuda:0] * 4`` is a virtual mesh on one card,
    ``["cpu"] * 4`` one on the host)."""
    if devices is None:
        count = torch.cuda.device_count()
        if n_devices is not None and count < n_devices:
            raise ValueError(f"need {n_devices} devices, have {count}")
        devices = [torch.device("cuda", i)
                   for i in range(count if n_devices is None else n_devices)]
    else:
        devices = list(devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    mesh = Mesh(devices, axis)
    if advertise:
        advertise_mesh(mesh.devices, axis)
    return mesh


class ShardPlan:
    """Host-side group-aligned shard layout for one dispatch.

    ``lane_pos[i]`` is the global (permuted) lane slot of original lane
    i: each shard's contiguous lane block holds exactly the lanes of the
    rows that shard owns.  ``row_layout[p]`` is the canonical row index
    in global row slot p (-1 = padding row).  All shapes are pow-2 and
    equal across shards."""

    __slots__ = ("n_shards", "lanes_per_shard", "rows_per_shard",
                 "padded", "rows_total", "lane_pos", "row_layout",
                 "shard_lanes", "shard_rows")

    def __init__(self, n_shards, lanes_per_shard, rows_per_shard,
                 lane_pos, row_layout, shard_lanes=None, shard_rows=None):
        self.n_shards = n_shards
        self.lanes_per_shard = lanes_per_shard
        self.rows_per_shard = rows_per_shard
        self.padded = n_shards * lanes_per_shard
        self.rows_total = n_shards * rows_per_shard
        self.lane_pos = lane_pos
        self.row_layout = row_layout
        # the per-shard real loads (before padding)
        self.shard_lanes = list(shard_lanes or [])
        self.shard_rows = list(shard_rows or [])

    @property
    def makespan_ratio(self) -> float:
        """max shard lane load / mean shard lane load (>= 1.0)."""
        total = sum(self.shard_lanes)
        if not total or not self.n_shards:
            return 0.0
        return max(self.shard_lanes) / (total / self.n_shards)


def plan_group_shards(rows: Sequence[Tuple[int, List[int]]],
                      n_lanes: int, n_shards: int, min_lanes: int = 1,
                      min_rows: int = 1) -> ShardPlan:
    """Pack message-group rows onto shards, whole rows only: longest rows
    first, each onto the least-loaded shard; each shard's lane and row
    blocks pad to the same pow-2.  ``min_lanes`` / ``min_rows`` are
    per-shard floors."""
    m = n_shards
    order = sorted(range(len(rows)), key=lambda r: -len(rows[r][1]))
    bin_rows: List[List[int]] = [[] for _ in range(m)]
    bin_lanes = [0] * m
    for r in order:
        b = min(range(m), key=lambda i: (bin_lanes[i], len(bin_rows[i]), i))
        bin_rows[b].append(r)
        bin_lanes[b] += len(rows[r][1])
    lanes_per = max(_next_pow2(max(bin_lanes + [1])),
                    _next_pow2(max(min_lanes, 1)))
    rows_per = max(_next_pow2(max([len(br) for br in bin_rows] + [1])),
                   _next_pow2(max(min_rows, 1)))
    lane_pos = np.zeros(n_lanes, dtype=np.int64)
    row_layout = np.full(m * rows_per, -1, dtype=np.int64)
    for s in range(m):
        cursor = s * lanes_per
        for k, r in enumerate(bin_rows[s]):
            row_layout[s * rows_per + k] = r
            for i in rows[r][1]:
                lane_pos[i] = cursor
                cursor += 1
    return ShardPlan(m, lanes_per, rows_per, lane_pos, row_layout,
                     shard_lanes=bin_lanes,
                     shard_rows=[len(br) for br in bin_rows])


# --------------------------------------------------------------------------
# The sharded kernel chains
# --------------------------------------------------------------------------

def _on(dev: torch.device):
    """Launches on `dev`: its CUDA device entered (a kernel launches on
    the current device); a CPU device enters nothing."""
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _init_devices(mesh: Mesh) -> None:
    """Init the kernel libraries once on each CUDA card of the mesh."""
    for index in sorted({torch.cuda.current_device() if d.index is None
                         else d.index for d in mesh.devices
                         if d.type == "cuda"}):
        _build.init_device(index)


def _put(x, dev: torch.device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def run_shards(devices: Sequence[torch.device], shard_fn, arrays: dict,
               engine: str = "cios"):
    """Cut every array of `arrays` (numpy or tensors, leading axis the
    lanes or the rows) into one equal block per device, run
    ``shard_fn(block dict) -> (product, sum, lane_ok)`` on each device,
    gather the partials to the first device and run finish (built with
    `engine`) there once.  Returns (ok (1,), lane_ok) in the shard
    layout's lane order."""
    n, dev0 = len(devices), devices[0]
    prods, sums, lane_oks = [], [], []
    for s, dev in enumerate(devices):
        with _on(dev):
            block = {}
            for k, v in arrays.items():
                if v.shape[0] % n:
                    raise ValueError(f"{k}: leading axis {v.shape[0]} does "
                                     f"not split into {n} shards")
                size = v.shape[0] // n
                block[k] = _put(v[s * size:(s + 1) * size], dev)
            prod, ssum, lane_ok = shard_fn(block)
        prods.append(prod.to(dev0))
        sums.append(ssum.to(dev0))
        lane_oks.append(lane_ok.to(dev0))
    with _on(dev0):
        ok = KP.finish(torch.cat(prods), torch.cat(sums), engine=engine)
    return ok, torch.cat(lane_oks)


def _prepare(t, engine):
    return KD.prepare(t["pk_x"], t["pk_y"], t["pk_present"], t["sig_x0"],
                      t["sig_x1"], t["sig_large"], t["sig_inf"],
                      t["lane_valid"], engine=engine)


def grouped_shard(msm_path: str, engine: str = "cios"):
    """One shard of the group-aligned mesh: prepare -> scalars_group
    (ladder) or scalars_msm (pippenger) -> miller at the shard's row
    width -> shard_partials, every kernel built with `engine`.  Row
    arrays: group_idx (shard-local lane indices), group_present,
    hm_rows."""
    def shard_fn(t):
        pk_jac, sig_jac, lane_ok, mmask = _prepare(t, engine)
        if msm_path == "pippenger":
            agg, u_mask, wsig = KM.scalars_msm(
                pk_jac, sig_jac, t["glv_digits"], mmask, t["group_idx"],
                t["group_present"], engine=engine)
        else:
            agg, u_mask, wsig = KS.scalars_group(
                pk_jac, sig_jac, t["r"], mmask, t["group_idx"],
                t["group_present"], engine=engine)
        ml = KP.miller(agg, t["hm_rows"], u_mask, engine=engine)
        return (*KSH.shard_partials(ml, wsig, engine=engine), lane_ok)
    return shard_fn


def lane_shard(t, engine: str = "cios"):
    """One shard of the legacy lane-sharded form (the reference's
    _lane_work): prepare -> scalars -> lane_affine -> miller at lane
    width (hm: per-lane H(m) rows) -> shard_partials."""
    pk_jac, sig_jac, lane_ok, mmask = _prepare(t, engine)
    pk_r, wsig = KS.scalars(pk_jac, sig_jac, t["r"], engine=engine)
    ml = KP.miller(KSH.lane_affine(pk_r, engine=engine), t["hm"], mmask,
                   engine=engine)
    return (*KSH.shard_partials(ml, wsig, engine=engine), lane_ok)


def _mesh_size(mesh: Mesh) -> int:
    n = mesh.size
    if n & (n - 1):
        # pow-2 buckets must split evenly across shards
        raise ValueError("mesh size must be a power of two")
    return n


class ShardedVerifier:
    """Legacy lane-sharded dispatch: a Miller row per lane (message
    groups would cross shards, so the grouping and the MSM are given
    up), always the ladder.  Call it with global arrays in the kernels'
    word layout: (pk_x, pk_y, pk_present, hm (N, 2, 2, 12) per-lane H(m),
    sig_x0, sig_x1, sig_large, sig_inf, r (N,) int64, lane_valid); N
    must split into the mesh size.  Returns (ok, lane_ok).  The
    Montgomery engine is the process path's, resolved once, when the
    verifier is built (ops/mxu.py)."""

    KEYS = ("pk_x", "pk_y", "pk_present", "hm", "sig_x0", "sig_x1",
            "sig_large", "sig_inf", "r", "lane_valid")

    def __init__(self, mesh: Mesh, min_bucket: int = 16):
        self.mesh = mesh
        self.n_devices = _mesh_size(mesh)
        self.min_bucket = max(min_bucket, self.n_devices)
        self.mont_path = mxu.resolve()
        self.engine = ENGINE_OF[self.mont_path]
        _init_devices(mesh)

    def __call__(self, *args):
        engine = self.engine
        return run_shards(self.mesh.devices,
                          lambda t: lane_shard(t, engine),
                          dict(zip(self.KEYS, args, strict=True)), engine)


# process-level memo of the shard launch functions, keyed by (devices,
# axis, msm path, engine), as the reference memoises its sharded programs
# (its store name carries the mont path)
_KERNELS: dict = {}
_KERNELS_LOCK = threading.Lock()


class GroupShardedVerifier:
    """Group-aligned mesh dispatch: the per-dispatch shard planner
    (plan()) and one launch function per scalars path (kernel()), its
    kernels built with `engine` (the provider's)."""

    def __init__(self, mesh: Mesh, min_bucket: int = 16,
                 engine: str = "cios"):
        self.mesh = mesh
        self.engine = engine
        self.n_devices = _mesh_size(mesh)
        self.min_bucket = max(min_bucket, self.n_devices)
        _init_devices(mesh)
        self.devices = [str(d) for d in mesh.devices]

    def describe(self) -> dict:
        return {"devices": list(self.devices),
                "n_devices": self.n_devices, "axis": self.mesh.axis}

    def plan(self, rows, n_lanes: int, min_rows_total: int = 1) -> ShardPlan:
        return plan_group_shards(
            rows, n_lanes, self.n_devices,
            min_lanes=self.min_bucket // self.n_devices,
            min_rows=max(min_rows_total // self.n_devices, 1))

    def kernel_key(self, msm_path: str) -> tuple:
        return (tuple(self.devices), self.mesh.axis, msm_path)

    def kernel(self, msm_path: str):
        """run(arrays) -> (ok, lane_ok): the mesh's launch function for
        one scalars path.  ``arrays``: the lane-sharded pk_x, pk_y,
        pk_present, sig_x0, sig_x1, sig_large, sig_inf, lane_valid and r
        (ladder) or glv_digits (pippenger), and the row-sharded
        group_idx, group_present and hm_rows."""
        key = (*self.kernel_key(msm_path), self.engine)
        with _KERNELS_LOCK:
            fn = _KERNELS.get(key)
            if fn is None:
                engine = self.engine
                devices, shard_fn = list(self.mesh.devices), grouped_shard(
                    msm_path, engine)
                fn = _KERNELS[key] = (
                    lambda arrays: run_shards(devices, shard_fn, arrays,
                                              engine))
        return fn
