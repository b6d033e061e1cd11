"""TorchBls12381 -- the BLS provider SPI on PyTorch and the CUDA kernels.

The port of teku_tpu/ops/provider.py:JaxBls12381 without its metrics,
tracing and ledger hooks.  Host work as in the reference: wire
parse (flag bits, x < P), SHA-256 message expansion, the pubkey LRU with
one batched validation dispatch for its misses, unique-message dedup,
group rows (cap 32), pow-2 buckets, the device H(m) arena, and 64-bit
random multipliers from ``secrets``.  Device work: the kernel chain
prepare -> h2c (unique width) -> scalars -> miller -> finish
(ops/kernels/), where the scalars stage is the 64-bit ladder with the
per-row fold (scalars_group) or the GLV + Pippenger MSM (scalars_msm),
chosen per dispatch by ops/msm.py's path rule.  With ``mesh=`` (a
parallel.Mesh) a dispatch is group-aligned over the mesh's devices:
h2c once on the first device, gather_hm into the shard row layout, the
chain up to miller per shard, shard_partials, and one finish on the
gathered partials.  With ``device="cpu"`` (or a CPU mesh) the same chain
runs the kernels' plain PyTorch versions.  The Montgomery engine is
resolved once, when the provider is built (``mont_path``: ops/mxu.py's
rule over the ``mont_path`` argument or the process path), and every
kernel and plain call of its batches uses it: vpu -> the cios build,
mxu -> the mma build (tensor cores) and the plain digit product.  Rare
host-only SPI operations (key generation, signing, aggregation) go to
the port's copy of the pure-Python oracle.
"""

import hashlib
import secrets
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..crypto.bls import hash_to_curve as OH
from ..crypto.bls.constants import P
from ..crypto.bls.pure_impl import PureBls12381
from ..crypto.bls.spi import BLS12381, BatchSemiAggregate, ResolvedHandle
from . import h2c_cache as HC
from . import limbs as fp
from . import msm
from . import mxu
from . import kernels as K
from . import shapeset as SS
from .kernels import decompress as KD
from .kernels import h2c as KH
from .kernels import msm as KM
from .kernels import pairing as KP
from .kernels import scalars_group as KS
from .kernels import shard as KSH

G1_INF = bytes([0xC0] + [0] * 47)
G2_INF = bytes([0xC0] + [0] * 95)


def secret_multipliers(n: int) -> np.ndarray:
    """n random 64-bit batch multipliers from the OS entropy source."""
    return np.frombuffer(secrets.token_bytes(8 * n), dtype=np.uint64).copy()


class LruMap:
    """Bounded map evicting the least recently used entry (thread-safe)."""

    def __init__(self, max_size: int):
        self._max = max_size
        self._lock = threading.Lock()
        self._items: "OrderedDict" = OrderedDict()

    def get(self, key):
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
                return self._items[key]
            return None

    def put(self, key, value) -> None:
        with self._lock:
            self._items[key] = value
            self._items.move_to_end(key)
            if len(self._items) > self._max:
                self._items.popitem(last=False)

    def __len__(self) -> int:
        return len(self._items)


def parse_g2_wire(sig: bytes):
    """Compressed G2 signature -> (x bytes (2, 48), large, is_inf) or None."""
    if len(sig) != 96 or not sig[0] & 0x80:
        return None
    if sig[0] & 0x40:
        if any(sig[1:]) or (sig[0] & 0x3F):
            return None
        return (np.zeros((2, 48), dtype=np.uint8), False, True)
    x1 = int.from_bytes(bytes([sig[0] & 0x1F]) + sig[1:48], "big")
    x0 = int.from_bytes(sig[48:96], "big")
    if x0 >= P or x1 >= P:
        return None
    xb = np.frombuffer(sig, dtype=np.uint8).reshape(2, 48).copy()
    xb[0, 0] &= 0x1F
    return (xb, bool(sig[0] & 0x20), False)


def parse_g1_wire(pk: bytes):
    """Compressed G1 pubkey -> (x, large, is_inf) or None."""
    if len(pk) != 48 or not pk[0] & 0x80:
        return None
    if pk[0] & 0x40:
        if any(pk[1:]) or (pk[0] & 0x3F):
            return None
        return (0, False, True)
    x = int.from_bytes(bytes([pk[0] & 0x1F]) + pk[1:], "big")
    if x >= P:
        return None
    return (x, bool(pk[0] & 0x20), False)


class _Semi(BatchSemiAggregate):
    __slots__ = ("pk_words", "message", "sig_x_bytes", "sig_large",
                 "sig_inf")

    def __init__(self, pk_words, message, sig_x_bytes, sig_large, sig_inf):
        self.pk_words = pk_words        # list of (x, y) affine words (12,)
        self.message = message
        self.sig_x_bytes = sig_x_bytes  # (2, 48): x.c1 then x.c0, BE
        self.sig_large = sig_large
        self.sig_inf = sig_inf


class DispatchHandle:
    """An in-flight batch: kernels are enqueued; result() synchronizes.

    A mesh dispatch permutes lanes into group-aligned shard blocks:
    ``lane_sel[i]`` is original lane i's slot, so lane_ok() reads the
    lanes back in the caller's order; ``gather_ok`` is gather_hm's
    index check, which result() raises on."""

    __slots__ = ("_ok", "_lane_ok", "_n", "_lane_sel", "_gather_ok",
                 "_verdict")

    def __init__(self, ok, lane_ok, n, lane_sel=None, gather_ok=None):
        self._ok = ok
        self._lane_ok = lane_ok
        self._n = n
        self._lane_sel = lane_sel
        self._gather_ok = gather_ok
        self._verdict = None

    def lane_ok(self) -> np.ndarray:
        """Each lane's decompression / subgroup / key verdict, (n,)."""
        lane_ok = self._lane_ok.cpu().numpy()
        if self._lane_sel is not None:
            return lane_ok[self._lane_sel]
        return lane_ok[:self._n]

    def result(self) -> bool:
        if self._verdict is None:
            if self._gather_ok is not None and not bool(
                    self._gather_ok.cpu()[0]):
                raise RuntimeError("gather_hm: an H(m) row index is out "
                                   "of range")
            lane_ok = self.lane_ok()
            self._verdict = bool(self._ok.cpu()[0]) and bool(lane_ok.all())
        return self._verdict


class TorchBls12381(BLS12381):
    """Batched BLS verification on the CUDA kernels (or their plain
    versions on the CPU)."""

    name = "torch-cuda"

    def __init__(self, device="cuda", max_batch: int = 4096,
                 max_keys_per_lane: int = 2048, min_bucket: int = 4,
                 group_cap: int = SS.GROUP_CAP_DEFAULT,
                 h2c_min_bucket: int = SS.H2C_MIN_BUCKET_DEFAULT,
                 h2c_cache_capacity: int = HC.DEFAULT_CAP,
                 multipliers: Callable[[int], np.ndarray] = secret_multipliers,
                 mesh=None, mont_path: Optional[str] = None):
        # the Montgomery engine of every batch, resolved once (None: the
        # process path), as the reference's provider records it
        self.mont_path = mxu.resolve(mont_path)
        self.engine = K.ENGINE_OF[self.mont_path]
        # optional multi-device dispatch, group-aligned over the mesh's
        # devices (parallel.GroupShardedVerifier); host arrays and the H(m)
        # arena live on its first device
        self._sharded = None
        self.mesh_info = None
        if mesh is not None:
            from ..parallel import GroupShardedVerifier
            self._sharded = GroupShardedVerifier(mesh, min_bucket=min_bucket,
                                                 engine=self.engine)
            min_bucket = self._sharded.min_bucket
            self.mesh_info = self._sharded.describe()
            device = mesh.devices[0]
        self.device = torch.device(device)
        self._pure = PureBls12381()
        self.max_batch = max_batch
        self.max_keys_per_lane = max_keys_per_lane
        self.min_bucket = min_bucket
        self._group_cap = group_cap
        self._h2c_min_bucket = h2c_min_bucket
        self._multipliers = multipliers
        self._pk_cache = LruMap(200_000)
        self._u_cache = LruMap(100_000)
        self._h2c_cache = HC.H2cPointCache(self.device, h2c_cache_capacity)
        self.dispatch_count = 0
        self.h2c_dispatch_count = 0
        # dedup counters: lanes dispatched, and their unique messages
        self.h2c_lanes = 0
        self.h2c_unique = 0
        self.msm_dispatches = {"ladder": 0, "pippenger": 0}

    # ------------------------------------------------------------------
    # Host-side SPI ops delegated to the oracle
    # ------------------------------------------------------------------
    def secret_key_to_public_key(self, secret: int) -> bytes:
        return self._pure.secret_key_to_public_key(secret)

    def sign(self, secret: int, message: bytes) -> bytes:
        return self._pure.sign(secret, message)

    def aggregate_public_keys(self, public_keys: Sequence[bytes]) -> bytes:
        return self._pure.aggregate_public_keys(public_keys)

    def aggregate_signatures(self, signatures: Sequence[bytes]) -> bytes:
        return self._pure.aggregate_signatures(signatures)

    def signature_is_valid(self, signature: bytes) -> bool:
        return self._pure.signature_is_valid(signature)

    # ------------------------------------------------------------------
    # Pubkey LRU with batched device validation
    # ------------------------------------------------------------------
    def _resolve_pks(self, all_pks: Sequence[bytes]) -> dict:
        """{pk: ("ok", x words, y words) | ("bad",)}; misses validated in
        one dispatch.  Callers read the returned snapshot, never the LRU."""
        resolved, miss = {}, {}
        for pk in all_pks:
            if pk in resolved or pk in miss:
                continue
            entry = self._pk_cache.get(pk)
            if entry is not None:
                resolved[pk] = entry
                continue
            wire = parse_g1_wire(pk)
            if wire is None or wire[2]:
                resolved[pk] = ("bad",)
                self._pk_cache.put(pk, ("bad",))
            else:
                miss[pk] = wire
        if not miss:
            return resolved
        items = list(miss.items())
        m = SS.pk_validate_bucket(len(items))
        xs = np.zeros((m, fp.NW), dtype=np.int32)
        large = np.zeros(m, dtype=bool)
        for i, (_, (x, lg, _inf)) in enumerate(items):
            xs[i] = fp.int_to_words(x)
            large[i] = lg
        ok, gx, gy = KD.g1_validate(self._to_dev(xs), self._to_dev(large),
                                    engine=self.engine)
        ok, gx, gy = ok.cpu().numpy(), gx.cpu().numpy(), gy.cpu().numpy()
        for i, (pk, _) in enumerate(items):
            entry = ("ok", gx[i], gy[i]) if ok[i] else ("bad",)
            resolved[pk] = entry
            self._pk_cache.put(pk, entry)
        return resolved

    def public_key_is_valid(self, public_key: bytes) -> bool:
        return self._resolve_pks([public_key])[public_key][0] == "ok"

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ------------------------------------------------------------------
    # Message draws (host SHA-256 -> Fq2 pairs, cached)
    # ------------------------------------------------------------------
    def _u_draws(self, message: bytes) -> np.ndarray:
        hit = self._u_cache.get(message)
        if hit is None:
            (a, b), (c, d) = OH.hash_to_field_fq2(message, 2)
            hit = np.stack([fp.int_to_words(v) for v in (a, b, c, d)])
            self._u_cache.put(message, hit)
        return hit

    def _uniq_draws(self, msgs: List[bytes], bucket: int):
        u = np.zeros((bucket, 4, fp.NW), dtype=np.int32)
        for j, m in enumerate(msgs):
            u[j] = self._u_draws(m)
        return u

    # ------------------------------------------------------------------
    # SPI verification
    # ------------------------------------------------------------------
    def prepare_batch_verify(
        self, triple: Tuple[Sequence[bytes], bytes, bytes]
    ) -> Optional[BatchSemiAggregate]:
        public_keys, message, signature = triple
        if not public_keys or len(public_keys) > self.max_keys_per_lane:
            return None
        resolved = self._resolve_pks(public_keys)
        points = []
        for pk in public_keys:
            entry = resolved[pk]
            if entry[0] != "ok":
                return None
            points.append((entry[1], entry[2]))
        sig = parse_g2_wire(signature)
        if sig is None:
            return None
        return _Semi(points, message, *sig)

    def complete_batch_verify(
        self, semi_aggregates: Sequence[Optional[BatchSemiAggregate]]
    ) -> bool:
        if any(sa is None for sa in semi_aggregates):
            return False
        if not semi_aggregates:
            return True
        semis = list(semi_aggregates)
        if len(semis) > self.max_batch:
            return all(
                self.complete_batch_verify(semis[i:i + self.max_batch])
                for i in range(0, len(semis), self.max_batch))
        return self._begin_dispatch(semis, randomize=True).result()

    def _prepare_all(self, triples) -> list:
        # one validation dispatch for every key of the batch the LRU
        # misses, then each triple's preparation reads the warm LRU
        self._resolve_pks([pk for t in triples for pk in t[0]])
        return [self.prepare_batch_verify(t) for t in triples]

    def batch_verify(self, triples) -> bool:
        return self.complete_batch_verify(self._prepare_all(triples))

    def begin_batch_verify(self, triples):
        """Host prep and kernel enqueue now; the verdict at .result()."""
        if len(triples) > self.max_batch:
            return None
        semis = self._prepare_all(triples)
        if any(s is None for s in semis):
            return ResolvedHandle(False)
        if not semis:
            return ResolvedHandle(True)
        return self._begin_dispatch(semis, randomize=True)

    def verify(self, public_key: bytes, message: bytes,
               signature: bytes) -> bool:
        return self.fast_aggregate_verify([public_key], message, signature)

    def fast_aggregate_verify(self, public_keys, message: bytes,
                              signature: bytes) -> bool:
        semi = self.prepare_batch_verify((public_keys, message, signature))
        if semi is None:
            return False
        return self._begin_dispatch([semi], randomize=False).result()

    def aggregate_verify(self, public_keys, messages, signature: bytes) -> bool:
        if not public_keys or len(public_keys) != len(messages):
            return False
        # prod_i e(pk_i, H(m_i)) == e(g1, sig): r = 1, the signature on
        # lane 0 and infinity signatures elsewhere
        semis = []
        for i, (pk, msg) in enumerate(zip(public_keys, messages)):
            semi = self.prepare_batch_verify(
                ([pk], msg, signature if i == 0 else G2_INF))
            if semi is None:
                return False
            semis.append(semi)
        return self._begin_dispatch(semis, randomize=False).result()

    # ------------------------------------------------------------------
    # H(m): arena lookups on the host, one h2c dispatch for the misses
    # ------------------------------------------------------------------
    def _hm_host_plan(self, row_msgs: List[bytes], u_bucket: int):
        cache = self._h2c_cache
        if not cache.enabled or len(row_msgs) > cache.capacity:
            return None, None, None, self._uniq_draws(row_msgs, u_bucket)
        digests = [hashlib.sha256(m).digest() for m in row_msgs]
        slots = np.zeros(u_bucket, dtype=np.int64)
        missing = []
        for j, dg in enumerate(digests):
            slot = cache.lookup(dg)
            if slot is None:
                missing.append(j)
            else:
                slots[j] = slot
        draws = None
        if missing:
            mb = SS.h2c_miss_bucket(len(missing), self._h2c_min_bucket)
            draws = self._uniq_draws([row_msgs[j] for j in missing], mb)
        return slots, missing, digests, draws

    def _h2c_dispatch(self, draws: np.ndarray):
        self.h2c_dispatch_count += 1
        u = self._to_dev(draws)
        return KH.h2c(u[:, 0:2].contiguous(), u[:, 2:4].contiguous(),
                      engine=self.engine)

    def _hm_device(self, plan):
        slots, missing, digests, draws = plan
        if slots is None:
            return self._h2c_dispatch(draws)
        if missing:
            hm_bucket = self._h2c_dispatch(draws)
            slots[np.asarray(missing)] = self._h2c_cache.insert(
                [digests[j] for j in missing], hm_bucket)
        return self._h2c_cache.gather(slots)

    # ------------------------------------------------------------------
    # Dispatch: dedup plan, buckets, then the kernel chain
    # ------------------------------------------------------------------
    def _begin_dispatch(self, semis: List[_Semi], randomize: bool):
        return self.launch(self.plan(semis, randomize))

    def plan(self, semis: List[_Semi], randomize: bool) -> dict:
        """Host half of a dispatch: the dedup plan, pow-2 buckets and the
        kernels' input arrays (numpy), plus the H(m) arena plan."""
        n = len(semis)
        kmax = SS.kmax_bucket(max(len(s.pk_words) for s in semis))
        uniq_index: dict = {}
        uniq_msgs: List[bytes] = []
        groups: List[List[int]] = []
        for i, s in enumerate(semis):
            u = uniq_index.get(s.message)
            if u is None:
                u = uniq_index[s.message] = len(uniq_msgs)
                uniq_msgs.append(s.message)
                groups.append([])
            groups[u].append(i)
        rows = SS.group_rows(groups, self._group_cap)
        row_msgs = [uniq_msgs[u] for u, _ in rows]
        g_bucket = SS.group_bucket(rows)
        # the h2c / H(m) arena width, from the batch alone: the same for
        # a single-device and a mesh dispatch, so the h2c and dedup
        # counters do not depend on the mesh
        u_hm = SS.unique_bucket(len(rows), self._h2c_min_bucket)
        shards = lane_pos = None
        if self._sharded is not None:
            # whole rows per shard, lanes permuted into shard blocks
            shards = self._sharded.plan(rows, n,
                                        min_rows_total=self._h2c_min_bucket)
            padded, u_total = shards.padded, shards.rows_total
            lane_pos = shards.lane_pos
        else:
            padded = SS.lane_bucket(n, self.min_bucket)
            u_total = u_hm

        pk_x = np.zeros((padded, kmax, fp.NW), dtype=np.int32)
        pk_y = np.zeros((padded, kmax, fp.NW), dtype=np.int32)
        pk_present = np.zeros((padded, kmax), dtype=bool)
        sig_bytes = np.zeros((padded, 2, 48), dtype=np.uint8)
        s_large = np.zeros(padded, dtype=bool)
        s_inf = np.zeros(padded, dtype=bool)
        lane_valid = np.zeros(padded, dtype=bool)
        for i, s in enumerate(semis):
            p = i if lane_pos is None else int(lane_pos[i])
            for j, (x, y) in enumerate(s.pk_words):
                pk_x[p, j] = x
                pk_y[p, j] = y
                pk_present[p, j] = True
            sig_bytes[p] = s.sig_x_bytes
            s_large[p] = s.sig_large
            s_inf[p] = s.sig_inf
            lane_valid[p] = True
        group_idx = np.zeros((u_total, g_bucket), dtype=np.int32)
        group_present = np.zeros((u_total, g_bucket), dtype=bool)
        row_gather = None
        if shards is None:
            for r, (_, g) in enumerate(rows):
                group_idx[r, :len(g)] = g
                group_present[r, :len(g)] = True
        else:
            # shard-local lane indices; row_gather places the canonical
            # H(m) rows in the shard layout (padding rows gather slot 0,
            # masked by group_present)
            row_gather = np.zeros(u_total, dtype=np.int32)
            for pos, r in enumerate(shards.row_layout):
                if r < 0:
                    continue
                g = rows[r][1]
                base = (pos // shards.rows_per_shard) * shards.lanes_per_shard
                group_idx[pos, :len(g)] = lane_pos[np.asarray(g)] - base
                group_present[pos, :len(g)] = True
                row_gather[pos] = r
        # the scalars stage's path, per dispatch: the ladder takes 64-bit
        # multipliers (0 nudged to 1); pippenger splits the same draw
        # into GLV halves (k1, k2), or takes (1, 0) for r = 1
        msm_path = msm.resolve(lanes=n, rows=len(rows), device=self.device)
        raw = glv_digits = None
        if randomize:
            raw = np.asarray(self._multipliers(padded), dtype=np.uint64).copy()
            if msm_path == "pippenger":
                k1, k2 = msm.glv_sample_from_uint64(raw)
                glv_digits, raw = msm.glv_digits_np(k1, k2), None
            else:
                raw[raw == 0] = 1
        elif msm_path == "pippenger":
            glv_digits = msm.glv_digits_np(np.ones(padded, dtype=np.uint64),
                                           np.zeros(padded, dtype=np.uint64))
        else:
            raw = np.ones(padded, dtype=np.uint64)
        return {
            "lanes": n, "unique": len(uniq_msgs), "lane_pos": lane_pos,
            "row_gather": row_gather, "pk_x": pk_x, "pk_y": pk_y,
            "pk_present": pk_present,
            "sig_x0": fp.bytes_to_words_np(sig_bytes[:, 1]),
            "sig_x1": fp.bytes_to_words_np(sig_bytes[:, 0]),
            "sig_large": s_large, "sig_inf": s_inf, "lane_valid": lane_valid,
            "msm_path": msm_path, "glv_digits": glv_digits,
            "r": None if raw is None else raw.view(np.int64),
            "group_idx": group_idx,
            "group_present": group_present,
            "hm_plan": self._hm_host_plan(row_msgs, u_hm)}

    # the mesh's lane-sharded and row-sharded inputs
    LANE_KEYS = ("pk_x", "pk_y", "pk_present", "sig_x0", "sig_x1",
                 "sig_large", "sig_inf", "lane_valid")
    ROW_KEYS = ("group_idx", "group_present")

    def launch(self, plan: dict) -> DispatchHandle:
        """Device half: the kernel chain, enqueued on the current stream
        (a mesh: each shard's on its device's)."""
        self.dispatch_count += 1
        self.h2c_lanes += plan["lanes"]
        self.h2c_unique += plan["unique"]
        self.msm_dispatches[plan["msm_path"]] += 1
        d = self._to_dev
        hm = self._hm_device(plan["hm_plan"])
        if self._sharded is not None:
            hm_rows, gather_ok = KSH.gather_hm(hm, d(plan["row_gather"]),
                                               engine=self.engine)
            arrays = {k: plan[k] for k in self.LANE_KEYS + self.ROW_KEYS}
            scalars = ("glv_digits" if plan["msm_path"] == "pippenger"
                       else "r")
            arrays[scalars] = plan[scalars]
            arrays["hm_rows"] = hm_rows
            ok, lane_ok = self._sharded.kernel(plan["msm_path"])(arrays)
            return DispatchHandle(ok, lane_ok, plan["lanes"],
                                  lane_sel=plan["lane_pos"],
                                  gather_ok=gather_ok)
        pk_jac, sig_jac, lane_ok, miller_mask = KD.prepare(
            d(plan["pk_x"]), d(plan["pk_y"]), d(plan["pk_present"]),
            d(plan["sig_x0"]), d(plan["sig_x1"]), d(plan["sig_large"]),
            d(plan["sig_inf"]), d(plan["lane_valid"]), engine=self.engine)
        group_idx = d(plan["group_idx"])
        group_present = d(plan["group_present"])
        if plan["msm_path"] == "pippenger":
            agg, u_mask, wsig = KM.scalars_msm(
                pk_jac, sig_jac, d(plan["glv_digits"]), miller_mask, group_idx,
                group_present, engine=self.engine)
        else:
            agg, u_mask, wsig = KS.scalars_group(
                pk_jac, sig_jac, d(plan["r"]), miller_mask, group_idx,
                group_present, engine=self.engine)
        ml = KP.miller(agg, hm, u_mask, engine=self.engine)
        ok = KP.finish(ml, wsig, engine=self.engine)
        return DispatchHandle(ok, lane_ok, plan["lanes"])
