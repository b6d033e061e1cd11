"""Device-resident H(m) point arena, after teku_tpu/ops/h2c_cache.py.

Committee traffic re-delivers signatures over the same message, so the
mapped G2 points stay on the device and a warm batch skips hash-to-curve
entirely.  The arena is four (capacity, 12) int32 word tensors (affine
x.c0, x.c1, y.c0, y.c1, canonical words); the host keeps an LRU index
of message digest -> slot.  Insert is one ``index_copy_`` per tensor,
lookup one gather by slot.  A hit is re-verified by key: the slot must
still record the queried digest, else it is a miss.
"""

import threading
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

DEFAULT_CAP = 4096


class H2cPointCache:
    """Bounded LRU of device-resident H(m) affine points (thread-safe)."""

    def __init__(self, device, capacity: int = DEFAULT_CAP):
        self.device = torch.device(device)
        self.capacity = capacity
        self._lock = threading.Lock()
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        self._slot_digest: List[Optional[bytes]] = [None] * capacity
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._arena = None

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def lookup(self, digest: bytes) -> Optional[int]:
        with self._lock:
            slot = self._index.get(digest)
            if slot is not None and self._slot_digest[slot] == digest:
                self._index.move_to_end(digest)
                return slot
            if slot is not None:
                self._index.pop(digest, None)
            return None

    def insert(self, digests: Sequence[bytes], hm_bucket) -> np.ndarray:
        """Store the first len(digests) rows of an h2c output
        ((B, 2, 2, 12) words, B >= len(digests)); returns their slots."""
        k = len(digests)
        if k > self.capacity:
            raise ValueError(f"insert of {k} points exceeds arena capacity "
                             f"{self.capacity}")
        slots = np.zeros(k, dtype=np.int64)
        with self._lock:
            for i, dg in enumerate(digests):
                existing = self._index.get(dg)
                if existing is not None:
                    slots[i] = existing
                    self._index.move_to_end(dg)
                    continue
                if not self._free:
                    _, old_slot = self._index.popitem(last=False)
                    self._slot_digest[old_slot] = None
                    self._free.append(old_slot)
                slot = self._free.pop()
                self._index[dg] = slot
                self._slot_digest[slot] = dg
                slots[i] = slot
            if self._arena is None:
                self._arena = tuple(
                    torch.zeros((self.capacity, 12), dtype=torch.int32,
                                device=self.device) for _ in range(4))
            idx = torch.as_tensor(slots, device=self.device)
            comps = (hm_bucket[:k, 0, 0], hm_bucket[:k, 0, 1],
                     hm_bucket[:k, 1, 0], hm_bucket[:k, 1, 1])
            for arena, comp in zip(self._arena, comps):
                arena.index_copy_(0, idx, comp)
        return slots

    def gather(self, slots: np.ndarray):
        """(n, 2, 2, 12) affine words for the given slots."""
        with self._lock:
            arena = self._arena
        assert arena is not None, "gather before any insert"
        idx = torch.as_tensor(np.asarray(slots, dtype=np.int64),
                              device=self.device)
        x0, x1, y0, y1 = (a[idx] for a in arena)
        return torch.stack([torch.stack([x0, x1], dim=1),
                            torch.stack([y0, y1], dim=1)], dim=1)
