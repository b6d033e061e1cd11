"""TorchKzg -- EIP-4844 blob verification on PyTorch and the CUDA kernels.

The port of teku_tpu/ops/kzg.py:JaxKzg, installed behind the port's
crypto/kzg ``set_backend`` seam.  Host work as in the reference: blob
bytes to Fr words with the canonical-range check, wire parsing of
commitments and proofs with a G1 cache, the SHA-256 Fiat-Shamir
challenges and fold multipliers, the scalar bookkeeping.  Device work in
fixed pow-2 shapes (ops/kernels/):

- ``g1_validate`` (decompress.cu) -- decompression and subgroup check of
  the cache misses (the reference's g1_validate_kernel has the same body
  as its pubkey-validate program);
- ``kzg_eval`` -- barycentric p(z) of every blob;
- ``kzg_fold`` -- the whole batch folded with random multipliers into
  one 2-pairing check,
    e(sum r_i C_i + sum (r_i z_i) pi_i - [sum r_i y_i] G1, G2)
      * e(-sum r_i pi_i, [s]G2) == 1;
- ``kzg_msm`` -- the prover side's MSM over the setup's Lagrange basis
  (``g1_lincomb``: commitments and proofs).

With ``device="cpu"`` the same calls run the kernels' plain versions.
Nothing here raises ``BackendUnavailable``: a kernel that fails to build
or launch raises, and the facade's host path never serves a card batch.
"""

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..crypto.bls import curve as C
from ..crypto.bls.constants import G1_X, G1_Y
from ..crypto.bls.constants import R as R_MOD
from ..crypto.kzg import (BYTES_PER_BLOB, BYTES_PER_FIELD_ELEMENT,
                          FIELD_ELEMENTS_PER_BLOB, KzgError,
                          RANDOM_CHALLENGE_DOMAIN, TrustedSetup,
                          compute_challenge, roots_of_unity)
from . import limbs as fp
from .kernels import decompress as KD
from .kernels import kzg as KK
from .modfield import FR
from .provider import parse_g1_wire
from .shapeset import next_pow2

_N = FIELD_ELEMENTS_PER_BLOB
_NBITS = 255                       # Fr scalars fit in 255 bits
G1_INF = bytes([0xC0] + [0] * 47)


def blob_bytes_to_limbs(blobs: Sequence[bytes]) -> np.ndarray:
    """(B, 4096, L) plain (non-Montgomery) Fr limbs from blob bytes --
    one vectorized numpy pass, as the reference's."""
    b = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    b = b.reshape(len(blobs) * _N, BYTES_PER_FIELD_ELEMENT)
    le = b[:, ::-1].astype(np.uint64)
    out = np.zeros((b.shape[0], FR.L), dtype=np.int64)
    for i in range(FR.L):
        bit0 = FR.W * i
        byte0, shift = divmod(bit0, 8)
        acc = np.zeros(b.shape[0], dtype=np.uint64)
        for k in range(5):
            idx = byte0 + k
            if idx < BYTES_PER_FIELD_ELEMENT:
                acc |= le[:, idx] << np.uint64(8 * k)
        out[:, i] = ((acc >> np.uint64(shift))
                     & np.uint64(FR.MASK)).astype(np.int64)
    return out.reshape(len(blobs), _N, FR.L)


_R_LIMBS = FR.int_to_limbs(R_MOD)


def limbs_lt_modulus(limbs: np.ndarray) -> np.ndarray:
    """Canonical-range check: limb vectors < r, limb by limb from the top
    (the spec's bytes_to_bls_field)."""
    lt = np.zeros(limbs.shape[:-1], dtype=bool)
    eq = np.ones(limbs.shape[:-1], dtype=bool)
    for i in range(FR.L - 1, -1, -1):
        lt |= eq & (limbs[..., i] < _R_LIMBS[i])
        eq &= limbs[..., i] == _R_LIMBS[i]
    return lt


def int_to_bits(vals: Sequence[int], nbits: int = _NBITS) -> np.ndarray:
    """(N, nbits) MSB-first bit matrix from host ints."""
    nbytes = (nbits + 7) // 8
    raw = b"".join(v.to_bytes(nbytes, "big") for v in vals)
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8)
                         .reshape(len(vals), nbytes), axis=1)
    return bits[:, 8 * nbytes - nbits:].astype(np.int64)


def fr_words(vals: Sequence[int]) -> np.ndarray:
    """Host ints in [0, 2^256) -> (N, 8) canonical Fr words."""
    return fp.ints_to_words(vals, FR.NW)


class TorchKzg:
    """Device KZG backend behind crypto/kzg's set_backend seam."""

    name = "torch-cuda"

    def __init__(self, device="cuda", min_bucket: int = 8):
        self.device = torch.device(device)
        self.min_bucket = min_bucket
        self._g1_cache: dict = {}
        self._setup_cache: dict = {}
        self._roots = None
        self.dispatch_count = 0

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- setup constants ----------------------------------------------
    def _setup_cached(self, kind: str, setup: TrustedSetup, build):
        """id()-keyed entries PIN the setup object they were built from --
        a recycled id after GC must never serve another setup's constants."""
        key = (kind, id(setup))
        hit = self._setup_cache.get(key)
        if hit is not None and hit[0] is setup:
            return hit[1]
        value = build()
        if len(self._setup_cache) > 4:
            self._setup_cache.clear()
        self._setup_cache[key] = (setup, value)
        return value

    def _g2_consts(self, setup: TrustedSetup) -> torch.Tensor:
        """[G2, sG2] affine, (2 points, x/y, c0/c1, 12) words."""
        def build():
            pts = [C.to_affine(C.FQ2_OPS, C.G2_GENERATOR),
                   C.to_affine(C.FQ2_OPS, setup.s_g2)]
            return self._to_dev(np.stack([np.stack([np.stack(
                [fp.int_to_words(c) for c in coord]) for coord in pt])
                for pt in pts]))
        return self._setup_cached("g2", setup, build)

    def _lagrange_arrays(self, setup: TrustedSetup):
        """(xs (4096, 12) words, ys, present (4096,)); absent = infinity."""
        def build():
            if setup.g1_lagrange is None:
                raise KzgError("setup has no Lagrange points")
            xs = np.zeros((_N, fp.NW), dtype=np.int32)
            ys = np.zeros((_N, fp.NW), dtype=np.int32)
            present = np.zeros(_N, dtype=bool)
            for i, pt in enumerate(setup.g1_lagrange):
                aff = C.to_affine(C.FQ_OPS, pt)
                if aff is None:
                    continue
                xs[i] = fp.int_to_words(aff[0])
                ys[i] = fp.int_to_words(aff[1])
                present[i] = True
            return self._to_dev(xs), self._to_dev(ys), self._to_dev(present)
        return self._setup_cached("lagrange", setup, build)

    def _roots_words(self) -> torch.Tensor:
        if self._roots is None:
            self._roots = self._to_dev(fr_words(roots_of_unity()))
        return self._roots

    # -- G1 cache ------------------------------------------------------
    def _resolve_g1(self, all_points: Sequence[bytes]) -> None:
        if len(self._g1_cache) > 100_000:
            self._g1_cache.clear()
        miss = {}
        for raw in all_points:
            if raw in self._g1_cache or raw in miss:
                continue
            wire = parse_g1_wire(raw)
            if wire is None:
                self._g1_cache[raw] = ("bad",)
            elif wire[2]:
                self._g1_cache[raw] = ("inf",)
            else:
                miss[raw] = wire
        miss = list(miss.items())
        if not miss:
            return
        n = max(next_pow2(len(miss)), 8)
        xs = np.zeros((n, fp.NW), dtype=np.int32)
        large = np.zeros(n, dtype=bool)
        for i, (_, (x, lg, _inf)) in enumerate(miss):
            xs[i] = fp.int_to_words(x)
            large[i] = lg
        ok, gx, gy = KD.g1_validate(self._to_dev(xs), self._to_dev(large))
        ok, gx, gy = ok.cpu().numpy(), gx.cpu().numpy(), gy.cpu().numpy()
        for i, (raw, _) in enumerate(miss):
            self._g1_cache[raw] = (("ok", gx[i], gy[i]) if ok[i]
                                   else ("bad",))

    # -- blob evaluation ----------------------------------------------
    def _evaluate(self, blobs: Sequence[bytes],
                  zs: Sequence[int]) -> List[int]:
        if not limbs_lt_modulus(blob_bytes_to_limbs(blobs)).all():
            raise KzgError("field element out of range")
        b = len(blobs)
        pad = max(next_pow2(b), 2)
        poly = np.zeros((pad * _N, FR.NW), dtype=np.int32)
        poly[:b * _N] = fp.bytes_to_words_np(np.frombuffer(
            b"".join(blobs), dtype=np.uint8).reshape(b * _N, -1))
        z = np.zeros((pad, FR.NW), dtype=np.int32)
        z[:b] = fr_words(zs)
        self.dispatch_count += 1
        y = KK.kzg_eval(self._to_dev(poly.reshape(pad, _N, FR.NW)),
                        self._to_dev(z), self._roots_words()).cpu()
        return [fp.words_to_int(y[i]) for i in range(b)]

    # -- verification --------------------------------------------------
    def _fold_check(self, setup: TrustedSetup,
                    lanes: List[Tuple[tuple, int, bool]]) -> bool:
        """lanes: (cache_entry, scalar, in_group_b)."""
        n = max(next_pow2(len(lanes)), self.min_bucket)
        xs = np.zeros((n, fp.NW), dtype=np.int32)
        ys = np.zeros((n, fp.NW), dtype=np.int32)
        inf = np.zeros(n, dtype=bool)
        valid = np.zeros(n, dtype=bool)
        group_b = np.zeros(n, dtype=bool)
        scalars = []
        for i, (entry, scalar, in_b) in enumerate(lanes):
            if entry[0] == "inf":
                inf[i] = True
            else:
                xs[i], ys[i] = entry[1], entry[2]
            valid[i] = True
            group_b[i] = in_b
            scalars.append(scalar % R_MOD)
        scalars += [0] * (n - len(lanes))
        self.dispatch_count += 1
        ok, _, _ = KK.kzg_fold(*(self._to_dev(a) for a in (
            xs, ys, inf, valid, group_b, fr_words(scalars))),
            self._g2_consts(setup))
        return bool(ok.cpu()[0])

    @staticmethod
    def _g1_gen_entry():
        return ("ok", fp.int_to_words(G1_X), fp.int_to_words(G1_Y))

    def verify_kzg_proof(self, commitment: bytes, z: int, y: int,
                         proof: bytes, setup: TrustedSetup) -> bool:
        """e(C - [y]G1 + [z]pi, G2) * e(-pi, [s]G2) == 1."""
        self._resolve_g1([commitment, proof])
        c = self._g1_cache[commitment]
        p = self._g1_cache[proof]
        if c[0] == "bad" or p[0] == "bad":
            return False
        lanes = [(c, 1, False), (p, z % R_MOD, False),
                 (self._g1_gen_entry(), (-y) % R_MOD, False),
                 (p, 1, True)]
        return self._fold_check(setup, lanes)

    def _r_multipliers(self, blobs, commitments, proofs) -> List[int]:
        """Deterministic unpredictable fold multipliers: hash of the whole
        input set (the role of c-kzg's compute_r_powers)."""
        h = hashlib.sha256()
        h.update(RANDOM_CHALLENGE_DOMAIN)
        h.update(len(blobs).to_bytes(8, "big"))
        for b in blobs:
            h.update(hashlib.sha256(b).digest())
        for cm in commitments:
            h.update(cm)
        for pr in proofs:
            h.update(pr)
        seed = h.digest()
        out = []
        for i in range(len(blobs)):
            d = hashlib.sha256(seed + i.to_bytes(8, "big")).digest()
            out.append(int.from_bytes(d, "big") % R_MOD or 1)
        return out

    def verify_blob_kzg_proof_batch(self, blobs: Sequence[bytes],
                                    commitments: Sequence[bytes],
                                    proofs: Sequence[bytes],
                                    setup: TrustedSetup) -> bool:
        if not (len(blobs) == len(commitments) == len(proofs)):
            return False
        if not blobs:
            return True
        for b in blobs:
            if len(b) != BYTES_PER_BLOB:
                return False
        self._resolve_g1(list(commitments) + list(proofs))
        entries_c = [self._g1_cache[c] for c in commitments]
        entries_p = [self._g1_cache[p] for p in proofs]
        if any(e[0] == "bad" for e in entries_c + entries_p):
            return False
        try:
            zs = [compute_challenge(b, c)
                  for b, c in zip(blobs, commitments)]
            ys = self._evaluate(blobs, zs)
        except KzgError:
            return False
        rs = self._r_multipliers(blobs, commitments, proofs)
        lanes = []
        acc_y = 0
        for e_c, e_p, z, y, r in zip(entries_c, entries_p, zs, ys, rs):
            lanes.append((e_c, r, False))
            lanes.append((e_p, r * z, False))
            lanes.append((e_p, r, True))
            acc_y += r * y
        lanes.append((self._g1_gen_entry(), -acc_y, False))
        return self._fold_check(setup, lanes)

    def verify_blob_kzg_proof(self, blob: bytes, commitment: bytes,
                              proof: bytes, setup: TrustedSetup) -> bool:
        return self.verify_blob_kzg_proof_batch(
            [blob], [commitment], [proof], setup)

    # -- prover-side MSM (commitments/proofs from real setups) ---------
    def g1_lincomb(self, setup: TrustedSetup,
                   scalars: Sequence[int]) -> bytes:
        """MSM over the setup's Lagrange basis -> compressed G1."""
        xs, ys, present = self._lagrange_arrays(setup)
        if len(scalars) != _N:
            raise KzgError("scalar count must match basis size")
        self.dispatch_count += 1
        inf, xy = KK.kzg_msm(xs, ys, present, self._to_dev(
            fr_words([s % R_MOD for s in scalars])))
        if bool(inf.cpu()[0]):
            return G1_INF
        xy = xy.cpu()
        return C.g1_compress((fp.words_to_int(xy[0]),
                              fp.words_to_int(xy[1]), 1))
