"""Pure-Python BLS12-381 provider (oracle + CPU fallback).

The port's own copy of teku_tpu/crypto/bls/pure_impl.py (teku_tpu_torch
imports nothing of teku_tpu); keep the two in step.

Implements the eth2 BLS signature scheme (proof-of-possession ciphersuite)
entirely on host Python bigints.  It is the test oracle for the JAX/TPU
provider and the graceful-degradation fallback when no accelerator is
available — the same dual role split the reference has between blst and its
SPI (reference: infrastructure/bls/.../impl/blst/BlstBLS12381.java).
"""

import hashlib
import hmac
import secrets
from typing import List, Optional, Sequence, Tuple

from . import curve as C
from . import fields as F
from . import pairing as PR
from .constants import P, R
from .hash_to_curve import hash_to_g2
from .spi import BLS12381, BatchSemiAggregate

_G1_NEG_AFFINE = C.to_affine(C.FQ_OPS, C.point_neg(C.FQ_OPS, C.G1_GENERATOR))

# Compressed encodings of the points at infinity.
G1_INFINITY = bytes([0xC0] + [0] * 47)
G2_INFINITY = bytes([0xC0] + [0] * 95)


def keygen(ikm: bytes, key_info: bytes = b"") -> int:
    """draft-irtf-cfrg-bls-signature-05 KeyGen (HKDF-based, deterministic)."""
    salt = b"BLS-SIG-KEYGEN-SALT-"
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = hmac.new(salt, ikm + b"\x00", hashlib.sha256).digest()
        l = 48
        okm = b""
        t = b""
        i = 1
        info = key_info + l.to_bytes(2, "big")
        while len(okm) < l:
            t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
            okm += t
            i += 1
        sk = int.from_bytes(okm[:l], "big") % R
    return sk


def random_secret_key() -> int:
    return keygen(secrets.token_bytes(32))


class _SemiAggregate(BatchSemiAggregate):
    """Miller-loop product + multiplier-weighted signature for one triple."""

    __slots__ = ("ml", "weighted_sig")

    def __init__(self, ml, weighted_sig):
        self.ml = ml
        self.weighted_sig = weighted_sig


class PureBls12381(BLS12381):
    """Pure-Python provider. Slow but exactly the eth2 scheme."""

    name = "pure-python"

    # -- parsing with tiny memo caches (mirrors reference lazy parsing) --
    def __init__(self) -> None:
        self._pk_cache: dict = {}
        self._sig_cache: dict = {}

    _MISS = object()  # cache sentinel: None is a legitimate value (infinity)

    def _parse_pk(self, pk: bytes):
        """Returns affine G1 point, None for infinity; raises if invalid."""
        hit = self._pk_cache.get(pk, self._MISS)
        if hit is self._MISS:
            point = C.g1_decompress(pk)
            hit = C.to_affine(C.FQ_OPS, point)  # None when infinity
            if len(self._pk_cache) > 100_000:
                self._pk_cache.clear()
            self._pk_cache[pk] = hit
        return hit

    def _parse_sig(self, sig: bytes):
        hit = self._sig_cache.get(sig, self._MISS)
        if hit is self._MISS:
            point = C.g2_decompress(sig)
            hit = C.to_affine(C.FQ2_OPS, point)
            if len(self._sig_cache) > 100_000:
                self._sig_cache.clear()
            self._sig_cache[sig] = hit
        return hit

    # -- keys ------------------------------------------------------------
    def secret_key_to_public_key(self, secret: int) -> bytes:
        if not 0 < secret < R:
            raise ValueError("secret key out of range")
        return C.g1_compress(C.point_mul(C.FQ_OPS, secret, C.G1_GENERATOR))

    def sign(self, secret: int, message: bytes) -> bytes:
        # Zero-key signing is prohibited (reference BlstBLS12381.java:54-56).
        if not 0 < secret < R:
            raise ValueError("secret key out of range")
        q = hash_to_g2(message)
        return C.g2_compress(C.point_mul(C.FQ2_OPS, secret, q))

    # -- validation ------------------------------------------------------
    def public_key_is_valid(self, public_key: bytes) -> bool:
        try:
            return self._parse_pk(public_key) is not None  # infinity invalid
        except ValueError:
            return False

    def signature_is_valid(self, signature: bytes) -> bool:
        try:
            self._parse_sig(signature)
            return True
        except ValueError:
            return False

    # -- aggregation -----------------------------------------------------
    def aggregate_public_keys(self, public_keys: Sequence[bytes]) -> bytes:
        if not public_keys:
            raise ValueError("cannot aggregate empty public key list")
        acc = C.infinity(C.FQ_OPS)
        for pk in public_keys:
            aff = self._parse_pk(pk)
            if aff is None:
                raise ValueError("infinity public key in aggregation")
            acc = C.point_add(C.FQ_OPS, acc, C.from_affine(C.FQ_OPS, *aff))
        return C.g1_compress(acc)

    def aggregate_signatures(self, signatures: Sequence[bytes]) -> bytes:
        if not signatures:
            raise ValueError("cannot aggregate empty signature list")
        acc = C.infinity(C.FQ2_OPS)
        for sig in signatures:
            aff = self._parse_sig(sig)
            if aff is not None:
                acc = C.point_add(C.FQ2_OPS, acc, C.from_affine(C.FQ2_OPS, *aff))
        return C.g2_compress(acc)

    # -- verification ----------------------------------------------------
    def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        return self.fast_aggregate_verify([public_key], message, signature)

    def aggregate_verify(self, public_keys: Sequence[bytes],
                         messages: Sequence[bytes], signature: bytes) -> bool:
        if not public_keys or len(public_keys) != len(messages):
            return False
        try:
            sig_aff = self._parse_sig(signature)
            pks = [self._parse_pk(pk) for pk in public_keys]
        except ValueError:
            return False
        if any(pk is None for pk in pks):
            return False  # KeyValidate rejects infinity
        pairs = [(pk, PR_hash(msg)) for pk, msg in zip(pks, messages)]
        pairs.append((_G1_NEG_AFFINE, sig_aff))
        return F.fq12_is_one(PR.multi_pairing(pairs))

    def fast_aggregate_verify(self, public_keys: Sequence[bytes],
                              message: bytes, signature: bytes) -> bool:
        if not public_keys:
            return False
        try:
            sig_aff = self._parse_sig(signature)
            pks = [self._parse_pk(pk) for pk in public_keys]
        except ValueError:
            return False
        if any(pk is None for pk in pks):
            return False
        acc = C.infinity(C.FQ_OPS)
        for pk in pks:
            acc = C.point_add(C.FQ_OPS, acc, C.from_affine(C.FQ_OPS, *pk))
        agg = C.to_affine(C.FQ_OPS, acc)
        if agg is None:
            return False  # keys summed to infinity
        pairs = [(agg, PR_hash(message)), (_G1_NEG_AFFINE, sig_aff)]
        return F.fq12_is_one(PR.multi_pairing(pairs))

    # -- batch verification ----------------------------------------------
    def prepare_batch_verify(
        self, triple: Tuple[Sequence[bytes], bytes, bytes]
    ) -> Optional[BatchSemiAggregate]:
        public_keys, message, signature = triple
        if not public_keys:
            return None
        try:
            sig_aff = self._parse_sig(signature)
            pks = [self._parse_pk(pk) for pk in public_keys]
        except ValueError:
            return None
        if any(pk is None for pk in pks):
            return None
        acc = C.infinity(C.FQ_OPS)
        for pk in pks:
            acc = C.point_add(C.FQ_OPS, acc, C.from_affine(C.FQ_OPS, *pk))
        # Random 64-bit nonzero multiplier (reference BlstBLS12381.java:191-195)
        r = 0
        while r == 0:
            r = secrets.randbits(64)
        pk_r = C.to_affine(C.FQ_OPS, C.point_mul(C.FQ_OPS, r, acc))
        if pk_r is None:
            return None
        ml = PR.miller_loop(pk_r, PR_hash(message))
        if sig_aff is None:
            weighted_sig = C.infinity(C.FQ2_OPS)
        else:
            weighted_sig = C.point_mul(
                C.FQ2_OPS, r, C.from_affine(C.FQ2_OPS, *sig_aff))
        return _SemiAggregate(ml, weighted_sig)

    def complete_batch_verify(
        self, semi_aggregates: Sequence[Optional[BatchSemiAggregate]]
    ) -> bool:
        if any(sa is None for sa in semi_aggregates):
            return False
        if not semi_aggregates:
            return True
        f = F.FQ12_ONE
        sig_acc = C.infinity(C.FQ2_OPS)
        for sa in semi_aggregates:
            f = F.fq12_mul(f, sa.ml)
            sig_acc = C.point_add(C.FQ2_OPS, sig_acc, sa.weighted_sig)
        sig_aff = C.to_affine(C.FQ2_OPS, sig_acc)
        f = F.fq12_mul(f, PR.miller_loop(_G1_NEG_AFFINE, sig_aff))
        return F.fq12_is_one(PR.final_exponentiation(f))

    def batch_verify(
        self,
        triples: Sequence[Tuple[Sequence[bytes], bytes, bytes]],
    ) -> bool:
        return self.complete_batch_verify(
            [self.prepare_batch_verify(t) for t in triples])


# Message -> H(m) affine-point cache: hashing dominates the oracle's runtime
# and tests/batches repeat messages heavily.
_H2G_CACHE: dict = {}


def PR_hash(message: bytes):
    hit = _H2G_CACHE.get(message)
    if hit is None:
        hit = C.to_affine(C.FQ2_OPS, hash_to_g2(message))
        if len(_H2G_CACHE) > 50_000:
            _H2G_CACHE.clear()
        _H2G_CACHE[message] = hit
    return hit
