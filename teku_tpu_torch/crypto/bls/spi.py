"""BLS provider SPI — the seam between the node and a BLS implementation.

The port's own copy of teku_tpu/crypto/bls/spi.py (teku_tpu_torch
imports nothing of teku_tpu); keep the two in step.

Mirrors the reference's pluggable provider interface (reference:
infrastructure/bls/src/main/java/tech/pegasys/teku/bls/impl/BLS12381.java:34-157
and bls/BLS.java:51-62 setBlsImplementation) so the pure-Python oracle and
the JAX/TPU implementation are interchangeable: the pure impl is the
always-available fallback (the analogue of the reference's BlstLoader
graceful-degradation path, BlstLoader.java:34-51) and the TPU impl is the
performance path.

Keys/signatures cross this boundary as *bytes* (48-byte compressed G1
pubkeys, 96-byte compressed G2 signatures); implementations own parsing,
validation and caching.
"""

import abc
from typing import List, Optional, Sequence, Tuple


class BatchSemiAggregate:
    """Opaque per-triple preparation result for split batch verification.

    Equivalent of the reference's BatchSemiAggregate (bls/BatchSemiAggregate.java):
    produced by prepare_batch_verify, consumed by complete_batch_verify, so
    async pipelines can overlap preparation with queueing.
    """


class ResolvedHandle:
    """Trivially-resolved async-verify handle: the shared shape for
    batches whose verdict is known at begin time (empty, host-rejected)
    — same .result() contract as a live dispatch handle."""

    __slots__ = ("_verdict",)

    def __init__(self, verdict: bool):
        self._verdict = bool(verdict)

    def result(self) -> bool:
        return self._verdict


class BLS12381(abc.ABC):
    """Provider interface: everything the node needs from a BLS library."""

    name: str = "abstract"

    # --- key operations -------------------------------------------------
    @abc.abstractmethod
    def secret_key_to_public_key(self, secret: int) -> bytes:
        """48-byte compressed public key for a secret scalar."""

    @abc.abstractmethod
    def sign(self, secret: int, message: bytes) -> bytes:
        """96-byte compressed signature over message (PoP ciphersuite)."""

    # --- validation -----------------------------------------------------
    @abc.abstractmethod
    def public_key_is_valid(self, public_key: bytes) -> bool:
        """Curve + subgroup + non-infinity check (KeyValidate)."""

    @abc.abstractmethod
    def signature_is_valid(self, signature: bytes) -> bool:
        """Curve + subgroup check (infinity allowed at this layer)."""

    # --- aggregation ----------------------------------------------------
    @abc.abstractmethod
    def aggregate_public_keys(self, public_keys: Sequence[bytes]) -> bytes:
        ...

    @abc.abstractmethod
    def aggregate_signatures(self, signatures: Sequence[bytes]) -> bytes:
        ...

    # --- verification ---------------------------------------------------
    @abc.abstractmethod
    def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        ...

    @abc.abstractmethod
    def aggregate_verify(self, public_keys: Sequence[bytes],
                         messages: Sequence[bytes], signature: bytes) -> bool:
        ...

    @abc.abstractmethod
    def fast_aggregate_verify(self, public_keys: Sequence[bytes],
                              message: bytes, signature: bytes) -> bool:
        ...

    # --- batch verification (random multiplier scheme) ------------------
    @abc.abstractmethod
    def batch_verify(
        self,
        triples: Sequence[Tuple[Sequence[bytes], bytes, bytes]],
    ) -> bool:
        """One combined check over (public_keys, message, signature) triples.

        Each triple has fast_aggregate_verify semantics; the whole batch is
        combined with 64-bit random multipliers (ethresear.ch/5407 scheme,
        reference BLS.java:230-254) into a single multi-pairing.  Returns
        True iff every triple would verify individually (with overwhelming
        probability).
        """

    @abc.abstractmethod
    def prepare_batch_verify(
        self, triple: Tuple[Sequence[bytes], bytes, bytes]
    ) -> Optional[BatchSemiAggregate]:
        """Per-triple preparation; None signals an invalid triple."""

    @abc.abstractmethod
    def complete_batch_verify(
        self, semi_aggregates: Sequence[Optional[BatchSemiAggregate]]
    ) -> bool:
        ...
