"""BLS facade of the port: one entry point for BLS operations.

``set_implementation`` installs a provider (the pure-Python oracle by
default, ``TorchBls12381`` for the card); the functions below forward to
it, with the eth2 wrapper rule for an empty key list.
"""

from typing import Sequence, Tuple

from .pure_impl import G2_INFINITY, PureBls12381
from .spi import BLS12381, ResolvedHandle

_IMPL: BLS12381 = PureBls12381()


def set_implementation(impl: BLS12381) -> None:
    global _IMPL
    _IMPL = impl


def get_implementation() -> BLS12381:
    return _IMPL


def reset_implementation() -> None:
    set_implementation(PureBls12381())


def verify(public_key: bytes, message: bytes, signature: bytes) -> bool:
    return _IMPL.verify(public_key, message, signature)


def aggregate_verify(public_keys: Sequence[bytes], messages: Sequence[bytes],
                     signature: bytes) -> bool:
    return _IMPL.aggregate_verify(public_keys, messages, signature)


def fast_aggregate_verify(public_keys: Sequence[bytes], message: bytes,
                          signature: bytes) -> bool:
    return _IMPL.fast_aggregate_verify(public_keys, message, signature)


def eth_fast_aggregate_verify(public_keys: Sequence[bytes], message: bytes,
                              signature: bytes) -> bool:
    """eth2 wrapper: an empty key list with the infinity signature verifies."""
    if not public_keys and signature == G2_INFINITY:
        return True
    return _IMPL.fast_aggregate_verify(public_keys, message, signature)


def batch_verify(triples: Sequence[Tuple[Sequence[bytes], bytes, bytes]]) -> bool:
    if not triples:
        return True
    if len(triples) == 1:
        pks, msg, sig = triples[0]
        return _IMPL.fast_aggregate_verify(pks, msg, sig)
    return _IMPL.batch_verify(triples)


def begin_batch_verify(triples):
    """Async twin of batch_verify: a handle whose .result() is the verdict,
    or None when the implementation has no async path."""
    if not triples:
        return ResolvedHandle(True)
    begin = getattr(_IMPL, "begin_batch_verify", None)
    return None if begin is None else begin(triples)
