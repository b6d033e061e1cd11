"""Port parity: teku_tpu_torch hash-to-G2 vs teku_tpu/ops/h2c.py.

The device pipeline (SSWU, 3-isogeny, sgn0, cofactor clearing) on the
same draws and at the shape tests/test_ops_h2c.py compiles: Jacobian
outputs bit-identical.  The h2c kernel's plain version (the port's
stage_h2c on canonical words) against the oracle's hash_to_g2.
"""

import jax
import numpy as np
import torch

from teku_tpu.ops import h2c as JH
from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls import hash_to_curve as OH
from teku_tpu_torch.ops import h2c
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops.kernels import h2c as KH
from tests.torch_parity import (as_np, assert_same_bits,  # noqa: F401
                                no_aot_store, one_torch_thread)

MSGS = [b"", b"abc", b"hello world", b"\x00" * 32, b"q" * 100]


def test_host_draws_match_reference():
    ref = JH.messages_to_fields(MSGS)
    got = h2c.messages_to_fields(MSGS)
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            np.testing.assert_array_equal(a, b)


def test_hash_to_g2_device_bit_identical():
    u0, u1 = JH.messages_to_fields(MSGS)
    ref = jax.jit(JH.hash_to_g2_device)(u0, u1)
    got = h2c.hash_to_g2_device(fp.from_reference(u0), fp.from_reference(u1))
    assert_same_bits(as_np(ref), got)


def test_h2c_plain_words_match_oracle():
    msgs = MSGS[:3] + [b"m" * 7]
    draws = [OH.hash_to_field_fq2(m, 2) for m in msgs]

    def words(k):
        return torch.from_numpy(np.stack([
            np.stack([fp.int_to_words(d[k][0]), fp.int_to_words(d[k][1])])
            for d in draws]))
    out = KH.h2c(words(0), words(1))
    assert out.shape == (4, 2, 2, 12) and out.dtype == torch.int32
    for i, m in enumerate(msgs):
        x = (fp.words_to_int(out[i, 0, 0]), fp.words_to_int(out[i, 0, 1]))
        y = (fp.words_to_int(out[i, 1, 0]), fp.words_to_int(out[i, 1, 1]))
        assert (x, y) == C.to_affine(C.FQ2_OPS, OH.hash_to_g2(m))
