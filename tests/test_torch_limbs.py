"""Port parity: teku_tpu_torch fp381 limbs vs the JAX engine.

Same seeded numpy inputs through teku_tpu/ops/limbs.py and its PyTorch
twin; limb-level ops must be bit-identical (tolerance: exact).  Also the
conversions between the reference layout, canonical words and wire
bytes.  The towers are in test_torch_towers.py.
"""

import numpy as np
import pytest
import torch

from teku_tpu.ops import limbs as JL
from teku_tpu_torch.crypto.bls.constants import P
from teku_tpu_torch.ops import limbs as fp
from tests.torch_parity import (as_np, assert_same_bits, assert_same_values,
                                no_aot_store, one_torch_thread)  # noqa: F401

RNG = np.random.default_rng(0x7E4C)


def rand_ints(n):
    return [int.from_bytes(RNG.bytes(48), "big") % P for _ in range(n)]


def mont(vals):
    return np.stack([JL.int_to_mont(v) for v in vals])


def t(x):
    return fp.from_reference(x)


def test_constants_match_reference():
    assert (fp.W, fp.L, fp.N0INV) == (JL.W, JL.L, JL.N0INV)
    np.testing.assert_array_equal(fp.P_LIMBS, JL.P_LIMBS)
    np.testing.assert_array_equal(fp.ONE_MONT, JL.ONE_MONT)
    np.testing.assert_array_equal(fp.R2_LIMBS, JL.R2_LIMBS)


def test_mont_mul_sqr_compress_bit_identical():
    a, b = mont(rand_ints(6)), mont(rand_ints(6))
    lazy_a = 3 * a - 2 * np.roll(b, 1, axis=0)     # 5 units, signed
    lazy_b = b + np.roll(a, 2, axis=0)             # 2 units
    for x, y in ((a, b), (lazy_a, lazy_b), (lazy_b, lazy_a)):
        assert_same_bits(as_np(JL.mont_mul_vpu(x, y)), fp.mont_mul(t(x), t(y)))
        assert_same_bits(as_np(JL.mont_sqr_vpu(x)), fp.mont_sqr(t(x)))
    big = lazy_a * 1000
    assert_same_bits(as_np(JL.compress(big)), fp.compress(t(big)))
    assert_same_bits(as_np(JL.canonical(lazy_a)), fp.canonical(t(lazy_a)))
    assert_same_bits(as_np(JL.canonical_plain(lazy_b)),
                     fp.canonical_plain(t(lazy_b)))


@pytest.mark.parametrize("ua,ub", [(1, 64), (8, 8), (64, 1)])
def test_mont_mul_lazy_contract_edge(ua, ub):
    """Signed lazy sums at the units(a) * units(b) = 64 edge."""
    def lazy(n):
        acc = np.zeros((4, fp.L), dtype=np.int64)
        for _ in range(n):
            acc = acc + RNG.choice([1, -1]) * mont(rand_ints(4))
        return acc
    a, b = lazy(ua), lazy(ub)
    assert_same_bits(as_np(JL.mont_mul_vpu(a, b)), fp.mont_mul(t(a), t(b)))


def test_pow_inv_sqrt_match_reference():
    a = mont(rand_ints(3) + [0])
    assert_same_bits(as_np(JL.pow_static(a, 13)), fp.pow_static(t(a), 13))
    assert_same_bits(as_np(JL.inv(a)), fp.inv(t(a)))
    assert_same_bits(as_np(JL.sqrt_candidate(a)), fp.sqrt_candidate(t(a)))
    # inv_many: the prefix products run in another order -> same values
    assert_same_values(as_np(JL.inv_many(a)), fp.inv_many(t(a)))
    assert fp.limbs_to_int(fp.inv_many(t(a))[3]) == 0


def test_gt_is_zero_eq_select():
    vals = [0, 1, P - 1, (P - 1) // 2]
    a = np.stack([JL.int_to_limbs(v) for v in vals])
    b = np.roll(a, 1, axis=0)
    assert fp.gt(t(a), t(b)).tolist() == np.asarray(JL.gt(a, b)).tolist()
    m = mont(vals)
    assert fp.is_zero(t(m)).tolist() == np.asarray(JL.is_zero(m)).tolist()
    assert fp.eq(t(m), t(m + 0)).all()
    cond = torch.tensor([True, False, True, False])
    sel = fp.select(cond, t(m), t(np.roll(m, 1, axis=0)))
    assert_same_bits(as_np(JL.select(np.asarray(cond), m, np.roll(m, 1, 0))),
                     sel)


def test_words_and_reference_conversions_round_trip():
    vals = rand_ints(5) + [0, 1, P - 1]
    m = mont(vals)
    w = fp.to_words(t(m))
    assert w.dtype == torch.int32 and w.shape == (8, fp.NW)
    assert [fp.words_to_int(w[i]) for i in range(8)] == vals
    assert_same_bits(as_np(JL.canonical(m)), fp.canonical(fp.from_words(w)))
    np.testing.assert_array_equal(fp.to_reference(fp.from_reference(m)), m)
    wire = np.stack([np.frombuffer(v.to_bytes(48, "big"), dtype=np.uint8)
                     for v in vals])
    np.testing.assert_array_equal(fp.bytes_to_words_np(wire), w.numpy())
    np.testing.assert_array_equal(
        fp.plain_limbs_from_words(w).numpy(),
        np.stack([JL.int_to_limbs(v) for v in vals]))
