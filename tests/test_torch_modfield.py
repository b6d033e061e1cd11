"""Port parity: the Fr field of teku_tpu_torch/ops/modfield.py vs
teku_tpu/ops/modfield.py (the reference's make_field(R), eager, at the
shapes of tests/test_ops_kzg.py).

Same seeded numpy inputs through both.  Tolerance: exact -- limbs equal
bit for bit (the two engines run the same lazy-limb algorithm), except
inv_many, whose log-depth products may order differently: its values
are compared canonically.  Also the Fr word conversions of the kernels'
interface.
"""

import numpy as np
import pytest
import torch

from teku_tpu.ops import kzg as RK
from teku_tpu_torch.crypto.bls.constants import R
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops.modfield import FR
from tests.torch_parity import no_aot_store, one_torch_thread  # noqa: F401

RFR = RK.FR
RNG = np.random.default_rng(0xF12)


def rand_fr(n):
    return [int.from_bytes(RNG.bytes(32), "big") % R for _ in range(n)]


def mont_inputs(n):
    """n Montgomery units and n lazy values (differences of two units)."""
    a = np.stack([FR.int_to_mont(v) for v in rand_fr(n)])
    b = np.stack([FR.int_to_mont(v) for v in rand_fr(n)])
    c = np.stack([FR.int_to_mont(v) for v in rand_fr(n)])
    return a, b - c


def assert_bits(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_constants_and_host_conversions_match_reference():
    assert (FR.M, FR.W, FR.L, FR.MASK) == (RFR.M, RFR.W, RFR.L, RFR.MASK)
    assert FR.L == 10 and FR.NW == 8
    np.testing.assert_array_equal(FR.ONE_MONT, RFR.ONE_MONT)
    np.testing.assert_array_equal(FR.M_LIMBS, RFR.M_LIMBS)
    for v in rand_fr(4) + [0, 1, R - 1]:
        np.testing.assert_array_equal(FR.int_to_mont(v), RFR.int_to_mont(v))
        assert FR.mont_to_int(FR.int_to_mont(v)) == v
        assert FR.limbs_to_int(FR.int_to_limbs(v)) == v


@pytest.mark.parametrize("op", ["mont_mul", "mont_sqr", "to_mont"])
def test_products_bit_identical(op):
    a, lazy = mont_inputs(3)
    x = np.concatenate([a[:2], lazy[:1]])
    y = np.concatenate([lazy[1:], a[2:]])
    if op == "mont_mul":
        ref, got = RFR.mont_mul(x, y), FR.mont_mul(torch.from_numpy(x),
                                                    torch.from_numpy(y))
        assert_bits(RFR.mont_mul_vpu(x, y), FR.mont_mul_vpu(
            torch.from_numpy(x), torch.from_numpy(y)))
    elif op == "mont_sqr":
        ref, got = RFR.mont_sqr(x), FR.mont_sqr(torch.from_numpy(x))
    else:
        plain = np.stack([FR.int_to_limbs(v) for v in rand_fr(3)])
        ref, got = RFR.to_mont(plain), FR.to_mont(torch.from_numpy(plain))
    assert_bits(ref, got)


def test_canonical_plain_and_pow_static_bit_identical():
    a, _ = mont_inputs(1)
    assert_bits(RFR.canonical_plain(a), FR.canonical_plain(torch.from_numpy(a)))
    assert_bits(RFR.pow_static(a, 4096), FR.pow_static(torch.from_numpy(a),
                                                       4096))
    v = FR.mont_to_int(a[0])
    assert FR.mont_to_int(FR.pow_static(torch.from_numpy(a), 4096)[0]) == \
        pow(v, 4096, R)


def test_inv_many_canonical_with_zero_lane():
    vals = rand_fr(5) + [0]
    a = np.stack([FR.int_to_mont(v) for v in vals])
    ref = np.asarray(RFR.inv_many(a))
    got = FR.inv_many(torch.from_numpy(a))
    assert_bits(RFR.canonical(ref), FR.canonical(got))
    for i, v in enumerate(vals):
        assert FR.mont_to_int(got[i]) == (pow(v, R - 2, R) if v else 0)
    # a longer batch: the log-depth scans over a non-power-of-two length
    vals = rand_fr(37)
    vals[11] = 0
    got = FR.inv_many(torch.from_numpy(np.stack([FR.int_to_mont(v)
                                                 for v in vals])))
    assert [FR.mont_to_int(g) for g in got] == [
        pow(v, R - 2, R) if v else 0 for v in vals]


def test_fr_word_round_trip():
    vals = rand_fr(6) + [0, 1, R - 1]
    words = torch.from_numpy(fp.ints_to_words(vals, FR.NW))
    assert words.dtype == torch.int32 and words.shape == (9, 8)
    assert [fp.words_to_int(w) for w in words] == vals
    mont = FR.from_words(words)
    assert [FR.mont_to_int(m) for m in mont] == vals
    assert torch.equal(FR.to_words(mont), words)
    # lazy (non-canonical) limbs leave as canonical words
    assert torch.equal(FR.to_words(mont - torch.from_numpy(FR.M_LIMBS)),
                       words)
    assert torch.equal(FR.plain_to_words(FR.words_to_plain(words)), words)
    bits = fp.words_to_bits(words, 255)
    assert bits.shape == (9, 255)
    assert [int("".join(map(str, b.tolist())), 2) for b in bits] == vals
