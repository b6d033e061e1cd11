"""Port parity: teku_tpu_torch hash-to-G2 vs teku_tpu/ops/h2c.py.

The device pipeline (SSWU, 3-isogeny, sgn0, cofactor clearing) on the
same draws and at the shape tests/test_ops_h2c.py compiles: Jacobian
outputs bit-identical.  The h2c kernel's plain version (the port's
stage_h2c on canonical words) against the oracle's hash_to_g2.  The
kernel's source (a warp a row) built as host C++ on both engines against
the plain version, word for word, on 1, 3 and 8 rows whose draws take
every square-root candidate on both SSWU branches, u = 0 (tv2 == 0), and
draws whose points double or cancel.
"""

import jax
import numpy as np
import pytest
import torch

from teku_tpu.ops import h2c as JH
from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls import fields as F
from teku_tpu_torch.crypto.bls import hash_to_curve as OH
from teku_tpu_torch.crypto.bls.constants import P, SSWU_A2, SSWU_B2, SSWU_Z2
from teku_tpu_torch.ops import h2c
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops.towers import SQRT_EXP, _SQRT_C2, _SQRT_C3, _SQRT_M1
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


def sswu_case(u):
    """(branch, root) the SSWU map takes for draw u: branch 1 when gx1 is
    a square, else 2; root the index of the winning candidate's factor in
    (1, sqrt(-1), sqrt(sqrt(-1)), sqrt(-sqrt(-1))), as the kernel's order."""
    mul, sqr, add = F.fq2_mul, F.fq2_sqr, F.fq2_add
    tv = mul(SSWU_Z2, sqr(u))
    tv2 = add(sqr(tv), tv)
    zero = F.fq2_is_zero(tv2)
    xd = mul(SSWU_A2, SSWU_Z2 if zero else tv2)
    x1n = SSWU_B2 if zero else F.fq2_neg(mul(SSWU_B2, add(tv2, F.FQ2_ONE)))
    xd3 = mul(sqr(xd), xd)
    gx1n = add(add(mul(sqr(x1n), x1n), mul(mul(SSWU_A2, x1n), sqr(xd))),
               mul(SSWU_B2, xd3))
    gval = mul(gx1n, xd3)
    cand = F.fq2_pow(gval, SQRT_EXP)
    roots = (F.FQ2_ONE, _SQRT_M1, _SQRT_C2, _SQRT_C3)
    for branch, (c, g) in enumerate((
            (cand, gval),
            (mul(mul(mul(sqr(u), u), h2c._Z3_POW_E), cand),
             mul(mul(sqr(tv), tv), gval))), 1):
        for k, root in enumerate(roots):
            if F.fq2_eq(sqr(mul(root, c)), g):
                return branch, k
    raise AssertionError("neither SSWU value has a root")


@pytest.fixture(scope="module")
def h2c_grid():
    """8 rows: their first draws take the 8 (branch, root) cases in turn;
    the second draws of rows 0-4 take cases 3-7, row 5's is its first
    (the draws' sum doubles), row 6's the first's negative (the sum is
    infinity) and row 7's u = 0 (tv2 == 0, the exceptional case); and the
    plain version's words."""
    rng = np.random.default_rng(0x2C2)
    cases = {}
    while len(cases) < 8:
        u = tuple(int.from_bytes(rng.bytes(48), "big") % P for _ in range(2))
        cases.setdefault(sswu_case(u), u)
    first = [cases[k] for k in sorted(cases)]
    second = first[3:] + [first[5], tuple((P - c) % P for c in first[6]),
                          (0, 0)]
    assert sorted(cases) == [(b, k) for b in (1, 2) for k in range(4)]

    def words(us):
        return torch.from_numpy(np.array(
            [[fp.int_to_words(c) for c in u] for u in us], dtype=np.int32))
    u0, u1 = words(first), words(second)
    with torch.inference_mode():
        want = KH.h2c_plain(u0, u1)
    assert not want[6].any() and want[5].any()      # infinity -> (0, 0)
    return u0, u1, want


@pytest.mark.parametrize("engine", ["cios", "mma"])
def test_h2c_host_build_matches_plain(engine, h2c_grid):
    u0, u1, want = h2c_grid
    library = K.lib("h2c", host=True, engine=engine)
    for n in (1, 3, 8):
        got = KH._run_h2c(library, u0[:n].contiguous(), u1[:n].contiguous())
        assert got.dtype == want.dtype and got.shape == (n, 2, 2, 12)
        assert torch.equal(got, want[:n]), (engine, n)
