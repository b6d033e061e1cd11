"""miller and kzg_fold on pairing.cuh's cooperative routines, on the host.

miller runs one block of two warps per message row (coop_miller), and
kzg_fold its two Miller loops and its final exponentiation on blocks of
the same routines (coop_miller, coop_final_exp).  Their sources build as
host C++ in both Montgomery engines, each block's phases a loop over its
lanes, and word for word they must give the plain versions: miller_plain
on a seeded batch with masked rows and a row at the G1 generator;
kzg_fold_plain on the reference's 8-lane shape (an infinity lane and two
padding lanes in each case) with a valid fold, one bad proof, and a group
whose sum is infinity -- ok, pair and pair_inf alike.

Tolerance: exact, on words and verdicts.  Each case's plain version runs
once (its words are canonical, the same under either engine's product)
and both engines' host builds are held against it.
"""

import numpy as np
import pytest
import torch

from teku_tpu_torch.crypto import kzg as HK
from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls.constants import R
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import kzg as TK
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops.kernels import kzg as KK
from teku_tpu_torch.ops.kernels import pairing as KP
from tests.torch_parity import one_torch_thread  # noqa: F401

ENGINES = ("cios", "mma")
SETUP = HK.insecure_setup()


def scalars(rng, n):
    return [int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1
            for _ in range(n)]


def g1_words(ks) -> torch.Tensor:
    """[k]G1 affine, (n, 2, 12) words."""
    return torch.from_numpy(np.array(
        [[fp.int_to_words(c) for c in C.to_affine(
            C.FQ_OPS, C.point_mul(C.FQ_OPS, k, C.G1_GENERATOR))]
         for k in ks], dtype=np.int32))


def g2_words(ks) -> torch.Tensor:
    """[k]G2 affine, (n, 2, 2, 12) words."""
    return torch.from_numpy(np.array(
        [[[fp.int_to_words(c) for c in v] for v in C.to_affine(
            C.FQ2_OPS, C.point_mul(C.FQ2_OPS, k, C.G2_GENERATOR))]
         for k in ks], dtype=np.int32))


@pytest.fixture(scope="module")
def miller_case():
    """Five rows, the first at the G1 generator, rows 2 and 4 masked."""
    rng = np.random.default_rng(0xC0)
    agg = g1_words([1] + scalars(rng, 4))
    hm = g2_words(scalars(rng, 5))
    mask = torch.tensor([1, 1, 0, 1, 0], dtype=torch.bool)
    with torch.inference_mode():
        want = KP.miller_plain(agg, hm, mask)
    return (agg, hm, mask), want


@pytest.mark.parametrize("engine", ENGINES)
def test_miller_rows_match_plain(engine, miller_case):
    args, want = miller_case
    got = KP._run_miller(K.lib("pairing", host=True, engine=engine), *args)
    assert got.dtype == want.dtype and got.shape == (5, 12, 12)
    assert torch.equal(got, want)
    one = torch.zeros(12, 12, dtype=torch.int32)
    one[0, 0] = 1
    assert torch.equal(got[2], one) and torch.equal(got[4], one)
    assert not torch.equal(got[0], one)


def fold_case(case):
    """kzg_fold's inputs at the reference's 8-lane shape: lanes 0-5 real
    (group b, the proofs: lanes 3 and 4; lane 2 at infinity), lanes 6-7
    padding as TorchKzg pads them.  "valid": group a's sum is tau times
    group b's (the insecure setup's known tau), so the fold holds; "bad
    proof": lane 3's point replaced; "infinity group": group b's lanes at
    infinity or invalid."""
    rng = np.random.default_rng(0xF01D)
    ks, ss = scalars(rng, 6), scalars(rng, 6)
    group_b = [False, False, False, True, True, False]
    # sum over group a of s k = tau * (sum over group b of s k), lane 2 out
    b_sum = sum(s * k for s, k, b in zip(ss, ks, group_b) if b)
    a_rest = sum(ss[i] * ks[i] for i in (0, 1))
    ks[5] = (SETUP.tau * b_sum - a_rest) * pow(ss[5], -1, R) % R
    if case == "bad proof":
        ks[3] = scalars(rng, 1)[0]
    pts = g1_words(ks)
    xs = torch.zeros(8, 12, dtype=torch.int32)
    ys = torch.zeros(8, 12, dtype=torch.int32)
    xs[:6], ys[:6] = pts[:, 0], pts[:, 1]
    inf = torch.tensor([0, 0, 1, 0, 0, 0, 0, 0], dtype=torch.bool)
    valid = torch.tensor([1] * 6 + [0] * 2, dtype=torch.bool)
    if case == "infinity group":
        inf[3], valid[4] = True, False
    words = torch.from_numpy(TK.fr_words(ss + [0, 0]))
    return (xs, ys, inf, valid, torch.tensor(group_b + [False] * 2),
            words, TK.TorchKzg(device="cpu")._g2_consts(SETUP))


@pytest.mark.parametrize("case, ok, pair_inf", [
    ("valid", True, [False, False]),
    ("bad proof", False, [False, False]),
    ("infinity group", False, [False, True])])
def test_kzg_fold_matches_plain(case, ok, pair_inf):
    args = fold_case(case)
    with torch.inference_mode():
        want = KK.kzg_fold_plain(*args)
    assert want[0].tolist() == [ok] and want[2].tolist() == pair_inf
    for engine in ENGINES:
        got = KK._run_kzg_fold(K.lib("kzg", host=True, engine=engine), *args)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b), (case, engine)
    if pair_inf[1]:
        assert not want[1][1].any()         # infinity -> (0, 0)
