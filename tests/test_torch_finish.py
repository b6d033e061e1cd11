"""The batch verdict's cooperative routines and the one-launch gather.

pairing.cuh's cooperative Fq12 product, square, cyclotomic square, Miller
loop and final exponentiation (the finish kernel's; one block of two
warps per value on the card) build as host C++ in both Montgomery
engines, each phase a loop over its lanes.  Word for word they must give
the plain towers.py / pairing.py functions, the Miller loop (the miller
kernel, a block per row) the plain miller, and the final exponentiation
the reference's teku_tpu.ops.pairing.final_exponentiation.  finish must
give the verdicts that the inputs were built to give (valid, one bad
lane, an infinity signature sum, 1 row, odd row and lane counts), and
gather_hm (one launch a call, in_range written by the kernel) the plain
gather.
"""

import jax
import numpy as np
import pytest
import torch

from teku_tpu.ops import pairing as JPR
from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls import pairing as OP
from teku_tpu_torch.crypto.bls.constants import P, R
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops import towers as T
from teku_tpu_torch.ops.kernels import fp381 as KF
from teku_tpu_torch.ops.kernels import pairing as KP
from teku_tpu_torch.ops.kernels import shard as KSH
from tests.torch_parity import as_np, no_aot_store, one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0xF1A)
ENGINES = ("cios", "mma")


def scalar():
    return int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1


def host(source, engine="cios"):
    return K.lib(source, host=True, engine=engine)


def fq12_words(vals) -> torch.Tensor:
    """Oracle Fq12 values ((c0, c1) of (Fq2, Fq2, Fq2)) -> (n, 12, 12)."""
    return torch.from_numpy(np.array(
        [[fp.int_to_words(c) for six in v for two in six for c in two]
         for v in vals], dtype=np.int32))


def random_fq12(n) -> torch.Tensor:
    return torch.from_numpy(np.array(
        [[fp.int_to_words(int.from_bytes(RNG.bytes(48), "big") % P)
          for _ in range(12)] for _ in range(n)], dtype=np.int32))


def cyclotomic(words) -> torch.Tensor:
    """f^((p^6 - 1)(p^2 + 1)): the easy part, into the cyclotomic subgroup."""
    f = T.fq12_from_words(words)
    g = T.fq12_mul(T.fq12_conj(f), T.fq12_inv(f))
    return T.fq12_to_words(T.fq12_mul(T.fq12_frobenius(g, 2), g))


def miller_value():
    return OP.miller_loop(
        C.to_affine(C.FQ_OPS, C.point_mul(C.FQ_OPS, scalar(), C.G1_GENERATOR)),
        C.to_affine(C.FQ2_OPS, C.point_mul(C.FQ2_OPS, scalar(),
                                           C.G2_GENERATOR)))


@pytest.mark.parametrize("engine", ENGINES)
def test_coop_fq12_ops_match_towers(engine):
    """Product, square (ONE, zero and random values) and cyclotomic square
    (on cyclotomic values, where it equals the square), once and chained,
    word for word; the Euclid inverse they take against Fermat's."""
    a, b = random_fq12(4), random_fq12(4)
    a[0] = fq12_words([(((1, 0), (0, 0), (0, 0)), ((0, 0),) * 3)])[0]
    a[1] = 0
    c = cyclotomic(random_fq12(3))
    lib = host("pairing", engine)
    with K.plain_engine(engine):
        for op, args, reps in (("mul", (a, b), 1), ("mul", (a, b), 3),
                               ("sqr", (a,), 1), ("sqr", (c,), 2),
                               ("cyclo_sqr", (c,), 1), ("cyclo_sqr", (c,), 3)):
            assert torch.equal(
                KP._run_pairing_ops(lib, op, *args, reps=reps),
                KP.pairing_ops_plain(op, *args, reps=reps)), (op, reps)
    assert torch.equal(KP._run_pairing_ops(lib, "cyclo_sqr", c),
                       KP._run_pairing_ops(lib, "sqr", c))
    # the Fq inverse of the routines (binary extended Euclid), 0 -> 0
    x = torch.from_numpy(fp.ints_to_words([0, 1, P - 1, 2, P - 2], 12).copy())
    fp381 = host("fp381", engine)
    assert torch.equal(KF._run(fp381, "fp_inv_euclid", x),
                       KF._run(fp381, "fp_inv", x))


@pytest.mark.parametrize("engine", ENGINES)
def test_coop_final_exponentiation_matches_plain(engine):
    """Random Fq12 values and a real Miller value: the cooperative final
    exponentiation gives the plain one's words."""
    a = torch.cat([random_fq12(2), fq12_words([miller_value()])])
    lib = host("pairing", engine)
    coop = KP._run_pairing_ops(lib, "final_exp", a)
    with K.plain_engine(engine):
        assert torch.equal(coop, KP.pairing_ops_plain("final_exp", a))


def test_coop_final_exponentiation_matches_reference():
    """On one real Miller value, called as tests/test_torch_pairing.py
    calls the reference (store off: torch_parity.no_aot_store)."""
    ml = miller_value()
    dev = tuple(tuple(tuple(fp.int_to_mont(c)[None] for c in two)
                      for two in six) for six in ml)
    ref = jax.jit(JPR.final_exponentiation)(dev)
    want = T.fq12_to_words(fp.from_reference(as_np(ref)))
    got = KP._run_pairing_ops(host("pairing"), "final_exp", fq12_words([ml]))
    assert torch.equal(got, want)
    assert torch.equal(got, fq12_words([OP.final_exponentiation(ml)]))


def g1_affine_words(ks) -> torch.Tensor:
    return torch.from_numpy(np.array(
        [[fp.int_to_words(c) for c in C.to_affine(
            C.FQ_OPS, C.point_mul(C.FQ_OPS, k % R, C.G1_GENERATOR))]
         for k in ks], dtype=np.int32))


def g2_words(ks, jacobian) -> torch.Tensor:
    """[k]G2 (k = None: infinity) as affine (n, 2, 2, 12) or Jacobian
    (n, 3, 2, 12) words (z = 1; infinity (1, 1, 0))."""
    rows = []
    for k in ks:
        if k is None:
            pt = ((1, 0), (1, 0), (0, 0))
        else:
            x, y = C.to_affine(C.FQ2_OPS, C.point_mul(C.FQ2_OPS, k % R,
                                                      C.G2_GENERATOR))
            pt = (x, y, (1, 0))
        rows.append([[fp.int_to_words(c) for c in v]
                     for v in pt[:3 if jacobian else 2]])
    return torch.from_numpy(np.array(rows, dtype=np.int32))


@pytest.mark.parametrize("engine", ENGINES)
def test_finish_verdicts(engine):
    """e(a_i G1, b_i G2) over the rows against e(-G1, sum of the lanes):
    True exactly when the lanes sum to sum a_i b_i G2.  The miller
    kernel's cooperative Miller loop gives the plain miller's rows on
    every batch (3, 1 and 2 rows), held in one plain call at the end."""
    lib = host("pairing", engine)
    batches = []

    def verdict(pairs, lane_ks):
        agg = g1_affine_words([a for a, _ in pairs])
        hm = g2_words([b for _, b in pairs], jacobian=False)
        ml = KP._run_miller(lib, agg, hm,
                            torch.ones(len(pairs), dtype=torch.bool))
        batches.append((agg, hm, ml))
        wsig = g2_words(lane_ks, jacobian=True)
        got = KP._run_finish(lib, ml, wsig)
        return got, (ml, wsig)

    def lanes_for(s, n):
        ks = [scalar() for _ in range(n - 1)]
        return ks + [(s - sum(ks)) % R]

    pairs = [(scalar(), scalar()) for _ in range(3)]
    s = sum(a * b for a, b in pairs) % R
    ks = lanes_for(s, 5)
    ok, args = verdict(pairs, ks)
    assert ok.tolist() == [True]                      # 3 rows, 5 lanes
    if engine == "cios":
        assert KP.finish_plain(*args).tolist() == [True]
    bad = list(ks)
    bad[2] = (bad[2] + 1) % R
    assert verdict(pairs, bad)[0].tolist() == [False]  # one bad lane
    one = [(scalar(), scalar())]
    assert verdict(one, [one[0][0] * one[0][1]])[0].tolist() == [True]
    # an infinity sum: lanes c, -c and infinity, against rows that cancel
    a, b, c = scalar(), scalar(), scalar()
    inf_lanes = [c, R - c, None]
    assert verdict([(a, b), (R - a, b)], inf_lanes)[0].tolist() == [True]
    assert verdict([(a, b), (a, b)], inf_lanes)[0].tolist() == [False]
    agg, hm, ml = (torch.cat(t) for t in zip(*batches))
    assert torch.equal(ml, KP.miller_plain(
        agg, hm, torch.ones(ml.shape[0], dtype=torch.bool)))


def test_gather_hm_one_launch_no_fill(monkeypatch):
    """Out-of-range indices give zero rows and in_range False; rows == 0
    returns without a launch; rows x 48 words past one block's threads;
    each call with rows counts one launch and writes outputs of its own."""
    monkeypatch.setattr(KSH, "on_card", lambda t: True)
    monkeypatch.setattr(KSH, "lib", lambda src, host=False, engine="cios":
                        K.lib(src, host=True, engine=engine))
    hm = g2_words([scalar() for _ in range(6)], jacobian=False)
    K.reset_launches()
    idx = torch.tensor([5, 6, 0, -1, 2], dtype=torch.int32)
    out, ok = KSH.gather_hm(hm, idx)
    assert ok.tolist() == [False] and ok.dtype == torch.bool
    assert not out[1].any() and not out[3].any()
    assert torch.equal(out[[0, 2, 4]], hm[[5, 0, 2]])
    assert torch.equal(out, KSH.gather_hm_plain(hm, idx)[0])
    assert K.LAUNCHES["gather_hm"] == 1
    out, ok = KSH.gather_hm(hm, torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 2, 2, 12) and ok.tolist() == [True]
    assert K.LAUNCHES["gather_hm"] == 1
    idx = torch.from_numpy(RNG.integers(0, 6, 40).astype(np.int32))
    out, ok = KSH.gather_hm(hm, idx)                   # 1,920 words
    assert ok.tolist() == [True] and torch.equal(out, hm[idx.long()])
    assert K.LAUNCHES["gather_hm"] == 2
    # a call's outputs are its own: a later call leaves held ones as they were
    again, flag = KSH.gather_hm(hm, idx.flip(0))
    assert again.data_ptr() != out.data_ptr()
    assert torch.equal(out, hm[idx.long()]) and ok.tolist() == [True]
    assert torch.equal(again, hm[idx.flip(0).long()])
    assert K.LAUNCHES["gather_hm"] == 3
