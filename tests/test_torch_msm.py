"""The GLV + Pippenger scalars stage of the port: ops/msm.py, kernels/msm.cu
and the provider's path rule, against teku_tpu/ops/msm.py and the oracle.

- The host helpers (GLV sampling, digits, LAMBDA, windows, the path rule)
  equal the JAX package's on seeded numpy inputs.
- The plain msm_rows equals the oracle and the jitted reference bit for
  bit on an adversarial grid: zero scalars, all-ones digits, a duplicate
  point with duplicate buckets, an infinity column, excluded columns.
- The plain grouped G1 and G2 MSMs equal the ladder driven with the
  effective multipliers k1 + k2 LAMBDA, canonically.
- The host C++ build of msm.cu equals its plain version word for word.
- TorchBls12381 on the pippenger path gives the oracle's verdicts.

``slow``: stage_scalars_pippenger and JaxBls12381 on pippenger against
the port (cold compiles of the reference's staged programs).  The
module imports jax and the JAX package inside the tests that use them,
so the card test runs where neither is installed.
"""

import random

import numpy as np
import pytest
import torch

from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls.constants import R
from teku_tpu_torch.crypto.bls.pure_impl import G2_INFINITY, PureBls12381
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops import msm as M
from teku_tpu_torch.ops import points as PT
from teku_tpu_torch.ops import verify as V
from teku_tpu_torch.ops.kernels import decompress as KD
from teku_tpu_torch.ops.kernels import h2c as KH
from teku_tpu_torch.ops.kernels import msm as KM
from teku_tpu_torch.ops.kernels import pairing as KP
from teku_tpu_torch.ops.kernels import scalars_group as KS
from teku_tpu_torch.ops.provider import TorchBls12381
from tests.torch_parity import no_aot_store, one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0x3573)
PURE = PureBls12381()
SKS = [int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1 for _ in range(4)]
PKS = [PURE.secret_key_to_public_key(s) for s in SKS]
REF_ENV = ("TEKU_TPU_MSM", "TEKU_TPU_MSM_WINDOW", "TEKU_TPU_MSM_AUTO_MIN_LANES",
           "TEKU_TPU_MSM_AUTO_MIN_DUP")


def rand_point(ops, gen):
    return C.point_mul(ops, int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1,
                       gen)


def stack_g1(points):
    """Oracle Jacobian points -> (X, Y, Z) Montgomery limb arrays (n, L)."""
    return tuple(np.stack([fp.int_to_mont(p[i]) for p in points])
                 for i in range(3))


def stack_g2(points):
    return tuple((np.stack([fp.int_to_mont(p[i][0]) for p in points]),
                  np.stack([fp.int_to_mont(p[i][1]) for p in points]))
                 for i in range(3))


def g1_words(points):
    return torch.from_numpy(np.stack([np.stack(
        [fp.int_to_words(p[i]) for i in range(3)]) for p in points]))


def g2_words(points):
    return torch.from_numpy(np.stack([np.stack(
        [np.stack([fp.int_to_words(p[i][0]), fp.int_to_words(p[i][1])])
         for i in range(3)]) for p in points]))


def g1_at(pt, i):
    return tuple(fp.mont_to_int(c[i]) for c in pt)


def g2_first(pt):
    """The first point of a G2 Jacobian limb tree, as oracle integers."""
    return tuple(tuple(fp.mont_to_int(x.reshape(-1, fp.L)[0]) for x in c)
                 for c in pt)


def oracle_msm(ops, scalars, points):
    acc = C.infinity(ops)
    for s, p in zip(scalars, points):
        acc = C.point_add(ops, acc, C.point_mul(ops, int(s), p))
    return acc


def test_host_helpers_and_path_rule_match_reference(monkeypatch):
    from teku_tpu.ops import msm as RM
    for name in REF_ENV:
        monkeypatch.delenv(name, raising=False)
    assert M.LAMBDA == RM.LAMBDA and M.GLV_BITS == RM.GLV_BITS
    assert M.WINDOW == RM.window_env() and M.G2_SEG == RM._seg_len()
    for w in range(1, 9):
        assert M.n_windows(w) == RM.n_windows(w)
        assert M.window_for_nwin(M.n_windows(w)) == w
    raw = RNG.integers(0, 2**63, 64, dtype=np.int64).astype(np.uint64) * 2
    raw[:3] = [0, 1 << 32, 0xFFFFFFFF]
    k1, k2 = M.glv_sample_from_uint64(raw)
    rk1, rk2 = RM.glv_sample_from_uint64(raw)
    assert np.array_equal(k1, rk1) and np.array_equal(k2, rk2)
    assert (k1[0], k2[0]) == (1, 0)
    digits = M.glv_digits_np(k1, k2)
    assert digits.dtype == np.int32 and digits.shape == (64, 2, 8)
    assert np.array_equal(digits, RM.glv_digits_np(rk1, rk2, window=4))
    for w in (3, 5):
        assert np.array_equal(M.glv_digits_np(k1, k2, w),
                              RM.glv_digits_np(k1, k2, window=w))
    with pytest.raises(ValueError):
        M.glv_digits_np(np.array([1 << 32], np.uint64), np.zeros(1, np.uint64))
    for a, b in zip(k1[:8], k2[:8]):
        assert M.effective_scalar(a, b) == RM.effective_scalar(a, b)
    # the path rule: explicit paths; auto off the device the crossover was
    # tuned for (a TPU) -> ladder, on cpu and cuda alike, as the reference
    # rules off a TPU
    shapes = [(256, 8), (256, 128), (256, 129), (256, 256), (8, 2), (31, 1),
              (32, 16), (32, 17), (4999, 2500), (5000, 2500), (None, None)]
    for path in ("ladder", "pippenger"):
        with M.force(path), RM.force(path):
            for dev in ("cpu", "cuda"):
                assert M.resolve(256, 8, dev) == RM.resolve(256, 8) == path
    with M.force("auto"), RM.force("auto"):
        for lanes, rows in shapes:
            assert M.resolve(lanes, rows, torch.device("cpu")) == "ladder"
            assert RM.resolve(lanes, rows) == "ladder"
        monkeypatch.setattr(RM, "_device_is_tpu", lambda: False)
        for lanes, rows in shapes:
            path, why = M.explain(lanes, rows, torch.device("cuda", 0))
            ref_path, ref_why = RM.explain(lanes, rows)
            assert path == ref_path == "ladder", (lanes, rows)
            assert why["rule"] == ref_why["rule"]
            assert why["tpu"] is ref_why["tpu"] is False
            assert "dup" not in why
        assert M.resolve(256, 8, "cuda") == "ladder"
    assert M.get_path() == "auto"
    with pytest.raises(ValueError):
        M.set_path("bogus")
    M.set_path(None)
    assert M.get_path() == "auto"


def adversarial_grid():
    """4 rows x 4 columns of G1 points, 32-bit scalars and include flags."""
    rng = random.Random(0x88)
    pts = [[C.point_mul(C.FQ_OPS, rng.randrange(1, R), C.G1_GENERATOR)
            for _ in range(4)] for _ in range(4)]
    pts[2][1] = pts[2][0]                      # duplicate point
    pts[2][3] = C.infinity(C.FQ_OPS)           # infinity column
    k = np.array([[0, 0, 0, 0],                # zero scalars
                  [0xFFFFFFFF] * 4,            # all-ones: one bucket per window
                  [7, 7, 0xABCD, 5],           # duplicate digits
                  [1, 0xDEAD, 2, 0xFFFF]], dtype=np.uint64)
    include = np.ones((4, 4), dtype=bool)
    include[3, 1] = include[3, 3] = False      # excluded columns
    return pts, k, include


def test_msm_rows_grid_matches_oracle_and_reference():
    import jax
    from teku_tpu.ops import msm as RM
    from teku_tpu.ops import points as RPT
    pts, k, include = adversarial_grid()
    digits = np.stack([M.glv_digits_np(k[r], np.zeros(4, np.uint64))[:, 0]
                       for r in range(4)])
    limbs = tuple(np.stack([stack_g1(row)[i] for row in pts])
                  for i in range(3))
    got = M.msm_rows(PT.G1_KIT, fp.tree_map(torch.from_numpy, limbs),
                     torch.from_numpy(digits), torch.from_numpy(include))
    ref = jax.jit(lambda p, d, i: RM.msm_rows(RPT.G1_KIT, p, d, i))(
        limbs, digits, include)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for r in range(4):
        exp = oracle_msm(C.FQ_OPS, k[r] * include[r], pts[r])
        assert C.point_eq(C.FQ_OPS, g1_at(got, r), exp), f"row {r}"
    assert PT.is_infinity(PT.G1_KIT, got).tolist() == [True, False, False,
                                                        False]


def bits_of(scalars, nbits):
    return torch.tensor([[(int(s) >> (nbits - 1 - j)) & 1
                          for j in range(nbits)] for s in scalars])


def test_grouped_and_g2_msm_match_the_ladder(monkeypatch):
    """The same multipliers through the MSMs and through the 255-bit
    ladder of their effective values: equal canonical affine values."""
    pk_pts = [rand_point(C.FQ_OPS, C.G1_GENERATOR) for _ in range(4)]
    sig_pts = [rand_point(C.FQ2_OPS, C.G2_GENERATOR) for _ in range(3)] + [
        C.infinity(C.FQ2_OPS)]
    pk = fp.tree_map(torch.from_numpy, stack_g1(pk_pts))
    sig = fp.tree_map(torch.from_numpy, stack_g2(sig_pts))
    k1 = np.array([5, 0, 0xFFFFFFFF, 0x1234], dtype=np.uint64)
    k2 = np.array([0, 3, 0xFFFFFFFF, 0xBEEF], dtype=np.uint64)
    digits = torch.from_numpy(M.glv_digits_np(k1, k2))
    r_eff = [M.effective_scalar(a, b) for a, b in zip(k1, k2)]
    group_idx = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    group_present = torch.ones((2, 2), dtype=torch.bool)
    miller_mask = torch.tensor([True, False, True, True])
    bits = bits_of(r_eff, 255)

    pip = V.to_affine_g1(M.g1_grouped_msm(pk, digits, group_idx,
                                          group_present, miller_mask))
    lad, u_mask = V.stage_group(PT.scalar_mul_bits(PT.G1_KIT, bits, pk),
                                miller_mask, group_idx, group_present)
    assert u_mask.tolist() == [True, True]
    for a, b in zip(pip, lad):
        assert torch.equal(fp.canonical(a), fp.canonical(b))
    for u, lanes in enumerate(([0], [2, 3])):
        exp = oracle_msm(C.FQ_OPS, [r_eff[i] for i in lanes],
                         [pk_pts[i] for i in lanes])
        assert g1_at(pip, u) == C.to_affine(C.FQ_OPS, exp)

    lad2 = V.point_batch_sum(PT.G2_KIT,
                             PT.scalar_mul_bits(PT.G2_KIT, bits, sig))
    exp2 = C.to_affine(C.FQ2_OPS, oracle_msm(C.FQ2_OPS, r_eff, sig_pts))
    assert C.to_affine(C.FQ2_OPS, g2_first(lad2)) == exp2
    for seg in (M.G2_SEG, 2):                  # S = 1, and S = 4 merged
        monkeypatch.setattr(M, "G2_SEG", seg)
        wsig = M.g2_msm(sig, digits)
        assert C.to_affine(C.FQ2_OPS, g2_first(wsig)) == exp2


def kernel_inputs(case):
    """scalars_msm's inputs (words) for the adversarial grid as 16 lanes
    in 4 rows, or a 4-lane grouped batch with an infinity signature, a
    masked lane, a zero draw and a padding row."""
    if case == "grid":
        pts, k, include = adversarial_grid()
        pk_pts = [p for row in pts for p in row]
        base = rand_point(C.FQ2_OPS, C.G2_GENERATOR)
        sig_pts = [base]
        for _ in range(15):
            sig_pts.append(C.point_add(C.FQ2_OPS, sig_pts[-1], base))
        sig_pts[5] = C.infinity(C.FQ2_OPS)
        k1 = k.reshape(-1)
        k2 = np.zeros(16, np.uint64)
        k2[6] = 0xFFFFFFFF                     # row 1: both halves all-ones
        mm = torch.ones(16, dtype=torch.bool)
        gidx = torch.arange(16, dtype=torch.int32).reshape(4, 4)
        gp = torch.from_numpy(include)
    else:
        pk_pts = [rand_point(C.FQ_OPS, C.G1_GENERATOR) for _ in range(4)]
        sig_pts = [rand_point(C.FQ2_OPS, C.G2_GENERATOR) for _ in range(3)]
        sig_pts.append(C.infinity(C.FQ2_OPS))
        raw = RNG.integers(0, 2**63, 4, dtype=np.int64).astype(np.uint64)
        raw[0] = 0
        k1, k2 = M.glv_sample_from_uint64(raw)
        mm = torch.tensor([True, False, True, True])
        gidx = torch.tensor([[0, 1], [2, 3], [0, 0]], dtype=torch.int32)
        gp = torch.tensor([[True, True], [True, True], [False, False]])
    digits = torch.from_numpy(M.glv_digits_np(k1, k2))
    return g1_words(pk_pts), g2_words(sig_pts), digits, mm, gidx, gp


@pytest.mark.parametrize("case", ["grid", "grouped"])
def test_kernel_host_build_matches_plain(case):
    args = kernel_inputs(case)
    got = KM._run_scalars_msm(K.lib("msm", host=True), *args)
    want = KM.scalars_msm_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    if case == "grid":
        assert got[1].tolist() == [False, True, True, True]
    else:
        assert got[1].tolist() == [True, True, False]
    assert KM.scalars_msm(*args)[1].tolist() == got[1].tolist()
    with pytest.raises(ValueError):
        KM.scalars_msm(*args[:2], args[2][:, :, :4].contiguous(), *args[3:])


def batch(msgs, tamper=None, inf_sig=None):
    out = []
    for i, m in enumerate(msgs):
        sig = PURE.sign(SKS[i % 4], b"tampered" if i == tamper else m)
        out.append(([PKS[i % 4]], m, G2_INFINITY if i == inf_sig else sig))
    return out


def test_provider_on_pippenger_gives_oracle_verdicts():
    """The plain path (device="cpu") forced onto pippenger: valid,
    swapped-signature and infinity-signature 4-lane batches."""
    prov = TorchBls12381(device="cpu", multipliers=lambda n: RNG.integers(
        0, 2**63, n, dtype=np.int64).astype(np.uint64))
    valid = batch([b"pip-a", b"pip-a", b"pip-b", b"pip-a"])
    swapped = list(valid)
    swapped[0], swapped[1] = ((valid[0][0], valid[0][1], valid[2][2]),
                              (valid[2][0], valid[2][1], valid[0][2]))
    inf_sig = batch([b"pip-a", b"pip-a", b"pip-b", b"pip-a"], inf_sig=3)
    with M.force("pippenger"):
        for triples in (valid, swapped, inf_sig):
            assert prov.batch_verify(triples) is PURE.batch_verify(triples)
    assert PURE.batch_verify(valid) is True
    assert prov.msm_dispatches == {"ladder": 0, "pippenger": 3}
    plan = prov.plan([prov.prepare_batch_verify(t) for t in valid], True)
    assert plan["msm_path"] == "ladder" and plan["glv_digits"] is None


def test_group_split_and_aggregate_verify_on_pippenger(monkeypatch):
    """A committee split across group-cap rows, and aggregate_verify's
    r = 1 dispatch, through the wrappers on the host C++ build."""
    real_lib = K.lib
    for mod in (KD, KH, KP, KS, KM):
        monkeypatch.setattr(mod, "on_card", lambda t: True)
        monkeypatch.setattr(mod, "lib",
                            lambda src, host=False: real_lib(src, host=True))
    K.reset_launches()
    prov = TorchBls12381(device="cpu", group_cap=2)
    msgs = [b"msm-split"] * 3 + [b"msm-solo"]          # rows of 2, 1, 1
    agg_msgs = [b"msm-agg-0", b"msm-agg-1"]
    agg = PURE.aggregate_signatures(
        [PURE.sign(SKS[i], m) for i, m in enumerate(agg_msgs)])
    with M.force("pippenger"):
        assert prov.batch_verify(batch(msgs)) is True
        assert prov.batch_verify(batch(msgs, tamper=1)) is False
        assert prov.aggregate_verify(PKS[:2], agg_msgs, agg) is True
        assert prov.aggregate_verify(PKS[:2], agg_msgs[::-1], agg) is False
    assert PURE.batch_verify(batch(msgs)) is True
    assert PURE.aggregate_verify(PKS[:2], agg_msgs, agg) is True
    assert prov.msm_dispatches == {"ladder": 0, "pippenger": 4}
    assert K.LAUNCHES["scalars_msm"] == 4 and K.LAUNCHES["scalars_group"] == 0


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False (and nvcc to build the kernels)")
    dev = torch.device("cuda")
    for case in ("grid", "grouped"):
        args = tuple(a.to(dev) for a in kernel_inputs(case))
        got = KM._run_scalars_msm(K.lib("msm"), *args)
        for a, b in zip(got, KM.scalars_msm_plain(*args)):
            assert torch.equal(a, b)


def jax_stage_inputs():
    """stage_scalars_pippenger's inputs as the reference's numpy limbs."""
    args = kernel_inputs("grouped")
    pk = fp.to_reference(KD.g1_from_words(args[0]))
    sig = fp.to_reference(KD.g2_from_words(args[1]))
    return (pk, sig, args[2].numpy(), args[4].numpy(), args[5].numpy(),
            args[3].numpy())


def staged_pipeline_inputs(triples):
    """verify_staged_pippenger's inputs (limbs) for a batch, from the
    provider's plan on the pippenger path."""
    prov = TorchBls12381(device="cpu")
    with M.force("pippenger"):
        plan = prov.plan([prov.prepare_batch_verify(t) for t in triples],
                         True)
    t = {k: torch.from_numpy(v) for k, v in plan.items()
         if isinstance(v, np.ndarray)}
    draws = torch.from_numpy(plan["hm_plan"][3])
    hm = KH.h2c_plain(draws[:, 0:2].contiguous(), draws[:, 2:4].contiguous())
    sig_x = tuple(fp.plain_limbs_from_words(t[k]) for k in ("sig_x0",
                                                            "sig_x1"))
    return (fp.from_words(t["pk_x"]), fp.from_words(t["pk_y"]),
            t["pk_present"], KD.g2_from_words(hm[:len(t["group_idx"])]),
            t["group_idx"], t["group_present"], sig_x, t["sig_large"],
            t["sig_inf"], t["glv_digits"], t["lane_valid"])


@pytest.mark.slow
def test_stage_scalars_pippenger_matches_reference():
    """The stage against the jitted reference, bit for bit; and the
    staged pipeline around it verifies a valid batch, not a swapped one."""
    import jax
    from teku_tpu.ops import verify as JV
    from tests.torch_parity import as_np
    ins = jax_stage_inputs()
    ref = as_np(jax.jit(JV.stage_scalars_pippenger)(*ins))
    got = V.stage_scalars_pippenger(*fp.from_reference(ins))
    for a, b in zip(ref[0], got[0]):
        np.testing.assert_array_equal(a, b.numpy())
    assert ref[1].tolist() == got[1].tolist()
    for a, b in zip(jax.tree_util.tree_leaves(ref[2]),
                    jax.tree_util.tree_leaves(list(got[2]))):
        np.testing.assert_array_equal(a, b.numpy())
    valid = batch([b"stg-a", b"stg-a", b"stg-b", b"stg-a"])
    swapped = valid[:3] + [(valid[3][0], valid[3][1], valid[0][2])]
    for triples, expect in ((valid, True), (swapped, False)):
        ok, lane_ok = V.verify_staged_pippenger(
            *staged_pipeline_inputs(triples))
        assert bool(ok) is expect and lane_ok.tolist() == [True] * 4


@pytest.mark.slow
def test_jax_provider_on_pippenger_matches_torch(monkeypatch):
    """JaxBls12381 and TorchBls12381 forced onto pippenger, fed the same
    multiplier draws: the same verdicts, the oracle's."""
    from teku_tpu.ops import msm as RM
    from teku_tpu.ops import provider as JP
    draws = RNG.bytes(8 * 64)
    monkeypatch.setattr(JP.secrets, "token_bytes",
                        lambda k: draws[:k])
    prov = TorchBls12381(device="cpu", multipliers=lambda n: np.frombuffer(
        draws[:8 * n], dtype=np.uint64).copy())
    cases = [batch([b"msm-a"] * 4), batch([b"msm-a"] * 4, tamper=2),
             batch([b"msm-a"] * 3 + [b"msm-b"], inf_sig=3)]
    with M.force("pippenger"), RM.force("pippenger"):
        ref = JP.JaxBls12381()
        for triples in cases:
            want = PURE.batch_verify(triples)
            assert ref.batch_verify(triples) is want
            assert prov.batch_verify(triples) is want
        assert ref.msm_dispatches["pippenger"] == len(cases)
    assert prov.msm_dispatches["pippenger"] == len(cases)
