"""The mesh dispatch end to end on a CPU mesh.

``TorchBls12381(device="cpu", mesh=make_mesh(devices=["cpu"] * n))``
through the kernel wrappers, pointed at the host C++ build of the kernel
sources as tests/test_torch_provider.py does: on a grid of valid, one
tampered lane, an infinity signature, a signature off the curve, a
committee split across the group cap and a batch that leaves shards
empty, on both scalars paths, the verdicts equal the oracle's and the
single-device dispatch's, lane_ok comes back in the caller's lane order,
and the h2c and dedup counters do not depend on the mesh.  The legacy
``ShardedVerifier`` on the port's own copy of __graft_entry__.py's
``_example_batch_hm``.  Three small batches through the plain versions.
Marked slow: the port against the reference's verify_kernel_sharded_grouped
(through JaxBls12381(mesh=...)) and verify_kernel_sharded on the
8-virtual-device CPU mesh, at the reference tests' shapes.  Verdicts and
lane flags are compared exactly.
"""

import numpy as np
import pytest
import torch

from teku_tpu_torch import parallel as PP
from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls import hash_to_curve as OH
from teku_tpu_torch.crypto.bls.pure_impl import (G2_INFINITY, PureBls12381,
                                                 keygen)
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops import msm
from teku_tpu_torch.ops.kernels import decompress as KD
from teku_tpu_torch.ops.kernels import h2c as KH
from teku_tpu_torch.ops.kernels import msm as KM
from teku_tpu_torch.ops.kernels import pairing as KP
from teku_tpu_torch.ops.kernels import scalars_group as KS
from teku_tpu_torch.ops.kernels import shard as KSH
from teku_tpu_torch.ops.provider import TorchBls12381, parse_g2_wire
from tests.torch_parity import no_aot_store, one_torch_thread  # noqa: F401


@pytest.fixture
def host_build(monkeypatch):
    """Every kernel wrapper launches the host C++ build of its source."""
    real_lib = K.lib
    for mod in (KD, KH, KP, KS, KM, KSH):
        monkeypatch.setattr(mod, "on_card", lambda t: True)
        monkeypatch.setattr(mod, "lib",
                            lambda src, host=False: real_lib(src, host=True))


@pytest.fixture(scope="module")
def keys():
    pure = PureBls12381()
    sks = [keygen(bytes([61 + i]) * 32) for i in range(6)]
    return pure, sks, [pure.secret_key_to_public_key(s) for s in sks]


@pytest.fixture(scope="module")
def grid(keys):
    """{case: (triples, the oracle's verdict)}.  With a group cap of 2,
    m0's three lanes split over two rows; the two-lane batch leaves two
    of four shards empty."""
    pure, sks, pks = keys
    msgs = [b"m0", b"m0", b"m0", b"m1", b"m1", b"m2"]
    base = [([pks[i]], m, pure.sign(sks[i], m)) for i, m in enumerate(msgs)]
    tampered = list(base)
    tampered[4] = (base[4][0], base[4][1], pure.sign(sks[4], b"other"))
    infinity = list(base)
    infinity[1] = (base[1][0], base[1][1], G2_INFINITY)
    off_curve = list(base)
    off_curve[3] = (base[3][0], base[3][1],
                    base[3][2][:95] + bytes([base[3][2][95] ^ 1]))
    cases = {"valid": base, "tampered lane": tampered,
             "infinity signature": infinity, "off-curve signature": off_curve,
             "empty shards": [base[0], base[5]]}
    return {name: (t, pure.batch_verify(t)) for name, t in cases.items()}


@pytest.mark.parametrize("path", ["ladder", "pippenger"])
def test_mesh_grid_matches_oracle_and_single_device(host_build, grid, path):
    mesh = PP.make_mesh(devices=["cpu"] * 4, advertise=False)
    with msm.force(path):
        meshed = TorchBls12381(device="cpu", mesh=mesh, group_cap=2)
        single = TorchBls12381(device="cpu", group_cap=2)
        assert meshed.mesh_info == {"devices": ["cpu"] * 4, "n_devices": 4,
                                    "axis": "dp"}
        assert meshed.min_bucket == 4 and meshed.device.type == "cpu"
        scalars = {"ladder": "scalars_group", "pippenger": "scalars_msm"}[path]
        handles = {}
        for name, (triples, want) in grid.items():
            K.reset_launches()
            got = meshed.begin_batch_verify(triples)
            assert got.result() is want, name
            assert [K.LAUNCHES[k] for k in ("gather_hm", scalars,
                                            "shard_partials", "finish")] \
                == [1, 4, 4, 1], name
            ref = single.begin_batch_verify(triples)
            assert ref.result() is want, name
            np.testing.assert_array_equal(got.lane_ok(), ref.lane_ok())
            handles[name] = got
        # the shard layout permutes lanes; lane_ok() un-permutes them
        semis = [meshed.prepare_batch_verify(t) for t in grid["valid"][0]]
        plan = meshed.plan(semis, randomize=True)
        assert (plan["lane_pos"] != np.arange(6)).any()
        assert plan["group_idx"].shape == (8, 2)
    assert [want for _, want in grid.values()] == [True, False, False, False,
                                                   True]
    assert handles["off-curve signature"].lane_ok().tolist() == \
        [True] * 3 + [False, True, True]
    for counter in ("dispatch_count", "h2c_dispatch_count", "h2c_lanes",
                    "h2c_unique", "msm_dispatches"):
        assert getattr(meshed, counter) == getattr(single, counter), counter
    assert meshed.msm_dispatches[path] == len(grid)


def test_out_of_range_h2c_row_raises(host_build, grid):
    prov = TorchBls12381(device="cpu", group_cap=2,
                         mesh=PP.make_mesh(devices=["cpu"] * 2,
                                           advertise=False))
    triples = grid["valid"][0]
    plan = prov.plan([prov.prepare_batch_verify(t) for t in triples], True)
    plan["row_gather"] = plan["row_gather"].copy()
    plan["row_gather"][1] = 8
    with pytest.raises(RuntimeError, match="out of range"):
        prov.launch(plan).result()
    # the SPI's single verifications go through the mesh too
    (pk,), msg, sig = triples[0]
    assert prov.verify(pk, msg, sig) is True
    assert prov.verify(pk, b"m1", sig) is False


def example_batch_hm(n_lanes: int):
    """The port's copy of __graft_entry__.py:_example_batch_hm: n lanes
    cycling over min(n, 8) messages, one key each, per-lane H(m), r from
    numpy's generator with seed 7 -- in the kernels' word layout, in
    ShardedVerifier.KEYS order."""
    pure = PureBls12381()
    uniq = min(n_lanes, 8)
    sks = [keygen(bytes([i + 1]) * 32) for i in range(uniq)]
    msgs = [b"graft-entry-%d" % i for i in range(uniq)]
    sigs = [pure.sign(sk, m) for sk, m in zip(sks, msgs)]
    pks = [C.to_affine(C.FQ_OPS, C.point_mul(C.FQ_OPS, sk, C.G1_GENERATOR))
           for sk in sks]
    hms = [C.to_affine(C.FQ2_OPS, OH.hash_to_g2(m)) for m in msgs]
    rng = np.random.default_rng(7)
    w = fp.int_to_words
    pk_x = np.zeros((n_lanes, 1, 12), dtype=np.int32)
    pk_y = np.zeros((n_lanes, 1, 12), dtype=np.int32)
    hm = np.zeros((n_lanes, 2, 2, 12), dtype=np.int32)
    sig_bytes = np.zeros((n_lanes, 2, 48), dtype=np.uint8)
    s_large = np.zeros(n_lanes, dtype=bool)
    s_inf = np.zeros(n_lanes, dtype=bool)
    rs = np.zeros(n_lanes, dtype=np.uint64)
    for i in range(n_lanes):
        j = i % uniq
        pk_x[i, 0], pk_y[i, 0] = w(pks[j][0]), w(pks[j][1])
        hm[i] = [[w(c) for c in hms[j][0]], [w(c) for c in hms[j][1]]]
        sig_bytes[i], s_large[i], s_inf[i] = parse_g2_wire(sigs[j])
        rs[i] = rng.integers(1, 2 ** 63, dtype=np.uint64)
    t = torch.from_numpy
    return (t(pk_x), t(pk_y), torch.ones((n_lanes, 1), dtype=torch.bool),
            t(hm), t(fp.bytes_to_words_np(sig_bytes[:, 1])),
            t(fp.bytes_to_words_np(sig_bytes[:, 0])), t(s_large), t(s_inf),
            t(rs.view(np.int64)), torch.ones(n_lanes, dtype=torch.bool))


def tamper_hm(args, lane: int, source: int):
    """Lane `lane`'s H(m) replaced by lane `source`'s (the reference
    test's tamper): the lanes still parse, the pairing fails."""
    hm = args[3].clone()
    hm[lane] = hm[source]
    return args[:3] + (hm,) + args[4:]


def test_sharded_verifier_on_example_batch(host_build):
    args = example_batch_hm(8)
    for n in (2, 8):
        sharded = PP.ShardedVerifier(PP.make_mesh(devices=["cpu"] * n,
                                                  advertise=False))
        K.reset_launches()
        ok, lane_ok = sharded(*args)
        assert ok.tolist() == [True] and lane_ok.all()
        assert K.LAUNCHES["scalars"] == K.LAUNCHES["lane_affine"] == n
        assert K.LAUNCHES["shard_partials"] == n
        assert K.LAUNCHES["finish"] == 1 and K.LAUNCHES["scalars_group"] == 0
        ok, lane_ok = sharded(*tamper_hm(args, 3, 4))
        assert ok.tolist() == [False] and lane_ok.all()
    with pytest.raises(ValueError, match="split"):
        PP.ShardedVerifier(PP.make_mesh(devices=["cpu"] * 8,
                                        advertise=False))(
            *(a[:4] for a in args))


def plan_shards(plan, n: int):
    """A mesh dispatch plan (words) -> the per-shard limb inputs of
    ops/verify.py:verify_sharded_grouped, H(m) from the plain h2c."""
    from teku_tpu_torch.ops import points as PT
    from teku_tpu_torch.ops import verify as V
    t = {k: torch.from_numpy(v) for k, v in plan.items()
         if isinstance(v, np.ndarray)}
    draws = fp.from_words(torch.from_numpy(plan["hm_plan"][3]))
    hm = V.stage_h2c((draws[:, 0], draws[:, 1]), (draws[:, 2], draws[:, 3]))
    hm_rows = V.stage_gather_hm(hm, t["row_gather"])
    scalars = PT.scalar_from_uint64(t["r"])
    return V.split_shards((
        fp.from_words(t["pk_x"]), fp.from_words(t["pk_y"]), t["pk_present"],
        hm_rows, t["group_idx"], t["group_present"],
        (fp.plain_limbs_from_words(t["sig_x0"]),
         fp.plain_limbs_from_words(t["sig_x1"])),
        t["sig_large"], t["sig_inf"], scalars, t["lane_valid"]), n)


def test_mesh_plain_versions_end_to_end(keys):
    """Three 4-lane batches through the plain versions (no host build):
    the mesh provider (kernel wrappers' plain versions), the limb-level
    verify_sharded_grouped on a tampered batch's shard layout, and the
    legacy ShardedVerifier."""
    from teku_tpu_torch.ops import verify as V
    pure, sks, pks = keys
    msgs = [b"p0", b"p0", b"p1", b"p2"]
    triples = [([pks[i]], m, pure.sign(sks[i], m)) for i, m in enumerate(msgs)]
    mesh = PP.make_mesh(devices=["cpu"] * 2, advertise=False)
    K.reset_launches()
    prov = TorchBls12381(device="cpu", mesh=mesh)
    assert prov.batch_verify(triples) is True
    swapped = triples[:2] + [triples[2][:2] + (triples[3][2],), triples[3]]
    fresh = TorchBls12381(device="cpu", mesh=mesh)    # H(m) arena cold
    with msm.force("ladder"):
        plan = fresh.plan([fresh.prepare_batch_verify(t) for t in swapped],
                          randomize=True)
    ok, lane_ok = V.verify_sharded_grouped(plan_shards(plan, 2))
    assert bool(ok) is pure.batch_verify(swapped) is False
    assert lane_ok.tolist() == [True] * 4
    ok, lane_ok = PP.ShardedVerifier(mesh)(*example_batch_hm(4))
    assert ok.tolist() == [True] and lane_ok.tolist() == [True] * 4
    assert all(v == 0 for v in K.LAUNCHES.values())


# --------------------------------------------------------------------------
# Against the reference's mesh programs (8 virtual CPU devices)
# --------------------------------------------------------------------------

# the lane -> message map of tests/test_mesh_grouped.py's grid: 16 lanes
# over 8 messages, 32 lanes x kmax 1, 8 rows x group 4 over 8 shards
U_MAP = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 5, 6, 7]


@pytest.mark.slow
def test_grouped_mesh_matches_reference(host_build):
    import jax
    from teku_tpu import parallel as RP
    from teku_tpu.ops.provider import JaxBls12381
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (see conftest XLA_FLAGS)")
    pure = PureBls12381()
    sks = [keygen(bytes([31 + i]) * 32) for i in range(8)]
    pks = [pure.secret_key_to_public_key(sk) for sk in sks]
    msgs = [b"torch-grid-%d" % u for u in range(8)]
    base = [([pks[lane % 8]], msgs[U_MAP[lane]],
             pure.sign(sks[lane % 8], msgs[U_MAP[lane]]))
            for lane in range(16)]
    tampered = list(base)
    tampered[10] = (base[10][0], b"tampered-msg", base[10][2])
    inf_sig = list(base)
    inf_sig[12] = (base[12][0], base[12][1], G2_INFINITY)
    cases = {"valid": base, "tamper_msg": tampered, "infinity_sig": inf_sig,
             "padding_13": base[:13]}
    ref = JaxBls12381(mesh=RP.make_mesh(8), min_bucket=8)
    port = TorchBls12381(device="cpu", min_bucket=8,
                         mesh=PP.make_mesh(devices=["cpu"] * 8))
    for name, triples in cases.items():
        want = ref.batch_verify(triples)
        assert port.batch_verify(triples) is want, name
        assert want is (name in ("valid", "padding_13")), name
    assert port.h2c_dispatch_count == ref.h2c_dispatch_count


@pytest.mark.slow
def test_sharded_kernel_matches_reference(host_build):
    import jax
    from jax.sharding import Mesh

    import __graft_entry__ as ge
    from teku_tpu.ops import verify as JV
    from teku_tpu_torch.ops import points as PT
    from teku_tpu_torch.ops import verify as V
    from teku_tpu_torch.ops.kernels.decompress import g2_to_words
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (see conftest XLA_FLAGS)")
    ref_args = ge._example_batch_hm(8)
    args = example_batch_hm(8)
    # the port's copy holds the reference's batch
    t = fp.from_reference
    assert torch.equal(args[0][:, 0], fp.to_words(t(ref_args[0])[:, 0]))
    assert torch.equal(args[1][:, 0], fp.to_words(t(ref_args[1])[:, 0]))
    assert torch.equal(args[3], g2_to_words(t(ref_args[3])))
    for got, plain in zip(args[4:6], ref_args[4]):
        assert torch.equal(got, fp.words_i32(fp.limbs_to_words(t(plain))))
    np.testing.assert_array_equal(
        PT.scalar_from_uint64(args[8]).numpy(), ref_args[7])
    tampered = list(ref_args)
    (hx0, hx1), (hy0, hy1) = ref_args[3]
    hx0, hx1, hy0, hy1 = hx0.copy(), hx1.copy(), hy0.copy(), hy1.copy()
    for a in (hx0, hx1, hy0, hy1):
        a[3] = a[4]
    tampered[3] = ((hx0, hx1), (hy0, hy1))
    sharded = PP.ShardedVerifier(PP.make_mesh(devices=["cpu"] * 8))
    with Mesh(np.array(jax.devices()[:8]), ("dp",)) as mesh:
        fn = jax.jit(JV.verify_kernel_sharded(mesh, "dp"))
        for ra, pa in ((ref_args, args), (tampered, tamper_hm(args, 3, 4))):
            ok, lane_ok = fn(*ra)
            got_ok, got_lane_ok = sharded(*pa)
            assert got_ok.tolist() == [bool(np.asarray(ok))]
            assert got_lane_ok.tolist() == np.asarray(lane_ok).tolist()
            # the limb-level plain forms, on the reference's own inputs:
            # sharded, and the unsharded per-lane pipeline
            for plain_ok, plain_lane_ok in (
                    V.verify_sharded(V.split_shards(t(ra), 8)),
                    V.verify_staged_hm(*t(ra))):
                assert bool(plain_ok) is bool(np.asarray(ok))
                assert plain_lane_ok.tolist() == \
                    np.asarray(lane_ok).tolist()
