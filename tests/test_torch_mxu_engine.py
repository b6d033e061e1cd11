"""The mma engine of the kernels (row 11) on the host C++ build.

Without a card every kernel source builds as host C++ in both engines:
``cios`` and ``mma``, whose fp_mul / fr_mul take the product columns of
kernels/mma_digits.cuh (the tensor-core tile computed directly, with the
instruction's int32 accumulate).  Word for word, the mma build must
equal the cios build: fp381_ops' products (fp_mont / fr_mont, one a
pair; fp_mul / fr_mul, canonical) on 4096 seeded pairs and the edges,
every kernel of the BLS chain on both scalars paths, the
mesh kernels and the KZG kernels; and TorchBls12381 / TorchKzg built
with ``mont_path="mxu-force"`` must give the oracle's verdicts through
the mma build.  The fragment layout is held against an emulation of the
PTX ISA's mma.m16n8k32 figures (``mma_layout_check``).
"""

import numpy as np
import pytest
import torch

from teku_tpu_torch.crypto import kzg as HK
from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls.constants import P, R
from teku_tpu_torch.crypto.bls.pure_impl import PureBls12381
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops import msm as M
from teku_tpu_torch.ops import mxu
from teku_tpu_torch.ops import kzg as TK
from teku_tpu_torch.ops.kernels import decompress as KD
from teku_tpu_torch.ops.kernels import fp381 as KF
from teku_tpu_torch.ops.kernels import h2c as KH
from teku_tpu_torch.ops.kernels import kzg as KK
from teku_tpu_torch.ops.kernels import msm as KM
from teku_tpu_torch.ops.kernels import pairing as KP
from teku_tpu_torch.ops.kernels import scalars_group as KS
from teku_tpu_torch.ops.kernels import shard as KSH
from teku_tpu_torch.ops.provider import TorchBls12381
from tests.torch_parity import no_aot_store, one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0x11A)
PURE = PureBls12381()
SKS = [int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1 for _ in range(8)]
PKS = [PURE.secret_key_to_public_key(s) for s in SKS]
WRAPPERS = (KD, KH, KM, KP, KS, KSH, KK)


def on_host_build(monkeypatch):
    """Point every wrapper at the host C++ build of its engine, as if its
    tensors lay on the card."""
    real_lib = K.lib
    for mod in WRAPPERS:
        monkeypatch.setattr(mod, "on_card", lambda t: True)
        monkeypatch.setattr(mod, "lib", lambda src, host=False, engine="cios":
                            real_lib(src, host=True, engine=engine))


def host(src, engine):
    return K.lib(src, host=True, engine=engine)


def words(vals, nw):
    return torch.from_numpy(fp.ints_to_words(vals, nw).copy())


def batch(msgs, tamper=None):
    triples = [([PKS[i]], m, PURE.sign(SKS[i], m))
               for i, m in enumerate(msgs)]
    if tamper is not None:
        a, b = tamper
        triples[a] = (triples[a][0], triples[a][1], triples[b][2])
    return triples


def assert_same(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)


def test_products_mma_equal_cios_and_plain():
    """fp_mont and fr_mont (one product a pair: a b R^-1 on words taken
    as Montgomery form), fp_mul and fr_mul (canonical a b): the mma build
    equals the cios build word for word on 4096 seeded pairs plus 0, 1,
    M - 1 and R mod M, and the plain digit product (mont_mul_mxu)
    canonically; the fragment builders of every lane, through the PTX
    figures, give the direct tile's words."""
    for op, modulus, nw in (("fp_mul", P, 12), ("fr_mul", R, 8),
                            ("fp_mont", P, 12), ("fr_mont", R, 8)):
        r_mod = (1 << (32 * nw)) % modulus
        r_inv = pow(r_mod, -1, modulus) if op.endswith("mont") else 1
        edges = [0, 1, modulus - 1, r_mod]
        xs = [int.from_bytes(RNG.bytes(48), "big") % modulus
              for _ in range(4096)] + edges
        ys = [int.from_bytes(RNG.bytes(48), "big") % modulus
              for _ in range(4096)] + edges[::-1]
        a, b = words(xs, nw), words(ys, nw)
        cios = KF._run(host("fp381", "cios"), op, a, b)
        mma = KF._run(host("fp381", "mma"), op, a, b)
        assert torch.equal(cios, mma)
        with K.plain_engine("mma"):
            assert torch.equal(mma, KF.fp381_ops_plain(op, a, b))
        got = [fp.words_to_int(mma[i]) for i in range(4096, 4100)]
        assert got == [x * y * r_inv % modulus
                       for x, y in zip(edges, edges[::-1])]
        assert host("fp381", "mma").mma_layout_check(
            nw, K.ptr(a[:32].contiguous()), K.ptr(b[:32].contiguous())) == 0
    assert mxu.current() == "vpu"


def run_chain(plan, run):
    """The BLS chain's kernels on one plan: {name: (inputs, outputs)},
    run(name, *args) launching one build's entry."""
    d = torch.from_numpy
    t = {k: d(v) for k, v in plan.items() if isinstance(v, np.ndarray)}
    draws = d(plan["hm_plan"][3])
    out = {"h2c": run("h2c", draws[:, 0:2].contiguous(),
                      draws[:, 2:4].contiguous())}
    hm = out["h2c"][:t["group_idx"].shape[0]].contiguous()
    out["prepare"] = run("prepare", *(t[k] for k in (
        "pk_x", "pk_y", "pk_present", "sig_x0", "sig_x1", "sig_large",
        "sig_inf", "lane_valid")))
    pk_jac, sig_jac, _, mmask = out["prepare"]
    scalars, mult = (("scalars_msm", t["glv_digits"])
                     if plan["msm_path"] == "pippenger"
                     else ("scalars_group", t["r"]))
    out[scalars] = run(scalars, pk_jac, sig_jac, mult, mmask,
                       t["group_idx"], t["group_present"])
    agg, u_mask, wsig = out[scalars]
    out["miller"] = run("miller", agg, hm, u_mask)
    out["finish"] = run("finish", out["miller"], wsig)
    # the mesh kernels on the same lanes
    pk_r, wsig_l = run("scalars", pk_jac, sig_jac, t["r"] if "r" in t
                       else torch.ones(pk_jac.shape[0], dtype=torch.int64))
    out["scalars"] = (pk_r, wsig_l)
    out["lane_affine"] = run("lane_affine", pk_r)
    out["gather_hm"] = run("gather_hm", out["h2c"],
                           torch.zeros(2, dtype=torch.int32))
    out["shard_partials"] = run("shard_partials", out["miller"], wsig)
    present = torch.ones(pk_jac.shape[0], dtype=torch.bool)
    present[1] = False
    out["aggregate_points"] = run("aggregate_points", out["lane_affine"],
                                  present)
    return out


RUNS = {"h2c": (KH._run_h2c, "h2c"), "prepare": (KD._run_prepare,
                                                  "decompress"),
        "scalars_group": (KS._run_scalars_group, "scalars_group"),
        "scalars_msm": (KM._run_scalars_msm, "msm"),
        "miller": (KP._run_miller, "pairing"),
        "finish": (KP._run_finish, "pairing"),
        "scalars": (KS._run_scalars, "scalars_group"),
        "lane_affine": (KSH._run_lane_affine, "shard"),
        "gather_hm": (KSH._run_gather_hm, "shard"),
        "shard_partials": (KSH._run_shard_partials, "shard"),
        "aggregate_points": (KSH._run_aggregate_points, "shard")}


def test_provider_on_the_host_mma_build(monkeypatch):
    """TorchBls12381(mont_path="mxu-force") through the wrappers on the
    host mma build: an 8-lane, 2-message batch and its tampered twin get
    the oracle's verdicts, every launch counted as an mma launch; then
    every kernel of the chain (both scalars paths) and of the mesh,
    on the same plan, equals the cios build word for word."""
    on_host_build(monkeypatch)
    prov = TorchBls12381(device="cpu", mont_path="mxu-force")
    assert (prov.mont_path, prov.engine) == ("mxu", "mma")
    valid = batch([b"mma-a"] * 5 + [b"mma-b"] * 3)
    K.reset_launches()
    assert prov.batch_verify(valid) is PURE.batch_verify(valid) is True
    tampered = batch([b"mma-a"] * 5 + [b"mma-b"] * 3, tamper=(2, 6))
    assert prov.batch_verify(tampered) is PURE.batch_verify(tampered) \
        is False
    assert all(v == 0 for v in K.LAUNCHES.values())
    assert all(K.MMA_LAUNCHES[k] == n for k, n in (
        ("g1_validate", 1), ("prepare", 2), ("h2c", 1),
        ("scalars_group", 2), ("miller", 2), ("finish", 2)))
    fresh = TorchBls12381(device="cpu", mont_path="mxu-force")
    semis = [fresh.prepare_batch_verify(t) for t in tampered]
    for path in ("ladder", "pippenger"):
        with M.force(path):
            plan = fresh.plan(semis, randomize=True)
        outs = {e: run_chain(plan, lambda name, *args, e=e: RUNS[name][0](
            host(RUNS[name][1], e), *args)) for e in ("cios", "mma")}
        for name in outs["cios"]:
            assert_same(outs["cios"][name], outs["mma"][name])
        assert not bool(outs["mma"]["finish"][0])


def test_kzg_on_the_host_mma_build(monkeypatch):
    """One blob through TorchKzg(mont_path="mxu-force") on the host mma
    build: the host path's verdicts, valid and with another blob's
    proof; kzg_eval, kzg_fold and an 8-lane kzg_msm equal the cios
    build word for word."""
    on_host_build(monkeypatch)
    setup = HK.insecure_setup()
    rng = np.random.default_rng(0x4844)
    blobs = [b"".join((int.from_bytes(rng.bytes(31), "big") % R).to_bytes(
        32, "big") for _ in range(HK.FIELD_ELEMENTS_PER_BLOB))
        for _ in range(2)]
    cms = [HK.blob_to_kzg_commitment(b, setup) for b in blobs]
    prs = [HK.compute_blob_kzg_proof(b, c, setup) for b, c in zip(blobs, cms)]
    backend = TK.TorchKzg(device="cpu", mont_path="mxu-force")
    monkeypatch.setattr(HK, "_BACKEND", backend)
    K.reset_launches()
    seen = {}
    for name in ("kzg_eval", "kzg_fold"):
        real = getattr(KK, name)

        def keep(*args, name=name, real=real, **kw):
            seen[name] = args
            return real(*args, **kw)
        monkeypatch.setattr(KK, name, keep)
    for pr, expect in ((prs[0], True), (prs[1], False)):
        got = HK.verify_blob_kzg_proof_batch([blobs[0]], [cms[0]], [pr],
                                             setup)
        assert got is HK._verify_batch_host([blobs[0]], [cms[0]], [pr],
                                            setup) is expect
    assert {k: K.MMA_LAUNCHES[k] for k in ("kzg_eval", "kzg_fold")} == \
        {"kzg_eval": 2, "kzg_fold": 2}
    assert all(v == 0 for v in K.LAUNCHES.values())
    for name, run in (("kzg_eval", KK._run_kzg_eval),
                      ("kzg_fold", KK._run_kzg_fold)):
        assert_same(run(host("kzg", "cios"), *seen[name]),
                    run(host("kzg", "mma"), *seen[name]))
    aff = [C.to_affine(C.FQ_OPS, C.point_mul(
        C.FQ_OPS, int.from_bytes(rng.bytes(32), "big") % R, C.G1_GENERATOR))
        for _ in range(8)]
    xs = torch.from_numpy(np.stack([fp.int_to_words(p[0]) for p in aff]))
    ys = torch.from_numpy(np.stack([fp.int_to_words(p[1]) for p in aff]))
    present = torch.tensor([True] * 7 + [False])
    scalars = words([int.from_bytes(rng.bytes(32), "big") % R
                     for _ in range(8)], 8)
    assert_same(KK._run_kzg_msm(host("kzg", "cios"), xs, ys, present,
                                scalars),
                KK._run_kzg_msm(host("kzg", "mma"), xs, ys, present, scalars))


@pytest.mark.slow
def test_plain_mxu_path_matches_jax_provider():
    """The plain CPU path under mxu-force (every product the digit
    product) against JaxBls12381 under the reference's
    mxu.force("mxu-force"), on a 2-lane batch and its tampered twin."""
    from teku_tpu.ops import mxu as JX
    from teku_tpu.ops import provider as JP
    cases = [batch([b"slow-a", b"slow-b"]),
             batch([b"slow-a", b"slow-b"], tamper=(0, 1))]
    with mxu.force("mxu-force"), JX.force("mxu-force"):
        prov = TorchBls12381(device="cpu")
        ref = JP.JaxBls12381()
        assert prov.mont_path == ref.mont_path == "mxu"
        for triples in cases:
            want = PURE.batch_verify(triples)
            assert prov.batch_verify(triples) is want
            assert ref.batch_verify(triples) is want


@pytest.mark.gpu
def test_mma_engine_matches_cios_on_card():
    """On the card: fp381_ops' products of the mma build equal the cios
    build, and an 8-lane batch verifies alike on both engines."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False (and nvcc to build the kernels)")
    dev = torch.device("cuda")
    for op, modulus, nw in (("fp_mul", P, 12), ("fr_mul", R, 8),
                            ("fp_mont", P, 12), ("fr_mont", R, 8)):
        xs = [int.from_bytes(RNG.bytes(48), "big") % modulus
              for _ in range(256)]
        a = words(xs, nw).to(dev)
        b = words(xs[::-1], nw).to(dev)
        assert torch.equal(KF.fp381_ops(op, a, b, engine="cios"),
                           KF.fp381_ops(op, a, b, engine="mma"))
    valid = batch([b"card-a"] * 5 + [b"card-b"] * 3)
    tampered = batch([b"card-a"] * 5 + [b"card-b"] * 3, tamper=(1, 7))
    for path in ("vpu", "mxu-force"):
        prov = TorchBls12381(device=dev, mont_path=path)
        assert prov.batch_verify(valid) is True
        assert prov.batch_verify(tampered) is False
