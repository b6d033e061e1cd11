"""Port parity: KZG blob verification (teku_tpu_torch/ops/kzg.py TorchKzg,
kernels/kzg.cu and its plain programs) vs teku_tpu/ops/kzg.py and the
host path of crypto/kzg.

- The host helpers equal the reference's.
- The plain barycentric evaluation equals eval_blob_kernel (eager, B = 1,
  as tests/test_ops_kzg.py calls it) at a random z and at a root.
- TorchKzg(device="cpu") gives JaxKzg's verify_kzg_proof verdicts at the
  reference's 8-lane fold and validate shapes.
- The host C++ build of kzg.cu equals each plain version word for word;
  the plain msm equals the reference's host Pippenger g1_msm.
- A 2-blob batch on the host build, installed behind the port's
  crypto/kzg facade, agrees with the host path.
- The setup conversion gives TorchKzg JaxKzg's setup constants, and
  g1_lincomb on the host build equals the host Pippenger.

Tolerance: exact, on canonical values or words.  JAX runs only at the
shapes tests/test_ops_kzg.py's tier-1 tests use; the AOT store is off
per test (tests/torch_parity.py).
"""

import numpy as np
import pytest
import torch

from teku_tpu.crypto import kzg as RHK
from teku_tpu.ops import kzg as RK
from teku_tpu_torch.crypto import kzg as HK
from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls.constants import R
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import kzg as TK
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops.kernels import decompress as KD
from teku_tpu_torch.ops.kernels import kzg as KK
from teku_tpu_torch.ops.modfield import FR
from tests.torch_parity import no_aot_store, one_torch_thread  # noqa: F401

N = HK.FIELD_ELEMENTS_PER_BLOB
SETUP = HK.insecure_setup()
REF_SETUP = RHK.insecure_setup()


def rand_blob(seed):
    rng = np.random.default_rng(seed)
    return b"".join((int.from_bytes(rng.bytes(31), "big") % R).to_bytes(
        32, "big") for _ in range(N))


def rand_g1_affine(rng, n):
    return [C.to_affine(C.FQ_OPS, C.point_mul(
        C.FQ_OPS, int.from_bytes(rng.bytes(32), "big") % R, C.G1_GENERATOR))
        for _ in range(n)]


def g1_words(points):
    return (torch.from_numpy(np.stack([fp.int_to_words(p[0]) for p in points])),
            torch.from_numpy(np.stack([fp.int_to_words(p[1]) for p in points])))


def on_host_build(monkeypatch):
    """Point the KZG wrappers at the host C++ build, as if on the card."""
    real_lib = K.lib
    for mod in (KD, KK):
        monkeypatch.setattr(mod, "on_card", lambda t: True)
        monkeypatch.setattr(mod, "lib",
                            lambda src, host=False: real_lib(src, host=True))


def test_host_helpers_match_reference():
    blobs = [rand_blob(1), bytes(HK.BYTES_PER_BLOB)]
    limbs = TK.blob_bytes_to_limbs(blobs)
    np.testing.assert_array_equal(limbs, RK.blob_bytes_to_limbs(blobs))
    bad = b"".join(v.to_bytes(32, "big") for v in [0] * (N - 2) + [R, R - 1])
    for blob in blobs + [bad]:
        lm = TK.blob_bytes_to_limbs([blob])
        np.testing.assert_array_equal(TK.limbs_lt_modulus(lm),
                                      RK.limbs_lt_modulus(lm))
    assert not TK.limbs_lt_modulus(TK.blob_bytes_to_limbs([bad])).all()
    vals = [0, 1, R - 1, 2**254 + 12345]
    np.testing.assert_array_equal(TK.int_to_bits(vals), RK.int_to_bits(vals))
    np.testing.assert_array_equal(TK.int_to_bits(vals[:2] + [2**64 - 1], 64),
                                  RK.int_to_bits(vals[:2] + [2**64 - 1], 64))
    assert HK.roots_of_unity() == RHK.roots_of_unity()
    cm = RHK.blob_to_kzg_commitment(blobs[0], REF_SETUP)
    assert HK.blob_to_kzg_commitment(blobs[0], SETUP) == cm
    assert HK.compute_challenge(blobs[0], cm) == RHK.compute_challenge(
        blobs[0], cm)
    # the blob's words, as TorchKzg builds them, are its field elements
    words = fp.bytes_to_words_np(np.frombuffer(blobs[0], np.uint8)
                                 .reshape(N, 32))
    assert [fp.words_to_int(w) for w in words[:5]] == \
        HK.blob_to_polynomial(blobs[0])[:5]


def test_plain_eval_matches_reference():
    blob = rand_blob(9)
    poly = HK.blob_to_polynomial(blob)
    limbs = RK.blob_bytes_to_limbs([blob])
    roots = torch.from_numpy(np.stack([FR.int_to_mont(w)
                                       for w in HK.roots_of_unity()]))
    z_rand = int.from_bytes(np.random.default_rng(4).bytes(32), "big") % R
    for z in (z_rand, HK.roots_of_unity()[17]):
        z_mont = FR.int_to_mont(z)[None]
        ref = np.asarray(RK.eval_blob_kernel(limbs, z_mont))
        got = KK.eval_blob(torch.from_numpy(limbs), torch.from_numpy(z_mont),
                           roots)
        np.testing.assert_array_equal(ref, got.numpy())
        assert FR.limbs_to_int(got[0]) == \
            HK.evaluate_polynomial_in_evaluation_form(poly, z)
    assert FR.limbs_to_int(got[0]) == poly[17]


def test_torch_kzg_verdicts_match_jaxkzg():
    blob = rand_blob(11)
    poly = HK.blob_to_polynomial(blob)
    z = 0x1234567890ABCDEF1234567890ABCDEF
    proof, y = HK.compute_kzg_proof_impl(poly, z, SETUP)
    cm = HK.blob_to_kzg_commitment(blob, SETUP)
    port, ref = TK.TorchKzg(device="cpu"), RK.JaxKzg()
    for yy in (y, (y + 1) % R):
        got = port.verify_kzg_proof(cm, z, yy, proof, SETUP)
        assert got is ref.verify_kzg_proof(cm, z, yy, proof, REF_SETUP)
        assert got is (yy == y)
    assert port.dispatch_count == 2


def kernel_case(name):
    """(library entry, plain version, args) for one kernel on a grid of
    edge cases."""
    rng = np.random.default_rng(0x4A6 + len(name))
    if name == "kzg_eval":
        # a random blob at a random z and at a root; the zero blob
        blob = rand_blob(3)
        poly = fp.bytes_to_words_np(np.frombuffer(
            blob + bytes(HK.BYTES_PER_BLOB) + blob, np.uint8).reshape(-1, 32))
        roots = HK.roots_of_unity()
        z = TK.fr_words([int.from_bytes(rng.bytes(32), "big") % R,
                         12345, roots[4000]])
        args = (torch.from_numpy(poly.reshape(3, N, 8)), torch.from_numpy(z),
                torch.from_numpy(TK.fr_words(roots)))
        return KK._run_kzg_eval, KK.kzg_eval_plain, args
    pts = rand_g1_affine(rng, 8)
    xs, ys = g1_words(pts)
    scalars = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(8)]
    if name == "kzg_msm":
        # absent points and zero scalars
        present = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.bool)
        scalars[1] = scalars[4] = 0
        args = (xs, ys, present, torch.from_numpy(TK.fr_words(scalars)))
        return KK._run_kzg_msm, KK.kzg_msm_plain, args
    # fold: an infinity lane, padding lanes, both groups
    inf = torch.tensor([0, 0, 1, 0, 0, 0, 0, 0], dtype=torch.bool)
    valid = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.bool)
    group_b = torch.tensor([0, 1, 0, 0, 1, 0, 1, 0], dtype=torch.bool)
    g2 = TK.TorchKzg(device="cpu")._g2_consts(SETUP)
    args = (xs, ys, inf, valid, group_b,
            torch.from_numpy(TK.fr_words(scalars)), g2)
    return KK._run_kzg_fold, KK.kzg_fold_plain, args


@pytest.mark.parametrize("name", ["kzg_eval", "kzg_fold", "kzg_msm"])
def test_kernel_host_build_matches_plain(name):
    run, plain, args = kernel_case(name)
    got = run(K.lib("kzg", host=True), *args)
    want = plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    if name == "kzg_eval":
        blob = HK.blob_to_polynomial(rand_blob(3))
        zs = [fp.words_to_int(z) for z in args[1]]
        assert [fp.words_to_int(y) for y in got] == [
            HK.evaluate_polynomial_in_evaluation_form(blob, zs[0]), 0,
            blob[4000]]
    elif name == "kzg_fold":
        assert got[0].tolist() == [False] and got[2].tolist() == [False,
                                                                   False]
    else:
        # the reference's host Pippenger on the same points and scalars
        xs, ys, present, sc = args
        pts = [(fp.words_to_int(x), fp.words_to_int(y), 1) if p
               else C.infinity(C.FQ_OPS) for x, y, p in zip(xs, ys, present)]
        ref = C.to_affine(C.FQ_OPS, RHK.g1_msm(
            pts, [fp.words_to_int(s) for s in sc]))
        assert (fp.words_to_int(want[1][0]),
                fp.words_to_int(want[1][1])) == ref
        assert want[0].tolist() == [False]
        inf, xy = plain(xs, ys, torch.zeros(8, dtype=torch.bool), sc)
        assert inf.tolist() == [True] and not xy.any()


def test_batch_on_host_build_matches_host_path(monkeypatch):
    on_host_build(monkeypatch)
    blobs = [rand_blob(20), rand_blob(21)]
    cms = [HK.blob_to_kzg_commitment(b, SETUP) for b in blobs]
    prs = [HK.compute_blob_kzg_proof(b, c, SETUP) for b, c in zip(blobs, cms)]
    out_of_range = bytearray(blobs[1])
    out_of_range[-32:] = R.to_bytes(32, "big")
    cases = [(blobs, cms, prs, True), (blobs, cms, prs[::-1], False),
             (blobs, [b"\x00" * 48, cms[1]], prs, False),
             ([blobs[0], bytes(out_of_range)], cms, prs, False)]
    backend = TK.TorchKzg(device="cpu")
    K.reset_launches()
    monkeypatch.setattr(HK, "_BACKEND", backend)
    for bl, cm, pr, expect in cases:
        got = HK.verify_blob_kzg_proof_batch(bl, cm, pr, SETUP)
        assert got is HK._verify_batch_host(bl, cm, pr, SETUP) is expect
        assert got is RHK._verify_batch_host(bl, cm, pr, REF_SETUP)
    assert HK.verify_blob_kzg_proof(blobs[1], cms[1], prs[1], SETUP) is True
    # eval + fold for the two well-formed batches and the single blob; the
    # malformed and out-of-range inputs stop on the host; one validation
    assert backend.dispatch_count == 6
    assert {k: K.LAUNCHES[k] for k in ("g1_validate", "kzg_eval", "kzg_fold")
            } == {"g1_validate": 1, "kzg_eval": 3, "kzg_fold": 3}
    # the zero blob's infinity commitment verifies on the device path
    zero = bytes(HK.BYTES_PER_BLOB)
    zc = HK.blob_to_kzg_commitment(zero, SETUP)
    assert zc == TK.G1_INF
    assert backend.verify_blob_kzg_proof_batch(
        [zero], [zc], [HK.compute_blob_kzg_proof(zero, zc, SETUP)], SETUP)


def test_setup_conversion_and_g1_lincomb(monkeypatch):
    rng = np.random.default_rng(0x5E7)
    ref = RHK.TrustedSetup(
        g1_lagrange=[C.point_mul(C.FQ_OPS, int.from_bytes(rng.bytes(32), "big")
                                 % R, C.G1_GENERATOR) for _ in range(6)]
        + [C.infinity(C.FQ_OPS)],
        g2_monomial=list(REF_SETUP.g2_monomial))
    port = HK.from_reference_setup(ref)
    assert isinstance(port, HK.TrustedSetup) and port.tau is None
    assert port.g1_lagrange == ref.g1_lagrange
    jk, tk = RK.JaxKzg(), TK.TorchKzg(device="cpu")
    g2 = tk._g2_consts(port)
    for k, arr in enumerate(jk._g2_consts(ref)):         # x0, x1, y0, y1
        want = [fp.mont_to_int(v) for v in np.asarray(arr)]
        assert [fp.words_to_int(w) for w in g2[:, k // 2, k % 2]] == want
    rx, ry, rp = jk._lagrange_arrays(ref)
    xs, ys, present = tk._lagrange_arrays(port)
    np.testing.assert_array_equal(present.numpy(), rp)
    assert present.sum() == 6
    for i in np.flatnonzero(rp):
        assert fp.words_to_int(xs[i]) == fp.mont_to_int(rx[i])
        assert fp.words_to_int(ys[i]) == fp.mont_to_int(ry[i])
    assert tk._lagrange_arrays(port)[0] is xs          # cached per setup
    with pytest.raises(HK.KzgError):
        tk._lagrange_arrays(SETUP)
    # g1_lincomb on the host build over an 8-point basis (7 points and an
    # absent one) against the host Pippenger; all-zero scalars -> infinity
    on_host_build(monkeypatch)
    monkeypatch.setattr(TK, "_N", 8)
    small = HK.TrustedSetup(g1_lagrange=port.g1_lagrange + [port.g1_lagrange[0]],
                            g2_monomial=port.g2_monomial)
    tk = TK.TorchKzg(device="cpu")
    scalars = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(8)]
    assert tk.g1_lincomb(small, scalars) == C.g1_compress(
        HK.g1_msm(small.g1_lagrange, scalars))
    assert tk.g1_lincomb(small, [0] * 8) == TK.G1_INF
    assert tk.dispatch_count == 2
    with pytest.raises(HK.KzgError):
        tk.g1_lincomb(small, scalars[:7])
