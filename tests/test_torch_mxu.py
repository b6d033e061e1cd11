"""Port parity: the Montgomery engine rule and the plain int8 digit product.

teku_tpu_torch/ops/mxu.py against teku_tpu/ops/mxu.py: the path rule
(the reference's ``_device_is_tpu`` is False on this box, and the port
dispatches to no TPU), its single warning for ``mxu``, and the plain
``mont_mul_mxu`` / ``mont_sqr_mxu`` of the Fq limbs and of Fr
(``make_field``), bit-identical in lazy limbs to the reference's on the
inputs of its own tests (tolerance: exact).  Also the dispatch of
``mont_mul`` by the configured path and by a pinned engine, and the
engine a provider records.
"""

import logging
import random

import numpy as np
import pytest
import torch

from teku_tpu.ops import limbs as JL
from teku_tpu.ops import modfield as JM
from teku_tpu.ops import mxu as JX
from teku_tpu_torch.crypto.bls.constants import P, R
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops import mxu
from teku_tpu_torch.ops.modfield import FR
from tests.torch_parity import no_aot_store, one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def restore_paths():
    """Each test leaves both packages' configured paths as it found them."""
    prev, prev_ref = mxu._state["path"], JX._state["path"]
    yield
    mxu.set_path(prev)
    JX.set_path(prev_ref)


def fq_inputs():
    """tests/test_ops_limbs.py's cross-path inputs: 32 lanes, canonical
    and lazy signed sums of units 2 and 4."""
    prng = random.Random(0xA11CE)
    a = np.stack([np.asarray(JL.int_to_mont(prng.randrange(P)))
                  for _ in range(32)])
    b = np.stack([np.asarray(JL.int_to_mont(prng.randrange(P)))
                  for _ in range(32)])
    lazy_a = a - np.roll(a, 1, axis=0)
    lazy_b = b + np.roll(b, 3, axis=0) - np.roll(a, 5, axis=0) + a
    return a, b, lazy_a, lazy_b


def test_path_rule_matches_reference():
    """resolve() for every configured path equals the reference's off a
    TPU (auto -> vpu, mxu -> vpu, mxu-force -> mxu); force() restores
    the path; an unknown path raises in both packages."""
    assert not JX._device_is_tpu() and not mxu._device_is_tpu()
    assert mxu.PATHS == JX.PATHS
    assert (mxu.DIGIT_BITS, mxu.UNITS_SLACK_BITS) == (JX.DIGIT_BITS,
                                                       JX.UNITS_SLACK_BITS)
    for path in mxu.PATHS:
        mxu.set_path(path)
        JX.set_path(path)
        assert mxu.get_path() == JX.get_path() == path
        assert mxu.resolve() == JX.resolve()
        assert mxu.active() is JX.active()
        assert mxu.resolve(path) == mxu.resolve()
    assert [mxu.resolve(p) for p in ("vpu", "auto", "mxu", "mxu-force")] \
        == ["vpu", "vpu", "vpu", "mxu"]
    mxu.set_path(None)
    assert mxu.get_path() == "auto"
    with mxu.force("mxu-force"):
        assert mxu.get_path() == "mxu-force" and mxu.active()
        with mxu.force("vpu"):
            assert not mxu.active()
        assert mxu.get_path() == "mxu-force"
    assert mxu.get_path() == "auto"
    for bad in ("MXU", "tpu", ""):
        for mod in (mxu, JX):
            with pytest.raises(ValueError):
                mod.set_path(bad)
        with pytest.raises(ValueError):
            mxu.resolve(bad)
        with pytest.raises(ValueError):
            with mxu.force(bad):
                pass
    with pytest.raises(ValueError):
        with mxu.engine("cios"):
            pass


def test_mxu_off_a_tpu_warns_once(caplog):
    """Explicit mxu resolves to vpu with exactly one warning until the
    path is set again, as the reference (tests/test_compile_cache.py);
    the dispatching mont_mul then serves the vpu result."""
    caplog.set_level(logging.WARNING, logger="teku_tpu_torch.ops.mxu")
    mxu.set_path("mxu")
    assert [mxu.resolve() for _ in range(3)] == ["vpu"] * 3
    warns = [r for r in caplog.records
             if "falling back to the vpu path" in r.getMessage()]
    assert len(warns) == 1
    a = torch.from_numpy(np.stack([fp.int_to_mont(v) for v in (5, 7, 11)]))
    out = fp.mont_mul(a, a)
    assert torch.equal(out, fp.mont_mul_vpu(a, a))
    assert [fp.mont_to_int(out[i]) for i in range(3)] == [25, 49, 121]
    mxu.set_path("mxu")                  # a reconfigure may warn again
    mxu.resolve()
    assert len([r for r in caplog.records
                if "falling back" in r.getMessage()]) == 2


def test_fq_digit_product_bit_identical_to_reference():
    """Fq (15 limbs, 4 digit planes): mont_mul_mxu / mont_sqr_mxu equal
    the reference's lazy limbs, canonical and lazy operands (units 2 and
    4), and at the lazy contract's edge (units product 64: a x -32a and
    the square of -8a)."""
    a, b, lazy_a, lazy_b = fq_inputs()
    assert fp.mont_mul_mxu.digits == 4
    for x, y in ((a, b), (lazy_a, lazy_b), (lazy_b, lazy_a), (a, -32 * a),
                 (-32 * a, a)):
        ref = np.asarray(JL.mont_mul_mxu(x, y))
        got = fp.mont_mul_mxu(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_array_equal(ref, got.numpy())
    for x in (lazy_b, -8 * a):
        ref = np.asarray(JL.mont_sqr_mxu(x))
        got = fp.mont_sqr_mxu(torch.from_numpy(x))
        np.testing.assert_array_equal(ref, got.numpy())
    # and the same residues as the limb product
    vpu = fp.mont_mul_vpu(torch.from_numpy(lazy_a), torch.from_numpy(lazy_b))
    mxu_ = fp.mont_mul_mxu(torch.from_numpy(lazy_a),
                           torch.from_numpy(lazy_b))
    assert torch.equal(fp.canonical(vpu), fp.canonical(mxu_))


def test_fr_digit_product_bit_identical_to_reference():
    """Fr (10 limbs, 5 digit planes) against the reference's
    make_field(R, "fr") on 0, 1, R - 1, R - 2 and 12 seeded values, the
    left operand a lazy difference."""
    ref_fr = JM.make_field(R, "fr")
    prng = random.Random(0xF2)
    xs = [0, 1, R - 1, R - 2] + [prng.randrange(R) for _ in range(12)]
    ys = list(reversed(xs))
    a = np.stack([np.asarray(ref_fr.int_to_mont(v)) for v in xs])
    b = np.stack([np.asarray(ref_fr.int_to_mont(v)) for v in ys])
    lazy_a = a - np.roll(b, 2, axis=0)
    assert FR.mont_mul_mxu.digits == 5
    for x, y in ((a, b), (lazy_a, b), (b, lazy_a)):
        ref = np.asarray(ref_fr.mont_mul_mxu(x, y))
        got = FR.mont_mul_mxu(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_array_equal(ref, got.numpy())
    ref = np.asarray(ref_fr.mont_sqr_mxu(lazy_a))
    np.testing.assert_array_equal(ref, FR.mont_sqr_mxu(
        torch.from_numpy(lazy_a)).numpy())
    va = [(x - y2) % R for x, y2 in zip(xs, np.roll(ys, 2).tolist())]
    out = FR.mont_mul_mxu(torch.from_numpy(lazy_a), torch.from_numpy(b))
    assert [FR.mont_to_int(out[i]) for i in range(len(xs))] == \
        [v * y % R for v, y in zip(va, ys)]


def test_mont_mul_routes_by_path_and_pinned_engine():
    """limbs.mont_mul / mont_sqr and FR.mont_mul follow the configured
    path (force("mxu-force") -> the digit product, bit for bit) unless a
    block pins an engine, which wins over the process path."""
    a, b, lazy_a, lazy_b = fq_inputs()
    x, y = torch.from_numpy(lazy_a[:4]), torch.from_numpy(lazy_b[:4])
    fx = torch.from_numpy(np.stack([FR.int_to_mont(v) for v in (3, 5, R - 1)]))
    with mxu.force("mxu-force"):
        assert torch.equal(fp.mont_mul(x, y), fp.mont_mul_mxu(x, y))
        assert torch.equal(fp.mont_sqr(x), fp.mont_sqr_mxu(x))
        assert torch.equal(FR.mont_mul(fx, fx), FR.mont_mul_mxu(fx, fx))
        with mxu.engine("vpu"):
            assert torch.equal(fp.mont_mul(x, y), fp.mont_mul_vpu(x, y))
            assert torch.equal(FR.mont_sqr(fx), FR.mont_sqr_vpu(fx))
        assert mxu.current() == "mxu"
    with mxu.force("vpu"):
        assert torch.equal(fp.mont_mul(x, y), fp.mont_mul_vpu(x, y))
        with K.plain_engine("mma"):
            assert mxu.current() == "mxu"
            assert torch.equal(fp.mont_mul(x, y), fp.mont_mul_mxu(x, y))
        assert mxu.current() == "vpu"
    # the two products agree canonically on every lane
    assert torch.equal(fp.canonical(fp.mont_mul_vpu(x, y)),
                       fp.canonical(fp.mont_mul_mxu(x, y)))


def test_providers_record_the_engine_they_resolved():
    """TorchBls12381, TorchKzg and the mesh verifiers resolve the path
    once, when built: mont_path as the reference records it, the kernel
    engine beside it; a later set_path does not move them.  The mesh's
    launch functions are memoised per engine."""
    from teku_tpu_torch import parallel as PP
    from teku_tpu_torch.ops.kzg import TorchKzg
    from teku_tpu_torch.ops.provider import TorchBls12381
    prov = TorchBls12381(device="cpu")
    assert (prov.mont_path, prov.engine) == ("vpu", "cios")
    with mxu.force("mxu-force"):
        forced = TorchBls12381(device="cpu")
        kzg = TorchKzg(device="cpu")
    assert (forced.mont_path, forced.engine) == ("mxu", "mma")
    assert (kzg.mont_path, kzg.engine) == ("mxu", "mma")
    assert TorchBls12381(device="cpu", mont_path="mxu").mont_path == "vpu"
    assert TorchKzg(device="cpu", mont_path="mxu-force").engine == "mma"
    with pytest.raises(ValueError):
        TorchBls12381(device="cpu", mont_path="fast")
    mesh = PP.make_mesh(devices=["cpu"] * 2, advertise=False)
    cios = PP.GroupShardedVerifier(mesh)
    mma = PP.GroupShardedVerifier(mesh, engine="mma")
    assert cios.kernel_key("ladder") == mma.kernel_key("ladder")
    assert cios.kernel("ladder") is not mma.kernel("ladder")
    assert mma.kernel("ladder") is PP.GroupShardedVerifier(
        mesh, engine="mma").kernel("ladder")
    meshed = TorchBls12381(device="cpu", mesh=mesh, mont_path="mxu-force")
    assert meshed._sharded.engine == "mma"
    assert PP.ShardedVerifier(mesh).engine == "cios"
    with mxu.force("mxu-force"):
        assert PP.ShardedVerifier(mesh).engine == "mma"
