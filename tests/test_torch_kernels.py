"""The CUDA kernels' sources, their wrappers and their plain versions.

Without a card: the kernel sources (ops/kernels/*.cu) compile as host C++
(each kernel a loop over its per-thread body, the carry flag of the PTX
chains kept in a variable), and every kernel must give its plain
PyTorch version's words exactly on a seeded 2-lane batch.  The wrappers
take the plain version for CPU tensors and check dtype, shape and
contiguity.  With a card (marker ``gpu``): the CUDA build against the
plain version on the card.  The fp381 entry points are tested in
test_torch_fp381.py, the provider on the host build in
test_torch_provider.py.
"""

import numpy as np
import pytest
import torch

from teku_tpu_torch.crypto.bls.constants import R
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops.kernels import decompress as KD
from teku_tpu_torch.ops.kernels import h2c as KH
from teku_tpu_torch.ops.kernels import pairing as KP
from teku_tpu_torch.ops.kernels import scalars_group as KS
from teku_tpu_torch.ops.provider import TorchBls12381
from teku_tpu_torch.crypto.bls.pure_impl import PureBls12381
from tests.torch_parity import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0xC0DA)
RUN = {"g1_validate": (KD._run_g1_validate, "decompress"),
       "prepare": (KD._run_prepare, "decompress"),
       "h2c": (KH._run_h2c, "h2c"),
       "scalars_group": (KS._run_scalars_group, "scalars_group"),
       "miller": (KP._run_miller, "pairing"),
       "finish": (KP._run_finish, "pairing")}
PLAIN = {"g1_validate": KD.g1_validate_plain, "prepare": KD.prepare_plain,
         "h2c": KH.h2c_plain, "scalars_group": KS.scalars_group_plain,
         "miller": KP.miller_plain, "finish": KP.finish_plain}


def stage_inputs():
    """Each kernel's inputs for one seeded 2-lane batch (a 2-key lane and
    a 1-key lane over two messages), chained through the plain versions."""
    pure = PureBls12381()
    sks = [int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1
           for _ in range(3)]
    pks = [pure.secret_key_to_public_key(s) for s in sks]
    triples = [(pks[:2], b"k-0", pure.aggregate_signatures(
        [pure.sign(sks[0], b"k-0"), pure.sign(sks[1], b"k-0")])),
        ([pks[2]], b"k-1", pure.sign(sks[2], b"k-1"))]
    prov = TorchBls12381(device="cpu", min_bucket=2, h2c_min_bucket=2,
                         multipliers=lambda n: RNG.integers(
                             1, 2**63, n, dtype=np.int64).astype(np.uint64))
    plan = prov.plan([prov.prepare_batch_verify(t) for t in triples], True)
    t = torch.from_numpy
    xs = [int.from_bytes(bytes([pk[0] & 0x1F]) + pk[1:], "big") for pk in pks]
    ins = {"g1_validate": (t(np.stack([fp.int_to_words(x) for x in xs])),
                           torch.tensor([bool(pk[0] & 0x20) for pk in pks]))}
    draws = t(plan["hm_plan"][3])
    ins["h2c"] = (draws[:, 0:2].contiguous(), draws[:, 2:4].contiguous())
    hm = KH.h2c_plain(*ins["h2c"])
    ins["prepare"] = tuple(t(plan[k]) for k in (
        "pk_x", "pk_y", "pk_present", "sig_x0", "sig_x1", "sig_large",
        "sig_inf", "lane_valid"))
    pk_jac, sig_jac, _, mmask = KD.prepare_plain(*ins["prepare"])
    ins["scalars_group"] = (pk_jac, sig_jac, t(plan["r"]), mmask,
                            t(plan["group_idx"]), t(plan["group_present"]))
    agg, u_mask, wsig = KS.scalars_group_plain(*ins["scalars_group"])
    ins["miller"] = (agg, hm, u_mask)
    ins["finish"] = (KP.miller_plain(*ins["miller"]), wsig)
    return ins


@pytest.fixture(scope="module")
def inputs():
    return stage_inputs()


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def assert_equal_outputs(a, b):
    for x, y in zip(as_tuple(a), as_tuple(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", sorted(RUN))
def test_kernel_host_build_matches_plain(inputs, name):
    fn, source = RUN[name]
    args = inputs[name]
    assert_equal_outputs(fn(K.lib(source, host=True), *args),
                         PLAIN[name](*args))
    if name == "finish":
        assert PLAIN[name](*args).tolist() == [True]


def test_wrappers_take_plain_version_on_cpu_and_check_inputs(inputs):
    K.reset_launches()
    ok, gx, gy = KD.g1_validate(*inputs["g1_validate"])
    assert ok.tolist() == [True, True, True]
    assert all(v == 0 for v in K.LAUNCHES.values())
    x, large = inputs["g1_validate"]
    with pytest.raises(TypeError):
        KD.g1_validate(x.to(torch.int64), large)
    with pytest.raises(ValueError):
        KD.g1_validate(x[:, :6], large)
    with pytest.raises(ValueError):
        KH.h2c(inputs["h2c"][0].transpose(0, 1), inputs["h2c"][1])
    with pytest.raises(ValueError):
        KP.miller(*inputs["miller"][:2], inputs["miller"][2][:1])


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card(inputs):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False (and nvcc to build the kernels)")
    dev = torch.device("cuda")
    for name, (fn, source) in RUN.items():
        args = tuple(a.to(dev) for a in inputs[name])
        assert_equal_outputs(fn(K.lib(source), *args), PLAIN[name](*args))
