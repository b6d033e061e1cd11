"""TorchBls12381 through the kernel wrappers on the host C++ build.

Without a card the kernel sources compile as host C++, and the wrappers
are pointed at that build as if their tensors lay on the card: the SPI
entry points, group rows split at the cap and the H(m) arena must give
the oracle's verdicts, with every kernel's launch counted.  Also: the
port imports neither jax nor the JAX package.
"""

import numpy as np

from teku_tpu_torch.crypto.bls.constants import R
from teku_tpu_torch.crypto.bls.pure_impl import PureBls12381
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops.kernels import decompress as KD
from teku_tpu_torch.ops.kernels import h2c as KH
from teku_tpu_torch.ops.kernels import pairing as KP
from teku_tpu_torch.ops.kernels import scalars_group as KS
from teku_tpu_torch.ops.provider import TorchBls12381
from tests.torch_parity import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0xA91)


def test_provider_api_on_the_host_build(monkeypatch):
    """The SPI entry points through the kernel wrappers, with the host
    C++ build standing in for the CUDA one (each wrapper counts its
    launch), against the oracle's verdicts."""
    real_lib = K.lib
    for mod in (KD, KH, KP, KS):
        monkeypatch.setattr(mod, "on_card", lambda t: True)
        monkeypatch.setattr(mod, "lib",
                            lambda src, host=False: real_lib(src, host=True))
    pure = PureBls12381()
    sks = [int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1
           for _ in range(3)]
    pks = [pure.secret_key_to_public_key(s) for s in sks]
    sigs = [pure.sign(s, b"api-%d" % i) for i, s in enumerate(sks)]
    prov = TorchBls12381(device="cpu")
    K.reset_launches()
    assert prov.verify(pks[0], b"api-0", sigs[0]) is True
    assert prov.verify(pks[0], b"api-1", sigs[0]) is False
    agg = pure.aggregate_signatures([pure.sign(s, b"all") for s in sks])
    assert prov.fast_aggregate_verify(pks, b"all", agg) is True
    assert prov.fast_aggregate_verify(pks[:2], b"all", agg) is False
    msgs = [b"api-0", b"api-1", b"api-2"]
    agg_multi = pure.aggregate_signatures(sigs)
    assert prov.aggregate_verify(pks, msgs, agg_multi) is True
    assert prov.aggregate_verify(pks, msgs[::-1], agg_multi) is False
    triples = [([pks[i]], msgs[i], sigs[i]) for i in range(3)]
    assert prov.batch_verify(triples) is pure.batch_verify(triples) is True
    assert prov.begin_batch_verify(triples[:2] + [triples[0]]).result() is True
    assert all(K.LAUNCHES[k] > 0 for k in (
        "g1_validate", "prepare", "h2c", "scalars_group", "miller", "finish"))


def test_group_split_and_h2c_arena_on_the_host_build(monkeypatch):
    """Rows split at the group cap, the H(m) arena's hits, evictions and
    over-capacity bypass, through the wrappers on the host C++ build."""
    real_lib = K.lib
    for mod in (KD, KH, KP, KS):
        monkeypatch.setattr(mod, "on_card", lambda t: True)
        monkeypatch.setattr(mod, "lib",
                            lambda src, host=False: real_lib(src, host=True))
    pure = PureBls12381()
    sks = [int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1
           for _ in range(5)]
    pks = [pure.secret_key_to_public_key(s) for s in sks]

    def batch(msgs):
        return [([pks[i]], m, pure.sign(sks[i], m)) for i, m in enumerate(msgs)]
    prov = TorchBls12381(device="cpu", group_cap=2, h2c_cache_capacity=4)
    split = batch([b"c"] * 5)                  # rows of 2, 2, 1
    assert prov.batch_verify(split) is True
    swapped = split[:4] + [(split[4][0], b"c", split[0][2])]
    assert prov.batch_verify(swapped) is False
    assert prov.h2c_dispatch_count == 1        # second batch: arena hits
    for msgs, dispatches in (([b"d", b"e", b"c"], 2),   # d, e miss
                             ([b"x", b"y", b"z"], 3),   # evicts c, d
                             ([b"c", b"e"], 4),         # c missed again
                             ([b"m%d" % i for i in range(5)], 5)):  # bypass
        assert prov.batch_verify(batch(msgs)) is True
        assert prov.h2c_dispatch_count == dispatches


def test_port_imports_neither_jax_nor_the_reference():
    """teku_tpu_torch and chip_smoke.py import torch, numpy and the
    standard library; no module of jax or teku_tpu."""
    import ast
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    files = list((root / "teku_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {m}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "teku_tpu")]
    assert len(files) > 20 and not bad, bad
    # the MSM slice: its modules are checked too, and its path rule
    # reads no environment variable
    names = {str(p.relative_to(root)) for p in files}
    assert {"teku_tpu_torch/ops/msm.py",
            "teku_tpu_torch/ops/kernels/msm.py"} <= names
    # the KZG slice: its modules are checked too
    assert {"teku_tpu_torch/crypto/kzg.py", "teku_tpu_torch/ops/kzg.py",
            "teku_tpu_torch/ops/modfield.py",
            "teku_tpu_torch/ops/kernels/kzg.py"} <= names
    # TorchKzg never hands a batch to the facade's host path
    tree = ast.parse((root / "teku_tpu_torch/ops/kzg.py").read_text())
    assert not [n for n in ast.walk(tree) if getattr(n, "id", None) ==
                "BackendUnavailable" or getattr(n, "name", None) ==
                "BackendUnavailable"]
    msm_src = (root / "teku_tpu_torch/ops/msm.py").read_text()
    assert not any(isinstance(node, (ast.Import, ast.ImportFrom)) and any(
        a.name == "os" for a in node.names) for node in ast.walk(
            ast.parse(msm_src)))
    assert "os.environ" not in msm_src and "getenv" not in msm_src
