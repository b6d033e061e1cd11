"""Shared helpers of the tests/test_torch_*.py parity tests.

The port (teku_tpu_torch) and the JAX package take the same seeded numpy
inputs; results are compared as canonical integers mod P (both packages
use Montgomery form with R = 2^390, so equal residues mean equal values).
"""

import numpy as np
import pytest
import torch

from teku_tpu_torch.crypto.bls.constants import P
from teku_tpu_torch.ops import limbs as fp


@pytest.fixture(autouse=True)
def no_aot_store(monkeypatch):
    """Reference calls never read or write the serialized-executable store."""
    monkeypatch.setenv("TEKU_TPU_AOT_STORE", "0")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def residues(arr) -> list:
    """(..., 15) limb array -> flat list of python ints mod P."""
    a = np.asarray(arr.detach().cpu() if torch.is_tensor(arr) else arr)
    a = a.reshape(-1, fp.L)
    return [sum(int(row[i]) << (fp.W * i) for i in range(fp.L)) % P
            for row in a]


def assert_same_values(ref, got):
    """Every leaf of two limb trees holds the same residues."""
    ref_l, got_l = leaves(ref), leaves(got)
    assert len(ref_l) == len(got_l)
    for r, g in zip(ref_l, got_l):
        assert residues(r) == residues(g)


def assert_same_bits(ref, got):
    """Every leaf of two limb trees is bit-identical."""
    ref_l, got_l = leaves(ref), leaves(got)
    assert len(ref_l) == len(got_l)
    for r, g in zip(ref_l, got_l):
        np.testing.assert_array_equal(np.asarray(r), g.detach().cpu().numpy())


def as_np(tree):
    """Reference outputs (jax arrays) -> numpy, same tree."""
    if isinstance(tree, (tuple, list)):
        return tuple(as_np(t) for t in tree)
    return np.asarray(tree)
