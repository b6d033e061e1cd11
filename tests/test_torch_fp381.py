"""The fp381 entry points of ops/kernels/fp381.cu against their plain
versions.

Without a card the source compiles as host C++; each entry point must
give its plain PyTorch version's words exactly on seeded inputs, and the
host build's Montgomery-product counter must count what the entry point
does (tolerance: exact).
"""

import numpy as np
import pytest
import torch

from teku_tpu_torch.crypto.bls.constants import P
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops.kernels import fp381 as KF
from tests.torch_parity import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0xF381)


def rand_words(n, width=1):
    vals = [int.from_bytes(RNG.bytes(48), "big") % P for _ in range(n * width)]
    return torch.from_numpy(np.stack([fp.int_to_words(v) for v in vals])
                            ).reshape(n, 12 * width)


@pytest.mark.parametrize("op", sorted(KF.OPS))
def test_fp381_entry_points_host_build_match_plain(op):
    _, width, nargs = KF.OPS[op]
    a = rand_words(3, width)
    b = rand_words(3, width) if nargs == 2 else None
    out = KF._run(K.lib("fp381", host=True), op, a, b)
    assert torch.equal(out, KF.fp381_ops_plain(op, a, b))


def test_host_mul_count_reports_montgomery_products():
    lib = K.lib("fp381", host=True)
    before = lib.fp381_mul_count()
    KF._run(lib, "fq2_mul", rand_words(5, 2), rand_words(5, 2))
    # per element: two loads (to Montgomery) x 2 components, 3 products,
    # two stores (from Montgomery) x 1 component each
    assert lib.fp381_mul_count() - before == 5 * (4 + 3 + 2)
