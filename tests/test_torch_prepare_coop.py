"""prepare (a warp a lane) on its host C++ build against prepare_plain.

decompress.cu's prepare runs one warp per lane: the lane's key tree a
level at a time, its signature's Fq2 square root and psi subgroup check
with each step's Fq products on separate lanes (wcoop.cuh).  Its source
builds as host C++ in both Montgomery engines, each phase a loop over its
jobs, and word for word it must give the plain version (the port's
stage_prepare): pk_jac, sig_jac, lane_ok and miller_mask.  The lanes
cover a key absent (pk_inf), keys that cancel (P + -P), a key twice (the
tree's doubling case), an infinity signature, a signature x off the
curve, a point off the subgroup, a point of order 13 (its subgroup
ladder doubles to infinity, adds to infinity and adds Q to -Q) and masked
lanes, at 1, 2 and 128 keys a lane; the lane counts (7, 5, 3) are not a
multiple of a warp.

Tolerance: exact, on words and flags.  Inputs come from the port's
oracle at small multiples of the generators, so no test signs.
"""

import numpy as np
import pytest
import torch

from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls import fields as F
from teku_tpu_torch.crypto.bls.constants import B_G2, H_EFF_G2, P, R, X_ABS
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops.kernels import decompress as KD
from tests.torch_parity import one_torch_thread  # noqa: F401

ENGINES = ("cios", "mma")
G1 = C.to_affine(C.FQ_OPS, C.G1_GENERATOR)
# E2's cofactor: #E2(Fq2) = H2 R, and h_eff = 3 (z^2 - 1) H2
H2 = H_EFF_G2 // (3 * (X_ABS * X_ABS - 1))


def g1_multiples(n):
    """[1]G1 .. [n]G1, affine."""
    acc, out = C.G1_GENERATOR, []
    for _ in range(n):
        out.append(C.to_affine(C.FQ_OPS, acc))
        acc = C.point_add(C.FQ_OPS, acc, C.G1_GENERATOR)
    return out


def g2_signature(k):
    """The wire fields of [k]G2: (x, large)."""
    x, y = C.to_affine(C.FQ2_OPS, C.point_mul(C.FQ2_OPS, k, C.G2_GENERATOR))
    return x, C._fq2_is_large(y)


def g2_off_curve_x(rng):
    """An x whose x^3 + b is not a square in Fq2 (no point)."""
    while True:
        x = tuple(int.from_bytes(rng.bytes(48), "big") % P for _ in range(2))
        if F.fq2_sqrt(F.fq2_add(F.fq2_mul(F.fq2_sqr(x), x), B_G2)) is None:
            return x


def g2_off_subgroup_x(rng):
    """The x of a point on E2 outside the order-r subgroup."""
    while True:
        x = tuple(int.from_bytes(rng.bytes(48), "big") % P for _ in range(2))
        y = F.fq2_sqrt(F.fq2_add(F.fq2_mul(F.fq2_sqr(x), x), B_G2))
        if y is not None and not C.g2_in_subgroup(C.from_affine(C.FQ2_OPS, x, y)):
            return x


def g2_order13_sig(rng):
    """The wire fields of a point of order 13 on E2 (13^2 divides H2, and
    E2's 13-torsion has exponent 13)."""
    while True:
        x = tuple(int.from_bytes(rng.bytes(48), "big") % P for _ in range(2))
        y = F.fq2_sqrt(F.fq2_add(F.fq2_mul(F.fq2_sqr(x), x), B_G2))
        if y is None:
            continue
        q = C.point_mul(C.FQ2_OPS, H2 * R // 169, C.from_affine(C.FQ2_OPS, x, y))
        if not C.is_infinity(C.FQ2_OPS, q):
            assert C.is_infinity(C.FQ2_OPS, C.point_mul(C.FQ2_OPS, 13, q))
            qx, qy = C.to_affine(C.FQ2_OPS, q)
            return qx, C._fq2_is_large(qy)


def lane_batch(keys, sigs, valid):
    """keys: per lane, k affine G1 keys or None (absent); sigs: per lane,
    (x, large) or None (the infinity signature); valid: lane_valid."""
    n, k = len(keys), len(keys[0])
    pk = np.zeros((2, n, k, 12), dtype=np.int32)
    present = np.zeros((n, k), dtype=bool)
    for i, lane in enumerate(keys):
        for j, key in enumerate(lane):
            if key is not None:
                present[i, j] = True
                pk[:, i, j] = [fp.int_to_words(c) for c in key]
    sx = np.zeros((2, n, 12), dtype=np.int32)
    large = np.zeros(n, dtype=bool)
    for i, sig in enumerate(sigs):
        if sig is not None:
            sx[:, i] = [fp.int_to_words(c) for c in sig[0]]
            large[i] = sig[1]
    t = torch.from_numpy
    return (t(pk[0]), t(pk[1]), t(present), t(sx[0]), t(sx[1]), t(large),
            torch.tensor([s is None for s in sigs]), torch.tensor(valid))


def case(name):
    rng = np.random.default_rng(0x9E9)
    ks = g1_multiples(256)
    neg = (G1[0], (P - G1[1]) % P)
    good, other = g2_signature(7), g2_signature(11)
    off_curve = (g2_off_curve_x(rng), False)
    off_subgroup = (g2_off_subgroup_x(rng), True)
    if name == "1 key":
        return lane_batch(
            [[ks[0]], [None], [ks[2]], [ks[3]], [ks[4]], [ks[5]], [ks[6]]],
            [good, good, None, off_curve, off_subgroup, other,
             g2_order13_sig(rng)],
            [True, True, True, True, True, False, True])
    if name == "2 keys":
        return lane_batch(
            [[ks[0], ks[1]], [ks[2], None], [None, None], [G1, neg],
             [ks[4], ks[4]]],
            [good, off_subgroup, other, good, None],
            [True, True, True, False, True])
    return lane_batch(
        [ks[:128], [None if j % 3 else key for j, key in
                    enumerate(ks[128:])], [None] * 128],
        [good, None, other], [True, True, False])


@pytest.mark.parametrize("name, lane_ok, miller_mask", [
    ("1 key", [1, 0, 1, 0, 0, 1, 0], [1, 0, 1, 1, 1, 0, 1]),
    ("2 keys", [1, 0, 0, 0, 1], [1, 1, 0, 0, 1]),
    ("128 keys", [1, 1, 0], [1, 1, 0])], ids=["1 key", "2 keys", "128 keys"])
def test_prepare_host_builds_match_plain(name, lane_ok, miller_mask):
    args = case(name)
    with torch.inference_mode():
        want = KD.prepare_plain(*args)
    assert want[2].int().tolist() == lane_ok
    assert want[3].int().tolist() == miller_mask
    for engine in ENGINES:
        got = KD._run_prepare(K.lib("decompress", host=True, engine=engine),
                              *args)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b), (name, engine)
