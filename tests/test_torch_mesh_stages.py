"""The mesh dispatch's stages: plain versions vs the reference, kernels vs
plain versions.

The port's plain stage_gather_hm, stage_lane_affine, shard partials
(batch_product + point_batch_sum) and aggregate_points (G1, G2) against
teku_tpu/ops/verify.py's stage_gather_hm, stage_lane_affine,
PR.batch_product + point_batch_sum and aggregate_points_kernel (jitted,
compile store off) on the same seeded 4-8 lane inputs: equal canonical
values (both packages keep 15 x 26-bit Montgomery limbs, R = 2^390).
Then the host C++ build of shard.cu and of scalars_group.cu's ``scalars``
against those plain versions, word for word, on bigger grids with
infinity lanes, padding rows, out-of-range gather indices, odd counts
and an all-padding shard.  The Jacobian sums are compared as words: the
kernels add in point_batch_sum's halving order.
"""

import jax
import numpy as np
import pytest
import torch

from teku_tpu.ops import pairing as JPR
from teku_tpu.ops import points as JP
from teku_tpu.ops import verify as JV
from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls.constants import P, R
from teku_tpu_torch.ops import kernels as K
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops import points as PT
from teku_tpu_torch.ops import towers as T
from teku_tpu_torch.ops import verify as V
from teku_tpu_torch.ops.kernels import scalars_group as KS
from teku_tpu_torch.ops.kernels import shard as KSH
from teku_tpu_torch.ops.kernels.decompress import (g1_from_words,
                                                   g2_from_words)
from tests.torch_parity import (as_np, assert_same_values,  # noqa: F401
                                no_aot_store, one_torch_thread)

RNG = np.random.default_rng(0x3E5)


def scalar():
    return int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1


def jac_words(points, g2: bool) -> torch.Tensor:
    """Oracle Jacobian points (None = infinity) -> canonical words."""
    one, zero = ((1, 0), (0, 0)) if g2 else (1, 0)
    rows = []
    for p in points:
        p = (one, one, zero) if p is None else p
        if g2:
            rows.append([[fp.int_to_words(c) for c in coord] for coord in p])
        else:
            rows.append([fp.int_to_words(coord) for coord in p])
    return torch.from_numpy(np.array(rows, dtype=np.int32))


def g1_points(n, inf=()):
    return jac_words([None if i in inf else C.point_mul(
        C.FQ_OPS, scalar(), C.G1_GENERATOR) for i in range(n)], g2=False)


def g2_points(n, inf=()):
    return jac_words([None if i in inf else C.point_mul(
        C.FQ2_OPS, scalar(), C.G2_GENERATOR) for i in range(n)], g2=True)


def affine(words: torch.Tensor) -> torch.Tensor:
    """Jacobian words (n, 3, ...) -> affine words (n, 2, ...) (z = 1)."""
    g2 = words.dim() == 4
    out = []
    for row in words.numpy():
        ints = [fp.words_to_int(w) for w in row.reshape(-1, 12)]
        if g2:
            pt = ((ints[0], ints[1]), (ints[2], ints[3]), (ints[4], ints[5]))
            x, y = C.to_affine(C.FQ2_OPS, pt)
            out.append([[fp.int_to_words(c) for c in v] for v in (x, y)])
        else:
            x, y = C.to_affine(C.FQ_OPS, tuple(ints))
            out.append([fp.int_to_words(v) for v in (x, y)])
    return torch.from_numpy(np.array(out, dtype=np.int32))


def fq12_rows(n, ones=False) -> torch.Tensor:
    """n random Fq12 values (or n ONEs) as (n, 12, 12) words."""
    vals = [[int(j == 0) if ones else
             int.from_bytes(RNG.bytes(48), "big") % P for j in range(12)]
            for _ in range(n)]
    return torch.from_numpy(np.array(
        [[fp.int_to_words(v) for v in row] for row in vals], dtype=np.int32))


def ref(tree):
    return fp.to_reference(tree)


def test_gather_hm_and_lane_affine_match_reference():
    hm = affine(g2_points(4))
    lane_map = torch.tensor([3, 0, 0, 2, 1, 3, 3, 0], dtype=torch.int32)
    hm_t = g2_from_words(hm)
    got = V.stage_gather_hm(hm_t, lane_map)
    want = as_np(jax.jit(JV.stage_gather_hm)(ref(hm_t), lane_map.numpy()))
    assert_same_values(want, got)
    pk_r = g1_from_words(g1_points(6, inf={2, 5}))
    got = V.stage_lane_affine(pk_r)
    want = as_np(jax.jit(JV.stage_lane_affine)(ref(pk_r)))
    assert_same_values(want, got)
    # infinity lanes come out as (0, 0)
    assert not fp.to_words(got[0])[2].any() and \
        not fp.to_words(got[1])[5].any()


def test_shard_partials_match_reference():
    ml = T.fq12_from_words(fq12_rows(4))
    wsig = g2_from_words(g2_points(8, inf={1, 6}))
    prod, ssum = V.shard_partials(ml, wsig)
    f = jax.jit(lambda m, w: (JPR.batch_product(m),
                              JV.point_batch_sum(JP.G2_KIT, w)))
    want = as_np(f(ref(ml), ref(wsig)))
    assert_same_values(want[0], prod)
    assert_same_values(want[1], ssum)
    # an all-padding shard: every row ONE, every signature infinity
    prod, ssum = V.shard_partials(T.fq12_from_words(fq12_rows(4, ones=True)),
                                  g2_from_words(g2_points(8, inf=range(8))))
    assert T.fq12_is_one(prod).item()
    assert PT.is_infinity(PT.G2_KIT, ssum).item()
    # the gathered partials' finish is the reference's _finish
    assert bool(V.finish_partials([(prod, ssum)] * 2)) is True


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_aggregate_points_match_reference(group):
    g2 = group == "g2"
    pts = affine(g2_points(8) if g2 else g1_points(8))
    present = torch.tensor([True, False, True, True, False, True, True, True])
    kit, jkit = (PT.G2_KIT, JP.G2_KIT) if g2 else (PT.G1_KIT, JP.G1_KIT)
    x, y = (g2_from_words if g2 else g1_from_words)(pts)
    got = V.aggregate_points(kit, x, y, present)
    want = as_np(jax.jit(lambda a, b, m: JV.aggregate_points_kernel(
        jkit, a, b, m))(ref(x), ref(y), present.numpy()))
    assert_same_values(want, got)
    none = V.aggregate_points(kit, x, y, torch.zeros(8, dtype=torch.bool))
    assert PT.is_infinity(kit, none).item()


def host(source):
    return K.lib(source, host=True)


def assert_words_equal(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def check_gather_hm():
    hm = affine(g2_points(8))
    for idx in ([7, 0, 3, 3, 1, 6, 2, 5, 4, 0, 0, 7, 1, 2, 6, 5],
                [0, 8, -1, 3, 7, 2**31 - 1]):
        idx = torch.tensor(idx, dtype=torch.int32)
        out = KSH._run_gather_hm(host("shard"), hm, idx)
        assert_words_equal(out, KSH.gather_hm_plain(hm, idx))
        assert out[1].item() is bool((idx < 8).all() and (idx >= 0).all())


def check_scalars_lane_affine():
    pk = g1_points(8, inf={0, 5})
    sig = g2_points(8, inf={3, 5})
    r = torch.from_numpy(RNG.integers(-2**63, 2**63 - 1, 8, dtype=np.int64))
    r[1] = 0
    out = KS._run_scalars(host("scalars_group"), pk, sig, r)
    assert_words_equal(out, KS.scalars_plain(pk, sig, r))
    aff = KSH._run_lane_affine(host("shard"), out[0])
    assert_words_equal(aff, KSH.lane_affine_plain(out[0]))
    assert not aff[0].any() and not aff[1].any() and aff[2].any()


def check_shard_partials():
    sigs = g2_points(8, inf={2})
    for rows, lanes in ((1, 1), (2, 8), (3, 5), (8, 7)):
        ml, wsig = fq12_rows(rows), sigs[:lanes].contiguous()
        out = KSH._run_shard_partials(host("shard"), ml, wsig)
        assert_words_equal(out, KSH.shard_partials_plain(ml, wsig))
    # an all-padding shard gives ONE and infinity
    ml, wsig = fq12_rows(2, ones=True), g2_points(4, inf=range(4))
    out = KSH._run_shard_partials(host("shard"), ml, wsig)
    assert_words_equal(out, KSH.shard_partials_plain(ml, wsig))
    assert torch.equal(out[0], ml[:1]) and torch.equal(out[1], wsig[:1])


def check_aggregate_points():
    for pts in (affine(g1_points(8)), affine(g2_points(8))):
        for n, present in ((1, [True]), (3, [True, False, True]),
                           (8, [True] * 8), (8, [False] * 8),
                           (8, [False, True] * 4)):
            p = pts[:n].contiguous()
            m = torch.tensor(present)
            out = KSH._run_aggregate_points(host("shard"), p, m)
            assert_words_equal(out, KSH.aggregate_points_plain(p, m))


@pytest.mark.parametrize("check", [check_gather_hm, check_scalars_lane_affine,
                                   check_shard_partials,
                                   check_aggregate_points],
                         ids=["gather_hm", "scalars+lane_affine",
                              "shard_partials", "aggregate_points"])
def test_host_build_matches_plain(check):
    check()
