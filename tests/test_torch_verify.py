"""The slice end to end: TorchBls12381 (device="cpu") and its stages.

Tier-1 holds the port's provider and facade against the pure-Python
oracle (teku_tpu.crypto.bls.pure_impl) on 4-lane batches: valid with
duplicated messages, one infinity-signature lane, swapped signatures.
The stage functions are held against the oracle on one batch.  The
same verdicts against JaxBls12381 are ``slow``: a cold compile of the
reference's staged programs takes minutes per shape on a CPU.
"""

import numpy as np
import pytest
import torch

from teku_tpu.crypto.bls.pure_impl import PureBls12381 as RefPure
from teku_tpu_torch.crypto import bls
from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls import pairing as OP
from teku_tpu_torch.crypto.bls.constants import R
from teku_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2
from teku_tpu_torch.crypto.bls.pure_impl import G2_INFINITY, PureBls12381
from teku_tpu_torch.ops import h2c
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops import points as PT
from teku_tpu_torch.ops import towers as T
from teku_tpu_torch.ops import verify as V
from teku_tpu_torch.ops.provider import TorchBls12381
from tests.torch_parity import no_aot_store, one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0xB15)
PURE = PureBls12381()
SKS = [int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1 for _ in range(5)]
PKS = [PURE.secret_key_to_public_key(s) for s in SKS]


def seeded_multipliers(n):
    return RNG.integers(1, 2**63, n, dtype=np.int64).astype(np.uint64)


def triple(keys, msg):
    sig = PURE.aggregate_signatures([PURE.sign(SKS[k], msg) for k in keys])
    return ([PKS[k] for k in keys], msg, sig)


# lanes 0, 2, 3 share a message; lane 3 carries a 2-key aggregate
VALID = [triple([0], b"att-a"), triple([1], b"att-b"), triple([2], b"att-a"),
         triple([3, 4], b"att-a")]


@pytest.fixture(scope="module")
def provider():
    return TorchBls12381(device="cpu", multipliers=seeded_multipliers)


def test_valid_batch_with_duplicates_through_facade(provider):
    bls.set_implementation(provider)
    try:
        assert bls.get_implementation() is provider
        assert bls.batch_verify(VALID) is True
    finally:
        bls.reset_implementation()
    assert RefPure().batch_verify(VALID) is True
    assert provider.h2c_dispatch_count == 1


def test_infinity_signature_lane_rejects_like_oracle(provider):
    batch = VALID[:3] + [(VALID[3][0], VALID[3][1], G2_INFINITY)]
    expect = RefPure().batch_verify(batch)
    assert expect is False
    handle = provider.begin_batch_verify(batch)
    assert handle.result() is expect


def test_swapped_signatures_reject_like_oracle(provider):
    batch = list(VALID)
    batch[0], batch[1] = ((VALID[0][0], VALID[0][1], VALID[1][2]),
                          (VALID[1][0], VALID[1][1], VALID[0][2]))
    assert RefPure().batch_verify(batch) is False
    assert provider.batch_verify(batch) is False


def test_host_rejections_need_no_dispatch(provider):
    before = provider.dispatch_count
    inf_pk = bytes([0xC0] + [0] * 47)
    assert provider.batch_verify([([inf_pk], b"x", VALID[0][2])]) is False
    assert provider.batch_verify([(VALID[0][0], b"x", b"\x00" * 96)]) is False
    assert provider.prepare_batch_verify(([], b"x", VALID[0][2])) is None
    assert provider.public_key_is_valid(inf_pk) is False
    assert bls.eth_fast_aggregate_verify([], b"x", G2_INFINITY) is True
    assert provider.dispatch_count == before


STAGE_MSGS = [b"s-0", b"s-1"]
STAGE_LANES = [([0, 1], 0), ([2], 1), ([3], 0)]   # (keys, message)


def stage_inputs():
    """Numpy inputs of the stage functions for a 3-lane, 2-message batch
    plus one padding lane (infinity signature, no keys), the oracle's
    points beside them."""
    r = [int(x) for x in RNG.integers(1, 2**63, 4)]
    pk_aff = [C.to_affine(C.FQ_OPS, C.point_mul(C.FQ_OPS, s, C.G1_GENERATOR))
              for s in SKS]
    n, k = 4, 2
    pk_x = np.zeros((n, k, fp.L), dtype=np.int64)
    pk_y = np.zeros_like(pk_x)
    present = np.zeros((n, k), dtype=bool)
    sig_pts = []
    for i, (keys, m) in enumerate(STAGE_LANES):
        for j, key in enumerate(keys):
            pk_x[i, j] = fp.int_to_mont(pk_aff[key][0])
            pk_y[i, j] = fp.int_to_mont(pk_aff[key][1])
            present[i, j] = True
        sig_pts.append(C.point_mul(C.FQ2_OPS, sum(SKS[x] for x in keys) % R,
                                   hash_to_g2(STAGE_MSGS[m])))
    sig_aff = [C.to_affine(C.FQ2_OPS, p) for p in sig_pts] + [((0, 0),
                                                              (0, 0))]
    sig_x = tuple(np.stack([fp.int_to_limbs(a[0][c]) for a in sig_aff])
                  for c in (0, 1))
    u0, u1 = h2c.messages_to_fields(STAGE_MSGS)
    return dict(
        prepare=(pk_x, pk_y, present, sig_x,
                 np.array([C._fq2_is_large(a[1]) for a in sig_aff]),
                 np.array([False, False, False, True]),
                 np.array([True, True, True, False])),
        h2c=(u0, u1),
        bits=np.array(PT.scalar_from_uint64(
            torch.tensor(r, dtype=torch.int64))),
        group=(np.array([[0, 2], [1, 0]], dtype=np.int32),
               np.array([[True, True], [True, False]])),
        r=r, pk_aff=pk_aff, sig_pts=sig_pts)


def to_t(x):
    return fp.from_reference(x)


def test_wire_parse_rejects_like_reference():
    from teku_tpu.ops import provider as JP
    from teku_tpu_torch.crypto.bls.constants import P
    from teku_tpu_torch.ops.provider import parse_g1_wire, parse_g2_wire
    big = P.to_bytes(48, "big")
    g1 = [PKS[0], bytes([0xC0] + [0] * 47), bytes([0xC1] + [0] * 47),
          bytes([big[0] | 0x80]) + big[1:], PKS[0][1:] + b"\0",
          bytes([PKS[0][0] & 0x7F]) + PKS[0][1:], PKS[0][:47]]
    for pk in g1:
        assert parse_g1_wire(pk) == JP._parse_g1_wire(pk)
    sig = VALID[0][2]
    g2 = [sig, G2_INFINITY, bytes([0xE0] + [0] * 95),
          sig[:48] + big, bytes([big[0] | 0x80]) + big[1:] + sig[48:],
          bytes([sig[0] & 0x7F]) + sig[1:], sig[:95]]
    for s in g2:
        ref, got = JP._parse_g2_wire(s), parse_g2_wire(s)
        assert (ref is None) == (got is None)
        if ref is not None:
            assert ref[1:] == got[1:] and (ref[0] == got[0]).all()


def test_stages_match_oracle():
    """prepare -> h2c -> scalars -> group -> miller -> finish, each
    stage's output against the oracle."""
    d = stage_inputs()
    r, pk_aff = d["r"], d["pk_aff"]
    pk_jac, sig_jac, lane_ok, mmask = V.stage_prepare(*to_t(d["prepare"]))
    # lane 3 is padding with no keys: its aggregate is infinity
    assert lane_ok.tolist() == [True, True, True, False]
    assert mmask.tolist() == [True, True, True, False]
    for i in range(3):
        assert C.point_eq(C.FQ2_OPS, tuple(T.fq2_from_device(c, (i,))
                                           for c in sig_jac), d["sig_pts"][i])
    hm = V.stage_h2c(*to_t(d["h2c"]))
    for m in range(2):
        assert (T.fq2_from_device(hm[0], (m,)),
                T.fq2_from_device(hm[1], (m,))) == C.to_affine(
                    C.FQ2_OPS, hash_to_g2(STAGE_MSGS[m]))
    pk_r, wsig = V.stage_scalars(pk_jac, sig_jac, to_t(d["bits"]))
    agg, u_mask = V.stage_group(pk_r, mmask, *to_t(d["group"]))
    assert u_mask.tolist() == [True, True]
    lane_pk = [C.point_add(C.FQ_OPS, *[C.from_affine(C.FQ_OPS, *pk_aff[x])
                                       for x in keys]) if len(keys) > 1
               else C.from_affine(C.FQ_OPS, *pk_aff[keys[0]])
               for keys, _ in STAGE_LANES]
    expect = [C.point_add(C.FQ_OPS, C.point_mul(C.FQ_OPS, r[0], lane_pk[0]),
                          C.point_mul(C.FQ_OPS, r[2], lane_pk[2])),
              C.point_mul(C.FQ_OPS, r[1], lane_pk[1])]
    for u in range(2):
        got = (fp.mont_to_int(agg[0][u]), fp.mont_to_int(agg[1][u]))
        assert got == C.to_affine(C.FQ_OPS, expect[u])
    ml = V.stage_miller(agg, hm, u_mask)
    for u in range(2):
        assert T.fq12_from_device(ml, (u,)) == OP.miller_loop(
            C.to_affine(C.FQ_OPS, expect[u]),
            C.to_affine(C.FQ2_OPS, hash_to_g2(STAGE_MSGS[u])))
    assert bool(V.stage_finish(ml, wsig)) is True
    # lane 0's weighted signature replaced by lane 1's
    wsig_bad = tuple((torch.cat([c[0][1:2], c[0][1:]]),
                      torch.cat([c[1][1:2], c[1][1:]])) for c in wsig)
    assert bool(V.stage_finish(ml, wsig_bad)) is False


@pytest.mark.slow
def test_stages_match_jax_stages():
    """Each stage of teku_tpu/ops/verify.py (jitted, compile store off)
    against the port's on the same inputs: equal canonical values."""
    import jax
    from teku_tpu.ops import verify as JV
    from tests.torch_parity import as_np, assert_same_values
    d = stage_inputs()
    ref = as_np(jax.jit(JV.stage_prepare)(*d["prepare"]))
    got = V.stage_prepare(*to_t(d["prepare"]))
    assert_same_values(ref[:2], got[:2])
    assert [r.tolist() for r in ref[2:]] == [g.tolist() for g in got[2:]]
    hm_ref = as_np(jax.jit(JV.stage_h2c)(*d["h2c"]))
    assert_same_values(hm_ref, V.stage_h2c(*to_t(d["h2c"])))
    sc_ref = as_np(jax.jit(JV.stage_scalars)(ref[0], ref[1], d["bits"]))
    sc = V.stage_scalars(to_t(ref[0]), to_t(ref[1]), to_t(d["bits"]))
    assert_same_values(sc_ref, sc)
    gr_ref = as_np(jax.jit(JV.stage_group)(sc_ref[0], ref[3], *d["group"]))
    gr = V.stage_group(to_t(sc_ref[0]), to_t(ref[3]), *to_t(d["group"]))
    assert_same_values(gr_ref[0], gr[0])
    assert gr_ref[1].tolist() == gr[1].tolist()
    ml_ref = as_np(jax.jit(JV.stage_miller)(gr_ref[0], hm_ref, gr_ref[1]))
    ml = V.stage_miller(to_t(gr_ref[0]), to_t(hm_ref), to_t(gr_ref[1]))
    assert_same_values(ml_ref, ml)
    ok_ref = bool(jax.jit(JV.stage_finish)(ml_ref, sc_ref[1]))
    assert ok_ref is bool(V.stage_finish(to_t(ml_ref), to_t(sc_ref[1])))
    assert ok_ref is True
    p = to_t(d["prepare"])
    ok, lane_ok = V.verify_staged(*p[:3], *to_t(d["h2c"]), *to_t(d["group"]),
                                  *p[3:6], to_t(d["bits"]), p[6])
    assert bool(ok) is True and lane_ok.tolist() == ref[2].tolist()


@pytest.mark.slow
def test_verdicts_match_jax_provider(provider):
    """Valid, duplicated-message, infinity and tampered 4-lane batches:
    TorchBls12381 and JaxBls12381 (compile store off) agree."""
    from teku_tpu.ops.provider import JaxBls12381
    ref = JaxBls12381(min_bucket=4)
    infinity = VALID[:3] + [(VALID[3][0], VALID[3][1], G2_INFINITY)]
    tampered = list(VALID)
    tampered[2] = (VALID[2][0], VALID[2][1], VALID[1][2])
    dup = [triple([0], b"dup")] * 2 + [triple([1], b"dup"),
                                      triple([2], b"dup")]
    for batch in (VALID, dup, infinity, tampered):
        assert provider.batch_verify(batch) == ref.batch_verify(batch)
