"""Port parity: teku_tpu_torch curve points vs teku_tpu/ops/points.py.

Jacobian add / double (with the infinity, P == Q and P == -Q cases), the
64-bit window ladder, the subgroup checks and decompression, on the
same seeded inputs and at the shapes tests/test_ops_points.py compiles.
Jacobian outputs must be bit-identical (same formulas); booleans equal.
Also the decompress kernel's plain versions (pubkey validation and the
prepare stage) against the pure-Python oracle.
"""

import jax
import numpy as np
import torch

from teku_tpu.ops import limbs as JL
from teku_tpu.ops import points as JP
from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls import fields as F
from teku_tpu_torch.crypto.bls.constants import P, R
from teku_tpu_torch.crypto.bls.pure_impl import G2_INFINITY, PureBls12381
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops import points as PT
from teku_tpu_torch.ops.kernels import decompress as KD
from teku_tpu_torch.ops.provider import parse_g1_wire, parse_g2_wire
from tests.torch_parity import (as_np, assert_same_bits,  # noqa: F401
                                no_aot_store, one_torch_thread)

RNG = np.random.default_rng(0x9015)


def scalar():
    return int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1


def rand_g1():
    return C.point_mul(C.FQ_OPS, scalar(), C.G1_GENERATOR)


def rand_g2():
    return C.point_mul(C.FQ2_OPS, scalar(), C.G2_GENERATOR)


def stack_g1(points):
    return tuple(np.stack([JL.int_to_mont(p[i]) for p in points])
                 for i in range(3))


def stack_g2(points):
    return tuple((np.stack([JL.int_to_mont(p[i][0]) for p in points]),
                  np.stack([JL.int_to_mont(p[i][1]) for p in points]))
                 for i in range(3))


def t(x):
    return fp.from_reference(x)


def non_subgroup_g2():
    while True:
        x = tuple(int.from_bytes(RNG.bytes(48), "big") % P for _ in range(2))
        y = F.fq2_sqrt(F.fq2_add(F.fq2_mul(F.fq2_sqr(x), x), (4, 4)))
        if y is not None and not C.g2_in_subgroup((x, y, F.FQ2_ONE)):
            return (x, y, F.FQ2_ONE)


def test_g1_add_double_edge_cases_bit_identical():
    a, b = rand_g1(), rand_g1()
    inf = C.infinity(C.FQ_OPS)
    pairs = [(a, b), (a, a), (a, C.point_neg(C.FQ_OPS, a)), (inf, b),
             (a, inf), (inf, inf)]
    pa, pb = stack_g1([p for p, _ in pairs]), stack_g1([q for _, q in pairs])
    ref = jax.jit(lambda x, y: JP.point_add(JP.G1_KIT, x, y))(pa, pb)
    assert_same_bits(as_np(ref), PT.point_add(PT.G1_KIT, t(pa), t(pb)))
    ref = jax.jit(lambda x: JP.point_double(JP.G1_KIT, x))(pa)
    assert_same_bits(as_np(ref), PT.point_double(PT.G1_KIT, t(pa)))


def test_g2_add_and_ladder_bit_identical():
    a, b = rand_g2(), rand_g2()
    inf = C.infinity(C.FQ2_OPS)
    pairs = [(a, b), (a, a), (a, C.point_neg(C.FQ2_OPS, a)), (inf, b),
             (a, inf)]
    pa, pb = stack_g2([p for p, _ in pairs]), stack_g2([q for _, q in pairs])
    ref = jax.jit(lambda x, y: JP.point_add(JP.G2_KIT, x, y))(pa, pb)
    assert_same_bits(as_np(ref), PT.point_add(PT.G2_KIT, t(pa), t(pb)))
    pts = stack_g2([rand_g2() for _ in range(2)])
    scal = np.array([int(RNG.integers(0, 2**63)) for _ in range(2)],
                    dtype=np.uint64)
    bits = np.array(JP.scalar_from_uint64(scal))
    ref = jax.jit(lambda b_, p: JP.scalar_mul_bits(JP.G2_KIT, b_, p))(
        bits, pts)
    got = PT.scalar_mul_bits(PT.G2_KIT, torch.from_numpy(bits), t(pts))
    assert_same_bits(as_np(ref), got)


def test_g1_ladder_bit_identical():
    pts = [rand_g1() for _ in range(3)] + [C.infinity(C.FQ_OPS)]
    dev = stack_g1(pts)
    scal = np.array([int(RNG.integers(0, 2**63)) for _ in range(3)]
                    + [12345], dtype=np.uint64)
    bits = np.array(JP.scalar_from_uint64(scal))
    assert torch.equal(PT.scalar_from_uint64(
        torch.from_numpy(scal.view(np.int64))), torch.from_numpy(bits))
    ref = jax.jit(lambda b_, p: JP.scalar_mul_bits(JP.G1_KIT, b_, p))(
        bits, dev)
    got = PT.scalar_mul_bits(PT.G1_KIT, torch.from_numpy(bits), t(dev))
    assert_same_bits(as_np(ref), got)


def test_subgroup_checks_match_reference():
    good2 = [rand_g2() for _ in range(2)]
    dev2 = stack_g2(good2 + [non_subgroup_g2()])
    ref = np.asarray(jax.jit(JP.g2_in_subgroup)(dev2)).tolist()
    assert PT.g2_in_subgroup(t(dev2)).tolist() == ref == [True, True, False]
    dev1 = stack_g1([rand_g1(), C.infinity(C.FQ_OPS)])
    assert PT.g1_in_subgroup(t(dev1)).tolist() == [True, True]


def test_decompress_matches_reference():
    pts = [rand_g1() for _ in range(4)]
    xs, flags = [], []
    for p in pts:
        x, large, _ = parse_g1_wire(C.g1_compress(p))
        xs.append(JL.int_to_limbs(x))
        flags.append(large)
    ok_j, pt_j = jax.jit(JP.g1_recover_y)(np.stack(xs), np.array(flags))
    ok_t, pt_t = PT.g1_recover_y(t(np.stack(xs)), torch.tensor(flags))
    assert ok_t.tolist() == np.asarray(ok_j).tolist() == [True] * 4
    assert_same_bits(as_np(pt_j), pt_t)
    g2 = [rand_g2() for _ in range(3)]
    x0s, x1s, flags = [], [], []
    for p in g2:
        xb, large, _ = parse_g2_wire(C.g2_compress(p))
        x1s.append(JL.int_to_limbs(int.from_bytes(xb[0].tobytes(), "big")))
        x0s.append(JL.int_to_limbs(int.from_bytes(xb[1].tobytes(), "big")))
        flags.append(large)
    x = (np.stack(x0s), np.stack(x1s))
    ok_j, pt_j = jax.jit(JP.g2_recover_y)(x, np.array(flags))
    ok_t, pt_t = PT.g2_recover_y(t(x), torch.tensor(flags))
    assert ok_t.tolist() == np.asarray(ok_j).tolist() == [True] * 3
    assert_same_bits(as_np(pt_j), pt_t)


def test_g1_validate_plain_matches_oracle():
    pure = PureBls12381()
    pks = [pure.secret_key_to_public_key(scalar()) for _ in range(3)]
    # an x off the curve, and a point of the curve outside the subgroup
    bad_x = 5
    while F.fq_sqrt((bad_x ** 3 + 4) % P) is not None:
        bad_x += 1
    while True:
        x = int.from_bytes(RNG.bytes(48), "big") % P
        y = F.fq_sqrt((x ** 3 + 4) % P)
        if y is not None and not C.g1_in_subgroup((x, y, 1)):
            break
    wires = [parse_g1_wire(pk) for pk in pks] + [(bad_x, False, False),
                                                 (x, True, False)]
    xw = torch.from_numpy(np.stack([fp.int_to_words(w[0]) for w in wires]))
    ok, gx, gy = KD.g1_validate(xw, torch.tensor([w[1] for w in wires]))
    assert ok.tolist() == [True, True, True, False, False]
    for i, pk in enumerate(pks):
        expect = C.to_affine(C.FQ_OPS, C.g1_decompress(pk))
        assert (fp.words_to_int(gx[i]), fp.words_to_int(gy[i])) == expect


def test_prepare_plain_masks_match_oracle():
    """Aggregated keys, decompressed signatures and the lane masks:
    valid 2-key lane, infinity signature, an off-curve signature x,
    and a padding lane."""
    pure = PureBls12381()
    sks = [scalar() for _ in range(3)]
    pk_aff = [C.to_affine(C.FQ_OPS, C.point_mul(C.FQ_OPS, s, C.G1_GENERATOR))
              for s in sks]
    sig = pure.aggregate_signatures([pure.sign(sks[0], b"m"),
                                     pure.sign(sks[1], b"m")])
    bad_sig = bytearray(sig)
    bad_sig[-1] ^= 1
    sigs = [sig, G2_INFINITY, bytes(bad_sig), G2_INFINITY]
    n, k = 4, 2
    pk_x = torch.zeros((n, k, 12), dtype=torch.int32)
    pk_y = torch.zeros_like(pk_x)
    present = torch.zeros((n, k), dtype=torch.bool)
    for lane, keys in enumerate([[0, 1], [2], [2], []]):
        for j, key in enumerate(keys):
            pk_x[lane, j] = torch.from_numpy(fp.int_to_words(pk_aff[key][0]))
            pk_y[lane, j] = torch.from_numpy(fp.int_to_words(pk_aff[key][1]))
            present[lane, j] = True
    parsed = [parse_g2_wire(s) for s in sigs]
    xb = np.stack([p[0] for p in parsed])
    out = KD.prepare(
        pk_x, pk_y, present,
        torch.from_numpy(fp.bytes_to_words_np(xb[:, 1])),
        torch.from_numpy(fp.bytes_to_words_np(xb[:, 0])),
        torch.tensor([p[1] for p in parsed]),
        torch.tensor([p[2] for p in parsed]),
        torch.tensor([True, True, True, False]))
    pk_jac, sig_jac, lane_ok, miller_mask = out
    assert lane_ok.tolist() == [True, True, False, False]
    assert miller_mask.tolist() == [True, True, True, False]
    agg = C.point_add(C.FQ_OPS, C.from_affine(C.FQ_OPS, *pk_aff[0]),
                      C.from_affine(C.FQ_OPS, *pk_aff[1]))
    got = tuple(fp.words_to_int(pk_jac[0, i]) for i in range(3))
    assert C.point_eq(C.FQ_OPS, got, agg)
    sig_pt = tuple((fp.words_to_int(sig_jac[0, i, 0]),
                    fp.words_to_int(sig_jac[0, i, 1])) for i in range(3))
    assert C.point_eq(C.FQ2_OPS, sig_pt, C.g2_decompress(sig))
    for lane in (1, 2, 3):      # infinity, failed decompression, padding
        assert fp.words_to_int(sig_jac[lane, 2, 0]) == 0
        assert fp.words_to_int(sig_jac[lane, 2, 1]) == 0
