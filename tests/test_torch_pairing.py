"""Port parity: teku_tpu_torch pairing vs teku_tpu/ops/pairing.py.

Miller loop (masked lanes give one) and final exponentiation on the
same inputs, at the shapes tests/test_ops_pairing.py compiles: Fq12
values bit-identical.  The pairing kernels' plain versions (miller,
finish) against the oracle's pairing check.
"""

import jax
import numpy as np
import torch

from teku_tpu.ops import pairing as JPR
from teku_tpu_torch.crypto.bls import curve as C
from teku_tpu_torch.crypto.bls import fields as F
from teku_tpu_torch.crypto.bls import pairing as OP
from teku_tpu_torch.crypto.bls.constants import R
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops import pairing as PR
from teku_tpu_torch.ops import towers as T
from teku_tpu_torch.ops.kernels import pairing as KP
from tests.torch_parity import (as_np, assert_same_bits,  # noqa: F401
                                no_aot_store, one_torch_thread)

RNG = np.random.default_rng(0xA7E)


def scalar():
    return int.from_bytes(RNG.bytes(32), "big") % (R - 1) + 1


def aff_g1(k):
    return C.to_affine(C.FQ_OPS, C.point_mul(C.FQ_OPS, k, C.G1_GENERATOR))


def aff_g2(k):
    return C.to_affine(C.FQ2_OPS, C.point_mul(C.FQ2_OPS, k, C.G2_GENERATOR))


def stack_p(pts):
    return tuple(np.stack([fp.int_to_mont(p[i]) for p in pts])
                 for i in range(2))


def stack_q(pts):
    return tuple((np.stack([fp.int_to_mont(p[i][0]) for p in pts]),
                  np.stack([fp.int_to_mont(p[i][1]) for p in pts]))
                 for i in range(2))


def fq12_np(v):
    return tuple(tuple(tuple(fp.int_to_mont(c)[None] for c in two)
                       for two in six) for six in v)


def test_miller_loop_bit_identical():
    p = stack_p([aff_g1(scalar()) for _ in range(3)])
    q = stack_q([aff_g2(scalar()) for _ in range(3)])
    ref = jax.jit(JPR.miller_loop)(p, q)
    assert_same_bits(as_np(ref), PR.miller_loop(fp.from_reference(p),
                                                fp.from_reference(q)))


def test_miller_mask_gives_one():
    p = stack_p([aff_g1(5), aff_g1(7)])
    q = stack_q([aff_g2(3), aff_g2(11)])
    got = PR.miller_loop(fp.from_reference(p), fp.from_reference(q),
                         torch.tensor([True, False]))
    assert T.fq12_from_device(got, (1,)) == F.FQ12_ONE
    assert T.fq12_from_device(got, (0,)) == OP.miller_loop(aff_g1(5),
                                                           aff_g2(3))


def test_final_exponentiation_bit_identical():
    ml = OP.miller_loop(aff_g1(scalar()), aff_g2(scalar()))
    dev = fq12_np(ml)
    ref = jax.jit(JPR.final_exponentiation)(dev)
    got = PR.final_exponentiation(fp.from_reference(dev))
    assert_same_bits(as_np(ref), got)
    assert T.fq12_from_device(got, (0,)) == OP.final_exponentiation(ml)


def test_miller_and_finish_plain_decide_bilinearity():
    """e(aP, bQ) * e(-g1, [ab]Q-sum) == 1, and not with a wrong sum."""
    a, b = scalar(), scalar()
    agg = torch.from_numpy(np.stack([np.stack([fp.int_to_words(c) for c in
                                               aff_g1(a)])]))
    q = aff_g2(b)
    hm = torch.from_numpy(np.stack([np.stack([np.stack(
        [fp.int_to_words(c[0]), fp.int_to_words(c[1])]) for c in q])]))
    ml = KP.miller(agg, hm, torch.tensor([True]))
    assert ml.shape == (1, 12, 12)

    def wsig_of(k):
        pt = C.point_mul(C.FQ2_OPS, k, C.G2_GENERATOR)
        return torch.from_numpy(np.stack([np.stack([np.stack(
            [fp.int_to_words(c[0]), fp.int_to_words(c[1])]) for c in pt])]))
    assert KP.finish(ml, wsig_of(a * b % R)).tolist() == [True]
    assert KP.finish(ml, wsig_of(a * b % R + 1)).tolist() == [False]
