"""Port parity: teku_tpu_torch Fq2/Fq6/Fq12 towers vs the JAX engine.

Same seeded numpy inputs through teku_tpu/ops/towers.py (jitted, at the
shapes tests/test_ops_towers.py compiles, so the compile cache serves
them) and their PyTorch twins: equal limbs where the reference's are
canonical, else equal canonical integers (tolerance: exact).  Also the
port's copies of the oracle constants.
"""

import jax
import numpy as np

from teku_tpu.crypto.bls import fields as F
from teku_tpu.ops import limbs as JL
from teku_tpu.ops import towers as JT
from teku_tpu_torch.crypto.bls.constants import P
from teku_tpu_torch.ops import limbs as fp
from teku_tpu_torch.ops import towers as T
from tests.torch_parity import (as_np, assert_same_bits, assert_same_values,
                                no_aot_store, one_torch_thread)  # noqa: F401

RNG = np.random.default_rng(0x7E4C)


def rand_ints(n):
    return [int.from_bytes(RNG.bytes(48), "big") % P for _ in range(n)]


def mont(vals):
    return np.stack([JL.int_to_mont(v) for v in vals])


def t(x):
    return fp.from_reference(x)


def rand_fq2():
    return tuple(rand_ints(2))


def stack2(vals):
    return (mont([v[0] for v in vals]), mont([v[1] for v in vals]))


def stack6(vals):
    return tuple(stack2([v[i] for v in vals]) for i in range(3))


def stack12(vals):
    return tuple(stack6([v[i] for v in vals]) for i in range(2))


A2 = [rand_fq2() for _ in range(6)] + [(0, 0), (1, 0), (0, 1)]
B2 = [rand_fq2() for _ in range(6)] + [(5, 7), (0, 0), (P - 1, P - 1)]


def test_fq2_ops_match_reference():
    a, b = stack2(A2), stack2(B2)
    assert_same_bits(as_np(jax.jit(JT.fq2_mul)(a, b)), T.fq2_mul(t(a), t(b)))
    assert_same_bits(as_np(jax.jit(JT.fq2_sqr)(a)), T.fq2_sqr(t(a)))
    assert_same_values(as_np(jax.jit(JT.fq2_inv)(a)), T.fq2_inv(t(a)))


def test_fq2_pow_and_sqrt_match_reference():
    vals = [F.fq2_sqr(rand_fq2()) for _ in range(4)]
    while len(vals) < 6:
        c = rand_fq2()
        if F.fq2_sqrt(c) is None:
            vals.append(c)
    vals.append((0, 0))
    a = stack2(vals)
    assert_same_bits(as_np(jax.jit(lambda x: JT.fq2_pow_static(x, 65537))(a)),
                     T.fq2_pow_static(t(a), 65537))
    ok_j, root_j = jax.jit(JT.fq2_sqrt)(a)
    ok_t, root_t = T.fq2_sqrt(t(a))
    assert ok_t.tolist() == np.asarray(ok_j).tolist() == [True] * 4 + [
        False, False, True]
    assert_same_values(as_np(root_j), root_t)


def test_fq6_ops_match_reference():
    A6 = [tuple(rand_fq2() for _ in range(3)) for _ in range(4)] + [
        F.FQ6_ZERO, F.FQ6_ONE]
    B6 = [tuple(rand_fq2() for _ in range(3)) for _ in range(4)] + [
        F.FQ6_ONE, F.FQ6_ZERO]
    a, b = stack6(A6), stack6(B6)
    assert_same_bits(as_np(jax.jit(JT.fq6_mul)(a, b)), T.fq6_mul(t(a), t(b)))
    assert_same_bits(as_np(jax.jit(JT.fq6_sqr)(a)), T.fq6_sqr(t(a)))
    assert_same_values(as_np(jax.jit(JT.fq6_inv)(a)), T.fq6_inv(t(a)))
    assert_same_bits(as_np(jax.jit(JT.fq6_frobenius)(a)),
                     T.fq6_frobenius(t(a)))


def _cyclotomic(f):
    g = F.fq12_mul(F.fq12_conj(f), F.fq12_inv(f))
    return F.fq12_mul(F.fq12_frobenius(g, 2), g)


def test_fq12_ops_match_reference():
    def rand12():
        return tuple(tuple(rand_fq2() for _ in range(3)) for _ in range(2))
    A12 = [rand12() for _ in range(3)] + [F.FQ12_ONE]
    B12 = [rand12() for _ in range(3)] + [F.FQ12_ONE]
    a, b = stack12(A12), stack12(B12)
    assert_same_bits(as_np(jax.jit(JT.fq12_mul)(a, b)), T.fq12_mul(t(a), t(b)))
    assert_same_bits(as_np(jax.jit(JT.fq12_sqr)(a)), T.fq12_sqr(t(a)))
    assert_same_values(as_np(jax.jit(JT.fq12_inv)(a)), T.fq12_inv(t(a)))
    assert_same_bits(as_np(jax.jit(lambda x: JT.fq12_frobenius(x, 1))(a)),
                     T.fq12_frobenius(t(a), 1))
    assert_same_bits(as_np(jax.jit(lambda x: JT.fq12_frobenius(x, 2))(a)),
                     T.fq12_frobenius(t(a), 2))
    cyc = stack12([_cyclotomic(rand12()) for _ in range(3)] + [F.FQ12_ONE])
    assert_same_bits(as_np(jax.jit(JT.fq12_cyclo_sqr)(cyc)),
                     T.fq12_cyclo_sqr(t(cyc)))
    assert T.fq12_is_one(t(cyc)).tolist() == np.asarray(
        jax.jit(JT.fq12_is_one)(cyc)).tolist() == [False] * 3 + [True]
    w = T.fq12_to_words(t(a))
    assert w.shape == (4, 12, fp.NW)
    assert_same_values(a, T.fq12_from_words(w))


def test_oracle_copies_hold_the_reference_constants():
    from teku_tpu.crypto.bls import constants as RC
    from teku_tpu_torch.crypto.bls import constants as PC
    from teku_tpu_torch.crypto.bls import fields as PF
    names = [n for n in dir(RC) if n.isupper()]
    assert names and all(getattr(PC, n) == getattr(RC, n) for n in names)
    assert (PF.FROB6_C1, PF.FROB6_C2, PF.FROB12_C1) == (
        F.FROB6_C1, F.FROB6_C2, F.FROB12_C1)
