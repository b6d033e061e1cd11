"""Generic Montgomery limb field in plain PyTorch, mirroring teku_tpu/ops/modfield.py.

``make_field(modulus)`` builds the lazy-limb engine of ops/limbs.py for
another prime: signed 26-bit limbs in int64 lanes, R = 2^(26 L), the
same contracts (lazy add/sub/neg, ``mont_mul`` of bounded operands
emits one compressed unit with value in (-M, 2M), ``canonical`` decides
equality) and the same carry scans, so every value equals the
reference's bit for bit.  Both of the reference's multipliers are here:
the limb product (``mont_mul_vpu``) and the int8 digit product
(``mont_mul_mxu``, ops/mxu.py); ``mont_mul`` takes the engine of this
thread, as the reference's takes the configured path.

``inv_many`` is Montgomery's trick over log-depth prefix and suffix
products (the reference's two associative scans); its canonical values
equal the reference's, its lazy limbs may not.

First client: the BLS12-381 scalar field ``FR`` (L = 10), for KZG blob
evaluation.  The kernels take canonical plain 32-bit words
(``to_words`` / ``from_words``, 8 per Fr element); the packing lives in
ops/limbs.py with the Fq conversions.
"""

from types import SimpleNamespace

import numpy as np
import torch

from ..crypto.bls.constants import R
from . import limbs as fp
from . import mxu as _mxu


def make_field(modulus: int, name: str = "field") -> SimpleNamespace:
    W = fp.W                        # 26-bit limbs, as the Fq engine's
    L = (modulus.bit_length() + W - 1) // W
    NW = (modulus.bit_length() + 31) // 32
    MASK = (1 << W) - 1
    RADIX = 1 << W
    M = modulus
    R_MOD = (1 << (W * L)) % M
    R2_MOD = (R_MOD * R_MOD) % M
    N0INV = (-pow(M, -1, RADIX)) % RADIX

    def int_to_limbs(x: int) -> np.ndarray:
        if not 0 <= x < (1 << (W * L)):
            raise ValueError("value out of limb range")
        return np.array([(x >> (W * i)) & MASK for i in range(L)],
                        dtype=np.int64)

    def limbs_to_int(a) -> int:
        a = np.asarray(a.cpu() if torch.is_tensor(a) else a)
        return sum(int(a[..., i]) << (W * i) for i in range(L)) % M

    M_LIMBS = int_to_limbs(M)
    ONE_MONT = int_to_limbs(R_MOD)
    R2_LIMBS = int_to_limbs(R2_MOD)
    ONE_PLAIN = int_to_limbs(1)

    def int_to_mont(x: int) -> np.ndarray:
        return int_to_limbs((x % M) * R_MOD % M)

    def mont_to_int(a) -> int:
        return limbs_to_int(a) * pow(R_MOD, -1, M) % M

    def const(arr, like):
        return fp.const(arr, like.device)

    def select(cond, a, b):
        return torch.where(cond[..., None], a, b)

    def compress(r):
        cols = r.unbind(-1)
        c = torch.zeros_like(cols[0])
        out = []
        for col in cols:
            v = col + c
            c = v >> W
            out.append(v & MASK)
        out[L - 1] = out[L - 1] + c * RADIX
        return torch.stack(out, dim=-1)

    def _sub_with_borrow(a, b):
        a, b = torch.broadcast_tensors(a, b)
        c = torch.zeros_like(a[..., 0])
        out = []
        for x, y in zip(a.unbind(-1), b.unbind(-1)):
            v = x - y + c
            c = v >> W
            out.append(v & MASK)
        return torch.stack(out, dim=-1), c

    def _cond_sub_m(a):
        d, borrow = _sub_with_borrow(a, const(M_LIMBS, a))
        return torch.where((borrow != 0)[..., None], a, d)

    col_idx = {}

    def _col_index(device):
        idx = col_idx.get(str(device))
        if idx is None:
            idx = col_idx[str(device)] = torch.tensor(
                [i + j for i in range(L) for j in range(L)],
                dtype=torch.int64, device=device)
        return idx

    def _mont_reduce(t):
        # the reference's scan: columns shift left one limb per step
        t = t.clone()
        m_limbs = const(M_LIMBS, t)
        for _ in range(L):
            m = ((t[..., 0] & MASK) * N0INV) & MASK
            t[..., :L] += m[..., None] * m_limbs
            c = t[..., 0] >> W
            t = t[..., 1:]
            t[..., 0] += c
        return compress(t)

    def mont_mul_vpu(a, b):
        # exact column sums of the outer product: the reference's columns
        a, b = torch.broadcast_tensors(a, b)
        outer = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(
            a.shape[:-1] + (L * L,))
        t = torch.zeros(a.shape[:-1] + (2 * L,), dtype=torch.int64,
                        device=a.device)
        t.index_add_(-1, _col_index(a.device), outer)
        return _mont_reduce(t)

    def mont_sqr_vpu(a):
        return mont_mul_vpu(a, a)

    mont_mul_mxu, mont_sqr_mxu = _mxu.make_digit_kernels(
        L, W, M.bit_length(), compress, _mont_reduce)

    def mont_mul(a, b):
        if _mxu.active():
            return mont_mul_mxu(a, b)
        return mont_mul_vpu(a, b)

    def mont_sqr(a):
        if _mxu.active():
            return mont_sqr_mxu(a)
        return mont_sqr_vpu(a)

    def to_mont(a):
        return mont_mul(a, const(R2_LIMBS, a))

    def canonical_unit(y):
        """The limbs of y mod M in [0, M), for a product's y in (-M, 2M)."""
        y = compress(y + const(M_LIMBS, y))
        return _cond_sub_m(_cond_sub_m(y))

    def canonical(a):
        return canonical_unit(mont_mul(a, const(R2_LIMBS, a)))

    def canonical_plain(a):
        return canonical_unit(mont_mul(a, const(ONE_PLAIN, a)))

    def is_zero(a):
        return torch.all(canonical(a) == 0, dim=-1)

    def pow_static(a, e: int):
        """a^e: square-and-multiply from the top bit, as the reference."""
        if e == 0:
            return const(ONE_MONT, a).expand(a.shape)
        acc = a
        for bit in bin(e)[3:]:
            acc = mont_sqr(acc)
            if bit == "1":
                acc = mont_mul(acc, a)
        return acc

    def inv(a):
        return pow_static(a, M - 2)

    def _scan(x):
        """Inclusive prefix products along dim 0, log depth."""
        off = 1
        while off < x.shape[0]:
            x = torch.cat([x[:off], mont_mul(x[off:], x[:-off])], dim=0)
            off *= 2
        return x

    def inv_many(a):
        shape = a.shape
        flat = a.reshape(-1, L)
        if flat.shape[0] == 1:
            return inv(flat).reshape(shape)
        zero = is_zero(flat)
        one = const(ONE_MONT, flat).expand(flat.shape)
        safe = torch.where(zero[:, None], one, flat)
        pre = _scan(safe)
        suf = _scan(safe.flip(0)).flip(0)
        tinv = inv(pre[-1:])
        left = torch.cat([one[:1], pre[:-1]], dim=0)
        right = torch.cat([suf[1:], one[:1]], dim=0)
        out = mont_mul(mont_mul(left, right), tinv)
        out = torch.where(zero[:, None], torch.zeros_like(out), out)
        return out.reshape(shape)

    # the kernels' interface: canonical plain 32-bit words
    def plain_to_words(c):
        return fp.words_i32(fp.limbs_to_words(c, NW))

    def words_to_plain(w):
        return fp.words_to_limbs(fp.words_u(w), L)

    def to_words(a):
        return plain_to_words(canonical_plain(a))

    def from_words(w):
        return to_mont(words_to_plain(w))

    return SimpleNamespace(
        name=name, M=M, W=W, L=L, NW=NW, MASK=MASK,
        int_to_limbs=int_to_limbs, limbs_to_int=limbs_to_int,
        int_to_mont=int_to_mont, mont_to_int=mont_to_int,
        ONE_MONT=ONE_MONT, M_LIMBS=M_LIMBS,
        select=select, compress=compress, mont_mul=mont_mul,
        mont_sqr=mont_sqr, mont_mul_vpu=mont_mul_vpu,
        mont_sqr_vpu=mont_sqr_vpu, mont_mul_mxu=mont_mul_mxu,
        mont_sqr_mxu=mont_sqr_mxu, to_mont=to_mont,
        canonical_unit=canonical_unit, canonical=canonical,
        canonical_plain=canonical_plain, is_zero=is_zero,
        pow_static=pow_static, inv=inv, inv_many=inv_many,
        plain_to_words=plain_to_words, words_to_plain=words_to_plain,
        to_words=to_words, from_words=from_words,
    )


FR = make_field(R, "fr")
