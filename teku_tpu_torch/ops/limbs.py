"""fp381 limb arithmetic in plain PyTorch, mirroring teku_tpu/ops/limbs.py.

The base field Fq of BLS12-381 as 15 signed lazy limbs of 26 bits in
int64 lanes, Montgomery form with R = 2^390 -- the same representation,
the same lazy-reduction contract (``units(a)*units(b) <= 64``) and the
same carry scans as the JAX engine, so every value here equals the
reference's value bit for bit.  Torch's int64 ``>>`` is arithmetic and
``&`` is two's-complement, as in jnp.

This is the plain version of the port: the CPU path, and the yardstick
the CUDA kernels (ops/kernels/) are held against on the card.  Both of
the reference's Montgomery products are here: the limb product
(``mont_mul_vpu``) and the int8 digit product (``mont_mul_mxu``,
ops/mxu.py); ``mont_mul`` takes the engine of this thread.  The
kernels use another layout (12 x 32-bit words, R = 2^384), so values
cross between the two only as canonical plain words; every conversion
lives at the bottom of this module:

- ``from_reference`` / ``to_reference``: reference numpy limb arrays
  <-> port tensors (nested tuples of arrays allowed);
- ``to_words`` / ``from_words``: Montgomery limbs <-> canonical plain
  12 x 32-bit words (int32 bit patterns), the kernels' interface;
- ``bytes_to_words_np`` / ``int_to_words`` / ``ints_to_words``: wire
  bytes / ints -> words; ``words_to_bits`` for scalars;
- ``limbs_to_words`` / ``words_to_limbs``: the packing itself, for any
  limb count (the Fr field of ops/modfield.py converts through it).
"""

import numpy as np
import torch

from ..crypto.bls.constants import P
from . import mxu as _mxu

W = 26
L = 15
MASK = (1 << W) - 1
RADIX = 1 << W

R_MOD_P = (1 << (W * L)) % P
R2_MOD_P = (R_MOD_P * R_MOD_P) % P
N0INV = (-pow(P, -1, RADIX)) % RADIX


def int_to_limbs(x: int) -> np.ndarray:
    """Host: python int -> canonical limb vector (NOT Montgomery form)."""
    if not 0 <= x < (1 << (W * L)):
        raise ValueError("value out of limb range")
    return np.array([(x >> (W * i)) & MASK for i in range(L)], dtype=np.int64)


def limbs_to_int(a) -> int:
    """Host: (possibly lazy, signed) limb vector -> python int mod P."""
    a = np.asarray(a.cpu() if torch.is_tensor(a) else a)
    return sum(int(a[..., i]) << (W * i) for i in range(L)) % P


P_LIMBS = int_to_limbs(P)
ONE_MONT = int_to_limbs(R_MOD_P)
R2_LIMBS = int_to_limbs(R2_MOD_P)


def int_to_mont(x: int) -> np.ndarray:
    return int_to_limbs((x % P) * R_MOD_P % P)


def mont_to_int(a) -> int:
    return limbs_to_int(a) * pow(R_MOD_P, -1, P) % P


# --------------------------------------------------------------------------
# Constants on the caller's device (cached per device)
# --------------------------------------------------------------------------

_CONST_CACHE: dict = {}


def const(arr: np.ndarray, device) -> torch.Tensor:
    """A host numpy constant as an int64 tensor on `device` (cached)."""
    key = (id(arr), str(device))
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(np.asarray(arr), dtype=torch.int64,
                            device=device)
        _CONST_CACHE[key] = (t, arr)   # arr kept alive: id() stays unique
        return t
    return t[0]


def bcast(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return const(arr, like.device).expand(like.shape)


# --------------------------------------------------------------------------
# Lazy elementwise ops
# --------------------------------------------------------------------------

def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def neg(a):
    return -a


def double(a):
    return a + a


def select(cond, a, b):
    """cond True -> a, else b; cond has the batch shape."""
    return torch.where(cond[..., None], a, b)


# --------------------------------------------------------------------------
# Carry machinery
# --------------------------------------------------------------------------

def compress(r):
    """One signed carry scan; the final carry folds into the top limb."""
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
    """(a - b) limbwise with sequential borrow; canonical inputs.
    Returns (diff, borrow): borrow 0 if a >= b else -1."""
    a, b = torch.broadcast_tensors(a, b)
    ac, bc = a.unbind(-1), b.unbind(-1)
    c = torch.zeros_like(ac[0])
    out = []
    for x, y in zip(ac, bc):
        v = x - y + c
        c = v >> W
        out.append(v & MASK)
    return torch.stack(out, dim=-1), c


def _cond_sub_p(a):
    d, borrow = _sub_with_borrow(a, const(P_LIMBS, a.device))
    return torch.where((borrow != 0)[..., None], a, d)


def gt(a, b):
    """a > b as integers; both inputs truly canonical."""
    _, borrow = _sub_with_borrow(b, a)
    return borrow != 0


# --------------------------------------------------------------------------
# Montgomery multiplication
# --------------------------------------------------------------------------

_COL_IDX: dict = {}


def _col_index(device):
    idx = _COL_IDX.get(str(device))
    if idx is None:
        idx = torch.tensor([i + j for i in range(L) for j in range(L)],
                           dtype=torch.int64, device=device)
        _COL_IDX[str(device)] = idx
    return idx


def _mont_reduce(t):
    """Word-serial Montgomery reduction of 2L product columns, then
    compress.  Output value in (-P, 2P), bit-identical to the
    reference's scan (columns shift left one limb per step)."""
    t = t.clone()
    p = const(P_LIMBS, t.device)
    for _ in range(L):
        m = ((t[..., 0] & MASK) * N0INV) & MASK
        t[..., :L] += m[..., None] * p
        c = t[..., 0] >> W
        t = t[..., 1:]
        t[..., 0] += c
    return compress(t)


def mont_mul_vpu(a, b):
    """Montgomery product a*b*R^-1: one unit out, value in (-P, 2P).
    Column sums are exact integers, so summing the outer product by
    column index gives the reference's columns bit for bit."""
    a, b = torch.broadcast_tensors(a, b)
    outer = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(
        a.shape[:-1] + (L * L,))
    t = torch.zeros(a.shape[:-1] + (2 * L,), dtype=torch.int64,
                    device=a.device)
    t.index_add_(-1, _col_index(a.device), outer)
    return _mont_reduce(t)


def mont_sqr_vpu(a):
    return mont_mul_vpu(a, a)


# the digit engine: same operand contract, same _mont_reduce, product
# columns as int8 digit outer products (ops/mxu.py)
mont_mul_mxu, mont_sqr_mxu = _mxu.make_digit_kernels(
    L, W, P.bit_length(), compress, _mont_reduce)


def mont_mul(a, b):
    """Montgomery product via the engine of this thread (ops/mxu.py:
    pinned by ``mxu.engine``, else the configured path's)."""
    if _mxu.active():
        return mont_mul_mxu(a, b)
    return mont_mul_vpu(a, b)


def mont_sqr(a):
    if _mxu.active():
        return mont_sqr_mxu(a)
    return mont_sqr_vpu(a)


def to_mont(a):
    return mont_mul(a, const(R2_LIMBS, a.device))


# --------------------------------------------------------------------------
# Canonical representatives
# --------------------------------------------------------------------------

def canonical_unit(y):
    """The limbs of y mod P in [0, P), for a product's y in (-P, 2P)."""
    y = compress(y + const(P_LIMBS, y.device))
    return _cond_sub_p(_cond_sub_p(y))


def canonical(a):
    """THE canonical limbs of (a*R) mod P: decides equality/zero-ness."""
    return canonical_unit(mont_mul(a, const(R2_LIMBS, a.device)))


_ONE_PLAIN = int_to_limbs(1)


def canonical_plain(a):
    """Exact canonical plain (non-Montgomery) limbs of a Montgomery unit."""
    return canonical_unit(mont_mul(a, const(_ONE_PLAIN, a.device)))


def is_zero(a):
    return torch.all(canonical(a) == 0, dim=-1)


def eq(a, b):
    return is_zero(a - b)


def from_mont(a):
    return canonical_plain(a)


# --------------------------------------------------------------------------
# Static-exponent powers, inversion, square roots
# --------------------------------------------------------------------------

POW_WINDOW = 4


def pow_static(a, e: int, window: int = POW_WINDOW):
    """a^e for a static exponent: the reference's fixed-window chain
    (table by successive multiplies, w squarings + one mul per digit)."""
    if e == 0:
        return bcast(ONE_MONT, a)
    if e.bit_length() <= window:
        acc = a
        for bit in bin(e)[3:]:
            acc = mont_sqr(acc)
            if bit == "1":
                acc = mont_mul(acc, a)
        return acc
    n_digits = (e.bit_length() + window - 1) // window
    digits = [(e >> (window * i)) & ((1 << window) - 1)
              for i in range(n_digits)][::-1]
    table = [bcast(ONE_MONT, a)]
    for _ in range((1 << window) - 1):
        table.append(mont_mul(table[-1], a))
    acc = table[digits[0]]
    for d in digits[1:]:
        for _ in range(window):
            acc = mont_sqr(acc)
        acc = mont_mul(acc, table[d])
    return acc


def inv(a):
    """Fermat inverse; inv(0) == 0."""
    return pow_static(a, P - 2)


def inv_many(a):
    """Batched inverse by Montgomery's trick: one Fermat exponentiation
    for the whole batch; zero lanes map to zero."""
    shape = a.shape
    flat = a.reshape(-1, L)
    m = flat.shape[0]
    if m == 1:
        return inv(flat).reshape(shape)
    zero = is_zero(flat)
    one = bcast(ONE_MONT, flat)
    safe = torch.where(zero[:, None], one, flat)
    pre = [safe[0]]
    for i in range(1, m):
        pre.append(mont_mul(pre[-1], safe[i]))
    tinv = inv(pre[-1][None])[0]
    out = [None] * m
    acc = tinv                      # inverse of the prefix product
    for i in range(m - 1, 0, -1):
        out[i] = mont_mul(acc, pre[i - 1])
        acc = mont_mul(acc, safe[i])
    out[0] = acc
    out = torch.stack(out, dim=0)
    out = torch.where(zero[:, None], torch.zeros_like(out), out)
    return out.reshape(shape)


def sqrt_candidate(a):
    """a^((P+1)/4): the root when a is a QR.  Caller checks cand^2 == a."""
    return pow_static(a, (P + 1) // 4)


# --------------------------------------------------------------------------
# Conversions: reference arrays, canonical 32-bit words, wire bytes
# --------------------------------------------------------------------------

NW = 12          # 32-bit words per element in the kernels' layout


def tree_map(fn, t):
    """Map over the leaves of nested tuples (Fq2/Fq6/Fq12, points)."""
    if isinstance(t, (tuple, list)):
        return tuple(tree_map(fn, x) for x in t)
    return fn(t)


def tree_map2(fn, a, b):
    if isinstance(a, (tuple, list)):
        return tuple(tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def from_reference(x, device="cpu"):
    """Reference numpy (or jax) limb arrays -> port tensors."""
    return tree_map(lambda v: torch.as_tensor(
        np.array(v), device=device), x)


def to_reference(t):
    """Port tensors -> numpy arrays (the reference's layout)."""
    return tree_map(lambda v: v.detach().cpu().numpy(), t)


def limbs_to_words(c, n_words: int = NW):
    """Canonical plain limbs (..., n) int64 -> (..., n_words) int64 in
    [0, 2^32).  Any limb count of width W (Fq here, Fr in ops/modfield.py)."""
    cols = c.unbind(-1)
    words = []
    for j in range(n_words):
        bit = 32 * j
        acc = torch.zeros_like(cols[0])
        i, s = divmod(bit, W)
        shift = -s
        while shift < 32 and i < len(cols):
            acc = acc | ((cols[i] << shift) if shift >= 0
                         else (cols[i] >> -shift))
            i += 1
            shift += W
        words.append(acc & 0xFFFFFFFF)
    return torch.stack(words, dim=-1)


def words_to_limbs(w, n_limbs: int = L):
    """(..., n) int64 words in [0, 2^32) -> plain limbs (..., n_limbs)."""
    cols = w.unbind(-1)
    limbs = []
    for i in range(n_limbs):
        bit = W * i
        acc = torch.zeros_like(cols[0])
        j, s = divmod(bit, 32)
        shift = -s
        while shift < W and j < len(cols):
            acc = acc | ((cols[j] << shift) if shift >= 0
                         else (cols[j] >> -shift))
            j += 1
            shift += 32
        limbs.append(acc & MASK)
    return torch.stack(limbs, dim=-1)


def words_i32(w64):
    """[0, 2^32) int64 words -> int32 bit patterns."""
    return (w64 - ((w64 >> 31) << 32)).to(torch.int32)


def words_u(w32):
    """int32 bit patterns -> [0, 2^32) int64 words."""
    return w32.to(torch.int64) & 0xFFFFFFFF


def to_words(a):
    """Montgomery limbs (lazy) -> canonical plain int32 words (..., NW)."""
    return words_i32(limbs_to_words(canonical_plain(a)))


def from_words(w):
    """Canonical plain int32 words (..., NW) -> Montgomery limbs."""
    return to_mont(words_to_limbs(words_u(w)))


def plain_limbs_from_words(w):
    """int32 words -> plain (non-Montgomery) limbs, e.g. a wire x."""
    return words_to_limbs(words_u(w))


def int_to_words(x: int) -> np.ndarray:
    """Host: python int in [0, 2^384) -> (NW,) int32 words."""
    return np.array([(x >> (32 * j)) & 0xFFFFFFFF for j in range(NW)],
                    dtype=np.uint32).view(np.int32)


def ints_to_words(vals, n_words: int) -> np.ndarray:
    """Host: python ints -> (len, n_words) int32 words (one to_bytes each)."""
    raw = b"".join(int(v).to_bytes(4 * n_words, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").view(np.int32).reshape(
        len(vals), n_words).copy()


def words_to_int(w) -> int:
    w = np.asarray(w.cpu() if torch.is_tensor(w) else w).astype(np.int64)
    return sum((int(w[..., j]) & 0xFFFFFFFF) << (32 * j)
               for j in range(w.shape[-1]))


def words_to_bits(w, nbits: int):
    """int32 words (..., n) of unsigned scalars -> (..., nbits) int64 bits,
    MSB first (the low nbits bits)."""
    u = words_u(w)
    bits = (u[..., None] >> torch.arange(32, device=w.device)) & 1
    bits = bits.reshape(w.shape[:-1] + (32 * w.shape[-1],))
    return bits[..., :nbits].flip(-1)


def bytes_to_words_np(b: np.ndarray) -> np.ndarray:
    """Big-endian byte matrix (N, 4 n) -> (N, n) int32 little-endian
    words (vectorized wire parse: 48-byte Fq, 32-byte Fr)."""
    le = np.ascontiguousarray(b[:, ::-1]).astype(np.uint8)
    return le.view("<u4").view(np.int32).copy()
