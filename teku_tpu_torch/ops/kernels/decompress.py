"""decompress.cu: pubkey validation and the prepare stage.

g1_validate replaces teku_tpu/ops/provider.py:_pk_validate_kernel;
prepare replaces teku_tpu/ops/verify.py:stage_prepare.
"""

import torch

from .. import _build
from .. import limbs as fp
from .. import points as PT
from .. import verify as V
from . import INT, LONG, check_tensor, dispatch, ptr
from . import lib, on_card  # noqa: F401  (looked up by dispatch)


def g1_validate(x, large, engine="cios"):
    """x: (m, 12) canonical plain words of wire x; large: (m,) sign flag.
    Returns (ok (m,), affine x words, affine y words)."""
    m = x.shape[0]
    check_tensor(x, "x", torch.int32, (m, 12), x.device)
    check_tensor(large, "large", torch.bool, (m,), x.device)
    return dispatch(__name__, "g1_validate", "decompress", engine,
                    g1_validate_plain, _run_g1_validate, x, large)


def _run_g1_validate(library, x, large):
    m = x.shape[0]
    ok = torch.empty(m, dtype=torch.bool, device=x.device)
    ox, oy = torch.empty_like(x), torch.empty_like(x)
    _build.check(library.g1_validate(ptr(x), ptr(large), ptr(ok), ptr(ox),
                                     ptr(oy), LONG(m), _build.stream_ptr(x)),
                 "g1_validate")
    return ok, ox, oy


def g1_validate_plain(x, large):
    ok, pt = PT.g1_recover_y(fp.plain_limbs_from_words(x), large)
    ok = ok & PT.g1_in_subgroup(pt)
    return ok, fp.to_words(pt[0]), fp.to_words(pt[1])


def prepare(pk_x, pk_y, pk_present, sig_x0, sig_x1, sig_large, sig_inf,
            lane_valid, engine="cios"):
    """pk_x/pk_y: (n, k, 12) affine key words; pk_present (n, k);
    sig_x0/sig_x1: (n, 12) plain words of the signature's x (c0, c1);
    sig_large, sig_inf, lane_valid: (n,).
    Returns (pk_jac (n, 3, 12), sig_jac (n, 3, 2, 12), lane_ok, miller_mask)."""
    n, k = pk_present.shape
    dev = pk_x.device
    for name, t, dt, shape in (
            ("pk_x", pk_x, torch.int32, (n, k, 12)),
            ("pk_y", pk_y, torch.int32, (n, k, 12)),
            ("pk_present", pk_present, torch.bool, (n, k)),
            ("sig_x0", sig_x0, torch.int32, (n, 12)),
            ("sig_x1", sig_x1, torch.int32, (n, 12)),
            ("sig_large", sig_large, torch.bool, (n,)),
            ("sig_inf", sig_inf, torch.bool, (n,)),
            ("lane_valid", lane_valid, torch.bool, (n,))):
        check_tensor(t, name, dt, shape, dev)
    if k & (k - 1):
        raise ValueError(f"keys per lane {k} is not a power of two")
    return dispatch(__name__, "prepare", "decompress", engine, prepare_plain,
                    _run_prepare, pk_x, pk_y, pk_present, sig_x0, sig_x1,
                    sig_large, sig_inf, lane_valid)


def _run_prepare(library, pk_x, pk_y, pk_present, sig_x0, sig_x1,
                 sig_large, sig_inf, lane_valid):
    n, k = pk_present.shape
    dev = pk_x.device
    scratch = torch.empty(n * k * 36, dtype=torch.int32, device=dev)
    pk_jac = torch.empty((n, 3, 12), dtype=torch.int32, device=dev)
    sig_jac = torch.empty((n, 3, 2, 12), dtype=torch.int32, device=dev)
    lane_ok = torch.empty(n, dtype=torch.bool, device=dev)
    miller_mask = torch.empty(n, dtype=torch.bool, device=dev)
    _build.check(library.prepare(
        ptr(pk_x), ptr(pk_y), ptr(pk_present), INT(k), ptr(sig_x0),
        ptr(sig_x1), ptr(sig_large), ptr(sig_inf), ptr(lane_valid),
        ptr(scratch), ptr(pk_jac), ptr(sig_jac), ptr(lane_ok),
        ptr(miller_mask), LONG(n), _build.stream_ptr(pk_x)), "prepare")
    return pk_jac, sig_jac, lane_ok, miller_mask


def prepare_plain(pk_x, pk_y, pk_present, sig_x0, sig_x1, sig_large,
                  sig_inf, lane_valid):
    sig_x = (fp.plain_limbs_from_words(sig_x0),
             fp.plain_limbs_from_words(sig_x1))
    pk_jac, sig_jac, lane_ok, miller_mask = V.stage_prepare(
        fp.from_words(pk_x), fp.from_words(pk_y), pk_present, sig_x,
        sig_large, sig_inf, lane_valid)
    return (g1_to_words(pk_jac), g2_to_words(sig_jac), lane_ok, miller_mask)


def g1_to_words(p):
    """Tuple of Fq limb tensors (n, L) -> (n, len, 12) words."""
    return fp.to_words(torch.stack(p, dim=-2))


def g2_to_words(p):
    """Tuple of Fq2 limb pairs -> (n, len, 2, 12) words."""
    return fp.to_words(torch.stack([torch.stack(c, dim=-2) for c in p],
                                   dim=-3))


def g1_from_words(w):
    t = fp.from_words(w)
    return tuple(t[..., i, :] for i in range(w.shape[-2]))


def g2_from_words(w):
    t = fp.from_words(w)
    return tuple((t[..., i, 0, :], t[..., i, 1, :])
                 for i in range(w.shape[-3]))
