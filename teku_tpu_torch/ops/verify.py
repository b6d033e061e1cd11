"""Staged batched BLS verification in plain PyTorch, mirroring teku_tpu/ops/verify.py.

  ok  <=>  prod_u e(sum_{i in u} [r_i]pk_i, H(m_u)) * e(-g1, sum_i [r_i]sig_i) == 1

The stage functions keep the reference's argument contracts (15 x 26
Montgomery limbs, the same masks), so each can be held against its
JAX counterpart: prepare -> h2c (unique width) -> scalars -> group ->
miller -> finish.  ``verify_staged_grouped`` chains them;
``verify_staged_pippenger`` runs the GLV + Pippenger scalars stage
(ops/msm.py) in place of scalars + group; ``verify_staged_hm`` is the
per-lane chain (gathered H(m), lane affine, a Miller row per lane).
The mesh forms take one input tuple per shard (the blocks the
reference's shard_map in_specs cut): each shard reduces to a local
Fq12 product and G2 sum (``shard_partials``), and one finish runs on
the stacked partials.  The kernels in ops/kernels/ compute the same
stages on canonical words; their plain versions call these functions.
"""

import torch

from ..crypto.bls import curve as C
from . import h2c
from . import limbs as fp
from . import msm as MSM
from . import pairing as PR
from . import points as PT
from . import towers as T

_NEG_G1 = C.to_affine(C.FQ_OPS, C.point_neg(C.FQ_OPS, C.G1_GENERATOR))
_NEG_G1_X = fp.int_to_mont(_NEG_G1[0])
_NEG_G1_Y = fp.int_to_mont(_NEG_G1[1])

point_batch_sum = PT.point_batch_sum


def to_affine_g1(p):
    """Batched Jacobian -> affine G1 (one batched inversion)."""
    zinv = fp.inv_many(p[2])
    zinv2 = fp.mont_sqr(zinv)
    t = fp.mont_mul(T._stk(p[0], fp.mont_mul(zinv2, zinv)),
                    T._stk(zinv2, p[1]))
    return (t[..., 0, :], t[..., 1, :])


def _aggregate_lane_pks(pk_xs, pk_ys, pk_present):
    """(N, K, L) padded affine keys -> one Jacobian aggregate per lane."""
    one = fp.bcast(fp.ONE_MONT, pk_xs)
    G1 = PT.G1_KIT
    if pk_xs.shape[-2] == 1:
        pk_jac = (pk_xs[..., 0, :], pk_ys[..., 0, :], one[..., 0, :])
        inf = PT.infinity_like(G1, pk_jac[0])
        pk_jac = PT._select_point(G1, ~pk_present[..., 0], inf, pk_jac)
    else:
        jac = (pk_xs, pk_ys, one)
        inf = PT.infinity_like(G1, pk_xs)
        jac = PT._select_point(G1, pk_present, jac, inf)
        jac = fp.tree_map(lambda x: torch.movedim(x, -2, 0), jac)
        pk_jac = point_batch_sum(G1, jac)
    return pk_jac, PT.is_infinity(G1, pk_jac)


def stage_prepare(pk_xs, pk_ys, pk_present, sig_x_plain, sig_large,
                  sig_inf, lane_valid):
    """Key aggregation + signature decompression / subgroup checks."""
    pk_jac, pk_inf = _aggregate_lane_pks(pk_xs, pk_ys, pk_present)
    dec_ok, sig_pt = PT.g2_recover_y(sig_x_plain, sig_large)
    in_sub = PT.g2_in_subgroup(sig_pt)
    sig_ok = (dec_ok & in_sub) | sig_inf
    use_inf = sig_inf | ~sig_ok | ~lane_valid
    sig_jac = PT._select_point(
        PT.G2_KIT, use_inf, PT.infinity_like(PT.G2_KIT, sig_pt[0]), sig_pt)
    return pk_jac, sig_jac, sig_ok & ~pk_inf, lane_valid & ~pk_inf


def stage_h2c(u0, u1):
    """Hash-to-G2 + cofactor clearing + affine, at unique width."""
    return h2c.to_affine_g2(h2c.hash_to_g2_device(u0, u1))


def stage_gather_hm(hm_uniq, lane_map):
    """The H(m) rows at the given indices: (U, L) affine tree -> (R, L)."""
    idx = lane_map.to(torch.int64)
    return fp.tree_map(lambda x: x[idx], hm_uniq)


def stage_scalars(pk_jac, sig_jac, r_bits):
    """64-bit random-multiplier ladders on G1 and G2 (Jacobian out)."""
    return (PT.scalar_mul_bits(PT.G1_KIT, r_bits, pk_jac),
            PT.scalar_mul_bits(PT.G2_KIT, r_bits, sig_jac))


def stage_lane_affine(pk_r_jac):
    """Per-lane batched G1 affine (the per-lane pipeline)."""
    return to_affine_g1(pk_r_jac)


def stage_group(pk_r_jac, miller_mask, group_idx, group_present):
    """Fold each message row's lanes into one pairing input (bilinearity):
    ((x, y) affine (U, L), u_mask (U,))."""
    G1 = PT.G1_KIT
    inf = PT.infinity_like(G1, pk_r_jac[0])
    masked = PT._select_point(G1, miller_mask, pk_r_jac, inf)
    gidx = group_idx.to(torch.int64)
    grouped = fp.tree_map(lambda x: x[gidx], masked)
    inf_g = PT.infinity_like(G1, grouped[0])
    grouped = PT._select_point(G1, group_present, grouped, inf_g)
    if group_idx.shape[1] == 1:
        agg = fp.tree_map(lambda x: x[:, 0], grouped)
    else:
        agg = point_batch_sum(
            G1, fp.tree_map(lambda x: torch.movedim(x, 1, 0), grouped))
    u_mask = ~PT.is_infinity(G1, agg)
    return to_affine_g1(agg), u_mask


def stage_scalars_pippenger(pk_jac, sig_jac, glv_digits, group_idx,
                            group_present, miller_mask):
    """The MSM replacement of stage_scalars + stage_group: (N, 2, nwin)
    GLV digits in place of r bits, Pippenger MSMs for the per-row G1
    folds and the whole-batch G2 fold.  Returns (agg_aff (U, L),
    u_mask (U,), wsig (1,)-batched Jacobian)."""
    agg = MSM.g1_grouped_msm(pk_jac, glv_digits, group_idx, group_present,
                             miller_mask)
    u_mask = ~PT.is_infinity(PT.G1_KIT, agg)
    wsig = MSM.g2_msm(sig_jac, glv_digits)
    return to_affine_g1(agg), u_mask, wsig


def stage_miller(pk_r_aff, hm_aff, mask):
    return PR.miller_loop(pk_r_aff, hm_aff, mask=mask)


def _finish(ml_prod, s_sum):
    """One Miller loop on (-g1, sum of weighted signatures) and the
    shared final exponentiation."""
    s_inf = PT.is_infinity(PT.G2_KIT, s_sum)
    s_aff = h2c.to_affine_g2(fp.tree_map(lambda x: x[None], s_sum))
    like = s_aff[0][0]
    neg_g1 = (fp.bcast(_NEG_G1_X, like), fp.bcast(_NEG_G1_Y, like))
    ml_s = PR.miller_loop(neg_g1, s_aff, mask=~s_inf[None])
    f = T.fq12_mul(ml_prod, fp.tree_map(lambda x: x[0], ml_s))
    return PR.pairing_check(f)


def stage_finish(ml, wsig):
    """Cross-row product + G2 sum + final exponentiation + verdict."""
    return _finish(PR.batch_product(ml),
                   point_batch_sum(PT.G2_KIT, wsig))


def _lane_work(pk_xs, pk_ys, pk_present, hm_aff, sig_x_plain, sig_large,
               sig_inf, r_bits, lane_valid):
    """The per-lane pipeline downstream of h2c: (ml (N,), wsig (N,),
    lane_ok (N,)), a Miller row per lane."""
    pk_jac, sig_jac, lane_ok, miller_mask = stage_prepare(
        pk_xs, pk_ys, pk_present, sig_x_plain, sig_large, sig_inf,
        lane_valid)
    pk_r_jac, wsig = stage_scalars(pk_jac, sig_jac, r_bits)
    ml = stage_miller(stage_lane_affine(pk_r_jac), hm_aff, miller_mask)
    return ml, wsig, lane_ok


def verify_staged_hm(pk_xs, pk_ys, pk_present, hm_aff, sig_x_plain,
                     sig_large, sig_inf, r_bits, lane_valid):
    """The staged per-lane pipeline, per-lane H(m) points in: (ok, lane_ok)."""
    ml, wsig, lane_ok = _lane_work(pk_xs, pk_ys, pk_present, hm_aff,
                                   sig_x_plain, sig_large, sig_inf, r_bits,
                                   lane_valid)
    return stage_finish(ml, wsig), lane_ok


def verify_staged_grouped(pk_xs, pk_ys, pk_present, hm_uniq, group_idx,
                          group_present, sig_x_plain, sig_large, sig_inf,
                          r_bits, lane_valid):
    """The staged grouped pipeline downstream of h2c: (ok, lane_ok)."""
    pk_jac, sig_jac, lane_ok, miller_mask = stage_prepare(
        pk_xs, pk_ys, pk_present, sig_x_plain, sig_large, sig_inf,
        lane_valid)
    pk_r_jac, wsig = stage_scalars(pk_jac, sig_jac, r_bits)
    agg_aff, u_mask = stage_group(pk_r_jac, miller_mask, group_idx,
                                  group_present)
    ml = stage_miller(agg_aff, hm_uniq, u_mask)
    return stage_finish(ml, wsig), lane_ok


def verify_staged_pippenger(pk_xs, pk_ys, pk_present, hm_uniq, group_idx,
                            group_present, sig_x_plain, sig_large, sig_inf,
                            glv_digits, lane_valid):
    """The staged grouped pipeline with the GLV + Pippenger scalars
    stage: (ok, lane_ok)."""
    pk_jac, sig_jac, lane_ok, miller_mask = stage_prepare(
        pk_xs, pk_ys, pk_present, sig_x_plain, sig_large, sig_inf,
        lane_valid)
    agg_aff, u_mask, wsig = stage_scalars_pippenger(
        pk_jac, sig_jac, glv_digits, group_idx, group_present, miller_mask)
    ml = stage_miller(agg_aff, hm_uniq, u_mask)
    return stage_finish(ml, wsig), lane_ok


def verify_staged(pk_xs, pk_ys, pk_present, u0, u1, group_idx,
                  group_present, sig_x_plain, sig_large, sig_inf, r_bits,
                  lane_valid):
    """Unique-message draws in, (ok, lane_ok) out."""
    return verify_staged_grouped(pk_xs, pk_ys, pk_present, stage_h2c(u0, u1),
                                 group_idx, group_present, sig_x_plain,
                                 sig_large, sig_inf, r_bits, lane_valid)


# --------------------------------------------------------------------------
# Mesh forms: a list of per-shard inputs in, one verdict out
# --------------------------------------------------------------------------

def shard_partials(ml, wsig):
    """A shard's (local Fq12 product, local G2 Jacobian sum).  An
    all-padding shard (every row ONE, every signature infinity) gives
    ONE and infinity: the identity."""
    return PR.batch_product(ml), point_batch_sum(PT.G2_KIT, wsig)


def _stack_leaves(trees):
    first = trees[0]
    if isinstance(first, tuple):
        return tuple(_stack_leaves([t[i] for t in trees])
                     for i in range(len(first)))
    return torch.stack(trees)


def finish_partials(partials):
    """The gathered (product, sum) pairs of every shard -> the verdict:
    _finish(batch_product(products), point_batch_sum(sums))."""
    return stage_finish(_stack_leaves([p for p, _ in partials]),
                        _stack_leaves([s for _, s in partials]))


def verify_sharded_grouped(shards, msm_path: str = "ladder"):
    """The group-aligned mesh form of the grouped pipeline.  ``shards``
    holds one tuple per shard, (pk_xs, pk_ys, pk_present, hm_rows,
    group_idx, group_present, sig_x_plain, sig_large, sig_inf, scalars,
    lane_valid), its group_idx shard-local and its scalars r bits
    (ladder) or GLV digits (pippenger).  Returns (ok, lane_ok) with
    lane_ok in the shard layout's lane order."""
    partials, lane_oks = [], []
    for (pk_xs, pk_ys, pk_present, hm_rows, group_idx, group_present,
         sig_x, sig_large, sig_inf, scalars, lane_valid) in shards:
        pk_jac, sig_jac, lane_ok, miller_mask = stage_prepare(
            pk_xs, pk_ys, pk_present, sig_x, sig_large, sig_inf,
            lane_valid)
        if msm_path == "pippenger":
            agg_aff, u_mask, wsig = stage_scalars_pippenger(
                pk_jac, sig_jac, scalars, group_idx, group_present,
                miller_mask)
        else:
            pk_r_jac, wsig = stage_scalars(pk_jac, sig_jac, scalars)
            agg_aff, u_mask = stage_group(pk_r_jac, miller_mask, group_idx,
                                          group_present)
        ml = stage_miller(agg_aff, hm_rows, u_mask)
        partials.append(shard_partials(ml, wsig))
        lane_oks.append(lane_ok)
    return finish_partials(partials), torch.cat(lane_oks)


def verify_sharded(shards):
    """The legacy lane-sharded form: per shard, (pk_xs, pk_ys,
    pk_present, hm_aff, sig_x_plain, sig_large, sig_inf, r_bits,
    lane_valid) through the per-lane pipeline.  Returns (ok, lane_ok)."""
    partials, lane_oks = [], []
    for args in shards:
        ml, wsig, lane_ok = _lane_work(*args)
        partials.append(shard_partials(ml, wsig))
        lane_oks.append(lane_ok)
    return finish_partials(partials), torch.cat(lane_oks)


def split_shards(tree, n: int):
    """Cut every leaf of a tree of global arrays into n equal blocks along
    the leading axis: [shard 0's tree, ..., shard n-1's tree]."""
    if isinstance(tree, (tuple, list)):
        parts = [split_shards(t, n) for t in tree]
        return [tuple(p[s] for p in parts) for s in range(n)]
    if tree.shape[0] % n:
        raise ValueError(f"leading axis {tree.shape[0]} does not split "
                         f"into {n} shards")
    return list(torch.chunk(tree, n))


def aggregate_points(kit, xs, ys, present):
    """Sum a padded batch of affine points; absent lanes are infinity.
    Returns the Jacobian sum."""
    inf = PT.infinity_like(kit, xs)
    jac = PT._select_point(kit, present, (xs, ys, inf[0]), inf)
    return point_batch_sum(kit, jac)
