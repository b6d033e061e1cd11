// scalars_group.cu -- random-multiplier ladders fused with the per-message fold.
//
// Replaces stage_scalars (teku_tpu/ops/verify.py:200: the 4-bit
// fixed-window 64-bit ladders of points.py:scalar_mul_bits on G1 and G2)
// and stage_group (verify.py:214: the masked per-row G1 fold over the
// (U, G) group index and the batched affine conversion), which the
// reference dispatches as two programs.  Pass 1 runs one thread per
// ladder (N lanes of [r]pk on G1, then N lanes of [r]sig on G2, the same
// table and digit order as the reference); [r]pk stays in a Montgomery
// scratch on the card.  Pass 2 runs one thread per message row: it folds
// the row's present, unmasked lanes and converts the sum to affine
// (affine values are unique, so the fold order does not show).  The
// `scalars` entry runs pass 1 alone for the per-lane pipeline, [r]pk out
// as Jacobian words.
//
// Bound: 32-bit multiply-adds -- 64 doubles and 31 adds per ladder.

#include "fp381.cuh"

// threads per ladder group: n, or under the mma engine n rounded up to a
// warp (the G1 and G2 ladders then never share a warp)
#if MONT_ENGINE_MMA && defined(__CUDACC__)
#define LADDER_HALF(n) (((n) + 31) / 32 * 32)
#else
#define LADDER_HALF(n) (n)
#endif

// [r]pk goes to the Montgomery scratch (scalars_group) or, as Jacobian
// words, to pk_r_words (scalars)
DEVNI void ladder(long i, const int32_t* pk_jac, const int32_t* sig_jac, const int64_t* r,
                  g1p* pk_r, int32_t* pk_r_words, int32_t* wsig, long n) {
    if (i < n) {
        g1p p = pt_mul_u64(g1_load(pk_jac + 36 * i), (uint64_t)r[i]);
        if (pk_r_words) g1_store(pk_r_words + 36 * i, p);
        else if (LIVE) pk_r[i] = p;
    } else {
        long j = i - n;
        g2_store(wsig + 72 * j, pt_mul_u64(g2_load(sig_jac + 72 * j), (uint64_t)r[j]));
    }
}

DEVNI void group_row(long u, const g1p* pk_r, const uint8_t* miller_mask,
                     const int32_t* group_idx, const uint8_t* group_present, int g,
                     int32_t* agg, uint8_t* u_mask) {
    g1p acc = pt_infinity<fp>();
    for (int c = 0; c < g; c++) {
        long s = u * g + c;
        int lane = group_idx[s];
        bool use = group_present[s] && miller_mask[lane];
        WHEN(use) {
            g1p sum = pt_add(acc, pk_r[lane]);
            if (use) acc = sum;
        }
    }
    if (LIVE) u_mask[u] = pt_is_inf(acc) ? 0 : 1;
    fp x, y;
    g1_to_affine(acc, &x, &y);
    fp_store(agg + 24 * u, x);
    fp_store(agg + 24 * u + 12, y);
}

#ifdef __CUDACC__
__global__ void ladder_kernel(long m, const int32_t* pk_jac, const int32_t* sig_jac,
                              const int64_t* r, g1p* pk_r, int32_t* pk_r_words, int32_t* wsig,
                              long n) {
    // G1 ladders on threads [0, m/2), G2 on [m/2, m), m/2 = LADDER_HALF(n):
    // under mma each warp runs ladders of one group
    long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
    bool g2 = t >= m / 2;
    SHELL_AT(g2 ? t - m / 2 : t, n,
             ladder(g2 ? n + ix : ix, pk_jac, sig_jac, r, pk_r, pk_r_words, wsig, n));
}

__global__ void group_row_kernel(long rows, const g1p* pk_r, const uint8_t* miller_mask,
                                 const int32_t* group_idx, const uint8_t* group_present, int g,
                                 int32_t* agg, uint8_t* u_mask) {
    SHELL(rows, group_row(ix, pk_r, miller_mask, group_idx, group_present, g, agg, u_mask));
}
#endif

// pass 1: 2n ladders (G1 then G2); pass 2: one fold per row
extern "C" int scalars_group(const int32_t* pk_jac, const int32_t* sig_jac, const int64_t* r,
                             const uint8_t* miller_mask, const int32_t* group_idx,
                             const uint8_t* group_present, int g, void* scratch, int32_t* agg,
                             uint8_t* u_mask, int32_t* wsig, long n, long rows, void* stream) {
    LAUNCH(2 * LADDER_HALF(n), ladder, pk_jac, sig_jac, r, (g1p*)scratch, (int32_t*)0, wsig, n);
    LAUNCH(rows, group_row, (const g1p*)scratch, miller_mask, group_idx, group_present, g, agg,
           u_mask);
    return 0;
}

// pass 1 alone, [r]pk out as (n, 3, 12) Jacobian words: the per-lane
// pipeline's stage_scalars (verify.py:200, run by _lane_work :88), whose
// lane_affine (shard.cu) follows
extern "C" int scalars(const int32_t* pk_jac, const int32_t* sig_jac, const int64_t* r,
                       int32_t* pk_r, int32_t* wsig, long n, void* stream) {
    LAUNCH(2 * LADDER_HALF(n), ladder, pk_jac, sig_jac, r, (g1p*)0, pk_r, wsig, n);
    return 0;
}
