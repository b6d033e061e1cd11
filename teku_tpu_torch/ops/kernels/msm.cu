// msm.cu -- the GLV + Pippenger scalars stage.
//
// Replaces stage_scalars_pippenger (teku_tpu/ops/verify.py:246) and the
// MSM programs it is built from (teku_tpu/ops/msm.py:333-493:
// bucket_accumulate, bucket_reduce, window_combine, g1_grouped_msm,
// g2_lambda_point, g2_msm).  Multipliers arrive as GLV digits: for lane
// i, (2, NWIN) 4-bit digits, MSB first, of k1 (drives P) and k2 (drives
// [lambda]P), r_i = k1 + k2 lambda mod r.
//
//   pass 0  one thread per lane: the Montgomery columns -- the lane's
//           key (infinity where miller_mask is off) and phi of it; the
//           signature and -psi^2 of it
//   pass 1  one thread per (row, window): walk the row's 2G G1 columns
//           into 15 buckets, reduce them by suffix sums
//   pass 2  one thread per row: Horner over the windows, affine, u_mask
//   pass 3  one thread per (segment, window): walk the segment's G2
//           columns into 15 buckets
//   pass 4  one launch per halving level: merge the segment tables
//           pairwise (point_batch_sum's order), per (window, bucket)
//   pass 5  one thread per window: reduce the merged buckets
//   pass 6  one thread: Horner over the windows into wsig
//
// Every column does the same work whatever its digit: the add into the
// target bucket always runs, and digit 0 or an excluded column writes
// it to a 16th discard slot.  The order of every add is the
// reference's, so the outputs equal the plain PyTorch version's word
// for word.
//
// Bound: 32-bit multiply-adds -- per row 2G + 30 G1 adds per window and
// 28 doublings; per G2 column one add per window.

#include "fp381.cuh"

#define MSM_W 4
#define MSM_NWIN 8                  // 32-bit half-scalars in 4-bit digits
#define MSM_B 15                    // buckets per window; slot MSM_B discards

// bucket[digit - 1] += p when digit >= 1 and the column is included
template <class F>
DEV void bucket_add(jac<F>* table, const jac<F>& p, int digit, bool include) {
    unsigned idx = (unsigned)(digit - 1);
    bool hit = include && idx < MSM_B;
    jac<F> added = pt_add(table[hit ? idx : 0], p);
    table[hit ? idx : MSM_B] = added;
}

// sum_b (b + 1) bucket[b] by the top-down suffix sums
template <class F>
DEVNI jac<F> bucket_reduce(const jac<F>* table) {
    jac<F> acc = pt_infinity<F>(), tot = pt_infinity<F>();
    for (int b = MSM_B - 1; b >= 0; b--) {
        acc = pt_add(acc, table[b]);
        tot = pt_add(tot, acc);
    }
    return tot;
}

// Horner over the window sums, MSB first
template <class F>
DEVNI jac<F> window_combine(const jac<F>* wsum) {
    jac<F> acc = wsum[0];
    for (int j = 1; j < MSM_NWIN; j++) {
        for (int k = 0; k < MSM_W; k++) acc = pt_dbl(acc);
        acc = pt_add(acc, wsum[j]);
    }
    return acc;
}

// [lambda]Q = -psi(psi(Q))
DEV g2p g2_lambda(const g2p& q) { return pt_neg(g2_psi(g2_psi(q))); }

DEVNI void msm_columns(long i, const int32_t* pk_jac, const int32_t* sig_jac,
                       const uint8_t* miller_mask, g1p* cols1, g2p* cols2, long n) {
    g1p p = g1_load(pk_jac + 36 * i);
    if (!miller_mask[i]) p = pt_infinity<fp>();
    g1p phi = g1_phi(p);
    g2p q = g2_load(sig_jac + 72 * i);
    g2p lam = g2_lambda(q);
    if (LIVE) {
        cols1[i] = p;
        cols1[n + i] = phi;
        cols2[i] = q;
        cols2[n + i] = lam;
    }
}

// row u = t / NWIN, window j = t % NWIN; column c < G is lane
// group_idx[u][c], column G + c its phi image
DEVNI void g1_window(long t, const g1p* cols1, const int32_t* digits, const int32_t* group_idx,
                     const uint8_t* group_present, int g, g1p* wsum1, long n) {
    long u = t / MSM_NWIN;
    int j = (int)(t % MSM_NWIN);
    g1p table[MSM_B + 1];
    for (int b = 0; b <= MSM_B; b++) table[b] = pt_infinity<fp>();
    for (int c = 0; c < 2 * g; c++) {
        int half = c >= g ? 1 : 0;
        long s = u * g + (c - half * g);
        long lane = group_idx[s];
        bucket_add(table, cols1[half * n + lane], digits[(lane * 2 + half) * MSM_NWIN + j],
                   group_present[s] != 0);
    }
    g1p sum = bucket_reduce(table);
    if (LIVE) wsum1[t] = sum;
}

DEVNI void g1_row(long u, const g1p* wsum1, int32_t* agg, uint8_t* u_mask) {
    g1p acc = window_combine(wsum1 + u * MSM_NWIN);
    if (LIVE) u_mask[u] = pt_is_inf(acc) ? 0 : 1;
    fp x, y;
    g1_to_affine(acc, &x, &y);
    fp_store(agg + 24 * u, x);
    fp_store(agg + 24 * u + 12, y);
}

// segment s = t / NWIN of `seg` columns, window j; column col < n is
// signature col, column n + i is [lambda] signature i
DEVNI void g2_segment(long t, const g2p* cols2, const int32_t* digits, long seg, g2p* tables,
                      long n) {
    long s = t / MSM_NWIN;
    int j = (int)(t % MSM_NWIN);
    g2p table[MSM_B + 1];
    for (int b = 0; b <= MSM_B; b++) table[b] = pt_infinity<fq2>();
    for (long c = 0; c < seg; c++) {
        long col = s * seg + c;
        long half = col >= n ? 1 : 0;
        long lane = col - half * n;
        bucket_add(table, cols2[col], digits[(lane * 2 + half) * MSM_NWIN + j], true);
    }
    if (LIVE)
        for (int b = 0; b < MSM_B; b++) tables[t * MSM_B + b] = table[b];
}

// tables[i] += tables[i + half] for segment i < half, per (window, bucket)
DEVNI void g2_merge(long t, g2p* tables, long half) {
    long k = t + half * MSM_NWIN * MSM_B;
    g2p sum = pt_add(tables[t], tables[k]);
    if (LIVE) tables[t] = sum;
}

DEVNI void g2_window(long j, const g2p* tables, g2p* wsum2) {
    g2p sum = bucket_reduce(tables + j * MSM_B);
    if (LIVE) wsum2[j] = sum;
}

DEVNI void g2_combine(long i, const g2p* wsum2, int32_t* wsig) {
    g2_store(wsig, window_combine(wsum2));
}

#ifdef __CUDACC__
__global__ void msm_columns_kernel(long m, const int32_t* pk_jac, const int32_t* sig_jac,
                                   const uint8_t* miller_mask, g1p* cols1, g2p* cols2, long n) {
    SHELL(m, msm_columns(ix, pk_jac, sig_jac, miller_mask, cols1, cols2, n));
}

__global__ void g1_window_kernel(long m, const g1p* cols1, const int32_t* digits,
                                 const int32_t* group_idx, const uint8_t* group_present, int g,
                                 g1p* wsum1, long n) {
    SHELL(m, g1_window(ix, cols1, digits, group_idx, group_present, g, wsum1, n));
}

__global__ void g1_row_kernel(long m, const g1p* wsum1, int32_t* agg, uint8_t* u_mask) {
    SHELL(m, g1_row(ix, wsum1, agg, u_mask));
}

__global__ void g2_segment_kernel(long m, const g2p* cols2, const int32_t* digits, long seg,
                                  g2p* tables, long n) {
    SHELL(m, g2_segment(ix, cols2, digits, seg, tables, n));
}

__global__ void g2_merge_kernel(long m, g2p* tables, long half) {
    SHELL(m, g2_merge(ix, tables, half));
}

__global__ void g2_window_kernel(long m, const g2p* tables, g2p* wsum2) {
    SHELL(m, g2_window(ix, tables, wsum2));
}

__global__ void g2_combine_kernel(long m, const g2p* wsum2, int32_t* wsig) {
    SHELL(m, g2_combine(ix, wsum2, wsig));
}
#endif

// Scratch (Montgomery points): cols1 2n G1, cols2 2n G2, wsum1 rows x
// NWIN G1, tables S x NWIN x 15 G2 (S = 2n / seg, a power of two), wsum2
// NWIN G2.
extern "C" int scalars_msm(const int32_t* pk_jac, const int32_t* sig_jac, const int32_t* digits,
                           const uint8_t* miller_mask, const int32_t* group_idx,
                           const uint8_t* group_present, int g, void* scratch, int32_t* agg,
                           uint8_t* u_mask, int32_t* wsig, long n, long rows, long seg,
                           void* stream) {
    long nseg = 2 * n / seg;
    g1p* cols1 = (g1p*)scratch;
    g2p* cols2 = (g2p*)(cols1 + 2 * n);
    g1p* wsum1 = (g1p*)(cols2 + 2 * n);
    g2p* tables = (g2p*)(wsum1 + rows * MSM_NWIN);
    g2p* wsum2 = tables + nseg * MSM_NWIN * MSM_B;
    LAUNCH(n, msm_columns, pk_jac, sig_jac, miller_mask, cols1, cols2, n);
    LAUNCH(rows * MSM_NWIN, g1_window, cols1, digits, group_idx, group_present, g, wsum1, n);
    LAUNCH(rows, g1_row, wsum1, agg, u_mask);
    LAUNCH(nseg * MSM_NWIN, g2_segment, cols2, digits, seg, tables, n);
    for (long half = nseg / 2; half >= 1; half /= 2)
        LAUNCH(half * MSM_NWIN * MSM_B, g2_merge, tables, half);
    LAUNCH(MSM_NWIN, g2_window, tables, wsum2);
    LAUNCH(1, g2_combine, wsum2, wsig);
    return 0;
}
