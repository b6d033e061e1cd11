// kzg.cu -- EIP-4844 blob verification and commitments on the card.
//
// kzg_eval replaces eval_blob_kernel (teku_tpu/ops/kzg.py:112): the
// barycentric p(z) = (z^n - 1)/n * sum_i p_i w_i / (z - w_i) of B blobs
// of n Fr evaluations (n a power of two, the roots' count).  The TPU
// program inverts all B * n denominators in one batch; here a grid of
// B * n / EVAL_PER threads strides the points (EVAL_PER per thread), and
// each thread inverts its own EVAL_PER denominators by Montgomery's trick
// (one Fermat inverse), zero denominators mapping to zero as in the
// reference's inv_many.  A second pass sums each blob's partial sums on
// one thread, multiplies by (z^n - 1)/n, and selects p_i when z hit the
// root w_i.  Only the canonical y leaves, so the sum order does not show.
// The roots come in as a tensor built on the host.
//
// kzg_msm replaces msm_kernel (kzg.py:180): sum_i [s_i]P_i over the 4096
// Lagrange points (absent points are infinity) by one 255-bit fixed-window
// ladder per lane, pairwise halving passes (one launch per level), and one
// thread for the affine result and its infinity flag.
//
// kzg_fold replaces fold_pairing_kernel (kzg.py:149): per lane [s_i]P_i by
// the same ladder, masked sums into group a and group b (halving passes
// over both), then one thread per group: the affine sum (group b negated)
// and its Miller loop against [G2, sG2] (pairing.cuh); a last thread
// multiplies the two and runs the final exponentiation == 1.  The two
// affine sums and their infinity flags are outputs too.
//
// Bound: 32-bit multiply-adds.  Per ladder 252 doublings and 78 adds of
// G1; per fold two Miller loops and one final exponentiation, serial.

#include "fp381.cuh"
#include "fr255.cuh"
#include "pairing.cuh"

#define EVAL_PER 16                 // points per thread: n / EVAL_PER partial sums per blob

DEVNI void eval_part(long t, const int32_t* poly, const int32_t* z, const int32_t* roots,
                     fr* part, int32_t* hit, long n) {
    long nt = n / EVAL_PER;
    long b = t / nt;
    long k = t % nt;
    fr zm = fr_load(z + 8 * b);
    fr num[EVAL_PER], den[EVAL_PER], pre[EVAL_PER];
    fr acc = FR_ONE;
    for (int j = 0; j < EVAL_PER; j++) {
        long i = k + j * nt;
        fr w = fr_load(roots + 8 * i);
        num[j] = fr_mul(fr_load(poly + 8 * (b * n + i)), w);
        den[j] = fr_sub(zm, w);
        if (fr_is_zero(den[j])) {       // z == w_i: this term is 0
            hit[b] = (int32_t)i;
            num[j] = fr_zero();
            den[j] = FR_ONE;
        }
        pre[j] = acc;
        acc = fr_mul(acc, den[j]);
    }
    fr inv = fr_inv(acc);               // 1 / (den_0 ... den_last)
    fr sum = fr_zero();
    for (int j = EVAL_PER - 1; j >= 0; j--) {
        sum = fr_add(sum, fr_mul(num[j], fr_mul(inv, pre[j])));
        inv = fr_mul(inv, den[j]);
    }
    part[t] = sum;
}

DEVNI void eval_final(long b, const int32_t* poly, const int32_t* z, const fr* part,
                      const int32_t* hit, int32_t* y, long n) {
    long nt = n / EVAL_PER;
    fr sum = fr_zero();
    for (long k = 0; k < nt; k++) sum = fr_add(sum, part[b * nt + k]);
    fr zn = fr_load(z + 8 * b), inv_n = FR_ONE;
    for (long m = 1; m < n; m <<= 1) {                     // z^n and 1/n
        zn = fr_sqr(zn);
        inv_n = fr_mul(inv_n, FR_INV_2);
    }
    fr out = fr_mul(sum, fr_mul(fr_sub(zn, FR_ONE), inv_n));
    if (hit[b] >= 0) out = fr_load(poly + 8 * (b * n + hit[b]));
    fr_store(y + 8 * b, out);
}

#ifdef __CUDACC__
__global__ void eval_part_kernel(long m, const int32_t* poly, const int32_t* z,
                                 const int32_t* roots, fr* part, int32_t* hit, long n) {
    long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t < m) eval_part(t, poly, z, roots, part, hit, n);
}

__global__ void eval_final_kernel(long m, const int32_t* poly, const int32_t* z,
                                  const fr* part, const int32_t* hit, int32_t* y, long n) {
    long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b < m) eval_final(b, poly, z, part, hit, y, n);
}
#endif

// poly (B, n, 8), z (B, 8), roots (n, 8): canonical plain words, n a
// power of two >= EVAL_PER; scratch part (B * n / EVAL_PER Fr), hit (B,)
// preset to -1; y (B, 8) out
extern "C" int kzg_eval(const int32_t* poly, const int32_t* z, const int32_t* roots,
                        void* part, int32_t* hit, int32_t* y, long nblobs, long n,
                        void* stream) {
    LAUNCH(nblobs * (n / EVAL_PER), eval_part, poly, z, roots, (fr*)part, hit, n);
    LAUNCH(nblobs, eval_final, poly, z, (const fr*)part, hit, y, n);
    return 0;
}

// [s]P for a scalar of 8 little-endian words: the reference's 4-bit
// fixed-window ladder (points.py:scalar_mul_bits over 256 bits) -- table by
// successive adds from infinity, then per digit four doubles and one add
DEVNI g1p g1_mul_words(const g1p& p, const uint32_t* s) {
    g1p table[16];
    table[0] = pt_infinity<fp>();
    for (int k = 1; k < 16; k++) table[k] = pt_add(table[k - 1], p);
    g1p acc = table[s[7] >> 28];
    for (int d = 62; d >= 0; d--) {
        for (int j = 0; j < 4; j++) acc = pt_dbl(acc);
        acc = pt_add(acc, table[(s[d >> 3] >> (4 * (d & 7))) & 15]);
    }
    return acc;
}

DEV g1p g1_affine_load(const int32_t* xs, const int32_t* ys, long i, bool use) {
    g1p p = pt_infinity<fp>();
    if (use) {
        p.x = fp_load(xs + 12 * i);
        p.y = fp_load(ys + 12 * i);
        p.z = K_ONE;
    }
    return p;
}

DEV void scalar_load(const int32_t* scalars, long i, uint32_t* s) {
    for (int j = 0; j < 8; j++) s[j] = (uint32_t)scalars[8 * i + j];
}

// one halving level over `groups` arrays of stride n: x[j] += x[j + off], j < half
DEVNI void g1_sum_pass(long i, g1p* x, long n, long half, long off) {
    g1p* g = x + (i / half) * n;
    long j = i % half;
    g[j] = pt_add(g[j], g[j + off]);
}

DEVNI void msm_lane(long i, const int32_t* xs, const int32_t* ys, const uint8_t* present,
                    const int32_t* scalars, g1p* acc) {
    uint32_t s[8];
    scalar_load(scalars, i, s);
    acc[i] = g1_mul_words(g1_affine_load(xs, ys, i, present[i] != 0), s);
}

DEVNI void msm_out(long i, const g1p* acc, uint8_t* inf, int32_t* xy) {
    fp x, y;
    g1_to_affine(acc[0], &x, &y);       // infinity -> (0, 0)
    fp_store(xy, x);
    fp_store(xy + 12, y);
    inf[0] = pt_is_inf(acc[0]) ? 1 : 0;
}

DEVNI void fold_lane(long i, const int32_t* xs, const int32_t* ys, const uint8_t* inf,
                     const uint8_t* valid, const uint8_t* group_b, const int32_t* scalars,
                     g1p* acc, long n) {
    uint32_t s[8];
    scalar_load(scalars, i, s);
    g1p w = g1_mul_words(g1_affine_load(xs, ys, i, valid[i] && !inf[i]), s);
    bool in_b = group_b[i] != 0;
    acc[i] = valid[i] && !in_b ? w : pt_infinity<fp>();
    acc[n + i] = valid[i] && in_b ? w : pt_infinity<fp>();
}

// group g's sum (b negated) to affine, and its Miller loop against g2[g]
DEVNI void fold_pair(long g, const g1p* acc, long n, const int32_t* g2, int32_t* pair,
                     uint8_t* pair_inf, fq12* ml) {
    g1p s = acc[g * n];
    if (g == 1) s = pt_neg(s);
    bool is_inf = pt_is_inf(s);
    fp x, y;
    g1_to_affine(s, &x, &y);
    fp_store(pair + 24 * g, x);
    fp_store(pair + 24 * g + 12, y);
    pair_inf[g] = is_inf ? 1 : 0;
    fq12 f = fq12_one();
    if (!is_inf) f = miller_loop(x, y, fq2_load(g2 + 48 * g), fq2_load(g2 + 48 * g + 24));
    ml[g] = f;
}

DEVNI void fold_verdict(long i, const fq12* ml, uint8_t* ok) {
    ok[0] = fq12_is_one(final_exponentiation(fq12_mul(ml[0], ml[1]))) ? 1 : 0;
}

#ifdef __CUDACC__
__global__ void g1_sum_pass_kernel(long m, g1p* x, long n, long half, long off) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < m) g1_sum_pass(i, x, n, half, off);
}

__global__ void msm_lane_kernel(long n, const int32_t* xs, const int32_t* ys,
                                const uint8_t* present, const int32_t* scalars, g1p* acc) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) msm_lane(i, xs, ys, present, scalars, acc);
}

__global__ void msm_out_kernel(long n, const g1p* acc, uint8_t* inf, int32_t* xy) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) msm_out(i, acc, inf, xy);
}

__global__ void fold_lane_kernel(long m, const int32_t* xs, const int32_t* ys,
                                 const uint8_t* inf, const uint8_t* valid,
                                 const uint8_t* group_b, const int32_t* scalars, g1p* acc,
                                 long n) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < m) fold_lane(i, xs, ys, inf, valid, group_b, scalars, acc, n);
}

__global__ void fold_pair_kernel(long m, const g1p* acc, long n, const int32_t* g2,
                                 int32_t* pair, uint8_t* pair_inf, fq12* ml) {
    long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g < m) fold_pair(g, acc, n, g2, pair, pair_inf, ml);
}

__global__ void fold_verdict_kernel(long m, const fq12* ml, uint8_t* ok) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < m) fold_verdict(i, ml, ok);
}
#endif

// xs, ys (n, 12) affine words, present (n,), scalars (n, 8) words;
// scratch n G1 points; inf (1,), xy (2, 12) out
extern "C" int kzg_msm(const int32_t* xs, const int32_t* ys, const uint8_t* present,
                       const int32_t* scalars, void* scratch, uint8_t* inf, int32_t* xy,
                       long n, void* stream) {
    g1p* acc = (g1p*)scratch;
    LAUNCH(n, msm_lane, xs, ys, present, scalars, acc);
    for (long m = n; m > 1; m -= m / 2) LAUNCH(m / 2, g1_sum_pass, acc, n, m / 2, m - m / 2);
    LAUNCH(1, msm_out, (const g1p*)acc, inf, xy);
    return 0;
}

// xs, ys (n, 12) affine words; inf, valid, group_b (n,); scalars (n, 8);
// g2 (2, 2, 2, 12): [G2, sG2] affine (x, y) x (c0, c1) words; scratch
// 2n G1 points + 2 Fq12; ok (1,), pair (2, 2, 12), pair_inf (2,) out
extern "C" int kzg_fold(const int32_t* xs, const int32_t* ys, const uint8_t* inf,
                        const uint8_t* valid, const uint8_t* group_b, const int32_t* scalars,
                        const int32_t* g2, void* scratch, uint8_t* ok, int32_t* pair,
                        uint8_t* pair_inf, long n, void* stream) {
    g1p* acc = (g1p*)scratch;
    fq12* ml = (fq12*)(acc + 2 * n);
    LAUNCH(n, fold_lane, xs, ys, inf, valid, group_b, scalars, acc, n);
    for (long m = n; m > 1; m -= m / 2)
        LAUNCH(2 * (m / 2), g1_sum_pass, acc, n, m / 2, m - m / 2);
    LAUNCH(2, fold_pair, (const g1p*)acc, n, g2, pair, pair_inf, ml);
    LAUNCH(1, fold_verdict, (const fq12*)ml, ok);
    return 0;
}
