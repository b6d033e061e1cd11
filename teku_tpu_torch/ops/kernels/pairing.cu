// pairing.cu -- Miller loops per message row, then the batch verdict.
//
// miller replaces stage_miller (teku_tpu/ops/verify.py:266): the
// optimal-ate Miller loop with the reference's doubling / addition line
// formulas (pairing.py:_dbl_step, _add_step) and sparse line multiply
// (_mul_by_line), so row values equal the reference's.  One thread per row.
//
// finish replaces stage_finish (verify.py:272, _finish :112).  The TPU
// program reduces all rows in one dispatch; blocks on Hopper run in no
// order, so the cross-row Fq12 product and the sum of the weighted
// signatures run as halving passes (one launch per level), and a last
// single-thread kernel pairs (-g1, sum) and runs the one shared final
// exponentiation f^(3(p^12-1)/r) and the == 1 test.
//
// Bound: 32-bit multiply-adds -- 63 doubling and 5 addition steps per
// Miller row; the final exponentiation is serial (one thread).

#include "pairing.cuh"

DEVNI void miller_row(long i, const int32_t* agg, const int32_t* hm, const uint8_t* mask,
                      int32_t* out) {
    fq12 f = fq12_one();
    if (mask[i])
        f = miller_loop(fp_load(agg + 24 * i), fp_load(agg + 24 * i + 12),
                        fq2_load(hm + 48 * i), fq2_load(hm + 48 * i + 24));
    fq12_store(out + 144 * i, f);
}

#ifdef __CUDACC__
__global__ void miller_row_kernel(long n, const int32_t* agg, const int32_t* hm,
                                  const uint8_t* mask, int32_t* out) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) miller_row(i, agg, hm, mask, out);
}
#endif

extern "C" int miller(const int32_t* agg, const int32_t* hm, const uint8_t* mask, int32_t* out,
                      long n, void* stream) {
    LAUNCH(n, miller_row, agg, hm, mask, out);
    return 0;
}

// one halving level: x[i] = x[i] * x[i + off], i < half
DEVNI void fq12_prod_pass(long i, int32_t* x, long off) {
    fq12_store(x + 144 * i, fq12_mul(fq12_load(x + 144 * i), fq12_load(x + 144 * (i + off))));
}

DEVNI void g2_sum_pass(long i, int32_t* x, long off) {
    g2_store(x + 72 * i, pt_add(g2_load(x + 72 * i), g2_load(x + 72 * (i + off))));
}

DEVNI void finish_one(long i, const int32_t* ml_prod, const int32_t* s_sum, uint8_t* ok) {
    g2p s = g2_load(s_sum);
    fq12 f = fq12_load(ml_prod);
    if (!pt_is_inf(s)) {
        fq2 x, y;
        g2_to_affine(s, &x, &y);
        f = fq12_mul(f, miller_loop(K_NEG_G1_X, K_NEG_G1_Y, x, y));
    }
    ok[0] = fq12_is_one(final_exponentiation(f)) ? 1 : 0;
}

#ifdef __CUDACC__
__global__ void fq12_prod_pass_kernel(long n, int32_t* x, long off) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) fq12_prod_pass(i, x, off);
}

__global__ void g2_sum_pass_kernel(long n, int32_t* x, long off) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) g2_sum_pass(i, x, off);
}

__global__ void finish_one_kernel(long n, const int32_t* ml_prod, const int32_t* s_sum,
                                  uint8_t* ok) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) finish_one(i, ml_prod, s_sum, ok);
}
#endif

// ml (rows, 144) and wsig (lanes, 72) are consumed in place
extern "C" int finish(int32_t* ml, long rows, int32_t* wsig, long lanes, uint8_t* ok,
                      void* stream) {
    for (long n = rows; n > 1; n -= n / 2) LAUNCH(n / 2, fq12_prod_pass, ml, n - n / 2);
    for (long n = lanes; n > 1; n -= n / 2) LAUNCH(n / 2, g2_sum_pass, wsig, n - n / 2);
    LAUNCH(1, finish_one, ml, wsig, ok);
    return 0;
}
