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
// signatures run as halving passes (pairing.cuh, one launch per level), and a last
// kernel of one block pairs (-g1, sum) and runs the one shared final
// exponentiation f^(3(p^12-1)/r) and the == 1 test on the cooperative
// routines of pairing.cuh: two warps spread each Fq12 operation's products
// (the Miller loop's 68 steps, 5 z-powers of 63 cyclotomic squares) where
// one thread ran them in series; the affine sum and the Fq12 inverse stay
// serial, each one binary extended Euclid inversion (fp_inv_euclid).
//
// pairing_ops exposes the cooperative Fq12 product, square, cyclotomic
// square, Miller loop and final exponentiation, and the one-thread final
// exponentiation, on arrays of words (tests and chip_smoke.py; no caller
// on the verify path).
//
// Bound: 32-bit multiply-adds -- 63 doubling and 5 addition steps per
// Miller row; the verdict is a chain of ~750 dependent Fq12 operations and
// two serial inversions.

#include "pairing.cuh"

DEVNI void miller_row(long i, const int32_t* agg, const int32_t* hm, const uint8_t* mask,
                      int32_t* out) {
    fq12 f = fq12_one();
    bool use = mask[i] != 0;
    WHEN(use) {
        fq12 m = miller_loop(fp_load(agg + 24 * i), fp_load(agg + 24 * i + 12),
                             fq2_load(hm + 48 * i), fq2_load(hm + 48 * i + 24));
        if (use) f = m;
    }
    fq12_store(out + 144 * i, f);
}

#ifdef __CUDACC__
__global__ void miller_row_kernel(long n, const int32_t* agg, const int32_t* hm,
                                  const uint8_t* mask, int32_t* out) {
    SHELL(n, miller_row(ix, agg, hm, mask, out));
}
#endif

extern "C" int miller(const int32_t* agg, const int32_t* hm, const uint8_t* mask, int32_t* out,
                      long n, void* stream) {
    LAUNCH(n, miller_row, agg, hm, mask, out);
    return 0;
}

DEVNI void finish_coop(coop_t* S, long, const int32_t* ml_prod, const int32_t* s_sum,
                       uint8_t* ok) {
    coop_fq12_load(&S->f[0], ml_prod);
    COOP_FOR(j, 1) {
        g2p s = g2_load(s_sum);
        bool finite = !pt_is_inf(s);
        fq2 x = fq2_zero(), y = fq2_zero();
        WHEN(finite) g2_to_affine<true>(s, &x, &y);
        if (own) {
            S->r[R_XQ] = x;
            S->r[R_YQ] = y;
            S->r[R_PX] = fq2_make(fp_neg(K_NEG_G1_X), fp_zero());
            S->r[R_PY] = fq2_make(K_NEG_G1_Y, fp_zero());
            S->flag = finite;
        }
    } COOP_END
    bool finite = S->flag != 0;
    WHEN(finite) {
        coop_miller(S, &S->f[1], &S->f[2]);
        coop_fq12_mul(S, &S->f[1], &S->f[0], &S->f[1]);
        COOP_FOR(k, 6) {
            if (own && finite) *fq12_at(&S->f[0], k) = *fq12_at(&S->f[1], k);
        } COOP_END
    }
    coop_final_exp(S);
    COOP_FOR(j, 1) {
        bool one = fq12_is_one(S->f[1]);
        if (own) ok[0] = one ? 1 : 0;
    } COOP_END
}

COOP_KERNEL(finish_coop, (const int32_t* ml_prod, const int32_t* s_sum, uint8_t* ok), ml_prod,
            s_sum, ok)

// ml (rows, 144) and wsig (lanes, 72) are consumed in place
extern "C" int finish(int32_t* ml, long rows, int32_t* wsig, long lanes, uint8_t* ok,
                      void* stream) {
    HALVING(rows, fq12_prod_pass, ml, 144);
    HALVING(lanes, g2_sum_pass, wsig, 72);
    COOP_LAUNCH(1, finish_coop, ml, wsig, ok);
    return 0;
}

enum { OP_MUL = 0, OP_SQR = 1, OP_CYCLO_SQR = 2, OP_FINAL_EXP = 3, OP_FINAL_EXP_ONE_THREAD = 4,
       OP_MILLER = 5 };

// element i of the cooperative ops: a, b, out (n, 144) canonical words;
// the product and squares applied `reps` times (a b^reps, a^(2^reps)).
// OP_MILLER: a (n, 24) affine G1 words P, b (n, 48) affine G2 words Q,
// out the Miller value of (P, Q), as pairing.cuh's miller_loop gives it
DEVNI void pairing_op_coop(coop_t* S, long i, int op, const int32_t* a, const int32_t* b,
                           int32_t* out, int reps) {
    fq12 *x = &S->f[0], *y = &S->f[1];
    if (op == OP_MILLER) {
        COOP_FOR(j, 1) {
            fp px = fp_load(a + 24 * i), py = fp_load(a + 24 * i + 12);
            fq2 qx = fq2_load(b + 48 * i), qy = fq2_load(b + 48 * i + 24);
            if (own) {
                S->r[R_XQ] = qx;
                S->r[R_YQ] = qy;
                S->r[R_PX] = fq2_make(fp_neg(px), fp_zero());
                S->r[R_PY] = fq2_make(py, fp_zero());
            }
        } COOP_END
        coop_miller(S, x, y);
        coop_fq12_store(out + 144 * i, x);
        return;
    }
    coop_fq12_load(x, a + 144 * i);
    if (op == OP_MUL) coop_fq12_load(y, b + 144 * i);
    if (op == OP_FINAL_EXP) {
        coop_final_exp(S);
        x = y;
    } else {
        for (int r = 0; r < reps; r++) {
            if (op == OP_MUL) coop_fq12_mul(S, x, x, y);
            if (op == OP_SQR) coop_fq12_sqr(S, x, x);
            if (op == OP_CYCLO_SQR) coop_cyclo_sqr(S, x, x);
        }
    }
    coop_fq12_store(out + 144 * i, x);
}

COOP_KERNEL(pairing_op_coop, (int op, const int32_t* a, const int32_t* b, int32_t* out, int reps),
            op, a, b, out, reps)

DEVNI void final_exp_one(long i, const int32_t* a, int32_t* out) {
    fq12_store(out + 144 * i, final_exponentiation(fq12_load(a + 144 * i)));
}

#ifdef __CUDACC__
__global__ void final_exp_one_kernel(long n, const int32_t* a, int32_t* out) {
    SHELL(n, final_exp_one(ix, a, out));
}
#endif

extern "C" int pairing_ops(int op, const int32_t* a, const int32_t* b, int32_t* out, long n,
                           int reps, void* stream) {
    if (op == OP_FINAL_EXP_ONE_THREAD)
        LAUNCH(n, final_exp_one, a, out);
    else
        COOP_LAUNCH(n, pairing_op_coop, op, a, b, out, reps);
    return 0;
}
