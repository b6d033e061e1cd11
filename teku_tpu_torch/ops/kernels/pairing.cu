// pairing.cu -- Miller loops per message row, then the batch verdict.
//
// miller replaces stage_miller (teku_tpu/ops/verify.py:266): the
// optimal-ate Miller loop with the reference's doubling / addition line
// formulas (pairing.py:_dbl_step, _add_step) and sparse line multiply
// (_mul_by_line), so row values equal the reference's.  One block of two
// warps per row runs pairing.cuh's cooperative Miller loop (coop_miller):
// the loop is one chain of 68 steps, and each step's Fq12 square, line and
// line product spread their independent Fq products over the block's 64
// lanes, where one thread ran them in series.  A masked row stores ONE; its
// mask is one value for the whole block, so the block skips the loop as a
// whole and every warp stays whole through its products (the mma build).
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
// square and final exponentiation on arrays of words (tests and
// chip_smoke.py; no caller on the verify path).
//
// Bound: 32-bit multiply-adds -- per Miller row 63 doubling and 5 addition
// steps, 5 and 6 rounds of independent Fq products on the block (345
// rounds deep); the verdict is a chain of ~750 dependent Fq12 operations
// and two serial inversions.

#include "pairing.cuh"

// row i's Miller value on one block; ONE where the row is masked
DEVNI void miller_coop(coop_t* S, long i, const int32_t* agg, const int32_t* hm,
                       const uint8_t* mask, int32_t* out) {
    if (mask[i]) {
        COOP_FOR(j, 1) {
            fp px = fp_load(agg + 24 * i), py = fp_load(agg + 24 * i + 12);
            fq2 qx = fq2_load(hm + 48 * i), qy = fq2_load(hm + 48 * i + 24);
            if (own) coop_set_pair(S, px, py, qx, qy);
        } COOP_END
        coop_miller(S, &S->f[0], &S->f[1]);
    } else {
        coop_fq12_one(&S->f[0]);
    }
    coop_fq12_store(out + 144 * i, &S->f[0]);
}

COOP_KERNEL(miller_coop, (const int32_t* agg, const int32_t* hm, const uint8_t* mask,
                          int32_t* out), agg, hm, mask, out)

extern "C" int miller(const int32_t* agg, const int32_t* hm, const uint8_t* mask, int32_t* out,
                      long n, void* stream) {
    COOP_LAUNCH(n, miller_coop, agg, hm, mask, out);
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

enum { OP_MUL = 0, OP_SQR = 1, OP_CYCLO_SQR = 2, OP_FINAL_EXP = 3 };

// element i: a, b, out (n, 144) canonical words; the product and squares
// applied `reps` times (a b^reps, a^(2^reps))
DEVNI void pairing_op_coop(coop_t* S, long i, int op, const int32_t* a, const int32_t* b,
                           int32_t* out, int reps) {
    fq12 *x = &S->f[0], *y = &S->f[1];
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

extern "C" int pairing_ops(int op, const int32_t* a, const int32_t* b, int32_t* out, long n,
                           int reps, void* stream) {
    COOP_LAUNCH(n, pairing_op_coop, op, a, b, out, reps);
    return 0;
}
