// decompress.cu -- pubkey validation and the prepare stage.
//
// g1_validate replaces the TPU program _pk_validate_kernel
// (teku_tpu/ops/provider.py:456, jitted :409): G1 decompression (sqrt and
// sign select) plus the phi subgroup check, affine coordinates out.
//
// prepare replaces stage_prepare (teku_tpu/ops/verify.py:169): per-lane
// multi-key aggregation (_aggregate_lane_pks, the same pairwise tree, so
// the Jacobian aggregate equals the reference's), G2 signature
// decompression, the psi subgroup check and the lane masks.
//
// Bound: 32-bit multiply-adds, and on the card the latency of one lane's
// chain: an Fq2 square root (a 759-bit exponentiation) and a 64-bit static
// G2 ladder, Fq products in series on one thread.  g1_validate keeps one
// thread a key.  prepare runs a warp a lane (wcoop.cuh): the key tree's
// adds of a level one a lane (point_batch_sum's pairing order, in a global
// scratch of N * K points), then the square root as two halves off one
// chain of 381 squares and the ladder, each step's independent Fq
// products on separate lanes.  A 256-lane batch is 256 warps on the SMs,
// where one thread a lane filled 4 blocks.

#include "wcoop.cuh"

DEVNI void g1_validate_key(long i, const int32_t* x, const uint8_t* large, uint8_t* ok,
                           int32_t* ox, int32_t* oy) {
    fp xp;
    for (int j = 0; j < 12; j++) xp.v[j] = (uint32_t)x[12 * i + j];
    bool on_curve;
    g1p pt = g1_recover_y(xp, large[i] != 0, &on_curve);
    bool in_sub = (EVERY_LANE || on_curve) && g1_in_subgroup(pt);
    if (LIVE) ok[i] = (on_curve && in_sub) ? 1 : 0;
    fp_store(ox + 12 * i, pt.x);
    fp_store(oy + 12 * i, pt.y);
}

#ifdef __CUDACC__
__global__ void g1_validate_key_kernel(long n, const int32_t* x, const uint8_t* large, uint8_t* ok,
                                       int32_t* ox, int32_t* oy) {
    SHELL(n, g1_validate_key(ix, x, large, ok, ox, oy));
}
#endif

extern "C" int g1_validate(const int32_t* x, const uint8_t* large, uint8_t* ok,
                           int32_t* ox, int32_t* oy, long m, void* stream) {
    LAUNCH(m, g1_validate_key, x, large, ok, ox, oy);
    return 0;
}

// the lane's slots: the signature's x, the right-hand side x^3 + b, the
// candidate's halves and roots, Q = (x, y, 1), -[|z|]Q, psi(Q), pt_eq's
// products, the ladder's scratch
enum { P_X, P_RHS, P_X2, P_E1, P_E0, P_CAND, P_T, P_SQ = P_T + 3, P_Y = P_SQ + 4,
       P_Q, P_MX = P_Q + 3, P_PSI = P_MX + 3, P_EQ = P_PSI + 3, P_SCR = P_EQ + 8,
       P_N = P_SCR + 25 };
static_assert(P_N <= W_REGS, "wcoop.cuh: too few slots");

DEVNI void prepare_lane(wst* S, long i, const int32_t* pk_x, const int32_t* pk_y,
                        const uint8_t* pk_present, int k, const int32_t* sig_x0,
                        const int32_t* sig_x1, const uint8_t* sig_large, const uint8_t* sig_inf,
                        const uint8_t* lane_valid, g1p* scratch, int32_t* pk_jac,
                        int32_t* sig_jac, uint8_t* lane_ok, uint8_t* miller_mask) {
    fq2* r = S->r;
    fp* f = S->f;
    g1p* pts = scratch + i * k;
    // the keys (Montgomery form; absent: infinity), a coordinate a job
    WARP_FOR(j, 2 * k) {
        long s = i * k + j / 2;
        bool present = pk_present[s] != 0;
        fp v = K_ONE;
        WHEN(present) {
            fp w = fp_load((j & 1 ? pk_y : pk_x) + 12 * s);
            if (present) v = w;
        }
        if (own) {
            fp* pt = (fp*)&pts[j / 2];
            pt[j & 1] = v;
            if (!(j & 1)) pt[2] = present ? K_ONE : fp_zero();
        }
    } WARP_END
    // _aggregate_lane_pks: point_batch_sum over the (pow-2) key axis, a
    // level's adds one a job
    for (int m = k; m > 1; m >>= 1) {
        WARP_FOR(j, m / 2) {
            g1p q = pt_add(pts[j], pts[j + m / 2]);
            if (own) pts[j] = q;
        } WARP_END
    }
    w_from_mont(S, 3, [&](int c) { return ((const fp*)&pts[0])[c]; },
                [&](int c, const fp& v) { words_store(pk_jac + 36 * i + 12 * c, v); });

    // G2 decompression from the plain x: rhs = x^3 + b, its square root
    w_fp(S, 2, [&](int c, fp& x, fp& y) {
        const int32_t* w = (c ? sig_x1 : sig_x0) + 12 * i;
        for (int j = 0; j < 12; j++) x.v[j] = (uint32_t)w[j];
        y = K_R2;
    }, [&](int c, const fp& v) { ((fp*)(r + P_X))[c] = v; });
    w_prod(S, 1, [&](int, fq2& x, fq2& y) { x = y = r[P_X]; },
           [&](int, const fq2& v) { r[P_X2] = v; });
    w_prod(S, 1, [&](int, fq2& x, fq2& y) { x = r[P_X2]; y = r[P_X]; },
           [&](int, const fq2& v) { r[P_RHS] = fq2_add(v, K_B2); });
    w_sqrt_pow(S, 1, P_RHS, P_E1, 0);
    w_prod(S, 1, [&](int, fq2& x, fq2& y) { x = fq2_conj(r[P_E1]); y = r[P_E0]; },
           [&](int, const fq2& v) { r[P_CAND] = v; });
    w_prod(S, 3, [&](int q, fq2& x, fq2& y) { x = K_SQRT_ROOTS[q]; y = r[P_CAND]; },
           [&](int q, const fq2& v) { r[P_T + q] = v; });
    w_prod(S, 4, [&](int q, fq2& x, fq2& y) { x = y = q ? r[P_T + q - 1] : r[P_CAND]; },
           [&](int q, const fq2& v) { r[P_SQ + q] = v; });
    // the reference's fq2_sqrt order: the first of cand times 1,
    // sqrt(-1), ... whose square is rhs; ok = some is
    WARP_FOR(j, 1) {
        bool found = false;
        fq2 root = r[P_CAND];
        for (int q = 0; q < 4; q++) {
            bool m = !found && fq2_eq(r[P_SQ + q], r[P_RHS]);
            if (m) root = q ? r[P_T + q - 1] : r[P_CAND];
            found = found || m;
        }
        if (own) {
            r[P_Y] = root;
            S->flag[1] = found;
        }
    } WARP_END
    // the wire sign: the lexicographically larger root when the flag is set
    w_from_mont(S, 2, [&](int c) { return ((const fp*)(r + P_Y))[c]; },
                [&](int c, const fp& v) { f[c] = v; });
    WARP_FOR(j, 1) {
        bool large = fq2_is_large_plain(fq2_make(f[0], f[1]));
        fq2 y = large == (sig_large[i] != 0) ? r[P_Y] : fq2_neg(r[P_Y]);
        if (own) {
            r[P_Q] = r[P_X];
            r[P_Q + 1] = y;
            r[P_Q + 2] = fq2_one();
        }
    } WARP_END

    // psi(Q) == [z]Q, z < 0 (points.py g2_in_subgroup), by pt_eq's products
    w_mul_x(S, P_Q, P_MX, P_SCR);
    w_psi(S, P_Q, P_PSI);
    w_prod(S, 2, [&](int q, fq2& x, fq2& y) { x = y = r[(q ? P_MX : P_PSI) + 2]; },
           [&](int q, const fq2& v) { r[P_EQ + q] = v; });                // Z1Z1, Z2Z2
    w_prod(S, 4, [&](int q, fq2& x, fq2& y) {
        const int src[4] = {P_PSI, P_MX, P_MX + 2, P_PSI + 2};
        x = r[src[q]];
        y = r[P_EQ + ((q & 1) ? 0 : 1)];
    }, [&](int q, const fq2& v) { r[P_EQ + 2 + q] = v; });
    w_prod(S, 2, [&](int q, fq2& x, fq2& y) {
        x = r[(q ? P_MX : P_PSI) + 1];
        y = r[P_EQ + 4 + q];
    }, [&](int q, const fq2& v) { r[P_EQ + 6 + q] = v; });
    WARP_FOR(j, 1) {
        bool p_inf = fq2_is_zero(r[P_PSI + 2]), q_inf = fq2_is_zero(r[P_MX + 2]);
        bool eq = (fq2_eq(r[P_EQ + 2], r[P_EQ + 3]) && fq2_eq(r[P_EQ + 6], r[P_EQ + 7])
                   && !(p_inf ^ q_inf)) || (p_inf && q_inf);
        bool in_sub = eq || fq2_is_zero(r[P_Q + 2]);
        bool sig_ok = (S->flag[1] && in_sub) || sig_inf[i];
        bool use_inf = sig_inf[i] || !sig_ok || !lane_valid[i];
        bool pk_inf = fp_is_zero(pts[0].z);
        if (own) {
            S->flag[2] = use_inf;
            lane_ok[i] = (sig_ok && !pk_inf) ? 1 : 0;
            miller_mask[i] = (lane_valid[i] && !pk_inf) ? 1 : 0;
        }
    } WARP_END
    bool use_inf = S->flag[2] != 0;
    w_from_mont(S, 6, [&](int c) {
        g2p inf = pt_infinity<fq2>();
        return ((const fp*)(use_inf ? &inf.x : &r[P_Q]))[c];
    }, [&](int c, const fp& v) { words_store(sig_jac + 72 * i + 12 * c, v); });
}

WARP_KERNEL(prepare_lane, (const int32_t* pk_x, const int32_t* pk_y, const uint8_t* pk_present,
                           int k, const int32_t* sig_x0, const int32_t* sig_x1,
                           const uint8_t* sig_large, const uint8_t* sig_inf,
                           const uint8_t* lane_valid, g1p* scratch, int32_t* pk_jac,
                           int32_t* sig_jac, uint8_t* lane_ok, uint8_t* miller_mask),
            pk_x, pk_y, pk_present, k, sig_x0, sig_x1, sig_large, sig_inf, lane_valid, scratch,
            pk_jac, sig_jac, lane_ok, miller_mask)

extern "C" int prepare(const int32_t* pk_x, const int32_t* pk_y, const uint8_t* pk_present, int k,
                       const int32_t* sig_x0, const int32_t* sig_x1, const uint8_t* sig_large,
                       const uint8_t* sig_inf, const uint8_t* lane_valid, void* scratch,
                       int32_t* pk_jac, int32_t* sig_jac, uint8_t* lane_ok, uint8_t* miller_mask,
                       long n, void* stream) {
    WARP_LAUNCH(n, prepare_lane, pk_x, pk_y, pk_present, k, sig_x0, sig_x1, sig_large, sig_inf,
                lane_valid, (g1p*)scratch, pk_jac, sig_jac, lane_ok, miller_mask);
    return 0;
}
