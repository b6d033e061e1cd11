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
// Bound: 32-bit multiply-adds -- per lane one Fq2 square root (a 759-bit
// exponentiation) and a 64-bit static ladder dominate.  One thread per
// key / lane; the K-key tree runs in a global scratch of N * K points.

#include "fp381.cuh"

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

DEVNI void prepare_lane(long i, const int32_t* pk_x, const int32_t* pk_y,
                        const uint8_t* pk_present, int k, const int32_t* sig_x0,
                        const int32_t* sig_x1, const uint8_t* sig_large, const uint8_t* sig_inf,
                        const uint8_t* lane_valid, g1p* scratch, int32_t* pk_jac,
                        int32_t* sig_jac, uint8_t* lane_ok, uint8_t* miller_mask) {
    g1p* pts = scratch + i * k;
    for (int j = 0; j < k; j++) {
        long s = i * k + j;
        bool present = pk_present[s] != 0;
        g1p q = pt_infinity<fp>();
        WHEN(present) {
            g1p key;
            key.x = fp_load(pk_x + 12 * s);
            key.y = fp_load(pk_y + 12 * s);
            key.z = K_ONE;
            if (present) q = key;
        }
        if (LIVE) pts[j] = q;
    }
    // _aggregate_lane_pks: point_batch_sum over the (pow-2) key axis
    for (int m = k; m > 1; m >>= 1)
        for (int j = 0; j < m / 2; j++) {
            g1p q = pt_add(pts[j], pts[j + m / 2]);
            if (LIVE) pts[j] = q;
        }
    g1p pk = pts[0];
    bool pk_inf = pt_is_inf(pk);
    g1_store(pk_jac + 36 * i, pk);

    fq2 xp;
    for (int j = 0; j < 12; j++) {
        xp.c0.v[j] = (uint32_t)sig_x0[12 * i + j];
        xp.c1.v[j] = (uint32_t)sig_x1[12 * i + j];
    }
    bool dec_ok;
    g2p sig = g2_recover_y(xp, sig_large[i] != 0, &dec_ok);
    bool in_sub = g2_in_subgroup(sig);
    bool sig_ok = (dec_ok && in_sub) || sig_inf[i];
    bool use_inf = sig_inf[i] || !sig_ok || !lane_valid[i];
    if (use_inf) sig = pt_infinity<fq2>();
    g2_store(sig_jac + 72 * i, sig);
    if (LIVE) {
        lane_ok[i] = (sig_ok && !pk_inf) ? 1 : 0;
        miller_mask[i] = (lane_valid[i] && !pk_inf) ? 1 : 0;
    }
}

#ifdef __CUDACC__
__global__ void prepare_lane_kernel(long n, const int32_t* pk_x, const int32_t* pk_y,
                                    const uint8_t* pk_present, int k, const int32_t* sig_x0,
                                    const int32_t* sig_x1, const uint8_t* sig_large,
                                    const uint8_t* sig_inf, const uint8_t* lane_valid,
                                    g1p* scratch, int32_t* pk_jac, int32_t* sig_jac,
                                    uint8_t* lane_ok, uint8_t* miller_mask) {
    SHELL(n, prepare_lane(ix, pk_x, pk_y, pk_present, k, sig_x0, sig_x1, sig_large, sig_inf,
                     lane_valid, scratch, pk_jac, sig_jac, lane_ok, miller_mask));
}
#endif

extern "C" int prepare(const int32_t* pk_x, const int32_t* pk_y, const uint8_t* pk_present, int k,
                       const int32_t* sig_x0, const int32_t* sig_x1, const uint8_t* sig_large,
                       const uint8_t* sig_inf, const uint8_t* lane_valid, void* scratch,
                       int32_t* pk_jac, int32_t* sig_jac, uint8_t* lane_ok, uint8_t* miller_mask,
                       long n, void* stream) {
    LAUNCH(n, prepare_lane, pk_x, pk_y, pk_present, k, sig_x0, sig_x1, sig_large, sig_inf,
           lane_valid, (g1p*)scratch, pk_jac, sig_jac, lane_ok, miller_mask);
    return 0;
}
