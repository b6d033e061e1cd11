// h2c.cu -- hash-to-G2 at unique-message width.
//
// Replaces stage_h2c (teku_tpu/ops/verify.py:182): the divisionless
// projective SSWU map on the isogenous curve (h2c.py:map_to_curve_sswu_proj),
// the 3-isogeny (iso_map_proj), the RFC 9380 sgn0 sign, the sum of the two
// draws, Budroni-Pintore cofactor clearing (clear_cofactor) and the affine
// conversion (to_affine_g2).  The reference shares one batched inversion
// across the batch; here each row inverts on its own thread (affine values
// are unique, so the outputs are equal).
//
// Bound: 32-bit multiply-adds -- per row two 759-bit Fq2 exponentiations
// (square-root candidates) and two 64-bit static ladders.  One thread per
// unique-message row; the two Fq2 draws (u0, u1) arrive as canonical words.

#include "fp381.cuh"

struct e_aff { fq2 x, y; };

DEVNI e_aff map_draw(const fq2& u) {
    fq2 u2 = fq2_sqr(u);
    fq2 tv = fq2_mul(K_SSWU_Z, u2);
    fq2 tv2 = fq2_add(fq2_sqr(tv), tv);
    bool tv2_zero = fq2_is_zero(tv2);
    fq2 r0 = fq2_mul(K_SSWU_B, fq2_add(tv2, fq2_one()));
    fq2 xd = fq2_mul(K_SSWU_A, tv2_zero ? K_SSWU_Z : tv2);
    fq2 x1n = tv2_zero ? K_SSWU_B : fq2_neg(r0);

    fq2 x1n2 = fq2_sqr(x1n), xd2 = fq2_sqr(xd);
    fq2 x1n3 = fq2_mul(x1n2, x1n), xd3 = fq2_mul(xd2, xd);
    fq2 axd2 = fq2_mul(fq2_mul(K_SSWU_A, x1n), xd2);
    fq2 gx1n = fq2_add(fq2_add(x1n3, axd2), fq2_mul(K_SSWU_B, xd3));
    fq2 gval = fq2_mul(gx1n, xd3);
    // one exponentiation serves both candidates: gval2 = Z^3 u^6 gval
    fq2 cand = fq2_pow(gval, E_SQRT2, E_SQRT2_BITS);
    fq2 u3 = fq2_mul(u2, u);
    fq2 cand2 = fq2_mul(fq2_mul(u3, K_Z3E), cand);
    fq2 tv3 = fq2_mul(fq2_sqr(tv), tv);
    fq2 gval2 = fq2_mul(tv3, gval);
    bool found1 = false, found2 = false;
    fq2 y1 = cand, y2 = cand2;
    for (int r = 0; r < 4; r++) {
        fq2 t1 = r == 0 ? cand : fq2_mul(K_SQRT_ROOTS[r - 1], cand);
        bool m1 = (EVERY_LANE || !found1) && fq2_eq(fq2_sqr(t1), gval) && !found1;
        if (m1) y1 = t1;
        found1 = found1 || m1;
        fq2 t2 = r == 0 ? cand2 : fq2_mul(K_SQRT_ROOTS[r - 1], cand2);
        bool m2 = (EVERY_LANE || !found2) && fq2_eq(fq2_sqr(t2), gval2) && !found2;
        if (m2) y2 = t2;
        found2 = found2 || m2;
    }
    fq2 xn = x1n;
    WHEN(!found1) {
        fq2 t = fq2_mul(tv, x1n);
        if (!found1) xn = t;
    }
    fq2 yp = found1 ? y1 : y2;

    // 3-isogeny, homogeneous in (xn, xd): x = XN / XD, y = YN / YD
    fq2 xn_p[4], xd_p[4];
    xn_p[0] = fq2_one();
    xd_p[0] = fq2_one();
    for (int i = 1; i < 4; i++) {
        xn_p[i] = fq2_mul(xn_p[i - 1], xn);
        xd_p[i] = fq2_mul(xd_p[i - 1], xd);
    }
    fq2 XN = fq2_zero(), XDh = fq2_zero(), YNh = fq2_zero(), YDh = fq2_zero();
    for (int i = 0; i < 4; i++) {
        XN = fq2_add(XN, fq2_mul(fq2_mul(K_ISO_XN[i], xn_p[i]), xd_p[3 - i]));
        YNh = fq2_add(YNh, fq2_mul(fq2_mul(K_ISO_YN[i], xn_p[i]), xd_p[3 - i]));
        YDh = fq2_add(YDh, fq2_mul(fq2_mul(K_ISO_YD[i], xn_p[i]), xd_p[3 - i]));
    }
    for (int i = 0; i < 3; i++)
        XDh = fq2_add(XDh, fq2_mul(fq2_mul(K_ISO_XD[i], xn_p[i]), xd_p[2 - i]));
    fq2 XD = fq2_mul(xd, XDh);
    fq2 YN = fq2_mul(yp, YNh);
    fq2 YD = fq2_mul(xd_p[3], YDh);

    e_aff out;
    out.x = fq2_mul(XN, fq2_inv(XD));
    out.y = fq2_mul(YN, fq2_inv(YD));
    // RFC sgn0 applies to y' = yp / xd^3 on E' (the isogeny is odd in y)
    fq2 y_prime = fq2_mul(yp, fq2_inv(xd_p[3]));
    if (fq2_sgn0(u) != fq2_sgn0(y_prime)) out.y = fq2_neg(out.y);
    return out;
}

DEV g2p mul_x(const g2p& q) { return pt_neg(pt_mul_static(q, E_XABS, E_XABS_BITS)); }

// h_eff * P = [x^2 - x - 1]P + [x - 1]psi(P) + psi^2(2P)
DEVNI g2p clear_cofactor(const g2p& p) {
    g2p a = pt_add(mul_x(p), pt_neg(p));
    g2p res = pt_add(mul_x(a), pt_neg(p));
    res = pt_add(res, g2_psi(a));
    return pt_add(res, g2_psi(g2_psi(pt_dbl(p))));
}

DEVNI void h2c_row(long i, const int32_t* u0, const int32_t* u1, int32_t* out) {
    g2p pts[2];
    for (int d = 0; d < 2; d++) {
        e_aff a = map_draw(fq2_load((d == 0 ? u0 : u1) + 24 * i));
        pts[d].x = a.x;
        pts[d].y = a.y;
        pts[d].z = fq2_one();
    }
    g2p h = clear_cofactor(pt_add(pts[0], pts[1]));
    fq2 x, y;
    g2_to_affine(h, &x, &y);
    fq2_store(out + 48 * i, x);
    fq2_store(out + 48 * i + 24, y);
}

#ifdef __CUDACC__
__global__ void h2c_row_kernel(long n, const int32_t* u0, const int32_t* u1, int32_t* out) {
    SHELL(n, h2c_row(ix, u0, u1, out));
}
#endif

extern "C" int h2c(const int32_t* u0, const int32_t* u1, int32_t* out, long n, void* stream) {
    LAUNCH(n, h2c_row, u0, u1, out);
    return 0;
}
