// h2c.cu -- hash-to-G2 at unique-message width.
//
// Replaces stage_h2c (teku_tpu/ops/verify.py:182): the divisionless
// projective SSWU map on the isogenous curve (h2c.py:map_to_curve_sswu_proj),
// the 3-isogeny (iso_map_proj), the RFC 9380 sgn0 sign, the sum of the two
// draws, Budroni-Pintore cofactor clearing (clear_cofactor) and the affine
// conversion (to_affine_g2).  The reference shares one batched inversion
// across the batch; here each row inverts on its own warp (affine values
// are unique, so the outputs are equal).
//
// Bound: 32-bit multiply-adds, and on the card the latency of one row's
// chain: two 759-bit Fq2 exponentiations (the square-root candidates),
// two 64-bit static G2 ladders, seven Fq2 inversions, each a chain of
// Fq products in series on one thread.  Here one warp runs a row
// (wcoop.cuh): the two draws side by side on separate lanes, each step's
// independent Fq products on separate lanes, each candidate as two halves
// off one chain of 381 squares; one Fq inversion (binary Euclid) serves
// the six denominators of both draws by Montgomery's trick, and one more
// the affine conversion.  The draws (u0, u1) arrive as canonical words.
// Values keep the reference's formulas: the SSWU branch on tv2 == 0, the
// candidates' root order, sgn0 on y' = yp / xd^3, the cofactor sum and
// its Jacobian coordinates.

#include "wcoop.cuh"

// the slots of draw d: d * H_N + name
enum { H_U, H_U2, H_TV, H_U3, H_TVSQ, H_U3Z, H_XD, H_X1N, H_TV3, H_X1N2, H_XD2, H_AX1N,
       H_TVX1N, H_X1N3, H_XD3, H_AXD2, H_BXD3, H_GVAL, H_E1, H_E0, H_CAND, H_GVAL2,
       H_CAND2, H_T1, H_T2 = H_T1 + 3, H_SQ1 = H_T2 + 3, H_SQ2 = H_SQ1 + 4, H_XN = H_SQ2 + 4,
       H_YP, H_XN2, H_XNXD, H_XNXD2, H_XN3, H_XN2XD, H_XNUM, H_XDEN, H_YNUM, H_YDEN,
       H_XDF, H_YNF, H_YDF, H_INV, H_X = H_INV + 3, H_Y, H_Z, H_YPR, H_N };
// the row's slots after both draws: the cofactor's points and scratch,
// the affine step's
enum { C_P = 2 * H_N, C_NP = C_P + 3, C_MX = C_NP + 3, C_A = C_MX + 3, C_R = C_A + 3,
       C_T = C_R + 3, C_SCR = C_T + 3, C_ZI = C_SCR + 25, C_ZI2, C_ZI3, C_AX, C_AY, C_N };
// Fq slots: the denominators' norms and Montgomery's trick over them
enum { F_SQ, F_N = F_SQ + 12, F_P01 = F_N + 6, F_P23, F_P45, F_P03, F_ALL, F_INV, F_I03,
       F_I45, F_I01, F_I23, F_I = F_I23 + 1, F_PL = F_I + 6, F_COUNT = F_PL + 8 };
static_assert(C_N <= W_REGS && F_COUNT <= W_FPS, "wcoop.cuh: too few slots");

// m products a draw, product t of both: draw t / m, job t % m of it
#define DRAW(t, m)                                                               \
    const int d_ = (t) / (m);                                                    \
    [[maybe_unused]] const int q = (t) % (m);                                    \
    fq2* R = S->r + d_ * H_N

DEV uint32_t sgn0_plain(const fp& c0, const fp& c1) {
    return (c0.v[0] & 1) | ((fp_is_zero(c0) ? 1 : 0) & (c1.v[0] & 1));
}

// the two draws' points (x, y, 1) on E2 at slots d * H_N + H_X
DEVNI void map_draws(wst* S, long i, const int32_t* u0, const int32_t* u1) {
    fp* f = S->f;
    w_fp(S, 4, [&](int t, fp& x, fp& y) {
        const int32_t* w = (t < 2 ? u0 : u1) + 24 * i + 12 * (t & 1);
        for (int k = 0; k < 12; k++) x.v[k] = (uint32_t)w[k];
        y = K_R2;
    }, [&](int t, const fp& v) { ((fp*)(S->r + (t >> 1) * H_N + H_U))[t & 1] = v; });
    w_prod(S, 2, [&](int t, fq2& x, fq2& y) { DRAW(t, 1); x = y = R[H_U]; },
           [&](int t, const fq2& v) { DRAW(t, 1); R[H_U2] = v; });
    w_prod(S, 4, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 2);
        x = q ? R[H_U2] : K_SSWU_Z;
        y = q ? R[H_U] : R[H_U2];
    }, [&](int t, const fq2& v) { DRAW(t, 2); R[H_TV + q] = v; });        // TV, U3
    w_prod(S, 4, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 2);
        x = q ? R[H_U3] : R[H_TV];
        y = q ? K_Z3E : R[H_TV];
    }, [&](int t, const fq2& v) { DRAW(t, 2); R[H_TVSQ + q] = v; });      // TVSQ, U3Z
    // tv2 = tv^2 + tv; xd = A (tv2 == 0 ? Z : tv2), x1n = tv2 == 0 ? B : -B (tv2 + 1)
    w_prod(S, 6, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 3);
        fq2 tv2 = fq2_add(R[H_TVSQ], R[H_TV]);
        bool zero = fq2_is_zero(tv2);
        x = q == 0 ? K_SSWU_A : q == 1 ? K_SSWU_B : R[H_TVSQ];
        y = q == 0 ? (zero ? K_SSWU_Z : tv2) : q == 1 ? fq2_add(tv2, fq2_one()) : R[H_TV];
    }, [&](int t, const fq2& v) {
        DRAW(t, 3);
        bool zero = fq2_is_zero(fq2_add(R[H_TVSQ], R[H_TV]));
        R[H_XD + q] = q == 1 ? (zero ? K_SSWU_B : fq2_neg(v)) : v;        // XD, X1N, TV3
    });
    w_prod(S, 8, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 4);
        x = q == 0 ? R[H_X1N] : q == 1 ? R[H_XD] : q == 2 ? K_SSWU_A : R[H_TV];
        y = q == 1 ? R[H_XD] : R[H_X1N];
    }, [&](int t, const fq2& v) { DRAW(t, 4); R[H_X1N2 + q] = v; });     // X1N2, XD2, AX1N, TVX1N
    w_prod(S, 6, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 3);
        x = q == 0 ? R[H_X1N2] : q == 1 ? R[H_XD2] : R[H_AX1N];
        y = q == 0 ? R[H_X1N] : q == 1 ? R[H_XD] : R[H_XD2];
    }, [&](int t, const fq2& v) { DRAW(t, 3); R[H_X1N3 + q] = v; });     // X1N3, XD3, AXD2
    w_prod(S, 2, [&](int t, fq2& x, fq2& y) { DRAW(t, 1); x = K_SSWU_B; y = R[H_XD3]; },
           [&](int t, const fq2& v) { DRAW(t, 1); R[H_BXD3] = v; });
    // gval = gx1n xd^3, gx1n = x1n^3 + A x1n xd^2 + B xd^3
    w_prod(S, 2, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 1);
        x = fq2_add(fq2_add(R[H_X1N3], R[H_AXD2]), R[H_BXD3]);
        y = R[H_XD3];
    }, [&](int t, const fq2& v) { DRAW(t, 1); R[H_GVAL] = v; });
    // one exponentiation serves both candidates: gval2 = Z^3 u^6 gval
    w_sqrt_pow(S, 2, H_GVAL, H_E1, H_N);
    w_prod(S, 4, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 2);
        x = q ? R[H_TV3] : fq2_conj(R[H_E1]);
        y = q ? R[H_GVAL] : R[H_E0];
    }, [&](int t, const fq2& v) { DRAW(t, 2); R[H_CAND + q] = v; });     // CAND, GVAL2
    w_prod(S, 8, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 4);
        x = q ? K_SQRT_ROOTS[q - 1] : R[H_U3Z];
        y = R[H_CAND];
    }, [&](int t, const fq2& v) { DRAW(t, 4); R[q ? H_T1 + q - 1 : H_CAND2] = v; });
    // the squares of the first draw's candidates, the second's roots
    w_prod(S, 14, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 7);
        x = q < 3 ? K_SQRT_ROOTS[q] : q == 3 ? R[H_CAND] : R[H_T1 + q - 4];
        y = q < 3 ? R[H_CAND2] : x;
    }, [&](int t, const fq2& v) { DRAW(t, 7); R[q < 3 ? H_T2 + q : H_SQ1 + q - 3] = v; });
    w_prod(S, 8, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 4);
        x = y = q ? R[H_T2 + q - 1] : R[H_CAND2];
    }, [&](int t, const fq2& v) { DRAW(t, 4); R[H_SQ2 + q] = v; });
    // the first candidate whose square is the value, in the reference's
    // order; xn = tv x1n and y = y2 unless the first value is a square
    WARP_FOR(d, 2) {
        fq2* R = S->r + d * H_N;
        bool found1 = false, found2 = false;
        fq2 y1 = R[H_CAND], y2 = R[H_CAND2];
        for (int k = 0; k < 4; k++) {
            fq2 t1 = k ? R[H_T1 + k - 1] : R[H_CAND], t2 = k ? R[H_T2 + k - 1] : R[H_CAND2];
            bool m1 = !found1 && fq2_eq(R[H_SQ1 + k], R[H_GVAL]);
            bool m2 = !found2 && fq2_eq(R[H_SQ2 + k], R[H_GVAL2]);
            if (m1) y1 = t1;
            if (m2) y2 = t2;
            found1 = found1 || m1;
            found2 = found2 || m2;
        }
        fq2 xn = found1 ? R[H_X1N] : R[H_TVX1N], yp = found1 ? y1 : y2;
        if (own) {
            R[H_XN] = xn;
            R[H_YP] = yp;
        }
    } WARP_END
    // 3-isogeny, homogeneous in (xn, xd): x = XN / XD, y = YN / YD
    w_prod(S, 6, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 3);
        x = R[H_XN];
        y = q == 0 ? R[H_XN] : q == 1 ? R[H_XD] : R[H_XD2];
    }, [&](int t, const fq2& v) { DRAW(t, 3); R[H_XN2 + q] = v; });      // XN2, XNXD, XNXD2
    w_prod(S, 4, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 2);
        x = R[H_XN2];
        y = q ? R[H_XD] : R[H_XN];
    }, [&](int t, const fq2& v) { DRAW(t, 2); R[H_XN3 + q] = v; });      // XN3, XN2XD
    // XN = sum K_XN[i] xn^i xd^(3-i), XDh (3 terms: xd^(2-i)), YNh, YDh:
    // 15 products a draw, then a lane sums each
    w_parts(S, 30, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 15);
        const int m[4] = {H_XD3, H_XNXD2, H_XN2XD, H_XN3}, e[3] = {H_XD2, H_XNXD, H_XN2};
        int g = q < 4 ? 0 : q < 7 ? 1 : q < 11 ? 2 : 3, k = q - (g == 0 ? 0 : g == 1 ? 4 : g == 2 ? 7 : 11);
        x = g == 0 ? K_ISO_XN[k] : g == 1 ? K_ISO_XD[k] : g == 2 ? K_ISO_YN[k] : K_ISO_YD[k];
        y = R[g == 1 ? e[k] : m[k]];
    });
    WARP_FOR(t, 8) {
        int d = t / 4, g = t % 4;
        int first = 15 * d + (g == 0 ? 0 : g == 1 ? 4 : g == 2 ? 7 : 11);
        fq2 sum = fq2_zero();
        for (int k = 0; k < (g == 1 ? 3 : 4); k++) sum = fq2_add(sum, kara_join(S->part + 3 * (first + k)));
        if (own) S->r[d * H_N + H_XNUM + g] = sum;
    } WARP_END
    w_prod(S, 6, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 3);
        x = q == 0 ? R[H_XD] : q == 1 ? R[H_YP] : R[H_XD3];
        y = q == 0 ? R[H_XDEN] : q == 1 ? R[H_YNUM] : R[H_YDEN];
    }, [&](int t, const fq2& v) { DRAW(t, 3); R[H_XDF + q] = v; });      // XD, YN, YD
    // the six denominators XD, YD and xd^3 of both draws inverted with one
    // Fq inversion: their norms, Montgomery's trick over those (a zero
    // norm counts as 1 and inverts to 0, as fq2_inv's), the binary Euclid
    const int den[3] = {H_XDF, H_YDF, H_XD3};
    w_fp(S, 12, [&](int t, fp& x, fp& y) {
        const fq2& a = S->r[(t / 6) * H_N + den[t / 2 % 3]];
        x = y = t & 1 ? a.c1 : a.c0;
    }, [&](int t, const fp& v) { f[F_SQ + t] = v; });
    WARP_FOR(k, 6) {
        fp n = fp_add(f[F_SQ + 2 * k], f[F_SQ + 2 * k + 1]);
        if (own) f[F_N + k] = fp_is_zero(n) ? K_ONE : n;
    } WARP_END
    w_fp(S, 3, [&](int k, fp& x, fp& y) { x = f[F_N + 2 * k]; y = f[F_N + 2 * k + 1]; },
         [&](int k, const fp& v) { f[F_P01 + k] = v; });
    w_fp(S, 1, [&](int, fp& x, fp& y) { x = f[F_P01]; y = f[F_P23]; },
         [&](int, const fp& v) { f[F_P03] = v; });
    w_fp(S, 1, [&](int, fp& x, fp& y) { x = f[F_P03]; y = f[F_P45]; },
         [&](int, const fp& v) { f[F_ALL] = v; });
    WARP_FOR(j, 1) {
        fp v = fp_inv_euclid(f[F_ALL]);
        if (own) f[F_INV] = v;
    } WARP_END
    w_fp(S, 2, [&](int k, fp& x, fp& y) { x = f[F_INV]; y = f[k ? F_P03 : F_P45]; },
         [&](int k, const fp& v) { f[F_I03 + k] = v; });                 // 1 / P03, 1 / P45
    w_fp(S, 4, [&](int k, fp& x, fp& y) {
        x = f[k < 2 ? F_I03 : F_I45];
        y = f[k == 0 ? F_P23 : k == 1 ? F_P01 : k == 2 ? F_N + 5 : F_N + 4];
    }, [&](int k, const fp& v) { f[k < 2 ? F_I01 + k : F_I + 2 + k] = v; });
    w_fp(S, 4, [&](int k, fp& x, fp& y) {
        x = f[k < 2 ? F_I01 : F_I23];
        y = f[F_N + (k ^ 1)];
    }, [&](int k, const fp& v) { f[F_I + k] = v; });
    // each denominator's inverse: (c0 / n, -c1 / n), n its norm
    w_fp(S, 12, [&](int t, fp& x, fp& y) {
        int k = t / 2;
        const fq2& a = S->r[(k / 3) * H_N + den[k % 3]];
        x = t & 1 ? a.c1 : a.c0;
        bool zero = fp_is_zero(fp_add(f[F_SQ + 2 * k], f[F_SQ + 2 * k + 1]));
        y = zero ? fp_zero() : f[F_I + k];
    }, [&](int t, const fp& v) {
        fp* inv = (fp*)(S->r + (t / 6) * H_N + H_INV + t / 2 % 3);
        inv[t & 1] = t & 1 ? fp_neg(v) : v;
    });
    w_prod(S, 6, [&](int t, fq2& x, fq2& y) {
        DRAW(t, 3);
        x = q == 0 ? R[H_XNUM] : q == 1 ? R[H_YNF] : R[H_YP];
        y = R[H_INV + q];
    }, [&](int t, const fq2& v) { DRAW(t, 3); R[q < 2 ? H_X + q : H_YPR] = v; });
    // RFC sgn0 applies to y' = yp / xd^3 on E' (the isogeny is odd in y)
    w_from_mont(S, 8, [&](int t) {
        const fq2& a = S->r[(t / 4) * H_N + (t % 4 < 2 ? H_U : H_YPR)];
        return t & 1 ? a.c1 : a.c0;
    }, [&](int t, const fp& v) { f[F_PL + t] = v; });
    WARP_FOR(d, 2) {
        fq2* R = S->r + d * H_N;
        const fp* pl = f + F_PL + 4 * d;
        fq2 y = R[H_Y];
        if (sgn0_plain(pl[0], pl[1]) != sgn0_plain(pl[2], pl[3])) y = fq2_neg(y);
        if (own) {
            R[H_Y] = y;
            R[H_Z] = fq2_one();
        }
    } WARP_END
}

// h_eff P = [x^2 - x - 1]P + [x - 1]psi(P) + psi^2(2P), as clear_cofactor:
// P at C_P, the result at C_R
DEVNI void clear_cofactor(wst* S) {
    WARP_FOR(k, 3) {
        fq2 v = S->r[C_P + k];
        if (k == 1) v = fq2_neg(v);
        if (own) S->r[C_NP + k] = v;
    } WARP_END
    w_mul_x(S, C_P, C_MX, C_SCR);
    w_add(S, C_MX, C_NP, C_A, C_SCR);                   // a = [x]P - P
    w_mul_x(S, C_A, C_MX, C_SCR);
    w_add(S, C_MX, C_NP, C_R, C_SCR);                   // [x]a - P
    w_psi(S, C_A, C_T);
    w_add(S, C_R, C_T, C_R, C_SCR);                     // + psi(a)
    w_dbl(S, C_P, C_T, C_SCR);
    w_psi(S, C_T, C_T);
    w_psi(S, C_T, C_T);
    w_add(S, C_R, C_T, C_R, C_SCR);                     // + psi^2(2P)
}

// row i: the sum of its two draws, cleared, to affine words (one Euclid
// inversion, as g2_to_affine<true>); infinity gives (0, 0)
DEVNI void h2c_row(wst* S, long i, const int32_t* u0, const int32_t* u1, int32_t* out) {
    fq2* r = S->r;
    fp* f = S->f;
    map_draws(S, i, u0, u1);
    w_add(S, H_X, H_N + H_X, C_P, C_SCR);
    clear_cofactor(S);
    w_fp(S, 2, [&](int k, fp& x, fp& y) { x = y = k ? r[C_R + 2].c1 : r[C_R + 2].c0; },
         [&](int k, const fp& v) { f[F_SQ + k] = v; });
    WARP_FOR(j, 1) {
        fp v = fp_inv_euclid(fp_add(f[F_SQ], f[F_SQ + 1]));
        if (own) f[F_INV] = v;
    } WARP_END
    w_fp(S, 2, [&](int k, fp& x, fp& y) { x = k ? r[C_R + 2].c1 : r[C_R + 2].c0; y = f[F_INV]; },
         [&](int k, const fp& v) { ((fp*)(r + C_ZI))[k] = k ? fp_neg(v) : v; });
    w_prod(S, 1, [&](int, fq2& x, fq2& y) { x = y = r[C_ZI]; },
           [&](int, const fq2& v) { r[C_ZI2] = v; });
    w_prod(S, 2, [&](int k, fq2& x, fq2& y) { x = k ? r[C_ZI] : r[C_R]; y = r[C_ZI2]; },
           [&](int k, const fq2& v) { r[k ? C_ZI3 : C_AX] = v; });
    w_prod(S, 1, [&](int, fq2& x, fq2& y) { x = r[C_R + 1]; y = r[C_ZI3]; },
           [&](int, const fq2& v) { r[C_AY] = v; });
    w_from_mont(S, 4, [&](int k) { return ((const fp*)(r + (k < 2 ? C_AX : C_AY)))[k & 1]; },
                [&](int k, const fp& v) { words_store(out + 48 * i + 12 * k, v); });
}

WARP_KERNEL(h2c_row, (const int32_t* u0, const int32_t* u1, int32_t* out), u0, u1, out)

extern "C" int h2c(const int32_t* u0, const int32_t* u1, int32_t* out, long n, void* stream) {
    WARP_LAUNCH(n, h2c_row, u0, u1, out);
    return 0;
}
