// pairing.cuh -- the optimal-ate Miller loop and the final exponentiation.
//
// Shared by pairing.cu (miller, finish) and kzg.cu (kzg_fold): the
// reference's doubling / addition line formulas (teku_tpu/ops/pairing.py:
// _dbl_step, _add_step), its sparse line multiply (_mul_by_line) and its
// final exponentiation chain, so Miller values equal the reference's.
// Every Miller loop and final exponentiation runs on the cooperative
// routines below (one block of two warps a value): coop_dbl_step,
// coop_add_step and coop_fq12_mul_by_line compute the reference's line
// values in parallel rounds.  Every function is __noinline__ (compile time
// and registers: one Fq12 is 144 words).

#pragma once
#include "fp381.cuh"

// One level of the reference's halving reductions over the leading axis
// (points.py:point_batch_sum, pairing.py:batch_product), on rows of
// canonical words in place: x[i] = x[i] op x[i + half] for i < half, and
// for an odd count the last row then moves to row half (tail_pass, a
// launch of its own: the pass's thread 0 reads row half).  The order is
// the plain version's, so a Jacobian sum equals it word for word.
DEVNI void fq12_prod_pass(long i, int32_t* x, long half) {
    fq12_store(x + 144 * i, fq12_mul(fq12_load(x + 144 * i), fq12_load(x + 144 * (i + half))));
}

DEVNI void g2_sum_pass(long i, int32_t* x, long half) {
    g2_store(x + 72 * i, pt_add(g2_load(x + 72 * i), g2_load(x + 72 * (i + half))));
}

// one thread per word: row n - 1 -> row n / 2 (n odd)
DEVNI void tail_pass(long w, int32_t* x, long n, long width) {
    if (LIVE) x[(n / 2) * width + w] = x[(n - 1) * width + w];
}

#ifdef __CUDACC__
__global__ void fq12_prod_pass_kernel(long n, int32_t* x, long half) {
    SHELL(n, fq12_prod_pass(ix, x, half));
}

__global__ void g2_sum_pass_kernel(long n, int32_t* x, long half) {
    SHELL(n, g2_sum_pass(ix, x, half));
}

__global__ void tail_pass_kernel(long n_words, int32_t* x, long n, long width) {
    SHELL(n_words, tail_pass(ix, x, n, width));
}
#endif

// reduce n rows of `width` words at x into row 0, one launch per level
#define HALVING(n, pass, x, width)                                               \
    for (long m_ = (n); m_ > 1; m_ = m_ / 2 + (m_ & 1)) {                        \
        LAUNCH(m_ / 2, pass, x, m_ / 2);                                         \
        if (m_ & 1) LAUNCH(width, tail_pass, x, m_, (long)(width));              \
    }

// --------------------------------------------------------------------------
// Cooperative routines: one block of COOP_LANES threads works on one value
// --------------------------------------------------------------------------
//
// A Miller loop and a final exponentiation are ~20,000 dependent Fq
// products, 22 and 38 ms on one thread.  Here a block of two warps holds its
// Fq12 values in shared memory (coop_t) and spreads each operation's
// independent products over its 64 lanes; its latency is then one or a few
// products plus the adds that combine them:
//
//   coop_fq12_mul   a b over the w basis (w^6 = xi): the 36 Fq2 products
//                   a_i b_j one a lane (fq2_mul, 3 Fq products in series),
//                   then 6 lanes sum a coefficient each (108 Fq products
//                   would need two rounds and more shared memory than the
//                   mma build leaves)
//   coop_fq12_sqr, coop_fq12_mul_by_line   the 21 products a_i a_j (i <= j)
//                   and the 18 a_i l_j of the sparse Miller line, one
//                   Karatsuba Fq product a lane (3 lanes a pair)
//   coop_cyclo_sqr  Granger-Scott, as towers.py fq12_cyclo_sqr: 9 Fq2
//                   squares at 2 lanes each, 6 lanes combine; cyclotomic
//                   values only (the pow_z squares, as the reference's)
//   coop_dbl_step / coop_add_step   the reference's line formulas
//                   (teku_tpu/ops/pairing.py:_dbl_step, _add_step) in
//                   3 / 5 rounds of at most 7 independent Fq2 products at
//                   3 lanes each (coop_round), in place of 31 / 40
//                   products in series
//   coop_final_exp  the reference's chain (pairing.py:final_exponentiation); the
//                   Fq12 inverse stays serial, its Fq inverse the binary
//                   extended Euclid (fp_inv_euclid), as the affine sum's in
//                   finish
//
// Latency an operation, measured by chip_smoke.py on an H100 80GB HBM3 at
// 700 W (65 in one launch less one, over 64): product 10.3 us, square 6.7,
// cyclotomic square 5.0 (the mma build 25.0, 11.7, 11.0), where fq12_mul on
// one thread runs 54 products in series; a final exponentiation 2.5 ms
// against the one-thread routine's 37.6 (the Miller loop 2.0 against
// 22.0).  The adds that combine the products cost about as much as the
// products.
//
// Fq12 values are unique in [0, P) per component, so every routine gives
// the plain version's words; the Miller line coefficients keep the
// reference's formulas (they fix the projective representative).
//
// Phases.  COOP_FOR(j, n) { ... } COOP_END runs a body for j < n: on the
// card on lane j = threadIdx.x, then a block barrier; in the host build a
// loop over j.  A phase reads no slot that another lane of the same phase
// writes, so both forms give the same words and the CPU tests check the
// card's arithmetic.  Under the mma engine every product is a whole-warp
// instruction: every lane runs every phase, the lanes past n repeat job
// n - 1 with their stores off (`own`), and the lanes reconverge before a
// product (WARP_CONVERGE).  A serial section is COOP_FOR(j, 1).

#define COOP_LANES THREADS          // two warps (mma_digits.cuh sizes its buffers so)

#ifdef __CUDACC__
#define COOP_FOR(j, n)                                                           \
    {                                                                            \
        const int n_ = (n);                                                      \
        const bool own = (int)threadIdx.x < n_;                                  \
        if (EVERY_LANE || own) {                                                 \
            const int j = own ? (int)threadIdx.x : n_ - 1;
#define COOP_END                                                                 \
        }                                                                        \
        __syncthreads();                                                         \
    }
#else
#define COOP_FOR(j, n)                                                           \
    for (int j = 0; j < (n); j++) {                                              \
        const bool own = true;                                                   \
        {
#define COOP_END                                                                 \
        }                                                                        \
    }
#endif

// Fq2 registers: the Miller point T, Q affine, P as Fq2 (-px, 0) and
// (py, 0); scratch from R_FREE (an Fq12 product's 36 products, or a Miller
// step's temporaries and, from R_PARTS, a round's Fq products)
enum { R_TX, R_TY, R_TZ, R_XQ, R_YQ, R_PX, R_PY, R_FREE, R_PARTS = R_FREE + 18,
       R_COUNT = R_FREE + 36 };

struct coop_t {
    fq12 f[4];                      // Fq12 slots (Montgomery form)
    fq2 r[R_COUNT];
    int flag;
};

// component k of an Fq12 in struct order: c0.c0, c0.c1, c0.c2, c1.c0, c1.c1, c1.c2
DEV fq2* fq12_at(fq12* a, int k) { return (fq2*)a + k; }
// coefficient of w^i (w^2 = v): c0.c0, c1.c0, c0.c1, c1.c1, c0.c2, c1.c2
DEV fq2* fq12_w(fq12* a, int i) { return (fq2*)a + ((i & 1) ? 3 + (i >> 1) : (i >> 1)); }

// jobs q < n (n <= 7): *o[q] = *a[q] * *b[q], one Fq product a lane
DEVNI void coop_round(coop_t* S, int n, fq2* const* a, fq2* const* b, fq2* const* o) {
    fp* part = (fp*)(S->r + R_PARTS);
    COOP_FOR(j, 3 * n) {
        fp x = kara_part(*a[j / 3], j % 3), y = kara_part(*b[j / 3], j % 3);
        WARP_CONVERGE();
        fp v = fp_mul(x, y);
        if (own) part[j] = v;
    } COOP_END
    COOP_FOR(q, n) {
        fq2 v = kara_join(part + 3 * q);
        if (own) *o[q] = v;
    } COOP_END
}

// out = a * b (out may be a or b)
DEVNI void coop_fq12_mul(coop_t* S, fq12* out, fq12* a, fq12* b) {
    fq2* prod = S->r + R_FREE;
    COOP_FOR(j, 36) {
        WARP_CONVERGE();
        fq2 v = fq2_mul(*fq12_w(a, j / 6), *fq12_w(b, j % 6));
        if (own) prod[j] = v;
    } COOP_END
    COOP_FOR(k, 6) {
        fq2 lo = fq2_zero(), hi = fq2_zero();
        for (int i = 0; i < 6; i++) {
            int m = k - i;          // w^i w^m = w^k, or w^(k + 6) = xi w^k
            fq2 s = fq2_add(m >= 0 ? lo : hi, prod[6 * i + (m + 6) % 6]);
            if (m >= 0) lo = s;
            else hi = s;
        }
        fq2 v = fq2_add(lo, fq2_mul_by_xi(hi));
        if (own) *fq12_w(out, k) = v;
    } COOP_END
}

// a^2 over the w basis: the 21 products a_i a_j (i <= j) one Fq product a
// lane (three lanes a pair, kara_part); output coefficient k sums
// a_i a_((k - i) mod 6) over i, so a pair with i != j counts twice
DEVNI void coop_fq12_sqr(coop_t* S, fq12* out, fq12* a) {
    fp* part = (fp*)(S->r + R_FREE);
    COOP_FOR(l, 63) {
        int p = l / 3, i = 0;
        while (p >= 6 - i) {                    // pair (i, i + p)
            p -= 6 - i;
            i++;
        }
        fp x = kara_part(*fq12_w(a, i), l % 3), y = kara_part(*fq12_w(a, i + p), l % 3);
        WARP_CONVERGE();
        fp v = fp_mul(x, y);
        if (own) part[l] = v;
    } COOP_END
    COOP_FOR(k, 6) {
        fq2 lo = fq2_zero(), hi = fq2_zero();
        for (int i = 0; i < 6; i++) {
            int j = (k - i + 6) % 6, m = i < j ? i : j, n = i + j - m;
            fq2 s = fq2_add(i + j < 6 ? lo : hi, kara_join(part + 3 * (6 * m - m * (m - 1) / 2 + n - m)));
            if (i + j < 6) lo = s;
            else hi = s;
        }
        fq2 v = fq2_add(lo, fq2_mul_by_xi(hi));
        if (own) *fq12_w(out, k) = v;
    } COOP_END
}

// out = a * line, the line's c0, c1, c2 in c0.c0, c1.c1, c1.c2 (w^0, w^3,
// w^5): the 18 products a_i l_j one Fq product a lane
DEVNI void coop_fq12_mul_by_line(coop_t* S, fq12* out, fq12* a, fq12* line) {
    fp* part = (fp*)(S->r + R_FREE);
    COOP_FOR(l, 54) {
        int i = l / 9, t = l / 3 % 3;           // pair (i, j = 0, 3, 5 for t = 0, 1, 2)
        fp x = kara_part(*fq12_w(a, i), l % 3);
        fp y = kara_part(*fq12_w(line, 2 * t + (t > 0)), l % 3);
        WARP_CONVERGE();
        fp v = fp_mul(x, y);
        if (own) part[l] = v;
    } COOP_END
    COOP_FOR(k, 6) {
        fq2 lo = fq2_zero(), hi = fq2_zero();
        for (int t = 0; t < 3; t++) {
            int j = 2 * t + (t > 0), i = (k - j + 6) % 6;
            fq2 s = fq2_add(i + j < 6 ? lo : hi, kara_join(part + 3 * (3 * i + t)));
            if (i + j < 6) lo = s;
            else hi = s;
        }
        fq2 v = fq2_add(lo, fq2_mul_by_xi(hi));
        if (own) *fq12_w(out, k) = v;
    } COOP_END
}

// out = a^2 for a in the cyclotomic subgroup (Granger-Scott, as towers.py
// fq12_cyclo_sqr): the Fq4 squares of (c0.c0, c1.c1), (c1.c0, c0.c2) and
// (c0.c1, c1.c2), each from x^2, y^2 and (x + y)^2
DEVNI void coop_cyclo_sqr(coop_t* S, fq12* out, fq12* a) {
    const int px[3] = {0, 3, 1}, py[3] = {4, 2, 5};
    const int pair_of[6] = {0, 1, 2, 2, 0, 1};
    fp* part = (fp*)(S->r + R_FREE);
    // the squares of x, y and x + y of each pair, as fq2_sqr: lane 2 i
    // (c0 + c1)(c0 - c1), lane 2 i + 1 c0 c1 of square i
    COOP_FOR(j, 18) {
        int i = j / 2;
        const fq2& x = *fq12_at(a, px[i / 3]);
        const fq2& y = *fq12_at(a, py[i / 3]);
        fq2 s = fq2_add(x, y);
        if (i % 3 == 0) s = x;
        if (i % 3 == 1) s = y;
        fp sum = fp_add(s.c0, s.c1), dif = fp_sub(s.c0, s.c1);
        bool cross = j % 2;
        WARP_CONVERGE();
        fp v = fp_mul(cross ? s.c0 : sum, cross ? s.c1 : dif);
        if (own) part[j] = v;
    } COOP_END
    COOP_FOR(k, 6) {
        const fp* p = part + 6 * pair_of[k];
        fq2 t[3];
        for (int i = 0; i < 3; i++) t[i] = fq2_make(p[2 * i], fp_dbl(p[2 * i + 1]));
        // the pair's Fq4 square: x^2 + xi y^2 (k < 3), 2 x y (k >= 3)
        fq2 c = k < 3 ? fq2_add(t[0], fq2_mul_by_xi(t[1]))
                      : fq2_sub(fq2_sub(t[2], t[0]), t[1]);
        if (k == 3) c = fq2_mul_by_xi(c);
        fq2 c3 = fq2_add(fq2_add(c, c), c);
        fq2 z = *fq12_at(a, k);
        fq2 z2 = fq2_add(z, z);
        fq2 v = k < 3 ? fq2_sub(c3, z2) : fq2_add(c3, z2);
        if (own) *fq12_at(out, k) = v;
    } COOP_END
}

DEVNI void coop_fq12_conj(fq12* out, fq12* a) {
    COOP_FOR(k, 6) {
        fq2 v = *fq12_at(a, k);
        if (k >= 3) v = fq2_neg(v);
        if (own) *fq12_at(out, k) = v;
    } COOP_END
}

// out = a^(p^power): each lane one component, conj then two constant
// products (1 where fq12_frobenius has none, so every lane runs the same)
DEVNI void coop_fq12_frobenius(fq12* out, fq12* a, int power) {
    for (int p = 0; p < power; p++) {
        COOP_FOR(k, 6) {
            fq2 g[3] = {fq2_one(), K_FROB6_C1, K_FROB6_C2};
            fq2 h = k < 3 ? fq2_one() : K_FROB12_C1;
            fq2 x = fq2_conj(*fq12_at(p == 0 ? a : out, k));
            WARP_CONVERGE();
            fq2 v = fq2_mul(fq2_mul(x, g[k % 3]), h);
            if (own) *fq12_at(out, k) = v;
        } COOP_END
    }
}

// out = a^-1: serial, its Fq inverse by the binary extended Euclid
DEVNI void coop_fq12_inv(fq12* out, fq12* a) {
    COOP_FOR(j, 1) {
        fq12 v = fq12_inv<true>(*a);
        if (own) *out = v;
    } COOP_END
}

// out = x^z for cyclotomic x (out != x)
DEVNI void coop_pow_z(coop_t* S, fq12* out, fq12* x) {
    for (int i = E_XABS_BITS - 2; i >= 0; i--) {
        coop_cyclo_sqr(S, out, i == E_XABS_BITS - 2 ? x : out);
        if ((E_XABS[i >> 5] >> (i & 31)) & 1) coop_fq12_mul(S, out, out, x);
    }
    coop_fq12_conj(out, out);
}

// slot 1 = slot 0^(3 (p^12 - 1) / r), the reference's chain; slots 0-3 used
DEVNI void coop_final_exp(coop_t* S) {
    fq12 *s0 = &S->f[0], *s1 = &S->f[1], *s2 = &S->f[2], *s3 = &S->f[3];
    coop_fq12_inv(s1, s0);                          // g = conj(f) / f
    coop_fq12_conj(s2, s0);
    coop_fq12_mul(S, s0, s2, s1);
    coop_fq12_frobenius(s1, s0, 2);                 // g = g^(p^2) g
    coop_fq12_mul(S, s0, s1, s0);
    coop_pow_z(S, s1, s0);                          // a = g^z conj(g)
    coop_fq12_conj(s2, s0);
    coop_fq12_mul(S, s1, s1, s2);
    coop_pow_z(S, s2, s1);                          // a = a^z conj(a)
    coop_fq12_conj(s3, s1);
    coop_fq12_mul(S, s1, s2, s3);
    coop_pow_z(S, s2, s1);                          // b = a^z a^p
    coop_fq12_frobenius(s3, s1, 1);
    coop_fq12_mul(S, s2, s2, s3);
    coop_pow_z(S, s3, s2);                          // c = b^(z^2) b^(p^2) conj(b)
    coop_pow_z(S, s1, s3);
    coop_fq12_frobenius(s3, s2, 2);
    coop_fq12_mul(S, s1, s1, s3);
    coop_fq12_conj(s3, s2);
    coop_fq12_mul(S, s1, s1, s3);
    coop_cyclo_sqr(S, s2, s0);                      // c g^3
    coop_fq12_mul(S, s2, s2, s0);
    coop_fq12_mul(S, s1, s1, s2);
}

// the doubling step (teku_tpu/ops/pairing.py:_dbl_step) on T = R_TX..R_TZ;
// the line's c0, c1, c2 go to `line`'s c0.c0, c1.c1, c1.c2
enum { D_A = R_FREE, D_B, D_Z2, D_YZ, D_E, D_XB, D_RZ, D_XB2, D_CC, D_FV, D_EX, D_EZ2, D_RZZ2,
       D_RX, D_DMX, D_XIT, D_ED };

DEVNI void coop_dbl_step(coop_t* S, fq12* line) {
    fq2* r = S->r;
    fq2* l = fq12_at(line, 0);
    {
        fq2* a[4] = {&r[R_TX], &r[R_TY], &r[R_TZ], &r[R_TY]};
        fq2* b[4] = {&r[R_TX], &r[R_TY], &r[R_TZ], &r[R_TZ]};
        fq2* o[4] = {&r[D_A], &r[D_B], &r[D_Z2], &r[D_YZ]};
        coop_round(S, 4, a, b, o);
    }
    COOP_FOR(j, 3) {
        fq2 v = fq2_add(r[D_YZ], r[D_YZ]);                          // r.z
        if (j == 0) v = fq2_add(fq2_add(r[D_A], r[D_A]), r[D_A]);   // E
        if (j == 1) v = fq2_add(r[R_TX], r[D_B]);                   // XB
        if (own) r[D_E + j] = v;
    } COOP_END
    {
        fq2* a[6] = {&r[D_XB], &r[D_B], &r[D_E], &r[D_E], &r[D_E], &r[D_RZ]};
        fq2* b[6] = {&r[D_XB], &r[D_B], &r[D_E], &r[R_TX], &r[D_Z2], &r[D_Z2]};
        fq2* o[6] = {&r[D_XB2], &r[D_CC], &r[D_FV], &r[D_EX], &r[D_EZ2], &r[D_RZZ2]};
        coop_round(S, 6, a, b, o);
    }
    COOP_FOR(j, 3) {
        if (j == 0) {
            fq2 d = fq2_sub(fq2_sub(r[D_XB2], r[D_A]), r[D_CC]);
            d = fq2_add(d, d);
            fq2 x = fq2_sub(r[D_FV], fq2_add(d, d));
            if (own) {
                r[D_RX] = x;
                r[D_DMX] = fq2_sub(d, x);
            }
        } else if (j == 1) {
            fq2 v = fq2_sub(r[D_EX], fq2_add(r[D_B], r[D_B]));
            if (own) l[4] = v;                                      // l.c1
        } else {
            fq2 v = fq2_mul_by_xi(r[D_RZZ2]);
            if (own) r[D_XIT] = v;
        }
    } COOP_END
    {
        fq2* a[3] = {&r[D_E], &r[D_XIT], &r[D_EZ2]};
        fq2* b[3] = {&r[D_DMX], &r[R_PY], &r[R_PX]};
        fq2* o[3] = {&r[D_ED], &l[0], &l[5]};                       // l.c0, l.c2
        coop_round(S, 3, a, b, o);
    }
    COOP_FOR(j, 1) {
        fq2 c2 = fq2_add(r[D_CC], r[D_CC]), c4 = fq2_add(c2, c2);
        fq2 y = fq2_sub(r[D_ED], fq2_add(c4, c4));
        if (own) {
            r[R_TX] = r[D_RX];
            r[R_TY] = y;
            r[R_TZ] = r[D_RZ];
        }
    } COOP_END
}

// the addition step (teku_tpu/ops/pairing.py:_add_step; Q = R_XQ, R_YQ)
enum { A_Z2 = R_FREE, A_U2, A_Z3, A_H, A_S2, A_H2, A_RZ, A_RR, A_XIR, A_R2, A_H3, A_V, A_RRXQ,
       A_YQRZ, A_RX, A_VMX, A_RYA, A_RYB };

DEVNI void coop_add_step(coop_t* S, fq12* line) {
    fq2* r = S->r;
    fq2* l = fq12_at(line, 0);
    {
        fq2* a[1] = {&r[R_TZ]};
        fq2* o[1] = {&r[A_Z2]};
        coop_round(S, 1, a, a, o);
    }
    {
        fq2* a[2] = {&r[R_XQ], &r[A_Z2]};
        fq2* b[2] = {&r[A_Z2], &r[R_TZ]};
        fq2* o[2] = {&r[A_U2], &r[A_Z3]};
        coop_round(S, 2, a, b, o);
    }
    COOP_FOR(j, 1) {
        fq2 h = fq2_sub(r[A_U2], r[R_TX]);
        if (own) r[A_H] = h;
    } COOP_END
    {
        fq2* a[3] = {&r[R_YQ], &r[A_H], &r[R_TZ]};
        fq2* b[3] = {&r[A_Z3], &r[A_H], &r[A_H]};
        fq2* o[3] = {&r[A_S2], &r[A_H2], &r[A_RZ]};
        coop_round(S, 3, a, b, o);
    }
    COOP_FOR(j, 2) {
        fq2 v = j == 0 ? fq2_sub(r[A_S2], r[R_TY]) : fq2_mul_by_xi(r[A_RZ]);
        if (own) r[j == 0 ? A_RR : A_XIR] = v;
    } COOP_END
    {
        fq2* a[7] = {&r[A_RR], &r[A_H], &r[R_TX], &r[A_RR], &r[R_YQ], &r[A_XIR], &r[A_RR]};
        fq2* b[7] = {&r[A_RR], &r[A_H2], &r[A_H2], &r[R_XQ], &r[A_RZ], &r[R_PY], &r[R_PX]};
        fq2* o[7] = {&r[A_R2], &r[A_H3], &r[A_V], &r[A_RRXQ], &r[A_YQRZ], &l[0], &l[5]};
        coop_round(S, 7, a, b, o);
    }
    COOP_FOR(j, 2) {
        if (j == 0) {
            fq2 x = fq2_sub(fq2_sub(r[A_R2], r[A_H3]), fq2_add(r[A_V], r[A_V]));
            if (own) {
                r[A_RX] = x;
                r[A_VMX] = fq2_sub(r[A_V], x);
            }
        } else {
            fq2 v = fq2_sub(r[A_RRXQ], r[A_YQRZ]);
            if (own) l[4] = v;
        }
    } COOP_END
    {
        fq2* a[2] = {&r[A_RR], &r[R_TY]};
        fq2* b[2] = {&r[A_VMX], &r[A_H3]};
        fq2* o[2] = {&r[A_RYA], &r[A_RYB]};
        coop_round(S, 2, a, b, o);
    }
    COOP_FOR(j, 1) {
        fq2 y = fq2_sub(r[A_RYA], r[A_RYB]);
        if (own) {
            r[R_TX] = r[A_RX];
            r[R_TY] = y;
            r[R_TZ] = r[A_RZ];
        }
    } COOP_END
}

// *f = the Miller loop of P = (-R_PX, R_PY) and Q = (R_XQ, R_YQ) over the
// bits of |z| below the top bit, conjugated (z < 0), as the reference's
// pairing.py:miller_loop; `line` is scratch
DEVNI void coop_miller(coop_t* S, fq12* f, fq12* line) {
    COOP_FOR(k, 6) {
        fq2 zero = fq2_zero(), one = fq2_one();
        if (own) {
            *fq12_at(f, k) = k == 0 ? one : zero;
            *fq12_at(line, k) = zero;
            if (k < 2) S->r[R_TX + k] = S->r[R_XQ + k];
            if (k == 2) S->r[R_TZ] = one;
        }
    } COOP_END
    for (int i = E_XABS_BITS - 2; i >= 0; i--) {
        coop_fq12_sqr(S, f, f);
        coop_dbl_step(S, line);
        coop_fq12_mul_by_line(S, f, f, line);
        if ((E_XABS[i >> 5] >> (i & 31)) & 1) {
            coop_add_step(S, line);
            coop_fq12_mul_by_line(S, f, f, line);
        }
    }
    coop_fq12_conj(f, f);
}

// the Miller loop's affine P and Q into their registers (one lane's stores)
DEV void coop_set_pair(coop_t* S, const fp& px, const fp& py, const fq2& qx, const fq2& qy) {
    S->r[R_XQ] = qx;
    S->r[R_YQ] = qy;
    S->r[R_PX] = fq2_make(fp_neg(px), fp_zero());
    S->r[R_PY] = fq2_make(py, fp_zero());
}

DEVNI void coop_fq12_one(fq12* f) {
    COOP_FOR(k, 6) {
        fq2 v = k == 0 ? fq2_one() : fq2_zero();
        if (own) *fq12_at(f, k) = v;
    } COOP_END
}

// canonical words <-> an Fq12 slot, a component a lane
DEVNI void coop_fq12_load(fq12* out, const int32_t* w) {
    COOP_FOR(k, 12) {
        fp v = fp_load(w + 12 * k);
        if (own) ((fp*)out)[k] = v;
    } COOP_END
}

DEVNI void coop_fq12_store(int32_t* w, fq12* a) {
    COOP_FOR(k, 12) {
        fp v = fp_from_mont(((fp*)a)[k]);
        if (own)
            for (int i = 0; i < 12; i++) w[12 * k + i] = (int32_t)v.v[i];
    } COOP_END
}

// A cooperative kernel: one block of COOP_LANES threads per index i, the
// coop_t in shared memory (host build: a loop over i, each with its own)
#ifdef __CUDACC__
#define COOP_LAUNCH(n, fn, ...)                                                  \
    do {                                                                         \
        long n_ = (n);                                                           \
        if (n_ > 0)                                                              \
            fn##_block<<<(unsigned)n_, COOP_LANES, 0, (cudaStream_t)stream>>>(__VA_ARGS__); \
        int e_ = (int)cudaGetLastError();                                        \
        if (e_) return e_;                                                       \
    } while (0)
#define COOP_KERNEL(fn, params, ...)                                             \
    __global__ void fn##_block params {                                          \
        __shared__ coop_t S;                                                     \
        fn(&S, (long)blockIdx.x, __VA_ARGS__);                                   \
    }
#else
#define COOP_LAUNCH(n, fn, ...)                                                  \
    do {                                                                         \
        long n_ = (n);                                                           \
        for (long i_ = 0; i_ < n_; i_++) {                                       \
            coop_t S;                                                            \
            fn(&S, i_, __VA_ARGS__);                                             \
        }                                                                        \
    } while (0)
#define COOP_KERNEL(fn, params, ...)
#endif
