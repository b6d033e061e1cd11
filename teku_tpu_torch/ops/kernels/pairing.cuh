// pairing.cuh -- the optimal-ate Miller loop and the final exponentiation.
//
// Shared by pairing.cu (miller, finish) and kzg.cu (kzg_fold): the
// reference's doubling / addition line formulas (teku_tpu/ops/pairing.py:
// _dbl_step, _add_step), its sparse line multiply (_mul_by_line) and its
// final exponentiation chain, so Miller values equal the reference's.
// Every function is __noinline__ (compile time and registers: one Fq12 is
// 144 words).

#pragma once
#include "fp381.cuh"

struct line_t { fq2 c0, c1, c2; };

DEVNI g2p dbl_step(const g2p& t, const fp& px_neg, const fp& py, line_t* l) {
    fq2 A = fq2_sqr(t.x), B = fq2_sqr(t.y), Z2 = fq2_sqr(t.z);
    fq2 XB = fq2_add(t.x, B), E = fq2_add(fq2_add(A, A), A);
    fq2 XB2 = fq2_sqr(XB), Cc = fq2_sqr(B), Fv = fq2_sqr(E), YZ = fq2_mul(t.y, t.z);
    fq2 D = fq2_sub(fq2_sub(XB2, A), Cc);
    D = fq2_add(D, D);
    g2p r;
    r.z = fq2_add(YZ, YZ);
    r.x = fq2_sub(Fv, fq2_add(D, D));
    fq2 C2 = fq2_add(Cc, Cc), C4 = fq2_add(C2, C2), C8 = fq2_add(C4, C4);
    r.y = fq2_sub(fq2_mul(E, fq2_sub(D, r.x)), C8);
    l->c0 = fq2_mul_fp(fq2_mul_by_xi(fq2_mul(r.z, Z2)), py);
    l->c1 = fq2_sub(fq2_mul(E, t.x), fq2_add(B, B));
    l->c2 = fq2_mul_fp(fq2_mul(E, Z2), px_neg);
    return r;
}

DEVNI g2p add_step(const g2p& t, const fq2& xq, const fq2& yq, const fp& px_neg, const fp& py,
                   line_t* l) {
    fq2 Z2 = fq2_sqr(t.z);
    fq2 U2 = fq2_mul(xq, Z2), Z3cu = fq2_mul(Z2, t.z);
    fq2 S2 = fq2_mul(yq, Z3cu);
    fq2 H = fq2_sub(U2, t.x), rr = fq2_sub(S2, t.y);
    fq2 H2 = fq2_sqr(H), R2 = fq2_sqr(rr);
    g2p r;
    r.z = fq2_mul(t.z, H);
    fq2 H3 = fq2_mul(H, H2), V = fq2_mul(t.x, H2);
    r.x = fq2_sub(fq2_sub(R2, H3), fq2_add(V, V));
    r.y = fq2_sub(fq2_mul(rr, fq2_sub(V, r.x)), fq2_mul(t.y, H3));
    l->c0 = fq2_mul_fp(fq2_mul_by_xi(r.z), py);
    l->c1 = fq2_sub(fq2_mul(rr, xq), fq2_mul(yq, r.z));
    l->c2 = fq2_mul_fp(rr, px_neg);
    return r;
}

// a * (c1 v + c2 v^2) for a in Fq6
DEV fq6 mul_by_c12(const fq6& a, const fq2& c1, const fq2& c2) {
    return fq6_make(fq2_mul_by_xi(fq2_add(fq2_mul(a.c1, c2), fq2_mul(a.c2, c1))),
                    fq2_add(fq2_mul(a.c0, c1), fq2_mul_by_xi(fq2_mul(a.c2, c2))),
                    fq2_add(fq2_mul(a.c0, c2), fq2_mul(a.c1, c1)));
}

// f * (c0 + (c1 v + c2 v^2) w)
DEVNI fq12 mul_by_line(const fq12& f, const line_t& l) {
    fq6 t1 = mul_by_c12(f.c1, l.c1, l.c2);
    fq6 s0 = mul_by_c12(f.c0, l.c1, l.c2);
    fq6 f0c0 = fq6_mul_by_fq2(f.c0, l.c0), f1c0 = fq6_mul_by_fq2(f.c1, l.c0);
    return fq12_make(fq6_add(f0c0, fq6_mul_by_v(t1)), fq6_add(s0, f1c0));
}

// Miller loop over the bits of |z| below the top bit; conjugated (z < 0)
DEVNI fq12 miller_loop(const fp& px, const fp& py, const fq2& qx, const fq2& qy) {
    fp px_neg = fp_neg(px);
    g2p t;
    t.x = qx;
    t.y = qy;
    t.z = fq2_one();
    fq12 f = fq12_one();
    line_t l;
    for (int i = E_XABS_BITS - 2; i >= 0; i--) {
        f = fq12_sqr(f);
        t = dbl_step(t, px_neg, py, &l);
        f = mul_by_line(f, l);
        if ((E_XABS[i >> 5] >> (i & 31)) & 1) {
            t = add_step(t, qx, qy, px_neg, py, &l);
            f = mul_by_line(f, l);
        }
    }
    return fq12_conj(f);
}

DEVNI fq12 pow_z(const fq12& f) {
    fq12 r = f;
    for (int i = E_XABS_BITS - 2; i >= 0; i--) {
        r = fq12_sqr(r);
        if ((E_XABS[i >> 5] >> (i & 31)) & 1) r = fq12_mul(r, f);
    }
    return fq12_conj(r);
}

// f^(3 (p^12 - 1) / r): the reference's chain (pairing.py:final_exponentiation)
DEVNI fq12 final_exponentiation(const fq12& f) {
    fq12 g = fq12_mul(fq12_conj(f), fq12_inv(f));
    g = fq12_mul(fq12_frobenius(g, 2), g);
    fq12 a = fq12_mul(pow_z(g), fq12_conj(g));
    a = fq12_mul(pow_z(a), fq12_conj(a));
    fq12 b = fq12_mul(pow_z(a), fq12_frobenius(a, 1));
    fq12 c = fq12_mul(fq12_mul(pow_z(pow_z(b)), fq12_frobenius(b, 2)), fq12_conj(b));
    return fq12_mul(c, fq12_mul(fq12_sqr(g), g));
}

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
