// wcoop.cuh -- Fq2 and G2 arithmetic spread over the lanes of one warp.
//
// Shared by h2c.cu (a warp a message row) and decompress.cu's prepare (a
// warp a lane).  A one-thread chain of Fq2 and G2 operations runs its Fq
// products in series: an Fq2 product is three of them, a G2 doubling
// seven Fq2 products, an addition sixteen.  Here a warp holds its Fq2
// values in shared memory (wst, one a block of 32 threads) and each step
// runs its independent Fq products on separate lanes, so its latency is
// one product, the adds around it and a __syncwarp:
//
//   w_prod        n independent Fq2 products: the three Karatsuba Fq
//                 products of each (kara_part) one a lane, then a lane
//                 joins each (kara_join) -- two phases
//   w_fp          n independent Fq products, one phase
//   w_dbl, w_add  the G2 doubling (dbl-2009-l) and addition (add-2007-bl,
//                 with its selects for infinity, P == Q and P == -Q) of
//                 fp381.cuh, in 3 and 5 rounds of at most 4 Fq2 products
//   w_mul_x       -[|z|]P, pt_mul_static's ladder over those (the
//                 reference's h2c.py mul_x and g2_in_subgroup)
//   w_sqrt_pow    the Fq2 square-root candidate a^((q^2 + 7) / 16) of the
//                 reference's fq2_sqrt (towers.py): with e = e1 q + e0,
//                 a^e = conj(a^e1) a^e0 (the q-power Frobenius of Fq2 is
//                 the conjugate), both halves accumulated right to left off
//                 one chain of 381 squares, one phase a bit, where one
//                 thread's square-and-multiply runs 759 squares and ~380
//                 products in series
//
// Every value is the unique one in [0, P) of the same formula, so the
// outputs equal the one-thread routines' and the plain versions' words;
// the G2 formulas are fp381.cuh's, so Jacobian coordinates are too.
//
// Phases.  WARP_FOR(j, n) { ... } WARP_END runs a body for j < n: on the
// card job j on lane j % 32 (a lane runs jobs j, j + 32, ... in turn),
// then __syncwarp; in the host build a loop over j.  A phase reads no slot
// that another job of it writes, so both forms give the same words and
// the CPU tests check the card's arithmetic.  Under the mma engine every
// product is a whole-warp instruction: every lane runs every pass, the
// lanes past n repeat job n - 1 with their stores off (`own`), a product
// that depends on data is computed on every lane and selected (WHEN), and
// the lanes reconverge before each product (WARP_CONVERGE).  A warp is a
// whole block, so a group never straddles a partial warp, and the warps
// need no block barrier.

#pragma once
#include "fp381.cuh"

#ifdef __CUDACC__
#define WARP_FOR(j, n)                                                           \
    {                                                                            \
        const int wn_ = (n);                                                     \
        const int wl_ = (int)(threadIdx.x & 31);                                 \
        for (int wb_ = 0; wb_ < wn_; wb_ += 32) {                                \
            const bool own = wb_ + wl_ < wn_;                                    \
            if (EVERY_LANE || own) {                                             \
                const int j = own ? wb_ + wl_ : wn_ - 1;
#define WARP_END                                                                 \
            }                                                                    \
        }                                                                        \
        __syncwarp();                                                            \
    }
#else
#define WARP_FOR(j, n)                                                           \
    for (int j = 0, wn_ = (n); j < wn_; j++) {                                   \
        const bool own = true;                                                   \
        {
#define WARP_END                                                                 \
        }                                                                        \
    }
#endif

enum { W_REGS = 176, W_PARTS = 96, W_FPS = 48 };

// a warp's working set: Fq2 slots, the Karatsuba parts of a round, Fq
// slots and flags (Montgomery form)
struct wst {
    fq2 r[W_REGS];
    fp part[W_PARTS];
    fp f[W_FPS];
    int flag[4];
};

// One round of n Fq2 products: opnd(t, x, y) gives product t's operands,
// out(t, v) stores its value (own lanes only: no product in out)
template <class OP> DEV void w_parts(wst* S, int n, OP opnd) {
    WARP_FOR(j, 3 * n) {
        fq2 x, y;
        opnd(j / 3, x, y);
        fp a = kara_part(x, j % 3), b = kara_part(y, j % 3);
        WARP_CONVERGE();
        fp v = fp_mul(a, b);
        if (own) S->part[j] = v;
    } WARP_END
}

template <class OP, class OUT> DEV void w_prod(wst* S, int n, OP opnd, OUT out) {
    w_parts(S, n, opnd);
    WARP_FOR(t, n) {
        fq2 v = kara_join(S->part + 3 * t);
        if (own) out(t, v);
    } WARP_END
}

// n Fq products in one phase
template <class OP, class OUT> DEV void w_fp(wst* S, int n, OP opnd, OUT out) {
    WARP_FOR(t, n) {
        fp x, y;
        opnd(t, x, y);
        WARP_CONVERGE();
        fp v = fp_mul(x, y);
        if (own) out(t, v);
    } WARP_END
}

// n values out of Montgomery form in one phase: out(t, v) gets the
// canonical plain words of in(t)
template <class IN, class OUT> DEV void w_from_mont(wst* S, int n, IN in, OUT out) {
    w_fp(S, n, [&](int t, fp& x, fp& y) {
        x = in(t);
        y = fp_zero();
        y.v[0] = 1;
    }, out);
}

DEV void words_store(int32_t* w, const fp& v) {
    for (int k = 0; k < 12; k++) w[k] = (int32_t)v.v[k];
}

// r[o + k] = r[p + k], k < n
DEVNI void w_copy(wst* S, int p, int o, int n) {
    WARP_FOR(k, n) {
        fq2 v = S->r[p + k];
        if (own) S->r[o + k] = v;
    } WARP_END
}

// point o = dbl(point p) (o may be p); scratch t .. t + 5
DEVNI void w_dbl(wst* S, int p, int o, int t) {
    fq2* r = S->r;
    // A = X^2, B = Y^2, YZ = Y Z
    w_prod(S, 3, [&](int k, fq2& x, fq2& y) {
        x = r[p + (k > 0)];
        y = r[p + k];
    }, [&](int k, const fq2& v) { r[t + k] = v; });
    // (X + B)^2, C = B^2, F = E^2 with E = 3 A
    w_prod(S, 3, [&](int k, fq2& x, fq2& y) {
        fq2 a = r[t], b = r[t + 1];
        fq2 e = fq2_add(fq2_add(a, a), a);
        x = k == 0 ? fq2_add(r[p], b) : k == 1 ? b : e;
        y = x;
    }, [&](int k, const fq2& v) { r[t + 3 + k] = v; });
    // E (D - X3): D = 2 ((X + B)^2 - A - C), X3 = F - 2 D; Y3 = E (D - X3) - 8 C
    w_prod(S, 1, [&](int, fq2& x, fq2& y) {
        fq2 a = r[t];
        fq2 d = fq2_sub(fq2_sub(r[t + 3], a), r[t + 4]);
        d = fq2_add(d, d);
        x = fq2_add(fq2_add(a, a), a);
        y = fq2_sub(d, fq2_sub(r[t + 5], fq2_add(d, d)));
    }, [&](int, const fq2& v) {
        fq2 d = fq2_sub(fq2_sub(r[t + 3], r[t]), r[t + 4]);
        d = fq2_add(d, d);
        fq2 c2 = fq2_add(r[t + 4], r[t + 4]), c4 = fq2_add(c2, c2);
        r[o] = fq2_sub(r[t + 5], fq2_add(d, d));
        r[o + 1] = fq2_sub(v, fq2_add(c4, c4));
        r[o + 2] = fq2_add(r[t + 2], r[t + 2]);
    });
}

// point o = add(point p, point q) (o may be p or q); scratch t .. t + 24
DEVNI void w_add(wst* S, int p, int q, int o, int t) {
    fq2* r = S->r;
    enum { Z1Z1, Z2Z2, Z1Z2, U1, U2, T1, T2, S1, S2, I, ZZ, J, V, R2, RVX, S1J, DB = 16 };
    // Z1^2, Z2^2, Z1 Z2
    w_prod(S, 3, [&](int k, fq2& x, fq2& y) {
        x = r[(k == 1 ? q : p) + 2];
        y = r[(k == 0 ? p : q) + 2];
    }, [&](int k, const fq2& v) { r[t + Z1Z1 + k] = v; });
    // U1 = X1 Z2Z2, U2 = X2 Z1Z1, Z2 Z2Z2, Z1 Z1Z1
    w_prod(S, 4, [&](int k, fq2& x, fq2& y) {
        const int src[4] = {p, q, q + 2, p + 2};
        x = r[src[k]];
        y = r[t + ((k & 1) ? Z1Z1 : Z2Z2)];
    }, [&](int k, const fq2& v) { r[t + U1 + k] = v; });
    // S1 = Y1 Z2^3, S2 = Y2 Z1^3, I = (2 H)^2, Z3 = 2 Z1 Z2 H; H = U2 - U1
    w_prod(S, 4, [&](int k, fq2& x, fq2& y) {
        fq2 h = fq2_sub(r[t + U2], r[t + U1]), h2 = fq2_add(h, h);
        fq2 z12 = fq2_add(r[t + Z1Z2], r[t + Z1Z2]);
        x = k == 0 ? r[p + 1] : k == 1 ? r[q + 1] : k == 2 ? h2 : z12;
        y = k == 0 ? r[t + T1] : k == 1 ? r[t + T2] : k == 2 ? h2 : h;
    }, [&](int k, const fq2& v) { r[t + S1 + k] = v; });
    // J = H I, V = U1 I, rr^2; rr = 2 (S2 - S1)
    w_prod(S, 3, [&](int k, fq2& x, fq2& y) {
        fq2 h = fq2_sub(r[t + U2], r[t + U1]);
        fq2 sd = fq2_sub(r[t + S2], r[t + S1]), rr = fq2_add(sd, sd);
        x = k == 0 ? h : k == 1 ? r[t + U1] : rr;
        y = k == 2 ? rr : r[t + I];
    }, [&](int k, const fq2& v) { r[t + J + k] = v; });
    // rr (V - X3), S1 J; X3 = rr^2 - J - 2 V
    w_prod(S, 2, [&](int k, fq2& x, fq2& y) {
        fq2 sd = fq2_sub(r[t + S2], r[t + S1]), rr = fq2_add(sd, sd);
        fq2 x3 = fq2_sub(fq2_sub(r[t + R2], r[t + J]), fq2_add(r[t + V], r[t + V]));
        x = k == 0 ? rr : r[t + S1];
        y = k == 0 ? fq2_sub(r[t + V], x3) : r[t + J];
    }, [&](int k, const fq2& v) { r[t + RVX + k] = v; });
    // the result and the reference's selects; P == Q doubles below
    WARP_FOR(j, 1) {
        fq2 h = fq2_sub(r[t + U2], r[t + U1]), sd = fq2_sub(r[t + S2], r[t + S1]);
        bool same_x = fq2_is_zero(h), same_y = fq2_is_zero(sd);
        bool p_inf = fq2_is_zero(r[p + 2]), q_inf = fq2_is_zero(r[q + 2]);
        bool finite = !p_inf && !q_inf;
        bool dbl = finite && same_x && same_y;
        g2p out;
        out.x = fq2_sub(fq2_sub(r[t + R2], r[t + J]), fq2_add(r[t + V], r[t + V]));
        out.y = fq2_sub(r[t + RVX], fq2_add(r[t + S1J], r[t + S1J]));
        out.z = r[t + ZZ];
        if (finite && same_x && !same_y) out.z = fq2_zero();
        if (p_inf) out = g2p{r[q], r[q + 1], r[q + 2]};
        if (q_inf && !p_inf) out = g2p{r[p], r[p + 1], r[p + 2]};
        if (own) {
            S->flag[0] = dbl;
            if (!dbl) {
                r[o] = out.x;
                r[o + 1] = out.y;
                r[o + 2] = out.z;
            }
        }
    } WARP_END
    bool dbl = S->flag[0] != 0;
    WHEN(dbl) {
        w_dbl(S, p, t + DB, t + DB + 3);
        WARP_FOR(k, 3) {
            fq2 v = r[t + DB + k];
            if (own && dbl) r[o + k] = v;
        } WARP_END
    }
}

// point o = psi(point p) (o may be p)
DEVNI void w_psi(wst* S, int p, int o) {
    fq2* r = S->r;
    w_prod(S, 2, [&](int k, fq2& x, fq2& y) {
        x = fq2_conj(r[p + k]);
        y = k == 0 ? K_PSI_X : K_PSI_Y;
    }, [&](int k, const fq2& v) {
        r[o + k] = v;
        if (k == 0) r[o + 2] = fq2_conj(r[p + 2]);
    });
}

// point o = -[|z|] (point p) (o != p); scratch t .. t + 24
DEVNI void w_mul_x(wst* S, int p, int o, int t) {
    w_copy(S, p, o, 3);
    for (int i = E_XABS_BITS - 2; i >= 0; i--) {
        w_dbl(S, o, o, t);
        if ((E_XABS[i >> 5] >> (i & 31)) & 1) w_add(S, o, p, o, t);
    }
    WARP_FOR(j, 1) {
        fq2 y = fq2_neg(S->r[o + 1]);
        if (own) S->r[o + 1] = y;
    } WARP_END
}

DEV bool exp_bit(const uint32_t* e, int nbits, int i) {
    return i < nbits && ((e[i >> 5] >> (i & 31)) & 1);
}

// r[out + s d] = a^e1 and r[out + 1 + s d] = a^e0, the halves of the
// square-root candidate a^e (e = E_SQRT2 = e1 q + e0) of a = r[in + s d],
// d < nd (at most 2); the candidate is conj(a^e1) a^e0.  Each phase runs
// bit i of both halves: s^2 (parts (s0 + s1)(s0 - s1), s0 s1: s = (t0,
// 2 t1)) and h_k s (Karatsuba parts) where bit i of e_k is set, into the
// other of two part buffers (8 a value: s's 2, then e0's 3 and e1's 3)
DEVNI void w_sqrt_pow(wst* S, int nd, int in, int out, int s) {
    enum { NB = E_SQRT2_LO_BITS > E_SQRT2_HI_BITS ? E_SQRT2_LO_BITS : E_SQRT2_HI_BITS };
    fp* buf = S->part;
    WARP_FOR(j, 6 * nd) {            // both halves start at 1: parts (1, 0, 1)
        fp v = j % 3 == 1 ? fp_zero() : K_ONE;
        if (own) buf[8 * (j / 6) + 2 + j % 6] = v;
    } WARP_END
    for (int i = 0; i < NB; i++) {
        const fp* cur = buf + 16 * (i & 1);
        fp* nxt = buf + 16 * ((i + 1) & 1);
        WARP_FOR(j, 8 * nd) {
            int d = j >> 3, k = j & 7;
            const fp* c = cur + 8 * d;
            fq2 a = i == 0 ? S->r[in + s * d] : fq2_make(c[0], fp_dbl(c[1]));
            int h = k >= 5;
            bool need = k < 2 ? i + 1 < NB
                              : h ? exp_bit(E_SQRT2_HI, E_SQRT2_HI_BITS, i)
                                  : exp_bit(E_SQRT2_LO, E_SQRT2_LO_BITS, i);
            fp x, y;
            if (k < 2) {
                x = k == 0 ? fp_add(a.c0, a.c1) : a.c0;
                y = k == 0 ? fp_sub(a.c0, a.c1) : a.c1;
            } else {
                int q = (k - 2) % 3;
                x = kara_part(kara_join(c + 2 + 3 * h), q);
                y = kara_part(a, q);
            }
            fp v = c[k];                // an unset bit keeps the part
            WHEN(need) {
                WARP_CONVERGE();
                fp m = fp_mul(x, y);
                if (need) v = m;
            }
            if (own) nxt[8 * d + k] = v;
        } WARP_END
    }
    const fp* fin = buf + 16 * (NB & 1);
    WARP_FOR(j, 2 * nd) {
        int d = j >> 1, h = 1 - (j & 1);
        fq2 v = kara_join(fin + 8 * d + 2 + 3 * h);
        if (own) S->r[out + s * d + (j & 1)] = v;
    } WARP_END
}

// one warp a value: fn(S, i, args...) for i < n, S in shared memory
// (dynamic: the mma build's product buffers leave too little static room)
#ifdef __CUDACC__
#define WARP_KERNEL(fn, params, ...)                                             \
    __global__ void fn##_warp params {                                           \
        extern __shared__ __align__(16) unsigned char w_smem_[];                 \
        fn((wst*)w_smem_, (long)blockIdx.x, __VA_ARGS__);                        \
    }
#define WARP_LAUNCH(n, fn, ...)                                                  \
    do {                                                                         \
        long n_ = (n);                                                           \
        int e_ = 0;                                                              \
        if (n_ > 0) {                                                            \
            e_ = (int)cudaFuncSetAttribute(                                      \
                fn##_warp, cudaFuncAttributeMaxDynamicSharedMemorySize,          \
                (int)sizeof(wst));                                               \
            if (!e_)                                                             \
                fn##_warp<<<(unsigned)n_, 32, sizeof(wst),                       \
                            (cudaStream_t)stream>>>(__VA_ARGS__);                \
        }                                                                        \
        if (!e_) e_ = (int)cudaGetLastError();                                   \
        if (e_) return e_;                                                       \
    } while (0)
#else
#include <stdlib.h>
#define WARP_KERNEL(fn, params, ...)
#define WARP_LAUNCH(n, fn, ...)                                                  \
    do {                                                                         \
        long n_ = (n);                                                           \
        wst* S_ = (wst*)malloc(sizeof(wst));                                     \
        for (long i_ = 0; i_ < n_; i_++) fn(S_, i_, __VA_ARGS__);                \
        free(S_);                                                                \
    } while (0)
#endif
