// fp381.cuh -- BLS12-381 field, tower and curve arithmetic for Hopper (sm_90a).
//
// The device library the kernel sources share.  It replaces the
// fp381 limb engine the TPU programs are built from (teku_tpu/ops/limbs.py,
// towers.py, points.py, pairing.py): there, 15 signed lazy 26-bit limbs in
// int64 lanes with R = 2^390; here, 12 x 32-bit words, Montgomery form with
// R = 2^384, every value fully reduced to [0, P) after each operation.
//
// What bounds it: 32-bit integer multiply-adds.  One Montgomery product is
// a CIOS loop of 12 rows, each row four mad.lo.cc / madc.hi.cc carry chains
// of 12 (operand row lo and hi, reduction row lo and hi): 576 multiply-adds,
// about 2 * 12^2 32 x 32 -> 64-bit products.  The kernels run one thread
// per lane or row (the cooperative ones, pairing.cuh and wcoop.cuh, a block
// or a warp); the tower and curve functions are __noinline__ so nvcc
// does not inline a whole Miller loop into one body (compile time and
// register spills), and every element crosses a call in local memory.
//
// Formulas mirror the reference where a value is formula-dependent
// (Jacobian coordinates, Miller-loop lines): point_double is dbl-2009-l,
// point_add is add-2007-bl with the reference's selects for infinity,
// P == Q and P == -Q, so the kernels' canonical outputs equal the plain
// PyTorch versions' word for word.
//
// Kernel interface: canonical plain words (12 little-endian uint32 per Fq
// element, not Montgomery form).  load_* converts to Montgomery form on
// entry, store_* back on exit.
//
// The same text compiles as host C++ (no __CUDACC__): each carry-chain
// primitive then keeps the carry flag in a variable, so the arithmetic
// can be exercised by a C++ compiler on a machine without a card.
//
// Two engines build every source (ops/_build.py): ``cios`` (this file's
// CIOS product) and ``mma`` (-DMONT_ENGINE_MMA=1: fp_mul and fr_mul take
// the tensor-core product of mma_digits.cuh).  The mma product is one
// instruction of a whole warp, so under it every thread of a warp runs
// the same products: the kernel shells run padding threads on a clamped
// index with their stores off (SHELL, LIVE), and a product that depends
// on data is computed on every thread and selected (WHEN, EVERY_LANE).
// The cios build keeps its control flow.

#pragma once
#include <stdint.h>

#ifndef MONT_ENGINE_MMA
#define MONT_ENGINE_MMA 0
#endif
#define EVERY_LANE MONT_ENGINE_MMA
// WHEN(c) { x = f(); if (c) y = x; } -- f runs on every thread under the
// mma engine (selected afterwards), only where c holds under cios
#define WHEN(c) if (EVERY_LANE || (c))
// reconverge a warp before a product that data-dependent control flow
// reached: the mma product is one instruction of the whole warp
#if MONT_ENGINE_MMA && defined(__CUDACC__)
#define WARP_CONVERGE() __syncwarp()
#else
#define WARP_CONVERGE()
#endif

#ifdef __CUDACC__
#define THREADS 64                  // threads per block of every launch
#define DEV __device__ __forceinline__
#define DEVNI __device__ __noinline__
#define DCONST __device__ const
#else
#define DEV static inline
#define DEVNI static
#define DCONST static const
#endif

struct fp { uint32_t v[12]; };
struct fq2 { fp c0, c1; };
struct fq6 { fq2 c0, c1, c2; };
struct fq12 { fq6 c0, c1; };

// Generated by teku_tpu_torch/ops/_build.py from the port's constants:
// K_P, N0, K_ONE, K_R2, exponents and the curve / tower constants.
#include "fp381_consts.h"

// --------------------------------------------------------------------------
// Carry-chain primitives
// --------------------------------------------------------------------------

#ifdef __CUDACC__
DEV uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r; asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
DEV uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r; asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
DEV uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r; asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
DEV uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r; asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); return r; }
DEV uint32_t addc_cc(uint32_t a, uint32_t b) {
    uint32_t r; asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
DEV uint32_t addc(uint32_t a, uint32_t b) {
    uint32_t r; asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
#else
static uint32_t host_cf;
DEV uint32_t cc_set(uint64_t s) { host_cf = (uint32_t)(s >> 32); return (uint32_t)s; }
DEV uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return cc_set((uint64_t)(uint32_t)(a * b) + c); }
DEV uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return cc_set((uint64_t)(uint32_t)(a * b) + c + host_cf); }
DEV uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return cc_set((((uint64_t)a * b) >> 32) + c); }
DEV uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return cc_set((((uint64_t)a * b) >> 32) + c + host_cf); }
DEV uint32_t addc_cc(uint32_t a, uint32_t b) {
    return cc_set((uint64_t)a + b + host_cf); }
DEV uint32_t addc(uint32_t a, uint32_t b) { return a + b + host_cf; }
#endif

// The host build counts Montgomery products: the operation count of a
// kernel on given inputs is 576 multiply-adds per product.
#ifdef __CUDACC__
#define COUNT_MUL()
#else
static unsigned long long host_mul_count;
extern "C" unsigned long long fp381_mul_count() { return host_mul_count; }
#define COUNT_MUL() (host_mul_count++)
#endif

// A thread's global stores: off for the padding threads of the mma
// engine's shells (SHELL below), always on otherwise.
#if MONT_ENGINE_MMA && defined(__CUDACC__)
__shared__ uint8_t mma_live[THREADS];
#define LIVE (mma_live[threadIdx.x] != 0)
#else
#define LIVE true
#endif

#if MONT_ENGINE_MMA
#include "mma_digits.cuh"
#endif

// r = a - b over 12 words; returns 1 on borrow
DEV uint32_t sub12(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    int64_t br = 0;
#pragma unroll
    for (int j = 0; j < 12; j++) {
        int64_t d = (int64_t)a[j] - (int64_t)b[j] + br;
        r[j] = (uint32_t)d;
        br = d >> 32;
    }
    return (uint32_t)(br != 0);
}

// r = a + b over 12 words; returns the carry out
DEV uint32_t add12(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 12; j++) {
        c += (uint64_t)a[j] + b[j];
        r[j] = (uint32_t)c;
        c >>= 32;
    }
    return (uint32_t)c;
}

// --------------------------------------------------------------------------
// Fq
// --------------------------------------------------------------------------

DEV fp fp_zero() { fp r; for (int j = 0; j < 12; j++) r.v[j] = 0; return r; }
DEV fp fp_one() { return K_ONE; }

DEV bool fp_is_zero(const fp& a) {
    uint32_t acc = 0;
    for (int j = 0; j < 12; j++) acc |= a.v[j];
    return acc == 0;
}

DEV bool fp_eq(const fp& a, const fp& b) {
    uint32_t acc = 0;
    for (int j = 0; j < 12; j++) acc |= a.v[j] ^ b.v[j];
    return acc == 0;
}

// a >= P ? a - P : a, for a < 2P
DEV fp fp_reduce_once(const fp& a) {
    fp s;
    uint32_t borrow = sub12(s.v, a.v, K_P.v);
    return borrow ? a : s;
}

DEV fp fp_add(const fp& a, const fp& b) {
    fp r;
    add12(r.v, a.v, b.v);
    return fp_reduce_once(r);
}

DEV fp fp_sub(const fp& a, const fp& b) {
    fp r, s;
    uint32_t borrow = sub12(r.v, a.v, b.v);
    add12(s.v, r.v, K_P.v);
    return borrow ? s : r;
}

DEV fp fp_neg(const fp& a) {
    fp r;
    sub12(r.v, K_P.v, a.v);
    return fp_is_zero(a) ? a : r;
}

DEV fp fp_dbl(const fp& a) { return fp_add(a, a); }

// Montgomery product a * b * 2^-384 mod P (CIOS), inputs and output in [0, P)
DEV fp fp_mul_cios(const fp& a, const fp& b) {
    uint32_t t[14];
    uint32_t p[12];
#pragma unroll
    for (int j = 0; j < 12; j++) p[j] = K_P.v[j];
#pragma unroll
    for (int j = 0; j < 14; j++) t[j] = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) {
        uint32_t bi = b.v[i];
        // t[0..11] += lo(a * bi); t[1..12] += hi(a * bi)
        t[0] = mad_lo_cc(a.v[0], bi, t[0]);
#pragma unroll
        for (int j = 1; j < 12; j++) t[j] = madc_lo_cc(a.v[j], bi, t[j]);
        t[12] = addc_cc(t[12], 0);
        t[13] = addc(t[13], 0);
        t[1] = mad_hi_cc(a.v[0], bi, t[1]);
#pragma unroll
        for (int j = 1; j < 12; j++) t[j + 1] = madc_hi_cc(a.v[j], bi, t[j + 1]);
        t[13] = addc(t[13], 0);
        // t += m * P with m chosen so that t[0] becomes 0, then shift
        uint32_t m = t[0] * N0;
        t[0] = mad_lo_cc(m, p[0], t[0]);
#pragma unroll
        for (int j = 1; j < 12; j++) t[j] = madc_lo_cc(m, p[j], t[j]);
        t[12] = addc_cc(t[12], 0);
        t[13] = addc(t[13], 0);
        t[1] = mad_hi_cc(m, p[0], t[1]);
#pragma unroll
        for (int j = 1; j < 12; j++) t[j + 1] = madc_hi_cc(m, p[j], t[j + 1]);
        t[13] = addc(t[13], 0);
#pragma unroll
        for (int j = 0; j < 13; j++) t[j] = t[j + 1];
        t[13] = 0;
    }
    fp r;
#pragma unroll
    for (int j = 0; j < 12; j++) r.v[j] = t[j];
    return fp_reduce_once(r);
}

#if MONT_ENGINE_MMA
// the same product from the tensor cores' columns (mma_digits.cuh)
DEV fp fp_mul_mma(const fp& a, const fp& b) {
    uint32_t t[25];
    mma_product<12>(a.v, b.v, t);
    t[24] = 0;
    mma_redc<12>(t, K_P.v, N0);
    fp r;
#pragma unroll
    for (int j = 0; j < 12; j++) r.v[j] = t[12 + j];
    return fp_reduce_once(r);
}
#endif

DEVNI fp fp_mul(const fp& a, const fp& b) {
    COUNT_MUL();
#if MONT_ENGINE_MMA
    return fp_mul_mma(a, b);
#else
    return fp_mul_cios(a, b);
#endif
}

DEV fp fp_sqr(const fp& a) { return fp_mul(a, a); }

DEV fp fp_to_mont(const fp& a) { return fp_mul(a, K_R2); }

DEV fp fp_from_mont(const fp& a) {
    fp one = fp_zero();
    one.v[0] = 1;
    return fp_mul(a, one);
}

// a^e, e given as nbits bits in little-endian 32-bit words, MSB first
DEVNI fp fp_pow(const fp& a, const uint32_t* e, int nbits) {
    fp r = K_ONE;
    for (int i = nbits - 1; i >= 0; i--) {
        r = fp_sqr(r);
        if ((e[i >> 5] >> (i & 31)) & 1) r = fp_mul(r, a);
    }
    return r;
}

DEV fp fp_inv(const fp& a) { return fp_pow(a, E_PM2, E_PM2_BITS); }

DEV bool words_are_one(const fp& a) {
    uint32_t acc = a.v[0] ^ 1;
    for (int j = 1; j < 12; j++) acc |= a.v[j];
    return acc == 0;
}

DEV void shr1_12(uint32_t* x) {
    for (int j = 0; j < 11; j++) x[j] = (x[j] >> 1) | (x[j + 1] << 31);
    x[11] >>= 1;
}

// x / 2 mod P for x in [0, P): x + P < 2^382 keeps to 12 words
DEV void half_mod(fp& x) {
    if (x.v[0] & 1) add12(x.v, x.v, K_P.v);
    shr1_12(x.v);
}

// a^-1 by the binary extended Euclid (Guide to ECC, alg. 2.22) on the words
// of a = x R (Montgomery form): y = (x R)^-1, then one product y R^3 R^-1 =
// x^-1 R; 0 -> 0, as fp_inv.  About 1,150 steps of 12-word shifts and
// subtractions and one product, where fp_inv runs ~570 dependent products;
// the steps depend on the data (a thread's own chain, or every thread of a
// warp on the same value).  The cooperative routines of pairing.cuh take it.
DEVNI fp fp_inv_euclid(const fp& a) {
    bool zero = fp_is_zero(a);
    fp u = a, v = K_P, x1 = fp_zero(), x2 = fp_zero();
    u.v[0] |= zero;                 // 0: run on 1 (every lane reaches the product)
    x1.v[0] = 1;
    // x1 a = u, x2 a = v (mod P); u, v > 0 and gcd(u, v) = 1 throughout
    while (!words_are_one(u) && !words_are_one(v)) {
        while (!(u.v[0] & 1)) {
            shr1_12(u.v);
            half_mod(x1);
        }
        while (!(v.v[0] & 1)) {
            shr1_12(v.v);
            half_mod(x2);
        }
        fp d;
        if (!sub12(d.v, u.v, v.v)) {
            u = d;
            x1 = fp_sub(x1, x2);
        } else {
            sub12(v.v, v.v, u.v);
            x2 = fp_sub(x2, x1);
        }
    }
    fp y = words_are_one(u) ? x1 : x2;
    WARP_CONVERGE();
    fp r = fp_mul(y, K_R3);
    return zero ? a : r;
}
DEV fp fp_sqrt_candidate(const fp& a) { return fp_pow(a, E_SQRT1, E_SQRT1_BITS); }

// canonical plain a > b
DEV bool plain_gt(const fp& a, const fp& b) {
    fp d;
    return sub12(d.v, b.v, a.v) != 0;
}

DEV fp fp_load(const int32_t* w) {
    fp r;
    for (int j = 0; j < 12; j++) r.v[j] = (uint32_t)w[j];
    return fp_to_mont(r);
}

DEV void fp_store(int32_t* w, const fp& a) {
    fp r = fp_from_mont(a);
    if (LIVE)
        for (int j = 0; j < 12; j++) w[j] = (int32_t)r.v[j];
}

// --------------------------------------------------------------------------
// Fq2 = Fq[u] / (u^2 + 1)
// --------------------------------------------------------------------------

DEV fq2 fq2_make(const fp& a, const fp& b) { fq2 r; r.c0 = a; r.c1 = b; return r; }
DEV fq2 fq2_zero() { return fq2_make(fp_zero(), fp_zero()); }
DEV fq2 fq2_one() { return fq2_make(K_ONE, fp_zero()); }
DEV fq2 fq2_add(const fq2& a, const fq2& b) { return fq2_make(fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)); }
DEV fq2 fq2_sub(const fq2& a, const fq2& b) { return fq2_make(fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)); }
DEV fq2 fq2_neg(const fq2& a) { return fq2_make(fp_neg(a.c0), fp_neg(a.c1)); }
DEV fq2 fq2_dbl(const fq2& a) { return fq2_add(a, a); }
DEV fq2 fq2_conj(const fq2& a) { return fq2_make(a.c0, fp_neg(a.c1)); }
DEV fq2 fq2_mul_by_xi(const fq2& a) { return fq2_make(fp_sub(a.c0, a.c1), fp_add(a.c0, a.c1)); }
DEV bool fq2_is_zero(const fq2& a) { return fp_is_zero(a.c0) && fp_is_zero(a.c1); }
DEV bool fq2_eq(const fq2& a, const fq2& b) { return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1); }

DEVNI fq2 fq2_mul(const fq2& a, const fq2& b) {
    fp t0 = fp_mul(a.c0, b.c0);
    fp t1 = fp_mul(a.c1, b.c1);
    fp t2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
    return fq2_make(fp_sub(t0, t1), fp_sub(fp_sub(t2, t0), t1));
}

// Karatsuba's three Fq products of an Fq2 product x y (fq2_mul): s = 0
// x0 y0, s = 1 x1 y1, s = 2 (x0 + x1)(y0 + y1); kara_join combines them
// (the cooperative routines of pairing.cuh and wcoop.cuh run them on
// separate lanes)
DEV fp kara_part(const fq2& x, int s) {
    fp sum = fp_add(x.c0, x.c1);
    return s == 0 ? x.c0 : s == 1 ? x.c1 : sum;
}

DEV fq2 kara_join(const fp* p) {
    return fq2_make(fp_sub(p[0], p[1]), fp_sub(fp_sub(p[2], p[0]), p[1]));
}

DEVNI fq2 fq2_sqr(const fq2& a) {
    fp t0 = fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1));
    fp t1 = fp_mul(a.c0, a.c1);
    return fq2_make(t0, fp_dbl(t1));
}

DEV fq2 fq2_mul_fp(const fq2& a, const fp& s) { return fq2_make(fp_mul(a.c0, s), fp_mul(a.c1, s)); }

// the tower inverses over Fermat's fp_inv, or (EUCLID) over fp_inv_euclid
template <bool EUCLID = false> DEVNI fq2 fq2_inv(const fq2& a) {
    fp norm = fp_add(fp_sqr(a.c0), fp_sqr(a.c1));
    fp ninv = EUCLID ? fp_inv_euclid(norm) : fp_inv(norm);
    return fq2_make(fp_mul(a.c0, ninv), fp_neg(fp_mul(a.c1, ninv)));
}

// wire sign of a canonical plain Fq2 y: lexicographically larger root
DEV bool fq2_is_large_plain(const fq2& y) {
    bool large1 = plain_gt(y.c1, K_HALF);
    return large1 || (fp_is_zero(y.c1) && plain_gt(y.c0, K_HALF));
}

DEV fq2 fq2_load(const int32_t* w) { return fq2_make(fp_load(w), fp_load(w + 12)); }
DEV void fq2_store(int32_t* w, const fq2& a) { fp_store(w, a.c0); fp_store(w + 12, a.c1); }

// --------------------------------------------------------------------------
// Fq6 = Fq2[v] / (v^3 - xi), Fq12 = Fq6[w] / (w^2 - v)
// --------------------------------------------------------------------------

DEV fq6 fq6_make(const fq2& a, const fq2& b, const fq2& c) { fq6 r; r.c0 = a; r.c1 = b; r.c2 = c; return r; }
DEV fq6 fq6_zero() { return fq6_make(fq2_zero(), fq2_zero(), fq2_zero()); }
DEV fq6 fq6_one() { return fq6_make(fq2_one(), fq2_zero(), fq2_zero()); }
DEV fq6 fq6_add(const fq6& a, const fq6& b) { return fq6_make(fq2_add(a.c0, b.c0), fq2_add(a.c1, b.c1), fq2_add(a.c2, b.c2)); }
DEV fq6 fq6_sub(const fq6& a, const fq6& b) { return fq6_make(fq2_sub(a.c0, b.c0), fq2_sub(a.c1, b.c1), fq2_sub(a.c2, b.c2)); }
DEV fq6 fq6_neg(const fq6& a) { return fq6_make(fq2_neg(a.c0), fq2_neg(a.c1), fq2_neg(a.c2)); }
DEV fq6 fq6_mul_by_v(const fq6& a) { return fq6_make(fq2_mul_by_xi(a.c2), a.c0, a.c1); }
DEV bool fq6_eq(const fq6& a, const fq6& b) { return fq2_eq(a.c0, b.c0) && fq2_eq(a.c1, b.c1) && fq2_eq(a.c2, b.c2); }

DEVNI fq6 fq6_mul(const fq6& a, const fq6& b) {
    fq2 t0 = fq2_mul(a.c0, b.c0);
    fq2 t1 = fq2_mul(a.c1, b.c1);
    fq2 t2 = fq2_mul(a.c2, b.c2);
    fq2 s12 = fq2_mul(fq2_add(a.c1, a.c2), fq2_add(b.c1, b.c2));
    fq2 s01 = fq2_mul(fq2_add(a.c0, a.c1), fq2_add(b.c0, b.c1));
    fq2 s02 = fq2_mul(fq2_add(a.c0, a.c2), fq2_add(b.c0, b.c2));
    return fq6_make(fq2_add(t0, fq2_mul_by_xi(fq2_sub(fq2_sub(s12, t1), t2))),
                    fq2_add(fq2_sub(fq2_sub(s01, t0), t1), fq2_mul_by_xi(t2)),
                    fq2_add(fq2_sub(fq2_sub(s02, t0), t2), t1));
}

DEV fq6 fq6_mul_by_fq2(const fq6& a, const fq2& s) {
    return fq6_make(fq2_mul(a.c0, s), fq2_mul(a.c1, s), fq2_mul(a.c2, s));
}

template <bool EUCLID = false> DEVNI fq6 fq6_inv(const fq6& a) {
    fq2 t0 = fq2_sub(fq2_sqr(a.c0), fq2_mul_by_xi(fq2_mul(a.c1, a.c2)));
    fq2 t1 = fq2_sub(fq2_mul_by_xi(fq2_sqr(a.c2)), fq2_mul(a.c0, a.c1));
    fq2 t2 = fq2_sub(fq2_sqr(a.c1), fq2_mul(a.c0, a.c2));
    fq2 norm = fq2_add(fq2_mul(a.c0, t0),
                       fq2_mul_by_xi(fq2_add(fq2_mul(a.c2, t1), fq2_mul(a.c1, t2))));
    fq2 ninv = fq2_inv<EUCLID>(norm);
    return fq6_make(fq2_mul(t0, ninv), fq2_mul(t1, ninv), fq2_mul(t2, ninv));
}

DEV fq6 fq6_frobenius(const fq6& a) {
    return fq6_make(fq2_conj(a.c0), fq2_mul(fq2_conj(a.c1), K_FROB6_C1),
                    fq2_mul(fq2_conj(a.c2), K_FROB6_C2));
}

DEV fq12 fq12_make(const fq6& a, const fq6& b) { fq12 r; r.c0 = a; r.c1 = b; return r; }
DEV fq12 fq12_one() { return fq12_make(fq6_one(), fq6_zero()); }
DEV fq12 fq12_conj(const fq12& a) { return fq12_make(a.c0, fq6_neg(a.c1)); }
DEV bool fq12_is_one(const fq12& a) { return fq6_eq(a.c0, fq6_one()) && fq6_eq(a.c1, fq6_zero()); }

DEVNI fq12 fq12_mul(const fq12& a, const fq12& b) {
    fq6 t0 = fq6_mul(a.c0, b.c0);
    fq6 t1 = fq6_mul(a.c1, b.c1);
    fq6 t2 = fq6_mul(fq6_add(a.c0, a.c1), fq6_add(b.c0, b.c1));
    return fq12_make(fq6_add(t0, fq6_mul_by_v(t1)), fq6_sub(fq6_sub(t2, t0), t1));
}

// complex squaring, as the reference
DEVNI fq12 fq12_sqr(const fq12& a) {
    fq6 t = fq6_mul(a.c0, a.c1);
    fq6 u = fq6_mul(fq6_add(a.c0, a.c1), fq6_add(a.c0, fq6_mul_by_v(a.c1)));
    return fq12_make(fq6_sub(u, fq6_add(t, fq6_mul_by_v(t))), fq6_add(t, t));
}

template <bool EUCLID = false> DEVNI fq12 fq12_inv(const fq12& a) {
    fq6 norm = fq6_sub(fq6_mul(a.c0, a.c0), fq6_mul_by_v(fq6_mul(a.c1, a.c1)));
    fq6 ninv = fq6_inv<EUCLID>(norm);
    return fq12_make(fq6_mul(a.c0, ninv), fq6_neg(fq6_mul(a.c1, ninv)));
}

DEVNI fq12 fq12_frobenius(const fq12& a, int power) {
    fq12 r = a;
    for (int i = 0; i < power; i++)
        r = fq12_make(fq6_frobenius(r.c0),
                      fq6_mul_by_fq2(fq6_frobenius(r.c1), K_FROB12_C1));
    return r;
}

DEV fq12 fq12_load(const int32_t* w) {
    fq12 r;
    fp* f = (fp*)&r;
    for (int k = 0; k < 12; k++) f[k] = fp_load(w + 12 * k);
    return r;
}

DEV void fq12_store(int32_t* w, const fq12& a) {
    const fp* f = (const fp*)&a;
    for (int k = 0; k < 12; k++) fp_store(w + 12 * k, f[k]);
}

// --------------------------------------------------------------------------
// Jacobian points over Fq (G1) and Fq2 (G2); Z == 0 <=> infinity
// --------------------------------------------------------------------------

DEV fp f_add(const fp& a, const fp& b) { return fp_add(a, b); }
DEV fp f_sub(const fp& a, const fp& b) { return fp_sub(a, b); }
DEV fp f_mul(const fp& a, const fp& b) { return fp_mul(a, b); }
DEV fp f_neg(const fp& a) { return fp_neg(a); }
DEV bool f_is_zero(const fp& a) { return fp_is_zero(a); }
DEV fq2 f_add(const fq2& a, const fq2& b) { return fq2_add(a, b); }
DEV fq2 f_sub(const fq2& a, const fq2& b) { return fq2_sub(a, b); }
DEV fq2 f_mul(const fq2& a, const fq2& b) { return fq2_mul(a, b); }
DEV fq2 f_neg(const fq2& a) { return fq2_neg(a); }
DEV bool f_is_zero(const fq2& a) { return fq2_is_zero(a); }
DEV void f_set_one(fp& a) { a = K_ONE; }
DEV void f_set_one(fq2& a) { a = fq2_one(); }
DEV void f_set_zero(fp& a) { a = fp_zero(); }
DEV void f_set_zero(fq2& a) { a = fq2_zero(); }

template <class F> struct jac { F x, y, z; };
typedef jac<fp> g1p;
typedef jac<fq2> g2p;

template <class F> DEV jac<F> pt_infinity() {
    jac<F> r;
    f_set_one(r.x);
    f_set_one(r.y);
    f_set_zero(r.z);
    return r;
}

template <class F> DEV bool pt_is_inf(const jac<F>& p) { return f_is_zero(p.z); }

template <class F> DEV jac<F> pt_neg(const jac<F>& p) {
    jac<F> r = p;
    r.y = f_neg(p.y);
    return r;
}

// dbl-2009-l (a = 0), as teku_tpu/ops/points.py:point_double
template <class F> DEVNI jac<F> pt_dbl(const jac<F>& p) {
    F A = f_mul(p.x, p.x), B = f_mul(p.y, p.y), YZ = f_mul(p.y, p.z);
    F XB = f_add(p.x, B), E = f_add(f_add(A, A), A);
    F XB2 = f_mul(XB, XB), C = f_mul(B, B), Fv = f_mul(E, E);
    F D = f_sub(f_sub(XB2, A), C);
    D = f_add(D, D);
    jac<F> r;
    r.x = f_sub(Fv, f_add(D, D));
    F C2 = f_add(C, C), C4 = f_add(C2, C2), C8 = f_add(C4, C4);
    r.y = f_sub(f_mul(E, f_sub(D, r.x)), C8);
    r.z = f_add(YZ, YZ);
    return r;
}

// add-2007-bl with the reference's lane selects (points.py:point_add)
template <class F> DEVNI jac<F> pt_add(const jac<F>& p, const jac<F>& q) {
    F Z1Z1 = f_mul(p.z, p.z), Z2Z2 = f_mul(q.z, q.z), Z1Z2 = f_mul(p.z, q.z);
    F U1 = f_mul(p.x, Z2Z2), U2 = f_mul(q.x, Z1Z1);
    F S1 = f_mul(p.y, f_mul(q.z, Z2Z2)), S2 = f_mul(q.y, f_mul(p.z, Z1Z1));
    F H = f_sub(U2, U1), sdiff = f_sub(S2, S1);
    F rr = f_add(sdiff, sdiff);
    F H2 = f_add(H, H);
    F I = f_mul(H2, H2), R2 = f_mul(rr, rr);
    F J = f_mul(H, I), V = f_mul(U1, I);
    jac<F> out;
    out.z = f_mul(f_add(Z1Z2, Z1Z2), H);
    out.x = f_sub(f_sub(R2, J), f_add(V, V));
    F S1J = f_mul(S1, J);
    out.y = f_sub(f_mul(rr, f_sub(V, out.x)), f_add(S1J, S1J));
    bool same_x = f_is_zero(H), same_y = f_is_zero(sdiff);
    bool p_inf = f_is_zero(p.z), q_inf = f_is_zero(q.z);
    bool finite = !p_inf && !q_inf;
    bool dbl = finite && same_x && same_y;
    WHEN(dbl) {
        jac<F> d = pt_dbl(p);
        if (dbl) out = d;
    }
    if (finite && same_x && !same_y) f_set_zero(out.z);
    if (p_inf) out = q;
    if (q_inf && !p_inf) out = p;
    return out;
}

template <class F> DEVNI bool pt_eq(const jac<F>& p, const jac<F>& q) {
    F Z1Z1 = f_mul(p.z, p.z), Z2Z2 = f_mul(q.z, q.z);
    F x_d = f_sub(f_mul(p.x, Z2Z2), f_mul(q.x, Z1Z1));
    F y_d = f_sub(f_mul(p.y, f_mul(q.z, Z2Z2)), f_mul(q.y, f_mul(p.z, Z1Z1)));
    bool p_inf = f_is_zero(p.z), q_inf = f_is_zero(q.z);
    return (f_is_zero(x_d) && f_is_zero(y_d) && !(p_inf ^ q_inf)) || (p_inf && q_inf);
}

// [e]P for a static exponent (words little-endian): double, and add at
// each one-bit below the top bit
template <class F> DEVNI jac<F> pt_mul_static(const jac<F>& p, const uint32_t* e, int nbits) {
    jac<F> acc = p;
    for (int i = nbits - 2; i >= 0; i--) {
        acc = pt_dbl(acc);
        if ((e[i >> 5] >> (i & 31)) & 1) acc = pt_add(acc, p);
    }
    return acc;
}

// [r]P for a 64-bit runtime scalar: the reference's 4-bit fixed-window
// ladder (points.py:scalar_mul_bits) -- table by successive adds from
// infinity, then per digit four doubles and one add
template <class F> DEVNI jac<F> pt_mul_u64(const jac<F>& p, uint64_t r) {
    jac<F> table[16];
    table[0] = pt_infinity<F>();
    for (int k = 1; k < 16; k++) table[k] = pt_add(table[k - 1], p);
    jac<F> acc = table[(r >> 60) & 15];
    for (int w = 14; w >= 0; w--) {
        for (int d = 0; d < 4; d++) acc = pt_dbl(acc);
        acc = pt_add(acc, table[(r >> (4 * w)) & 15]);
    }
    return acc;
}

DEV g1p g1_load(const int32_t* w) {
    g1p r;
    r.x = fp_load(w);
    r.y = fp_load(w + 12);
    r.z = fp_load(w + 24);
    return r;
}

DEV void g1_store(int32_t* w, const g1p& p) {
    fp_store(w, p.x);
    fp_store(w + 12, p.y);
    fp_store(w + 24, p.z);
}

DEV g2p g2_load(const int32_t* w) {
    g2p r;
    r.x = fq2_load(w);
    r.y = fq2_load(w + 24);
    r.z = fq2_load(w + 48);
    return r;
}

DEV void g2_store(int32_t* w, const g2p& p) {
    fq2_store(w, p.x);
    fq2_store(w + 24, p.y);
    fq2_store(w + 48, p.z);
}

// --------------------------------------------------------------------------
// Endomorphisms, subgroup checks, decompression, affine conversion
// --------------------------------------------------------------------------

DEV g1p g1_phi(const g1p& p) {
    g1p r = p;
    r.x = fp_mul(p.x, K_BETA);
    return r;
}

DEV g2p g2_psi(const g2p& q) {
    g2p r;
    r.x = fq2_mul(fq2_conj(q.x), K_PSI_X);
    r.y = fq2_mul(fq2_conj(q.y), K_PSI_Y);
    r.z = fq2_conj(q.z);
    return r;
}

// phi(P) == [-z^2]P (infinity counts as in the subgroup)
DEVNI bool g1_in_subgroup(const g1p& p) {
    g1p rhs = pt_neg(pt_mul_static(p, E_XSQ, E_XSQ_BITS));
    return pt_eq(g1_phi(p), rhs) || pt_is_inf(p);
}

// G1 decompression from a canonical plain x: (x, y, 1), ok = on curve
DEVNI g1p g1_recover_y(const fp& x_plain, bool large_flag, bool* ok) {
    g1p r;
    r.x = fp_to_mont(x_plain);
    fp rhs = fp_add(fp_mul(fp_sqr(r.x), r.x), K_B1);
    fp y = fp_sqrt_candidate(rhs);
    *ok = fp_eq(fp_sqr(y), rhs);
    bool large = plain_gt(fp_from_mont(y), K_HALF);
    r.y = (large == large_flag) ? y : fp_neg(y);
    r.z = K_ONE;
    return r;
}

// Jacobian -> affine; infinity gives (0, 0) as the reference's batched
// inversion (inv(0) == 0) does
DEV void g1_to_affine(const g1p& p, fp* x, fp* y) {
    fp zinv = fp_inv(p.z);
    fp zinv2 = fp_sqr(zinv);
    *x = fp_mul(p.x, zinv2);
    *y = fp_mul(p.y, fp_mul(zinv2, zinv));
}

template <bool EUCLID = false> DEV void g2_to_affine(const g2p& p, fq2* x, fq2* y) {
    fq2 zinv = fq2_inv<EUCLID>(p.z);
    fq2 zinv2 = fq2_sqr(zinv);
    *x = fq2_mul(p.x, zinv2);
    *y = fq2_mul(p.y, fq2_mul(zinv2, zinv));
}

// A kernel is a per-thread body fn(i, args...) and, in the CUDA build, a
// __global__ shell fn_kernel(n, args...) that calls it for i < n
// (SHELL(n, fn(ix, args...)); SHELL_AT(i, n, ...) for a thread index i
// the shell has remapped): under cios the threads past n return; under
// mma they run the body on the last index with LIVE off, so every warp
// stays whole through its products.
// LAUNCH(n, fn, args...) runs it: one CUDA thread per i on the caller's
// stream (the entry point's `stream` argument), or a plain loop in the
// host build.
#ifdef __CUDACC__
#if MONT_ENGINE_MMA
#define SHELL_AT(i, n, call)                                                     \
    do {                                                                         \
        long i_ = (i);                                                           \
        mma_live[threadIdx.x] = i_ < (n);                                        \
        long ix = i_ < (n) ? i_ : (n) - 1;                                       \
        call;                                                                    \
    } while (0)
#else
#define SHELL_AT(i, n, call)                                                     \
    do {                                                                         \
        long ix = (i);                                                           \
        if (ix < (n)) call;                                                      \
    } while (0)
#endif
#define SHELL(n, call) SHELL_AT((long)blockIdx.x * blockDim.x + threadIdx.x, n, call)

#define LAUNCH(n, fn, ...)                                                       \
    do {                                                                         \
        long n_ = (n);                                                           \
        if (n_ > 0)                                                              \
            fn##_kernel<<<(unsigned)((n_ + THREADS - 1) / THREADS), THREADS, 0,  \
                          (cudaStream_t)stream>>>(n_, __VA_ARGS__);              \
        int e_ = (int)cudaGetLastError();                                        \
        if (e_) return e_;                                                       \
    } while (0)

// Per-thread stack for the __noinline__ call chains (a G2 ladder table
// alone is 4.6 KB; ptxas reports up to 16.5 KB for the final
// exponentiation); every library exports this and the binding calls it
// once after loading.
extern "C" int fp381_init() {
    cudaDeviceSetLimit(cudaLimitStackSize, 32768);
    return (int)cudaGetLastError();
}
#else
#define LAUNCH(n, fn, ...)                                                       \
    do {                                                                         \
        long n_ = (n);                                                           \
        for (long i_ = 0; i_ < n_; i_++) fn(i_, __VA_ARGS__);                    \
    } while (0)

extern "C" int fp381_init() { return 0; }
#endif
