// fr255.cuh -- the BLS12-381 scalar field Fr for Hopper (sm_90a).
//
// The Fr engine of the KZG kernels.  It replaces the reference's generic
// limb field instantiated for Fr (teku_tpu/ops/modfield.py make_field(R):
// 10 signed lazy 26-bit limbs, R = 2^260); here 8 x 32-bit words,
// Montgomery form with R = 2^256, every value fully reduced to [0, r).
//
// What bounds it: 32-bit integer multiply-adds.  One Montgomery product is
// a CIOS loop of 8 rows, each row four mad.lo.cc / madc.hi.cc chains of 8
// (operand lo and hi, reduction lo and hi): 256 multiply-adds.  It uses
// fp381.cuh's carry-chain primitives (PTX on the card, the carry flag in a
// variable in the host build), and the host build counts its products
// (fr_mul_count) as fp381.cuh counts Fq's.
//
// Interface: canonical plain words (8 little-endian uint32 per element);
// fr_load converts to Montgomery form, fr_store back.

#pragma once
#include "fp381.cuh"

struct fr { uint32_t v[8]; };

// Generated by teku_tpu_torch/ops/_build.py: FR_M, FR_N0, FR_ONE, FR_R2,
// FR_INV_2 (1/2, Montgomery form) and FR_E_MM2 (r - 2).
#include "fr255_consts.h"

#ifdef __CUDACC__
#define COUNT_FR_MUL()
#else
static unsigned long long host_fr_mul_count;
extern "C" unsigned long long fr_mul_count() { return host_fr_mul_count; }
#define COUNT_FR_MUL() (host_fr_mul_count++)
#endif

DEV fr fr_zero() { fr r; for (int j = 0; j < 8; j++) r.v[j] = 0; return r; }

DEV bool fr_is_zero(const fr& a) {
    uint32_t acc = 0;
    for (int j = 0; j < 8; j++) acc |= a.v[j];
    return acc == 0;
}

// r = a - b over 8 words; returns 1 on borrow
DEV uint32_t sub8(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    int64_t br = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        int64_t d = (int64_t)a[j] - (int64_t)b[j] + br;
        r[j] = (uint32_t)d;
        br = d >> 32;
    }
    return (uint32_t)(br != 0);
}

DEV uint32_t add8(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        c += (uint64_t)a[j] + b[j];
        r[j] = (uint32_t)c;
        c >>= 32;
    }
    return (uint32_t)c;
}

// a >= r ? a - r : a, for a < 2r (r < 2^255, so a + b never carries out)
DEV fr fr_reduce_once(const fr& a) {
    fr s;
    uint32_t borrow = sub8(s.v, a.v, FR_M.v);
    return borrow ? a : s;
}

DEV fr fr_add(const fr& a, const fr& b) {
    fr r;
    add8(r.v, a.v, b.v);
    return fr_reduce_once(r);
}

DEV fr fr_sub(const fr& a, const fr& b) {
    fr r, s;
    uint32_t borrow = sub8(r.v, a.v, b.v);
    add8(s.v, r.v, FR_M.v);
    return borrow ? s : r;
}

// Montgomery product a * b * 2^-256 mod r (CIOS), inputs < 2^256, output in
// [0, r): t < (a b) / 2^256 + r < 2r before the last subtraction
DEV fr fr_mul_cios(const fr& a, const fr& b) {
    uint32_t t[10];
    uint32_t m_[8];
#pragma unroll
    for (int j = 0; j < 8; j++) m_[j] = FR_M.v[j];
#pragma unroll
    for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint32_t bi = b.v[i];
        t[0] = mad_lo_cc(a.v[0], bi, t[0]);
#pragma unroll
        for (int j = 1; j < 8; j++) t[j] = madc_lo_cc(a.v[j], bi, t[j]);
        t[8] = addc_cc(t[8], 0);
        t[9] = addc(t[9], 0);
        t[1] = mad_hi_cc(a.v[0], bi, t[1]);
#pragma unroll
        for (int j = 1; j < 8; j++) t[j + 1] = madc_hi_cc(a.v[j], bi, t[j + 1]);
        t[9] = addc(t[9], 0);
        uint32_t m = t[0] * FR_N0;
        t[0] = mad_lo_cc(m, m_[0], t[0]);
#pragma unroll
        for (int j = 1; j < 8; j++) t[j] = madc_lo_cc(m, m_[j], t[j]);
        t[8] = addc_cc(t[8], 0);
        t[9] = addc(t[9], 0);
        t[1] = mad_hi_cc(m, m_[0], t[1]);
#pragma unroll
        for (int j = 1; j < 8; j++) t[j + 1] = madc_hi_cc(m, m_[j], t[j + 1]);
        t[9] = addc(t[9], 0);
#pragma unroll
        for (int j = 0; j < 9; j++) t[j] = t[j + 1];
        t[9] = 0;
    }
    fr r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = t[j];
    return fr_reduce_once(r);
}

#if MONT_ENGINE_MMA
// the same product from the tensor cores' columns (mma_digits.cuh);
// inputs in [0, r)
DEV fr fr_mul_mma(const fr& a, const fr& b) {
    uint32_t t[17];
    mma_product<8>(a.v, b.v, t);
    t[16] = 0;
    mma_redc<8>(t, FR_M.v, FR_N0);
    fr r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = t[8 + j];
    return fr_reduce_once(r);
}
#endif

DEVNI fr fr_mul(const fr& a, const fr& b) {
    COUNT_FR_MUL();
#if MONT_ENGINE_MMA
    return fr_mul_mma(a, b);
#else
    return fr_mul_cios(a, b);
#endif
}

DEV fr fr_sqr(const fr& a) { return fr_mul(a, a); }

// a^e, e given as nbits bits in little-endian 32-bit words
DEVNI fr fr_pow(const fr& a, const uint32_t* e, int nbits) {
    fr r = FR_ONE;
    for (int i = nbits - 1; i >= 0; i--) {
        r = fr_sqr(r);
        if ((e[i >> 5] >> (i & 31)) & 1) r = fr_mul(r, a);
    }
    return r;
}

DEV fr fr_inv(const fr& a) { return fr_pow(a, FR_E_MM2, FR_E_MM2_BITS); }

DEV fr fr_load(const int32_t* w) {
    fr r;
    for (int j = 0; j < 8; j++) r.v[j] = (uint32_t)w[j];
    return fr_mul(r, FR_R2);
}

DEV void fr_store(int32_t* w, const fr& a) {
    fr one = fr_zero();
    one.v[0] = 1;
    fr r = fr_mul(a, one);
    if (LIVE)
        for (int j = 0; j < 8; j++) w[j] = (int32_t)r.v[j];
}
