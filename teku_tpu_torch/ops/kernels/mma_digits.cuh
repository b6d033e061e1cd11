// mma_digits.cuh -- the Montgomery product's columns on the tensor cores.
//
// The kernel of the reference's MXU engine (teku_tpu/ops/mxu.py:195-273
// make_digit_kernels): there, both operands split into int8 digits, a
// batched int8 outer product on the MXU gives the digit products, and
// folds give the 2L schoolbook product columns that the field's own
// reduction takes.  Here the same columns come from mma.sync
// m16n8k32 u8 x u8 -> s32 on Hopper's tensor cores, and the reduction is
// the m * P half of the CIOS loop (fp381.cuh), so the product out is the
// unique value in [0, M), the same word for word as the CIOS product.
//
// Digits.  The kernels' operands are canonical words in [0, M), so the
// digits are the operand's bytes, unsigned: D = 4 NW digits of 8 bits
// (Fq: 48, Fr: 32), used with .u8.  A column sums at most D digit
// products: < 48 * 255^2 < 2^22, exact in s32.  (The reference's 7-bit
// signed digits exist for its lazy signed limbs, which no kernel holds.)
//
// Layout.  One operand pair's 2D - 1 columns fill one 16 x 8 accumulator
// tile, column s = m + 16 n at row m, column n (n < NC = ceil((2D-1)/16)):
//     A[m][k] = a_(m + D - k),   B[k][n] = b_(16 n + k - D),
// zero outside [0, D), so sum_k A[m][k] B[k][n] = sum_(i+j=s) a_i b_j.
// For a digit pair (i, j) of column s, k = m + D - i lies in [1, 63]: two
// k32 steps cover it, with no fold afterwards.  A is stored as the
// operand's digits reversed and padded (arev, byte q = a_(D+15-q), so a
// fragment register of 4 consecutive k is 4 consecutive bytes: two
// aligned words and a funnel shift); B as the digits after D zero bytes
// (bpad, byte 16 n + k: an aligned word).
//
// Warp-collective.  mma.sync is one instruction of all 32 threads of a
// warp, each bringing its own operand pair: the pairs' digits go to a
// per-warp __shared__ buffer, the warp runs 2 mma.sync per pair (64 for
// its 32 pairs), each tile's columns go back to the buffer, and each
// thread then recombines its own pair's columns into the 2 NW product
// words and reduces them.  Every thread of the warp must call the
// product at the same point of the same path: the kernels run every
// thread of a warp (padding threads on a clamped index, stores off) and
// compute-and-select where a product depended on data (fp381.cuh
// EVERY_LANE, LIVE, SHELL).  A product reached by part of a warp only
// (a path this rule missed) traps: the launch fails and its wrapper
// raises, for nothing falls back to the CIOS product.
//
// Fragments (PTX ISA, mma.m16n8k32, .u8): groupID g = lane >> 2,
// t = lane & 3.  A: four .b32, element i (reg i / 4, byte i % 4) at row
// g (i < 4 or 8 <= i < 12) or g + 8, column 4t + i % 4 (+ 16 for i >= 8).
// B: two .b32, element i at row 4t + i % 4 (+ 16 for i >= 4), column g.
// C: four .s32, element i at row g (i < 2) or g + 8, column 2t + i % 2.
//
// The host build (no __CUDACC__) computes the same tile of the same A
// and B directly (int32 accumulate), so the CPU tests check the digit
// layout, the recombination and the reduction word for word;
// mma_layout_check runs the fragment builders of every lane through an
// emulation of the instruction's figures above.

#pragma once

// operand geometry for NW 32-bit words
template <int NW> struct mma_geom {
    enum {
        D = 4 * NW,                 // 8-bit digits
        NC = (2 * D - 1 + 15) / 16, // accumulator columns in use (n < NC)
        SLOTS = 16 * NC,            // column slots s = m + 16 n (>= 2D - 1)
        AW = 20,                    // arev words: A reads bytes < 80
        BW = 4 * NC + 12,           // bpad words: B reads bytes < 16 NC + 48
        CS = SLOTS + 1,             // a pair's column stride (odd: reads hit 32 banks)
        WARP_WORDS = 32 * (AW + BW + CS)
    };
};

DEV uint32_t mma_bswap(uint32_t x) {
#ifdef __CUDACC__
    return __byte_perm(x, 0, 0x0123);
#else
    return __builtin_bswap32(x);
#endif
}

// the low word of (hi:lo) >> sh, sh in {0, 8, 16, 24}
DEV uint32_t mma_funnel(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDACC__
    return __funnelshift_r(lo, hi, sh);
#else
    return sh == 0 ? lo : (lo >> sh) | (hi << (32 - sh));
#endif
}

// one pair's digit buffers: arev byte q = a_(D+15-q), bpad byte x = b_(x-D)
template <int NW>
DEV void mma_put_digits(const uint32_t* a, const uint32_t* b, uint32_t* arev, uint32_t* bpad) {
    typedef mma_geom<NW> G;
#pragma unroll
    for (int w = 0; w < G::AW; w++) {
        int u = NW + 3 - w;
        arev[w] = (u >= 0 && u < NW) ? mma_bswap(a[u]) : 0;
    }
#pragma unroll
    for (int w = 0; w < G::BW; w++) {
        int u = w - NW;
        bpad[w] = (u >= 0 && u < NW) ? b[u] : 0;
    }
}

// lane's A fragments of both k32 steps (fa[0..3] step 0, fa[4..7] step 1):
// register r of step s holds row m, k = 32 s + 4 t (+ 16 for r >= 2), at
// arev byte k - m + 15 = o + 8 j with o = 4t - g + 7 and j = 4 s + {1, 0, 3, 2}[r]
DEV void mma_frag_a(const uint32_t* arev, int lane, uint32_t* fa) {
    int g = lane >> 2, t = lane & 3;
    int o = 4 * t - g + 7;
    int w0 = o >> 2, sh = (o & 3) * 8;
#pragma unroll
    for (int s = 0; s < 2; s++) {
#pragma unroll
        for (int r = 0; r < 4; r++) {
            int j = 4 * s + (r == 0 ? 1 : r == 1 ? 0 : r == 2 ? 3 : 2);
            int w = w0 + 2 * j;
            fa[4 * s + r] = mma_funnel(arev[w], arev[w + 1], sh);
        }
    }
}

// lane's B fragments (fb[0..1] step 0, fb[2..3] step 1): column n = g,
// k = 32 s + 4 t (+ 16): bpad bytes 16 g + k, aligned words
DEV void mma_frag_b(const uint32_t* bpad, int lane, int nc, uint32_t* fb) {
    int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int s = 0; s < 2; s++) {
        fb[2 * s] = g < nc ? bpad[4 * g + 8 * s + t] : 0;
        fb[2 * s + 1] = g < nc ? bpad[4 * g + 8 * s + t + 4] : 0;
    }
}

// lane's accumulators into its pair's column slots s = m + 16 n
DEV void mma_store_c(int32_t* cols, int lane, int nc, const int32_t* c) {
    int g = lane >> 2, t = lane & 3;
    if (2 * t < nc) {
        cols[g + 32 * t] = c[0];
        cols[g + 8 + 32 * t] = c[2];
    }
    if (2 * t + 1 < nc) {
        cols[g + 16 + 32 * t] = c[1];
        cols[g + 24 + 32 * t] = c[3];
    }
}

// column slots -> the 2 NW words of the product (columns < 2^22)
template <int NW>
DEV void mma_recombine(const int32_t* cols, uint32_t* prod) {
    uint64_t acc = 0;
#pragma unroll
    for (int w = 0; w < 2 * NW; w++) {
#pragma unroll
        for (int e = 0; e < 4; e++) acc += (uint64_t)(uint32_t)cols[4 * w + e] << (8 * e);
        prod[w] = (uint32_t)acc;
        acc >>= 32;
    }
}

#ifdef __CUDACC__
// per warp: 32 pairs' arev, 32 pairs' bpad, 32 pairs' columns (Fq's
// geometry, the larger; Fr uses a prefix)
#define MMA_WARPS (THREADS / 32)
__shared__ __align__(16) uint32_t mma_smem[MMA_WARPS][mma_geom<12>::WARP_WORDS];

DEV void mma_k32(const uint32_t* fa, const uint32_t* fb, int32_t* c) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "r"(fb[0]), "r"(fb[1]));
}

// the 2 NW product words of this thread's pair; all 32 threads of the warp
template <int NW>
DEV void mma_product(const uint32_t* a, const uint32_t* b, uint32_t* prod) {
    typedef mma_geom<NW> G;
    uint32_t* arev = mma_smem[threadIdx.x >> 5];
    uint32_t* bpad = arev + 32 * G::AW;
    int32_t* cols = (int32_t*)(bpad + 32 * G::BW);
    int lane = threadIdx.x & 31;
    if (__activemask() != 0xffffffffu) __trap();   // a split warp: no product
    __syncwarp();                   // the last product's readers are done
    mma_put_digits<NW>(a, b, arev + lane * G::AW, bpad + lane * G::BW);
    __syncwarp();
#pragma unroll 1
    for (int p = 0; p < 32; p++) {
        uint32_t fa[8], fb[4];
        __syncwarp();               // whole for the mma.sync below
        mma_frag_a(arev + p * G::AW, lane, fa);
        mma_frag_b(bpad + p * G::BW, lane, G::NC, fb);
        int32_t c[4] = {0, 0, 0, 0};
        mma_k32(fa, fb, c);
        mma_k32(fa + 4, fb + 2, c);
        mma_store_c(cols + p * G::CS, lane, G::NC, c);
    }
    __syncwarp();
    mma_recombine<NW>(cols + lane * G::CS, prod);
}
#else
// the instruction's tile for one pair, directly: the same A and B
template <int NW>
DEV void mma_product(const uint32_t* a, const uint32_t* b, uint32_t* prod) {
    typedef mma_geom<NW> G;
    uint32_t arev[G::AW], bpad[G::BW];
    mma_put_digits<NW>(a, b, arev, bpad);
    const uint8_t* A = (const uint8_t*)arev;     // little-endian host
    const uint8_t* B = (const uint8_t*)bpad;
    int32_t cols[G::SLOTS];
    for (int n = 0; n < G::NC; n++)
        for (int m = 0; m < 16; m++) {
            int32_t acc = 0;
            for (int k = 0; k < 64; k++) acc += (int32_t)A[k - m + 15] * (int32_t)B[16 * n + k];
            cols[m + 16 * n] = acc;
        }
    mma_recombine<NW>(cols, prod);
}

// The fragment path on the host: 32 pairs through every lane's fragment
// builders, an emulation of mma.sync m16n8k32 by the PTX ISA's figures
// and the accumulator stores, against the direct tile; returns the
// number of column slots that differ (tests).
template <int NW>
static int mma_layout_check_nw(const uint32_t* a, const uint32_t* b) {
    typedef mma_geom<NW> G;
    int bad = 0;
    for (int p = 0; p < 32; p++) {
        uint32_t arev[G::AW], bpad[G::BW];
        mma_put_digits<NW>(a + NW * p, b + NW * p, arev, bpad);
        // the 16 x 64 A and 64 x 8 B that the lanes' fragments hold
        uint8_t A[16][64], B[64][8];
        for (int lane = 0; lane < 32; lane++) {
            uint32_t fa[8], fb[4];
            mma_frag_a(arev, lane, fa);
            mma_frag_b(bpad, lane, G::NC, fb);
            int g = lane >> 2, t = lane & 3;
            for (int s = 0; s < 2; s++) {
                for (int i = 0; i < 16; i++) {
                    int row = (i < 4 || (i >= 8 && i < 12)) ? g : g + 8;
                    int col = 32 * s + 4 * t + (i & 3) + (i >= 8 ? 16 : 0);
                    A[row][col] = (uint8_t)(fa[4 * s + i / 4] >> (8 * (i % 4)));
                }
                for (int i = 0; i < 8; i++) {
                    int row = 32 * s + 4 * t + (i & 3) + (i >= 4 ? 16 : 0);
                    B[row][g] = (uint8_t)(fb[2 * s + i / 4] >> (8 * (i % 4)));
                }
            }
        }
        // each lane's accumulators over both steps, stored as the card does
        int32_t cols[G::CS];
        for (int lane = 0; lane < 32; lane++) {
            int g = lane >> 2, t = lane & 3;
            int32_t c[4];
            for (int i = 0; i < 4; i++) {
                int row = i < 2 ? g : g + 8, col = 2 * t + (i & 1);
                int32_t acc = 0;
                for (int k = 0; k < 64; k++) acc += (int32_t)A[row][k] * (int32_t)B[k][col];
                c[i] = acc;
            }
            mma_store_c(cols, lane, G::NC, c);
        }
        uint32_t direct[2 * NW], warp[2 * NW];
        mma_product<NW>(a + NW * p, b + NW * p, direct);
        mma_recombine<NW>(cols, warp);
        for (int w = 0; w < 2 * NW; w++) bad += direct[w] != warp[w];
    }
    return bad;
}

extern "C" int mma_layout_check(int nw, const int32_t* a, const int32_t* b) {
    return nw == 12 ? mma_layout_check_nw<12>((const uint32_t*)a, (const uint32_t*)b)
                    : mma_layout_check_nw<8>((const uint32_t*)a, (const uint32_t*)b);
}
#endif

// Montgomery reduction of the 2 NW-word product t (t[2 NW] = 0 on entry):
// NW rows of t += (t[i] n0 mod 2^32) M 2^(32 i), each a lo and a hi
// multiply-add chain of NW (the m * P half of the CIOS loop); the
// result t[NW .. 2NW) < 2M
template <int NW>
DEV void mma_redc(uint32_t* t, const uint32_t* mod, uint32_t n0) {
    uint32_t pend = 0;              // carries owed to t[i + NW] (<= 2)
#pragma unroll
    for (int i = 0; i < NW; i++) {
        uint32_t m = t[i] * n0;
        t[i] = mad_lo_cc(m, mod[0], t[i]);
#pragma unroll
        for (int j = 1; j < NW; j++) t[i + j] = madc_lo_cc(m, mod[j], t[i + j]);
        t[i + NW] = addc_cc(t[i + NW], pend);
        uint32_t c1 = addc(0, 0);
        t[i + 1] = mad_hi_cc(m, mod[0], t[i + 1]);
#pragma unroll
        for (int j = 1; j < NW; j++) t[i + 1 + j] = madc_hi_cc(m, mod[j], t[i + 1 + j]);
        pend = c1 + addc(0, 0);
    }
    t[2 * NW] += pend;
}
