// fp381.cu -- entry points of the fp381.cuh library, for parity tests.
//
// Not a stage of the verify pipeline: these expose the field and tower
// arithmetic every kernel is built from (the counterpart of the TPU
// engine's teku_tpu/ops/limbs.py mont_mul / pow_static / inv and
// towers.py fq2_mul / fq12_mul), so each can be held against the plain
// PyTorch engine on the card.  One thread per element; canonical plain
// words in and out (to Montgomery form on load, back on store), except
// fp_mont and fr_mont: each engine's Montgomery product alone (the mma
// build: row 11, mma_digits.cuh), a * b * R^-1 on words in [0, M) taken
// as they are, one product an element.  Bound: 32-bit multiply-adds
// (fp381.cuh, fr255.cuh).

#include "fp381.cuh"
#include "fr255.cuh"

enum { OP_FP_MUL = 0, OP_FP_INV = 1, OP_FP_SQRT = 2, OP_FQ2_MUL = 3, OP_FQ12_MUL = 4,
       OP_FR_MUL = 5, OP_FP_MONT = 6, OP_FR_MONT = 7 };

// NW words as they are, no conversion (T: fp or fr)
template <typename T, int NW> DEV T words_in(const int32_t* w) {
    T r;
    for (int j = 0; j < NW; j++) r.v[j] = (uint32_t)w[j];
    return r;
}

template <typename T, int NW> DEV void words_out(int32_t* w, const T& a) {
    if (LIVE)
        for (int j = 0; j < NW; j++) w[j] = (int32_t)a.v[j];
}

DEVNI void fp381_op(long i, int op, const int32_t* a, const int32_t* b, int32_t* out) {
    switch (op) {
    case OP_FP_MUL:
        fp_store(out + 12 * i, fp_mul(fp_load(a + 12 * i), fp_load(b + 12 * i)));
        break;
    case OP_FP_INV:
        fp_store(out + 12 * i, fp_inv(fp_load(a + 12 * i)));
        break;
    case OP_FP_SQRT:
        fp_store(out + 12 * i, fp_sqrt_candidate(fp_load(a + 12 * i)));
        break;
    case OP_FQ2_MUL:
        fq2_store(out + 24 * i, fq2_mul(fq2_load(a + 24 * i), fq2_load(b + 24 * i)));
        break;
    case OP_FQ12_MUL:
        fq12_store(out + 144 * i, fq12_mul(fq12_load(a + 144 * i), fq12_load(b + 144 * i)));
        break;
    case OP_FR_MUL:
        fr_store(out + 8 * i, fr_mul(fr_load(a + 8 * i), fr_load(b + 8 * i)));
        break;
    case OP_FP_MONT:
        words_out<fp, 12>(out + 12 * i,
                          fp_mul(words_in<fp, 12>(a + 12 * i), words_in<fp, 12>(b + 12 * i)));
        break;
    case OP_FR_MONT:
        words_out<fr, 8>(out + 8 * i,
                         fr_mul(words_in<fr, 8>(a + 8 * i), words_in<fr, 8>(b + 8 * i)));
        break;
    }
}

#ifdef __CUDACC__
__global__ void fp381_op_kernel(long n, int op, const int32_t* a, const int32_t* b, int32_t* out) {
    SHELL(n, fp381_op(ix, op, a, b, out));
}
#endif

extern "C" int fp381_ops(int op, const int32_t* a, const int32_t* b, int32_t* out, long n,
                         void* stream) {
    LAUNCH(n, fp381_op, op, a, b, out);
    return 0;
}
