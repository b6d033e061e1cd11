// fp381.cu -- entry points of the fp381.cuh library, for parity tests.
//
// Not a stage of the verify pipeline: these expose the field and tower
// arithmetic every kernel is built from (the counterpart of the TPU
// engine's teku_tpu/ops/limbs.py mont_mul / pow_static / inv and
// towers.py fq2_mul / fq12_mul), so each can be held against the plain
// PyTorch engine on the card.  Bound: 32-bit multiply-adds (fp381.cuh).
// One thread per element; canonical plain words in and out.

#include "fp381.cuh"

enum { OP_FP_MUL = 0, OP_FP_INV = 1, OP_FP_SQRT = 2, OP_FQ2_MUL = 3, OP_FQ12_MUL = 4 };

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
    }
}

#ifdef __CUDACC__
__global__ void fp381_op_kernel(long n, int op, const int32_t* a, const int32_t* b, int32_t* out) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) fp381_op(i, op, a, b, out);
}
#endif

extern "C" int fp381_ops(int op, const int32_t* a, const int32_t* b, int32_t* out, long n,
                         void* stream) {
    LAUNCH(n, fp381_op, op, a, b, out);
    return 0;
}
