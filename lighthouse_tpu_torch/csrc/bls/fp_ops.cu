// fp_ops: elementwise Montgomery multiply, add and subtract over [n, 32]
// limbs (op 0, 1, 2), one element per thread.
//
// Replaces lighthouse_tpu/ops/bigint.py:318 mont_mul (with :124
// normalize, :207 _mul_columns), :376 add_mod and :381 sub_mod: the card
// check of the field layer every other BLS kernel is built on, and the
// main path's conversion of lane inputs into the Montgomery domain
// (mont_from_int_limbs). Built once for each multiply lowering
// (LH_FP_MODE, fp.cuh): the mode-1 and mode-2 variants replace :319 in
// those modes. Bound: integer ops (a CIOS product is 288 32x32->64-bit
// multiply-adds, ops/bls_cost.py FP_MUL_INT_OPS, in every mode) for mul,
// bytes for add and sub.
#include "fp.cuh"

LH_DEV void fp_ops_lane(int op, const int32_t* a, const int32_t* b,
                        int32_t* out, long long i) {
    Fp x, y, r;
    fp_load(x, a + i * LH_LIMBS);
    fp_load(y, b + i * LH_LIMBS);
    if (op == 0) fp_mul(r, x, y);
    else if (op == 1) fp_add(r, x, y);
    else fp_sub(r, x, y);
    fp_store(out + i * LH_LIMBS, r);
}

__global__ void fp_ops_kernel(int op, const int32_t* __restrict__ a,
                              const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) fp_ops_lane(op, a, b, out, i);
}

extern "C" int lh_fp_ops(int op, const void* a, const void* b, void* out,
                         long long n, void* stream) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    fp_ops_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        op, (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n);
    return (int)cudaGetLastError();
}
