// rlc_scale: the random-linear-combination scaling of a batch, [b_i]P_i
// for per-lane scalars given as MSB-first 0/1 bits [n, nbits], over G1
// (field 1) or G2 (field 2), one lane per thread: double, and add the
// point on set bits, with the Jacobian formulas of _make_point_ops.
//
// Replaces lighthouse_tpu/ops/bls12_381.py:523-524 g1_scalar_mul_jit /
// g2_scalar_mul_jit (:460 scalar_mul). Bound: integer multiply-adds (64
// doublings and ~32 additions a lane); lanes are independent, so 10,240
// of them fill the card.
#include "curve.cuh"

template <class F>
LH_DEV void scale_lane(const int32_t* x, const int32_t* y, const int32_t* z,
                       const int32_t* bits, int nbits, int32_t* ox,
                       int32_t* oy, int32_t* oz, long long i) {
    Jac<F> p, r;
    jac_load(p, x, y, z, i);
    jac_scalar_mul_bits(r, p, bits + i * nbits, nbits);
    jac_store(ox, oy, oz, i, r);
}

template <class F>
__global__ void scale_kernel(const int32_t* __restrict__ x,
                             const int32_t* __restrict__ y,
                             const int32_t* __restrict__ z,
                             const int32_t* __restrict__ bits, int nbits,
                             int32_t* __restrict__ ox,
                             int32_t* __restrict__ oy,
                             int32_t* __restrict__ oz, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) scale_lane<F>(x, y, z, bits, nbits, ox, oy, oz, i);
}

extern "C" int lh_rlc_scale(int field, const void* x, const void* y,
                            const void* z, const void* bits, int nbits,
                            void* ox, void* oy, void* oz, long long n,
                            void* stream) {
    const int threads = 64;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 1)
        scale_kernel<Fp><<<blocks, threads, 0, s>>>(
            (const int32_t*)x, (const int32_t*)y, (const int32_t*)z,
            (const int32_t*)bits, nbits, (int32_t*)ox, (int32_t*)oy,
            (int32_t*)oz, n);
    else
        scale_kernel<Fp2><<<blocks, threads, 0, s>>>(
            (const int32_t*)x, (const int32_t*)y, (const int32_t*)z,
            (const int32_t*)bits, nbits, (int32_t*)ox, (int32_t*)oy,
            (int32_t*)oz, n);
    return (int)cudaGetLastError();
}
