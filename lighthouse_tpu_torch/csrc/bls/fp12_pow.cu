// fp12_pow: f^e for a constant exponent e, one Fp12 a thread,
// [n, 2, 3, 2, 32] -> [n, 2, 3, 2, 32].
//
// Replaces lighthouse_tpu/ops/bls12_381.py:337 `fp12_pow_const`: start from
// f, then for each bit of e after its leading one square, and multiply by
// f where the bit is set (the JAX scan computes the product on every bit
// and selects; the bits are the same for every lane, so the kernel skips
// it). The wrapper passes the bits MSB first, the leading one left out.
// Bound: integer multiply-adds, (FP12_SQR + FP12_MUL on set bits) field
// products (ops/bls_cost.py) a lane; each lane is one serial chain of
// products (fp12_sqr, fp12_mul of tower.cuh), so a few lanes are latency
// bound.
#include "tower.cuh"

__global__ void fp12_pow_kernel(const int32_t* __restrict__ f,
                                const int32_t* __restrict__ bits, int nbits,
                                int32_t* __restrict__ out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Fp12 base, acc;
    fp12_load(base, f + i * 12 * LH_LIMBS);
    acc = base;
    for (int b = 0; b < nbits; ++b) {
        fp12_sqr(acc, acc);
        if (bits[b]) fp12_mul(acc, acc, base);
    }
    fp12_store(out + i * 12 * LH_LIMBS, acc);
}

extern "C" int lh_fp12_pow(const void* f, const void* bits, int nbits,
                           void* out, long long n, void* stream) {
    const int threads = 32;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    fp12_pow_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)f, (const int32_t*)bits, nbits, (int32_t*)out, n);
    return (int)cudaGetLastError();
}
