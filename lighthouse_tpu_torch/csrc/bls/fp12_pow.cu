// fp12_pow: f^e for a constant exponent e on the cooperative layer
// (coop.cuh co_step), [n, 2, 3, 2, 32] -> [n, 2, 3, 2, 32].
//
// Replaces lighthouse_tpu/ops/bls12_381.py:337 `fp12_pow_const`. The JAX
// scan starts from f and, for each bit of e after its leading one, squares
// and multiplies by f where the bit is set; this kernel walks e from its
// bottom bit, as co_cyc_pow does: each bit squares the base (the general
// square, CO_SQR12: f need not be cyclotomic) and, where it is set,
// multiplies the base into acc in the same step (the first set bit copies
// it). Both give f^e, so the two are compared canonically. e = 0 gives f,
// as the JAX scan over no bits does. The wrapper passes e's bits from the
// bottom one, so an exponent of any width works.
//
// Design: every lane takes the same step (e is the same for all), so a
// block holds L lanes and one co_step runs their 2L ops side by side,
// LH_POW_TPL threads a lane each taking products. The chain is e's bit
// length deep in steps, each one multiply's latency plus its sums and
// barriers, instead of a thread's chain of ~2,500 products. The C entry
// takes L = 1 while the lanes are at most two an SM (latency-bound), else
// 2: within 12 % of the best of L = 1, 2, 4 at 32 or 64 threads a lane
// from 128 to 10,240 lanes in compare_kernels' sweep (an H100), whose
// builds set LH_POW_LANES to force one L.
// What bounds it: integer multiply-adds of 36 products a square and 54 a
// product a lane (ops/bls_cost.py fp12_pow), ~3.7k products a lane for
// e = |x|.
#include "coop.cuh"

#ifndef LH_POW_TPL
#define LH_POW_TPL 64          // threads a lane
#endif
#define LH_POW_SM_LANES 2      // one lane a block up to this many an SM
// a lane's shared memory: its base and acc (24 Fp), and the scratch of its
// square and product (72 + 108 Fp)
#define LH_POW_LANE_FP (24 + 72 + 108)

template <int L>
__global__ void __launch_bounds__(L * LH_POW_TPL)
fp12_pow_kernel(const int32_t* __restrict__ f,
                const int32_t* __restrict__ bits, int nbits,
                int32_t* __restrict__ out, long long n) {
    extern __shared__ uint4 lh_smem[];
    Fp* sh = reinterpret_cast<Fp*>(lh_smem);   // lane l: base, acc at 24 l
    Fp* sc = sh + 24 * L;
    const long long first = (long long)blockIdx.x * L;
    const int live = n - first < L ? (int)(n - first) : L;
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int j = tid; j < 12 * live; j += nt) {
        const int l = j / 12, c = j - 12 * l;
        Fp v;
        fp_load(v, f + ((first + l) * 12 + c) * LH_LIMBS);
        sh[24 * l + c] = v;
    }
    __syncthreads();
    bool have = false;
    for (int i = 0; i < nbits; ++i) {
        const bool set = bits[i] != 0;
        CoOp ops[2 * L];
        int k = 0;
        for (int l = 0; l < live; ++l) {
            Fp* base = sh + 24 * l;
            Fp* acc = base + 12;
            if (set)
                ops[k++] = have ? co_op(CO_MUL12, acc, acc, base)
                                : co_op(CO_COPY, acc, base);
            if (i + 1 < nbits) ops[k++] = co_op(CO_SQR12, base, base);
        }
        have = have || set;
        co_step(ops, k, sc);
    }
    for (int j = tid; j < 12 * live; j += nt) {
        const int l = j / 12, c = j - 12 * l;
        fp_store(out + ((first + l) * 12 + c) * LH_LIMBS,
                 sh[24 * l + (have ? 12 : 0) + c]);
    }
}

// the C entry (the host build of testing/host_cuda.py stops here)
extern "C" int lh_fp12_pow(const void* f, const void* bits, int nbits,
                           void* out, long long n, void* stream);

template <int L>
static int fp12_pow_launch(const void* f, const void* bits, int nbits,
                           void* out, long long n, cudaStream_t s) {
    fp12_pow_kernel<L><<<(unsigned)((n + L - 1) / L), L * LH_POW_TPL,
                         L * LH_POW_LANE_FP * sizeof(Fp), s>>>(
        (const int32_t*)f, (const int32_t*)bits, nbits, (int32_t*)out, n);
    return (int)cudaGetLastError();
}

// L = 1 while the lanes are at most LH_POW_SM_LANES an SM, else 2 (a
// sweep build's LH_POW_LANES forces its own L)
extern "C" int lh_fp12_pow(const void* f, const void* bits, int nbits,
                           void* out, long long n, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
#ifdef LH_POW_LANES
    return fp12_pow_launch<LH_POW_LANES>(f, bits, nbits, out, n, s);
#else
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (n <= (long long)LH_POW_SM_LANES * sms) return fp12_pow_launch<1>(f, bits, nbits, out, n, s);
    return fp12_pow_launch<2>(f, bits, nbits, out, n, s);
#endif
}
