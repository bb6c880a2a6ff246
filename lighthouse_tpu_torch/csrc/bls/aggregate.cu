// aggregate: the sums and the affine conversion between the scaling and
// the Miller loop.
//   lh_g1_segment_sum: per-message pubkey sums; thread g walks the segment
//       that holds lane ends[g] in lane order, from its first lane
//       (starts[] == 1) to ends[g] (replaces lighthouse_tpu/ops/
//       bls12_381.py:527 g1_segment_sum, a log-depth segmented scan: the
//       same sums, in another order, so the same points projectively);
//   lh_g2_sum: the sum of n G2 points in the JAX order (:571 _g2_sum_rows,
//       :589 g2_sum): 128 threads of one block each add one column of the
//       [ceil(n/128), 128] layout (rows padded with infinity), then one
//       thread adds the 128 partials;
//   lh_affine: (X/Z^2, Y/Z^3) over G1 (field 1) or G2 (field 2), Z = 0
//       inverting to 0 (:557 jacobian_to_affine_fp2, :564 _fp).
// Bound: integer multiply-adds. The G2 sum is a serial chain of ~208
// additions in one block (latency bound); the segment walk is as long as
// the longest segment (~79 lanes for 10,000 sets over 127 messages).
#include "curve.cuh"

LH_DEV void g1_segment_sum_lane(const int32_t* x, const int32_t* y,
                                const int32_t* z, const int32_t* starts,
                                const int32_t* ends, int32_t* ox,
                                int32_t* oy, int32_t* oz, long long g) {
    const long long e = ends[g];
    long long s = e;
    while (s > 0 && !starts[s]) --s;
    Jac<Fp> acc, p;
    jac_load(acc, x, y, z, s);
    for (long long l = s + 1; l <= e; ++l) {
        jac_load(p, x, y, z, l);
        jac_add(acc, acc, p);
    }
    jac_store(ox, oy, oz, g, acc);
}

#define LH_G2_SUM_W 128

// column c of the [m, w] layout of n points, rows padded with infinity
LH_DEV void g2_sum_column(Jac<Fp2>& acc, const int32_t* x, const int32_t* y,
                          const int32_t* z, long long n, long long w,
                          long long c) {
    const long long m = (n + w - 1) / w;
    Jac<Fp2> p;
    jac_inf_g2(acc);
    for (long long r = 0; r < m; ++r) {
        const long long idx = r * w + c;
        if (idx < n) jac_load(p, x, y, z, idx);
        else jac_inf_g2(p);
        jac_add(acc, acc, p);
    }
}

// the sum of the w column partials (the partial itself when w == 1)
LH_DEV void g2_sum_partials(Jac<Fp2>& acc, const Jac<Fp2>* part,
                            long long w) {
    if (w == 1) {
        acc = part[0];
        return;
    }
    jac_inf_g2(acc);
    for (long long k = 0; k < w; ++k) jac_add(acc, acc, part[k]);
}

template <class F>
LH_DEV void affine_lane(const int32_t* x, const int32_t* y, const int32_t* z,
                        int32_t* ox, int32_t* oy, long long i) {
    Jac<F> p;
    F ax, ay;
    jac_load(p, x, y, z, i);
    jac_to_affine(ax, ay, p);
    f_store(ox + i * Limbs<F>::n, ax);
    f_store(oy + i * Limbs<F>::n, ay);
}

__global__ void g1_segment_sum_kernel(const int32_t* __restrict__ x,
                                      const int32_t* __restrict__ y,
                                      const int32_t* __restrict__ z,
                                      const int32_t* __restrict__ starts,
                                      const int32_t* __restrict__ ends,
                                      long long g_count,
                                      int32_t* __restrict__ ox,
                                      int32_t* __restrict__ oy,
                                      int32_t* __restrict__ oz) {
    long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g < g_count)
        g1_segment_sum_lane(x, y, z, starts, ends, ox, oy, oz, g);
}

__global__ void g2_sum_kernel(const int32_t* __restrict__ x,
                              const int32_t* __restrict__ y,
                              const int32_t* __restrict__ z, long long n,
                              int32_t* __restrict__ ox,
                              int32_t* __restrict__ oy,
                              int32_t* __restrict__ oz) {
    __shared__ Jac<Fp2> part[LH_G2_SUM_W];
    const int c = threadIdx.x;
    const long long w = n < LH_G2_SUM_W ? n : LH_G2_SUM_W;
    if (c < w) {
        Jac<Fp2> acc;
        g2_sum_column(acc, x, y, z, n, w, c);
        part[c] = acc;
    }
    __syncthreads();
    if (c == 0) {
        Jac<Fp2> acc;
        g2_sum_partials(acc, part, w);
        jac_store(ox, oy, oz, 0, acc);
    }
}

template <class F>
__global__ void affine_kernel(const int32_t* __restrict__ x,
                              const int32_t* __restrict__ y,
                              const int32_t* __restrict__ z,
                              int32_t* __restrict__ ox,
                              int32_t* __restrict__ oy, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) affine_lane<F>(x, y, z, ox, oy, i);
}

extern "C" int lh_g1_segment_sum(const void* x, const void* y,
                                 const void* z, const void* starts,
                                 long long n_lanes, const void* ends,
                                 long long g_count, void* ox, void* oy,
                                 void* oz, void* stream) {
    (void)n_lanes;
    const int threads = 32;
    const unsigned blocks = (unsigned)((g_count + threads - 1) / threads);
    g1_segment_sum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (const int32_t*)y, (const int32_t*)z,
        (const int32_t*)starts, (const int32_t*)ends, g_count,
        (int32_t*)ox, (int32_t*)oy, (int32_t*)oz);
    return (int)cudaGetLastError();
}

extern "C" int lh_g2_sum(const void* x, const void* y, const void* z,
                         long long n, void* ox, void* oy, void* oz,
                         void* stream) {
    g2_sum_kernel<<<1, LH_G2_SUM_W, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, n,
        (int32_t*)ox, (int32_t*)oy, (int32_t*)oz);
    return (int)cudaGetLastError();
}

extern "C" int lh_affine(int field, const void* x, const void* y,
                         const void* z, void* ox, void* oy, long long n,
                         void* stream) {
    const int threads = 64;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 1)
        affine_kernel<Fp><<<blocks, threads, 0, s>>>(
            (const int32_t*)x, (const int32_t*)y, (const int32_t*)z,
            (int32_t*)ox, (int32_t*)oy, n);
    else
        affine_kernel<Fp2><<<blocks, threads, 0, s>>>(
            (const int32_t*)x, (const int32_t*)y, (const int32_t*)z,
            (int32_t*)ox, (int32_t*)oy, n);
    return (int)cudaGetLastError();
}
