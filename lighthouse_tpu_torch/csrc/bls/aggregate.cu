// aggregate: the sums and the affine conversion between the scaling and
// the Miller loop.
//   lh_g1_segment_sum: per-message pubkey sums; thread g walks the segment
//       that holds lane ends[g] in lane order, from its first lane
//       (starts[] == 1) to ends[g] (replaces lighthouse_tpu/ops/
//       bls12_381.py:527 g1_segment_sum, a log-depth segmented scan: the
//       same sums, in another order, so the same points projectively);
//   lh_g2_sum: the sum of n G2 points (:571 _g2_sum_rows, :589 g2_sum) as
//       a pairwise tree in two launches of one kernel: G = min(ceil(n /
//       128), 128) blocks of 128 threads, thread g = 128 b + t holding
//       point g (and folding g + 128 G, g + 256 G, ... in series past
//       128^2 points), a tree over the block's threads in shared memory
//       (each level slot i takes slot i + ceil(w / 2)), one partial a
//       block; then one block's tree over the G partials. A level of many
//       additions gives each a thread; the top levels, of at most 16,
//       give each a warp (coop.cuh w_jac_add, the same values). The order
//       is fixed by n alone (no atomics, nothing scheduling-dependent),
//       so every call on the same points gives the same limbs; it is not
//       the JAX order (rows, then the 128 column partials), so the
//       Jacobian representative differs from the JAX one by (l^2, l^3,
//       l): the same point, held projectively. jac_add takes infinity,
//       equal and opposite points, so any order gives the same point;
//   lh_affine: (X/Z^2, Y/Z^3) over G1 (field 1) or G2 (field 2), Z = 0
//       inverting to 0 (:557 jacobian_to_affine_fp2, :564 _fp), one thread
//       a point. The inverse is fp.cuh's binary extended Euclid (one
//       multiply and ~270 steps of word subtractions and shifts, where the
//       JAX package's Fermat power runs 608 multiplies in series: the same
//       values, variable-time on public inputs). A lane's chain of
//       dependent word operations bounds a launch; a warp runs its longest
//       lane, and small blocks (LH_AFFINE_THREADS, the best of 32 / 64 /
//       128 on the card) spread a call's few warps over more SMs.
// Bound: integer multiply-adds (the affine conversion: what the function
// needs at least, one inverse a call by batch inversion, 3 (n - 1)
// products for it and four a lane, bls_cost.affine_least; this kernel
// inverts a lane at a time, bls_cost.affine_int_ops). The G2 sum is n - 1 additions; its
// latency is the tree's depth, 14 levels at 10,240 points (7 in a block,
// 7 over the 80 partials): four of 48 dependent field multiplies on one
// thread, the rest 5 warp steps an addition in one to four rounds (277 in
// all, bls_cost.g2_sum_depth); the segment walk is as long as the longest
// segment (~79 lanes for 10,000 sets over 127 messages).
#include "coop.cuh"

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

// threads a block of the affine conversion
#define LH_AFFINE_THREADS 32

#ifndef LH_G2_SUM_T
#define LH_G2_SUM_T 128        // threads (tree slots) a block; most blocks
#endif
// a level of at most this many additions a warp gives each a warp
#define LH_G2_SUM_WARP_ROUNDS 4
// the slots, then each warp's 32 Fp of w_step scratch
#define LH_G2_SUM_SMEM (LH_G2_SUM_T * (int)sizeof(Jac<Fp2>) \
                        + LH_G2_SUM_T * (int)sizeof(Fp))

// slot[0] = the sum of slot[0..w), w <= blockDim.x, in a fixed order: each
// level slot i takes slot i + h, h = ceil(w / 2); every thread calls it.
// A level of many additions gives each a thread (jac_add: 48 dependent
// multiplies); one of few gives each a warp in turn (w_jac_add: its 16
// Fp2 products in 5 warp steps), the same values. sc: the warps' scratch
LH_DEV void g2_tree(Jac<Fp2>* slot, int w, Fp* sc) {
    const int t = threadIdx.x, warp = t >> 5, warps = blockDim.x >> 5;
    for (; w > 1; w = (w + 1) / 2) {
        const int h = (w + 1) / 2, m = w - h;
        if (m > LH_G2_SUM_WARP_ROUNDS * warps) {
            if (t < m) {
                Jac<Fp2> a = slot[t];
                const Jac<Fp2> b = slot[t + h];
                jac_add(a, a, b);
                slot[t] = a;
            }
        } else {
            for (int q = warp; q < m; q += warps) {
                Jac<Fp2> a = slot[q];
                const Jac<Fp2> b = slot[q + h];
                w_jac_add(sc + 32 * warp, a, a, b);
                if ((t & 31) == 0) slot[q] = a;
            }
        }
        __syncthreads();
    }
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

// block b writes the sum of points g, g + S, g + 2S, ... (S = gridDim.x *
// blockDim.x) over its threads g = b * blockDim.x + t to (ox, oy, oz)[b]
__global__ void __launch_bounds__(LH_G2_SUM_T)
g2_sum_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
              const int32_t* __restrict__ z, long long n,
              int32_t* __restrict__ ox, int32_t* __restrict__ oy,
              int32_t* __restrict__ oz) {
    extern __shared__ uint4 lh_smem[];
    Jac<Fp2>* slot = reinterpret_cast<Jac<Fp2>*>(lh_smem);
    Fp* sc = reinterpret_cast<Fp*>(slot + LH_G2_SUM_T);
    const long long first = (long long)blockIdx.x * blockDim.x;
    const long long g = first + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    if (g < n) {
        Jac<Fp2> acc, p;
        jac_load(acc, x, y, z, g);
        for (long long i = g + stride; i < n; i += stride) {
            jac_load(p, x, y, z, i);
            jac_add(acc, acc, p);
        }
        slot[threadIdx.x] = acc;
    }
    __syncthreads();
    const long long left = n - first;
    g2_tree(slot, left < blockDim.x ? (int)left : (int)blockDim.x, sc);
    if (threadIdx.x == 0) {
        const Jac<Fp2> s = slot[0];
        jac_store(ox, oy, oz, blockIdx.x, s);
    }
}

// blocks of the first launch of g2_sum_kernel (the partials' count)
static long long g2_sum_blocks(long long n) {
    const long long b = (n + LH_G2_SUM_T - 1) / LH_G2_SUM_T;
    return b < LH_G2_SUM_T ? b : LH_G2_SUM_T;
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

// part: the first launch's partials, 3 x blocks x 2 x LH_LIMBS words (the
// caller allocates them; unread up to LH_G2_SUM_T points)
extern "C" int lh_g2_sum(const void* x, const void* y, const void* z,
                         long long n, void* part, void* ox, void* oy,
                         void* oz, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long blocks = g2_sum_blocks(n);
    if (blocks == 1) {
        g2_sum_kernel<<<1, LH_G2_SUM_T, LH_G2_SUM_SMEM, s>>>(
            (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, n,
            (int32_t*)ox, (int32_t*)oy, (int32_t*)oz);
        return (int)cudaGetLastError();
    }
    int32_t* px = (int32_t*)part;
    const long long words = blocks * 2 * LH_LIMBS;
    g2_sum_kernel<<<(unsigned)blocks, LH_G2_SUM_T, LH_G2_SUM_SMEM, s>>>(
        (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, n, px,
        px + words, px + 2 * words);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    g2_sum_kernel<<<1, LH_G2_SUM_T, LH_G2_SUM_SMEM, s>>>(
        px, px + words, px + 2 * words, blocks, (int32_t*)ox, (int32_t*)oy,
        (int32_t*)oz);
    return (int)cudaGetLastError();
}

extern "C" int lh_affine(int field, const void* x, const void* y,
                         const void* z, void* ox, void* oy, long long n,
                         void* stream) {
    const int threads = LH_AFFINE_THREADS;
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
