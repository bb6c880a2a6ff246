// rlc_scale: the random-linear-combination scaling of a batch, [b_i]P_i
// for per-lane scalars given as MSB-first 0/1 bits [n, nbits], over G1
// (field 1) or G2 (field 2): double, and add the point on set bits, with
// the Jacobian formulas of _make_point_ops; the addition is mixed (no
// products by Z2 = 1) on lanes whose input z is one, as on the main path.
//
// Replaces lighthouse_tpu/ops/bls12_381.py:523-524 g1_scalar_mul_jit /
// g2_scalar_mul_jit (:460 scalar_mul). Bound: integer multiply-adds (64
// doublings and ~32 additions a lane). Design: a lane group of
// LH_RLC_G1_WIDTH / LH_RLC_G2_WIDTH threads a lane (coop.cuh lg_step),
// its values in shared memory, a step's products spread over the group,
// so the 10,240 lanes of the batch give the card several warps a
// scheduler where a thread a lane gave 320 warps for its 528 schedulers;
// the groups of a warp double together and add when any of their bits is
// set (coop.cuh LgMul).
#include "coop.cuh"

#define LH_RLC_G1_WIDTH 3
#define LH_RLC_G2_WIDTH 3
#define LH_RLC_THREADS 64

template <class F> struct RlcLayout;
template <> struct RlcLayout<Fp> : LgRlc1 { enum { G = LH_RLC_G1_WIDTH }; };
template <> struct RlcLayout<Fp2> : LgRlc2 { enum { G = LH_RLC_G2_WIDTH }; };

template <class F>
__global__ void __launch_bounds__(LH_RLC_THREADS)
scale_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
             const int32_t* __restrict__ z,
             const int32_t* __restrict__ bits, int nbits,
             int32_t* __restrict__ ox, int32_t* __restrict__ oy,
             int32_t* __restrict__ oz, long long n) {
    typedef RlcLayout<F> L;
    Lg g;
    long long lane;
    if (!lg_init(g, L::G, L::NV, n, lane)) return;
    lg_load_point(g, L::D, x, y, z, lane, L::QX, L::X);
    LgMul<L> m;
    m.bits = bits + lane * nbits;
    m.k = 0;
    if (nbits <= 64) {          // the bits into a register, MSB at bit 63
        for (int i = 0; i < nbits; ++i)
            m.k |= (unsigned long long)(m.bits[i] != 0) << (63 - i);
        m.bits = 0;
    }
    m.start(g, nbits, lg_is_one(g, L::QZ, L::D));
    while (!m.done()) {
        lg_step(g, m.step());
        m.next(g);
    }
    lg_store_point(g, L::D, ox, oy, oz, lane, L::X);
}

extern "C" int lh_rlc_scale(int field, const void* x, const void* y,
                            const void* z, const void* bits, int nbits,
                            void* ox, void* oy, void* oz, long long n,
                            void* stream) {
    auto launch = [&](auto kernel, int G, int nv) {
        const int lanes = lg_lanes(LH_RLC_THREADS, G);
        const size_t smem = lg_smem(LH_RLC_THREADS, G, nv);
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
        kernel<<<(unsigned)((n + lanes - 1) / lanes), LH_RLC_THREADS, smem,
                 (cudaStream_t)stream>>>(
            (const int32_t*)x, (const int32_t*)y, (const int32_t*)z,
            (const int32_t*)bits, nbits, (int32_t*)ox, (int32_t*)oy,
            (int32_t*)oz, n);
        return (int)cudaGetLastError();
    };
    return field == 1
        ? launch(scale_kernel<Fp>, RlcLayout<Fp>::G, RlcLayout<Fp>::NV)
        : launch(scale_kernel<Fp2>, RlcLayout<Fp2>::G, RlcLayout<Fp2>::NV);
}
