// g2_intake: gossip signature intake, a lane group a lane.
//   mode 0, decompression: y from y^2 = x^3 + 4(1+u) by the p = 3 mod 4
//           sqrt, the sign picked by the zcash lexicographic rule; ok is
//           0 where x^3 + b is not a square;
//   mode 1, subgroup check: psi(Q) == [u]Q (u < 0) for Jacobian Q.
//
// Replaces lighthouse_tpu/ops/bls12_381.py:1139 g2_decompress_batch and
// :1160 g2_in_subgroup_batch. Bound: integer multiply-adds (two 381-bit
// Fp2 exponentiations a lane for the sqrt; 64 doublings and 6 additions
// for [u]Q). Design: LH_G2I_WIDTH threads a lane (coop.cuh lg_step), the
// lane's values in shared memory: decompression walks fp2_sqrt's two
// powers from the bottom bit (the base's square and, on set bits, the
// product beside it in one step), the subgroup check runs psi, [|u|]Q
// (mixed additions where Q's z is one) and the cross-multiplied equality
// on the same steps, so the 10,240 lanes of the batch keep several warps
// on every scheduler where a thread a lane left most of them idle.
#include "coop.cuh"

#define LH_G2I_WIDTH 3
#define LH_G2I_THREADS 64

struct LgDec {
    enum {
        NV = LG_DEC_NV, X = LG_DEC_X, RHS = LG_DEC_RHS, Y = LG_DEC_Y,
        IX0 = LG_DEC_IX0, OTHER = LG_DEC_OTHER, B = LG_DEC_B,
        ONE = LG_DEC_ONE, INT1 = LG_DEC_INT1, YI = LG_DEC_YI,
        CUBE = LG_DEC_P_CUBE, CUBE_N = LG_DEC_P_CUBE_N,
        SQ = LG_DEC_P_POW_SQ, CPYSQ = LG_DEC_P_POW_CPYSQ,
        MULSQ = LG_DEC_P_POW_MULSQ, MUL = LG_DEC_P_POW_MUL,
        CPY = LG_DEC_P_POW_CPY, X0 = LG_DEC_P_X0, ALPHA = LG_DEC_P_ALPHA,
        ALPHA_V = LG_DEC_ALPHA_ALPHA, OTHER_P = LG_DEC_P_OTHER,
        Y2 = LG_DEC_P_Y2, Y2_V = LG_DEC_Y2_Y2, INT = LG_DEC_P_INT
    };
};

// the top set bit of a 12-word exponent
LH_DEV int lg_top(const uint32_t* e) {
    int top = 383;
    while (top > 0 && !((e[top >> 5] >> (top & 31)) & 1)) --top;
    return top;
}

LH_DEV bool lg_exp_bit(const uint32_t* e, int i) {
    return (e[i >> 5] >> (i & 31)) & 1;
}

__global__ void __launch_bounds__(LH_G2I_THREADS)
decompress_kernel(const int32_t* __restrict__ x,
                  const int32_t* __restrict__ flags,
                  int32_t* __restrict__ y, int32_t* __restrict__ ok,
                  long long n) {
    typedef LgDec L;
    Lg g;
    long long lane;
    if (!lg_init(g, LH_G2I_WIDTH, L::NV, n, lane)) return;
    for (int k = g.t; k < 7; k += g.G) {      // x, b, one, the integer 1
        Fp v;
        if (k < 2) {
            fp_load(v, x + (2 * lane + k) * LH_LIMBS);
        } else if (k < 4) {
            fp_set_const(v, LH_B_G2[k - 2]);
        } else {
            fp_zero(v);
            if (k == 4) fp_one(v);
            if (k == 6) v.w[0] = 1;
        }
        lg_st(g.V + (k < 2 ? L::X + k : k < 4 ? L::B + k - 2
                     : k < 6 ? L::ONE + k - 4 : L::INT1), v);
    }
    __syncwarp(g.mask);
    // phases: 0 x^3 + b; 1 a^((p-3)/4); 2 x0, alpha; 3 (alpha + 1)^((p-1)/2);
    // 4 the root; 5 its square; 6 its integer coefficients
    const uint32_t* e = LH_EXP_SQRT;
    int ph = 0, k = 0, i = 0, top = lg_top(e);
    bool have = false, neg1 = false, good = false;
    while (ph < 7) {
        int s;
        if (ph == 1 || ph == 3) {
            const bool bit = i < top && lg_exp_bit(e, i);
            s = i == top ? (have ? L::MUL : L::CPY)
                         : bit ? (have ? L::MULSQ : L::CPYSQ) : L::SQ;
            have = have || bit;
        } else {
            s = ph == 0 ? L::CUBE + k : ph == 2 ? (k ? L::ALPHA : L::X0)
                : ph == 4 ? L::OTHER_P : ph == 5 ? L::Y2 : L::INT;
        }
        lg_step(g, s);
        if (ph == 1 || ph == 3) {
            if (i++ < top) continue;
            i = 0;
            have = false;
            e = LH_EXP_LEGENDRE;
            top = lg_top(e);
        } else if (ph == 0 || ph == 2) {
            if (++k < (ph == 0 ? (int)L::CUBE_N : 2)) continue;
            k = 0;
            if (ph == 2) {
                Fp m1;
                fp_one(m1);
                fp_neg(m1, m1);
                Fp a0;
                lg_ld(a0, g.V + L::ALPHA_V);
                neg1 = fp_eq(a0, m1) && lg_is_zero(g, L::ALPHA_V + 1, 1);
                __syncwarp(g.mask);
            }
        } else if (ph == 4) {
            lg_copy(g, L::Y, neg1 ? L::IX0 : L::OTHER, 2);
        } else if (ph == 5) {
            good = lg_eq(g, L::Y2_V, L::RHS, 2);
            if (lg_is_zero(g, L::RHS, 2)) {
                good = true;
                lg_copy(g, L::Y, L::Y, 2, 0);
            } else {
                __syncwarp(g.mask);
            }
        }
        ++ph;
    }
    // the sign: y > -y lexicographically (c1 first), on the integers
    Fp c0, c1;
    lg_ld(c0, g.V + L::YI);
    lg_ld(c1, g.V + L::YI + 1);
    fp_canon(c0, c0);
    fp_canon(c1, c1);
    const bool larger = words_is_zero(c1.w) ? words_gt(c0, LH_HALF_P_INT)
                                            : words_gt(c1, LH_HALF_P_INT);
    const bool flip = larger != (flags[lane] != 0);
    for (int c = g.t; c < 2; c += g.G) {
        Fp v;
        lg_ld(v, g.V + L::Y + c);
        if (flip) fp_neg(v, v);
        fp_store(y + (2 * lane + c) * LH_LIMBS, v);
    }
    if (g.t == 0) ok[lane] = good ? 1 : 0;
}

struct LgSubg : LgSub {
    enum {
        PX = LG_SUB_PX, PZ = LG_SUB_PZ, CX = LG_SUB_CX, Y = LG_SUB_Y,
        PSI = LG_SUB_P_PSI, EQ = LG_SUB_P_EQ, EA = LG_SUB_EQ_EA,
        EB = LG_SUB_EQ_EB, EA2 = LG_SUB_EQ_EA2, EB2 = LG_SUB_EQ_EB2
    };
};

__global__ void __launch_bounds__(LH_G2I_THREADS)
subgroup_kernel(const int32_t* __restrict__ x,
                const int32_t* __restrict__ y,
                const int32_t* __restrict__ z, int32_t* __restrict__ ok,
                long long n) {
    typedef LgSubg L;
    Lg g;
    long long lane;
    if (!lg_init(g, LH_G2I_WIDTH, L::NV, n, lane)) return;
    for (int k = g.t; k < 4; k += g.G) {      // psi's constants
        Fp v;
        fp_set_const(v, k < 2 ? LH_H2C_PSI_CX[k] : LH_H2C_PSI_CY[k - 2]);
        lg_st(g.V + L::CX + k, v);
    }
    lg_load_point(g, 2, x, y, z, lane, L::QX, L::X);
    // [|u|]Q from the top bit of |u| (bit 63): ACC = Q there
    LgMul<L> m;
    m.bits = 0;
    m.k = LH_X_ABS;
    m.start(g, 64, lg_is_one(g, L::QZ, 2));
    // phases: 0 psi(Q); 1 [|u|]Q; 2 the equality of psi(Q) and [u]Q
    int ph = 0, k = 0;
    bool good = false;
    while (ph < 3) {
        lg_step(g, ph == 0 ? (int)L::PSI : ph == 1 ? m.step() : L::EQ + k);
        if (ph == 0) {
            ph = 1;
        } else if (ph == 1) {
            m.next(g);
            if (!m.done()) continue;
            const bool inf1 = lg_is_zero(g, L::PZ, 2);
            const bool inf2 = lg_is_zero(g, L::Z, 2);
            if (inf1 || inf2) {
                good = inf1 && inf2;
                break;
            }
            ph = 2;
        } else if (++k == 2) {
            if (!lg_eq(g, L::EA, L::EB, 2)) break;
        } else if (k == 3) {
            good = lg_eq(g, L::EA2, L::EB2, 2);
            break;
        }
    }
    if (g.t == 0) ok[lane] = good ? 1 : 0;
}

extern "C" int lh_g2_intake(int mode, const void* x, const void* flags,
                            void* y, const void* z, void* ok, long long n,
                            void* stream) {
    const int lanes = lg_lanes(LH_G2I_THREADS, LH_G2I_WIDTH);
    const unsigned blocks = (unsigned)((n + lanes - 1) / lanes);
    cudaStream_t s = (cudaStream_t)stream;
    if (mode == 0) {
        const size_t smem = lg_smem(LH_G2I_THREADS, LH_G2I_WIDTH, LgDec::NV);
        cudaFuncSetAttribute(decompress_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
        decompress_kernel<<<blocks, LH_G2I_THREADS, smem, s>>>(
            (const int32_t*)x, (const int32_t*)flags, (int32_t*)y,
            (int32_t*)ok, n);
    } else {
        const size_t smem = lg_smem(LH_G2I_THREADS, LH_G2I_WIDTH,
                                    LgSubg::NV);
        cudaFuncSetAttribute(subgroup_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
        subgroup_kernel<<<blocks, LH_G2I_THREADS, smem, s>>>(
            (const int32_t*)x, (const int32_t*)y, (const int32_t*)z,
            (int32_t*)ok, n);
    }
    return (int)cudaGetLastError();
}
