// g2_intake: gossip signature intake, one lane per thread.
//   mode 0, decompression: y from y^2 = x^3 + 4(1+u) by the p = 3 mod 4
//           sqrt, the sign picked by the zcash lexicographic rule; ok is
//           0 where x^3 + b is not a square;
//   mode 1, subgroup check: psi(Q) == [u]Q (u < 0) for Jacobian Q.
//
// Replaces lighthouse_tpu/ops/bls12_381.py:1139 g2_decompress_batch and
// :1160 g2_in_subgroup_batch. Bound: integer multiply-adds (two 381-bit
// Fp2 exponentiations a lane for the sqrt; 64 doublings and 6 additions
// for [u]Q). One thread carries a whole lane: the chains are serial, the
// lanes (10,240 on the flagship batch) fill the card.
#include "curve.cuh"

LH_DEV void g2_intake_lane(int mode, const int32_t* x, const int32_t* flags,
                           int32_t* y, const int32_t* z, int32_t* ok,
                           long long i) {
    const long long o = i * 2 * LH_LIMBS;
    if (mode == 0) {
        Fp2 X, rhs, t, b, Y;
        fp2_load(X, x + o);
        fp2_sqr(t, X);
        fp2_mul(t, t, X);
        fp2_set_const(b, LH_B_G2);
        fp2_add(rhs, t, b);
        bool good = fp2_sqrt(Y, rhs);
        if (fp2_lex_larger(Y) != (flags[i] != 0)) fp2_neg(Y, Y);
        fp2_store(y + o, Y);
        ok[i] = good ? 1 : 0;
    } else {
        Jac<Fp2> Q, PQ, UQ;
        jac_load(Q, x, y, z, i);
        g2_psi(PQ, Q);
        jac_scalar_mul_const(UQ, Q, 0ull, LH_X_ABS);
        fp2_neg(UQ.y, UQ.y);
        ok[i] = g2_eq_jac(PQ, UQ) ? 1 : 0;
    }
}

__global__ void g2_intake_kernel(int mode, const int32_t* __restrict__ x,
                                 const int32_t* __restrict__ flags,
                                 int32_t* __restrict__ y,
                                 const int32_t* __restrict__ z,
                                 int32_t* __restrict__ ok, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) g2_intake_lane(mode, x, flags, y, z, ok, i);
}

extern "C" int lh_g2_intake(int mode, const void* x, const void* flags,
                            void* y, const void* z, void* ok, long long n,
                            void* stream) {
    const int threads = 64;
    const long long blocks = (n + threads - 1) / threads;
    g2_intake_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
        mode, (const int32_t*)x, (const int32_t*)flags, (int32_t*)y,
        (const int32_t*)z, (int32_t*)ok, n);
    return (int)cudaGetLastError();
}
