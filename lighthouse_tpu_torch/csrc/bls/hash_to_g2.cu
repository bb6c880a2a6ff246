// hash_to_g2: the device half of hash-to-G2 (RFC 9380, BLS12381G2
// XMD:SHA-256 SSWU RO), one message per thread: map u0 and u1 by the
// simplified SWU onto the isogenous curve and the 3-isogeny (Jacobian,
// z = 0 on the exceptional inputs), add the two points, clear the
// cofactor by Budroni-Pintore ([u^2-u-1]Q + [u-1]psi(Q) + psi^2([2]Q)).
// Jacobian output; the formulas are the JAX ones, so the coordinates
// agree with the plain version's.
//
// Replaces lighthouse_tpu/ops/bls12_381.py:1068 map_to_g2_batch (:961
// sswu_map_g2, :990 iso_map_g2), :1075 _g2_add_halves and :1034-1065
// clear_cofactor_g2 (_cc_mul_k1, _cc_mul_k2_psi, _cc_dbl_psi2, _g2_add3).
// Bound: integer multiply-adds; a lane is a serial chain of ~six 381-bit
// exponentiations and a 128-bit and a 64-bit scalar multiply, and the
// flagship batch has only 128 message lanes, so the kernel is latency
// bound (one block of threads, one SM busy).
#include "curve.cuh"

LH_DEV void h2c_g(Fp2& r, const Fp2& x) {
    Fp2 x3, t, c;
    fp2_sqr(x3, x);
    fp2_mul(x3, x3, x);
    fp2_set_const(c, LH_H2C_A);
    fp2_mul(t, c, x);
    fp2_add(x3, x3, t);
    fp2_set_const(c, LH_H2C_B);
    fp2_add(r, x3, c);
}

LH_NOINL void sswu_map(Fp2& x, Fp2& y, const Fp2& u) {
    Fp2 Z, zu2, tv1, inv, one, x1, x2, gx1, gx2, gx, t, c;
    fp2_set_const(Z, LH_H2C_Z);
    fp2_sqr(t, u);
    fp2_mul(zu2, Z, t);
    fp2_sqr(t, zu2);
    fp2_add(tv1, t, zu2);
    const bool tv1_zero = fp2_is_zero(tv1);
    fp2_inv(inv, tv1);
    fp2_one(one);
    fp2_add(t, one, inv);
    fp2_set_const(c, LH_H2C_NBA);
    fp2_mul(x1, c, t);
    if (tv1_zero) fp2_set_const(x1, LH_H2C_X1EXC);
    h2c_g(gx1, x1);
    const bool e1 = fp2_is_square(gx1);
    fp2_mul(x2, zu2, x1);
    h2c_g(gx2, x2);
    x = e1 ? x1 : x2;
    gx = e1 ? gx1 : gx2;
    fp2_sqrt(y, gx);
    if (fp2_sgn0(u) != fp2_sgn0(y)) fp2_neg(y, y);
}

// Horner over the isogeny coefficients: non-monic starts from the top
// coefficient, monic from one
LH_DEV void iso_horner(Fp2& acc, const uint32_t (*cs)[2][LH_W], int len,
                       bool monic, const Fp2& x) {
    Fp2 c;
    int i;
    if (monic) {
        fp2_one(acc);
        i = len - 1;
    } else {
        fp2_set_const(acc, cs[len - 1]);
        i = len - 2;
    }
    for (; i >= 0; --i) {
        fp2_mul(acc, acc, x);
        fp2_set_const(c, cs[i]);
        fp2_add(acc, acc, c);
    }
}

LH_NOINL void iso_map(Jac<Fp2>& r, const Fp2& x, const Fp2& y) {
    Fp2 xn, xd, yn, yd, z, yd2, xd2, t, s;
    iso_horner(xn, LH_ISO_XN, 4, false, x);
    iso_horner(xd, LH_ISO_XD, 2, true, x);
    iso_horner(yn, LH_ISO_YN, 4, false, x);
    iso_horner(yd, LH_ISO_YD, 3, true, x);
    const bool bad = fp2_is_zero(xd) || fp2_is_zero(yd);
    fp2_mul(z, xd, yd);
    fp2_sqr(yd2, yd);
    fp2_mul(t, xn, xd);
    fp2_mul(r.x, t, yd2);
    fp2_sqr(xd2, xd);
    fp2_mul(t, y, yn);
    fp2_mul(s, xd2, xd);
    fp2_mul(t, t, s);
    fp2_mul(r.y, t, yd2);
    r.z = z;
    if (bad) fp2_zero(r.z);
}

// Inlined into the lane on purpose: built out of line (__noinline__),
// this function returned a wrong point on the card (sm_90a, CUDA 12.8)
// while the same steps inlined were right;
// tests/test_torch_cuda.py::test_hash_to_g2_kernel holds it.
LH_DEV void clear_cofactor(Jac<Fp2>& r, const Jac<Fp2>& p) {
    Jac<Fp2> t1, t2, t3, u;
    jac_scalar_mul_const(t1, p, LH_BP_K1_HI, LH_BP_K1_LO);
    jac_scalar_mul_const(u, p, 0ull, LH_BP_K2);
    fp2_neg(u.y, u.y);
    g2_psi(t2, u);
    jac_dbl(u, p);
    g2_psi(u, u);
    g2_psi(t3, u);
    jac_add(u, t1, t2);
    jac_add(r, u, t3);
}

LH_DEV void hash_to_g2_lane(const int32_t* u0, const int32_t* u1,
                           int32_t* ox, int32_t* oy, int32_t* oz,
                           long long i) {
    const long long o = i * 2 * LH_LIMBS;
    Fp2 u, x, y;
    Jac<Fp2> q0, q1, s, out;
    fp2_load(u, u0 + o);
    sswu_map(x, y, u);
    iso_map(q0, x, y);
    fp2_load(u, u1 + o);
    sswu_map(x, y, u);
    iso_map(q1, x, y);
    jac_add(s, q0, q1);
    clear_cofactor(out, s);
    jac_store(ox, oy, oz, i, out);
}

__global__ void hash_to_g2_kernel(const int32_t* __restrict__ u0,
                                  const int32_t* __restrict__ u1,
                                  int32_t* __restrict__ ox,
                                  int32_t* __restrict__ oy,
                                  int32_t* __restrict__ oz, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) hash_to_g2_lane(u0, u1, ox, oy, oz, i);
}

extern "C" int lh_hash_to_g2(const void* u0, const void* u1, void* ox,
                             void* oy, void* oz, long long n,
                             void* stream) {
    const int threads = 32;
    const long long blocks = (n + threads - 1) / threads;
    hash_to_g2_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t*)u0, (const int32_t*)u1, (int32_t*)ox, (int32_t*)oy,
        (int32_t*)oz, n);
    return (int)cudaGetLastError();
}
