// hash_to_g2: the device half of hash-to-G2 (RFC 9380, BLS12381G2
// XMD:SHA-256 SSWU RO): map u0 and u1 by the simplified SWU onto the
// isogenous curve and the 3-isogeny (Jacobian, z = 0 on the exceptional
// inputs), add the two points, clear the cofactor by Budroni-Pintore
// ([u^2-u-1]Q + [u-1]psi(Q) + psi^2([2]Q)). Jacobian output; the formulas
// and their order are the JAX ones, so the coordinates agree with the
// plain version's. Two designs of one function, picked by the batch:
//
// - up to LH_H2G_COOP_MAX messages (the 10k batch's 128 message lanes),
//   one message a block of two warps on the cooperative layer (coop.cuh,
//   warp level): warp w maps u_w; warp 0 adds the two points; warp 0 takes
//   [k1]Q while warp 1 takes psi(-[k2]Q) and psi^2([2]Q); warp 0 adds the
//   three. Bound: latency. A message is one chain and the batch fills
//   128 of the 132 SMs with a block each, so the time is the chain's depth
//   in dependent field multiplies (bls_cost.hash_to_g2_depth: 1,369) times
//   a warp step (a multiply's latency, the lanes' additions and two warp
//   barriers), plus each map's binary inversion and Legendre symbol
//   (fp.cuh). The design cuts the depth from 14,779 serial multiplies: the
//   independent Fp2 products of a formula run at once on a warp's lanes
//   (an Fp2 product on three), the square roots' powers take a set bit's
//   product beside the square, u0 and u1 map at once, the cofactor's terms
//   run on the two warps, and the inversion and Legendre symbol are
//   binary, a few hundred word steps each instead of ~600 multiplies;
// - past it (the sharded path's 10,240 message lanes), one message a
//   thread with the sequential tower (fp.cuh, curve.cuh): thousands of
//   chains fill the card, and a warp's lanes all multiply at once, where
//   the cooperative kernel keeps most lanes idle. Bound: integer
//   multiply-adds, ~6 381-bit exponentiations and a 128- and a 64-bit
//   scalar multiply a message.
//
// Replaces lighthouse_tpu/ops/bls12_381.py:1068 map_to_g2_batch (:961
// sswu_map_g2, :990 iso_map_g2), :1075 _g2_add_halves and :1034-1065
// clear_cofactor_g2 (_cc_mul_k1, _cc_mul_k2_psi, _cc_dbl_psi2, _g2_add3).
#include "coop.cuh"

#define LH_H2G_THREADS 64      // two warps a message (cooperative)
#ifndef LH_H2G_COOP_MAX
#define LH_H2G_COOP_MAX 1024   // wider batches take a thread a message
#endif

// ------------------------------------------------- a thread a message

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

// ------------------------------------------- a message a block of two warps


// x^3 + A x + B for x1 and x2 = zu2 x1 (three steps), with gx1's norm
// (gx1.c0^2 + gx1.c1^2) in the third
LH_DEV void w_h2c_g2(Fp* sc, Fp2& gx1, Fp2& gx2, Fp2& x2, Fp& norm1,
                     const Fp2& x1, const Fp2& zu2) {
    Fp2 A, B;
    fp2_set_const(A, LH_H2C_A);
    fp2_set_const(B, LH_H2C_B);
    Fp2 R[3];
    {
        const Fp2 a[3] = {x1, zu2, A}, b[3] = {x1, x1, x1};
        w_step<3>(sc, R, a, b, W_KINDS3(W_SQR, W_MUL, W_MUL));
    }
    const Fp2 x1s = R[0], ax1 = R[2];
    x2 = R[1];
    {
        const Fp2 a[3] = {x1s, x2, A}, b[3] = {x1, x2, x2};
        w_step<3>(sc, R, a, b, W_KINDS3(W_MUL, W_SQR, W_MUL));
    }
    fp2_add(gx1, R[0], ax1);
    fp2_add(gx1, gx1, B);
    const Fp2 x2s = R[1], ax2 = R[2];
    {
        Fp2 S[2];
        const Fp2 a[2] = {x2s, gx1}, b[2] = {x2, gx1};
        w_step<2>(sc, S, a, b, W_KINDS2(W_MUL, W_CMP));
        fp2_add(gx2, S[0], ax2);
        fp2_add(gx2, gx2, B);
        fp_add(norm1, S[1].c0, S[1].c1);
    }
}

// sqrt for p = 3 mod 4 (Adj-Rodriguez), as fp2_sqrt (fp.cuh); the check
// y^2 == a is left out (the map never reads it)
LH_DEV void w_fp2_sqrt(Fp* sc, Fp2& y, const Fp2& a) {
    Fp2 a1, x0, alpha, b, bp, other, ix0, m1, one;
    w_fp2_pow(sc, a1, a, LH_EXP_SQRT);
    w_mul(sc, x0, a1, a);
    w_mul(sc, alpha, a1, x0);
    fp2_one(one);
    fp2_neg(m1, one);
    const bool is_neg1 = fp2_eq(alpha, m1);
    fp_neg(ix0.c0, x0.c1);
    ix0.c1 = x0.c0;
    fp2_add(b, alpha, one);
    w_fp2_pow(sc, bp, b, LH_EXP_LEGENDRE);
    w_mul(sc, other, bp, x0);
    y = is_neg1 ? ix0 : other;
    if (fp2_is_zero(a)) fp2_zero(y);
}

// RFC 9380 sgn0 of the integer values c (canonical words)
LH_DEV int sgn0_ints(const Fp2& c) {
    Fp c0, c1;
    fp_canon(c0, c.c0);
    fp_canon(c1, c.c1);
    return words_is_zero(c0.w) ? (int)(c1.w[0] & 1) : (int)(c0.w[0] & 1);
}

LH_DEV void w_sswu(Fp* sc, Fp2& x, Fp2& y, const Fp2& u) {
    Fp2 Z, t, zu2, tv1, inv, one, x1, x2, gx1, gx2, c;
    fp2_set_const(Z, LH_H2C_Z);
    w_one(sc, t, u, u, W_SQR);
    w_mul(sc, zu2, Z, t);
    w_one(sc, t, zu2, zu2, W_SQR);
    fp2_add(tv1, t, zu2);
    const bool tv1_zero = fp2_is_zero(tv1);
    w_fp2_inv(sc, inv, tv1);
    fp2_one(one);
    fp2_add(t, one, inv);
    fp2_set_const(c, LH_H2C_NBA);
    w_mul(sc, x1, c, t);
    if (tv1_zero) fp2_set_const(x1, LH_H2C_X1EXC);
    Fp norm1;
    w_h2c_g2(sc, gx1, gx2, x2, norm1, x1, zu2);
    const bool e1 = fp_legendre_binary(norm1) != -1;
    x = e1 ? x1 : x2;
    // a copy: the conditional lvalue passed by reference into the root
    // gave a wrong root on the card (sm_90a), right on the host
    const Fp2 gx = e1 ? gx1 : gx2;
    w_fp2_sqrt(sc, y, gx);
    // sgn0(u) and sgn0(y): the four integer values (a product by 1) at once
    Fp2 ones, R[2];
    fp_zero(ones.c0);
    ones.c0.w[0] = 1;
    ones.c1 = ones.c0;
    const Fp2 a[2] = {u, y}, b[2] = {ones, ones};
    w_step<2>(sc, R, a, b, W_KINDS2(W_CMP, W_CMP));
    if (sgn0_ints(R[0]) != sgn0_ints(R[1])) fp2_neg(y, y);
}

LH_DEV void w_iso_map(Fp* sc, Jac<Fp2>& r, const Fp2& x, const Fp2& y) {
    // the four Horner chains side by side: xn, yn non-monic (from the top
    // coefficient, 3 steps), xd, yd monic (from one, 2 and 3 steps)
    Fp2 xn, xd, yn, yd, c;
    fp2_set_const(xn, LH_ISO_XN[3]);
    fp2_one(xd);
    fp2_set_const(yn, LH_ISO_YN[3]);
    fp2_one(yd);
    for (int s = 0; s < 2; ++s) {
        Fp2 R[4];
        const Fp2 a[4] = {xn, xd, yn, yd}, b[4] = {x, x, x, x};
        w_step<4>(sc, R, a, b, 0);
        fp2_set_const(c, LH_ISO_XN[2 - s]); fp2_add(xn, R[0], c);
        fp2_set_const(c, LH_ISO_XD[1 - s]); fp2_add(xd, R[1], c);
        fp2_set_const(c, LH_ISO_YN[2 - s]); fp2_add(yn, R[2], c);
        fp2_set_const(c, LH_ISO_YD[2 - s]); fp2_add(yd, R[3], c);
    }
    {
        Fp2 R[3];
        const Fp2 a[3] = {xn, yn, yd}, b[3] = {x, x, x};
        w_step<3>(sc, R, a, b, 0);
        fp2_set_const(c, LH_ISO_XN[0]); fp2_add(xn, R[0], c);
        fp2_set_const(c, LH_ISO_YN[0]); fp2_add(yn, R[1], c);
        fp2_set_const(c, LH_ISO_YD[0]); fp2_add(yd, R[2], c);
    }
    const bool bad = fp2_is_zero(xd) || fp2_is_zero(yd);
    Fp2 z, yd2, t, xd2, tyn, s;
    {
        Fp2 R[5];
        const Fp2 a[5] = {xd, yd, xn, xd, y}, b[5] = {yd, yd, xd, xd, yn};
        w_step<5>(sc, R, a, b, W_KINDS5(W_MUL, W_SQR, W_MUL, W_SQR, W_MUL));
        z = R[0]; yd2 = R[1]; t = R[2]; xd2 = R[3]; tyn = R[4];
    }
    {
        Fp2 R[2];
        const Fp2 a[2] = {t, xd2}, b[2] = {yd2, xd};
        w_step<2>(sc, R, a, b, 0);
        r.x = R[0];
        s = R[1];
    }
    w_mul(sc, t, tyn, s);
    w_mul(sc, r.y, t, yd2);
    r.z = z;
    if (bad) fp2_zero(r.z);
}

// curve.cuh jac_dbl on the warp: 7 products in 3 steps
LH_NOINL void w_jac_dbl(Fp* sc, Jac<Fp2>& r, const Jac<Fp2>& p) {
    Fp2 A, B, yz, E, C, t, Fv, D, X3, EDX, s;
    {
        Fp2 R[3];
        const Fp2 a[3] = {p.x, p.y, p.y}, b[3] = {p.x, p.y, p.z};
        w_step<3>(sc, R, a, b, 0);
        A = R[0]; B = R[1]; yz = R[2];
    }
    f_muln(E, A, 3);
    fp2_add(s, p.x, B);
    {
        Fp2 R[3];
        const Fp2 a[3] = {B, s, E}, b[3] = {B, s, E};
        w_step<3>(sc, R, a, b, 0);
        C = R[0]; t = R[1]; Fv = R[2];
    }
    fp2_sub(s, t, A);
    fp2_sub(s, s, C);
    f_muln(D, s, 2);
    f_muln(s, D, 2);
    fp2_sub(X3, Fv, s);
    fp2_sub(s, D, X3);
    w_mul(sc, EDX, E, s);
    f_muln(s, C, 8);
    fp2_sub(r.y, EDX, s);
    f_muln(r.z, yz, 2);
    r.x = X3;
}

// curve.cuh jac_add on the warp: 16 products in 5 steps, the same
// infinity and doubling branches
LH_NOINL void w_jac_add(Fp* sc, Jac<Fp2>& r, const Jac<Fp2>& p,
                        const Jac<Fp2>& q) {
    const bool inf1 = fp2_is_zero(p.z), inf2 = fp2_is_zero(q.z);
    Fp2 Z1Z1, Z2Z2, zz, U1, U2, z2c, z1c, H, H2, S1, S2, I, rr, J, V, rr2;
    Fp2 X3, Y3, Z3, rVX, S1J, s, d;
    fp2_add(s, p.z, q.z);
    {
        Fp2 R[3];
        const Fp2 a[3] = {p.z, q.z, s}, b[3] = {p.z, q.z, s};
        w_step<3>(sc, R, a, b, 0);
        Z1Z1 = R[0]; Z2Z2 = R[1]; zz = R[2];
    }
    {
        Fp2 R[4];
        const Fp2 a[4] = {p.x, q.x, q.z, p.z}, b[4] = {Z2Z2, Z1Z1, Z2Z2, Z1Z1};
        w_step<4>(sc, R, a, b, 0);
        U1 = R[0]; U2 = R[1]; z2c = R[2]; z1c = R[3];
    }
    fp2_sub(H, U2, U1);
    f_muln(H2, H, 2);
    {
        Fp2 R[3];
        const Fp2 a[3] = {p.y, q.y, H2}, b[3] = {z2c, z1c, H2};
        w_step<3>(sc, R, a, b, 0);
        S1 = R[0]; S2 = R[1]; I = R[2];
    }
    const bool same_x = fp2_is_zero(H);
    fp2_sub(d, S2, S1);
    const bool same_y = fp2_is_zero(d);
    f_muln(rr, d, 2);
    {
        Fp2 R[3];
        const Fp2 a[3] = {H, U1, rr}, b[3] = {I, I, rr};
        w_step<3>(sc, R, a, b, 0);
        J = R[0]; V = R[1]; rr2 = R[2];
    }
    fp2_sub(X3, rr2, J);
    f_muln(s, V, 2);
    fp2_sub(X3, X3, s);
    fp2_sub(s, V, X3);
    fp2_sub(d, zz, Z1Z1);
    fp2_sub(d, d, Z2Z2);
    {
        Fp2 R[3];
        const Fp2 a[3] = {rr, S1, d}, b[3] = {s, J, H};
        w_step<3>(sc, R, a, b, 0);
        rVX = R[0]; S1J = R[1]; Z3 = R[2];
    }
    f_muln(s, S1J, 2);
    fp2_sub(Y3, rVX, s);
    Jac<Fp2> out;
    out.x = X3;
    out.y = Y3;
    out.z = Z3;
    if (same_x && same_y && !inf1 && !inf2) w_jac_dbl(sc, out, p);
    if (same_x && !same_y && !inf1 && !inf2) fp2_zero(out.z);
    if (inf1) out = q;
    if (inf2 && !inf1) out = p;
    r = out;
}

// jac_scalar_mul_const on the warp: from (x, y, 0), every bit of k from
// its top one down
LH_DEV void w_scalar_mul_const(Fp* sc, Jac<Fp2>& r, const Jac<Fp2>& p,
                               unsigned long long hi,
                               unsigned long long lo) {
    int top = 127;
    while (top > 0 && !(((top >= 64 ? hi >> (top - 64) : lo >> top)) & 1))
        --top;
    Jac<Fp2> acc = p;
    fp2_zero(acc.z);
    for (int i = top; i >= 0; --i) {
        w_jac_dbl(sc, acc, acc);
        if ((i >= 64 ? hi >> (i - 64) : lo >> i) & 1)
            w_jac_add(sc, acc, acc, p);
    }
    r = acc;
}

// psi: (cx conj(X), cy conj(Y), conj(Z)), both products in one step
LH_DEV void w_psi(Fp* sc, Jac<Fp2>& r, const Jac<Fp2>& p) {
    Fp2 cx, cy, R[2], a[2];
    fp2_set_const(cx, LH_H2C_PSI_CX);
    fp2_set_const(cy, LH_H2C_PSI_CY);
    fp2_conj(a[0], p.x);
    fp2_conj(a[1], p.y);
    const Fp2 b[2] = {cx, cy};
    w_step<2>(sc, R, a, b, 0);
    r.x = R[0];
    r.y = R[1];
    fp2_conj(r.z, p.z);
}

__global__ void __launch_bounds__(LH_H2G_THREADS)
hash_to_g2_coop_kernel(const int32_t* __restrict__ u0,
                  const int32_t* __restrict__ u1, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz) {
    extern __shared__ uint4 lh_smem[];
    Jac<Fp2>* xch = reinterpret_cast<Jac<Fp2>*>(lh_smem);    // 3 points
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    Fp* sc = reinterpret_cast<Fp*>(xch + 3) + 32 * warp;
    const long long i = blockIdx.x;
    Fp2 u, x, y;
    Jac<Fp2> q, s, t;
    fp2_load(u, (warp ? u1 : u0) + i * 2 * LH_LIMBS);
    w_sswu(sc, x, y, u);
    w_iso_map(sc, q, x, y);
    if (warp == 1 && lane == 0) xch[0] = q;
    __syncthreads();
    if (warp == 0) {
        const Jac<Fp2> q1 = xch[0];
        w_jac_add(sc, s, q, q1);
        if (lane == 0) xch[1] = s;
    }
    __syncthreads();
    s = xch[1];
    if (warp == 0) {
        w_scalar_mul_const(sc, t, s, LH_BP_K1_HI, LH_BP_K1_LO);
    } else {
        w_scalar_mul_const(sc, q, s, 0ull, LH_BP_K2);
        fp2_neg(q.y, q.y);
        w_psi(sc, q, q);
        w_jac_dbl(sc, t, s);
        w_psi(sc, t, t);
        w_psi(sc, t, t);
        if (lane == 0) {
            xch[0] = q;
            xch[2] = t;
        }
    }
    __syncthreads();
    if (warp == 0) {
        const Jac<Fp2> t2 = xch[0], t3 = xch[2];
        w_jac_add(sc, q, t, t2);
        w_jac_add(sc, s, q, t3);
        if (lane == 0) jac_store(ox, oy, oz, i, s);
    }
}

extern "C" int lh_hash_to_g2(const void* u0, const void* u1, void* ox,
                             void* oy, void* oz, long long n,
                             void* stream) {
    if (n > LH_H2G_COOP_MAX) {
        const int threads = 32;
        const long long blocks = (n + threads - 1) / threads;
        hash_to_g2_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
            (const int32_t*)u0, (const int32_t*)u1, (int32_t*)ox,
            (int32_t*)oy, (int32_t*)oz, n);
        return (int)cudaGetLastError();
    }
    const int smem = 3 * (int)sizeof(Jac<Fp2>)
                     + 2 * 32 * (int)sizeof(Fp);
    hash_to_g2_coop_kernel<<<(unsigned)n, LH_H2G_THREADS, smem,
                             (cudaStream_t)stream>>>(
        (const int32_t*)u0, (const int32_t*)u1, (int32_t*)ox, (int32_t*)oy,
        (int32_t*)oz);
    return (int)cudaGetLastError();
}
