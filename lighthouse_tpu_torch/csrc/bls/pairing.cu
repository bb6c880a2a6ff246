// pairing: the optimal-ate pairing check of a batch.
//   lh_miller_loop: one thread per (P, Q) pair: the Miller loop over the
//       bits of |x| with the JAX projective doubling and mixed addition
//       steps and their line coefficients, each line multiplied into f in
//       the sparse fp12_mul_by_014 shape; f conjugated at the end (x < 0);
//       lanes whose mask is 0 write the identity.
//   lh_final_exp: one block reduces the n Miller outputs to their product
//       (64 threads each multiply a strided share, then one thread the 64
//       partials); mode 1 then runs the final exponentiation in that one
//       thread: the easy part f^((p^6-1)(p^2+1)), the 16-entry Frobenius
//       subset table and the 381-step hard-part scan, and writes whether
//       the result is one. Mode 0 stops at the product.
//
// Replaces lighthouse_tpu/ops/bls12_381.py:673 miller_loop_batch (:630
// _miller_dbl_step, :649 _miller_add_step, :665 _ell), :834 _mask_to_one,
// :711 _fp12_prod_rows / :723 fp12_product, :805 final_exponentiation and
// :842 pairing_check_batch. Bound: integer multiply-adds; the final
// exponentiation is one serial chain (~1,100 Fp12 products) in one
// thread, latency bound by design.
#include "curve.cuh"

LH_NOINL void miller_dbl_step(Jac<Fp2>& t, Fp2& i, Fp2& j3, Fp2& nh) {
    Fp2 half, b3, b, c, j, u, txty, h, a, e, f, g, nx, ny, nz, gg, ee, s;
    fp_set_const(half.c0, LH_TWO_INV);
    fp_zero(half.c1);
    fp2_set_const(b3, LH_B_TWIST_3);
    fp2_mul(b, t.y, t.y);
    fp2_mul(c, t.z, t.z);
    fp2_mul(j, t.x, t.x);
    fp2_add(s, t.y, t.z);
    fp2_mul(u, s, s);
    fp2_mul(txty, t.x, t.y);
    fp2_add(s, b, c);
    fp2_sub(h, u, s);
    fp2_mul(a, txty, half);
    fp2_mul(e, c, b3);
    f_muln(f, e, 3);
    fp2_sub(i, e, b);
    fp2_add(s, b, f);
    fp2_mul(g, s, half);
    fp2_sub(s, b, f);
    fp2_mul(nx, a, s);
    fp2_mul(nz, b, h);
    fp2_mul(gg, g, g);
    fp2_mul(ee, e, e);
    f_muln(s, ee, 3);
    fp2_sub(ny, gg, s);
    f_muln(j3, j, 3);
    fp2_neg(nh, h);
    t.x = nx;
    t.y = ny;
    t.z = nz;
}

LH_NOINL void miller_add_step(Jac<Fp2>& t, const Fp2& qx, const Fp2& qy,
                              Fp2& j, Fp2& ntheta, Fp2& lam) {
    Fp2 qyz, qxz, theta, c, d, tqx, lqy, e, f, g, h, nx, tgh, ety, nz, s;
    fp2_mul(qyz, qy, t.z);
    fp2_mul(qxz, qx, t.z);
    fp2_sub(theta, t.y, qyz);
    fp2_sub(lam, t.x, qxz);
    fp2_mul(c, theta, theta);
    fp2_mul(d, lam, lam);
    fp2_mul(tqx, theta, qx);
    fp2_mul(lqy, lam, qy);
    fp2_mul(e, lam, d);
    fp2_mul(f, t.z, c);
    fp2_mul(g, t.x, d);
    fp2_add(s, e, f);
    f_muln(h, g, 2);
    fp2_sub(h, s, h);
    fp2_mul(nx, lam, h);
    fp2_sub(s, g, h);
    fp2_mul(tgh, theta, s);
    fp2_mul(ety, e, t.y);
    fp2_mul(nz, t.z, e);
    fp2_sub(t.y, tgh, ety);
    t.x = nx;
    t.z = nz;
    fp2_sub(j, tqx, lqy);
    fp2_neg(ntheta, theta);
}

// f *= line (c0, c1, c2) evaluated at P: c2 scaled by py, c1 by px
LH_DEV void ell(Fp12& f, const Fp2& c0, const Fp2& c1, const Fp2& c2,
                const Fp& px, const Fp& py) {
    Fp2 l1, l4;
    fp2_mul_fp(l4, c2, py);
    fp2_mul_fp(l1, c1, px);
    fp12_mul_by_014(f, f, c0, l1, l4);
}

LH_DEV void miller_loop_lane(const int32_t* px, const int32_t* py,
                             const int32_t* qx, const int32_t* qy,
                             const int32_t* mask, int32_t* out,
                             long long i) {
    Fp12 f;
    fp12_one(f);
    if (mask[i]) {
        Fp PX, PY;
        Fp2 QX, QY, c0, c1, c2;
        Jac<Fp2> T;
        fp_load(PX, px + i * LH_LIMBS);
        fp_load(PY, py + i * LH_LIMBS);
        fp2_load(QX, qx + i * 2 * LH_LIMBS);
        fp2_load(QY, qy + i * 2 * LH_LIMBS);
        T.x = QX;
        T.y = QY;
        fp2_one(T.z);
        for (int b = 62; b >= 0; --b) {
            fp12_sqr(f, f);
            miller_dbl_step(T, c0, c1, c2);
            ell(f, c0, c1, c2, PX, PY);
            if ((LH_X_ABS >> b) & 1) {
                miller_add_step(T, QX, QY, c0, c1, c2);
                ell(f, c0, c1, c2, PX, PY);
            }
        }
        fp12_conj(f, f);
    }
    fp12_store(out + i * 12 * LH_LIMBS, f);
}

#define LH_PROD_THREADS 64

LH_NOINL void final_exponentiation(Fp12& out, const Fp12& f_in) {
    Fp12 f, t, table[16];
    fp12_conj(f, f_in);
    fp12_inv(t, f_in);
    fp12_mul(f, f, t);                       // f^(p^6 - 1)
    fp12_frobenius(t, f, 2);
    fp12_mul(f, t, f);                       // ^(p^2 + 1)
    // table[m] = prod_{i in m} frob_i(f)
    fp12_one(table[0]);
    table[1] = f;
    fp12_frobenius(table[2], f, 1);
    fp12_frobenius(table[4], f, 2);
    fp12_frobenius(table[8], f, 3);
    for (int m = 3; m < 16; ++m) {
        if ((m & (m - 1)) == 0) continue;    // the powers of two are set
        const int low = m & (-m);
        fp12_mul(table[m], table[m - low], table[low]);
    }
    fp12_one(out);
    for (int s = 0; s < LH_HARD_NBITS; ++s) {
        fp12_sqr(out, out);
        fp12_mul(out, out, table[LH_HARD_IDX[s]]);
    }
}

// thread t's share of the product: fs[t], fs[t + threads], ...
LH_DEV void fp12_product_share(Fp12& acc, const int32_t* fs, long long n,
                               int t, int threads) {
    Fp12 v;
    fp12_one(acc);
    for (long long i = t; i < n; i += threads) {
        fp12_load(v, fs + i * 12 * LH_LIMBS);
        fp12_mul(acc, acc, v);
    }
}

// product of the partials, then (mode 1) the final exponentiation; writes
// the value and whether it is one
LH_DEV void final_exp_finish(int mode, const Fp12* part, int parts,
                             int32_t* out, int32_t* flag) {
    Fp12 acc = part[0], v;
    for (int k = 1; k < parts; ++k) fp12_mul(acc, acc, part[k]);
    if (mode == 1) {
        final_exponentiation(v, acc);
        acc = v;
    }
    fp12_store(out, acc);
    flag[0] = fp12_is_one(acc) ? 1 : 0;
}

__global__ void miller_loop_kernel(const int32_t* __restrict__ px,
                                   const int32_t* __restrict__ py,
                                   const int32_t* __restrict__ qx,
                                   const int32_t* __restrict__ qy,
                                   const int32_t* __restrict__ mask,
                                   int32_t* __restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) miller_loop_lane(px, py, qx, qy, mask, out, i);
}

__global__ void final_exp_kernel(int mode, const int32_t* __restrict__ fs,
                                 long long n, int32_t* __restrict__ out,
                                 int32_t* __restrict__ flag) {
    __shared__ Fp12 part[LH_PROD_THREADS];
    const int t = threadIdx.x;
    Fp12 acc;
    fp12_product_share(acc, fs, n, t, LH_PROD_THREADS);
    part[t] = acc;
    __syncthreads();
    if (t == 0) final_exp_finish(mode, part, LH_PROD_THREADS, out, flag);
}

extern "C" int lh_miller_loop(const void* px, const void* py,
                              const void* qx, const void* qy,
                              const void* mask, void* out, long long n,
                              void* stream) {
    const int threads = 32;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    miller_loop_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)px, (const int32_t*)py, (const int32_t*)qx,
        (const int32_t*)qy, (const int32_t*)mask, (int32_t*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int lh_final_exp(int mode, const void* fs, long long n,
                            void* out, void* flag, void* stream) {
    final_exp_kernel<<<1, LH_PROD_THREADS, 0, (cudaStream_t)stream>>>(
        mode, (const int32_t*)fs, n, (int32_t*)out, (int32_t*)flag);
    return (int)cudaGetLastError();
}
