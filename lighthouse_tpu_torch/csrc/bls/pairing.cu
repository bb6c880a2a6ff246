// pairing: the optimal-ate pairing check of a batch.
//   lh_miller_loop: the Miller loop over the bits of |x| with the JAX
//       projective doubling and mixed addition steps and their line
//       coefficients, each line multiplied into f in the sparse
//       fp12_mul_by_014 shape; f conjugated at the end (x < 0); lanes
//       whose mask is 0 write the identity. Two designs of one function,
//       picked by n alone:
//     - up to LH_ML_COOP_MAX pairs (the 10k batch's 129), one block of
//       128 threads a pair on the cooperative layer (coop.cuh, block
//       level): each of T's four layers of independent Fp2 products is
//       one step, the line's scalings by px, py ride in the second (the
//       line is known after it), f times the line in the third, and f^2
//       for the next bit in the fourth, so a doubling bit is 4 steps and
//       an addition 4 more (271 in all, bls_cost.miller_loop_depth); the
//       additions between the layers are a short pass of two threads.
//       The formulas of T are the one-thread kernel's, so f is the same
//       field value, lane for lane;
//     - past it, one thread a pair with the sequential tower: thousands
//       of chains fill the card, where a block a pair would run many
//       waves. The crossover is measured (compare_kernels): a block a
//       pair is faster up to 2,561 pairs (16.7 ms against 18.3), 3.2x
//       slower at 10,241 (66.1 against 20.6). A batch past it whose
//       live pairs are within it (the verification's 10,241 lanes over
//       a few hundred messages) comes here as its live pairs alone
//       (ops/bls12_381.py miller_loop_batch), so n is the live count.
//   lh_final_exp: one block of 256 threads on the cooperative layer
//       (coop.cuh): the product of the n Miller outputs as a pairwise tree
//       over 256 shared-memory slots (ceil(log2 n) levels for n <= 256,
//       each level's products side by side, four Fp12 products = 216
//       field products a step; past 256 values thread t first folds
//       t, t + 256, ... into slot t with the sequential tower.cuh product,
//       the work-efficient way for a wide batch); mode 1 then the final
//       exponentiation:
//       the easy part f^((p^6-1)(p^2+1)) (the Fp12 inverse cooperative,
//       its one Fp inverse a binary extended Euclid), and the hard part
//       (p^4 - p^2 + 1)/r = ((x-1)^2/3)(x+p)(x^2+p^2-1) + 1 by the x-chain
//       with Granger-Scott squares (ops/bls12_381.py
//       _final_exponentiation_plain), five powers walked from the bottom
//       bit so a set bit's product shares the square's step; writes
//       whether the result is one. Mode 0 stops at the product.
//
// Replaces lighthouse_tpu/ops/bls12_381.py:673 miller_loop_batch (:630
// _miller_dbl_step, :649 _miller_add_step, :665 _ell), :834 _mask_to_one,
// :711 _fp12_prod_rows / :723 fp12_product, :805 final_exponentiation and
// :842 pairing_check_batch (the JAX hard part is a base-p scan over a
// Frobenius table; the x-chain gives the same value).
// Bound: the Miller loop integer multiply-adds; the cooperative design
// is latency bound, its time its 271 steps. The final exponentiation
// is latency bound by design: one chain, so its time is its depth in
// dependent field multiplies (bls_cost.final_exp_depth: 8 product levels
// + 331 at 129 values) times one cooperative step, a multiply's latency
// plus its pre- and post-additions and up to four block barriers. The
// design cuts the depth (54 products of an Fp12 product at once, squares
// at 18 products, products beside squares) from ~35,800 serial field
// multiplies on one thread.
#include "coop.cuh"

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

__global__ void miller_loop_kernel(const int32_t* __restrict__ px,
                                   const int32_t* __restrict__ py,
                                   const int32_t* __restrict__ qx,
                                   const int32_t* __restrict__ qy,
                                   const int32_t* __restrict__ mask,
                                   int32_t* __restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) miller_loop_lane(px, py, qx, qy, mask, out, i);
}

#define LH_ML_THREADS 128      // a pair's block (cooperative)
#ifndef LH_ML_COOP_MAX
#define LH_ML_COOP_MAX 2561    // wider batches take a thread a pair
#endif
// shared memory of the cooperative Miller loop, in Fp: f, the line, T, Q,
// P, the constants 1/2 and 3b', 16 Fp2 of temporaries, the step scratch
#define LH_ML_SH_W 39
#define LH_ML_SMEM ((LH_ML_SH_W + 32 + CO_SCRATCH) * (int)sizeof(Fp))

// T = 2T on the block (miller_dbl_step's layers) and f = f * line; then,
// when sq, f = f^2 for the next bit. l: the line (CO_MUL014's b); w: 16
// Fp2 of workspace
LH_DEV void co_miller_dbl(Fp* f, Fp* l, Fp* tx, Fp* ty, Fp* tz,
                          const Fp* px, const Fp* py, const Fp* half,
                          const Fp* b3, Fp* w, Fp* sc, bool last, bool sq) {
    Fp *s = w, *b = w + 2, *c = w + 4, *j = w + 6, *u = w + 8;
    Fp *txty = w + 10, *h = w + 12, *a = w + 14, *e = w + 16, *j3 = w + 18;
    Fp *nh = w + 20, *s1 = w + 22, *s2 = w + 24, *g = w + 26, *gg = w + 28;
    Fp *ee = w + 30;
    const int tid = threadIdx.x;
    if (tid < 2) fp_add(s[tid], ty[tid], tz[tid]);
    __syncthreads();
    const CoOp l1[5] = {co_op(CO_SQR2, b, ty), co_op(CO_SQR2, c, tz),
                        co_op(CO_SQR2, j, tx), co_op(CO_SQR2, u, s),
                        co_op(CO_MUL2, txty, tx, ty)};
    co_step(l1, 5, sc);
    if (tid < 2) {              // h = u - (b + c); the line's 3j and -h
        Fp t;
        fp_add(t, b[tid], c[tid]);
        fp_sub(h[tid], u[tid], t);
        fp_add(t, j[tid], j[tid]);
        fp_add(j3[tid], t, j[tid]);
        fp_neg(nh[tid], h[tid]);
    }
    __syncthreads();
    const CoOp l2[4] = {co_op(CO_MULF, a, txty, half),
                        co_op(CO_MUL2, e, c, b3),
                        co_op(CO_MULF, l + 2, j3, px),
                        co_op(CO_MULF, l + 8, nh, py)};
    co_step(l2, 4, sc);
    if (tid < 2) {              // the line's i = e - b; b + 3e, b - 3e
        Fp t, f3;
        fp_add(t, e[tid], e[tid]);
        fp_add(f3, t, e[tid]);
        fp_sub(l[tid], e[tid], b[tid]);
        fp_add(s1[tid], b[tid], f3);
        fp_sub(s2[tid], b[tid], f3);
    }
    __syncthreads();
    const CoOp l3[4] = {co_op(CO_MULF, g, s1, half),
                        co_op(CO_MUL2, tx, a, s2), co_op(CO_MUL2, tz, b, h),
                        co_op(CO_MUL014, f, f, l)};
    co_step(l3, 4, sc);
    if (last) return;           // the last bit's y is never read
    const CoOp l4[3] = {co_op(CO_SQR2, gg, g), co_op(CO_SQR2, ee, e),
                        co_op(CO_MUL12, f, f, f)};
    co_step(l4, sq ? 3 : 2, sc);
    if (tid < 2) {              // y = gg - 3 ee
        Fp t;
        fp_add(t, ee[tid], ee[tid]);
        fp_add(t, t, ee[tid]);
        fp_sub(ty[tid], gg[tid], t);
    }
    __syncthreads();
}

// T = T + Q on the block (miller_add_step's layers) and f = f * line;
// then, when sq, f = f^2 for the next bit
LH_DEV void co_miller_add(Fp* f, Fp* l, Fp* tx, Fp* ty, Fp* tz,
                          const Fp* qx, const Fp* qy, const Fp* px,
                          const Fp* py, Fp* w, Fp* sc, bool sq) {
    Fp *qyz = w, *qxz = w + 2, *th = w + 4, *lam = w + 6, *nth = w + 8;
    Fp *c = w + 10, *d = w + 12, *tqx = w + 14, *lqy = w + 16, *e = w + 18;
    Fp *ff = w + 20, *g = w + 22, *h = w + 24, *sg = w + 26, *tgh = w + 28;
    Fp *ety = w + 30;
    const int tid = threadIdx.x;
    const CoOp l1[2] = {co_op(CO_MUL2, qyz, qy, tz),
                        co_op(CO_MUL2, qxz, qx, tz)};
    co_step(l1, 2, sc);
    if (tid < 2) {              // theta, lambda; the line's -theta
        fp_sub(th[tid], ty[tid], qyz[tid]);
        fp_sub(lam[tid], tx[tid], qxz[tid]);
        fp_neg(nth[tid], th[tid]);
    }
    __syncthreads();
    const CoOp l2[6] = {co_op(CO_SQR2, c, th), co_op(CO_SQR2, d, lam),
                        co_op(CO_MUL2, tqx, th, qx),
                        co_op(CO_MUL2, lqy, lam, qy),
                        co_op(CO_MULF, l + 2, nth, px),
                        co_op(CO_MULF, l + 8, lam, py)};
    co_step(l2, 6, sc);
    if (tid < 2) fp_sub(l[tid], tqx[tid], lqy[tid]);     // the line's j
    __syncthreads();
    const CoOp l3[4] = {co_op(CO_MUL2, e, lam, d), co_op(CO_MUL2, ff, tz, c),
                        co_op(CO_MUL2, g, tx, d),
                        co_op(CO_MUL014, f, f, l)};
    co_step(l3, 4, sc);
    if (tid < 2) {              // h = e + f - 2g; g - h
        Fp t, g2;
        fp_add(t, e[tid], ff[tid]);
        fp_add(g2, g[tid], g[tid]);
        fp_sub(h[tid], t, g2);
        fp_sub(sg[tid], g[tid], h[tid]);
    }
    __syncthreads();
    const CoOp l4[5] = {co_op(CO_MUL2, tx, lam, h),
                        co_op(CO_MUL2, tgh, th, sg),
                        co_op(CO_MUL2, ety, e, ty),
                        co_op(CO_MUL2, tz, tz, e),
                        co_op(CO_MUL12, f, f, f)};
    co_step(l4, sq ? 5 : 4, sc);
    if (tid < 2) fp_sub(ty[tid], tgh[tid], ety[tid]);
    __syncthreads();
}

// pair blockIdx.x: f = conj(Miller(P, Q)), or one where its mask is 0
__global__ void __launch_bounds__(LH_ML_THREADS)
miller_loop_coop_kernel(const int32_t* __restrict__ px,
                        const int32_t* __restrict__ py,
                        const int32_t* __restrict__ qx,
                        const int32_t* __restrict__ qy,
                        const int32_t* __restrict__ mask,
                        int32_t* __restrict__ out) {
    extern __shared__ uint4 lh_smem[];
    Fp* sh = reinterpret_cast<Fp*>(lh_smem);
    Fp *f = sh, *l = sh + 12, *tx = sh + 24, *ty = sh + 26, *tz = sh + 28;
    Fp *QX = sh + 30, *QY = sh + 32, *PX = sh + 34, *PY = sh + 35;
    Fp *half = sh + 36, *b3 = sh + 37, *w = sh + LH_ML_SH_W;
    Fp* sc = w + 32;
    const long long i = blockIdx.x;
    const int tid = threadIdx.x;
    const bool live = mask[i] != 0;
    if (tid < 12) {             // f = 1
        Fp v;
        if (tid == 0) fp_one(v); else fp_zero(v);
        f[tid] = v;
    } else if (live && tid < 23) {  // P, Q; T = (Q, 1); 1/2 and 3b'
        const int e = tid & 1;
        Fp v;
        if (tid == 12) {
            fp_load(v, px + i * LH_LIMBS);
            PX[0] = v;
        } else if (tid == 13) {
            fp_load(v, py + i * LH_LIMBS);
            PY[0] = v;
        } else if (tid < 16) {
            fp_load(v, qx + (2 * i + e) * LH_LIMBS);
            QX[e] = v;
            tx[e] = v;
        } else if (tid < 18) {
            fp_load(v, qy + (2 * i + e) * LH_LIMBS);
            QY[e] = v;
            ty[e] = v;
        } else if (tid < 20) {
            if (e == 0) fp_one(v); else fp_zero(v);
            tz[e] = v;
        } else if (tid == 20) {
            fp_set_const(v, LH_TWO_INV);
            half[0] = v;
        } else {
            Fp2 t;
            fp2_set_const(t, LH_B_TWIST_3);
            if (tid == 21) b3[0] = t.c0; else b3[1] = t.c1;
        }
    }
    __syncthreads();
    if (live) {
        for (int b = 62; b >= 0; --b) {
            const bool add = (LH_X_ABS >> b) & 1;
            co_miller_dbl(f, l, tx, ty, tz, PX, PY, half, b3, w, sc,
                          b == 0 && !add, !add);
            if (add)
                co_miller_add(f, l, tx, ty, tz, QX, QY, PX, PY, w, sc,
                              b > 0);
        }
    }
    if (tid < 12) {             // conj(f): c1 negated
        Fp v = f[tid];
        if (tid >= 6) fp_neg(v, v);
        fp_store(out + (i * 12 + tid) * LH_LIMBS, v);
    }
}

#define LH_FE_THREADS 256      // = ops/bls_cost.py FINAL_EXP_SLOTS
#define LH_FE_CHUNK 4          // Fp12 products a step of the tree
#define LH_FE_SMEM ((12 * LH_FE_THREADS + CO_SCRATCH) * (int)sizeof(Fp))

// r = a^-1 for the Fp12 a (tower.cuh fp12_inv) on the block; w: 5 Fp12 of
// workspace (r, a and w distinct)
LH_DEV void co_fp12_inv(Fp* r, const Fp* a, Fp* w, Fp* sc) {
    Fp *s0 = w, *s1 = w + 6, *x = w + 12, *y = w + 18, *t = w + 30;
    Fp *d = w + 36, *den = w + 42, *nrm = w + 44, *ti = w + 47;
    const int tid = threadIdx.x;
    const CoOp sq[2] = {co_op(CO_MUL6, s0, a, a), co_op(CO_MUL6, s1, a + 6, a + 6)};
    co_step(sq, 2, sc);
    if (tid < 6) {              // x = s0 - v s1, v (c0, c1, c2) = (xi c2, c0, c1)
        Fp u;
        if (tid == 0) fp_sub(u, s1[4], s1[5]);
        else if (tid == 1) fp_add(u, s1[4], s1[5]);
        else u = s1[tid - 2];
        fp_sub(x[tid], s0[tid], u);
    }
    __syncthreads();
    // fp6_inv(x): the six products, t = (s00 - xi s12, xi s22 - s01,
    // s11 - s02), d = (x0 t0, x2 t1, x1 t2), den = d0 + xi d1 + xi d2
    const CoOp six[6] = {
        co_op(CO_SQR2, y, x), co_op(CO_MUL2, y + 2, x + 2, x + 4),
        co_op(CO_SQR2, y + 4, x + 4), co_op(CO_MUL2, y + 6, x, x + 2),
        co_op(CO_SQR2, y + 8, x + 2), co_op(CO_MUL2, y + 10, x, x + 4)};
    co_step(six, 6, sc);
    if (tid < 6) {
        const int j = tid >> 1, e = tid & 1;
        Fp u;
        if (j == 0) {           // s00 - xi s12
            if (e == 0) fp_sub(u, y[2], y[3]); else fp_add(u, y[2], y[3]);
            fp_sub(t[tid], y[e], u);
        } else if (j == 1) {    // xi s22 - s01
            if (e == 0) fp_sub(u, y[4], y[5]); else fp_add(u, y[4], y[5]);
            fp_sub(t[tid], u, y[6 + e]);
        } else {                // s11 - s02
            fp_sub(t[tid], y[8 + e], y[10 + e]);
        }
    }
    __syncthreads();
    const CoOp three[3] = {co_op(CO_MUL2, d, x, t),
                           co_op(CO_MUL2, d + 2, x + 4, t + 2),
                           co_op(CO_MUL2, d + 4, x + 2, t + 4)};
    co_step(three, 3, sc);
    if (tid < 2) {              // den = d0 + xi (d1 + d2); its c1 negated
        Fp u, v;
        fp_add(u, d[2], d[4]);
        fp_add(v, d[3], d[5]);
        if (tid == 0) { fp_sub(u, u, v); fp_add(den[0], d[0], u); }
        else { fp_add(u, u, v); fp_add(u, d[1], u); fp_neg(den[1], u); }
    }
    __syncthreads();
    // fp2_inv(den): (den0, -den1) / (den0^2 + den1^2)
    const CoOp norm[2] = {co_op(CO_MUL1, nrm, den, den),
                          co_op(CO_MUL1, nrm + 1, den + 1, den + 1)};
    co_step(norm, 2, sc);
    if (tid == 0) {
        Fp n;
        fp_add(n, nrm[0], nrm[1]);
        fp_inv_binary(nrm[2], n);
    }
    __syncthreads();
    const CoOp dinv[2] = {co_op(CO_MUL1, nrm, den, nrm + 2),
                          co_op(CO_MUL1, nrm + 1, den + 1, nrm + 2)};
    co_step(dinv, 2, sc);
    const CoOp tinv[3] = {co_op(CO_MUL2, ti, t, nrm),
                          co_op(CO_MUL2, ti + 2, t + 2, nrm),
                          co_op(CO_MUL2, ti + 4, t + 4, nrm)};
    co_step(tinv, 3, sc);
    const CoOp out[2] = {co_op(CO_MUL6, r, a, ti),
                         co_op(CO_MUL6, r + 6, a + 6, ti, 1)};
    co_step(out, 2, sc);
}

// f^((p^12-1)/r) of the Fp12 at w (in place); w: 12 Fp12 of workspace
// after it
LH_DEV void co_final_exponentiation(Fp* w, Fp* sc) {
    Fp *E = w, *I = w + 12, *G = w + 24, *Ek = w + 36, *U = w + 48;
    Fp *A = w + 60, *Bp = w + 72, *C = w + 84, *D = w + 96, *Tf = w + 108;
    Fp *Bc = w + 120, *ws = w + 132;
    // easy part: f^(p^6 - 1) = conj(f) f^-1, then ^(p^2 + 1)
    co_fp12_inv(I, E, ws, sc);
    co_step1(co_op(CO_MUL12, G, E, I, 1), sc);
    co_step1(co_op(CO_FROB, I, G, 0, 2), sc);
    co_step1(co_op(CO_MUL12, E, I, G), sc);
    // u = f^((|x|+1)/3), keeping f (Ek)
    const CoOp keep = co_op(CO_COPY, Ek, E);
    co_cyc_pow(U, false, E, LH_X13, sc, &keep, 1);
    // a = u^|x| u
    const CoOp init_a = co_op(CO_COPY, A, U);
    co_cyc_pow(A, true, U, LH_X_ABS, sc, &init_a, 1);
    // b' = conj(b) = a^|x| conj(frob1(a)), b = a^(x+p)
    const CoOp init_b = co_op(CO_FROB, Bp, A, 0, 1 | 4);
    co_cyc_pow(Bp, true, A, LH_X_ABS, sc, &init_b, 1);
    // c' = conj(c) = b'^(x^2) d', d' = frob2(b') conj(b') (taken during the
    // first power), c = b^(x^2+p^2-1)
    const CoOp d0[2] = {co_op(CO_FROB, Tf, Bp, 0, 2), co_op(CO_COPY, Bc, Bp)};
    const CoOp d1 = co_op(CO_MUL12, D, Tf, Bc, 2);
    co_cyc_pow(C, false, Bp, LH_X_ABS, sc, d0, 2, &d1, 1);
    co_cyc_pow(D, true, C, LH_X_ABS, sc);
    // c f
    co_step1(co_op(CO_MUL12, E, D, Ek, 1), sc);
}

__global__ void __launch_bounds__(LH_FE_THREADS, 1)
final_exp_kernel(int mode, const int32_t* __restrict__ fs, long long n,
                 int32_t* __restrict__ out, int32_t* __restrict__ flag) {
    extern __shared__ uint4 lh_smem[];
    Fp* slot = reinterpret_cast<Fp*>(lh_smem);
    Fp* sc = slot + 12 * LH_FE_THREADS;
    const int tid = threadIdx.x;
    const int slots = n < LH_FE_THREADS ? (int)n : LH_FE_THREADS;
    // slot t: fs[t], times fs[t + 256], fs[t + 512], ... past the block's
    // threads (thread t's own chain of sequential products: the batch's
    // 129 values need none)
    if (tid < slots) {
        Fp12 acc, v;
        fp12_load(acc, fs + (long long)tid * 12 * LH_LIMBS);
        for (long long i = tid + LH_FE_THREADS; i < n; i += LH_FE_THREADS) {
            fp12_load(v, fs + i * 12 * LH_LIMBS);
            fp12_mul(acc, acc, v);
        }
        *reinterpret_cast<Fp12*>(slot + 12 * tid) = acc;
    }
    __syncthreads();
    // pairwise tree: slot i takes slot i + h, h = ceil(w / 2)
    for (int w = slots; w > 1; w = (w + 1) / 2) {
        const int h = (w + 1) / 2, m = w - h;
        for (int c0 = 0; c0 < m; c0 += LH_FE_CHUNK) {
            const int cm = m - c0 < LH_FE_CHUNK ? m - c0 : LH_FE_CHUNK;
            CoOp ops[LH_FE_CHUNK];
            for (int q = 0; q < cm; ++q) {
                Fp* s = slot + 12 * (c0 + q);
                ops[q] = co_op(CO_MUL12, s, s, s + 12 * h);
            }
            co_step(ops, cm, sc);
        }
    }
    if (mode == 1) co_final_exponentiation(slot, sc);
    if (tid < 12) fp_store(out + tid * LH_LIMBS, slot[tid]);
    if (tid == 0)
        flag[0] = fp12_is_one(*reinterpret_cast<const Fp12*>(slot)) ? 1 : 0;
}

extern "C" int lh_miller_loop(const void* px, const void* py,
                              const void* qx, const void* qy,
                              const void* mask, void* out, long long n,
                              void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n > LH_ML_COOP_MAX) {
        const int threads = 32;
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        miller_loop_kernel<<<blocks, threads, 0, s>>>(
            (const int32_t*)px, (const int32_t*)py, (const int32_t*)qx,
            (const int32_t*)qy, (const int32_t*)mask, (int32_t*)out, n);
        return (int)cudaGetLastError();
    }
    miller_loop_coop_kernel<<<(unsigned)n, LH_ML_THREADS, LH_ML_SMEM, s>>>(
        (const int32_t*)px, (const int32_t*)py, (const int32_t*)qx,
        (const int32_t*)qy, (const int32_t*)mask, (int32_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int lh_final_exp(int mode, const void* fs, long long n,
                            void* out, void* flag, void* stream) {
    cudaError_t rc = cudaFuncSetAttribute(
        final_exp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        LH_FE_SMEM);
    if (rc != cudaSuccess) return (int)rc;
    final_exp_kernel<<<1, LH_FE_THREADS, LH_FE_SMEM, (cudaStream_t)stream>>>(
        mode, (const int32_t*)fs, n, (int32_t*)out, (int32_t*)flag);
    return (int)cudaGetLastError();
}
