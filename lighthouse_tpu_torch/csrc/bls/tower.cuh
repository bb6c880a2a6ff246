// Fp6 = Fp2[v]/(v^3 - xi) and Fp12 = Fp6[w]/(w^2 - v), xi = 1 + u: the
// JAX package's tower (lighthouse_tpu/ops/bls12_381.py:189-403, 743-776),
// one element per thread. Field values in the tower are unique, so the
// kernel and the plain version agree on them whatever the formula; the
// formulas follow the JAX ones all the same. Multiply and square are out
// of line: an Fp12 is 144 words, and inlining a Miller loop whole costs
// nvcc minutes and registers. The final exponentiation's inverse and
// Frobenius maps run on the cooperative layer (coop.cuh).
#pragma once
#include "fp.cuh"

struct Fp6 { Fp2 c0, c1, c2; };
struct Fp12 { Fp6 c0, c1; };

// ----------------------------------------------------------------- Fp6

LH_DEV void fp6_add(Fp6& r, const Fp6& a, const Fp6& b) {
    fp2_add(r.c0, a.c0, b.c0);
    fp2_add(r.c1, a.c1, b.c1);
    fp2_add(r.c2, a.c2, b.c2);
}

LH_DEV void fp6_sub(Fp6& r, const Fp6& a, const Fp6& b) {
    fp2_sub(r.c0, a.c0, b.c0);
    fp2_sub(r.c1, a.c1, b.c1);
    fp2_sub(r.c2, a.c2, b.c2);
}

LH_DEV void fp6_neg(Fp6& r, const Fp6& a) {
    fp2_neg(r.c0, a.c0);
    fp2_neg(r.c1, a.c1);
    fp2_neg(r.c2, a.c2);
}

// v * (a0, a1, a2) = (xi a2, a0, a1)
LH_DEV void fp6_mul_by_v(Fp6& r, const Fp6& a) {
    Fp2 t;
    fp2_mul_by_xi(t, a.c2);
    r.c2 = a.c1;
    r.c1 = a.c0;
    r.c0 = t;
}

// Karatsuba-3, as fp6_mul_many
LH_NOINL void fp6_mul(Fp6& r, const Fp6& a, const Fp6& b) {
    Fp2 t0, t1, t2, u12, u01, u02, x, y;
    fp2_mul(t0, a.c0, b.c0);
    fp2_mul(t1, a.c1, b.c1);
    fp2_mul(t2, a.c2, b.c2);
    fp2_add(x, a.c1, a.c2); fp2_add(y, b.c1, b.c2); fp2_mul(u12, x, y);
    fp2_add(x, a.c0, a.c1); fp2_add(y, b.c0, b.c1); fp2_mul(u01, x, y);
    fp2_add(x, a.c0, a.c2); fp2_add(y, b.c0, b.c2); fp2_mul(u02, x, y);
    // c0 = xi (u12 - t1 - t2) + t0
    fp2_sub(x, u12, t1); fp2_sub(x, x, t2); fp2_mul_by_xi(x, x);
    fp2_add(r.c0, x, t0);
    // c1 = u01 - t0 - t1 + xi t2
    fp2_sub(x, u01, t0); fp2_sub(x, x, t1); fp2_mul_by_xi(y, t2);
    fp2_add(r.c1, x, y);
    // c2 = u02 - t0 - t2 + t1
    fp2_sub(x, u02, t0); fp2_sub(x, x, t2);
    fp2_add(r.c2, x, t1);
}

// ---------------------------------------------------------------- Fp12

LH_DEV void fp12_one(Fp12& r) {
    fp2_one(r.c0.c0);
    fp2_zero(r.c0.c1);
    fp2_zero(r.c0.c2);
    fp2_zero(r.c1.c0);
    fp2_zero(r.c1.c1);
    fp2_zero(r.c1.c2);
}

LH_DEV void fp12_conj(Fp12& r, const Fp12& a) {
    r.c0 = a.c0;
    fp6_neg(r.c1, a.c1);
}

// as fp12_mul_many: t0 = a0 b0, t1 = a1 b1, tm = (a0 + a1)(b0 + b1);
// c0 = t0 + v t1, c1 = tm - t0 - t1
LH_NOINL void fp12_mul(Fp12& r, const Fp12& a, const Fp12& b) {
    Fp6 t0, t1, tm, x, y;
    fp6_mul(t0, a.c0, b.c0);
    fp6_mul(t1, a.c1, b.c1);
    fp6_add(x, a.c0, a.c1);
    fp6_add(y, b.c0, b.c1);
    fp6_mul(tm, x, y);
    fp6_mul_by_v(x, t1);
    fp6_add(r.c0, t0, x);
    fp6_sub(x, tm, t0);
    fp6_sub(r.c1, x, t1);
}

// as fp12_square: t = a0 a1, s = (a0 + a1)(a0 + v a1);
// c0 = s - t - v t, c1 = 2t
LH_NOINL void fp12_sqr(Fp12& r, const Fp12& a) {
    Fp6 t, s, x, y;
    fp6_mul(t, a.c0, a.c1);
    fp6_add(x, a.c0, a.c1);
    fp6_mul_by_v(y, a.c1);
    fp6_add(y, a.c0, y);
    fp6_mul(s, x, y);
    fp6_sub(x, s, t);
    fp6_mul_by_v(y, t);
    fp6_sub(r.c0, x, y);
    fp6_add(r.c1, t, t);
}

// sparse multiply by g = (c0 + c1 v) + (c4 v) w: the Miller line shape,
// with the 15 Fp2 products of fp12_mul_by_014
LH_NOINL void fp12_mul_by_014(Fp12& r, const Fp12& f, const Fp2& c0,
                              const Fp2& c1, const Fp2& c4) {
    const Fp2 &x0 = f.c0.c0, &x1 = f.c0.c1, &x2 = f.c0.c2;
    const Fp2 &y0 = f.c1.c0, &y1 = f.c1.c1, &y2 = f.c1.c2;
    Fp2 w0, w1, w2, c14, p1, p2, p3, p4, p5, p6, q0, q1, q2;
    Fp2 r1, r2, r3, r4, r5, r6, t00, t01, t02, t10, u0, u1, u2, x;
    fp2_add(w0, x0, y0);
    fp2_add(w1, x1, y1);
    fp2_add(w2, x2, y2);
    fp2_add(c14, c1, c4);
    fp2_mul(p1, x0, c0); fp2_mul(p2, x2, c1); fp2_mul(p3, x0, c1);
    fp2_mul(p4, x1, c0); fp2_mul(p5, x1, c1); fp2_mul(p6, x2, c0);
    fp2_mul(q0, y0, c4); fp2_mul(q1, y1, c4); fp2_mul(q2, y2, c4);
    fp2_mul(r1, w0, c0); fp2_mul(r2, w2, c14); fp2_mul(r3, w0, c14);
    fp2_mul(r4, w1, c0); fp2_mul(r5, w1, c14); fp2_mul(r6, w2, c0);
    // t0 = f0 g0, t1 = f1 g1 = (xi q2, q0, q1), u = (f0 + f1)(g0 + g1)
    fp2_mul_by_xi(x, p2); fp2_add(t00, p1, x);
    fp2_add(t01, p3, p4);
    fp2_add(t02, p5, p6);
    fp2_mul_by_xi(t10, q2);
    fp2_mul_by_xi(x, r2); fp2_add(u0, r1, x);
    fp2_add(u1, r3, r4);
    fp2_add(u2, r5, r6);
    // out0 = t0 + v t1, out1 = u - t0 - t1 (every read of f is done)
    fp2_mul_by_xi(x, q1); fp2_add(r.c0.c0, t00, x);
    fp2_add(r.c0.c1, t01, t10);
    fp2_add(r.c0.c2, t02, q0);
    fp2_sub(x, u0, t00); fp2_sub(r.c1.c0, x, t10);
    fp2_sub(x, u1, t01); fp2_sub(r.c1.c1, x, q0);
    fp2_sub(x, u2, t02); fp2_sub(r.c1.c2, x, q1);
}

LH_DEV bool fp12_is_one(const Fp12& a) {
    Fp2 one;
    fp2_one(one);
    return fp2_eq(a.c0.c0, one) && fp2_is_zero(a.c0.c1) &&
           fp2_is_zero(a.c0.c2) && fp2_is_zero(a.c1.c0) &&
           fp2_is_zero(a.c1.c1) && fp2_is_zero(a.c1.c2);
}

// Fp12 [.., 2, 3, 2, 32]: coefficient (i, j) at limb offset (2i + ... )
LH_DEV void fp12_load(Fp12& r, const int32_t* p) {
    fp2_load(r.c0.c0, p + 0 * 64); fp2_load(r.c0.c1, p + 1 * 64);
    fp2_load(r.c0.c2, p + 2 * 64); fp2_load(r.c1.c0, p + 3 * 64);
    fp2_load(r.c1.c1, p + 4 * 64); fp2_load(r.c1.c2, p + 5 * 64);
}

LH_DEV void fp12_store(int32_t* p, const Fp12& a) {
    fp2_store(p + 0 * 64, a.c0.c0); fp2_store(p + 1 * 64, a.c0.c1);
    fp2_store(p + 2 * 64, a.c0.c2); fp2_store(p + 3 * 64, a.c1.c0);
    fp2_store(p + 4 * 64, a.c1.c1); fp2_store(p + 5 * 64, a.c1.c2);
}
