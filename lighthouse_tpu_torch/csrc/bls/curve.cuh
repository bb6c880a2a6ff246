// Jacobian G1 (over Fp) and G2 (over Fp2) with exactly the formulas of
// the JAX package's _make_point_ops (lighthouse_tpu/ops/bls12_381.py:
// 409-498), including the infinity and doubling branches, so the Jacobian
// outputs of a kernel and of the plain version agree coordinate for
// coordinate (canonically), not only up to projective equivalence.
// Infinity is z == 0. Also psi and the constant scalar multiply of the
// cofactor clearing.
#pragma once
#include "tower.cuh"

// field-generic names for the point formulas
LH_DEV void f_add(Fp& r, const Fp& a, const Fp& b) { fp_add(r, a, b); }
LH_DEV void f_sub(Fp& r, const Fp& a, const Fp& b) { fp_sub(r, a, b); }
LH_DEV void f_mul(Fp& r, const Fp& a, const Fp& b) { fp_mul(r, a, b); }
LH_DEV bool f_is_zero(const Fp& a) { return fp_is_zero(a); }
LH_DEV void f_zero(Fp& r) { fp_zero(r); }
LH_DEV void f_load(Fp& r, const int32_t* p) { fp_load(r, p); }
LH_DEV void f_store(int32_t* p, const Fp& a) { fp_store(p, a); }
LH_DEV void f_inv(Fp& r, const Fp& a) { fp_inv(r, a); }

LH_DEV void f_add(Fp2& r, const Fp2& a, const Fp2& b) { fp2_add(r, a, b); }
LH_DEV void f_sub(Fp2& r, const Fp2& a, const Fp2& b) { fp2_sub(r, a, b); }
LH_DEV void f_mul(Fp2& r, const Fp2& a, const Fp2& b) { fp2_mul(r, a, b); }
LH_DEV bool f_is_zero(const Fp2& a) { return fp2_is_zero(a); }
LH_DEV void f_zero(Fp2& r) { fp2_zero(r); }
LH_DEV void f_load(Fp2& r, const int32_t* p) { fp2_load(r, p); }
LH_DEV void f_store(int32_t* p, const Fp2& a) { fp2_store(p, a); }
LH_DEV void f_inv(Fp2& r, const Fp2& a) { fp2_inv(r, a); }

template <class F> struct Jac { F x, y, z; };

// limbs per coordinate: 32 for Fp, 64 for Fp2
template <class F> struct Limbs;
template <> struct Limbs<Fp> { static const int n = 32; };
template <> struct Limbs<Fp2> { static const int n = 64; };

template <class F>
LH_DEV void jac_load(Jac<F>& p, const int32_t* x, const int32_t* y,
                     const int32_t* z, long long i) {
    const long long o = i * Limbs<F>::n;
    f_load(p.x, x + o);
    f_load(p.y, y + o);
    f_load(p.z, z + o);
}

template <class F>
LH_DEV void jac_store(int32_t* x, int32_t* y, int32_t* z, long long i,
                      const Jac<F>& p) {
    const long long o = i * Limbs<F>::n;
    f_store(x + o, p.x);
    f_store(y + o, p.y);
    f_store(z + o, p.z);
}

// muln_(a, k): a added k times
template <class F> LH_DEV void f_muln(F& r, const F& a, int k) {
    F acc = a;
    for (int i = 1; i < k; ++i) f_add(acc, acc, a);
    r = acc;
}

template <class F> LH_NOINL void jac_dbl(Jac<F>& r, const Jac<F>& p) {
    F A, B, yz, E, C, t, Fv, D, X3, EDX, Y3, Z3, s;
    f_mul(A, p.x, p.x);
    f_mul(B, p.y, p.y);
    f_mul(yz, p.y, p.z);
    f_muln(E, A, 3);
    f_mul(C, B, B);
    f_add(s, p.x, B);
    f_mul(t, s, s);
    f_mul(Fv, E, E);
    f_sub(s, t, A);
    f_sub(s, s, C);
    f_muln(D, s, 2);
    f_muln(s, D, 2);
    f_sub(X3, Fv, s);
    f_sub(s, D, X3);
    f_mul(EDX, E, s);
    f_muln(s, C, 8);
    f_sub(Y3, EDX, s);
    f_muln(Z3, yz, 2);
    r.x = X3;
    r.y = Y3;
    r.z = Z3;
}

template <class F>
LH_NOINL void jac_add(Jac<F>& r, const Jac<F>& p, const Jac<F>& q) {
    const bool inf1 = f_is_zero(p.z), inf2 = f_is_zero(q.z);
    F Z1Z1, Z2Z2, zz, U1, U2, z2c, z1c, H, H2, S1, S2, I, rr, J, V, rr2;
    F X3, Y3, Z3, rVX, S1J, s, d;
    f_mul(Z1Z1, p.z, p.z);
    f_mul(Z2Z2, q.z, q.z);
    f_add(s, p.z, q.z);
    f_mul(zz, s, s);
    f_mul(U1, p.x, Z2Z2);
    f_mul(U2, q.x, Z1Z1);
    f_mul(z2c, q.z, Z2Z2);
    f_mul(z1c, p.z, Z1Z1);
    f_sub(H, U2, U1);
    f_muln(H2, H, 2);
    f_mul(S1, p.y, z2c);
    f_mul(S2, q.y, z1c);
    f_mul(I, H2, H2);
    const bool same_x = f_is_zero(H);
    f_sub(d, S2, S1);
    const bool same_y = f_is_zero(d);
    f_muln(rr, d, 2);
    f_mul(J, H, I);
    f_mul(V, U1, I);
    f_mul(rr2, rr, rr);
    f_sub(X3, rr2, J);
    f_muln(s, V, 2);
    f_sub(X3, X3, s);
    f_sub(s, V, X3);
    f_mul(rVX, rr, s);
    f_mul(S1J, S1, J);
    f_sub(s, zz, Z1Z1);
    f_sub(s, s, Z2Z2);
    f_mul(Z3, s, H);
    f_muln(s, S1J, 2);
    f_sub(Y3, rVX, s);
    Jac<F> out;
    out.x = X3;
    out.y = Y3;
    out.z = Z3;
    if (same_x && same_y && !inf1 && !inf2) jac_dbl(out, p);
    if (same_x && !same_y && !inf1 && !inf2) f_zero(out.z);
    if (inf1) out = q;
    if (inf2 && !inf1) out = p;
    r = out;
}

// shared constant scalar k = (hi, lo) as the JAX scalar_mul_const: from
// (x, y, 0), every bit of k from its top one down
template <class F>
LH_DEV void jac_scalar_mul_const(Jac<F>& r, const Jac<F>& p,
                                 unsigned long long hi,
                                 unsigned long long lo) {
    int top = 127;
    while (top > 0 && !(((top >= 64 ? hi >> (top - 64) : lo >> top)) & 1))
        --top;
    Jac<F> acc = p;
    f_zero(acc.z);
    for (int i = top; i >= 0; --i) {
        jac_dbl(acc, acc);
        if ((i >= 64 ? hi >> (i - 64) : lo >> i) & 1) jac_add(acc, acc, p);
    }
    r = acc;
}

// psi: (cx conj(X), cy conj(Y), conj(Z))
LH_NOINL void g2_psi(Jac<Fp2>& r, const Jac<Fp2>& p) {
    Fp2 t, c;
    fp2_conj(t, p.x);
    fp2_set_const(c, LH_H2C_PSI_CX);
    fp2_mul(r.x, t, c);
    fp2_conj(t, p.y);
    fp2_set_const(c, LH_H2C_PSI_CY);
    fp2_mul(r.y, t, c);
    fp2_conj(r.z, p.z);
}

// (X/Z^2, Y/Z^3); Z = 0 inverts to 0
template <class F>
LH_DEV void jac_to_affine(F& ax, F& ay, const Jac<F>& p) {
    F zi, zi2, zi3;
    f_inv(zi, p.z);
    f_mul(zi2, zi, zi);
    f_mul(ax, p.x, zi2);
    f_mul(zi3, zi2, zi);
    f_mul(ay, p.y, zi3);
}
