// The cooperative tower layer: a group of threads performs one tower
// operation together, each thread one of its independent Fp products.
//
// Shared by the two thread-cooperative kernels (pairing.cu final_exp,
// hash_to_g2.cu). Each computes the field operations of the sequential
// tower.cuh / curve.cuh functions: the same values, canonically (the
// representative in [0, 2p) may differ, as additions come in another
// order). What bounds a chain of tower operations on one thread is its
// depth in dependent multiplies times a multiply's latency; here a step
// costs one multiply's latency however many products it runs side by
// side, plus its additions and barriers.
//
// Two forms:
//
// - Block level (co_step): Fp12 values live in shared memory as 12 Fp,
//   index 6h + 2j + e (coefficient e of the Fp2 c_h.c_j, the interchange
//   layout). A step runs a few ops (CoOp) at once: every thread takes
//   product jobs, loads and pre-adds its two operands from shared memory,
//   runs fp_mul_inl (the build's multiply, in line: co_step is the one
//   site of the library), stores the product; then up to three stages of
//   post-additions spread over the threads, a barrier after each. An Fp12
//   product (Karatsuba over fp6_mul, as tower.cuh:fp12_mul) is 54
//   products, then 36, 18 and 12 sums; a Granger-Scott cyclotomic square
//   9 Fp2 squares (18 products), then 12 sums; a Frobenius map 18
//   products, then 12 sums.
//
// - Warp level (w_step): every lane holds the same Fp2 values in
//   registers and runs the formula's additions itself; a step's
//   independent Fp2 products (at most 10) run on lanes 3q..3q+2 (fp_mul,
//   out of line: one copy of the multiply for the warp's whole program)
//   and come back to every lane through the warp's 32-Fp shared scratch.
#pragma once
#include "curve.cuh"

// ======================================================== block level

enum CoKind {
    CO_MUL12,     // dst = a * b (Fp12); flags bit 0 conj(a), bit 1 conj(b)
    CO_CSQR,      // dst = a^2 (Fp12 in the cyclotomic subgroup); dst may be a
    CO_FROB,      // dst = a^(p^n) (Fp12), n = flags & 3; flags bit 2 conj(dst)
    CO_MUL6,      // dst = a * b (Fp6); flags bit 0: dst = -(a * b)
    CO_MUL2,      // dst = a * b (Fp2)
    CO_SQR2,      // dst = a^2 (Fp2)
    CO_MUL1,      // dst = a * b (Fp)
    CO_COPY,      // dst = a (Fp12)
};

struct CoOp {
    int kind, flags;
    Fp* dst;
    const Fp* a;
    const Fp* b;
};

#define CO_MAX_OPS 8
// scratch a step needs at most: four Fp12 products (54 + 36 + 18 each)
#define CO_SCRATCH (4 * 108)

LH_DEV CoOp co_op(int kind, Fp* dst, const Fp* a, const Fp* b = 0,
                  int flags = 0) {
    CoOp o;
    o.kind = kind;
    o.flags = flags;
    o.dst = dst;
    o.a = a;
    o.b = b;
    return o;
}

// products; then the scratch of stages 1 and 2 (kinds that stage there)
LH_DEV int co_nprod(int kind) {
    switch (kind) {
    case CO_MUL12: return 54;
    case CO_CSQR: case CO_FROB: case CO_MUL6: return 18;
    case CO_MUL2: return 3;
    case CO_SQR2: return 2;
    case CO_MUL1: return 1;
    default: return 0;
    }
}

LH_DEV int co_nstage1(int kind) {
    switch (kind) {
    case CO_MUL12: return 36;
    case CO_FROB: case CO_MUL6: return 12;
    case CO_MUL2: case CO_SQR2: return 2;
    case CO_MUL1: return 1;
    case CO_COPY: return 12;
    default: return 0;
    }
}

LH_DEV int co_nstage2(int kind) {
    switch (kind) {
    case CO_MUL12: return 18;
    case CO_CSQR: return 12;
    case CO_MUL6: return 6;
    default: return 0;
    }
}

LH_DEV int co_nstage3(int kind) { return kind == CO_MUL12 ? 12 : 0; }

// the sum of v[i] over the set bits of m (zero for none), one add a bit
LH_DEV void co_bits_sum(Fp& out, const Fp* v, unsigned m) {
    if (!m) {
        fp_zero(out);
        return;
    }
    Fp acc = v[__ffs(m) - 1];
    for (m &= m - 1; m; m &= m - 1) fp_add(acc, acc, v[__ffs(m) - 1]);
    out = acc;
}

// sum of v[i] over the set bits of pos, minus those over the bits of neg
LH_DEV void co_mask_sum(Fp& out, const Fp* v, unsigned pos, unsigned neg) {
    Fp p, q;
    co_bits_sum(p, v, pos);
    if (!neg) {
        out = p;
        return;
    }
    co_bits_sum(q, v, neg);
    fp_sub(out, p, q);
}

// Karatsuba operand of an Fp12 (hm: halves), Fp6 (jm: Fp2 slots) and Fp2
// (em: coefficients) product: the sum of v[6h + 2j + e] over the sets;
// conj negates half 1
LH_DEV void co_operand(Fp& out, const Fp* v, int hm, int jm, int em,
                       bool conj) {
    unsigned pos = 0, neg = 0;
    for (int h = 0; h < 2; ++h)
        for (int j = 0; j < 3; ++j)
            for (int e = 0; e < 2; ++e)
                if (((hm >> h) & (jm >> j) & (em >> e)) & 1) {
                    if (conj && h == 1) neg |= 1u << (6 * h + 2 * j + e);
                    else pos |= 1u << (6 * h + 2 * j + e);
                }
    co_mask_sum(out, v, pos, neg);
}

// Karatsuba-3 slots of fp6_mul: t0, t1, t2, u12, u01, u02
LH_DEV int co_jm(int s6) {
    return s6 < 3 ? 1 << s6 : (s6 == 3 ? 6 : (s6 == 4 ? 3 : 5));
}

// the operands of product k of op o
LH_DEV void co_operands(const CoOp& o, int k, Fp& x, Fp& y) {
    switch (o.kind) {
    case CO_MUL12: case CO_MUL6: {
        const int s12 = o.kind == CO_MUL12 ? k / 18 : 0;
        const int r = k - 18 * s12, s6 = r / 3, s2 = r - 3 * s6;
        const int hm = s12 == 2 ? 3 : 1 << s12;
        const int em = s2 < 2 ? 1 << s2 : 3;
        const bool cj = o.kind == CO_MUL12;
        co_operand(x, o.a, hm, co_jm(s6), em, cj && (o.flags & 1));
        co_operand(y, o.b, hm, co_jm(s6), em, cj && (o.flags & 2));
        break;
    }
    case CO_CSQR: {
        // square q of pairs (z0, z1), (z2, z3), (z4, z5) at Fp2 slots
        // (0, 4), (3, 2), (1, 5): a, b or a + b; then (x0 + x1)(x0 - x1)
        // or x0 x1
        const int q = k >> 1, g = q / 3, w = q - 3 * g;
        const int ca = g == 0 ? 0 : (g == 1 ? 3 : 1);
        const int cb = g == 0 ? 4 : (g == 1 ? 2 : 5);
        Fp x0, x1;
        if (w == 0) { x0 = o.a[2 * ca]; x1 = o.a[2 * ca + 1]; }
        else if (w == 1) { x0 = o.a[2 * cb]; x1 = o.a[2 * cb + 1]; }
        else {
            fp_add(x0, o.a[2 * ca], o.a[2 * cb]);
            fp_add(x1, o.a[2 * ca + 1], o.a[2 * cb + 1]);
        }
        if (k & 1) { x = x0; y = x1; }
        else { fp_add(x, x0, x1); fp_sub(y, x0, x1); }
        break;
    }
    case CO_FROB: {
        const int n = o.flags & 3, c = k / 3, t = k - 3 * c;
        const int i = c / 3, j = c - 3 * i;
        Fp x0 = o.a[2 * c], x1 = o.a[2 * c + 1], g0, g1;
        if (n & 1) fp_neg(x1, x1);
        fp_set_const(g0, LH_FROB[n - 1][i + 2 * j][0]);
        fp_set_const(g1, LH_FROB[n - 1][i + 2 * j][1]);
        if (t == 0) { x = x0; y = g0; }
        else if (t == 1) { x = x1; y = g1; }
        else { fp_add(x, x0, x1); fp_add(y, g0, g1); }
        break;
    }
    case CO_MUL2:
        if (k == 0) { x = o.a[0]; y = o.b[0]; }
        else if (k == 1) { x = o.a[1]; y = o.b[1]; }
        else { fp_add(x, o.a[0], o.a[1]); fp_add(y, o.b[0], o.b[1]); }
        break;
    case CO_SQR2:
        if (k == 0) { fp_add(x, o.a[0], o.a[1]); fp_sub(y, o.a[0], o.a[1]); }
        else { x = o.a[0]; y = o.a[1]; }
        break;
    default:            // CO_MUL1
        x = o.a[0];
        y = o.b[0];
        break;
    }
}

// Karatsuba Fp2 recombination of products t[0..2]: e = 0: t0 - t1,
// e = 1: t2 - t0 - t1
LH_DEV void co_fp2_post(Fp& out, const Fp* t, int e) {
    if (e == 0) {
        fp_sub(out, t[0], t[1]);
    } else {
        Fp s;
        fp_add(s, t[0], t[1]);
        fp_sub(out, t[2], s);
    }
}

// stage 1: Fp2 recombination (and the single-stage kinds' outputs)
LH_DEV void co_stage1(const CoOp& o, int k, const Fp* T, Fp* Q) {
    switch (o.kind) {
    case CO_MUL12: case CO_MUL6:
        co_fp2_post(Q[k], T + 3 * (k >> 1), k & 1);
        break;
    case CO_FROB: {
        Fp v;
        co_fp2_post(v, T + 3 * (k >> 1), k & 1);
        if ((o.flags & 4) && k >= 6) fp_neg(v, v);
        o.dst[k] = v;
        break;
    }
    case CO_MUL2:
        co_fp2_post(o.dst[k], T, k);
        break;
    case CO_SQR2:
        if (k == 0) o.dst[0] = T[0]; else fp_dbl(o.dst[1], T[1]);
        break;
    case CO_MUL1:
        o.dst[0] = T[0];
        break;
    default:            // CO_COPY
        o.dst[k] = o.a[k];
        break;
    }
}

// Fp6 recombination of fp6_mul (tower.cuh) over its six Fp2 products
// (t0, t1, t2, u12, u01, u02 at 2 s6 + e): coefficient e of c_j as the
// products added (pos) and subtracted (neg):
//   c0 = xi (u12 - t1 - t2) + t0, c1 = u01 - t0 - t1 + xi t2,
//   c2 = u02 - t0 - t2 + t1, with xi (y0, y1) = (y0 - y1, y0 + y1)
LH_DEV void co_fp6_masks(int j, int e, unsigned& pos, unsigned& neg) {
    const int m = 2 * j + e;
    pos = m == 0 ? 0x069u : m == 1 ? 0x0C2u : m == 2 ? 0x110u
        : m == 3 ? 0x230u : m == 4 ? 0x404u : 0x808u;
    neg = m == 0 ? 0x094u : m == 1 ? 0x03Cu : m == 2 ? 0x025u
        : m == 3 ? 0x00Au : m == 4 ? 0x011u : 0x022u;
}

// stage 2: Fp6 recombination; the cyclotomic square's outputs
LH_DEV void co_stage2(const CoOp& o, int k, const Fp* T, const Fp* Q,
                      Fp* S) {
    if (o.kind == CO_CSQR) {
        // squares Sq(q) = (T[2q], T[2q + 1]); pair g: a^2, b^2, (a + b)^2 at
        // q = 3g, 3g + 1, 3g + 2. Fp4 square (a^2 + xi b^2, (a + b)^2 - a^2
        // - b^2); z becomes 3t - 2z (c0 terms) or 3t + 2z (c1 terms)
        const int c = k >> 1, e = k & 1;
        const int g = c == 0 || c == 4 ? 0 : (c == 1 || c == 5 ? 1 : 2);
        const int part = c == 4 || c == 5 ? 1 : (c == 3 ? 2 : 0);
        const Fp* A2 = T + 6 * g;
        const Fp* B2 = A2 + 2;
        const Fp* S2 = A2 + 4;
        Fp t, u;
        if (part == 0) {            // a^2 + xi b^2
            if (e == 0) { fp_sub(u, B2[0], B2[1]); fp_add(t, A2[0], u); }
            else { fp_add(u, B2[0], B2[1]); fp_add(t, A2[1], u); }
        } else if (part == 1) {     // 2ab
            fp_add(u, A2[e], B2[e]);
            fp_sub(t, S2[e], u);
        } else {                    // xi (2ab) for z2
            Fp v0, v1;
            fp_add(u, A2[0], B2[0]);
            fp_sub(v0, S2[0], u);
            fp_add(u, A2[1], B2[1]);
            fp_sub(v1, S2[1], u);
            if (e == 0) fp_sub(t, v0, v1); else fp_add(t, v0, v1);
        }
        const Fp z = o.a[k];
        if (part == 0) fp_sub(u, t, z); else fp_add(u, t, z);
        fp_dbl(u, u);
        fp_add(o.dst[k], u, t);
        return;
    }
    // MUL12 (three Fp6 products, k = 6 s12 + 2j + e) or MUL6
    const int s12 = k / 6, m = k - 6 * s12;
    unsigned pos, neg;
    co_fp6_masks(m >> 1, m & 1, pos, neg);
    if (o.kind == CO_MUL6) {
        if (o.flags & 1) co_mask_sum(o.dst[m], Q, neg, pos);
        else co_mask_sum(o.dst[m], Q, pos, neg);
    } else {
        co_mask_sum(S[k], Q + 12 * s12, pos, neg);
    }
}

// stage 3 (MUL12): c0 = t0 + v t1, c1 = tm - t0 - t1 over the Fp6 products
// S = (t0, t1, tm), v (c0, c1, c2) = (xi c2, c0, c1)
LH_DEV void co_stage3(const CoOp& o, int k, const Fp* S) {
    unsigned pos, neg = 0;
    if (k >= 6) {
        const int m = k - 6;
        pos = 1u << (12 + m);
        neg = (1u << m) | (1u << (6 + m));
    } else if (k == 0) {
        pos = (1u << 0) | (1u << 10);
        neg = 1u << 11;
    } else if (k == 1) {
        pos = (1u << 1) | (1u << 10) | (1u << 11);
    } else {
        pos = (1u << k) | (1u << (4 + k));   // t0.c1 + t1.c0, t0.c2 + t1.c1
    }
    co_mask_sum(o.dst[k], S, pos, neg);
}

// One step of the block: all threads call it (it holds the barriers).
// Ops read their inputs in the product stage (CO_COPY and CO_CSQR's own
// coefficient: in the stage that writes their output) and write their
// outputs in their last stage, so one op may read what another op of the
// same step overwrites, but no two ops may write the same value.
LH_NOINL void co_step(const CoOp* ops, int nops, Fp* scratch) {
    int tp[CO_MAX_OPS + 1], tq[CO_MAX_OPS + 1], ts[CO_MAX_OPS + 1];
    int n1[CO_MAX_OPS + 1], n2[CO_MAX_OPS + 1], n3[CO_MAX_OPS + 1];
    tp[0] = tq[0] = ts[0] = n1[0] = n2[0] = n3[0] = 0;
    for (int i = 0; i < nops; ++i) {
        const int kd = ops[i].kind;
        tp[i + 1] = tp[i] + co_nprod(kd);
        tq[i + 1] = tq[i] + (kd == CO_MUL12 ? 36 : kd == CO_MUL6 ? 12 : 0);
        ts[i + 1] = ts[i] + (kd == CO_MUL12 ? 18 : 0);
        n1[i + 1] = n1[i] + co_nstage1(kd);
        n2[i + 1] = n2[i] + co_nstage2(kd);
        n3[i + 1] = n3[i] + co_nstage3(kd);
    }
    Fp* T = scratch;
    Fp* Q = T + tp[nops];
    Fp* S = Q + tq[nops];
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int j = tid; j < tp[nops]; j += nt) {
        int i = 0;
        while (j >= tp[i + 1]) ++i;
        const int k = j - tp[i];
        Fp x, y, r;
        co_operands(ops[i], k, x, y);
        fp_mul_inl(r, x, y);
        if (ops[i].kind == CO_CSQR && (k & 1)) fp_dbl(r, r);
        T[j] = r;
    }
    __syncthreads();
    if (n1[nops]) {
        for (int j = tid; j < n1[nops]; j += nt) {
            int i = 0;
            while (j >= n1[i + 1]) ++i;
            co_stage1(ops[i], j - n1[i], T + tp[i], Q + tq[i]);
        }
        __syncthreads();
    }
    if (n2[nops]) {
        for (int j = tid; j < n2[nops]; j += nt) {
            int i = 0;
            while (j >= n2[i + 1]) ++i;
            co_stage2(ops[i], j - n2[i], T + tp[i], Q + tq[i], S + ts[i]);
        }
        __syncthreads();
    }
    if (n3[nops]) {
        for (int j = tid; j < n3[nops]; j += nt) {
            int i = 0;
            while (j >= n3[i + 1]) ++i;
            co_stage3(ops[i], j - n3[i], S + ts[i]);
        }
        __syncthreads();
    }
}

LH_DEV void co_step1(const CoOp& a, Fp* sc) { co_step(&a, 1, sc); }

// acc = (have ? acc : 1) * base^e for a cyclotomic base, walked from the
// bottom bit: each bit below the top squares the base (Granger-Scott) and,
// where it is set, multiplies it into acc in the same step; the top bit
// multiplies alone. base is overwritten. extra0 / extra1 run beside steps
// 0 / 1 (they must not touch acc or base before acc's first use).
LH_DEV void co_cyc_pow(Fp* acc, bool have, Fp* base, unsigned long long e,
                       Fp* sc, const CoOp* extra0 = 0, int nextra0 = 0,
                       const CoOp* extra1 = 0, int nextra1 = 0) {
    const int top = 63 - __clzll(e);
    for (int i = 0; i <= top; ++i) {
        CoOp ops[CO_MAX_OPS];
        int k = 0;
        if ((e >> i) & 1ull) {
            ops[k++] = have ? co_op(CO_MUL12, acc, acc, base)
                            : co_op(CO_COPY, acc, base);
            have = true;
        }
        if (i < top) ops[k++] = co_op(CO_CSQR, base, base);
        const CoOp* ex = i == 0 ? extra0 : (i == 1 ? extra1 : 0);
        const int nex = i == 0 ? nextra0 : (i == 1 ? nextra1 : 0);
        for (int q = 0; q < nex; ++q) ops[k++] = ex[q];
        co_step(ops, k, sc);
    }
}

// ========================================================= warp level

enum { W_MUL = 0, W_SQR = 1, W_CMP = 2 };
// kinds of the jobs of a step, two bits each: job q's kind at bits 2q
#define W_KINDS2(a, b) ((a) | ((b) << 2))
#define W_KINDS3(a, b, c) (W_KINDS2(a, b) | ((c) << 4))
#define W_KINDS4(a, b, c, d) (W_KINDS3(a, b, c) | ((d) << 6))
#define W_KINDS5(a, b, c, d, f) (W_KINDS4(a, b, c, d) | ((f) << 8))

// r[q] = a[q] * b[q] (W_MUL, Karatsuba: 3 products), a[q]^2 (W_SQR, 2
// products) or (a0 b0, a1 b1) (W_CMP: two Fp products) for q < K <= 10,
// at once; every lane of the warp calls it with the same values, and gets
// the same results. sc: the warp's 32 Fp of shared scratch. r may alias a
// and b.
template <int K>
LH_DEV void w_step(Fp* sc, Fp2 (&r)[K], const Fp2 (&a)[K],
                   const Fp2 (&b)[K], unsigned kinds) {
    const int lane = threadIdx.x & 31, q = lane / 3, t = lane - 3 * q;
    Fp x, y;
    bool act = false;
#pragma unroll
    for (int i = 0; i < K; ++i) {
        if (i != q) continue;
        const unsigned kd = (kinds >> (2 * i)) & 3u;
        if (kd == W_MUL) {
            act = true;
            if (t == 0) { x = a[i].c0; y = b[i].c0; }
            else if (t == 1) { x = a[i].c1; y = b[i].c1; }
            else { fp_add(x, a[i].c0, a[i].c1); fp_add(y, b[i].c0, b[i].c1); }
        } else if (kd == W_SQR) {
            act = t < 2;
            if (t == 0) { fp_add(x, a[i].c0, a[i].c1); fp_sub(y, a[i].c0, a[i].c1); }
            else { x = a[i].c0; y = a[i].c1; }
        } else {
            act = t < 2;
            if (t == 0) { x = a[i].c0; y = b[i].c0; }
            else { x = a[i].c1; y = b[i].c1; }
        }
    }
    if (act) {
        Fp p;
        fp_mul(p, x, y);
        sc[lane] = p;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const unsigned kd = (kinds >> (2 * i)) & 3u;
        const Fp* T = sc + 3 * i;
        if (kd == W_MUL) {
            Fp s;
            fp_sub(r[i].c0, T[0], T[1]);
            fp_add(s, T[0], T[1]);
            fp_sub(r[i].c1, T[2], s);
        } else if (kd == W_SQR) {
            r[i].c0 = T[0];
            fp_dbl(r[i].c1, T[1]);
        } else {
            r[i].c0 = T[0];
            r[i].c1 = T[1];
        }
    }
    __syncwarp();
}

// one job
LH_DEV void w_one(Fp* sc, Fp2& r, const Fp2& a, const Fp2& b,
                  unsigned kind) {
    Fp2 R[1];
    const Fp2 A[1] = {a}, B[1] = {b};
    w_step<1>(sc, R, A, B, kind);
    r = R[0];
}

LH_DEV void w_mul(Fp* sc, Fp2& r, const Fp2& a, const Fp2& b) {
    w_one(sc, r, a, b, W_MUL);
}

// a^-1 (0 -> 0), as fp2_inv: the norm's two squares, its binary inverse
// (every lane), the two products
LH_DEV void w_fp2_inv(Fp* sc, Fp2& r, const Fp2& a) {
    Fp2 s, nn;
    w_one(sc, s, a, a, W_CMP);
    Fp n;
    fp_add(n, s.c0, s.c1);
    fp_inv_binary(nn.c0, n);
    nn.c1 = nn.c0;
    w_one(sc, s, a, nn, W_CMP);
    r.c0 = s.c0;
    fp_neg(r.c1, s.c1);
}

// a^e for a constant e (12 words), walked from the bottom bit: each bit
// below the top squares the base, and where it is set multiplies it into
// the product in the same step; the top bit multiplies alone. The products
// of fp2_pow (fp.cuh), whose walk from the top takes a step for each.
LH_DEV void w_fp2_pow(Fp* sc, Fp2& r, const Fp2& a, const uint32_t* e) {
    int top = 383;
    while (top > 0 && !((e[top >> 5] >> (top & 31)) & 1)) --top;
    Fp2 base = a, acc = a;
    bool have = false;
    for (int i = 0; i < top; ++i) {
        const bool bit = (e[i >> 5] >> (i & 31)) & 1;
        if (bit && have) {
            Fp2 R[2];
            const Fp2 A[2] = {acc, base}, B[2] = {base, base};
            w_step<2>(sc, R, A, B, W_KINDS2(W_MUL, W_SQR));
            acc = R[0];
            base = R[1];
        } else {
            if (bit) {
                acc = base;
                have = true;
            }
            w_one(sc, base, base, base, W_SQR);
        }
    }
    if (have) w_mul(sc, acc, acc, base); else acc = base;
    r = acc;
}
