// The cooperative tower layer: a group of threads performs one tower
// operation together, each thread one of its independent Fp products.
//
// Shared by the thread-cooperative kernels (pairing.cu final_exp and the
// cooperative Miller loop, hash_to_g2.cu, aggregate.cu g2_sum's top
// levels). Each computes the field operations of the sequential
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
//   products, then 12 sums; the Miller line's sparse product
//   (tower.cuh:fp12_mul_by_014) 45 products, then 30 and 12 sums.
//
// - Warp level (w_step): every lane holds the same Fp2 values in
//   registers and runs the formula's additions itself; a step's
//   independent Fp2 products (at most 10) run on lanes 3q..3q+2 (fp_mul,
//   out of line: one copy of the multiply for the warp's whole program)
//   and come back to every lane through the warp's 32-Fp shared scratch.
//   The Jacobian doubling and addition (w_jac_dbl, w_jac_add) run on it
//   over G2 for hash_to_g2.cu and the top levels of aggregate.cu's G2
//   tree, and over G1 on groups of four threads (GroupFp: an Fp product
//   a thread) for aggregate.cu's segment sums.
//
// - Lane groups (lg_step): G threads of one warp serve one lane of a wide
//   batch (rlc_scale.cu, g2_intake.cu: 10,240 lanes), several groups to a
//   warp and to a block. The lane's values live in the block's shared
//   memory as Fp slots; a step's products are spread over the group's
//   threads, each running fp_mul_inl on operands its table entry names
//   (a slot, or two slots added or subtracted), then up to three stages
//   of linear outputs (small integer combinations of slots), a
//   __syncwarp of the group's threads after each phase. The steps are
//   tables (lane_prog.cuh, rendered by ops/bls_lane.py from the formulas
//   of curve.cuh and fp.cuh), so a kernel calls lg_step at one site and
//   its control (scalar bits, exponent bits, the addition's branches)
//   picks the step: the groups of a warp run the same multiply code
//   whatever step each is at.
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
    CO_MUL014,    // dst = a * b (Fp12) for the sparse line b = (b0 + b1 v)
                  // + (b4 v) w: reads b's Fp2 slots 0, 1 and 4 only
    CO_MULF,      // dst = a * b (Fp2 by Fp)
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
    case CO_MUL014: return 45;
    case CO_CSQR: case CO_FROB: case CO_MUL6: return 18;
    case CO_MUL2: return 3;
    case CO_SQR2: case CO_MULF: return 2;
    case CO_MUL1: return 1;
    default: return 0;
    }
}

LH_DEV int co_nstage1(int kind) {
    switch (kind) {
    case CO_MUL12: return 36;
    case CO_MUL014: return 30;
    case CO_FROB: case CO_MUL6: return 12;
    case CO_MUL2: case CO_SQR2: case CO_MULF: return 2;
    case CO_MUL1: return 1;
    case CO_COPY: return 12;
    default: return 0;
    }
}

LH_DEV int co_nstage2(int kind) {
    switch (kind) {
    case CO_MUL12: return 18;
    case CO_CSQR: case CO_MUL014: return 12;
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

// fp12_mul_by_014's 15 Fp2 products p1..p6, q0..q2, r1..r6 (tower.cuh), two
// bits each: the left operand's halves (1: x = a.c0, 2: y = a.c1, 3: w =
// x + y), its Fp2 slot j, and the right one (0: b0, 1: b1, 2: b4, 3: b1 +
// b4)
#define CO_014_LHM 0x3ffea555u
#define CO_014_LJ 0x25224948u
#define CO_014_R 0x0cf2a114u

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
    case CO_MUL014: {
        const int q = k / 3, s2 = k - 3 * q;
        const int em = s2 < 2 ? 1 << s2 : 3;
        const int lhm = (CO_014_LHM >> (2 * q)) & 3;
        const int lj = (CO_014_LJ >> (2 * q)) & 3;
        const int rk = (CO_014_R >> (2 * q)) & 3;
        const int rhm = rk == 0 || rk == 1 ? 1 : (rk == 2 ? 2 : 3);
        co_operand(x, o.a, lhm, 1 << lj, em, false);
        co_operand(y, o.b, rhm, rk == 0 ? 1 : 2, em, false);
        break;
    }
    case CO_MULF:
        x = o.a[k];
        y = o.b[0];
        break;
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
    case CO_MUL12: case CO_MUL6: case CO_MUL014:
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
    case CO_MULF:
        o.dst[k] = T[k];
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

// fp12_mul_by_014's outputs (6h + 2j + e) as sums of its Fp2 products'
// coefficients (2 q + e, q in the order of CO_014_LHM): added (pos) and
// subtracted (neg); c0 = (t00 + xi q1, t01 + t10, t02 + q0), c1 = (u0 -
// t00 - t10, u1 - t01 - q0, u2 - t02 - q1) with t00 = p1 + xi p2, t01 =
// p3 + p4, t02 = p5 + p6, t10 = xi q2, u0 = r1 + xi r2, u1 = r3 + r4, u2 =
// r5 + r6
LH_DEV void co_014_masks(int k, unsigned& pos, unsigned& neg) {
    switch (k) {
    case 0: pos = 0x00004005u; neg = 0x00008008u; break;
    case 1: pos = 0x0000C00Eu; neg = 0; break;
    case 2: pos = 0x00010050u; neg = 0x00020000u; break;
    case 3: pos = 0x000300A0u; neg = 0; break;
    case 4: pos = 0x00001500u; neg = 0; break;
    case 5: pos = 0x00002A00u; neg = 0; break;
    case 6: pos = 0x00160008u; neg = 0x00210005u; break;
    case 7: pos = 0x00380000u; neg = 0x0003000Eu; break;
    case 8: pos = 0x01400000u; neg = 0x00001050u; break;
    case 9: pos = 0x02800000u; neg = 0x000020A0u; break;
    case 10: pos = 0x14000000u; neg = 0x00004500u; break;
    default: pos = 0x28000000u; neg = 0x00008A00u; break;
    }
}

// stage 2: Fp6 recombination; the cyclotomic square's and the sparse
// product's outputs
LH_DEV void co_stage2(const CoOp& o, int k, const Fp* T, const Fp* Q,
                      Fp* S) {
    if (o.kind == CO_MUL014) {
        unsigned pos, neg;
        co_014_masks(k, pos, neg);
        co_mask_sum(o.dst[k], Q, pos, neg);
        return;
    }
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
        tq[i + 1] = tq[i] + (kd == CO_MUL12 ? 36 : kd == CO_MUL6 ? 12
                             : kd == CO_MUL014 ? 30 : 0);
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

// The steps of the Jacobian formulas below. A stepper runs K independent
// products r[i] = a[i] * b[i] at once and hands every one to each of its
// threads: WarpFp2 on a warp (w_step: G2, Karatsuba), GroupFp on a group
// of LH_GROUP_FP threads of one warp (G1: product i on thread i).
struct WarpFp2 {
    typedef Fp2 F;
    Fp* sc;         // the warp's 32 Fp of shared scratch
    template <int K>
    LH_DEV void step(Fp2 (&r)[K], const Fp2 (&a)[K],
                     const Fp2 (&b)[K]) const {
        w_step<K>(sc, r, a, b, 0);
    }
};

// threads of a G1 group: the widest step of jac_add is 4 products
#define LH_GROUP_FP 4

struct GroupFp {
    typedef Fp F;
    Fp* sc;         // the group's LH_GROUP_FP Fp of shared scratch
    unsigned mask;  // the group's threads
    int t;          // this thread's rank in the group
    // product i on thread i (fp_mul out of line: one copy for the group's
    // whole program); __syncwarp of the group's threads around the
    // exchange. r may alias a and b.
    template <int K>
    LH_DEV void step(Fp (&r)[K], const Fp (&a)[K], const Fp (&b)[K]) const {
        static_assert(K <= LH_GROUP_FP, "a step of more products than "
                                        "threads");
        Fp x, y;
        bool act = false;
#pragma unroll
        for (int i = 0; i < K; ++i) {
            if (i != t) continue;
            x = a[i];
            y = b[i];
            act = true;
        }
        if (act) {
            Fp p;
            fp_mul(p, x, y);
            sc[t] = p;
        }
        __syncwarp(mask);
#pragma unroll
        for (int i = 0; i < K; ++i) r[i] = sc[i];
        __syncwarp(mask);
    }
};

// curve.cuh jac_dbl on a stepper: 7 products in 3 steps
template <class S>
LH_NOINL void w_jac_dbl(const S& st, Jac<typename S::F>& r,
                        const Jac<typename S::F>& p) {
    typedef typename S::F F;
    F A, B, yz, E, C, t, Fv, D, X3, s;
    {
        F R[3];
        const F a[3] = {p.x, p.y, p.y}, b[3] = {p.x, p.y, p.z};
        st.template step<3>(R, a, b);
        A = R[0]; B = R[1]; yz = R[2];
    }
    f_muln(E, A, 3);
    f_add(s, p.x, B);
    {
        F R[3];
        const F a[3] = {B, s, E}, b[3] = {B, s, E};
        st.template step<3>(R, a, b);
        C = R[0]; t = R[1]; Fv = R[2];
    }
    f_sub(s, t, A);
    f_sub(s, s, C);
    f_muln(D, s, 2);
    f_muln(s, D, 2);
    f_sub(X3, Fv, s);
    f_sub(s, D, X3);
    {
        F R[1];
        const F a[1] = {E}, b[1] = {s};
        st.template step<1>(R, a, b);
        f_muln(s, C, 8);
        f_sub(r.y, R[0], s);
    }
    f_muln(r.z, yz, 2);
    r.x = X3;
}

// curve.cuh jac_add on a stepper: 16 products in 5 steps, the same
// infinity and doubling branches
template <class S>
LH_NOINL void w_jac_add(const S& st, Jac<typename S::F>& r,
                        const Jac<typename S::F>& p,
                        const Jac<typename S::F>& q) {
    typedef typename S::F F;
    const bool inf1 = f_is_zero(p.z), inf2 = f_is_zero(q.z);
    F Z1Z1, Z2Z2, zz, U1, U2, z2c, z1c, H, H2, S1, S2, I, rr, J, V, rr2;
    F X3, Y3, Z3, rVX, S1J, s, d;
    f_add(s, p.z, q.z);
    {
        F R[3];
        const F a[3] = {p.z, q.z, s}, b[3] = {p.z, q.z, s};
        st.template step<3>(R, a, b);
        Z1Z1 = R[0]; Z2Z2 = R[1]; zz = R[2];
    }
    {
        F R[4];
        const F a[4] = {p.x, q.x, q.z, p.z}, b[4] = {Z2Z2, Z1Z1, Z2Z2, Z1Z1};
        st.template step<4>(R, a, b);
        U1 = R[0]; U2 = R[1]; z2c = R[2]; z1c = R[3];
    }
    f_sub(H, U2, U1);
    f_muln(H2, H, 2);
    {
        F R[3];
        const F a[3] = {p.y, q.y, H2}, b[3] = {z2c, z1c, H2};
        st.template step<3>(R, a, b);
        S1 = R[0]; S2 = R[1]; I = R[2];
    }
    const bool same_x = f_is_zero(H);
    f_sub(d, S2, S1);
    const bool same_y = f_is_zero(d);
    f_muln(rr, d, 2);
    {
        F R[3];
        const F a[3] = {H, U1, rr}, b[3] = {I, I, rr};
        st.template step<3>(R, a, b);
        J = R[0]; V = R[1]; rr2 = R[2];
    }
    f_sub(X3, rr2, J);
    f_muln(s, V, 2);
    f_sub(X3, X3, s);
    f_sub(s, V, X3);
    f_sub(d, zz, Z1Z1);
    f_sub(d, d, Z2Z2);
    {
        F R[3];
        const F a[3] = {rr, S1, d}, b[3] = {s, J, H};
        st.template step<3>(R, a, b);
        rVX = R[0]; S1J = R[1]; Z3 = R[2];
    }
    f_muln(s, S1J, 2);
    f_sub(Y3, rVX, s);
    Jac<F> out;
    out.x = X3;
    out.y = Y3;
    out.z = Z3;
    if (same_x && same_y && !inf1 && !inf2) w_jac_dbl(st, out, p);
    if (same_x && !same_y && !inf1 && !inf2) f_zero(out.z);
    if (inf1) out = q;
    if (inf2 && !inf1) out = p;
    r = out;
}

// the G2 forms on the warp (sc: its 32 Fp of shared scratch)
LH_DEV void w_jac_dbl(Fp* sc, Jac<Fp2>& r, const Jac<Fp2>& p) {
    w_jac_dbl(WarpFp2{sc}, r, p);
}

LH_DEV void w_jac_add(Fp* sc, Jac<Fp2>& r, const Jac<Fp2>& p,
                      const Jac<Fp2>& q) {
    w_jac_add(WarpFp2{sc}, r, p, q);
}

// ========================================================= lane groups

struct LgStep {
    unsigned short j0, nj;      // products: LG_JOB[j0 .. j0 + nj)
    unsigned short l0[3], nl[3];    // linear stages: LG_LIN pairs
};

#include "lane_prog.cuh"

// the G threads of a lane: its slots, this thread's rank, the group's
// threads in the warp
struct Lg {
    Fp* V;
    int t, G;
    unsigned mask;      // the group's threads
    unsigned live;      // the warp's threads whose group has a lane
};

// slots are 48 B (three 16-byte words) in 16-byte aligned shared memory
LH_DEV void lg_ld(Fp& r, const Fp* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const uint4 v = q[i];
        r.w[4 * i] = v.x;
        r.w[4 * i + 1] = v.y;
        r.w[4 * i + 2] = v.z;
        r.w[4 * i + 3] = v.w;
    }
}

LH_DEV void lg_st(Fp* p, const Fp& a) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        uint4 v;
        v.x = a.w[4 * i];
        v.y = a.w[4 * i + 1];
        v.z = a.w[4 * i + 2];
        v.w = a.w[4 * i + 3];
        q[i] = v;
    }
}

// lanes a block of `threads` serves at width G (the warp's leftover
// threads, 32 mod G, idle), and the shared memory it takes
__host__ __device__ inline int lg_lanes(int threads, int G) {
    return (threads / 32) * (32 / G);
}

// a lane's nv slots in 16-byte words, padded to 1 mod 8: the groups of a
// warp reading the same slot then fall on different banks (unpadded, 40
// slots are 480 words, and every group's copy of a slot on one bank)
__host__ __device__ inline int lg_stride(int nv) {
    return 3 * nv + ((1 - 3 * nv) % 8 + 8) % 8;
}

__host__ inline size_t lg_smem(int threads, int G, int nv) {
    return (size_t)lg_lanes(threads, G) * lg_stride(nv) * sizeof(uint4);
}

// this thread's group and lane; false for a leftover thread and past n
LH_DEV bool lg_init(Lg& g, int G, int nv, long long n, long long& lane) {
    extern __shared__ uint4 lh_smem[];
    const int wl = threadIdx.x & 31, gi = wl / G, gpw = 32 / G;
    if (gi >= gpw) return false;
    const int gb = (int)(threadIdx.x >> 5) * gpw + gi;
    lane = (long long)blockIdx.x * lg_lanes(blockDim.x, G) + gb;
    if (lane >= n) return false;
    g.V = reinterpret_cast<Fp*>(lh_smem + (long long)gb * lg_stride(nv));
    g.t = wl - gi * G;
    g.G = G;
    g.mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (gi * G);
    const long long left = n - (lane - gi);       // lanes from the warp's
    const int groups = left < gpw ? (int)left : gpw;    // first on
    g.live = groups * G == 32 ? 0xffffffffu : (1u << (groups * G)) - 1u;
    return true;
}

// 2p - x: the negation fp_add takes (x + (2p - y) < 4p), in [0, 2p]
LH_DEV void lg_neg2p(Fp& r, const Fp& x) {
    words_sub(r.w, LH_2P, x.w);
}

// an operand: V[a], or V[a] + V[b], or V[a] - V[b] (f: bit 0 two slots,
// bit 1 subtract). Every thread runs the same instructions: a lone slot
// adds zero.
LH_DEV void lg_operand(Fp& x, const Fp* V, unsigned a, unsigned b,
                       unsigned f) {
    Fp y, ny;
    lg_ld(x, V + a);
    lg_ld(y, V + b);
    if (!(f & 1u)) fp_zero(y);
    lg_neg2p(ny, y);
    if (f & 2u) y = ny;
    fp_add(x, x, y);
}

// V[dst] from its operation list (ops/bls_lane.py lin_ops: add or
// subtract a slot, or double, on an accumulator from zero), the same
// instructions on every thread whatever its output
LH_DEV void lg_lin(Fp* V, unsigned long long w0, unsigned long long w1) {
    const int n = (int)(w0 >> 6) & 15;
    Fp acc;
    fp_zero(acc);
    unsigned long long w = w0 >> 10;
    for (int i = 0; i < n; ++i) {
        if (i == 6) w = w1;
        const unsigned op = (unsigned)(w & 255u);
        w >>= 8;
        Fp x, nx;
        lg_ld(x, V + (op & 63u));
        if (op & 128u) x = acc;
        lg_neg2p(nx, x);
        if (op & 64u) x = nx;
        fp_add(acc, acc, x);
    }
    lg_st(V + (w0 & 63u), acc);
}

// step s of the tables on the lane: the products, then the linear stages.
// The kernel's one multiply site.
LH_DEV void lg_step(const Lg& g, int s) {
    const LgStep st = LG_STEP[s];
    for (int j = g.t; j < st.nj; j += g.G) {
        const unsigned long long d = LG_JOB[st.j0 + j];
        const unsigned f = (unsigned)(d >> 40);
        Fp x, y, r;
        lg_operand(x, g.V, (unsigned)(d >> 8) & 255u,
                   (unsigned)(d >> 16) & 255u, f & 3u);
        lg_operand(y, g.V, (unsigned)(d >> 24) & 255u,
                   (unsigned)(d >> 32) & 255u, (f >> 2) & 3u);
        fp_mul_inl(r, x, y);
        if (f & 16u) fp_dbl(r, r);
        lg_st(g.V + (d & 255u), r);
    }
    __syncwarp(g.mask);
    for (int k = 0; k < 3 && st.nl[k]; ++k) {
        for (int j = g.t; j < st.nl[k]; j += g.G)
            lg_lin(g.V, LG_LIN[2 * (st.l0[k] + j)],
                   LG_LIN[2 * (st.l0[k] + j) + 1]);
        __syncwarp(g.mask);
    }
}

// n slots from src to dst (zero where zero_from <= k), spread over the
// group
LH_DEV void lg_copy(const Lg& g, int dst, int src, int n,
                    int zero_from = 1 << 30) {
    for (int k = g.t; k < n; k += g.G) {
        Fp v;
        if (k >= zero_from) fp_zero(v); else lg_ld(v, g.V + src + k);
        lg_st(g.V + dst + k, v);
    }
    __syncwarp(g.mask);
}

LH_DEV bool lg_is_zero(const Lg& g, int s, int d) {
    bool z = true;
    for (int e = 0; e < d; ++e) {
        Fp v;
        lg_ld(v, g.V + s + e);
        z = z && fp_is_zero(v);
    }
    return z;
}

// slots a and b hold equal field values (d coefficients)
LH_DEV bool lg_eq(const Lg& g, int a, int b, int d) {
    bool eq = true;
    for (int e = 0; e < d; ++e) {
        Fp u, v;
        lg_ld(u, g.V + a + e);
        lg_ld(v, g.V + b + e);
        eq = eq && fp_eq(u, v);
    }
    return eq;
}

// slot s holds one (d coefficients)
LH_DEV bool lg_is_one(const Lg& g, int s, int d) {
    Fp v, one;
    lg_ld(v, g.V + s);
    fp_one(one);
    return fp_eq(v, one) && (d == 1 || lg_is_zero(g, s + 1, d - 1));
}

// the slots of a point's Jacobian coordinates (d coefficients each) from
// int32 limbs x, y, z [n, d, 32] at lane into dst and dst2
LH_DEV void lg_load_point(const Lg& g, int d, const int32_t* x,
                          const int32_t* y, const int32_t* z,
                          long long lane, int dst, int dst2) {
    for (int k = g.t; k < 3 * d; k += g.G) {
        const int c = k / d, e = k - c * d;
        const int32_t* src = c == 0 ? x : (c == 1 ? y : z);
        Fp v;
        fp_load(v, src + (lane * d + e) * LH_LIMBS);
        lg_st(g.V + dst + k, v);
        lg_st(g.V + dst2 + k, v);
    }
    __syncwarp(g.mask);
}

LH_DEV void lg_store_point(const Lg& g, int d, int32_t* x, int32_t* y,
                           int32_t* z, long long lane, int src) {
    for (int k = g.t; k < 3 * d; k += g.G) {
        const int c = k / d, e = k - c * d;
        int32_t* dst = c == 0 ? x : (c == 1 ? y : z);
        Fp v;
        lg_ld(v, g.V + src + k);
        fp_store(dst + (lane * d + e) * LH_LIMBS, v);
    }
}

// the slots and programs of a scalar-multiply layout (lane_prog.cuh)
#define LG_CURVE(S, N, DEG)                                               \
    struct S {                                                            \
        enum {                                                            \
            D = DEG, NV = LG_##N##_NV, X = LG_##N##_X, Z = LG_##N##_Z,    \
            QX = LG_##N##_QX, QZ = LG_##N##_QZ, RX = LG_##N##_RX,         \
            DBL = LG_##N##_P_DBL, DBL_N = LG_##N##_P_DBL_N,               \
            MADD = LG_##N##_P_MADD, MADD_N = LG_##N##_P_MADD_N,           \
            ADD = LG_##N##_P_ADD, ADD_N = LG_##N##_P_ADD_N,               \
            MADD_H = LG_##N##_MADD_H, MADD_DY = LG_##N##_MADD_DY,         \
            ADD_H = LG_##N##_ADD_H, ADD_DY = LG_##N##_ADD_DY              \
        };                                                                \
    };
LG_CURVE(LgRlc1, RLC1, 1)
LG_CURVE(LgRlc2, RLC2, 2)
LG_CURVE(LgSub, SUB, 2)

// jac_add's branches after the addition program (ACC + Q into R): ACC
// becomes Q (ACC at infinity), stays (Q at infinity), R with z zero (P +
// -P), or R; true for P + P, whose doubling program runs next on ACC
template <class L>
LH_DEV bool lg_add_select(const Lg& g, bool mixed) {
    const bool inf1 = lg_is_zero(g, L::Z, L::D);
    const bool inf2 = !mixed && lg_is_zero(g, L::QZ, L::D);
    const bool same_x = lg_is_zero(g, mixed ? L::MADD_H : L::ADD_H, L::D);
    const bool same_y = lg_is_zero(g, mixed ? L::MADD_DY : L::ADD_DY, L::D);
    __syncwarp(g.mask);          // every thread has read before ACC moves
    if (inf1) {
        lg_copy(g, L::X, L::QX, 3 * L::D);
    } else if (!inf2) {
        if (same_x && same_y) return true;
        lg_copy(g, L::X, L::RX, 3 * L::D, same_x ? 2 * L::D : 1 << 30);
    }
    return false;
}

// The MSB-first double-and-add of the plain scalar_mul and of
// jac_scalar_mul_const from the warp's first set bit on (its lanes'
// highest), ACC there Q where the lane's bit is set and infinity (zero)
// elsewhere (the doublings of the infinity before a lane's first set bit
// stay at infinity, and its addition gives Q): a doubling a bit, the
// addition of Q on set bits, mixed where Q's z is one. The groups of a
// warp run in step: after each doubling the warp votes, and every group
// runs the addition when one lane's bit is set, the others dropping its
// result, so the warp issues one program, not one for each group's
// place in its own bits. Bits MSB first: bits[j], or bit 63 - j of k
// when bits is null.
template <class L>
struct LgMul {
    const int32_t* bits;
    unsigned long long k;
    int nbits, j, prog, s;     // prog: 0 doubling, 1 addition, 2 the
    bool mixed;                // addition's doubling branch; s: its step

    LH_DEV bool bit(int i) const {
        return bits ? bits[i] != 0 : ((k >> (63 - i)) & 1ull) != 0;
    }

    // the warp's first set bit; ACC from Q there, or infinity
    LH_DEV void start(const Lg& g, int n, bool mixed_) {
        nbits = n;
        int first = 0;
        while (first < n && !__any_sync(g.live, bit(first))) ++first;
        if (first == n || !bit(first)) lg_copy(g, L::X, L::X, 3 * L::D, 0);
        j = first + 1;
        prog = s = 0;
        mixed = mixed_;
    }

    LH_DEV bool done() const { return j >= nbits; }

    LH_DEV int step() const {
        return (prog == 1 ? (mixed ? L::MADD : L::ADD) : L::DBL) + s;
    }

    // after step() ran
    LH_DEV void next(const Lg& g) {
        const int n = prog == 1 ? (mixed ? L::MADD_N : L::ADD_N) : L::DBL_N;
        if (++s < n) return;
        s = 0;
        if (prog == 0) {
            if (__any_sync(g.live, bit(j))) {
                prog = 1;
                return;
            }
        } else if (prog == 1 && bit(j) && lg_add_select<L>(g, mixed)) {
            prog = 2;
            return;
        }
        prog = 0;
        ++j;
    }
};
