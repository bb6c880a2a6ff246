// Fp and Fp2 for BLS12-381 on Hopper: one field element per thread.
//
// Replaces the field layer of lighthouse_tpu/ops/bigint.py (mont_mul,
// add_mod, sub_mod) and the Fp2 layer of lighthouse_tpu/ops/bls12_381.py.
// The interchange layout stays the JAX package's: int32[..., 32] limbs of
// 12 bits, Montgomery form with R = 2^384, values in [0, 2p). A thread
// repacks its 32 limbs into 12 32-bit words on load and unpacks on store;
// R is 2^384 in both layouts, so the Montgomery domain is the same.
//
// The multiply is CIOS Montgomery over 12 words with 64-bit products. For
// inputs below 2p the result is below (4p^2 + Rp)/R < 2p (4p < R), so no
// final subtraction is needed and every op keeps [0, 2p). The kernel and
// the plain 12-bit-limb multiply return different representatives of the
// same residue: equality and zero tests compare canonical values.
//
// What bounds it: integer multiply-adds (2 x 144 32x32->64-bit products a
// multiply). Simple first: no PTX carry chains, no sharing across threads.
//
// LH_FP_MODE (0, 1 or 2; kernels.py builds one library per mode) picks
// the lowering of fp_mul, the port of the JAX package's LHTPU_BIGINT_MXU
// modes (lighthouse_tpu/ops/bigint.py:319-356 mont_mul with :243
// _digits6, :251 _from_digits6, :264 toeplitz6, :281 _mul_columns_digits,
// :296 _mul_const_digits). Mode 0 is the CIOS product above. Modes 1 and 2
// run REDC in 6-bit digit space: an Fp is 64 digits below 64, packed four
// to a register (byte j of d[r] is digit 4r + j), and a column of a
// product is a sum of __dp4a's (four 8-bit products added into a 32-bit
// sum), product scanning with the carry taken as each column closes:
//   t = a*b (mode 2: 144 word products; mode 1: 128 digit columns);
//   m = (t mod R) * N' mod R (64 digit columns: m is exact mod R, where
//       the JAX package keeps loose limbs, so the representative differs);
//   (t + m*p) / R: 128 digit columns; the low 64 are zero by construction.
// t < 4p^2 and m < R give (t + m p)/R < 2p (4p < R): [0, 2p) is kept.
// The constants' digits are read reversed and packed four for each
// alignment (LH_NPRIME_DREV, LH_P_DREV in consts.cuh): every thread reads
// the same address. Mode 1 builds the reversed packs of b with
// __byte_perm. Digits are below 64, so the signed and unsigned __dp4a
// agree; the unsigned one is used, as every sum here is nonnegative.
// What bounds modes 1 and 2: the FMA pipe's issue of 2,688 __dp4a's
// (mode 1), or 1,616 __dp4a's and 288 word-product halves (mode 2),
// beside 899 / 576 digit, carry and pack ops on the ALU pipe
// (ops/bls_cost.py fp_mul_pipe_ops), against CIOS's 288 multiply-adds;
// each column's __dp4a's are one dependent chain.
// No tensor cores yet: a warp-cooperative mma.sync/wgmma s8 REDC needs
// all 32 lanes converged at every product, which the stage kernels'
// per-lane branches (scalar bits, masks, square roots) do not give.
#pragma once
#include <stdint.h>

#ifndef LH_FP_MODE
#define LH_FP_MODE 0
#endif

#define LH_DEV __device__ __forceinline__
#define LH_NOINL __device__ __noinline__

#include "consts.cuh"

#define LH_W 12            // 32-bit words of an Fp
#define LH_LIMBS 32        // 12-bit limbs of the interchange layout

struct Fp { uint32_t w[LH_W]; };
struct Fp2 { Fp c0, c1; };

// ---------------------------------------------------------------- words

LH_DEV void fp_set_const(Fp& r, const uint32_t* c) {
#pragma unroll
    for (int i = 0; i < LH_W; ++i) r.w[i] = c[i];
}

LH_DEV void fp_zero(Fp& r) {
#pragma unroll
    for (int i = 0; i < LH_W; ++i) r.w[i] = 0;
}

LH_DEV void fp_one(Fp& r) { fp_set_const(r, LH_ONE); }

// r = a + b over 12 words; returns the carry out. On the card one carry
// chain (add.cc / addc.cc, in two asm blocks of six words, the carry
// passed between them in a register): an instruction a word where the
// 64-bit sums of the host version take two.
LH_DEV uint32_t words_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
#ifdef __CUDA_ARCH__
    uint32_t c, t;
    asm("add.cc.u32 %0, %7, %13;\n\t"
        "addc.cc.u32 %1, %8, %14;\n\t"
        "addc.cc.u32 %2, %9, %15;\n\t"
        "addc.cc.u32 %3, %10, %16;\n\t"
        "addc.cc.u32 %4, %11, %17;\n\t"
        "addc.cc.u32 %5, %12, %18;\n\t"
        "addc.u32 %6, 0, 0;"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
          "=r"(r[5]), "=r"(c)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
          "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]));
    asm("add.cc.u32 %7, %8, 0xffffffff;\n\t"   // the carry in, to CC
        "addc.cc.u32 %0, %9, %15;\n\t"
        "addc.cc.u32 %1, %10, %16;\n\t"
        "addc.cc.u32 %2, %11, %17;\n\t"
        "addc.cc.u32 %3, %12, %18;\n\t"
        "addc.cc.u32 %4, %13, %19;\n\t"
        "addc.cc.u32 %5, %14, %20;\n\t"
        "addc.u32 %6, 0, 0;"
        : "=r"(r[6]), "=r"(r[7]), "=r"(r[8]), "=r"(r[9]), "=r"(r[10]),
          "=r"(r[11]), "=r"(c), "=r"(t)
        : "r"(c), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]),
          "r"(a[11]), "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]),
          "r"(b[10]), "r"(b[11]));
    return c;
#else
    uint64_t c = 0;
    for (int i = 0; i < LH_W; ++i) {
        c += (uint64_t)a[i] + b[i];
        r[i] = (uint32_t)c;
        c >>= 32;
    }
    return (uint32_t)c;
#endif
}

// r = a - b over 12 words; returns the borrow out (sub.cc / subc.cc on
// the card, as words_add)
LH_DEV uint32_t words_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
#ifdef __CUDA_ARCH__
    uint32_t br, t;
    asm("sub.cc.u32 %0, %7, %13;\n\t"
        "subc.cc.u32 %1, %8, %14;\n\t"
        "subc.cc.u32 %2, %9, %15;\n\t"
        "subc.cc.u32 %3, %10, %16;\n\t"
        "subc.cc.u32 %4, %11, %17;\n\t"
        "subc.cc.u32 %5, %12, %18;\n\t"
        "subc.u32 %6, 0, 0;"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
          "=r"(r[5]), "=r"(br)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
          "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]));
    asm("sub.cc.u32 %7, 0, %8;\n\t"            // the borrow in, to CC
        "subc.cc.u32 %0, %9, %15;\n\t"
        "subc.cc.u32 %1, %10, %16;\n\t"
        "subc.cc.u32 %2, %11, %17;\n\t"
        "subc.cc.u32 %3, %12, %18;\n\t"
        "subc.cc.u32 %4, %13, %19;\n\t"
        "subc.cc.u32 %5, %14, %20;\n\t"
        "subc.u32 %6, 0, 0;"
        : "=r"(r[6]), "=r"(r[7]), "=r"(r[8]), "=r"(r[9]), "=r"(r[10]),
          "=r"(r[11]), "=r"(br), "=r"(t)
        : "r"(br & 1u), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]),
          "r"(a[10]), "r"(a[11]), "r"(b[6]), "r"(b[7]), "r"(b[8]),
          "r"(b[9]), "r"(b[10]), "r"(b[11]));
    return br & 1u;
#else
    uint32_t br = 0;
    for (int i = 0; i < LH_W; ++i) {
        uint64_t d = (uint64_t)a[i] - b[i] - br;
        r[i] = (uint32_t)d;
        br = (uint32_t)(d >> 63);
    }
    return br;
#endif
}

// ------------------------------------------------------- load and store

// 32 limbs of 12 bits (digits may be loose, up to 2^13) -> 12 words
LH_DEV void fp_load(Fp& r, const int32_t* limbs) {
    uint64_t acc = 0;
    int bits = 0, wi = 0;
#pragma unroll
    for (int i = 0; i < LH_LIMBS; ++i) {
        acc += (uint64_t)(uint32_t)limbs[i] << bits;
        bits += 12;
        if (bits >= 32) {
            r.w[wi++] = (uint32_t)acc;
            acc >>= 32;
            bits -= 32;
        }
    }
}

// 12 words -> 32 canonical 12-bit digits
LH_DEV void fp_store(int32_t* limbs, const Fp& a) {
#pragma unroll
    for (int i = 0; i < LH_LIMBS; ++i) {
        int bit = 12 * i, wi = bit >> 5, sh = bit & 31;
        uint64_t v = a.w[wi];
        if (wi + 1 < LH_W) v |= (uint64_t)a.w[wi + 1] << 32;
        limbs[i] = (int32_t)((v >> sh) & 0xFFF);
    }
}

// ------------------------------------------------------------------ Fp

LH_DEV void fp_add(Fp& r, const Fp& a, const Fp& b) {
    Fp t, u;
    words_add(t.w, a.w, b.w);                 // < 4p < 2^384: no carry
    uint32_t br = words_sub(u.w, t.w, LH_2P);
    r = br ? t : u;
}

LH_DEV void fp_sub(Fp& r, const Fp& a, const Fp& b) {
    Fp t, u;
    uint32_t br = words_sub(t.w, a.w, b.w);
    words_add(u.w, t.w, LH_2P);
    r = br ? u : t;
}

LH_DEV void fp_neg(Fp& r, const Fp& a) {
    Fp z;
    fp_zero(z);
    fp_sub(r, z, a);
}

LH_DEV void fp_dbl(Fp& r, const Fp& a) { fp_add(r, a, a); }

// canonical representative in [0, p)
LH_DEV void fp_canon(Fp& r, const Fp& a) {
    Fp u;
    uint32_t br = words_sub(u.w, a.w, LH_P);
    r = br ? a : u;
}

LH_DEV bool fp_is_zero(const Fp& a) {
    Fp c;
    fp_canon(c, a);
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < LH_W; ++i) acc |= c.w[i];
    return acc == 0;
}

LH_DEV bool fp_eq(const Fp& a, const Fp& b) {
    Fp ca, cb;
    fp_canon(ca, a);
    fp_canon(cb, b);
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < LH_W; ++i) acc |= ca.w[i] ^ cb.w[i];
    return acc == 0;
}

// fp_mul_inl is the multiply's body, force-inlined where a kernel wants
// it in line (coop.cuh's co_step, the block layer's one product site);
// fp_mul is the same code out of line, one copy per library.
#if LH_FP_MODE == 0
// CIOS Montgomery product a*b*2^-384 mod p, inputs and output in [0, 2p)
LH_DEV void fp_mul_inl(Fp& r, const Fp& a, const Fp& b) {
    uint32_t t[LH_W + 2];
#pragma unroll
    for (int j = 0; j < LH_W + 2; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < LH_W; ++i) {
        uint64_t c = 0;
        uint32_t bi = b.w[i];
#pragma unroll
        for (int j = 0; j < LH_W; ++j) {
            c = (uint64_t)t[j] + (uint64_t)a.w[j] * bi + (c >> 32);
            t[j] = (uint32_t)c;
        }
        c = (uint64_t)t[LH_W] + (c >> 32);
        t[LH_W] = (uint32_t)c;
        t[LH_W + 1] = (uint32_t)(c >> 32);
        uint32_t m = t[0] * LH_N0INV;
        c = (uint64_t)t[0] + (uint64_t)m * LH_P[0];
#pragma unroll
        for (int j = 1; j < LH_W; ++j) {
            c = (uint64_t)t[j] + (uint64_t)m * LH_P[j] + (c >> 32);
            t[j - 1] = (uint32_t)c;
        }
        c = (uint64_t)t[LH_W] + (c >> 32);
        t[LH_W - 1] = (uint32_t)c;
        t[LH_W] = t[LH_W + 1] + (uint32_t)(c >> 32);
    }
#pragma unroll
    for (int j = 0; j < LH_W; ++j) r.w[j] = t[j];
}
#else
#define LH_DIG 64          // 6-bit digits of an Fp
#define LH_DREG 16         // registers of packed digits of an Fp
#define LH_DREV 67         // reversed packs of a constant (alignments 0..66)

// 12 words -> 64 digits, packed: byte j of d[r] is digit 4r + j
LH_DEV void fp_digits(uint32_t* d, const uint32_t* w) {
#pragma unroll
    for (int r = 0; r < LH_DREG; ++r) {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int bit = 6 * (4 * r + j), wi = bit >> 5, sh = bit & 31;
            uint32_t x = w[wi] >> sh;
            if (sh > 26 && wi + 1 < LH_W) x |= w[wi + 1] << (32 - sh);
            v |= (x & 63u) << (8 * j);
        }
        d[r] = v;
    }
}

// digits s, s-1, s-2, s-3 of the packed d (zero outside 0..63), in bytes
// 0..3: the partner of d'[r] in column s + 4r
LH_DEV uint32_t digits_rev(const uint32_t* d, int s) {
    const int t = s >> 2;
    const uint32_t hi = t < LH_DREG ? d[t] : 0u;
    const uint32_t lo = t > 0 ? d[t - 1] : 0u;
    return __byte_perm(lo, hi, 0x1234u + 0x1111u * (uint32_t)(s & 3));
}

LH_DEV uint32_t digit_at(const uint32_t* d, int k) {
    return (d[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

// Montgomery product a*b*2^-384 mod p in 6-bit digit space (modes 1, 2),
// inputs and output in [0, 2p)
LH_DEV void fp_mul_inl(Fp& r, const Fp& a, const Fp& b) {
    uint32_t t[2 * LH_DREG], m[LH_DREG];
#pragma unroll
    for (int i = 0; i < 2 * LH_DREG; ++i) t[i] = 0;
#if LH_FP_MODE == 1
    // t = a*b: 128 digit columns, b's packs reversed per alignment
    {
        uint32_t da[LH_DREG], db[LH_DREG];
        fp_digits(da, a.w);
        fp_digits(db, b.w);
        uint32_t carry = 0;
#pragma unroll
        for (int k = 0; k < 2 * LH_DIG; ++k) {
            uint32_t acc = carry;
#pragma unroll
            for (int i = 0; i < LH_DREG; ++i) {
                const int s = k - 4 * i;
                if (s >= 0 && s < LH_DREV)
                    acc = __dp4a(da[i], digits_rev(db, s), acc);
            }
            t[k >> 2] |= (acc & 63u) << (8 * (k & 3));
            carry = acc >> 6;
        }
    }
#else
    // t = a*b: 144 word products, then its 128 digits
    {
        uint32_t w[2 * LH_W];
#pragma unroll
        for (int j = 0; j < 2 * LH_W; ++j) w[j] = 0;
#pragma unroll
        for (int i = 0; i < LH_W; ++i) {
            uint64_t c = 0;
#pragma unroll
            for (int j = 0; j < LH_W; ++j) {
                c = (uint64_t)w[i + j] + (uint64_t)a.w[j] * b.w[i]
                    + (c >> 32);
                w[i + j] = (uint32_t)c;
            }
            w[i + LH_W] = (uint32_t)(c >> 32);
        }
        fp_digits(t, w);
        fp_digits(t + LH_DREG, w + LH_W);
    }
#endif
    // m = (t mod R) N' mod R: the low 64 digit columns, exact
    {
#pragma unroll
        for (int i = 0; i < LH_DREG; ++i) m[i] = 0;
        uint32_t carry = 0;
#pragma unroll
        for (int k = 0; k < LH_DIG; ++k) {
            uint32_t acc = carry;
#pragma unroll
            for (int i = 0; i <= (k >> 2); ++i)
                acc = __dp4a(t[i], LH_NPRIME_DREV[k - 4 * i], acc);
            m[k >> 2] |= (acc & 63u) << (8 * (k & 3));
            carry = acc >> 6;
        }
    }
    // (t + m p) / R: 128 digit columns; the high 64 digits are the result
    {
        uint64_t out = 0;
        int bits = 0, wi = 0;
        uint32_t carry = 0;
#pragma unroll
        for (int k = 0; k < 2 * LH_DIG; ++k) {
            uint32_t acc = carry + digit_at(t, k);
#pragma unroll
            for (int i = 0; i < LH_DREG; ++i) {
                const int s = k - 4 * i;
                if (s >= 0 && s < LH_DREV)
                    acc = __dp4a(m[i], LH_P_DREV[s], acc);
            }
            carry = acc >> 6;
            if (k >= LH_DIG) {
                out |= (uint64_t)(acc & 63u) << bits;
                bits += 6;
                if (bits >= 32) {
                    r.w[wi++] = (uint32_t)out;
                    out >>= 32;
                    bits -= 32;
                }
            }
        }
    }
}
#endif

LH_NOINL void fp_mul(Fp& r, const Fp& a, const Fp& b) {
    fp_mul_inl(r, a, b);
}

LH_DEV void fp_sqr(Fp& r, const Fp& a) { fp_mul(r, a, a); }

// a^e for a constant exponent e (12 words, MSB first from its top bit);
// starts from a and skips the leading one, as the JAX fp_pow_const does
LH_NOINL void fp_pow(Fp& r, const Fp& a, const uint32_t* e) {
    int top = 383;
    while (top > 0 && !((e[top >> 5] >> (top & 31)) & 1)) --top;
    Fp acc = a;
    for (int i = top - 1; i >= 0; --i) {
        fp_sqr(acc, acc);
        if ((e[i >> 5] >> (i & 31)) & 1) fp_mul(acc, acc, a);
    }
    r = acc;
}

// ------------------------------------------------ binary inverse, Legendre
// Variable-time (the inputs are public): a few hundred word shifts and
// subtractions where fp_pow runs 600 dependent multiplies.

LH_DEV bool words_is_zero(const uint32_t* a) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < LH_W; ++i) acc |= a[i];
    return acc == 0;
}

LH_DEV bool words_is_one(const uint32_t* a) {
    uint32_t acc = a[0] ^ 1u;
#pragma unroll
    for (int i = 1; i < LH_W; ++i) acc |= a[i];
    return acc == 0;
}

// a >>= 1, the carry shifted in at the top
LH_DEV void words_shr1(uint32_t* a, uint32_t top) {
#pragma unroll
    for (int i = 0; i < LH_W - 1; ++i) a[i] = (a[i] >> 1) | (a[i + 1] << 31);
    a[LH_W - 1] = (a[LH_W - 1] >> 1) | (top << 31);
}

// x - y mod p for x, y in [0, p)
LH_DEV void fp_int_sub(uint32_t* x, const uint32_t* y) {
    if (words_sub(x, x, y)) words_add(x, x, LH_P);
}

// w even and nonzero: strip its trailing zeros, and divide x (in [0, p))
// by the same power of two mod p, up to 31 bits at a time: x / 2^k =
// (x + m p) / 2^k with m = -x p^-1 mod 2^k (LH_N0INV), as a Montgomery
// reduction does a word, < p again
LH_DEV void words_halve_run(uint32_t* w, uint32_t* x) {
    while (!(w[0] & 1u)) {
        const int k = w[0] ? __ffs((int)w[0]) - 1 : 31;
#pragma unroll
        for (int i = 0; i < LH_W - 1; ++i)
            w[i] = __funnelshift_r(w[i], w[i + 1], k);
        w[LH_W - 1] >>= k;
        const uint32_t m = (x[0] * LH_N0INV) & ((1u << k) - 1u);
        uint32_t t[LH_W + 1];
        uint64_t acc = 0;
#pragma unroll
        for (int i = 0; i < LH_W; ++i) {
            acc = (uint64_t)m * LH_P[i] + x[i] + (acc >> 32);
            t[i] = (uint32_t)acc;
        }
        t[LH_W] = (uint32_t)(acc >> 32);
#pragma unroll
        for (int i = 0; i < LH_W; ++i)
            x[i] = __funnelshift_r(t[i], t[i + 1], k);
    }
}

// the Montgomery form of a^-1 (0 -> 0), a in [0, 2p): binary extended
// Euclid on the integer A = aR mod p (u = x1 A, v = x2 A mod p throughout),
// which gives A^-1 = a^-1 R^-1; then fp_mul by R^2 (LH_R2, in Montgomery
// form) gives a^-1 R. The value of a^(p-2) (the JAX package's Fermat
// inverse); one multiply where that power runs 608. Every step does the
// same work, so the lanes of a warp stay together (a lane branching its
// own way would make the warp issue every lane's path): u, v odd, the
// larger takes the difference (the pairs swapped so that it is u), then
// u's run of trailing zeros goes at once (words_halve_run); ~267 steps for
// a random a, at most ~300.
LH_DEV void fp_inv_binary(Fp& r, const Fp& a) {
    Fp u, v, x1, x2, r2;
    fp_canon(u, a);
    if (words_is_zero(u.w)) {
        fp_zero(r);
        return;
    }
    fp_set_const(v, LH_P);
    fp_zero(x1);
    x1.w[0] = 1;
    fp_zero(x2);
    words_halve_run(u.w, x1.w);
    while (!words_is_one(u.w) && !words_is_one(v.w)) {
        Fp d = u, e = x1;
        const uint32_t b = words_sub(d.w, d.w, v.w);   // u - v
        fp_int_sub(e.w, x2.w);                         // x1 - x2
        if (b) {                 // v > u: v - u, x2 - x1; u the smaller
            v = u;
            x2 = x1;
            Fp z;
            fp_zero(z);
            words_sub(d.w, z.w, d.w);
            fp_int_sub(z.w, e.w);
            e = z;
        }
        u = d;
        x1 = e;
        words_halve_run(u.w, x1.w);
    }
    fp_set_const(r2, LH_R2);
    const Fp inv = words_is_one(u.w) ? x1 : x2;
    fp_mul(r, inv, r2);
}

// the inverse, 0 -> 0, for every caller (affine conversion, fp2_inv):
// the binary extended Euclid, variable-time on public inputs
LH_DEV void fp_inv(Fp& r, const Fp& a) { fp_inv_binary(r, a); }

// the Legendre symbol (a / p) as 1, -1 or 0, by the binary Jacobi symbol
// algorithm on the integer aR mod p: R = 2^384 is a square, so (aR / p) =
// (a / p), the value of a^((p-1)/2)
LH_DEV int fp_legendre_binary(const Fp& a) {
    Fp x, n;
    fp_canon(x, a);
    fp_set_const(n, LH_P);
    int t = 1;
    while (!words_is_zero(x.w)) {
        while (!(x.w[0] & 1u)) {
            words_shr1(x.w, 0);
            const uint32_t m8 = n.w[0] & 7u;
            if (m8 == 3u || m8 == 5u) t = -t;
        }
        Fp d;
        if (words_sub(d.w, x.w, n.w)) {                // x < n: swap
            if ((x.w[0] & 3u) == 3u && (n.w[0] & 3u) == 3u) t = -t;
            words_sub(d.w, n.w, x.w);
            n = x;
        }
        x = d;                                        // even, or zero
    }
    return words_is_one(n.w) ? t : 0;
}

// the integer value in [0, p) (out of the Montgomery domain)
LH_DEV void fp_to_int(Fp& r, const Fp& a) {
    Fp one;
    fp_zero(one);
    one.w[0] = 1;
    fp_mul(r, a, one);
    fp_canon(r, r);
}

// lexicographic a > b on canonical integers
LH_DEV bool words_gt(const Fp& a, const uint32_t* b) {
    for (int i = LH_W - 1; i >= 0; --i) {
        if (a.w[i] != b[i]) return a.w[i] > b[i];
    }
    return false;
}

// ----------------------------------------------------------------- Fp2

LH_DEV void fp2_load(Fp2& r, const int32_t* limbs) {
    fp_load(r.c0, limbs);
    fp_load(r.c1, limbs + LH_LIMBS);
}

LH_DEV void fp2_store(int32_t* limbs, const Fp2& a) {
    fp_store(limbs, a.c0);
    fp_store(limbs + LH_LIMBS, a.c1);
}

LH_DEV void fp2_set_const(Fp2& r, const uint32_t (*c)[LH_W]) {
    fp_set_const(r.c0, c[0]);
    fp_set_const(r.c1, c[1]);
}

LH_DEV void fp2_zero(Fp2& r) { fp_zero(r.c0); fp_zero(r.c1); }
LH_DEV void fp2_one(Fp2& r) { fp_one(r.c0); fp_zero(r.c1); }

LH_DEV void fp2_add(Fp2& r, const Fp2& a, const Fp2& b) {
    fp_add(r.c0, a.c0, b.c0);
    fp_add(r.c1, a.c1, b.c1);
}

LH_DEV void fp2_sub(Fp2& r, const Fp2& a, const Fp2& b) {
    fp_sub(r.c0, a.c0, b.c0);
    fp_sub(r.c1, a.c1, b.c1);
}

LH_DEV void fp2_neg(Fp2& r, const Fp2& a) {
    fp_neg(r.c0, a.c0);
    fp_neg(r.c1, a.c1);
}

LH_DEV void fp2_dbl(Fp2& r, const Fp2& a) { fp2_add(r, a, a); }

LH_DEV void fp2_conj(Fp2& r, const Fp2& a) {
    r.c0 = a.c0;
    fp_neg(r.c1, a.c1);
}

// xi = 1 + u: (a0 - a1) + (a0 + a1) u
LH_DEV void fp2_mul_by_xi(Fp2& r, const Fp2& a) {
    Fp t0, t1;
    fp_sub(t0, a.c0, a.c1);
    fp_add(t1, a.c0, a.c1);
    r.c0 = t0;
    r.c1 = t1;
}

// Karatsuba, as fp2_mul_many: t0 = a0 b0, t1 = a1 b1,
// t2 = (a0 + a1)(b0 + b1); c0 = t0 - t1, c1 = t2 - t0 - t1
LH_NOINL void fp2_mul(Fp2& r, const Fp2& a, const Fp2& b) {
    Fp t0, t1, t2, sa, sb;
    fp_add(sa, a.c0, a.c1);
    fp_add(sb, b.c0, b.c1);
    fp_mul(t0, a.c0, b.c0);
    fp_mul(t1, a.c1, b.c1);
    fp_mul(t2, sa, sb);
    fp_sub(r.c0, t0, t1);
    fp_sub(t2, t2, t0);
    fp_sub(r.c1, t2, t1);
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 u
LH_NOINL void fp2_sqr(Fp2& r, const Fp2& a) {
    Fp s, d, t;
    fp_add(s, a.c0, a.c1);
    fp_sub(d, a.c0, a.c1);
    fp_mul(t, a.c0, a.c1);
    fp_mul(r.c0, s, d);
    fp_dbl(r.c1, t);
}

LH_DEV void fp2_mul_fp(Fp2& r, const Fp2& a, const Fp& s) {
    fp_mul(r.c0, a.c0, s);
    fp_mul(r.c1, a.c1, s);
}

LH_DEV bool fp2_is_zero(const Fp2& a) {
    return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

LH_DEV bool fp2_eq(const Fp2& a, const Fp2& b) {
    return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

LH_NOINL void fp2_inv(Fp2& r, const Fp2& a) {
    Fp s0, s1, n, ni;
    fp_sqr(s0, a.c0);
    fp_sqr(s1, a.c1);
    fp_add(n, s0, s1);
    fp_inv(ni, n);
    fp_mul(r.c0, a.c0, ni);
    fp_mul(s1, a.c1, ni);
    fp_neg(r.c1, s1);
}

// a^e, starting from a and skipping e's leading one (fp2_pow_const)
LH_NOINL void fp2_pow(Fp2& r, const Fp2& a, const uint32_t* e) {
    int top = 383;
    while (top > 0 && !((e[top >> 5] >> (top & 31)) & 1)) --top;
    Fp2 acc = a;
    for (int i = top - 1; i >= 0; --i) {
        fp2_sqr(acc, acc);
        if ((e[i >> 5] >> (i & 31)) & 1) fp2_mul(acc, acc, a);
    }
    r = acc;
}

// square in Fp2 iff the norm's Legendre symbol is not -1
LH_DEV bool fp2_is_square(const Fp2& a) {
    Fp s0, s1, n, leg, m1;
    fp_sqr(s0, a.c0);
    fp_sqr(s1, a.c1);
    fp_add(n, s0, s1);
    fp_pow(leg, n, LH_EXP_LEGENDRE);
    fp_one(m1);
    fp_neg(m1, m1);
    return !fp_eq(leg, m1);
}

// sqrt for p = 3 mod 4 (Adj-Rodriguez), as fp2_sqrt: y and ok
LH_NOINL bool fp2_sqrt(Fp2& y, const Fp2& a) {
    Fp2 a1, x0, alpha, b, bp, other, ix0, m1, one, y2;
    fp2_pow(a1, a, LH_EXP_SQRT);
    fp2_mul(x0, a1, a);
    fp2_mul(alpha, a1, x0);
    fp2_one(one);
    fp2_neg(m1, one);
    bool is_neg1 = fp2_eq(alpha, m1);
    fp_neg(ix0.c0, x0.c1);
    ix0.c1 = x0.c0;
    fp2_add(b, alpha, one);
    fp2_pow(bp, b, LH_EXP_LEGENDRE);
    fp2_mul(other, bp, x0);
    y = is_neg1 ? ix0 : other;
    fp2_sqr(y2, y);
    bool ok = fp2_eq(y2, a);
    if (fp2_is_zero(a)) {
        fp2_zero(y);
        ok = true;
    }
    return ok;
}

// RFC 9380 sgn0 of the integer values
LH_DEV int fp2_sgn0(const Fp2& a) {
    Fp c0, c1;
    fp_to_int(c0, a.c0);
    fp_to_int(c1, a.c1);
    uint32_t z0 = 0;
#pragma unroll
    for (int i = 0; i < LH_W; ++i) z0 |= c0.w[i];
    return z0 == 0 ? (int)(c1.w[0] & 1) : (int)(c0.w[0] & 1);
}
