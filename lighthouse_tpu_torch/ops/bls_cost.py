"""Field multiplies of the BLS kernels (csrc/bls/*.cu) on given inputs.

The op bound of a BLS kernel (``chip_smoke.py``) is its Montgomery products
times the integer ops of one. This module counts the products of each
kernel's own algorithm on the data it is given:

- a scalar multiply doubles on every bit and adds only on set bits;
- a Jacobian add computes its 16 products whatever its inputs, and takes
  its doubling fallback only when the two points are equal, which random
  scalars never meet: the fallback is not counted, so the count stays a
  lower bound;
- a Miller lane whose mask is 0 does nothing;
- a Jacobian equality stops after the x test when the x coordinates differ.

The plain versions count more on the same inputs (``MONT_MUL_ROWS``): they
are branch-free, as the JAX scans are, so they compute the add on every
bit and the doubling fallback inside every add, then select. Each cost
below is the kernel's formula; tests/test_torch_bls_kernel.py holds every
constant against the plain counter, naming the few places where the two
formulas square differently (the Fp6 inverse, the G2 affine conversion)
or where the kernel takes another route to the same value (the binary
inversion and Legendre symbol of ``final_exp`` and ``hash_to_g2``).
Units: Fp products (an Fp2 product is 3, Karatsuba).

The two thread-cooperative kernels (``final_exp``, ``hash_to_g2``) also
have a depth: the field multiplies on their critical path, each step of
the cooperative layer (csrc/bls/coop.cuh) one multiply's latency however
many products it runs side by side (``final_exp_depth``,
``hash_to_g2_depth``). The binary inversion and Legendre symbol add no
multiply to it; their time shows in the card's ms per level.
"""
from __future__ import annotations

import numpy as np

from . import bls12_381 as k

P = k.P_INT


def _pow(e: int, sqr: int, mul: int) -> int:
    """a^e from a, skipping e's leading one (fp_pow, fp2_pow)."""
    return (e.bit_length() - 1) * sqr + (bin(e).count("1") - 1) * mul


FP2_MUL, FP2_SQR, FP2_MUL_FP = 3, 2, 2
FP6_MUL = 6 * FP2_MUL
FP12_MUL = 3 * FP6_MUL
FP12_SQR = 2 * FP6_MUL
FP12_MUL_BY_014 = 15 * FP2_MUL
FP12_FROB = 6 * FP2_MUL
FP_INV = _pow(P - 2, 1, 1)
FP2_INV = 2 + FP_INV + 2
FP6_INV = 3 * FP2_SQR + 9 * FP2_MUL + FP2_INV
FP12_INV = 4 * FP6_MUL + FP6_INV
FP2_SQRT = (_pow((P - 3) // 4, FP2_SQR, FP2_MUL)
            + _pow((P - 1) // 2, FP2_SQR, FP2_MUL) + 3 * FP2_MUL + FP2_SQR)
FP_LEGENDRE = _pow((P - 1) // 2, 1, 1)
FP2_IS_SQUARE = 2 + FP_LEGENDRE
#: the cooperative kernels' inversion: a binary extended Euclid on the
#: integer (no field multiply), then one product by R^2 back into the
#: Montgomery domain; and their Legendre symbol, a binary Jacobi symbol
#: (no field multiply)
FP_INV_BINARY = 1
FP2_INV_BINARY = 2 + FP_INV_BINARY + 2
FP12_INV_BINARY = FP12_INV - FP_INV + FP_INV_BINARY
FP2_IS_SQUARE_BINARY = 2
#: Granger-Scott square of a cyclotomic Fp12: 9 Fp2 squares
FP12_CYC_SQR = 9 * FP2_SQR
FP2_TO_INT = 2                  # sgn0 and the lexicographic sign
#: Jacobian doubling and addition (without its fallback), by field degree
DBL = {1: 7, 2: 7 * FP2_MUL}
ADD = {1: 16, 2: 16 * FP2_MUL}
PSI = 2 * FP2_MUL
#: Miller loop: projective doubling and mixed addition steps, a line
#: scaled by P and multiplied into f
MILLER_DBL = 12 * FP2_MUL
MILLER_ADD = 13 * FP2_MUL
ELL = 2 * FP2_MUL_FP + FP12_MUL_BY_014
#: hash-to-G2 pieces (the square root's check y^2 == gx is left out:
#: the map never reads it)
H2C_G = FP2_SQR + 2 * FP2_MUL
SSWU = (2 * FP2_SQR + 3 * FP2_MUL + FP2_INV_BINARY + 2 * H2C_G
        + FP2_IS_SQUARE_BINARY + FP2_SQRT - FP2_SQR + 2 * FP2_TO_INT)
_ISO_HORNER = sum(len(k._H2C[n]) - (0 if n in ("XD", "YD") else 1)
                  for n in ("XN", "XD", "YN", "YD"))
ISO = (_ISO_HORNER + 7) * FP2_MUL + 2 * FP2_SQR
#: the final exponentiation's product: a pairwise tree over
#: FINAL_EXP_SLOTS slots, one a thread; past them thread t first folds
#: t, t + 256, ... into its slot with sequential Fp12 products
FINAL_EXP_SLOTS = 256
#: integer ops of one 12-word CIOS Montgomery product: 288 32x32->64-bit
#: multiply-adds (144 for a*b, 144 for m*p), each a low and a high half.
#: Additions and carries are left out, so a bound stays a lower bound.
#: The need of the function, so the bound of every multiply lowering.
FP_MUL_INT_OPS = 2 * 288


def _dp4a(columns: int, packs: int) -> int:
    """__dp4a's of a digit product: columns k < ``columns``, register i of
    the left operand (digits 4i..4i+3), wherever its partner pack
    k - 4i lies in 0..packs-1 (csrc/bls/fp.cuh)."""
    return sum(1 for k in range(columns) for i in range(16)
               if 0 <= k - 4 * i < packs)


def fp_mul_pipe_ops(mxu: int) -> dict[str, int]:
    """Integer ops of one field multiply as the kernels built for multiply
    lowering ``mxu`` issue it (csrc/bls/fp.cuh), by pipe: ``fma`` the
    word multiply-adds (IMAD, a low and a high half each) and the
    __dp4a's, ``alu`` the digit splits off a word (one each), a closed
    column of t and m (its digit and its carry), a column of the last
    product (its carry and the t digit it reads), an output digit packed,
    and in mode 1 one __byte_perm a reversed pack of b. ``issue`` is what
    bounds one thread's multiply at the 64-lane INT32 rate: the two pipes
    issue side by side, and all of the ops share the SM's issue slots (4
    schedulers x 32 lanes), so it is the largest of the two pipes' counts
    and half their sum. Carry adds inside the sums are left out, and
    mode 0's additions too: a lower bound of the lowering's own cost.

    This describes the algorithm, not the function: a bound (``chip_smoke``)
    charges every lowering the function's need, FP_MUL_INT_OPS."""
    if mxu == 0:
        fma, alu = FP_MUL_INT_OPS, 0
    elif mxu in (1, 2):
        m_fma, m_alu = _dp4a(64, 64), 2 * 64                 # m = t N' mod R
        r_fma, r_alu = _dp4a(128, 67), 2 * 128 + 64          # (t + m p) / R
        if mxu == 1:
            ab_fma, ab_alu = _dp4a(128, 67), 2 * 64 + 67 + 2 * 128
        else:
            ab_fma, ab_alu = 2 * 144, 128
        fma, alu = ab_fma + m_fma + r_fma, ab_alu + m_alu + r_alu
    else:
        raise ValueError(f"no multiply lowering {mxu}")
    return {"fma": fma, "alu": alu, "issue": max(fma, alu, -(-(fma + alu) // 2))}


def scalar_mul_const(scalar: int, degree: int) -> int:
    """jac_scalar_mul_const: from (x, y, 0), every bit from the top one."""
    return (scalar.bit_length() * DBL[degree]
            + bin(scalar).count("1") * ADD[degree])


CLEAR_COFACTOR = (scalar_mul_const(k._BP_K1, 2) + scalar_mul_const(k._BP_K2, 2)
                  + 3 * PSI + DBL[2] + 2 * ADD[2])
HASH_TO_G2_LANE = 2 * (SSWU + ISO) + ADD[2] + CLEAR_COFACTOR
#: the one-thread design of wide batches: fp_pow inverses and Legendre
#: symbols, and the square root's check
HASH_TO_G2_LANE_SERIAL = HASH_TO_G2_LANE + 2 * (
    FP_INV - FP_INV_BINARY + FP_LEGENDRE + FP2_SQR)
DECOMPRESS_LANE = FP2_SQR + FP2_MUL + FP2_SQRT + FP2_TO_INT
_X_STEPS = k._X_ABS.bit_length() - 1
MILLER_LANE = (_X_STEPS * (FP12_SQR + MILLER_DBL + ELL)
               + (bin(k._X_ABS).count("1") - 1) * (MILLER_ADD + ELL))
#: the final exponentiation: the easy part, then the x-chain (five
#: cyclotomic powers, by (|x|+1)/3 and four times by |x|, five products
#: and two Frobenius maps; ops/bls12_381.py _final_exponentiation_plain)
FINAL_EXP = (FP12_INV_BINARY + 2 * FP12_MUL + FP12_FROB
             + _pow(k._X13, FP12_CYC_SQR, FP12_MUL)
             + 4 * _pow(k._X_ABS, FP12_CYC_SQR, FP12_MUL)
             + 5 * FP12_MUL + 2 * FP12_FROB)


def g2_decompress(n: int) -> int:
    return n * DECOMPRESS_LANE


def g2_subgroup(z_is_zero, x_equal) -> int:
    """psi, [|x|]Q and the Jacobian equality, per lane: no products after
    an infinity test, 10 when the x test fails, 22 when it passes."""
    z_is_zero = np.asarray(z_is_zero, bool)
    x_equal = np.asarray(x_equal, bool)
    eq = np.where(z_is_zero, 0, np.where(x_equal, 10 + 4 * FP2_MUL, 10))
    return int(z_is_zero.size * (PSI + scalar_mul_const(k._X_ABS, 2))
               + eq.sum())


def hash_to_g2(n: int) -> int:
    """The cooperative design's products up to H2G_COOP_MAX messages, the
    one-thread design's past it."""
    return n * (HASH_TO_G2_LANE if n <= H2G_COOP_MAX
                else HASH_TO_G2_LANE_SERIAL)


def scalar_mul(bits, degree: int) -> int:
    """Per-lane MSB-first bits [n, nbits]: a doubling every bit, an add
    on every set bit."""
    bits = np.asarray(bits)
    return int(bits.size * DBL[degree] + np.count_nonzero(bits) * ADD[degree])


def g1_segment_sum(starts, ends) -> int:
    """Thread g adds the lanes after its segment's first up to ends[g]."""
    starts, ends = np.asarray(starts), np.asarray(ends)
    lanes = np.arange(starts.shape[0])
    first = np.maximum.accumulate(np.where(starts != 0, lanes, 0))
    return int((ends - first[ends]).sum() * ADD[1])


def g2_sum(n: int) -> int:
    """A column add per row of the [ceil(n/128), 128] layout, then the
    partials."""
    w = min(k.G2_SUM_WIDTH, max(1, n))
    rows = -(-n // w)
    return (w * rows + (w if w > 1 else 0)) * ADD[2]


def affine(n: int, degree: int) -> int:
    inv = FP_INV if degree == 1 else FP2_INV
    return n * (inv + 4 * (1 if degree == 1 else FP2_MUL))


def miller_loop(mask) -> int:
    return int(np.count_nonzero(np.asarray(mask)) * MILLER_LANE)


def fp12_pow(n: int, exponent: int) -> int:
    """fp12_pow: a square every bit after the leading one, a product on
    the set ones, per lane."""
    return n * _pow(exponent, FP12_SQR, FP12_MUL)


def final_exp(n: int, mode: int) -> int:
    """The product of n values (n - 1 products), and in mode 1 the final
    exponentiation."""
    return (n - 1) * FP12_MUL + (FINAL_EXP if mode == 1 else 0)


# -- critical-path depth of the cooperative kernels (dependent multiplies) --

def _pow_depth(e: int) -> int:
    """A power walked from the bottom bit (coop.cuh): each bit below the
    top one a step (the base squared, the product taken beside it on set
    bits), then the top bit's product."""
    return e.bit_length()


#: fp12_inv on the block: the two Fp6 squares, the Fp6 inverse's six
#: products and three, the norm, R^2 after the binary inverse, the two
#: products of the Fp2 inverse, its three, the two Fp6 products
FP12_INV_DEPTH = 8
#: the easy part (the inverse, conj(f) f^-1, frob2, the product), then the
#: x-chain: u = f^((|x|+1)/3), u^|x| u, a^|x| conj(frob1(a)) (the
#: Frobenius in the power's first step), two powers by |x| onto
#: frob2(b') conj(b') (both taken during the first power), the last
#: product
FINAL_EXP_DEPTH = (FP12_INV_DEPTH + 3 + _pow_depth(k._X13)
                   + 4 * _pow_depth(k._X_ABS) + 1)


def final_exp_depth(n: int, mode: int) -> int:
    """The product: a thread's fold of its values past the slots (a
    sequential Fp12 product is FP12_MUL dependent multiplies), then the
    tree's levels; mode 1 adds FINAL_EXP_DEPTH."""
    slots = min(n, FINAL_EXP_SLOTS)
    fold = (-(-n // FINAL_EXP_SLOTS) - 1) * FP12_MUL
    return fold + (slots - 1).bit_length() + (
        FINAL_EXP_DEPTH if mode == 1 else 0)


def _scalar_depth(scalar: int) -> int:
    """jac_scalar_mul_const on the warp: a doubling is 3 steps, an add 5."""
    return scalar.bit_length() * 3 + bin(scalar).count("1") * 5


#: one SSWU map: u^2, Z u^2, zu2^2; the inverse (norm, R^2, products);
#: x1; g(x1) and g(x2) in three steps with gx1's norm in the third; the
#: square root's two powers with x0, alpha and the root between; sgn0
SSWU_DEPTH = (3 + 3 + 1 + 3 + _pow_depth((P - 3) // 4) + 2
              + _pow_depth((P - 1) // 2) + 1 + 1)
#: the four Horner chains side by side (3 steps), then 4 steps
ISO_DEPTH = 7
#: u0 and u1 mapped at once (a warp each), their sum, then the longest
#: cofactor term ([k1]Q; [k2]Q, psi and psi^2([2]Q) run on the other
#: warp meanwhile), then the two adds
HASH_TO_G2_DEPTH = (SSWU_DEPTH + ISO_DEPTH + 5
                    + max(_scalar_depth(k._BP_K1),
                          _scalar_depth(k._BP_K2) + 1 + 3 + 2) + 2 * 5)
#: csrc/bls/hash_to_g2.cu LH_H2G_COOP_MAX: wider batches take the
#: one-thread design, whose chain is all of a lane's multiplies
H2G_COOP_MAX = 1024


def hash_to_g2_depth(n: int = 1) -> int:
    return HASH_TO_G2_DEPTH if n <= H2G_COOP_MAX else HASH_TO_G2_LANE_SERIAL
