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
or where the kernel takes another route to the same value (every
kernel's binary inversion, the Legendre symbol of ``final_exp`` and
``hash_to_g2``). Units: Fp products (an Fp2 product is 3, Karatsuba).
The affine conversion's bound is the least work of the function, not of
the kernel's algorithm (``affine_least``: one inverse for the whole call
by Montgomery's batch inversion); ``affine_int_ops`` counts the kernel's
own, an inverse a lane, whose word operations outweigh its products.

The lane-group kernels (rlc_scale, g2_intake on csrc/bls/coop.cuh
``lg_step``) run the programs of ``ops/bls_lane.py``: squares as two
products, a mixed addition (30 products over Fp2 where the point's z is
one, 44 for the general one), and each lane's own steps from its
scalar's top set bit on. ``scalar_mul_lanes``, ``g2_subgroup_lanes`` and
``g2_decompress_lanes`` count them from the programs' tables, with the
products and multiply rounds the groups issue (a step of n products is
ceil(n / G) rounds on G threads; a warp's groups run in step, so a warp
issues its longest group's, and rlc_scale's groups all add when one lane
does); ``scalar_mul`` and ``g2_subgroup`` keep the one-thread formulas'
counts, which the plain counter holds.

The latency-bound kernels also have a depth: the field multiplies on
their critical path, each step of the cooperative layer
(csrc/bls/coop.cuh) one multiply's latency however many products it runs
side by side (``final_exp_depth``, ``hash_to_g2_depth``,
``miller_loop_depth``, the top levels of ``g2_sum_depth``), a one-thread
G2 addition its 48 multiplies in series (the lower levels of
``g2_sum_depth``). The binary inversion and Legendre symbol add no
multiply to it; their time shows in the card's ms per level.
"""
from __future__ import annotations

from functools import lru_cache

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
#: the Fermat inverse a^(p-2) (the plain versions, as the JAX package)
FP_INV = _pow(P - 2, 1, 1)
FP2_INV = 2 + FP_INV + 2
FP6_INV = 3 * FP2_SQR + 9 * FP2_MUL + FP2_INV
FP12_INV = 4 * FP6_MUL + FP6_INV
FP2_SQRT = (_pow((P - 3) // 4, FP2_SQR, FP2_MUL)
            + _pow((P - 1) // 2, FP2_SQR, FP2_MUL) + 3 * FP2_MUL + FP2_SQR)
FP_LEGENDRE = _pow((P - 1) // 2, 1, 1)
FP2_IS_SQUARE = 2 + FP_LEGENDRE
#: the kernels' inversion (fp.cuh fp_inv, fp_inv_binary): a binary
#: extended Euclid on the integer (no field multiply; its word operations
#: are ``binary_inverse_word_ops``), then one product by R^2 back into the
#: Montgomery domain; and the cooperative kernels' Legendre symbol, a
#: binary Jacobi symbol (no field multiply)
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
#: the one-thread design of wide batches: fp_pow Legendre symbols and
#: the square root's check (its inverse is the binary one, as above)
HASH_TO_G2_LANE_SERIAL = HASH_TO_G2_LANE + 2 * (FP_LEGENDRE + FP2_SQR)
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
    """The L - 1 additions of each range of L lanes (the kernel's trees
    add no padding: a piece's tree w - 1, the partials' pieces - 1)."""
    _, length = k.segment_ranges(starts, ends)
    return int((length - 1).sum() * ADD[1])


def _levels(w: int) -> int:
    """The levels of a pairwise tree over w >= 1 slots: ceil(log2 w)."""
    return (int(w) - 1).bit_length()


def g1_segment_sum_depth(starts, ends) -> int:
    """The additions on the critical path of ``lh_g1_segment_sum``: the
    deepest range's, a range of L <= T lanes its tree's ceil(log2 L)
    levels; a longer one its full pieces' log2 T, then the fold of its
    pieces into min(pieces, T) slots (ceil(pieces / T) - 1 in series) and
    their tree (T the kernel's for the layout, ``g1_segment_t``). Each
    addition is a group's w_jac_add, W_JAC_ADD_DEPTH dependent
    multiplies."""
    t = k.g1_segment_t(len(starts), len(ends))
    _, length = k.segment_ranges(starts, ends)
    depth = 0
    for L in set(int(v) for v in length):
        pieces = -(-L // t)
        d = _levels(L) if pieces == 1 else (
            _levels(t) + -(-pieces // t) - 1 + _levels(min(pieces, t)))
        depth = max(depth, d)
    return depth


def g2_sum(n: int) -> int:
    """The n - 1 additions of n points (the kernel's tree adds no
    padding; the plain version's JAX layout pads rows with infinity and
    adds more)."""
    return max(0, n - 1) * ADD[2]


def affine(n: int, degree: int) -> int:
    """jac_to_affine's products: the binary inverse's one (in Fp2 the
    norm's two squares and two products around it), then Z^-2, X Z^-2,
    Z^-3 and Y Z^-3."""
    inv = FP_INV_BINARY if degree == 1 else FP2_INV_BINARY
    return n * (inv + 4 * (1 if degree == 1 else FP2_MUL))


#: word operations of the binary extended Euclid on 12-word integers
#: (fp.cuh fp_inv_binary): an addition or subtraction of two (one a word);
#: a run of up to 31 halvings (words_halve_run: a funnel shift a word of
#: w, m = -x p^-1 mod 2^k, m p + x as 12 multiply-adds of a low and a high
#: half, a funnel shift a word of the result). Loop tests and copies are
#: left out, so a count stays a lower bound.
WORD_ADD_OPS = 12
HALVE_RUN_OPS = 12 + 2 + 2 * 12 + 12
_P_INV_32 = (-pow(P, -1, 1 << 32)) % (1 << 32)


def _halve_run(w: int, x: int) -> tuple[int, int, int]:
    """words_halve_run: (w, x, its word operations)."""
    ops = 0
    while not w & 1:
        k = min((w & -w).bit_length() - 1, 31)
        m = (x * _P_INV_32) & ((1 << k) - 1)
        w, x = w >> k, (x + m * P) >> k
        ops += HALVE_RUN_OPS
    return w, x, ops


def binary_inverse_word_ops(a: int) -> int:
    """Word operations of fp_inv_binary on the integer ``a`` it runs its
    Euclid on (the canonical Montgomery representative, in [0, p)): a step
    subtracts v from u and x2 from x1 (adding p back on a borrow); where
    v > u it negates both (the pairs swap roles); then u's run of
    trailing zeros goes by halving runs."""
    if a % P == 0:
        return 0
    u, x1, ops = _halve_run(a % P, 1)
    v, x2 = P, 0
    while u != 1 and v != 1:
        d, e = u - v, x1 - x2
        ops += 2 * WORD_ADD_OPS + (WORD_ADD_OPS if e < 0 else 0)
        e %= P
        if d < 0:
            v, x2 = u, x1
            d = -d
            ops += 2 * WORD_ADD_OPS + (WORD_ADD_OPS if e else 0)
            e = (-e) % P
        u, x1, o = _halve_run(d, e)
        ops += o
    return ops


def _norms(z, degree: int) -> list[int]:
    """Each lane's z (Fp), or its norm c0^2 + c1^2 (Fp2): the value whose
    Fp inverse gives z's, canonical, from Montgomery limbs [n, 32] or [n,
    2, 32] (any representative)."""
    vals = k.fp_decode(z)
    if degree == 2:
        vals = [(c0 * c0 + c1 * c1) % P for c0, c1 in zip(vals[::2],
                                                          vals[1::2])]
    return vals


def affine_int_ops(z, degree: int) -> int:
    """Integer ops of ``lh_affine``'s own algorithm on Jacobian z
    coordinates ``z``: its products (``affine``) x FP_MUL_INT_OPS, and the
    Euclid's word operations on each lane's own input (the Montgomery form
    of its norm), which depend on the data. A diagnostic beside the bound
    (``affine_least``), as the Fermat count is."""
    vals = _norms(z, degree)
    euclid = sum(binary_inverse_word_ops(v * (1 << 384) % P) for v in vals)
    return affine(len(vals), degree) * FP_MUL_INT_OPS + euclid


def affine_least(z, degree: int) -> tuple[int, int]:
    """(Fp products, word operations) that converting these points needs
    at least, the bound's count: Montgomery's batch inversion over the m
    lanes whose z is not 0 (3 (m - 1) products of the field, one inverse:
    its products, and the Euclid's word operations on this data's one
    input, the Montgomery form of the lanes' product's norm), then each
    such lane's four products (Z^-2, X Z^-2, Z^-3, Y Z^-3). A lane at
    infinity needs none."""
    live = [v for v in _norms(z, degree) if v]
    if not live:
        return 0, 0
    norm = 1
    for v in live:
        norm = norm * v % P
    m, mul = len(live), 1 if degree == 1 else FP2_MUL
    inv = FP_INV_BINARY if degree == 1 else FP2_INV_BINARY
    return ((3 * (m - 1) + 4 * m) * mul + inv,
            binary_inverse_word_ops(norm * (1 << 384) % P))


def miller_loop(mask) -> int:
    return int(np.count_nonzero(np.asarray(mask)) * MILLER_LANE)


def fp12_pow(n: int, exponent: int) -> int:
    """fp12_pow, per lane: a general square (two Fp6 products, coop.cuh
    CO_SQR12) every bit below the top one, a product on the set ones but
    the lowest (the kernel walks from the bottom bit and copies the base
    there; the JAX scan from the top skips the leading one: the same
    counts)."""
    return n * _pow(exponent, FP12_SQR, FP12_MUL)


#: fp_ops (csrc/bls/fp_ops.cu), an element of each op: its field
#: multiplies, and the int32 limbs it must move (its inputs read once,
#: its [32] output written once): mul, add, sub (two [32] inputs), the
#: Montgomery entry (one [32], R^2 built in), the wide reduction (one
#: [64], R^2 and R^3 built in)
FP_OPS_MULS = (1, 0, 0, 1, 2)
FP_OPS_LIMBS = (96, 96, 96, 64, 96)


def fp_ops(op: int, n: int) -> tuple[int, int]:
    """(field multiplies, bytes) of one fp_ops launch of ``op`` on n
    elements: the function's least work."""
    return n * FP_OPS_MULS[op], n * FP_OPS_LIMBS[op] * 4


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


#: csrc/bls/aggregate.cu LH_G2_SUM_T: a block's threads, and the most
#: blocks (partials) of the first launch (past one block's points the sum
#: is two launches); LH_G2_SUM_WARP_ROUNDS: a tree level of at most this
#: many additions a warp gives each a warp in turn
G2_SUM_THREADS = 128
G2_SUM_WARP_ROUNDS = 4
#: w_jac_add (csrc/bls/coop.cuh): its 16 Fp2 products in 5 warp steps
W_JAC_ADD_DEPTH = 5


def _g2_tree_depth(w: int) -> int:
    """The tree over w slots of one block: a level of m additions is one
    thread's jac_add (ADD[2] dependent multiplies), or, when m is at most
    G2_SUM_WARP_ROUNDS a warp, ceil(m / warps) warp additions in turn."""
    warps, depth = G2_SUM_THREADS // 32, 0
    while w > 1:
        h = (w + 1) // 2
        m = w - h
        depth += (ADD[2] if m > G2_SUM_WARP_ROUNDS * warps
                  else -(-m // warps) * W_JAC_ADD_DEPTH)
        w = h
    return depth


def g2_sum_depth(n: int) -> int:
    """A thread's fold past 128^2 points (ADD[2] a point), the tree of
    block 0 (the fullest), then the tree of the partials."""
    t = G2_SUM_THREADS
    blocks = min(-(-n // t), t)
    fold = -(-n // (blocks * t)) - 1
    return (fold * ADD[2] + _g2_tree_depth(min(n, t))
            + _g2_tree_depth(blocks))


#: the cooperative Miller loop (csrc/bls/pairing.cu): T's four layers of
#: independent products a doubling and four an addition, one step each
#: (the line's scalings, f times the line and the next bit's f^2 ride in
#: them); the last doubling skips its fourth (T's y is never read) unless
#: an addition follows it
MILLER_COOP_DEPTH = (4 * _X_STEPS + 4 * (bin(k._X_ABS).count("1") - 1)
                     - (0 if k._X_ABS & 1 else 1))
#: csrc/bls/fp12_pow.cu LH_POW_SM_LANES: one lane a block up to this many
#: lanes an SM, two past it
POW_SM_LANES = 2


def fp12_pow_lanes(n: int, sms: int) -> int:
    """The lanes a block ``lh_fp12_pow`` takes for n lanes on a card of
    ``sms`` SMs."""
    return 1 if n <= POW_SM_LANES * sms else 2


def fp12_pow_depth(exponent: int) -> int:
    """fp12_pow's critical path in dependent steps: a cooperative step a
    bit of the exponent."""
    return _pow_depth(exponent)


#: csrc/bls/pairing.cu LH_ML_COOP_MAX: wider batches take the one-thread
#: design, whose chain is all of a lane's multiplies
ML_COOP_MAX = 2561


def miller_loop_pairs(n: int, live: int) -> int:
    """The pairs ``lh_miller_loop`` runs on for n pairs of which ``live``
    are unmasked: the live ones alone when n is past ML_COOP_MAX and they
    are within it (``bls12_381.miller_loop_batch``), else all n."""
    return live if live <= ML_COOP_MAX < n else n


def miller_loop_depth(n: int) -> int:
    """The critical path of ``lh_miller_loop`` on n pairs."""
    return MILLER_COOP_DEPTH if n <= ML_COOP_MAX else MILLER_LANE


def miller_loop_design(n: int) -> str:
    """The design ``lh_miller_loop`` picks for n pairs."""
    return ("a block a pair" if n <= ML_COOP_MAX else "a thread a pair")


# -- the lane-group kernels (csrc/bls/coop.cuh lg_step) --------------------

#: csrc/bls/rlc_scale.cu LH_RLC_G1_WIDTH / LH_RLC_G2_WIDTH and
#: g2_intake.cu LH_G2I_WIDTH: threads a lane
RLC_G1_WIDTH = 3
RLC_G2_WIDTH = 3
G2I_WIDTH = 3


@lru_cache(maxsize=None)
def lane_steps(layout: str, program: str) -> tuple:
    """The products of each step of a lane program (ops/bls_lane.py)."""
    from . import bls_lane
    lay = next(lay for lay in bls_lane.layouts() if lay.name == layout)
    prog = next(p for p in lay.programs if p.name == program)
    return tuple(len(s.jobs) for s in prog.steps)


def _run(layout: str, program: str, width: int) -> tuple[int, int]:
    """(products, multiply rounds on ``width`` threads) of one program."""
    steps = lane_steps(layout, program)
    return sum(steps), sum(-(-n // width) for n in steps)


def _issue(products, rounds, width: int) -> dict:
    """Per-lane products and rounds [n] of programs that every lane runs
    alike -> the batch's totals, the longest group, and the warps' rounds
    (each its longest group's: lanes of a warp are consecutive, 32 //
    width of them)."""
    products, rounds = np.asarray(products), np.asarray(rounds)
    per = 32 // width
    pad = (-rounds.size) % per
    warps = np.pad(rounds, (0, pad)).reshape(-1, per).max(axis=1)
    return {"products": int(products.sum()), "issued": int(products.sum()),
            "rounds": int(rounds.max(initial=0)),
            "warp_rounds": int(warps.sum()), "width": width,
            "lanes": int(products.size)}


def scalar_mul_lanes(bits, degree: int, z_one=True,
                     width: int | None = None) -> dict:
    """rlc_scale's lane groups on per-lane MSB-first bits [n, nbits].
    ``products``: each lane's own (the bound's count): from its top set
    bit, a doubling a bit and an addition (mixed where ``z_one``) on set
    bits. The groups of a warp run in step from the warp's first set bit,
    every group adding when one lane's bit is set: ``issued`` counts the
    products so run, ``warp_rounds`` their multiply rounds summed over the
    warps, ``rounds`` the longest warp's. The addition's doubling branch
    (P + P, which random scalars never meet) is not counted."""
    bits = np.asarray(bits) != 0
    n, nbits = bits.shape
    width = width or (RLC_G1_WIDTH if degree == 1 else RLC_G2_WIDTH)
    z_one = np.broadcast_to(np.asarray(z_one, bool), (n,))
    lay = f"RLC{degree}"
    dbl, madd, gadd = (_run(lay, p, width) for p in ("DBL", "MADD", "ADD"))
    ones = bits.sum(axis=1)
    first = np.where(ones > 0, bits.argmax(axis=1), nbits)
    own = (np.maximum(nbits - first - 1, 0) * dbl[0]
           + np.maximum(ones - 1, 0) * np.where(z_one, madd[0], gadd[0]))
    per = 32 // width
    pad = (-n) % per
    wb = np.pad(bits, ((0, pad), (0, 0))).reshape(-1, per, nbits)
    wz = np.pad(z_one, (0, pad), constant_values=True).reshape(-1, per)
    any_bit = wb.any(axis=1)                           # [warps, nbits]
    wfirst = np.where(any_bit.any(axis=1), any_bit.argmax(axis=1), nbits)
    after = np.arange(nbits)[None, :] > wfirst[:, None]
    n_dbl = np.maximum(nbits - wfirst - 1, 0)
    n_add = (any_bit & after).sum(axis=1)
    add_rounds = np.where(wz.all(axis=1), madd[1],
                          np.where(wz.any(axis=1), max(madd[1], gadd[1]),
                                   gadd[1]))
    rounds = n_dbl * dbl[1] + n_add * add_rounds
    issued = (n_dbl[:, None] * dbl[0] + n_add[:, None] * np.where(
        wz, madd[0], gadd[0]))[:, :per].reshape(-1)[:n]
    return {"products": int(own.sum()), "issued": int(issued.sum()),
            "rounds": int(rounds.max(initial=0)),
            "warp_rounds": int(rounds.sum()), "width": width, "lanes": n}


def g2_subgroup_lanes(z_one, z_is_zero, x_equal,
                      width: int = G2I_WIDTH) -> dict:
    """g2_intake's subgroup check: psi, [|x|]Q from its top bit (mixed
    additions where Q's z is one), the equality's first two steps unless a
    point is at infinity, its third when the x test passes."""
    z_one = np.asarray(z_one, bool)
    z_is_zero = np.asarray(z_is_zero, bool)
    x_equal = np.asarray(x_equal, bool)
    e = k._X_ABS
    n_dbl, n_add = e.bit_length() - 1, bin(e).count("1") - 1
    eq = lane_steps("SUB", "EQ")
    out = []
    for i in range(2):
        per_step = (lambda n: n) if i == 0 else (lambda n: -(-n // width))
        psi = sum(per_step(n) for n in lane_steps("SUB", "PSI"))
        mul = n_dbl * _run("SUB", "DBL", width)[i] + n_add * np.where(
            z_one, _run("SUB", "MADD", width)[i],
            _run("SUB", "ADD", width)[i])
        first = per_step(eq[0]) + per_step(eq[1])
        tail = np.where(z_is_zero, 0, first + np.where(
            x_equal, per_step(eq[2]), 0))
        out.append(psi + mul + tail)
    return _issue(*out, width)


def _pow_lane(e: int, width: int) -> tuple[int, int]:
    """A power walked from the bottom bit (the POW_* programs)."""
    top = e.bit_length() - 1
    prods = rounds = 0
    have = False
    for i in range(top + 1):
        bit = (e >> i) & 1
        name = ("POW_" + ("MUL" if have else "CPY") if i == top else
                "POW_" + ("MULSQ" if have else "CPYSQ") if bit else "POW_SQ")
        have = have or bool(bit)
        p, r = _run("DEC", name, width)
        prods, rounds = prods + p, rounds + r
    return prods, rounds


def g2_decompress_lanes(n: int, width: int = G2I_WIDTH) -> dict:
    """g2_intake's decompression: x^3 + b, the square root's two powers
    and its products, the root's square and its integer coefficients,
    the same on every lane."""
    prods = rounds = 0
    for name in ("CUBE", "X0", "ALPHA", "OTHER", "Y2", "INT"):
        p, r = _run("DEC", name, width)
        prods, rounds = prods + p, rounds + r
    for e in ((P - 3) // 4, (P - 1) // 2):
        p, r = _pow_lane(e, width)
        prods, rounds = prods + p, rounds + r
    return _issue(np.full(n, prods), np.full(n, rounds), width)
