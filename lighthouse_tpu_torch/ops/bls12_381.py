"""Batched BLS12-381 tower/curve/pairing stages on the card.

The port of ``lighthouse_tpu/ops/bls12_381.py``. Shapes (leading dims are
batch), as in the JAX package:

  Fp   [..., 32]          Fp2  [..., 2, 32]
  Fp6  [..., 3, 2, 32]    Fp12 [..., 2, 3, 2, 32]
  G1 Jacobian (x, y, z) of Fp;  G2 of Fp2.

Three layers:

- host helpers, plain numpy on Python ints: ``fp_encode``/``fp_decode``/
  ``fp2_encode``, ``scalars_to_bits``, ``hash_to_field_host``;
- plain PyTorch versions of the tower, the Jacobian point ops and every
  stage, copying the JAX formulas one for one (``_make_point_ops``, the
  Miller steps and ``_ell``, ``fp12_mul_by_014``, ``fp2_sqrt``,
  SSWU/iso, Budroni-Pintore), but for the final exponentiation's hard
  part, which follows the kernel's x-chain with cyclotomic squares (the
  JAX package's base-p scan gives the same value; the CPU tests hold the
  two equal). They run on any device on the plain field
  ops of ops/bigint.py; ``chip_smoke.py`` compares the kernels with them on
  the card;
- the stage wrappers (``g2_decompress_batch``, ``g2_in_subgroup_batch``,
  ``hash_to_g2_batch_from_u``, ``g1/g2_scalar_mul``, ``g1_segment_sum``,
  ``g2_sum``, ``jacobian_to_affine_fp{,2}``, ``miller_loop_batch``,
  ``fp12_product``, ``final_exponentiation``, ``pairing_check_batch``,
  ``fp12_pow_const``): a
  CUDA tensor launches the stage's kernel (csrc/bls/*.cu), a CPU tensor
  takes the plain version.

Two sums order their additions otherwise than the JAX package, so their
Jacobian outputs are the same points in other representatives (compare
them projectively): ``g1_segment_sum`` sums each range in pairwise trees
over pieces of T lanes (``g1_segment_t``; kernel and plain version alike,
in the same order; the JAX version is a log-depth segmented scan), and the
``g2_sum`` kernel adds in a pairwise tree whose order n alone fixes (its
plain version keeps the JAX row-then-partials order).
"""
from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls12_381.fields import P as P_INT, X_PARAM
from ..obs.cuda_accounting import host_readback
from ..obs.roofline import tensor_bytes, tracked
from . import bigint as bi

# ---------------------------------------------------------------------------
# host <-> device conversion (plain numpy on Python ints)
# ---------------------------------------------------------------------------

_R_INV = pow(bi.R_INT, -1, P_INT)


def fp_encode(vals) -> np.ndarray:
    """Python ints -> Montgomery limb batch [n, 32] (canonical digits)."""
    return bi.ints_to_limbs([(int(v) % P_INT) * bi.R_INT % P_INT
                             for v in vals])


def fp_decode(arr) -> list[int]:
    """Montgomery limbs [..., 32] -> Python ints in [0, p)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return [v * _R_INV % P_INT for v in bi.limbs_to_ints(arr)]


def fp2_encode(vals: list) -> np.ndarray:
    """List of python Fp2 -> [n, 2, 32]."""
    flat = []
    for v in vals:
        flat += [int(v.c0), int(v.c1)]
    return fp_encode(flat).reshape(len(vals), 2, bi.NLIMBS)


def fp_const(v: int) -> np.ndarray:
    return fp_encode([v])[0]


def fp2_const(c0: int, c1: int) -> np.ndarray:
    return fp_encode([c0, c1]).reshape(2, bi.NLIMBS)


def scalars_to_bits(scalars: list[int], nbits: int) -> np.ndarray:
    """Python ints in [0, 2^nbits) -> MSB-first bit matrix [n, nbits]
    int32 (vectorized over 64-bit words)."""
    out = np.zeros((len(scalars), nbits), dtype=np.int32)
    for w in range(0, nbits, 64):
        width = min(64, nbits - w)
        words = np.array([(s >> w) & ((1 << width) - 1) for s in scalars],
                         dtype=np.uint64)
        shifts = np.arange(width, dtype=np.uint64)
        bits = ((words[:, None] >> shifts) & np.uint64(1)).astype(np.int32)
        out[:, nbits - w - width:nbits - w] = bits[:, ::-1]
    return out


def hash_to_field_host(msgs: list[bytes], dst: bytes):
    """Host side of hash-to-G2: expand_message_xmd + limb encoding.
    Returns encoded (u0, u1) numpy arrays of shape [n, 2, 32]."""
    from ..crypto.bls12_381.hash_to_curve import expand_message_xmd
    u0s, u1s = [], []
    for m in msgs:
        uni = expand_message_xmd(m, dst, 256)
        vals = [int.from_bytes(uni[i * 64:(i + 1) * 64], "big") % P_INT
                for i in range(4)]
        u0s += vals[:2]
        u1s += vals[2:]
    n = len(msgs)
    return (fp_encode(u0s).reshape(n, 2, bi.NLIMBS),
            fp_encode(u1s).reshape(n, 2, bi.NLIMBS))


FP_ZERO = np.zeros(bi.NLIMBS, np.int32)
FP_ONE = fp_const(1)
FP2_ZERO = np.zeros((2, bi.NLIMBS), np.int32)
FP2_ONE = np.stack([FP_ONE, FP_ZERO])


def _c(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return bi.const(arr, like)


# ---------------------------------------------------------------------------
# Fp (plain field ops)
# ---------------------------------------------------------------------------

fp_add = bi._add_mod_plain
fp_sub = bi._sub_mod_plain
fp_mul = bi._mont_mul_plain


def fp_neg(a):
    return fp_sub(torch.zeros_like(a), a)


def fp_muln(a, k: int):
    """Multiply by a small integer via additions."""
    out = a
    for _ in range(k - 1):
        out = fp_add(out, a)
    return out


def fp_eq(a, b):
    return bi.eq_mod(a, b)


def fp_is_zero(a):
    return bi.is_zero_mod(a)


fp_to_int_limbs = bi.to_int_limbs_plain


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u^2+1); element [..., 2, 32]
# ---------------------------------------------------------------------------

fp2_add = fp_add
fp2_sub = fp_sub
fp2_neg = fp_neg


def _bcast_stack(items, dim):
    shape = np.broadcast_shapes(*[tuple(t.shape) for t in items])
    return torch.stack([t.expand(shape) for t in items], dim=dim)


def _fused(op, pairs):
    """[op(a, b) for (a, b) in pairs] in one call of the field op ``op``
    (add or sub): the operands stack on a new leading axis. The tower
    funnels independent additions through here as the JAX code funnels
    its products through one mont_mul (same values, fewer calls)."""
    n = len(pairs)
    A = _bcast_stack([a for a, _ in pairs] + [b for _, b in pairs], 0)
    out = op(A[:n], A[n:])
    return [out[i] for i in range(n)]


def fp2_mul_many(A, B):
    """Elementwise Fp2 products over a stacked axis: A, B [..., k, 2, 32];
    all 3k Karatsuba Fp products in one mont_mul."""
    A, B = torch.broadcast_tensors(A, B)
    a0, a1 = A[..., 0, :], A[..., 1, :]
    b0, b1 = B[..., 0, :], B[..., 1, :]
    sa, sb = _fused(fp_add, [(a0, a1), (b0, b1)])
    lhs = torch.cat([a0, a1, sa], dim=-2)
    rhs = torch.cat([b0, b1, sb], dim=-2)
    t = fp_mul(lhs, rhs)
    k = A.shape[-3]
    t0, t1, t2 = t[..., :k, :], t[..., k:2 * k, :], t[..., 2 * k:, :]
    c0, d = _fused(fp_sub, [(t0, t1), (t2, t0)])
    c1 = fp_sub(d, t1)
    return torch.stack([c0, c1], dim=-2)


def _fp2_products(pairs):
    """[(a, b), ...] of broadcast-compatible [..., 2, 32] operands ->
    products, one fused mont_mul for all of them."""
    A = _bcast_stack([a for a, _ in pairs] + [b for _, b in pairs], -3)
    n = len(pairs)
    out = fp2_mul_many(A[..., :n, :, :], A[..., n:, :, :])
    return [out[..., i, :, :] for i in range(n)]


def _fp_products(pairs):
    """Same fusion for raw Fp operands [..., 32]."""
    A = _bcast_stack([a for a, _ in pairs] + [b for _, b in pairs], -2)
    n = len(pairs)
    out = fp_mul(A[..., :n, :], A[..., n:, :])
    return [out[..., i, :] for i in range(n)]


def fp2_mul(a, b):
    return fp2_mul_many(a[..., None, :, :], b[..., None, :, :])[..., 0, :, :]


def fp2_square(a):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    lhs = torch.stack([fp_add(a0, a1), a0], dim=-2)
    rhs = torch.stack([fp_sub(a0, a1), a1], dim=-2)
    t = fp_mul(lhs, rhs)
    return torch.stack([t[..., 0, :], fp_muln(t[..., 1, :], 2)], dim=-2)


def fp2_muln(a, k: int):
    out = a
    for _ in range(k - 1):
        out = fp2_add(out, a)
    return out


def fp2_conj(a):
    return torch.stack([a[..., 0, :], fp_neg(a[..., 1, :])], dim=-2)


def fp2_mul_by_xi(a):
    """xi = 1 + u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([fp_sub(a0, a1), fp_add(a0, a1)], dim=-2)


def fp2_eq(a, b):
    return fp_eq(a[..., 0, :], b[..., 0, :]) & fp_eq(a[..., 1, :],
                                                      b[..., 1, :])


def fp2_is_zero(a):
    return fp_is_zero(a[..., 0, :]) & fp_is_zero(a[..., 1, :])


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - xi); element [..., 3, 2, 32]
# ---------------------------------------------------------------------------

def _f6(c0, c1, c2):
    return torch.stack([c0, c1, c2], dim=-3)


fp6_add = fp_add
fp6_sub = fp_sub
fp6_neg = fp_neg


def fp6_mul_many(A, B):
    """Elementwise Fp6 products over a stacked axis [..., k, 3, 2, 32]:
    6k Fp2 products (Karatsuba-3) in one call."""
    A, B = torch.broadcast_tensors(A, B)
    a0, a1, a2 = A[..., 0, :, :], A[..., 1, :, :], A[..., 2, :, :]
    b0, b1, b2 = B[..., 0, :, :], B[..., 1, :, :], B[..., 2, :, :]
    a12, a01, a02, b12, b01, b02 = _fused(fp2_add, [
        (a1, a2), (a0, a1), (a0, a2), (b1, b2), (b0, b1), (b0, b2)])
    L = torch.cat([a0, a1, a2, a12, a01, a02], dim=-3)
    R = torch.cat([b0, b1, b2, b12, b01, b02], dim=-3)
    t = fp2_mul_many(L, R)
    k = A.shape[-4]
    t0, t1, t2 = t[..., :k, :, :], t[..., k:2*k, :, :], t[..., 2*k:3*k, :, :]
    u12, u01, u02 = (t[..., 3*k:4*k, :, :], t[..., 4*k:5*k, :, :],
                     t[..., 5*k:, :, :])
    # c0 = xi (u12 - t1 - t2) + t0, c1 = (u01 - t0 - t1) + xi t2,
    # c2 = (u02 - t0 - t2) + t1
    d0, d1, d2 = _fused(fp2_sub, [(u12, t1), (u01, t0), (u02, t0)])
    d0, d1, d2 = _fused(fp2_sub, [(d0, t2), (d1, t1), (d2, t2)])
    x = fp2_mul_by_xi(torch.stack([d0, t2]))
    c0, c1, c2 = _fused(fp2_add, [(x[0], t0), (d1, x[1]), (d2, t1)])
    return torch.stack([c0, c1, c2], dim=-3)


def fp6_mul(a, b):
    return fp6_mul_many(a[..., None, :, :, :],
                        b[..., None, :, :, :])[..., 0, :, :, :]


def fp6_mul_by_v(a):
    return _f6(fp2_mul_by_xi(a[..., 2, :, :]), a[..., 0, :, :],
               a[..., 1, :, :])


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v); element [..., 2, 3, 2, 32]
# ---------------------------------------------------------------------------

def _f12(c0, c1):
    return torch.stack([c0, c1], dim=-4)


def fp12_one_like(batch_shape, like: torch.Tensor) -> torch.Tensor:
    one = torch.zeros(tuple(batch_shape) + (2, 3, 2, bi.NLIMBS),
                      dtype=torch.int32, device=like.device)
    one[..., 0, 0, :, :] = _c(FP2_ONE, like)
    return one


def fp12_mul_many(A, B):
    """Elementwise Fp12 products over a stacked axis [..., k, 2, 3, 2, 32]
    — 3k Fp6 (54k Fp) products in one call."""
    A, B = torch.broadcast_tensors(A, B)
    a0, a1 = A[..., 0, :, :, :], A[..., 1, :, :, :]
    b0, b1 = B[..., 0, :, :, :], B[..., 1, :, :, :]
    sa, sb = _fused(fp6_add, [(a0, a1), (b0, b1)])
    L = torch.cat([a0, a1, sa], dim=-4)
    R = torch.cat([b0, b1, sb], dim=-4)
    t = fp6_mul_many(L, R)
    k = A.shape[-5]
    t0, t1, tm = (t[..., :k, :, :, :], t[..., k:2 * k, :, :, :],
                  t[..., 2 * k:, :, :, :])
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(tm, t0), t1)
    return torch.stack([c0, c1], dim=-4)


def _fp12_products(pairs):
    A = _bcast_stack([a for a, _ in pairs] + [b for _, b in pairs], -5)
    n = len(pairs)
    out = fp12_mul_many(A[..., :n, :, :, :, :], A[..., n:, :, :, :, :])
    return [out[..., i, :, :, :, :] for i in range(n)]


def fp12_mul(a, b):
    return fp12_mul_many(a[..., None, :, :, :, :],
                         b[..., None, :, :, :, :])[..., 0, :, :, :, :]


def fp12_square(a):
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    s01, s0v = _fused(fp6_add, [(a0, a1), (a0, fp6_mul_by_v(a1))])
    A = torch.stack([a0, s01], dim=-4)
    B = torch.stack([a1, s0v], dim=-4)
    ts = fp6_mul_many(A, B)
    t, s = ts[..., 0, :, :, :], ts[..., 1, :, :, :]
    c0 = fp6_sub(fp6_sub(s, t), fp6_mul_by_v(t))
    return _f12(c0, fp6_add(t, t))


def fp12_conj(a):
    return _f12(a[..., 0, :, :, :], fp6_neg(a[..., 1, :, :, :]))


def fp12_mul_by_014(f, c0, c1, c4):
    """Sparse multiply by g = (c0 + c1 v) + (c4 v) w — the Miller line
    shape: 15 Fp2 products in one fused call."""
    x0, x1, x2 = f[..., 0, 0, :, :], f[..., 0, 1, :, :], f[..., 0, 2, :, :]
    y0, y1, y2 = f[..., 1, 0, :, :], f[..., 1, 1, :, :], f[..., 1, 2, :, :]
    w0, w1, w2, c14 = _fused(fp2_add, [(x0, y0), (x1, y1), (x2, y2),
                                       (c1, c4)])
    (p1, p2, p3, p4, p5, p6,
     q0, q1, q2,
     r1, r2, r3, r4, r5, r6) = _fp2_products([
         (x0, c0), (x2, c1), (x0, c1), (x1, c0), (x1, c1), (x2, c0),
         (y0, c4), (y1, c4), (y2, c4),
         (w0, c0), (w2, c14), (w0, c14), (w1, c0), (w1, c14), (w2, c0)])
    xp2, xq2, xr2, xq1 = fp2_mul_by_xi(torch.stack([p2, q2, r2, q1]))
    # t0 = f0*g0,  t1 = f1*g1 = (xi*q2, q0, q1),  u = (f0+f1)*(g0+g1)
    t00, t01, t02, u0, u1, u2 = _fused(fp2_add, [
        (p1, xp2), (p3, p4), (p5, p6), (r1, xr2), (r3, r4), (r5, r6)])
    t1 = (xq2, q0, q1)
    # out0 = t0 + v*t1;  v*(e0,e1,e2) = (xi*e2, e0, e1)
    o00, o01, o02 = _fused(fp2_add, [(t00, xq1), (t01, t1[0]),
                                     (t02, t1[1])])
    e0, e1, e2 = _fused(fp2_sub, [(u0, t00), (u1, t01), (u2, t02)])
    o10, o11, o12 = _fused(fp2_sub, [(e0, t1[0]), (e1, t1[1]),
                                     (e2, t1[2])])
    return _f12(_f6(o00, o01, o02), _f6(o10, o11, o12))


def fp12_eq(a, b):
    return torch.all(
        fp_eq(a.reshape(a.shape[:-4] + (12, bi.NLIMBS)),
              b.reshape(b.shape[:-4] + (12, bi.NLIMBS))), dim=-1)


# ---------------------------------------------------------------------------
# inversion / exponentiation (square-and-multiply over a constant's bits)
# ---------------------------------------------------------------------------

def _bits(exponent: int) -> list[int]:
    return [int(b) for b in bin(exponent)[2:]]


def _pow_const(a, exponent: int, square, mul):
    """a^exponent from a, over the bits after the leading one: square,
    then multiply by a where the bit is set (exponent 0 gives a, as the
    JAX scans do; the exponent is one constant for all lanes, so the unset
    bits skip the product the JAX scans compute and discard)."""
    out = a
    for bit in _bits(exponent)[1:]:
        out = square(out)
        if bit:
            out = mul(out, a)
    return out


def fp_pow_const(a, exponent: int):
    return _pow_const(a, exponent, lambda x: fp_mul(x, x), fp_mul)


def fp_inv(a):
    return fp_pow_const(a, P_INT - 2)


def fp2_inv(a):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    s0, s1 = _fp_products([(a0, a0), (a1, a1)])
    ninv = fp_inv(fp_add(s0, s1))
    p0, p1 = _fp_products([(a0, ninv), (a1, ninv)])
    return torch.stack([p0, fp_neg(p1)], dim=-2)


def fp6_inv(a):
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    s00, s12, s22, s01, s11, s02 = _fp2_products([
        (a0, a0), (a1, a2), (a2, a2), (a0, a1), (a1, a1), (a0, a2)])
    t0 = fp2_sub(s00, fp2_mul_by_xi(s12))
    t1 = fp2_sub(fp2_mul_by_xi(s22), s01)
    t2 = fp2_sub(s11, s02)
    d0, d1, d2 = _fp2_products([(a0, t0), (a2, t1), (a1, t2)])
    denom = fp2_add(d0, fp2_add(fp2_mul_by_xi(d1), fp2_mul_by_xi(d2)))
    dinv = fp2_inv(denom)
    o0, o1, o2 = _fp2_products([(t0, dinv), (t1, dinv), (t2, dinv)])
    return _f6(o0, o1, o2)


def fp12_inv(a):
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    st = torch.stack([a0, a1], dim=-4)
    sq = fp6_mul_many(st, st)
    t = fp6_inv(fp6_sub(sq[..., 0, :, :, :],
                        fp6_mul_by_v(sq[..., 1, :, :, :])))
    ot = fp6_mul_many(st, torch.stack([t, t], dim=-4))
    return _f12(ot[..., 0, :, :, :], fp6_neg(ot[..., 1, :, :, :]))


def _fp12_pow_const_plain(f, exponent: int):
    """f^exponent as the JAX ``fp12_pow_const`` scan."""
    return _pow_const(f, exponent, fp12_square, fp12_mul)


def fp2_pow_const(a, exponent: int):
    return _pow_const(a, exponent, fp2_square, fp2_mul)


# ---------------------------------------------------------------------------
# G1 / G2 Jacobian point ops (infinity <=> z == 0)
# ---------------------------------------------------------------------------

def _make_point_ops(add_, sub_, muln_, is_zero_, where_nd, products_):
    """Jacobian point ops over Fp or Fp2, the JAX formulas one for one
    (independent field products fused per dependency layer)."""

    def dbl(x, y, z):
        A, B, yz = products_([(x, x), (y, y), (y, z)])
        E = muln_(A, 3)
        xB = add_(x, B)
        C, t, F = products_([(B, B), (xB, xB), (E, E)])
        D = muln_(sub_(sub_(t, A), C), 2)
        X3 = sub_(F, muln_(D, 2))
        (EDX,) = products_([(E, sub_(D, X3))])
        Y3 = sub_(EDX, muln_(C, 8))
        Z3 = muln_(yz, 2)
        return X3, Y3, Z3

    def add(x1, y1, z1, x2, y2, z2):
        inf1 = is_zero_(z1)
        inf2 = is_zero_(z2)
        z12 = add_(z1, z2)
        Z1Z1, Z2Z2, zz = products_([(z1, z1), (z2, z2), (z12, z12)])
        U1, U2, z2c, z1c = products_([(x1, Z2Z2), (x2, Z1Z1),
                                      (z2, Z2Z2), (z1, Z1Z1)])
        H = sub_(U2, U1)
        H2 = muln_(H, 2)
        S1, S2, I = products_([(y1, z2c), (y2, z1c), (H2, H2)])
        same_x = is_zero_(H)
        dS = sub_(S2, S1)
        same_y = is_zero_(dS)
        rr = muln_(dS, 2)
        J, V, rr2 = products_([(H, I), (U1, I), (rr, rr)])
        X3 = sub_(sub_(rr2, J), muln_(V, 2))
        rVX, S1J, Z3 = products_([(rr, sub_(V, X3)), (S1, J),
                                  (sub_(sub_(zz, Z1Z1), Z2Z2), H)])
        Y3 = sub_(rVX, muln_(S1J, 2))
        dx, dy, dz = dbl(x1, y1, z1)
        use_dbl = same_x & same_y & ~inf1 & ~inf2
        to_inf = same_x & ~same_y & ~inf1 & ~inf2
        X3 = where_nd(use_dbl, dx, X3)
        Y3 = where_nd(use_dbl, dy, Y3)
        Z3 = where_nd(use_dbl, dz, Z3)
        Z3 = where_nd(to_inf, torch.zeros_like(Z3), Z3)
        X3 = where_nd(inf1, x2, X3)
        Y3 = where_nd(inf1, y2, Y3)
        Z3 = where_nd(inf1, z2, Z3)
        X3 = where_nd(inf2 & ~inf1, x1, X3)
        Y3 = where_nd(inf2 & ~inf1, y1, Y3)
        Z3 = where_nd(inf2 & ~inf1, z1, Z3)
        return X3, Y3, Z3

    def scalar_mul(x, y, z, bits):
        """Per-element scalars as a bit matrix [n, nbits] (MSB-first, 0/1):
        double, add, select the sum on set bits."""
        bits = torch.as_tensor(bits, device=x.device)
        ax, ay, az = (torch.zeros_like(x), torch.zeros_like(y),
                      torch.zeros_like(z))
        for j in range(bits.shape[-1]):
            ax, ay, az = dbl(ax, ay, az)
            sx, sy, sz = add(ax, ay, az, x, y, z)
            use = bits[..., j] != 0
            ax = where_nd(use, sx, ax)
            ay = where_nd(use, sy, ay)
            az = where_nd(use, sz, az)
        return ax, ay, az

    def scalar_mul_const(x, y, z, k: int):
        """Shared constant scalar (cofactor clearing, subgroup checks):
        as the JAX scan, start from (x, y, 0) (infinity) and run every bit
        of k, adding P on set bits."""
        ax, ay, az = x, y, torch.zeros_like(z)
        for bit in _bits(k):
            ax, ay, az = dbl(ax, ay, az)
            if bit:
                ax, ay, az = add(ax, ay, az, x, y, z)
        return ax, ay, az

    return dbl, add, scalar_mul, scalar_mul_const


def _where_fp(cond, a, b):
    return torch.where(cond[..., None], a, b)


def _where_fp2(cond, a, b):
    return torch.where(cond[..., None, None], a, b)


g1_dbl, g1_add, _g1_scalar_mul_plain, g1_scalar_mul_const = _make_point_ops(
    fp_add, fp_sub, fp_muln, fp_is_zero, _where_fp, _fp_products)

g2_dbl, g2_add, _g2_scalar_mul_plain, g2_scalar_mul_const = _make_point_ops(
    fp2_add, fp2_sub, fp2_muln, fp2_is_zero, _where_fp2, _fp2_products)


#: csrc/bls/aggregate.cu LH_SEG_T_SHORT, LH_SEG_T_LONG: the lanes of a
#: piece of a segment sum, short where its ranges average at most that
#: many lanes
G1_SEGMENT_T = (32, 128)


def g1_segment_t(n: int, g: int) -> int:
    """The piece of a segment sum of n lanes into g ranges, as
    aggregate.cu seg_piece_lanes picks it."""
    short, long_ = G1_SEGMENT_T
    return short if n <= short * g else long_


def _host_ints(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v).astype(np.int64).reshape(-1)


def segment_ranges(starts, ends) -> tuple[np.ndarray, np.ndarray]:
    """(first, length) of each range of a segment sum, host int64: range g
    runs from the last lane at or before ends[g] whose start flag is set
    (lane 0 if none) to ends[g]."""
    starts, ends = _host_ints(starts), _host_ints(ends)
    lanes = np.arange(starts.shape[0])
    seg = np.maximum.accumulate(np.where(starts != 0, lanes, 0))
    first = seg[ends] if ends.size else ends
    return first, ends - first + 1


def _tree_sums(x, y, z, base, width):
    """Pairwise trees over the runs [base[p], base[p] + width[p]) of the
    slots (x, y, z) [S, 32], a level at a time over all runs, in place:
    each level slot i of a run takes slot i + ceil(w / 2). Leaves each
    run's sum at its base."""
    w = np.asarray(width, np.int64).copy()
    base = np.asarray(base, np.int64)
    while True:
        h = (w + 1) // 2
        m = w - h
        total = int(m.sum())
        if total == 0:
            return
        run = np.repeat(np.arange(w.size), m)
        li = np.arange(total) - np.repeat(np.cumsum(m) - m, m)
        dst = torch.from_numpy(base[run] + li).to(x.device)
        src = torch.from_numpy(base[run] + li + h[run]).to(x.device)
        sx, sy, sz = g1_add(x[dst], y[dst], z[dst], x[src], y[src], z[src])
        x[dst], y[dst], z[dst] = sx, sy, sz
        w = h


def _g1_segment_sum_plain(x, y, z, starts, ends):
    """Per-range Jacobian G1 sums (``segment_ranges``) in the kernel's
    order: each range cut into pieces of T lanes (``g1_segment_t``) from
    its first lane, a pairwise tree over each piece; a range of more
    pieces then folds its pieces' sums into min(pieces, T) slots (slot s
    takes pieces s, s + S, ... in turn) and takes a tree over them.
    Vectorised a level at a time over all pieces, then over the long
    ranges."""
    t = g1_segment_t(x.shape[0], len(ends))
    first, length = segment_ranges(starts, ends)
    n_out = first.shape[0]
    pieces = -(-length // t)
    rng = np.repeat(np.arange(n_out), pieces)
    j = np.arange(rng.size) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    width = np.minimum(t, length[rng] - j * t)
    base = np.cumsum(width) - width
    lanes = np.repeat(first[rng] + j * t - base, width) + np.arange(
        int(width.sum()))
    idx = torch.from_numpy(lanes).to(x.device)
    sx, sy, sz = x[idx], y[idx], z[idx]
    _tree_sums(sx, sy, sz, base, width)
    # each range's first piece's sum; the long ranges' sums replace theirs
    head = base[np.cumsum(pieces) - pieces]
    at_head = torch.from_numpy(head).to(x.device)
    ox, oy, oz = sx[at_head], sy[at_head], sz[at_head]
    longs = np.flatnonzero(pieces > 1)
    if longs.size:
        slots = np.minimum(pieces[longs], t)
        sbase = np.cumsum(slots) - slots
        owner = np.repeat(np.arange(longs.size), slots)
        s_of = np.arange(int(slots.sum())) - np.repeat(sbase, slots)

        def piece_slot(i, q):
            """The slot of piece q of long range i (its pieces but the
            last are T wide)."""
            return head[longs[i]] + q * t

        pick = torch.from_numpy(piece_slot(owner, s_of)).to(x.device)
        ax, ay, az = sx[pick], sy[pick], sz[pick]
        step = 1
        while True:
            q = s_of + step * slots[owner]
            live = np.flatnonzero(q < pieces[longs][owner])
            if live.size == 0:
                break
            d = torch.from_numpy(live).to(x.device)
            sl = torch.from_numpy(piece_slot(owner[live], q[live])).to(
                x.device)
            rx, ry, rz = g1_add(ax[d], ay[d], az[d], sx[sl], sy[sl], sz[sl])
            ax[d], ay[d], az[d] = rx, ry, rz
            step += 1
        _tree_sums(ax, ay, az, sbase, slots)
        at = torch.from_numpy(longs).to(x.device)
        top = torch.from_numpy(sbase).to(x.device)
        ox[at], oy[at], oz[at] = ax[top], ay[top], az[top]
    return ox, oy, oz


def _jacobian_to_affine_fp2_plain(x, y, z):
    zi = fp2_inv(z)
    zi2 = fp2_square(zi)
    return fp2_mul(x, zi2), fp2_mul(y, fp2_mul(zi2, zi))


def _jacobian_to_affine_fp_plain(x, y, z):
    zi = fp_inv(z)
    zi2 = fp_mul(zi, zi)
    return fp_mul(x, zi2), fp_mul(y, fp_mul(zi2, zi))


G2_SUM_WIDTH = 128


def _g2_sum_rows(x, y, z):
    """Row-wise Jacobian sum: [m, w, 2, 32] -> [w, 2, 32], starting from
    infinity (1, 1, 0) and adding row after row."""
    one = _c(FP2_ONE, x).expand(x.shape[1:])
    acc = (one.clone(), one.clone(), torch.zeros_like(z[0]))
    for r in range(x.shape[0]):
        acc = g2_add(*acc, x[r], y[r], z[r])
    return acc


def _g2_sum_plain(x, y, z):
    """Aggregate n Jacobian points, in the JAX order: pad with infinity to
    a multiple of the width (128, or n when smaller), sum the rows
    (vectorized across the width), then sum the partials."""
    n = x.shape[0]
    w = min(G2_SUM_WIDTH, max(1, n))
    m = -(-n // w)
    pad = m * w - n
    if pad:
        one = _c(FP2_ONE, x).expand((pad,) + x.shape[1:])
        x = torch.cat([x, one], dim=0)
        y = torch.cat([y, one], dim=0)
        z = torch.cat([z, torch.zeros((pad,) + z.shape[1:], dtype=z.dtype,
                                      device=z.device)], dim=0)
    shape = (m, w) + x.shape[1:]
    px, py, pz = _g2_sum_rows(x.reshape(shape), y.reshape(shape),
                              z.reshape(shape))
    if w == 1:
        return px[0], py[0], pz[0]
    fx, fy, fz = _g2_sum_rows(px[:, None], py[:, None], pz[:, None])
    return fx[0], fy[0], fz[0]


# ---------------------------------------------------------------------------
# Miller loop (batched pairs) + final exponentiation
# ---------------------------------------------------------------------------

_X_ABS = abs(X_PARAM)
_X_BITS = _bits(_X_ABS)
_TWO_INV = fp_const(pow(2, P_INT - 2, P_INT))
_B_TWIST_3 = fp2_const(12, 12)  # 3 * (4 + 4u)


def _miller_dbl_step(tx, ty, tz, two_inv):
    """Projective doubling + line coefficients."""
    half = torch.stack([two_inv, torch.zeros_like(two_inv)], dim=-2)
    b3 = _c(_B_TWIST_3, tx)
    b, c, j, u, txty = _fp2_products([
        (ty, ty), (tz, tz), (tx, tx), (fp2_add(ty, tz), fp2_add(ty, tz)),
        (tx, ty)])
    h = fp2_sub(u, fp2_add(b, c))
    a, e = _fp2_products([(txty, half), (c, b3)])
    f = fp2_muln(e, 3)
    i = fp2_sub(e, b)
    g, nx, nz = _fp2_products([
        (fp2_add(b, f), half), (a, fp2_sub(b, f)), (b, h)])
    gg, ee = _fp2_products([(g, g), (e, e)])
    ny = fp2_sub(gg, fp2_muln(ee, 3))
    return (nx, ny, nz), (i, fp2_muln(j, 3), fp2_neg(h))


def _miller_add_step(tx, ty, tz, qx, qy):
    """Mixed addition + line coefficients."""
    qyz, qxz = _fp2_products([(qy, tz), (qx, tz)])
    theta = fp2_sub(ty, qyz)
    lam = fp2_sub(tx, qxz)
    c, d, tqx, lqy = _fp2_products([
        (theta, theta), (lam, lam), (theta, qx), (lam, qy)])
    e, f, g = _fp2_products([(lam, d), (tz, c), (tx, d)])
    h = fp2_sub(fp2_add(e, f), fp2_muln(g, 2))
    nx, tgh, ety, nz = _fp2_products([
        (lam, h), (theta, fp2_sub(g, h)), (e, ty), (tz, e)])
    ny = fp2_sub(tgh, ety)
    j = fp2_sub(tqx, lqy)
    return (nx, ny, nz), (j, fp2_neg(theta), lam)


def _ell(f, coeffs, px, py):
    c0, c1, c2 = coeffs
    a, b, c, d = _fp_products([(c2[..., 0, :], py), (c2[..., 1, :], py),
                               (c1[..., 0, :], px), (c1[..., 1, :], px)])
    return fp12_mul_by_014(f, c0, torch.stack([c, d], dim=-2),
                           torch.stack([a, b], dim=-2))


def _miller_loop_plain(px, py, qx, qy):
    """f_i = miller(P_i, Q_i) for a batch of affine pairs; px, py Fp [n];
    qx, qy Fp2 [n]. The add step runs on every step and is selected in on
    set bits of |x|, as in the JAX scan; conjugated at the end (x < 0)."""
    n = px.shape[0]
    two_inv = _c(_TWO_INV, px)
    f = fp12_one_like((n,), px)
    tx, ty = qx, qy
    tz = _c(FP2_ONE, qx).expand(qx.shape).clone()
    for bit in _X_BITS[1:]:
        f = fp12_square(f)
        (tx, ty, tz), coeffs = _miller_dbl_step(tx, ty, tz, two_inv)
        f = _ell(f, coeffs, px, py)
        if bit:
            (tx, ty, tz), acoeffs = _miller_add_step(tx, ty, tz, qx, qy)
            f = _ell(f, acoeffs, px, py)
    return fp12_conj(f)


def _mask_to_one(fs, mask):
    """Replace masked-out Miller outputs with the Fp12 identity."""
    mask = torch.as_tensor(mask, device=fs.device).to(torch.bool)
    one = fp12_one_like((fs.shape[0],), fs)
    return torch.where(mask[:, None, None, None, None], fs, one)


def _fp12_product_plain(fs):
    """Product over the batch axis (a field value: any order gives it),
    as a pairwise tree: n - 1 multiplies in log2(n) batched steps."""
    while fs.shape[0] > 1:
        half = fs.shape[0] // 2
        prod = fp12_mul(fs[:half], fs[half:2 * half])
        fs = torch.cat([prod, fs[2 * half:]]) if fs.shape[0] % 2 else prod
    return fs[0]


def _frob_consts():
    from ..crypto.bls12_381.fields import Fp2 as OF
    xi = OF(1, 1)
    out = {}
    for n in (1, 2, 3):
        g = xi.pow((P_INT**n - 1) // 6)
        out[n] = np.stack([fp2_const(int(v.c0), int(v.c1))
                           for v in [g.pow(k) for k in range(6)]])
    return out


_FROB_GAMMA = _frob_consts()


def fp12_frobenius(f, n: int):
    """f^(p^n) for n in {1, 2, 3}: coefficient (i, j) (of w^i v^j) picks up
    gamma_n^(i+2j), conjugated for odd n; all 6 products fused."""
    gammas = _FROB_GAMMA[n]
    pairs = []
    for i in (0, 1):
        for j in (0, 1, 2):
            c = f[..., i, j, :, :]
            if n % 2:
                c = fp2_conj(c)
            pairs.append((c, _c(gammas[i + 2 * j], f)))
    prods = _fp2_products(pairs)
    return _f12(_f6(prods[0], prods[1], prods[2]),
                _f6(prods[3], prods[4], prods[5]))


def fp12_cyclotomic_square(a):
    """Granger-Scott square of an element of the cyclotomic subgroup (any
    f^((p^6-1)(p^2+1))): three Fp4 squares, 9 Fp2 squares in one call.
    Equal to ``fp12_square`` there, and only there. With z0..z5 the Fp2
    coefficients (c0.c0, c1.c1), (c1.c0, c0.c2), (c0.c1, c1.c2) paired as
    Fp4 = Fp2[w^3] values (a, b): (a, b)^2 = (a^2 + xi b^2, 2ab), and each
    z becomes 3 t -/+ 2 z."""
    g, h = a[..., 0, :, :, :], a[..., 1, :, :, :]
    z0, z4, z3 = g[..., 0, :, :], g[..., 1, :, :], g[..., 2, :, :]
    z2, z1, z5 = h[..., 0, :, :], h[..., 1, :, :], h[..., 2, :, :]
    s01, s23, s45 = _fused(fp2_add, [(z0, z1), (z2, z3), (z4, z5)])
    sq = fp2_square(torch.stack([z0, z1, s01, z2, z3, s23, z4, z5, s45],
                                dim=-3))

    def fp4(i):
        """(a^2 + xi b^2, (a + b)^2 - a^2 - b^2) of pair i."""
        aa, bb, ss = sq[..., 3 * i, :, :], sq[..., 3 * i + 1, :, :], \
            sq[..., 3 * i + 2, :, :]
        return (fp2_add(aa, fp2_mul_by_xi(bb)),
                fp2_sub(fp2_sub(ss, aa), bb))

    def three_t(t, z, sign):
        """2 (t - z) + t, or 2 (t + z) + t."""
        d = fp2_sub(t, z) if sign < 0 else fp2_add(t, z)
        return fp2_add(fp2_add(d, d), t)

    t0, t1 = fp4(0)
    u0, u1 = fp4(1)
    v0, v1 = fp4(2)
    return _f12(_f6(three_t(t0, z0, -1), three_t(u0, z4, -1),
                    three_t(v0, z3, -1)),
                _f6(three_t(fp2_mul_by_xi(v1), z2, +1), three_t(t1, z1, +1),
                    three_t(u1, z5, +1)))


def _cyclotomic_pow_plain(f, exponent: int):
    """f^exponent for f in the cyclotomic subgroup: square-and-multiply
    with cyclotomic squares (the kernel walks the same bits from the
    bottom, squaring and multiplying at once: the same products)."""
    return _pow_const(f, exponent, fp12_cyclotomic_square, fp12_mul)


_R_SUBGROUP = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
#: |(x - 1)/3| = (|x| + 1)/3 (x < 0; 3 divides x - 1)
_X13 = (_X_ABS + 1) // 3


def _final_exponentiation_plain(f):
    """f^((p^12-1)/r): the easy part f^((p^6-1)(p^2+1)), then the hard
    part (p^4 - p^2 + 1)/r = ((x-1)^2/3)(x+p)(x^2+p^2-1) + 1 as the x-chain.
    After the easy part f is cyclotomic: a square is Granger-Scott's, an
    inverse a conjugate, so x < 0 costs conjugations only:
      u = f^((|x|+1)/3), a = u^|x| u = f^((x-1)^2/3),
      b = conj(a^|x|) frob1(a) = a^(x+p),
      c = (b^|x|)^|x| frob2(b) conj(b) = b^(x^2+p^2-1), and c f."""
    f = fp12_mul(fp12_conj(f), fp12_inv(f))       # easy: f^(p^6-1)
    f = fp12_mul(fp12_frobenius(f, 2), f)         # easy: ^(p^2+1)
    u = _cyclotomic_pow_plain(f, _X13)
    a = fp12_mul(_cyclotomic_pow_plain(u, _X_ABS), u)
    b = fp12_mul(fp12_conj(_cyclotomic_pow_plain(a, _X_ABS)),
                 fp12_frobenius(a, 1))
    d = fp12_mul(fp12_frobenius(b, 2), fp12_conj(b))
    c = fp12_mul(_cyclotomic_pow_plain(_cyclotomic_pow_plain(b, _X_ABS),
                                       _X_ABS), d)
    return fp12_mul(c, f)


# ---------------------------------------------------------------------------
# hash-to-G2: SSWU + 3-isogeny + psi-based cofactor clearing (RFC 9380)
# ---------------------------------------------------------------------------

def fp2_is_square(a):
    """Legendre of the norm: a square in Fp2 iff N(a)^((p-1)/2) != p-1."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    norm = fp_add(fp_mul(a0, a0), fp_mul(a1, a1))
    leg = fp_pow_const(norm, (P_INT - 1) // 2)
    return ~fp_eq(leg, _c(_FP_NEG_ONE, leg))


def fp2_sqrt(a):
    """Batched sqrt for p = 3 mod 4 (Adj-Rodriguez); returns (y, ok)."""
    a1 = fp2_pow_const(a, (P_INT - 3) // 4)
    x0 = fp2_mul(a1, a)
    alpha = fp2_mul(a1, x0)
    is_neg1 = fp2_eq(alpha, _c(_FP2_NEG_ONE, alpha))
    ix0 = torch.stack([fp_neg(x0[..., 1, :]), x0[..., 0, :]], dim=-2)
    b = fp2_add(alpha, _c(FP2_ONE, alpha))
    bp = fp2_pow_const(b, (P_INT - 1) // 2)
    other = fp2_mul(bp, x0)
    y = _where_fp2(is_neg1, ix0, other)
    ok = fp2_eq(fp2_square(y), a)
    zero = fp2_is_zero(a)
    y = _where_fp2(zero, torch.zeros_like(y), y)
    return y, ok | zero


def _limbs_gt(a, b):
    """Lexicographic a > b on canonical little-endian limb arrays."""
    diff = (a.to(torch.int32) - b.to(torch.int32)).flip(-1)   # MSB first
    nz = diff != 0
    idx = torch.argmax(nz.to(torch.int32), dim=-1, keepdim=True)
    val = torch.gather(diff, -1, idx)[..., 0]
    return val > 0


def fp2_sgn0(a):
    c0 = fp_to_int_limbs(a[..., 0, :])
    c1 = fp_to_int_limbs(a[..., 1, :])
    s0 = (c0[..., 0] & 1).to(torch.int32)
    z0 = torch.all(c0 == 0, dim=-1)
    s1 = (c1[..., 0] & 1).to(torch.int32)
    return torch.where(z0, s1, s0)


def _iso_consts():
    from ..crypto.bls12_381 import hash_to_curve as h2c
    from ..crypto.bls12_381.fields import Fp2 as OF
    oA = OF(0, 240)
    oB = OF(1012, 1012)
    oZ = OF(-2 % P_INT, -1 % P_INT)
    nba = -oB * oA.inv()                    # -B/A
    x1exc = oB * (oZ * oA).inv()            # B/(Z*A), tv1 == 0 case
    xi = OF(1, 1)
    gamma = xi.pow((P_INT - 1) // 6)
    k = xi * xi.conj().inv()
    psi_cx = gamma.pow(4) * k
    psi_cy = gamma.pow(3) * k
    enc = lambda v: fp2_const(int(v.c0), int(v.c1))  # noqa: E731
    return {
        "A": enc(oA), "B": enc(oB), "Z": enc(oZ),
        "NBA": enc(nba), "X1EXC": enc(x1exc),
        "XN": np.stack([enc(v) for v in h2c.ISO_X_NUM]),
        "XD": np.stack([enc(v) for v in h2c.ISO_X_DEN]),
        "YN": np.stack([enc(v) for v in h2c.ISO_Y_NUM]),
        "YD": np.stack([enc(v) for v in h2c.ISO_Y_DEN]),
        "PSI_CX": enc(psi_cx), "PSI_CY": enc(psi_cy),
    }


_FP_NEG_ONE = fp_const(P_INT - 1)
_FP2_NEG_ONE = fp2_const(P_INT - 1, 0)
_H2C = _iso_consts()
_U_ABS2 = abs(X_PARAM)
_BP_K1 = _U_ABS2 * _U_ABS2 + _U_ABS2 - 1      # u^2-u-1 with u<0
_BP_K2 = _U_ABS2 + 1                          # |u-1|


def sswu_map_g2(u):
    """Simplified SWU onto E' (affine), batched; u: [n, 2, 32]."""
    A, B, Z = (_c(_H2C[k], u) for k in ("A", "B", "Z"))
    zu2 = fp2_mul(Z, fp2_square(u))
    tv1 = fp2_add(fp2_square(zu2), zu2)
    tv1_zero = fp2_is_zero(tv1)
    inv_tv1 = fp2_inv(tv1)
    x1_main = fp2_mul(_c(_H2C["NBA"], u), fp2_add(_c(FP2_ONE, u), inv_tv1))
    x1 = _where_fp2(tv1_zero, _c(_H2C["X1EXC"], u), x1_main)

    def g(x):
        x3 = fp2_mul(fp2_square(x), x)
        return fp2_add(fp2_add(x3, fp2_mul(A, x)), B)

    gx1 = g(x1)
    e1 = fp2_is_square(gx1)
    x2 = fp2_mul(zu2, x1)
    gx2 = g(x2)
    x = _where_fp2(e1, x1, x2)
    gx = _where_fp2(e1, gx1, gx2)
    y, _ok = fp2_sqrt(gx)
    flip = fp2_sgn0(u) != fp2_sgn0(y)
    y = _where_fp2(flip, fp2_neg(y), y)
    return x, y


def iso_map_g2(x, y):
    """3-isogeny E' -> E, batched; returns Jacobian (x, y, z) with z = 0
    on the exceptional kernel inputs (RFC 9380 §4.1)."""
    def horner(consts, monic):
        if monic:
            acc = _c(FP2_ONE, x).expand(x.shape)
            rng = range(len(consts) - 1, -1, -1)
        else:
            acc = _c(consts[-1], x).expand(x.shape)
            rng = range(len(consts) - 2, -1, -1)
        for i in rng:
            acc = fp2_add(fp2_mul(acc, x), _c(consts[i], x))
        return acc

    xn = horner(_H2C["XN"], False)
    xd = horner(_H2C["XD"], True)
    yn = horner(_H2C["YN"], False)
    yd = horner(_H2C["YD"], True)
    bad = fp2_is_zero(xd) | fp2_is_zero(yd)
    z = fp2_mul(xd, yd)
    yd2 = fp2_square(yd)
    xj = fp2_mul(fp2_mul(xn, xd), yd2)
    xd2 = fp2_square(xd)
    yj = fp2_mul(fp2_mul(fp2_mul(y, yn), fp2_mul(xd2, xd)), yd2)
    z = _where_fp2(bad, torch.zeros_like(z), z)
    return xj, yj, z


def psi_g2(x, y, z):
    """Untwist-frobenius-twist endomorphism in Jacobian coordinates:
    (cx*conj(X), cy*conj(Y), conj(Z))."""
    return (fp2_mul(fp2_conj(x), _c(_H2C["PSI_CX"], x)),
            fp2_mul(fp2_conj(y), _c(_H2C["PSI_CY"], y)),
            fp2_conj(z))


def clear_cofactor_g2(x, y, z):
    """Budroni-Pintore: [u^2-u-1]Q + [u-1]psi(Q) + psi^2([2]Q)."""
    t1 = g2_scalar_mul_const(x, y, z, _BP_K1)
    ux, uy, uz = g2_scalar_mul_const(x, y, z, _BP_K2)
    t2 = psi_g2(ux, fp2_neg(uy), uz)
    t3 = psi_g2(*psi_g2(*g2_dbl(x, y, z)))
    ax, ay, az = g2_add(*t1, *t2)
    return g2_add(ax, ay, az, *t3)


def map_to_g2_batch(u):
    """map_to_curve (SSWU + iso) for a [n, 2, 32] batch."""
    return iso_map_g2(*sswu_map_g2(u))


def _hash_to_g2_plain(u0, u1):
    """Map the stacked 2n batch, add the halves, clear the cofactor;
    Jacobian output [n, 2, 32]."""
    x, y, z = map_to_g2_batch(torch.cat([u0, u1], dim=0))
    h = u0.shape[0]
    sx, sy, sz = g2_add(x[:h], y[:h], z[:h], x[h:], y[h:], z[h:])
    return clear_cofactor_g2(sx, sy, sz)


# ---------------------------------------------------------------------------
# G2 decompression + psi subgroup check (gossip signature intake)
# ---------------------------------------------------------------------------

_HALF_P_LIMBS = bi.to_limbs((P_INT - 1) // 2)
_B_G2_CONST = fp2_const(4, 4)


def fp2_lex_larger(a):
    """zcash compression sign: y > -y lexicographically (c1 first)."""
    c0 = fp_to_int_limbs(a[..., 0, :])
    c1 = fp_to_int_limbs(a[..., 1, :])
    half = _c(_HALF_P_LIMBS, a)
    c1_nz = ~torch.all(c1 == 0, dim=-1)
    return torch.where(c1_nz, _limbs_gt(c1, half), _limbs_gt(c0, half))


def _g2_decompress_plain(x, want_larger):
    rhs = fp2_add(fp2_mul(fp2_square(x), x), _c(_B_G2_CONST, x))
    y, ok = fp2_sqrt(rhs)
    want = torch.as_tensor(want_larger, device=x.device).to(torch.bool)
    flip = fp2_lex_larger(y) != want
    y = _where_fp2(flip, fp2_neg(y), y)
    return y, ok


def g2_eq_jac(x1, y1, z1, x2, y2, z2):
    """Batched Jacobian equality (cross-multiplied)."""
    inf1, inf2 = fp2_is_zero(z1), fp2_is_zero(z2)
    z1s, z2s = fp2_square(z1), fp2_square(z2)
    ex = fp2_eq(fp2_mul(x1, z2s), fp2_mul(x2, z1s))
    ey = fp2_eq(fp2_mul(y1, fp2_mul(z2s, z2)), fp2_mul(y2, fp2_mul(z1s, z1)))
    return torch.where(inf1 | inf2, inf1 & inf2, ex & ey)


def _g2_in_subgroup_plain(x, y, z):
    px, py, pz = psi_g2(x, y, z)
    ux, uy, uz = g2_scalar_mul_const(x, y, z, _U_ABS2)
    return g2_eq_jac(px, py, pz, ux, fp2_neg(uy), uz)


# ---------------------------------------------------------------------------
# stage wrappers: CUDA tensor -> kernel, CPU tensor -> plain version
# ---------------------------------------------------------------------------

def _on_cpu(*ts) -> bool:
    devs = {torch.as_tensor(t).device.type for t in ts
            if isinstance(t, torch.Tensor)}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"stage inputs on mixed or unsupported devices: {devs}")


def _arg(t: torch.Tensor, name: str, shape: tuple, dtype=torch.int32):
    """Check one kernel argument: CUDA, ``dtype``, ``shape``; contiguous."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _flags(v, n: int, like: torch.Tensor) -> torch.Tensor:
    """A bool/int flag vector [n] as int32 on ``like``'s device."""
    return torch.as_tensor(v, device=like.device).to(torch.int32).reshape(n)


def _empty(shape, like):
    return torch.empty(shape, dtype=torch.int32, device=like.device)


def _stream(like):
    from .. import kernels
    return kernels.stream_ptr(like.device)


FP, FP2 = 1, 2


# -- declared costs (obs/roofline): the function's work on the call's
# inputs, as bls_cost counts it: field multiplies x FP_MUL_INT_OPS (the
# affine conversion adds its one inverse's word operations), each tensor
# argument read once and each output written once


def _mul_work(out, args, muls: int, words: int = 0):
    from .bls_cost import FP_MUL_INT_OPS
    return (tensor_bytes(*args, out), muls * FP_MUL_INT_OPS + words,
            {"field_muls": muls, "word_ops": words})


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _z_is(z, value: np.ndarray) -> np.ndarray:
    """Per lane: z equals ``value`` (Montgomery limbs) as a field
    value."""
    zc = _host(bi.canonical(z))
    return (zc == value).reshape(zc.shape[0], -1).all(axis=1)


def _g2_decompress_cost(out, x, want_larger):
    from .bls_cost import g2_decompress
    return _mul_work(out, (x, want_larger), g2_decompress(x.shape[0]))


def _g2_subgroup_cost(ok, x, y, z):
    from .bls_cost import g2_subgroup_lanes
    muls = g2_subgroup_lanes(_z_is(z, FP2_ONE), _z_is(z, FP2_ZERO),
                             _host(ok))["products"]
    return _mul_work(ok, (x, y, z), muls)


def _hash_to_g2_cost(out, u0, u1):
    from .bls_cost import hash_to_g2
    return _mul_work(out, (u0, u1), hash_to_g2(u0.shape[0]))


def _scalar_mul_cost(out, field, x, y, z, bits):
    from .bls_cost import scalar_mul_lanes
    one = FP_ONE if field == FP else FP2_ONE
    muls = scalar_mul_lanes(_host(bits), field,
                            z_one=_z_is(z, one))["products"]
    return _mul_work(out, (x, y, z, bits), muls)


def _g1_segment_sum_cost(out, x, y, z, starts, ends):
    from .bls_cost import g1_segment_sum
    return _mul_work(out, (x, y, z, starts, ends),
                     g1_segment_sum(_host(starts), _host(ends)))


def _g2_sum_cost(out, x, y, z):
    from .bls_cost import g2_sum
    return _mul_work(out, (x, y, z), g2_sum(x.shape[0]))


def _affine_cost(out, field, x, y, z):
    from .bls_cost import affine_least
    return _mul_work(out, (x, y, z), *affine_least(z, field))


def _miller_loop_cost(out, px, py, qx, qy, mask=None):
    from .bls_cost import miller_loop
    live = np.ones(px.shape[0], bool) if mask is None else _host(mask)
    return _mul_work(out, (px, py, qx, qy, mask), miller_loop(live))


def _final_exp_cost(out, mode, fs):
    """The product of the values, and in mode 1 the final
    exponentiation and its flag."""
    from .bls_cost import final_exp
    return _mul_work(out if mode == 1 else out[0], (fs,),
                     final_exp(fs.shape[0], mode))


def _fp12_pow_cost(out, f, exponent):
    from .bls_cost import fp12_pow
    return _mul_work(out, (f,), fp12_pow(f.shape[0], exponent))


@tracked("g2_intake", _g2_decompress_cost)
def g2_decompress_batch(x, want_larger):
    """Batched y-recovery for compressed G2 points: x [n, 2, 32] Montgomery
    x-coordinates, want_larger [n] sign flags. Returns (y, ok): ok is
    False where x^3 + 4(1+u) is not a square."""
    if _on_cpu(x):
        return _g2_decompress_plain(x, want_larger)
    from .. import kernels
    n = x.shape[0]
    x = _arg(x, "x", (n, 2, bi.NLIMBS))
    flags = _flags(want_larger, n, x)
    y, ok = _empty((n, 2, bi.NLIMBS), x), _empty((n,), x)
    if n:
        kernels.G2_INTAKE.launch(0, x.data_ptr(), flags.data_ptr(),
                                 y.data_ptr(), 0, ok.data_ptr(), n,
                                 _stream(x))
    return y, ok.to(torch.bool)


@tracked("g2_intake", _g2_subgroup_cost)
def g2_in_subgroup_batch(x, y, z):
    """psi(Q) == [u]Q (u < 0) for Jacobian Q: the 64-bit endomorphism
    subgroup check."""
    if _on_cpu(x, y, z):
        return _g2_in_subgroup_plain(x, y, z)
    from .. import kernels
    n = x.shape[0]
    shp = (n, 2, bi.NLIMBS)
    x, y, z = _arg(x, "x", shp), _arg(y, "y", shp), _arg(z, "z", shp)
    ok = _empty((n,), x)
    if n:
        kernels.G2_INTAKE.launch(1, x.data_ptr(), 0, y.data_ptr(),
                                 z.data_ptr(), ok.data_ptr(), n, _stream(x))
    return ok.to(torch.bool)


@tracked("hash_to_g2", _hash_to_g2_cost)
def hash_to_g2_batch_from_u(u0, u1):
    """Device half of hash-to-G2 from encoded field elements u0, u1
    [n, 2, 32]: Jacobian (x, y, z) [n, 2, 32]."""
    if _on_cpu(u0, u1):
        return _hash_to_g2_plain(u0, u1)
    from .. import kernels
    n = u0.shape[0]
    shp = (n, 2, bi.NLIMBS)
    u0, u1 = _arg(u0, "u0", shp), _arg(u1, "u1", shp)
    out = [_empty(shp, u0) for _ in range(3)]
    if n:
        kernels.HASH_TO_G2.launch(u0.data_ptr(), u1.data_ptr(),
                                  *(t.data_ptr() for t in out), n,
                                  _stream(u0))
    return tuple(out)


@tracked("rlc_scale", _scalar_mul_cost)
def _scalar_mul(field, x, y, z, bits):
    from .. import kernels
    n = x.shape[0]
    shp = (n,) + ((bi.NLIMBS,) if field == FP else (2, bi.NLIMBS))
    x, y, z = _arg(x, "x", shp), _arg(y, "y", shp), _arg(z, "z", shp)
    bits = torch.as_tensor(bits, device=x.device).to(torch.int32)
    nbits = bits.shape[-1]
    bits = _arg(bits, "bits", (n, nbits))
    out = [_empty(shp, x) for _ in range(3)]
    if n:
        kernels.RLC_SCALE.launch(field, x.data_ptr(), y.data_ptr(),
                                 z.data_ptr(), bits.data_ptr(), nbits,
                                 *(t.data_ptr() for t in out), n,
                                 _stream(x))
    return tuple(out)


def g1_scalar_mul(x, y, z, bits):
    """[b_i]P_i for per-lane scalars as MSB-first bits [n, nbits]."""
    if _on_cpu(x, y, z):
        return _g1_scalar_mul_plain(x, y, z, bits)
    return _scalar_mul(FP, x, y, z, bits)


def g2_scalar_mul(x, y, z, bits):
    if _on_cpu(x, y, z):
        return _g2_scalar_mul_plain(x, y, z, bits)
    return _scalar_mul(FP2, x, y, z, bits)


def _seg_work_words(n: int, g: int) -> int:
    """int32 words of the segment sum's scratch (csrc/bls/aggregate.cu
    seg_work_words: the ranges' tables, the long ranges' partials)."""
    return 4 * 512 + 40 * g + 37 * n


@tracked("g1_segment_sum", _g1_segment_sum_cost)
def g1_segment_sum(x, y, z, starts, ends):
    """Per-range Jacobian G1 sums over host-sorted lanes: ``starts`` is 1
    at each segment's first lane; output g is the sum of the lanes from
    the first lane of the segment that holds lane ``ends[g]`` up to it
    (``segment_ranges``; a padding group's ``ends[g] = 0`` gives lane 0).

    On the card ``starts`` and ``ends`` may be host arrays (the batch
    path's: the range check runs on them, each goes up in one copy, and
    nothing is read back) or tensors on x's device (the range check then
    reads ``ends``' least and largest back, one sync). The kernel is one
    cooperative launch (csrc/bls/aggregate.cu)."""
    if _on_cpu(x, y, z):
        return _g1_segment_sum_plain(x, y, z, starts, ends)
    from .. import kernels
    n = x.shape[0]
    shp = (n, bi.NLIMBS)
    x, y, z = _arg(x, "x", shp), _arg(y, "y", shp), _arg(z, "z", shp)
    if any(t.data_ptr() % 16 for t in (x, y, z)):
        raise ValueError("g1_segment_sum: x, y, z must be 16-byte aligned "
                         "(the kernel loads rows in 16-byte words)")
    if isinstance(ends, torch.Tensor):
        lo, hi = (host_readback(torch.stack(torch.aminmax(
            ends.reshape(-1).long()))).tolist() if ends.numel() else (0, 0))
    else:
        ends = np.asarray(ends).reshape(-1)
        lo, hi = (int(ends.min()), int(ends.max())) if ends.size else (0, 0)
    if lo < 0 or hi >= n:
        raise ValueError("g1_segment_sum: ends out of range")
    starts = _flags(starts, n, x)
    ends = torch.as_tensor(ends, device=x.device).to(torch.int32)
    g = ends.shape[0]
    ends = ends.contiguous()
    out = [_empty((g, bi.NLIMBS), x) for _ in range(3)]
    if g:
        words = _seg_work_words(n, g)
        work = _empty((words,), x)
        kernels.G1_SEGMENT_SUM.launch(x.data_ptr(), y.data_ptr(),
                                      z.data_ptr(), starts.data_ptr(), n,
                                      ends.data_ptr(), g, work.data_ptr(),
                                      words, *(t.data_ptr() for t in out),
                                      _stream(x))
    return tuple(out)


@tracked("g2_sum", _g2_sum_cost)
def g2_sum(x, y, z):
    """The sum of n >= 1 Jacobian G2 points [n, 2, 32]: on the card a
    pairwise tree in a fixed order (the same limbs on every call with the
    same points; one launch of the kernel up to a block's points, two
    past them), on the CPU the JAX order (``_g2_sum_plain``); the same
    point, held projectively."""
    if _on_cpu(x, y, z):
        return _g2_sum_plain(x, y, z)
    from .. import kernels
    from . import bls_cost as cost
    n = x.shape[0]
    if n < 1:
        raise ValueError("g2_sum takes n >= 1 points")
    shp = (n, 2, bi.NLIMBS)
    x, y, z = _arg(x, "x", shp), _arg(y, "y", shp), _arg(z, "z", shp)
    out = [_empty((2, bi.NLIMBS), x) for _ in range(3)]
    # the first launch's partials (x, y, z of one point a block), past a
    # block's points
    blocks = min(-(-n // cost.G2_SUM_THREADS), cost.G2_SUM_THREADS)
    part = _empty((3, blocks, 2, bi.NLIMBS), x) if blocks > 1 else None
    kernels.G2_SUM.launch(x.data_ptr(), y.data_ptr(), z.data_ptr(), n,
                          None if part is None else part.data_ptr(),
                          *(t.data_ptr() for t in out), _stream(x),
                          count=1 if blocks == 1 else 2)
    return tuple(out)


@tracked("affine", _affine_cost)
def _affine(field, x, y, z):
    from .. import kernels
    n = x.shape[0]
    shp = (n,) + ((bi.NLIMBS,) if field == FP else (2, bi.NLIMBS))
    x, y, z = _arg(x, "x", shp), _arg(y, "y", shp), _arg(z, "z", shp)
    ox, oy = _empty(shp, x), _empty(shp, x)
    if n:
        kernels.AFFINE.launch(field, x.data_ptr(), y.data_ptr(),
                              z.data_ptr(), ox.data_ptr(), oy.data_ptr(), n,
                              _stream(x))
    return ox, oy


def jacobian_to_affine_fp(x, y, z):
    """(X/Z^2, Y/Z^3); Z = 0 inverts to 0, so infinity maps to (0, 0)."""
    if _on_cpu(x, y, z):
        return _jacobian_to_affine_fp_plain(x, y, z)
    return _affine(FP, x, y, z)


def jacobian_to_affine_fp2(x, y, z):
    """Fp2 form; a single point [2, 32] is taken as a batch of one."""
    if _on_cpu(x, y, z):
        return _jacobian_to_affine_fp2_plain(x, y, z)
    if x.dim() == 2:
        ox, oy = _affine(FP2, x[None], y[None], z[None])
        return ox[0], oy[0]
    return _affine(FP2, x, y, z)


@tracked("miller_loop", _miller_loop_cost)
def miller_loop_batch(px, py, qx, qy, mask=None):
    """f_i = miller(P_i, Q_i) for affine pairs, px, py [n, 32], qx, qy
    [n, 2, 32] -> Fp12 [n, 2, 3, 2, 32]; lanes with ``mask`` False give
    the identity. On the card the pairs the kernel runs on pick its design
    (``bls_cost.miller_loop_design``): a block a pair up to
    ``LH_ML_COOP_MAX`` pairs, a thread a pair past it. Past it, when the
    live pairs are few enough for a block each, the kernel runs on them
    alone (``_miller_live_lanes``): the batches the verification pads
    with masked lanes. The same values either way."""
    if _on_cpu(px, py, qx, qy):
        fs = _miller_loop_plain(px, py, qx, qy)
        return fs if mask is None else _mask_to_one(fs, mask)
    from .. import kernels
    n = px.shape[0]
    live = _miller_live_lanes(n, mask)
    if live is not None:
        return _on_live_lanes(miller_loop_batch, live, px, py, qx, qy)
    px, py = _arg(px, "px", (n, bi.NLIMBS)), _arg(py, "py", (n, bi.NLIMBS))
    qx = _arg(qx, "qx", (n, 2, bi.NLIMBS))
    qy = _arg(qy, "qy", (n, 2, bi.NLIMBS))
    m = _flags(np.ones(n, bool) if mask is None else mask, n, px)
    out = _empty((n, 2, 3, 2, bi.NLIMBS), px)
    if n:
        kernels.MILLER_LOOP.launch(px.data_ptr(), py.data_ptr(),
                                   qx.data_ptr(), qy.data_ptr(),
                                   m.data_ptr(), out.data_ptr(), n,
                                   _stream(px))
    return out


def _miller_live_lanes(n: int, mask):
    """The live lanes (``mask`` True) of n Miller pairs when the kernel
    should run on them alone (``bls_cost.miller_loop_pairs``: n past
    ``LH_ML_COOP_MAX``, the live lanes within it), else None. A mask on
    the card is read back (one sync), and only past the crossover."""
    from . import bls_cost as cost
    if mask is None or n <= cost.ML_COOP_MAX:
        return None
    host = mask.cpu().numpy() if torch.is_tensor(mask) else np.asarray(mask)
    live = np.flatnonzero(host.reshape(n))
    return live if cost.miller_loop_pairs(n, live.size) < n else None


def _on_live_lanes(miller, live, px, py, qx, qy):
    """``miller`` (unmasked) on the pairs at lanes ``live`` alone; the
    other lanes of the [n] output the Fp12 identity."""
    out = fp12_one_like((px.shape[0],), px)
    if live.size:
        idx = torch.from_numpy(live).to(px.device)
        out[idx] = miller(px[idx], py[idx], qx[idx], qy[idx])
    return out


@tracked("final_exp", _final_exp_cost)
def _final_exp_kernel(mode: int, fs):
    from .. import kernels
    n = fs.shape[0]
    if n < 1:
        raise ValueError("final_exp kernel takes n >= 1 Fp12 values")
    fs = _arg(fs, "fs", (n, 2, 3, 2, bi.NLIMBS))
    out = _empty((2, 3, 2, bi.NLIMBS), fs)
    flag = _empty((1,), fs)
    kernels.FINAL_EXP.launch(mode, fs.data_ptr(), n, out.data_ptr(),
                             flag.data_ptr(), _stream(fs))
    return out, flag


def fp12_product(fs):
    """Product of the Fp12 values [n, ...] over the batch axis."""
    if _on_cpu(fs):
        return _fp12_product_plain(fs)
    return _final_exp_kernel(0, fs)[0]


def final_exponentiation(f):
    """f^((p^12-1)/r) for one Fp12 element [2, 3, 2, 32]."""
    if _on_cpu(f):
        return _final_exponentiation_plain(f)
    return _final_exp_kernel(1, f[None])[0]


@tracked("fp12_pow", _fp12_pow_cost)
def fp12_pow_const(f, exponent: int):
    """f^exponent for a constant exponent, elementwise over Fp12 values
    [n, 2, 3, 2, 32] (exponent 0 gives f, as the JAX scan does). The
    kernel walks the exponent's bits from the bottom one (any width; none
    for exponent 0), the plain version from the top, as JAX: the same
    field values, other representatives."""
    if _on_cpu(f):
        return _fp12_pow_const_plain(f, exponent)
    from .. import kernels
    n = f.shape[0]
    f = _arg(f, "f", (n, 2, 3, 2, bi.NLIMBS))
    nbits = exponent.bit_length()
    bits = torch.tensor(_bits(exponent)[::-1] if nbits else [0],
                        dtype=torch.int32, device=f.device)
    out = _empty(f.shape, f)
    if n:
        kernels.FP12_POW.launch(f.data_ptr(), bits.data_ptr(), nbits,
                                out.data_ptr(), n, _stream(f))
    return out


def pairing_check_batch(px, py, qx, qy, mask=None) -> bool:
    """prod_i e(P_i, Q_i) == 1 over the lanes ``mask`` selects (one shared
    final exponentiation)."""
    fs = miller_loop_batch(px, py, qx, qy, mask)
    if _on_cpu(fs):
        out = _final_exponentiation_plain(_fp12_product_plain(fs))
        return bool(fp12_eq(out, fp12_one_like((), out)))
    return bool(_final_exp_kernel(1, fs)[1].item())
