"""Optimal ate pairing for BLS12-381 (M-type twist).

Miller loop with projective doubling/addition steps producing sparse Fp12
line evaluations (the mul_by_014 shape), product-of-Miller-loops +
single final exponentiation for batch verification — the same structure
`blst::verify_multiple_aggregate_signatures` uses
(sigp/lighthouse crypto/bls/src/impls/blst.rs:37-119), and the structure the
TPU kernel batches across the VPU.
"""
from __future__ import annotations

from .curve import Point
from .fields import (
    FP2_ONE, FP2_ZERO, Fp, Fp2, Fp6, Fp12, P, R, X_PARAM,
)

_X_ABS = abs(X_PARAM)
_X_BITS = bin(_X_ABS)[2:]


def _sparse_014(c0: Fp2, c1: Fp2, c4: Fp2) -> Fp12:
    return Fp12(Fp6(c0, c1, FP2_ZERO), Fp6(FP2_ZERO, c4, FP2_ZERO))


class _G2Proj:
    """Homogeneous projective G2 point used inside the Miller loop."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x: Fp2, y: Fp2, z: Fp2):
        self.x, self.y, self.z = x, y, z


_TWO_INV = Fp(pow(2, P - 2, P))
_B_TWIST = Fp2(4, 4)


def _doubling_step(r: _G2Proj):
    a = (r.x * r.y) * _TWO_INV
    b = r.y.square()
    c = r.z.square()
    e = _B_TWIST * (c * 3)
    f = e * 3
    g = (b + f) * _TWO_INV
    h = (r.y + r.z).square() - (b + c)
    i = e - b
    j = r.x.square()
    e_sq = e.square()
    r.x = a * (b - f)
    r.y = g.square() - e_sq * 3
    r.z = b * h
    # M-type twist line coefficients
    return (i, j * 3, -h)


def _addition_step(r: _G2Proj, qx: Fp2, qy: Fp2):
    theta = r.y - qy * r.z
    lam = r.x - qx * r.z
    c = theta.square()
    d = lam.square()
    e = lam * d
    f = r.z * c
    g = r.x * d
    h = e + f - g * 2
    r.x = lam * h
    r.y = theta * (g - h) - e * r.y
    r.z = r.z * e
    j = theta * qx - lam * qy
    return (j, -theta, lam)


def _ell(f: Fp12, coeffs, px: Fp, py: Fp) -> Fp12:
    c0, c1, c2 = coeffs
    # M-type: scale c2 by p.y, c1 by p.x; sparse mul_by_014
    c2 = Fp2(c2.c0 * py, c2.c1 * py)
    c1 = Fp2(c1.c0 * px, c1.c1 * px)
    return f * _sparse_014(c0, c1, c2)


def miller_loop(pairs: list[tuple[Point, Point]]) -> Fp12:
    """Product of Miller loops over (G1, G2) affine pairs."""
    prepared = []
    for p1, p2 in pairs:
        if p1.is_infinity() or p2.is_infinity():
            continue
        px, py = p1.to_affine()
        qx, qy = p2.to_affine()
        prepared.append((px, py, qx, qy, _G2Proj(qx, qy, FP2_ONE)))
    f = Fp12.one()
    for bit in _X_BITS[1:]:
        f = f.square()
        for px, py, qx, qy, r in prepared:
            f = _ell(f, _doubling_step(r), px, py)
        if bit == "1":
            for px, py, qx, qy, r in prepared:
                f = _ell(f, _addition_step(r, qx, qy), px, py)
    # x < 0: conjugate (equivalent to inversion up to final exponentiation)
    return f.conj()


_HARD_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f: Fp12) -> Fp12:
    # easy part: f^((p^6-1)(p^2+1))
    f = f.conj() * f.inv()
    f = f.pow(P * P) * f
    # hard part (generic exponentiation; the perf backends use the
    # x-based addition chain instead)
    return f.pow(_HARD_EXP)


def pairing(p1: Point, p2: Point) -> Fp12:
    """e(P, Q) with P in G1, Q in G2."""
    return final_exponentiation(miller_loop([(p1, p2)]))


def multi_pairing(pairs: list[tuple[Point, Point]]) -> Fp12:
    """prod_i e(P_i, Q_i) — one shared final exponentiation."""
    return final_exponentiation(miller_loop(pairs))
