"""BLS12-381 field towers: Fp, Fp2 = Fp[u]/(u^2+1),
Fp6 = Fp2[v]/(v^3 - xi) with xi = 1+u, Fp12 = Fp6[w]/(w^2 - v).

Int-backed, operator-overloaded; optimized for clarity not speed (the speed
paths are the C++ host backend and the limb-decomposed TPU kernels in
lighthouse_tpu/ops/bls12_381.py, which are validated against this module).
"""
from __future__ import annotations

# Field modulus
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Subgroup order (scalar field)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative): p, r are polynomials in x
X_PARAM = -0xD201000000010000

assert R == X_PARAM**4 - X_PARAM**2 + 1
assert P == (X_PARAM - 1) ** 2 * (X_PARAM**4 - X_PARAM**2 + 1) // 3 + X_PARAM


class Fp(int):
    """Element of Fp. Immutable int subclass (value already reduced)."""

    def __new__(cls, v: int):
        return super().__new__(cls, v % P)

    def __add__(self, o):
        return Fp(int(self) + int(o))

    __radd__ = __add__

    def __sub__(self, o):
        return Fp(int(self) - int(o))

    def __rsub__(self, o):
        return Fp(int(o) - int(self))

    def __mul__(self, o):
        return Fp(int(self) * int(o))

    __rmul__ = __mul__

    def __neg__(self):
        return Fp(-int(self))

    def inv(self):
        return Fp(pow(int(self), P - 2, P))

    def __truediv__(self, o):
        return self * Fp(int(o)).inv()

    def is_square(self) -> bool:
        return int(self) == 0 or pow(int(self), (P - 1) // 2, P) == 1

    def sqrt(self) -> "Fp | None":
        # p ≡ 3 (mod 4)
        c = Fp(pow(int(self), (P + 1) // 4, P))
        return c if c * c == self else None

    def sgn0(self) -> int:
        return int(self) & 1


class Fp2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0, c1):
        self.c0 = c0 if isinstance(c0, Fp) else Fp(c0)
        self.c1 = c1 if isinstance(c1, Fp) else Fp(c1)

    def __eq__(self, o):
        return isinstance(o, Fp2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((int(self.c0), int(self.c1)))

    def __repr__(self):
        return f"Fp2({hex(self.c0)}, {hex(self.c1)})"

    def __add__(self, o):
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fp2(self.c0 * o, self.c1 * o)
        # Karatsuba: (a0+a1 u)(b0+b1 u), u^2 = -1
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fp2(t0 - t1, t2 - t0 - t1)

    __rmul__ = __mul__

    def square(self):
        # (a0+a1u)^2 = (a0+a1)(a0-a1) + 2a0a1 u
        a, b = self.c0, self.c1
        return Fp2((a + b) * (a - b), (a * b) * 2)

    def conj(self):
        return Fp2(self.c0, -self.c1)

    def norm(self) -> Fp:
        return self.c0 * self.c0 + self.c1 * self.c1

    def inv(self):
        n = self.norm().inv()
        return Fp2(self.c0 * n, -self.c1 * n)

    def __truediv__(self, o):
        return self * o.inv()

    def mul_by_xi(self):
        """Multiply by xi = 1 + u (the Fp6 non-residue)."""
        return Fp2(self.c0 - self.c1, self.c0 + self.c1)

    def pow(self, e: int):
        out, base = FP2_ONE, self
        while e:
            if e & 1:
                out = out * base
            base = base.square()
            e >>= 1
        return out

    def is_zero(self):
        return int(self.c0) == 0 and int(self.c1) == 0

    def is_square(self) -> bool:
        # a square in Fp2 iff norm(a) is a square in Fp (norm = a^(p+1))
        return self.norm().is_square()

    def sqrt(self) -> "Fp2 | None":
        """Complex-method square root for u^2 = -1 towers."""
        if self.is_zero():
            return Fp2(0, 0)
        a0, a1 = self.c0, self.c1
        if int(a1) == 0:
            s = a0.sqrt()
            if s is not None:
                return Fp2(s, 0)
            s = (-a0).sqrt()
            assert s is not None
            return Fp2(0, s)
        alpha = self.norm().sqrt()
        if alpha is None:
            return None
        inv2 = Fp(2).inv()
        delta = (a0 + alpha) * inv2
        if not delta.is_square():
            delta = (a0 - alpha) * inv2
        x0 = delta.sqrt()
        if x0 is None or int(x0) == 0:
            return None
        x1 = a1 * (x0 * 2).inv()
        cand = Fp2(x0, x1)
        return cand if cand.square() == self else None

    def sgn0(self) -> int:
        # RFC 9380: parity of first nonzero coefficient (c0 first)
        if int(self.c0) != 0:
            return self.c0.sgn0()
        return self.c1.sgn0()


FP2_ZERO = Fp2(0, 0)
FP2_ONE = Fp2(1, 0)
XI = Fp2(1, 1)


class Fp6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __eq__(self, o):
        return (isinstance(o, Fp6) and self.c0 == o.c0 and self.c1 == o.c1
                and self.c2 == o.c2)

    def __add__(self, o):
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        if isinstance(o, Fp2):
            return Fp6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_xi() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_v(self):
        """Multiply by v: (c0,c1,c2) -> (xi*c2, c0, c1)."""
        return Fp6(self.c2.mul_by_xi(), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_xi()
        t1 = a2.square().mul_by_xi() - a0 * a1
        t2 = a1.square() - a0 * a2
        denom = (a0 * t0 + (a2 * t1).mul_by_xi() + (a1 * t2).mul_by_xi()).inv()
        return Fp6(t0 * denom, t1 * denom, t2 * denom)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


FP6_ZERO = Fp6(FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = Fp6(FP2_ONE, FP2_ZERO, FP2_ZERO)


class Fp12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    def __eq__(self, o):
        return isinstance(o, Fp12) and self.c0 == o.c0 and self.c1 == o.c1

    @staticmethod
    def one():
        return Fp12(FP6_ONE, FP6_ZERO)

    def __add__(self, o):
        return Fp12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp12(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fp12(c0, c1)

    def square(self):
        # complex squaring over Fp6 with w^2 = v
        a0, a1 = self.c0, self.c1
        t = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_v()) - t - t.mul_by_v()
        return Fp12(c0, t + t)

    def conj(self):
        """Fp12 conjugation (Frobenius^6): negates the w-odd part."""
        return Fp12(self.c0, -self.c1)

    def inv(self):
        # (a0 + a1 w)^-1 = (a0 - a1 w) / (a0^2 - a1^2 v)
        t = (self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()).inv()
        return Fp12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        out, base = Fp12.one(), self
        while e:
            if e & 1:
                out = out * base
            base = base.square()
            e >>= 1
        return out

    def is_one(self):
        return self == Fp12.one()
