"""hash-to-curve for G2: the BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_
ciphersuite (RFC 9380 §8.8.2), matching the reference's blst DST + map
(ref: crypto/bls/src/impls/blst.rs:15, sign :187-220).

- ``expand_message_xmd`` (SHA-256) and ``hash_to_field`` over Fp2 follow
  RFC 9380 §5 exactly.
- ``map_to_curve`` is simplified SWU (§6.6.2) onto the 3-isogenous curve
  E': y^2 = x^3 + 240i*x + 1012(1+i) with Z = -(2+i), followed by the
  3-isogeny to E.  The isogeny's rational-map constants are DERIVED at
  import time via Vélu's formulas from the kernel x0 = -6+6i (the unique
  small-form root of E's 3rd division polynomial) composed with the
  curve isomorphism (x,y) -> (x/9, -y/27); the derivation reproduces the
  RFC 9380 appendix E.3 constants bit-exactly (pinned in
  tests/test_bls12_381.py), so outputs are byte-compatible with blst.

Round 1's SVDW deviation is gone; every hash path is the spec ciphersuite.
"""
from __future__ import annotations

import hashlib
import struct

from .curve import H_EFF_G2_RFC, Point, G2Point, B_G2
from .fields import Fp, Fp2, P

DST_POP = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

_L = 64  # ceil((ceil(log2(p)) + k) / 8) = ceil((381 + 128)/8)
_B_IN_BYTES = 32
_R_IN_BYTES = 64


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * _R_IN_BYTES
    l_i_b_str = struct.pack(">H", len_in_bytes)
    b0 = hashlib.sha256(
        z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [b1]
    for i in range(2, ell + 1):
        prev = out[-1]
        xored = bytes(a ^ b for a, b in zip(b0, prev))
        out.append(hashlib.sha256(xored + bytes([i]) + dst_prime).digest())
    return b"".join(out)[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes) -> list[Fp2]:
    len_in_bytes = count * 2 * _L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coeffs = []
        for j in range(2):
            off = _L * (j + i * 2)
            coeffs.append(Fp(int.from_bytes(uniform[off:off + _L], "big")))
        out.append(Fp2(coeffs[0], coeffs[1]))
    return out


# -- simplified SWU on E' + 3-isogeny to E (RFC 9380 §6.6.2, §8.8.2) ---------

# E': y^2 = x^3 + A'x + B'
ISO_A = Fp2(0, 240)
ISO_B = Fp2(1012, 1012)
SSWU_Z = Fp2(-2 % P, -1 % P)          # Z = -(2 + i)


def map_to_curve_sswu_prime(u: Fp2) -> tuple[Fp2, Fp2]:
    """Simplified SWU onto E' (not E!); compose with iso_map_g2."""
    zu2 = SSWU_Z * u.square()
    tv1 = zu2.square() + zu2
    if tv1.is_zero():
        x1 = ISO_B * (SSWU_Z * ISO_A).inv()
    else:
        x1 = (-ISO_B) * ISO_A.inv() * (Fp2(1, 0) + tv1.inv())
    gx1 = x1 * x1 * x1 + ISO_A * x1 + ISO_B
    if gx1.is_square():
        x, y = x1, gx1.sqrt()
    else:
        x2 = zu2 * x1
        gx2 = x2 * x2 * x2 + ISO_A * x2 + ISO_B
        x, y = x2, gx2.sqrt()
    if u.sgn0() != y.sgn0():
        y = -y
    return x, y


def _derive_iso_constants():
    """Vélu's formulas for the 3-isogeny E' -> E with kernel x0 = -6+6i,
    composed with (x,y) -> (x/9, -y/27) (the RFC's orientation).  Returns
    (x_num, x_den, y_num, y_den) coefficient lists, low degree first;
    denominators monic with the leading 1 omitted (RFC E.3 layout)."""
    x0 = Fp2(-6 % P, 6)
    assert (x0.square().square() * 3 + x0.square() * (ISO_A * 6)
            + x0 * (ISO_B * 12) - ISO_A.square()).is_zero(), \
        "x0 must be a root of the 3rd division polynomial"
    gx0 = x0 * x0 * x0 + ISO_A * x0 + ISO_B          # y0^2
    t1 = (x0.square() * 3 + ISO_A) * 2               # Σ_kernel t_Q
    u = gx0 * 4                                      # Σ_kernel 2 y_Q^2
    w = (gx0 * 2 + x0 * (x0.square() * 3 + ISO_A)) * 2
    # image curve must be 3^6-isomorphic to E: (0, 2916(1+i)) -> c = 1/3
    assert (ISO_A - t1 * 5).is_zero() and \
        (ISO_B - w * 7) == Fp2(4 * 729, 4 * 729)
    inv9 = Fp2(pow(9, P - 2, P), 0)
    inv27 = Fp2(pow(27, P - 2, P), 0)
    x_num = [(u - t1 * x0) * inv9, (x0.square() + t1) * inv9,
             (-x0 * 2) * inv9, inv9]
    x_den = [x0.square(), -x0 * 2]                   # + x^2
    y_num = [-((-(x0 * x0 * x0) + t1 * x0 - u * 2) * inv27),
             -((x0.square() * 3 - t1) * inv27),
             -((-x0 * 3) * inv27), -inv27]
    y_den = [-(x0 * x0 * x0), x0.square() * 3, -x0 * 3]  # + x^3
    return x_num, x_den, y_num, y_den


ISO_X_NUM, ISO_X_DEN, ISO_Y_NUM, ISO_Y_DEN = _derive_iso_constants()


def _horner(coeffs: list[Fp2], x: Fp2, monic: bool) -> Fp2:
    acc = Fp2(1, 0) if monic else coeffs[-1]
    start = len(coeffs) - 1 if monic else len(coeffs) - 2
    for i in range(start, -1, -1):
        acc = acc * x + coeffs[i]
    return acc


def iso_map_g2(x: Fp2, y: Fp2) -> tuple[Fp2, Fp2] | None:
    """The 3-isogeny E' -> E as rational maps (RFC 9380 appendix E.3).
    Returns None (the point at infinity) on the exceptional kernel inputs
    where a denominator vanishes (RFC 9380 §4.1 inv0 convention)."""
    xn = _horner(ISO_X_NUM, x, monic=False)
    xd = _horner(ISO_X_DEN, x, monic=True)
    yn = _horner(ISO_Y_NUM, x, monic=False)
    yd = _horner(ISO_Y_DEN, x, monic=True)
    if xd.is_zero() or yd.is_zero():
        return None
    return xn * xd.inv(), y * yn * yd.inv()


def map_to_curve_sswu(u: Fp2) -> Point:
    affine = iso_map_g2(*map_to_curve_sswu_prime(u))
    if affine is None:
        return Point.infinity(B_G2)
    return G2Point(*affine)


def clear_cofactor_g2(p: Point) -> Point:
    return p.mul(H_EFF_G2_RFC)


def hash_to_g2(msg: bytes, dst: bytes = DST_POP) -> Point:
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = map_to_curve_sswu(u0)
    q1 = map_to_curve_sswu(u1)
    return clear_cofactor_g2(q0.add(q1))
