"""BLS signatures (min-pubkey-size: pk in G1/48B, sig in G2/96B) +
ZCash-format point compression + random-linear-combination batch verify.

Mirrors the reference's hot function `verify_signature_sets`
(crypto/bls/src/impls/blst.rs:37-119): draw 64-bit random scalars (first set
scalar may be 1), scale (pk_i, sig_i) by r_i, aggregate scaled signatures,
then one multi-pairing:  prod_i e(r_i·pk_i, H(m_i)) · e(-g1, sum r_i·sig_i) == 1.
"""
from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

from .curve import (
    B_G1, B_G2, G1_GENERATOR, G2_GENERATOR, Point,
)
from .fields import Fp, Fp2, P, R
from .hash_to_curve import DST_POP, hash_to_g2
from .pairing import multi_pairing

RAND_BITS = 64  # crypto/bls/src/impls/blst.rs:16


def keygen_interop(index: int) -> int:
    """Deterministic interop secret keys (common/eth2_interop_keypairs)."""
    h = hashlib.sha256(index.to_bytes(32, "little")).digest()
    return int.from_bytes(h, "little") % R


def sk_to_pk(sk: int) -> Point:
    return G1_GENERATOR.mul(sk)


def sign(sk: int, msg: bytes, dst: bytes = DST_POP) -> Point:
    return hash_to_g2(msg, dst).mul(sk)


def verify(pk: Point, msg: bytes, sig: Point, dst: bytes = DST_POP) -> bool:
    if sig.is_infinity() or pk.is_infinity():
        return False
    if not (sig.is_on_curve() and sig.in_subgroup()):
        return False
    h = hash_to_g2(msg, dst)
    return multi_pairing([(G1_GENERATOR.neg(), sig), (pk, h)]).is_one()


def aggregate_signatures(sigs: list[Point]) -> Point:
    out = Point.infinity(B_G2)
    for s in sigs:
        out = out.add(s)
    return out


def aggregate_pubkeys(pks: list[Point]) -> Point:
    out = Point.infinity(B_G1)
    for p in pks:
        out = out.add(p)
    return out


def fast_aggregate_verify(pks: list[Point], msg: bytes, sig: Point,
                          dst: bytes = DST_POP) -> bool:
    """All pubkeys signed the same message."""
    if not pks:
        return False
    return verify(aggregate_pubkeys(pks), msg, sig, dst)


def aggregate_verify(pks: list[Point], msgs: list[bytes], sig: Point,
                     dst: bytes = DST_POP) -> bool:
    """pk_i signed msg_i; one aggregate signature."""
    if not pks or len(pks) != len(msgs):
        return False
    if sig.is_infinity():
        return False
    if not (sig.is_on_curve() and sig.in_subgroup()):
        return False
    pairs = [(G1_GENERATOR.neg(), sig)]
    for pk, m in zip(pks, msgs):
        pairs.append((pk, hash_to_g2(m, dst)))
    return multi_pairing(pairs).is_one()


@dataclass
class SignatureSet:
    """One verification unit: sig over msg by (possibly aggregated) pubkeys."""
    signature: Point
    pubkeys: list[Point]            # aggregated before pairing
    message: bytes                  # 32-byte signing root


def verify_signature_sets_rlc(sets: list[SignatureSet],
                              dst: bytes = DST_POP,
                              rand_fn=None) -> bool:
    """Batched verify via random linear combination + one multi-pairing."""
    if not sets:
        return False
    rand_fn = rand_fn or (lambda: secrets.randbits(RAND_BITS) | 1)
    agg_sig = Point.infinity(B_G2)
    pairs: list[tuple[Point, Point]] = []
    for s in sets:
        if s.signature.is_infinity() or not s.pubkeys:
            return False
        if not (s.signature.is_on_curve() and s.signature.in_subgroup()):
            return False
        r = 1 if len(sets) == 1 else rand_fn()
        pk = aggregate_pubkeys(s.pubkeys)
        if pk.is_infinity():
            return False
        agg_sig = agg_sig.add(s.signature.mul(r))
        pairs.append((pk.mul(r), hash_to_g2(s.message, dst)))
    pairs.append((G1_GENERATOR.neg(), agg_sig))
    return multi_pairing(pairs).is_one()


# -- ZCash-format compression ------------------------------------------------

def _fp2_lex_larger(y: Fp2) -> bool:
    if int(y.c1) != 0:
        return int(y.c1) * 2 > P
    return int(y.c0) * 2 > P


def g1_compress(p: Point) -> bytes:
    if p.is_infinity():
        return bytes([0xC0]) + b"\x00" * 47
    x, y = p.to_affine()
    flags = 0x80 | (0x20 if int(y) * 2 > P else 0)
    out = bytearray(int(x).to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g1_decompress(data: bytes, subgroup_check: bool = True) -> Point | None:
    if len(data) != 48 or not data[0] & 0x80:
        return None
    if data[0] & 0x40:  # infinity
        if data[0] != 0xC0 or any(data[1:]):
            return None
        return Point.infinity(B_G1)
    y_flag = bool(data[0] & 0x20)
    x_int = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x_int >= P:
        return None
    x = Fp(x_int)
    y = (x * x * x + B_G1).sqrt()
    if y is None:
        return None
    if (int(y) * 2 > P) != y_flag:
        y = -y
    pt = Point.from_affine(x, y, B_G1)
    if subgroup_check and not pt.in_subgroup():
        return None
    return pt


def g2_compress(p: Point) -> bytes:
    if p.is_infinity():
        return bytes([0xC0]) + b"\x00" * 95
    x, y = p.to_affine()
    flags = 0x80 | (0x20 if _fp2_lex_larger(y) else 0)
    out = bytearray(int(x.c1).to_bytes(48, "big") +
                    int(x.c0).to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g2_decompress(data: bytes, subgroup_check: bool = True) -> Point | None:
    if len(data) != 96 or not data[0] & 0x80:
        return None
    if data[0] & 0x40:
        if data[0] != 0xC0 or any(data[1:]):
            return None
        return Point.infinity(B_G2)
    y_flag = bool(data[0] & 0x20)
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        return None
    x = Fp2(x0, x1)
    y = (x * x * x + B_G2).sqrt()
    if y is None:
        return None
    if _fp2_lex_larger(y) != y_flag:
        y = -y
    pt = Point.from_affine(x, y, B_G2)
    if subgroup_check and not pt.in_subgroup():
        return None
    return pt
