"""secp256k1 for the identity layer: deterministic ECDSA (RFC 6979) and
ECDH returning the compressed shared point.

Self-contained by design: ENR "v4" signatures (EIP-778) need
deterministic low-s 64-byte r||s signatures over a keccak256 digest, and
discv5 v5.1 session-key agreement needs the *compressed point* of the
ECDH result — neither shape is exposed by the `cryptography` package's
DER/x-only APIs.  Handshake-rate usage only (a few ops per peer), so
pure Python with Jacobian coordinates is plenty.

Ref parity: the reference's ENR/discv5 key handling lives in the
`discv5` + `k256` crates (beacon_node/lighthouse_network/src/discovery/
enr.rs:186 builds/signs records; CombinedKey = k256 ECDSA).
"""
from __future__ import annotations

import hashlib
import hmac

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
_INF = None


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


# Jacobian point arithmetic ---------------------------------------------------

def _to_jac(pt):
    return (pt[0], pt[1], 1) if pt is not _INF else (0, 0, 0)


def _from_jac(j):
    if j[2] == 0:
        return _INF
    zi = _inv(j[2], P)
    zi2 = zi * zi % P
    return (j[0] * zi2 % P, j[1] * zi2 * zi % P)


def _jac_double(j):
    x, y, z = j
    if z == 0 or y == 0:
        return (0, 0, 0)
    s = 4 * x * y * y % P
    m = 3 * x * x % P            # a = 0 for secp256k1
    x2 = (m * m - 2 * s) % P
    y2 = (m * (s - x2) - 8 * pow(y, 4, P)) % P
    z2 = 2 * y * z % P
    return (x2, y2, z2)


def _jac_add(j1, j2):
    if j1[2] == 0:
        return j2
    if j2[2] == 0:
        return j1
    x1, y1, z1 = j1
    x2, y2, z2 = j2
    z1s, z2s = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * z2s % P, x2 * z1s % P
    s1, s2 = y1 * z2s * z2 % P, y2 * z1s * z1 % P
    if u1 == u2:
        if s1 != s2:
            return (0, 0, 0)
        return _jac_double(j1)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    h2 = h * h % P
    h3 = h2 * h % P
    x3 = (r * r - h3 - 2 * u1 * h2) % P
    y3 = (r * (u1 * h2 - x3) - s1 * h3) % P
    z3 = h * z1 * z2 % P
    return (x3, y3, z3)


def _mul(k: int, pt):
    """Scalar multiple k*pt (affine in/out)."""
    acc = (0, 0, 0)
    add = _to_jac(pt)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    return _from_jac(acc)


def pubkey(priv: int):
    return _mul(priv, (GX, GY))


# encodings -------------------------------------------------------------------

def compress(pt) -> bytes:
    x, y = pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def uncompressed64(pt) -> bytes:
    """x||y without the 0x04 prefix (the ENR node-id input form)."""
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def decompress(data: bytes):
    if len(data) == 65 and data[0] == 4:
        pt = (int.from_bytes(data[1:33], "big"),
              int.from_bytes(data[33:], "big"))
    elif len(data) == 33 and data[0] in (2, 3):
        x = int.from_bytes(data[1:], "big")
        if x >= P:
            raise ValueError("x out of range")
        y2 = (pow(x, 3, P) + 7) % P
        y = pow(y2, (P + 1) // 4, P)
        if y * y % P != y2:
            raise ValueError("not on curve")
        if (y & 1) != (data[0] & 1):
            y = P - y
        pt = (x, y)
    else:
        raise ValueError("bad public key encoding")
    if not on_curve(pt):
        raise ValueError("not on curve")
    return pt


def on_curve(pt) -> bool:
    x, y = pt
    return 0 < x < P and 0 < y < P and \
        (y * y - pow(x, 3, P) - 7) % P == 0


# RFC 6979 deterministic nonce (HMAC-SHA256) ----------------------------------

def _rfc6979_k(priv: int, digest32: bytes) -> int:
    x = priv.to_bytes(32, "big")
    h1 = digest32
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(priv: int, digest32: bytes) -> bytes:
    """Deterministic low-s signature over a 32-byte digest -> r||s (64B).

    Matches libsecp256k1/k256 default signing (RFC 6979 SHA-256 nonce,
    low-s normalized) — required to reproduce EIP-778's sample record.
    """
    z = int.from_bytes(digest32, "big") % N
    while True:
        k = _rfc6979_k(priv, digest32)
        pt = _mul(k, (GX, GY))
        r = pt[0] % N
        if r == 0:
            digest32 = hashlib.sha256(digest32).digest()
            continue
        s = _inv(k, N) * (z + r * priv) % N
        if s == 0:
            digest32 = hashlib.sha256(digest32).digest()
            continue
        if s > N // 2:
            s = N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def verify(pub_pt, digest32: bytes, sig64: bytes) -> bool:
    if len(sig64) != 64:
        return False
    r = int.from_bytes(sig64[:32], "big")
    s = int.from_bytes(sig64[32:], "big")
    if not (1 <= r < N and 1 <= s < N):
        return False
    z = int.from_bytes(digest32, "big") % N
    w = _inv(s, N)
    u1, u2 = z * w % N, r * w % N
    pt = _from_jac(_jac_add(_to_jac(_mul(u1, (GX, GY))),
                            _to_jac(_mul(u2, pub_pt))))
    if pt is _INF:
        return False
    return pt[0] % N == r


def ecdh(pub_pt, priv: int) -> bytes:
    """discv5 v5.1 ecdh(): compressed 33-byte shared point."""
    return compress(_mul(priv, pub_pt))
