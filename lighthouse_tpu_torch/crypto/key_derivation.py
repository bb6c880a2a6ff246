"""EIP-2333 BLS key derivation (crypto/eth2_key_derivation equivalent)."""
from __future__ import annotations

import hashlib
import hmac

from .bls12_381.fields import R


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out, t, i = b"", b"", 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def _hkdf_mod_r(ikm: bytes, key_info: bytes = b"") -> int:
    salt = b"BLS-SIG-KEYGEN-SALT-"
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R
    return sk


def _parent_sk_to_lamport_pk(parent_sk: int, index: int) -> bytes:
    salt = index.to_bytes(4, "big")
    ikm = parent_sk.to_bytes(32, "big")
    lamport_0 = _hkdf_expand(_hkdf_extract(salt, ikm), b"", 8160)
    not_ikm = bytes(b ^ 0xFF for b in ikm)
    lamport_1 = _hkdf_expand(_hkdf_extract(salt, not_ikm), b"", 8160)
    combined = b"".join(
        hashlib.sha256(chunk[i * 32:(i + 1) * 32]).digest()
        for chunk in (lamport_0, lamport_1) for i in range(255))
    return hashlib.sha256(combined).digest()


def derive_master_sk(seed: bytes) -> int:
    if len(seed) < 32:
        raise ValueError("seed too short")
    return _hkdf_mod_r(seed)


def derive_child_sk(parent_sk: int, index: int) -> int:
    return _hkdf_mod_r(_parent_sk_to_lamport_pk(parent_sk, index))


def derive_path(seed: bytes, path: str) -> int:
    """e.g. m/12381/3600/0/0/0 (EIP-2334)."""
    parts = path.split("/")
    if parts[0] != "m":
        raise ValueError("path must start with m")
    sk = derive_master_sk(seed)
    for p in parts[1:]:
        sk = derive_child_sk(sk, int(p))
    return sk
