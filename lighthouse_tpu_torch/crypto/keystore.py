"""EIP-2335 keystores (scrypt + AES-128-CTR).

Equivalent of the reference's crypto/eth2_keystore (2.9k LoC): encrypt BLS
secret keys at rest; stdlib hashlib.scrypt + the `cryptography` package's AES
(both baked into the image). EIP-2333 hierarchical derivation lives in
key_derivation.py.
"""
from __future__ import annotations

import hashlib
import os
import uuid

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

from . import bls


def _scrypt(password: bytes, salt: bytes) -> bytes:
    return hashlib.scrypt(password, salt=salt, n=16384, r=8, p=1, dklen=32,
                          maxmem=64 * 1024 * 1024 * 2)


def encrypt_secret(secret: bytes, password: bytes) -> dict:
    """EIP-2335 crypto envelope over raw secret bytes (also the seed
    envelope for EIP-2386 wallets)."""
    salt = os.urandom(32)
    iv = os.urandom(16)
    dk = _scrypt(password, salt)
    cipher = Cipher(algorithms.AES(dk[:16]), modes.CTR(iv))
    enc = cipher.encryptor()
    ciphertext = enc.update(secret) + enc.finalize()
    checksum = hashlib.sha256(dk[16:32] + ciphertext).hexdigest()
    return {
        "kdf": {"function": "scrypt",
                "params": {"dklen": 32, "n": 16384, "p": 1, "r": 8,
                           "salt": salt.hex()},
                "message": ""},
        "checksum": {"function": "sha256", "params": {},
                     "message": checksum},
        "cipher": {"function": "aes-128-ctr",
                   "params": {"iv": iv.hex()},
                   "message": ciphertext.hex()},
    }


def decrypt_secret(crypto: dict, password: bytes) -> bytes:
    if crypto["kdf"]["function"] != "scrypt":
        raise ValueError("unsupported kdf")
    params = crypto["kdf"]["params"]
    dk = hashlib.scrypt(password, salt=bytes.fromhex(params["salt"]),
                        n=params["n"], r=params["r"], p=params["p"],
                        dklen=params["dklen"],
                        maxmem=64 * 1024 * 1024 * 2)
    ciphertext = bytes.fromhex(crypto["cipher"]["message"])
    checksum = hashlib.sha256(dk[16:32] + ciphertext).hexdigest()
    if checksum != crypto["checksum"]["message"]:
        raise ValueError("bad password (checksum mismatch)")
    iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
    cipher = Cipher(algorithms.AES(dk[:16]), modes.CTR(iv))
    dec = cipher.decryptor()
    return dec.update(ciphertext) + dec.finalize()


def create_keystore(sk: int, password: bytes,
                    path: str = "m/12381/3600/0/0/0") -> dict:
    pubkey = bls.sk_to_pk(sk)
    return {
        "crypto": encrypt_secret(sk.to_bytes(32, "big"), password),
        "description": "lighthouse_tpu keystore",
        "pubkey": pubkey.hex(),
        "path": path,
        "uuid": str(uuid.uuid4()),
        "version": 4,
    }


def decrypt_keystore(keystore: dict, password: bytes) -> int:
    return int.from_bytes(decrypt_secret(keystore["crypto"], password),
                          "big")
