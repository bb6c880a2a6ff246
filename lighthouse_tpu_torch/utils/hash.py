"""SHA-256 hashing utilities (host side).

Equivalent of the reference's `ethereum_hashing` crate (SHA-NI/asm accelerated,
see Cargo.toml:121 and lighthouse/src/main.rs:15,41 of the reference). The
host path here uses OpenSSL via hashlib (which already dispatches to SHA-NI);
the device path lives in `lighthouse_tpu_torch.ops.sha256` as CUDA kernels.
"""
from __future__ import annotations

import hashlib


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def hash_concat(a: bytes, b: bytes) -> bytes:
    """hash(a || b) — the merkle node combiner."""
    h = hashlib.sha256()
    h.update(a)
    h.update(b)
    return h.digest()


def _build_zero_hashes(depth: int = 64) -> list[bytes]:
    zh = [b"\x00" * 32]
    for _ in range(depth):
        zh.append(hash_concat(zh[-1], zh[-1]))
    return zh


#: ZERO_HASHES[i] = root of an all-zero merkle subtree of depth i.
ZERO_HASHES: list[bytes] = _build_zero_hashes()
