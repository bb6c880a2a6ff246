"""Swap-or-not shuffle, vectorized.

Equivalent of the reference's consensus/swap_or_not_shuffle/src/shuffle_list.rs
(whole-list shuffle, :1-40). The reference walks the list imperatively; here
every round transforms the entire index vector at once with numpy, and the
per-round randomness (SHA-256 of seed||round||block) is batched through the
C++ host hasher's short-message entry (utils/native_hash.py).
"""
from __future__ import annotations

import hashlib

import numpy as np


def _round_pivot(seed: bytes, r: int, n: int) -> int:
    h = hashlib.sha256(seed + bytes([r])).digest()
    return int.from_bytes(h[:8], "little") % n


def _round_source_bits(seed: bytes, r: int, n: int) -> np.ndarray:
    """All randomness bits for a round: bit array of length >= n."""
    num_blocks = (n + 255) // 256
    blocks = bytearray()
    for block in range(num_blocks):
        blocks += hashlib.sha256(
            seed + bytes([r]) + block.to_bytes(4, "little")).digest()
    byts = np.frombuffer(bytes(blocks), dtype=np.uint8)
    return np.unpackbits(byts, bitorder="little")


def _all_round_source_digests(seed: bytes, rounds: int,
                              n: int) -> np.ndarray | None:
    """Every round's source digests in ONE native batch call:
    (rounds, num_blocks*32) uint8, or None without the native hasher.

    At 1M validators this is rounds*ceil(n/256) = ~352k independent
    37-byte hashes — the dominant scalar cost of the shuffle before this
    batching (shuffle_list.rs leans on the same per-round block layout).
    """
    from ..utils.native_hash import hash_short_batch
    num_blocks = (n + 255) // 256
    if rounds * num_blocks < 512:       # FFI wins only in bulk
        return None
    # message layout: seed(32) | round(1) | block_u32le(4)
    buf = np.empty((rounds, num_blocks, 37), np.uint8)
    buf[:, :, :32] = np.frombuffer(seed, np.uint8)
    buf[:, :, 32] = np.arange(rounds, dtype=np.uint8)[:, None]
    buf[:, :, 33:] = np.arange(num_blocks, dtype="<u4") \
        .view(np.uint8).reshape(num_blocks, 4)[None, :, :]
    out = hash_short_batch(buf.tobytes(), 37)
    if out is None:
        return None
    return np.frombuffer(out, np.uint8).reshape(rounds, num_blocks * 32)


def compute_shuffled_indices(n: int, seed: bytes,
                             rounds: int) -> np.ndarray:
    """Vector of sigma(i) for i in 0..n: position -> source index.

    shuffled_list[i] == input[out[i]] reproduces the spec's
    compute_shuffled_index applied index-wise (forward direction).
    """
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    idx = np.arange(n, dtype=np.int64)
    digests = _all_round_source_digests(seed, rounds, n)
    # the scalar spec transform, applied to every index at once, round by round
    for r in range(rounds):
        pivot = _round_pivot(seed, r, n)
        flip = (pivot - idx) % n
        pos = np.maximum(idx, flip)
        if digests is not None:
            bits = np.unpackbits(digests[r], bitorder="little")
        else:
            bits = _round_source_bits(seed, r, n)
        idx = np.where(bits[pos] == 1, flip, idx)
    return idx


def compute_shuffled_index_batch(positions: np.ndarray, n: int, seed: bytes,
                                 rounds: int) -> np.ndarray:
    """``sigma[positions]`` without materializing the whole permutation.

    The proposer seed folds in the slot, so every block queries a fresh
    shuffle — but rejection sampling only ever looks at a handful of
    candidate positions, and shuffling all n indices (90 numpy passes
    over the full vector at 1M validators) to read a few of them is the
    dominant per-block state-transition cost.  This runs the scalar spec
    transform over just the queried positions, with each round's source
    digests deduped per 256-index block and batched through the native
    hasher.
    """
    if len(positions) == 0:
        return np.zeros(0, dtype=np.int64)
    from ..utils.native_hash import hash_short_batch
    idx = np.asarray(positions, dtype=np.int64).copy()
    for r in range(rounds):
        pivot = _round_pivot(seed, r, n)
        flip = (pivot - idx) % n
        pos = np.maximum(idx, flip)
        blocks = np.unique(pos // 256)
        msgs = np.empty((len(blocks), 37), np.uint8)
        msgs[:, :32] = np.frombuffer(seed, np.uint8)
        msgs[:, 32] = r
        msgs[:, 33:] = blocks.astype("<u4").view(np.uint8).reshape(-1, 4)
        raw = hash_short_batch(msgs.tobytes(), 37)
        if raw is None:
            raw = b"".join(
                hashlib.sha256(
                    seed + bytes([r]) + int(b).to_bytes(4, "little")
                ).digest() for b in blocks)
        digests = np.frombuffer(raw, np.uint8).reshape(len(blocks), 32)
        bits = np.unpackbits(digests, axis=1, bitorder="little")
        bit = bits[np.searchsorted(blocks, pos // 256), pos % 256]
        idx = np.where(bit == 1, flip, idx)
    return idx


def compute_shuffled_index(index: int, n: int, seed: bytes,
                           rounds: int) -> int:
    """Spec-exact scalar compute_shuffled_index (forward)."""
    assert 0 <= index < n
    for r in range(rounds):
        pivot = _round_pivot(seed, r, n)
        flip = (pivot + n - index) % n
        position = max(index, flip)
        source = hashlib.sha256(
            seed + bytes([r]) + (position // 256).to_bytes(4, "little")
        ).digest()
        byte = source[(position % 256) // 8]
        bit = (byte >> (position % 8)) & 1
        index = flip if bit else index
    return index


def shuffle_list(values: np.ndarray, seed: bytes, rounds: int) -> np.ndarray:
    """Shuffled copy with spec orientation: out[i] = values[sigma(i)], so
    committees are contiguous slices of the output (compute_committee)."""
    sigma = compute_shuffled_indices(len(values), seed, rounds)
    return values[sigma]
