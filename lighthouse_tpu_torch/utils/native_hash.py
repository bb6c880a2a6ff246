"""ctypes binding for the C++ batch SHA-256 (native/sha256_host.cpp).

The host-side analog of `ethereum_hashing`: one FFI crossing per merkle
level. The library is built by g++ into lighthouse_tpu_torch/_build/ at
first use (never into native/), and a failed build or load raises: the
port's host hashing has no silent fallback. ``hash_short_batch`` returns
None only for messages longer than one padded block, where its callers
hash with hashlib.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from .gxx import NATIVE, build

_lib = None


def get_lib():
    """The loaded library (built at the first call); raises if it does
    not build or load."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build(NATIVE / "sha256_host.cpp", "sha256host")))
    lib.sha256_have_shani.restype = ctypes.c_int
    lib.sha256_hash64_batch.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_uint64]
    lib.sha256_merkle_root.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                       ctypes.c_char_p, ctypes.c_char_p]
    lib.sha256_oneshot.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_char_p]
    lib.sha256_merkle_root_mt.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_uint32]
    lib.sha256_hash64_batch_mt.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint32]
    lib.sha256_short_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_uint64]
    _lib = lib
    return _lib


def have_shani() -> bool:
    lib = get_lib()
    return bool(lib.sha256_have_shani())


def hash64_batch(data: bytes) -> bytes:
    """n*64 bytes in -> n*32 digests out."""
    lib = get_lib()
    n = len(data) // 64
    out = ctypes.create_string_buffer(n * 32)
    lib.sha256_hash64_batch(data, out, n)
    return out.raw


def hash_short_batch(data: bytes, msg_len: int) -> bytes | None:
    """n independent msg_len-byte messages (msg_len <= 55, one padded
    block each) -> n*32 digests; None when msg_len > 55 (callers keep a
    hashlib loop for that case)."""
    if msg_len > 55:
        return None
    lib = get_lib()
    n = len(data) // msg_len
    out = ctypes.create_string_buffer(n * 32)
    lib.sha256_short_batch(data, msg_len, out, n)
    return out.raw


def merkle_root_pow2(leaves: bytes, threads: int | None = None) -> bytes:
    """Dense merkle root of a power-of-two number of 32-byte leaves
    (threaded across cores for big trees)."""
    lib = get_lib()
    n = len(leaves) // 32
    root = ctypes.create_string_buffer(32)
    t = threads if threads is not None else (os.cpu_count() or 1)
    if t > 1:
        # the threaded variant ping-pongs levels across two scratch halves
        scratch = ctypes.create_string_buffer(max(64, n * 32))
        lib.sha256_merkle_root_mt(leaves, n, root, scratch, t)
    else:
        scratch = ctypes.create_string_buffer(max(32, (n // 2) * 32))
        lib.sha256_merkle_root(leaves, n, root, scratch)
    return root.raw


class HostTree:
    """Incremental dense merkle tree over 32-byte chunks on the host
    hasher: build all levels once, then re-hash only the root paths of
    dirty chunks (the `update_tree_hash_cache` semantics of the
    reference's tree-states, on SHA-NI instead of a persistent tree).

    Memory: 2x the padded leaf bytes.  Update cost: O(dirty * depth)
    hashes instead of O(n)."""

    def __init__(self, chunks: np.ndarray, limit_chunks: int):
        n = int(chunks.shape[0])
        self.n = n
        self.limit_depth = max(0, (limit_chunks - 1).bit_length())
        dense = 1 if n <= 1 else 1 << (n - 1).bit_length()
        level0 = np.zeros((dense, 32), np.uint8)
        level0[:n] = chunks
        self.levels = [level0]
        size = dense
        while size > 1:
            out = hash64_batch(self.levels[-1].tobytes())
            self.levels.append(
                np.frombuffer(out, np.uint8).reshape(size // 2, 32).copy())
            size //= 2

    def update(self, idx: np.ndarray, new_chunks: np.ndarray) -> None:
        """Overwrite chunks at `idx` and re-hash their paths to the root."""
        self.levels[0][idx] = new_chunks
        cur = np.unique(np.asarray(idx, dtype=np.int64) // 2)
        for li in range(1, len(self.levels)):
            pairs = self.levels[li - 1].reshape(-1, 64)[cur]
            out = hash64_batch(pairs.tobytes())
            self.levels[li][cur] = np.frombuffer(
                out, np.uint8).reshape(len(cur), 32)
            cur = np.unique(cur // 2)

    def copy(self) -> "HostTree":
        out = HostTree.__new__(HostTree)
        out.n = self.n
        out.limit_depth = self.limit_depth
        out.levels = [lvl.copy() for lvl in self.levels]
        return out

    def root(self) -> bytes:
        from .hash import ZERO_HASHES, hash_concat
        r = self.levels[-1][0].tobytes()
        dense_depth = (int(self.levels[0].shape[0]) - 1).bit_length()
        for d in range(dense_depth, self.limit_depth):
            r = hash_concat(r, ZERO_HASHES[d])
        return r


def overlay_root(tree: HostTree, idx: np.ndarray,
                 new_chunks: np.ndarray) -> bytes:
    """Root of ``tree`` with the chunks at ``idx`` replaced by
    ``new_chunks`` — WITHOUT mutating or cloning the tree.

    A sparse overlay of changed nodes is carried up level by level,
    reading every untouched sibling from the shared levels.  This is the
    fork fan-out path: dozens of live state copies can each report an
    incremental root against ONE shared tree, paying O(dirty * depth)
    hashes and zero level memory instead of HostTree.copy()'s 2x padded
    leaf bytes per fork."""
    overlay = {int(i): new_chunks[j].tobytes()
               for j, i in enumerate(np.asarray(idx, np.int64))}
    for li in range(1, len(tree.levels)):
        prev = tree.levels[li - 1]
        parents = sorted({i >> 1 for i in overlay})
        buf = np.empty((len(parents), 64), np.uint8)
        for j, p in enumerate(parents):
            left = overlay.get(2 * p)
            buf[j, :32] = (np.frombuffer(left, np.uint8)
                           if left is not None else prev[2 * p])
            right = overlay.get(2 * p + 1)
            buf[j, 32:] = (np.frombuffer(right, np.uint8)
                           if right is not None else prev[2 * p + 1])
        out = hash64_batch(buf.tobytes())
        overlay = {p: out[32 * j:32 * j + 32]
                   for j, p in enumerate(parents)}
    r = overlay.get(0, tree.levels[-1][0].tobytes())
    dense_depth = (int(tree.levels[0].shape[0]) - 1).bit_length()
    from .hash import ZERO_HASHES, hash_concat
    for d in range(dense_depth, tree.limit_depth):
        r = hash_concat(r, ZERO_HASHES[d])
    return r


