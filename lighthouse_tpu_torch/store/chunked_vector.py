"""Chunked root vectors for the freezer.

Equivalent of the reference's beacon_node/store/src/chunked_vector.rs:
instead of one KV entry per slot, 32-byte roots are packed into
fixed-size chunks (CHUNK_SIZE roots per entry).  Range reads touch
O(range / CHUNK_SIZE) entries instead of O(range), and the freezer holds
~128x fewer keys — the property lighthouse's forwards iterators and
historical reconstruction depend on.

Layout: key = prefix + chunk_index (be64); value = concatenated 32-byte
roots (possibly short in the tail chunk).  Gaps are zero-filled: a slot
whose root was never recorded reads as None (all-zero sentinel), which
matches the reference's default-chunk behavior for pre-anchor slots.
"""
from __future__ import annotations

import struct

CHUNK_SIZE = 128
ROOT_LEN = 32
_ZERO = b"\x00" * ROOT_LEN


class ChunkedRootVector:
    def __init__(self, kv, prefix: bytes):
        self.kv = kv
        self.prefix = prefix

    def _key(self, chunk_index: int) -> bytes:
        return self.prefix + struct.pack(">Q", chunk_index)

    def put(self, slot: int, root: bytes) -> None:
        if len(root) != ROOT_LEN:
            raise ValueError("root must be 32 bytes")
        ci, off = divmod(slot, CHUNK_SIZE)
        chunk = bytearray(self.kv.get(self._key(ci)) or b"")
        need = (off + 1) * ROOT_LEN
        if len(chunk) < need:
            chunk += b"\x00" * (need - len(chunk))
        chunk[off * ROOT_LEN:(off + 1) * ROOT_LEN] = root
        self.kv.put(self._key(ci), bytes(chunk))

    def stage_puts(self, puts: dict[int, bytes]) -> list[tuple]:
        """Fold many slot->root writes into per-chunk KV put ops (one op
        per touched chunk) WITHOUT writing — the caller commits them in an
        atomic `do_atomically` batch alongside its other freezer writes.
        The read-modify-write of each chunk happens here, against the
        currently-visible chunk contents."""
        by_chunk: dict[int, dict[int, bytes]] = {}
        for slot, root in puts.items():
            if len(root) != ROOT_LEN:
                raise ValueError("root must be 32 bytes")
            ci, off = divmod(slot, CHUNK_SIZE)
            by_chunk.setdefault(ci, {})[off] = root
        ops: list[tuple] = []
        for ci in sorted(by_chunk):
            chunk = bytearray(self.kv.get(self._key(ci)) or b"")
            for off, root in sorted(by_chunk[ci].items()):
                need = (off + 1) * ROOT_LEN
                if len(chunk) < need:
                    chunk += b"\x00" * (need - len(chunk))
                chunk[off * ROOT_LEN:(off + 1) * ROOT_LEN] = root
            ops.append(("put", self._key(ci), bytes(chunk)))
        return ops

    def get(self, slot: int) -> bytes | None:
        ci, off = divmod(slot, CHUNK_SIZE)
        chunk = self.kv.get(self._key(ci))
        if chunk is None or len(chunk) < (off + 1) * ROOT_LEN:
            return None
        root = bytes(chunk[off * ROOT_LEN:(off + 1) * ROOT_LEN])
        return None if root == _ZERO else root

    def range(self, start_slot: int, end_slot: int):
        """Yield (slot, root|None) for start <= slot < end, reading each
        chunk once."""
        if end_slot <= start_slot:
            return
        ci_start = start_slot // CHUNK_SIZE
        ci_end = (end_slot - 1) // CHUNK_SIZE
        for ci in range(ci_start, ci_end + 1):
            chunk = self.kv.get(self._key(ci)) or b""
            base = ci * CHUNK_SIZE
            lo = max(start_slot, base)
            hi = min(end_slot, base + CHUNK_SIZE)
            for slot in range(lo, hi):
                off = (slot - base) * ROOT_LEN
                root = bytes(chunk[off:off + ROOT_LEN]) \
                    if len(chunk) >= off + ROOT_LEN else _ZERO
                yield slot, (None if root == _ZERO else root)

    def prune_before(self, slot: int) -> int:
        """Drop whole chunks strictly below slot; returns chunks removed
        (partial head chunks are kept — cheap and simple, like the
        reference's per-chunk granularity)."""
        removed = 0
        ci = slot // CHUNK_SIZE
        # walk down until a missing chunk (dense from anchor upward)
        j = ci - 1
        while j >= 0:
            key = self._key(j)
            if self.kv.get(key) is None:
                break
            self.kv.delete(key)
            removed += 1
            j -= 1
        return removed
