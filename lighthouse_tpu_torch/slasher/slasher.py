"""The slasher core.

Design (slasher/src/{slasher.rs:21, array.rs:16-28}): for each validator
we track, per epoch, min-target and max-target distance matrices:

  min_target[v][e] = min target among v's attestations with source >= e
  max_target[v][e] = max target among v's attestations with source <= e

  new (s,t) SURROUNDS a prior vote    iff min_target[v][s+1] < t
  new (s,t) IS SURROUNDED by a prior  iff max_target[v][s-1] > t

Storage is the reference's disk-scale layout re-done over the native C++
KV engine: the matrices are 2D-chunked (validator_chunk_size x
chunk_size), zlib-compressed per chunk, pulled through a bounded LRU
cache and flushed after each batch — memory stays O(cache), not
O(validators x history).  Update sweeps run per epoch-chunk with the
reference's early-stop: a chunk left unchanged ends the sweep (distances
are monotone along the sweep direction).  Attestations are ingested in
batches from a queue (attestation_queue.rs) on each
`process_queued(current_epoch)` call.
"""
from __future__ import annotations

import struct
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..ssz import htr

_NONE_MIN = np.iinfo(np.uint16).max


@dataclass
class SlasherConfig:
    history_length: int = 4096          # epochs of history
    chunk_size: int = 16                # epochs per chunk
    validator_chunk_size: int = 256     # validators per chunk
    cache_chunks: int = 256             # LRU cap (chunks held in memory)
    max_db_size_mb: int = 1024


@dataclass
class SlashingRecord:
    kind: str                  # "double" | "surrounds" | "surrounded"
    validator_index: int
    attestation_1: object      # prior offending message (indexed attestation
    attestation_2: object      # or signed header); attestation_2 is the new
    #                            offender.  Both present => convertible into
    #                            an on-chain slashing op (record_to_operation)


def record_to_operation(record: SlashingRecord, T):
    """Build the on-chain operation proving a slashing record, ready for
    the op pool.  Only records carrying BOTH offending messages convert;
    surround records found via the distance matrices know the prior vote
    existed but not its content, so they cannot be packaged (the
    reference re-fetches the indexed attestation from its DB — our
    matrices store distances only)."""
    a1, a2 = record.attestation_1, record.attestation_2
    if a1 is None or a2 is None:
        return None
    if hasattr(a1, "attesting_indices"):
        return T.AttesterSlashing(attestation_1=a1, attestation_2=a2)
    return T.ProposerSlashing(signed_header_1=a1, signed_header_2=a2)


class ChunkedArray:
    """One distance matrix as compressed (vchunk, echunk) tiles in the KV
    store with a bounded in-memory LRU (slasher/src/array.rs:16-28)."""

    def __init__(self, store, tag: bytes, config: SlasherConfig,
                 default: int):
        self.store = store
        self.tag = tag
        self.cfg = config
        self.default = np.uint16(default)
        self._cache: OrderedDict[tuple[int, int], np.ndarray] = \
            OrderedDict()
        self._dirty: set[tuple[int, int]] = set()
        self._written: set[tuple[int, int]] = set()  # store keys we own

    def _key(self, vc: int, ec: int) -> bytes:
        return b"slasher:" + self.tag + struct.pack("<QQ", vc, ec)

    def chunk(self, vc: int, ec: int) -> np.ndarray:
        ck = (vc, ec)
        arr = self._cache.get(ck)
        if arr is not None:
            self._cache.move_to_end(ck)
            return arr
        raw = self.store.get(self._key(vc, ec)) if self.store else None
        if raw is not None:
            arr = np.frombuffer(zlib.decompress(raw), np.uint16).reshape(
                self.cfg.validator_chunk_size, self.cfg.chunk_size).copy()
        else:
            arr = np.full((self.cfg.validator_chunk_size,
                           self.cfg.chunk_size), self.default, np.uint16)
        self._cache[ck] = arr
        self._evict()
        return arr

    def mark_dirty(self, vc: int, ec: int) -> None:
        self._dirty.add((vc, ec))

    def _evict(self) -> None:
        if self.store is None:
            # storeless (tests/dev): evicting a dirty chunk would DISCARD
            # slashing state — keep dirty chunks resident, evict clean only
            clean = [ck for ck in self._cache if ck not in self._dirty]
            while len(self._cache) > self.cfg.cache_chunks and clean:
                self._cache.pop(clean.pop(0), None)
            return
        while len(self._cache) > self.cfg.cache_chunks:
            ck, arr = self._cache.popitem(last=False)
            if ck in self._dirty:
                self._flush_one(ck, arr)

    def _flush_one(self, ck: tuple[int, int], arr: np.ndarray) -> None:
        if self.store is None:
            return       # storeless: stays dirty (and cache-resident)
        self.store.put(self._key(*ck),
                       zlib.compress(arr.tobytes(), level=3))
        self._written.add(ck)
        self._dirty.discard(ck)

    def flush(self) -> None:
        if self.store is None:
            return          # storeless: dirty chunks stay cache-resident
        for ck in list(self._dirty):
            arr = self._cache.get(ck)
            if arr is not None:
                self._flush_one(ck, arr)
        self._dirty.clear()

    def read_column(self, idxs: np.ndarray, epoch: int) -> np.ndarray:
        """Values at one epoch column for a set of validators."""
        vcs = idxs // self.cfg.validator_chunk_size
        ec = epoch // self.cfg.chunk_size
        off_e = epoch % self.cfg.chunk_size
        out = np.empty(len(idxs), np.uint16)
        for vc in np.unique(vcs):
            sel = vcs == vc
            arr = self.chunk(int(vc), int(ec))
            out[sel] = arr[idxs[sel] % self.cfg.validator_chunk_size, off_e]
        return out

    def update_sweep(self, idxs: np.ndarray, start_epoch: int,
                     stop_epoch: int, step: int, target: int) -> None:
        """Write distance-to-`target` into columns from start toward stop
        (inclusive), one vectorized tile write per (vchunk, echunk),
        stopping early when a whole epoch-chunk needed no update
        (monotone distances make further sweeping a no-op — the
        reference's early-stop)."""
        is_min = int(self.default) == _NONE_MIN
        merge = np.minimum if is_min else np.maximum
        grouped = []                      # hoisted: (vc, rows) once
        for vc in np.unique(idxs // self.cfg.validator_chunk_size):
            sel = idxs[(idxs // self.cfg.validator_chunk_size) == vc]
            grouped.append((int(vc),
                            sel % self.cfg.validator_chunk_size))
        e = start_epoch
        while (step > 0 and e <= stop_epoch) or \
                (step < 0 and e >= stop_epoch):
            ec = e // self.cfg.chunk_size
            if step > 0:
                e_edge = min(stop_epoch, (ec + 1) * self.cfg.chunk_size - 1)
                epochs = np.arange(e, e_edge + 1)
                e_next = e_edge + 1
            else:
                e_edge = max(stop_epoch, ec * self.cfg.chunk_size)
                epochs = np.arange(e_edge, e + 1)
                e_next = e_edge - 1
            cols = epochs % self.cfg.chunk_size
            dist = np.clip(target - epochs, 0,
                           _NONE_MIN - 1 if is_min else _NONE_MIN)
            dist = dist.astype(np.uint16)
            chunk_changed = False
            for vc, rows in grouped:
                arr = self.chunk(vc, int(ec))
                tile = arr[np.ix_(rows, cols)]
                merged = merge(tile, dist[None, :])
                if (merged != tile).any():
                    arr[np.ix_(rows, cols)] = merged
                    self.mark_dirty(vc, int(ec))
                    chunk_changed = True
            if not chunk_changed:
                return                       # early stop
            e = e_next

    def prune_before(self, min_epoch: int) -> None:
        """Drop cached AND stored chunks before the history window.
        Store keys written this process are tracked in _written; keys
        from a previous process linger (bounded by the history length at
        the time of that shutdown) until their epochs are rewritten."""
        min_ec = min_epoch // self.cfg.chunk_size
        for ck in [c for c in self._cache if c[1] < min_ec]:
            self._cache.pop(ck, None)
            self._dirty.discard(ck)
        if self.store is not None:
            stale = [ck for ck in self._written if ck[1] < min_ec]
            for ck in stale:
                try:
                    self.store.delete(self._key(*ck))
                except Exception:
                    pass
                self._written.discard(ck)

    def cache_bytes(self) -> int:
        return sum(a.nbytes for a in self._cache.values())


class Slasher:
    def __init__(self, config: SlasherConfig | None = None, store=None):
        self.config = config or SlasherConfig()
        self.store = store
        self.min_target = ChunkedArray(store, b"min", self.config,
                                       _NONE_MIN)
        self.max_target = ChunkedArray(store, b"max", self.config, 0)
        # (validator, target) -> (data_root, data) for double-vote detection
        self._by_target: dict[tuple[int, int], tuple[bytes, object]] = {}
        self._queue: list = []
        # (slot, proposer) -> (header_root, signed_header): the header is
        # kept so an equivocation record carries both signed messages
        self._blocks: dict[tuple[int, int],
                           tuple[bytes, object]] = {}
        self._block_queue: list = []
        self._lock = threading.Lock()
        self.slashings: list[SlashingRecord] = []

    # -- ingestion -----------------------------------------------------------

    def accept_attestation(self, indexed) -> None:
        """Queue an indexed attestation (gossip/block feed)."""
        with self._lock:
            self._queue.append(indexed)

    def accept_block_header(self, signed_header) -> None:
        with self._lock:
            self._block_queue.append(signed_header)

    # -- batch processing ----------------------------------------------------

    def process_queued(self, current_epoch: int) -> list[SlashingRecord]:
        """One batch update (slasher.rs process_queued); returns new
        slashings found in this batch."""
        with self._lock:
            batch, self._queue = self._queue, []
            blocks, self._block_queue = self._block_queue, []
        found: list[SlashingRecord] = []
        for indexed in batch:
            found.extend(self._process_attestation(indexed, current_epoch))
        for header in blocks:
            rec = self._process_block(header)
            if rec:
                found.append(rec)
        self.slashings.extend(found)
        # flush dirty chunks + prune double-vote/bookkeeping history
        self.min_target.flush()
        self.max_target.flush()
        lo = current_epoch - self.config.history_length
        if lo > 0:
            self.min_target.prune_before(lo)
            self.max_target.prune_before(lo)
            self._by_target = {k: v for k, v in self._by_target.items()
                               if k[1] >= lo}
        self.slashings = self.slashings[-4096:]
        return found

    def _process_attestation(self, indexed,
                             current_epoch: int) -> list[SlashingRecord]:
        H = self.config.history_length
        s = indexed.data.source.epoch
        t = indexed.data.target.epoch
        if t > current_epoch or s > t:
            return []
        if current_epoch - t >= H:
            return []
        data_root = htr(indexed.data)
        out = []
        idxs = np.asarray(sorted({int(i) for i in
                                  indexed.attesting_indices}),
                          dtype=np.int64)
        if len(idxs) == 0:
            return []

        # double votes
        for v in idxs:
            prev = self._by_target.get((int(v), t))
            if prev is not None and prev[0] != data_root:
                out.append(SlashingRecord("double", int(v), prev[1],
                                          indexed))
            else:
                self._by_target[(int(v), t)] = (data_root, indexed)

        # distances are stored relative to the column epoch
        if s + 1 <= current_epoch:
            mins = self.min_target.read_column(idxs, s + 1).astype(np.int64)
            surrounds = (mins != _NONE_MIN) & (mins + s + 1 < t)
            for v in idxs[surrounds]:
                out.append(SlashingRecord("surrounds", int(v), None,
                                          indexed))
        if s >= 1:
            maxs = self.max_target.read_column(idxs, s - 1).astype(np.int64)
            surrounded = (maxs > 0) & (maxs + s - 1 > t)
            for v in idxs[surrounded]:
                out.append(SlashingRecord("surrounded", int(v), None,
                                          indexed))

        lo = max(0, current_epoch - H + 1)
        self.min_target.update_sweep(idxs, s, lo, -1, t)
        # clamp the upward sweep into the history window too: an ancient
        # source must not materialize O(current_epoch) chunks
        self.max_target.update_sweep(idxs, max(s, lo), current_epoch, +1, t)
        return out

    def _process_block(self, signed_header) -> SlashingRecord | None:
        h = signed_header.message
        key = (h.slot, h.proposer_index)
        root = htr(h)
        prev = self._blocks.get(key)
        if prev is None:
            self._blocks[key] = (root, signed_header)
            return None
        if prev[0] != root:
            return SlashingRecord("double", h.proposer_index, prev[1],
                                  signed_header)
        return None

    # -- persistence ---------------------------------------------------------

    def persist(self) -> None:
        """Chunks stream to the KV store as they are evicted/flushed; this
        just forces a final flush (old dense-matrix persist is gone)."""
        self.min_target.flush()
        self.max_target.flush()

    def restore(self) -> None:
        """Nothing to do: chunks load lazily from the store by key."""

    def memory_bytes(self) -> int:
        return self.min_target.cache_bytes() + self.max_target.cache_bytes()
