"""Park-and-replay queue for early/unresolvable work.

Equivalent of beacon_processor/src/work_reprocessing_queue.rs (:1-60):
- early-arriving gossip blocks are parked until their slot starts and
  re-enter the processor's priority queues at the boundary;
- attestations/aggregates referencing an unknown block root are parked
  and replayed the moment that block imports (the reference replays via
  the `BlockImported` reprocess event);
- future-slot attestations are parked until their slot;
- buckets are bounded, and unresolved by-root parks expire after
  EXPIRY_SLOTS so a junk root can't pin memory forever.

The queue holds `Work` items and re-enters them through the submitter
(BeaconProcessor.submit), so replayed work flows through the same
priority scheduling as fresh gossip.
"""
from __future__ import annotations

import threading
from collections import defaultdict


class ReprocessQueue:
    EXPIRY_SLOTS = 64          # by-root parks older than this are dropped
    MAX_FUTURE_SLOTS = 64      # refuse parks this far past the clock

    def __init__(self, submit):
        self._submit = submit                 # BeaconProcessor.submit
        self._closed = False
        self._by_slot: dict[int, list] = defaultdict(list)
        # root -> (parked_at_slot, [work, ...])
        self._by_root: dict[bytes, tuple[int, list]] = {}
        self._lock = threading.Lock()
        self.max_per_bucket = 1024
        # Global bound across ALL by-root buckets: UNKNOWN_HEAD parks are
        # taken before any signature check, so an attacker gossiping random
        # roots must not open unbounded buckets inside the expiry window
        # (reference: work_reprocessing_queue.rs MAXIMUM_QUEUED_ATTESTATIONS).
        self.max_by_root_total = 16384
        self._by_root_count = 0
        self.parked_total = 0
        self.replayed_total = 0
        self.expired_total = 0
        self.refused_total = 0

    def close(self) -> None:
        """Sever the injected submitter: called from the owning
        BeaconProcessor's stop(), so a slot tick or late block import
        racing the teardown drops its replays instead of landing them in
        the stopped processor's queues."""
        self._closed = True

    def park_until_slot(self, slot: int, work,
                        current_slot: int | None = None) -> None:
        """Parks are clock-bounded: future_slot is raised BEFORE any
        signature check, so attacker-chosen far-future slots must not pin
        memory (each distinct slot would otherwise open a fresh bucket)."""
        if current_slot is not None and \
                slot > current_slot + self.MAX_FUTURE_SLOTS:
            with self._lock:
                self.refused_total += 1
            return
        with self._lock:
            bucket = self._by_slot[slot]
            if len(bucket) < self.max_per_bucket:
                bucket.append(work)
                self.parked_total += 1

    def park_until_block(self, block_root: bytes, work,
                         current_slot: int = 0) -> None:
        with self._lock:
            if self._by_root_count >= self.max_by_root_total:
                self.refused_total += 1
                return
            parked_at, bucket = self._by_root.get(block_root,
                                                  (current_slot, []))
            if len(bucket) < self.max_per_bucket:
                bucket.append(work)
                self.parked_total += 1
                self._by_root_count += 1
            else:
                self.refused_total += 1       # full bucket: drop, visibly
            self._by_root[block_root] = (parked_at, bucket)

    def on_slot(self, slot: int) -> int:
        """Replay everything parked for slots <= slot; expire stale
        by-root parks (their block never arrived)."""
        with self._lock:
            due = [w for s in list(self._by_slot)
                   if s <= slot for w in self._by_slot.pop(s)]
            for root in list(self._by_root):
                parked_at, bucket = self._by_root[root]
                if parked_at + self.EXPIRY_SLOTS < slot:
                    self._by_root.pop(root)
                    self.expired_total += len(bucket)
                    self._by_root_count -= len(bucket)
        if self._closed:
            return 0                  # owner stopping: drop, don't submit
        for w in due:
            self._submit(w)
        if due:
            from ..api import metrics_defs as M
            M.count("beacon_processor_reprocess_total", len(due))
        with self._lock:
            self.replayed_total += len(due)
        return len(due)

    def on_block_imported(self, block_root: bytes) -> int:
        with self._lock:
            _at, due = self._by_root.pop(block_root, (0, []))
            self._by_root_count -= len(due)
        if self._closed:
            return 0                  # owner stopping: drop, don't submit
        for w in due:
            self._submit(w)
        if due:
            from ..api import metrics_defs as M
            M.count("beacon_processor_reprocess_total", len(due))
        with self._lock:
            self.replayed_total += len(due)
        return len(due)

    @property
    def parked(self) -> int:
        with self._lock:
            return (sum(len(b) for b in self._by_slot.values())
                    + sum(len(b) for _a, b in self._by_root.values()))
