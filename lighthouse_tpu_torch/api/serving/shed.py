"""Priority load-shedding admission queue (serving tier).

The Security Review of Ethereum Beacon Clients (PAPERS.md) flags
unbounded API load as a liveness risk: a node drowning in debug/state
dumps must still answer the duties and attestation_data requests its
validators' rewards depend on.  So the tier bounds concurrency with an
admission queue and, under pressure, sheds the *lowest-priority,
youngest* waiting request first — shedding is explicit (a 503 the VC
can retry elsewhere), never a stall.

Priorities (lower value = more important):
  CRITICAL  duties / attestation_data — per-slot validator hot path
  BLOCKS    block and header reads
  BULK      debug dumps, full-state reads, light-client backfill
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

CRITICAL = 0
BLOCKS = 1
BULK = 2

PRIORITY_NAMES = {CRITICAL: "critical", BLOCKS: "blocks", BULK: "bulk"}


class ShedError(Exception):
    """Request shed by the admission queue (HTTP 503)."""

    def __init__(self, priority: int):
        super().__init__(
            f"request shed (priority {PRIORITY_NAMES.get(priority, priority)})")
        self.priority = priority


class _Waiter:
    __slots__ = ("priority", "seq", "event", "granted", "shed")

    def __init__(self, priority: int, seq: int):
        self.priority = priority
        self.seq = seq
        self.event = threading.Event()
        self.granted = False
        self.shed = False


class AdmissionQueue:
    """At most ``workers`` requests run; at most ``capacity`` wait."""

    def __init__(self, workers: int = 8, capacity: int = 64):
        self.workers = int(workers)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._waiting: list[_Waiter] = []
        self._active = 0
        self._seq = 0
        self.high_water = 0
        self.shed_counts = {CRITICAL: 0, BLOCKS: 0, BULK: 0}

    def depth(self) -> int:
        with self._lock:
            return len(self._waiting)

    @property
    def active(self) -> int:
        with self._lock:
            return self._active

    def acquire(self, priority: int) -> None:
        with self._lock:
            if self._active < self.workers and not self._waiting:
                self._active += 1
                return
            if len(self._waiting) >= self.capacity:
                # worst = lowest priority, then youngest (highest seq):
                # under equal priority the longest-waiting request keeps
                # its place
                worst = max(self._waiting,
                            key=lambda w: (w.priority, w.seq))
                if priority >= worst.priority:
                    self.shed_counts[priority] = (
                        self.shed_counts.get(priority, 0) + 1)
                    raise ShedError(priority)
                worst.shed = True
                self._waiting.remove(worst)
                self.shed_counts[worst.priority] = (
                    self.shed_counts.get(worst.priority, 0) + 1)
                worst.event.set()
            self._seq += 1
            me = _Waiter(priority, self._seq)
            self._waiting.append(me)
            self.high_water = max(self.high_water, len(self._waiting))
        me.event.wait()
        if me.shed:
            raise ShedError(priority)

    def release(self) -> None:
        with self._lock:
            if self._waiting:
                # transfer the slot: active count is unchanged, the
                # best waiter (highest priority, oldest) runs next
                best = min(self._waiting,
                           key=lambda w: (w.priority, w.seq))
                self._waiting.remove(best)
                best.granted = True
                best.event.set()
            else:
                self._active -= 1

    @contextmanager
    def admit(self, priority: int):
        self.acquire(priority)
        try:
            yield
        finally:
            self.release()
