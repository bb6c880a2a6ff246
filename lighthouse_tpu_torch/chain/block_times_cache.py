"""Per-block arrival/processing timeline cache.

Equivalent of the reference's beacon_node/beacon_chain/src/
block_times_cache.rs: for each recent block root, record when it was
first observed, when consensus verification finished (imported), and
when it became head — the late-block forensics the ValidatorMonitor and
the re-org heuristic read.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from ..api import metrics_defs
from ..obs import tracing

MAX_ENTRIES = 64


@dataclass
class BlockTimes:
    slot: int = 0
    observed_at: float | None = None
    imported_at: float | None = None
    became_head_at: float | None = None
    #: seconds into the slot when first seen (the lateness signal)
    observed_delay: float | None = None


class BlockTimesCache:
    def __init__(self, genesis_time: int, seconds_per_slot: int):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot
        self._entries: OrderedDict[bytes, BlockTimes] = OrderedDict()
        self._lock = threading.Lock()

    def _entry(self, root: bytes, slot: int) -> BlockTimes:
        e = self._entries.get(root)
        if e is None:
            e = BlockTimes(slot=slot)
            self._entries[root] = e
            while len(self._entries) > MAX_ENTRIES:
                self._entries.popitem(last=False)
        return e

    def _slot_start(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def on_observed(self, root: bytes, slot: int,
                    now: float | None = None) -> None:
        now = now if now is not None else time.time()
        with self._lock:
            e = self._entry(root, slot)
            if e.observed_at is None:
                e.observed_at = now
                e.observed_delay = max(0.0, now - self._slot_start(slot))
                metrics_defs.observe("beacon_block_observed_delay_seconds",
                                     e.observed_delay)
                # anchor the active trace to the slot timeline
                tracing.annotate(
                    observed_delay_s=round(e.observed_delay, 6))

    def on_imported(self, root: bytes, slot: int,
                    now: float | None = None) -> None:
        now = now if now is not None else time.time()
        with self._lock:
            e = self._entry(root, slot)
            if e.imported_at is None:
                e.imported_at = now
                if e.observed_at is not None:
                    imported_delay = max(0.0, now - e.observed_at)
                    metrics_defs.observe(
                        "beacon_block_imported_delay_seconds",
                        imported_delay)
                    tracing.annotate(
                        imported_delay_s=round(imported_delay, 6))

    def on_became_head(self, root: bytes, slot: int,
                       now: float | None = None) -> None:
        now = now if now is not None else time.time()
        with self._lock:
            e = self._entry(root, slot)
            if e.became_head_at is None:
                e.became_head_at = now
                if e.imported_at is not None:
                    head_delay = max(0.0, now - e.imported_at)
                    metrics_defs.observe(
                        "beacon_block_head_delay_seconds", head_delay)
                    tracing.annotate(head_delay_s=round(head_delay, 6))

    def get(self, root: bytes) -> BlockTimes | None:
        with self._lock:
            return self._entries.get(root)

    def recent(self, n: int = 16) -> list[tuple[bytes, BlockTimes]]:
        with self._lock:
            return list(self._entries.items())[-n:]
