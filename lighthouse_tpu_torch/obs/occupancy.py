"""graftpath import-stage occupancy — busy-fraction gauges per stage.

Every import-stage histogram observation already funnels through
``obs.timeseries.record`` (api.metrics mirrors each touch); this module
taps that stream, accumulates busy seconds per pipeline stage, and once
per slot (graftwatch's tick calls :func:`publish` right before the
sampler snapshot) converts them into busy *fractions* of the elapsed
wall clock.  The four gauges then ride the per-slot sampler rings like
every other catalog metric, which is the occupancy history ROADMAP
item 4 needs: a stage pipeline can only help while no single stage's
busy fraction is ~1.0.

Aggregated across threads on purpose: with parallel imports the
fraction can exceed 1.0 per wall second and is clamped — the signal is
"saturated", not a scheduler trace.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import deque

#: import-stage histogram -> stage label (the import decomposition:
#: signature-verify, state-transition, merkleization, persistence)
STAGE_METRICS: dict[str, str] = {
    "beacon_block_processing_signature_seconds": "signature",
    "beacon_block_processing_state_transition_seconds": "state_transition",
    "beacon_block_processing_state_root_seconds": "merkleization",
    "beacon_block_processing_db_write_seconds": "persistence",
}

STAGES = ("signature", "state_transition", "merkleization", "persistence")


class StageOccupancy:
    """Busy-second accumulator with a bounded publish history ring."""

    def __init__(self, history: int = 128):
        self._lock = threading.Lock()
        self._busy = {st: 0.0 for st in STAGES}
        self._last_publish: float | None = None
        self.history: deque = deque(maxlen=history)

    def on_observation(self, name: str, seconds: float) -> None:
        st = STAGE_METRICS.get(name)
        if st is None:
            return
        with self._lock:
            self._busy[st] += max(0.0, float(seconds))

    def publish(self, now: float | None = None) -> dict[str, float]:
        """Fold the accumulated busy seconds into fractions of the wall
        time since the previous publish, reset, and feed the gauges."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            elapsed = (0.0 if self._last_publish is None
                       else max(0.0, now - self._last_publish))
            self._last_publish = now
            busy, self._busy = self._busy, {st: 0.0 for st in STAGES}
        if elapsed > 0.0:
            frac = {st: min(1.0, busy[st] / elapsed) for st in STAGES}
        else:
            frac = {st: 0.0 for st in STAGES}
        md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
        if md is not None:
            md.gauge("import_stage_busy_fraction_signature",
                     frac["signature"])
            md.gauge("import_stage_busy_fraction_state_transition",
                     frac["state_transition"])
            md.gauge("import_stage_busy_fraction_merkleization",
                     frac["merkleization"])
            md.gauge("import_stage_busy_fraction_persistence",
                     frac["persistence"])
        self.history.append(frac)
        return frac

    def reset(self) -> None:
        with self._lock:
            self._busy = {st: 0.0 for st in STAGES}
            self._last_publish = None
            self.history.clear()


_OCC = StageOccupancy()


def get() -> StageOccupancy:
    return _OCC


def on_observation(name: str, seconds: float) -> None:
    _OCC.on_observation(name, seconds)


def publish(now: float | None = None) -> dict[str, float]:
    return _OCC.publish(now)
