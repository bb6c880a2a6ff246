"""graftwatch time-series — always-on slot-granular metric sampler.

Every metric feed funnels through ``api.metrics`` (inc_counter /
set_gauge / observe); that module mirrors each touch here via
:func:`record` using the same ``sys.modules`` hand-off graftscope uses
in the other direction, so neither layer imports the other at module
scope.  Once per slot :func:`SlotSampler.sample` snapshots the whole
``api/metrics_defs.CATALOG`` into fixed-size numpy rings keyed by slot:

- counters  -> per-slot delta under the catalog name
- gauges    -> last value set during the slot (NaN until first set)
- histograms-> ``name.p50`` / ``name.p95`` / ``name.count`` computed
               from the raw observations drained since the last sample
               (prometheus buckets cannot answer percentile queries, so
               the sampler keeps its own bounded observation buffers)

Slot semantics match the test topology: re-sampling the same slot
merges into the existing row (several nodes of one in-process network
all tick the same slot), and a slot moving *backwards* means a new
harness/network started — the rings and downstream incident state
describe a different chain, so the sampler resets wholesale.
"""
from __future__ import annotations

import sys
import threading

import numpy as np

from . import occupancy

#: ring length, in slots (~2 epochs of mainnet at 32 slots/epoch on
#: either side of any incident a flight dump wants to explain)
DEFAULT_WINDOW = 128

#: per-(slot, histogram) cap on buffered observations; percentiles are
#: statistically settled long before this, and it bounds memory when a
#: flood scenario observes thousands of times per slot
_MAX_PENDING = 4096


def _catalog() -> dict[str, tuple[str, str]]:
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    if md is None:  # first sample() before the api layer loaded
        from ..api import metrics_defs as md  # type: ignore[no-redef]
    return md.CATALOG


def _percentile(sorted_vals: list[float], pct: float) -> float:
    """Nearest-rank percentile (same convention as obs.report)."""
    if not sorted_vals:
        return float("nan")
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(pct / 100.0 * len(sorted_vals) + 0.5)) - 1))
    return sorted_vals[k]


class SlotSampler:
    """Bounded per-slot snapshot rings over the metric catalog."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.window = int(window)
        # reentrant: reset() runs standalone AND from inside sample()
        self._lock = threading.RLock()
        self.reset()

    # -- lifecycle -------------------------------------------------------

    def reset(self) -> None:
        with self._lock:
            self._slots = np.full(self.window, -1, dtype=np.int64)
            self._series: dict[str, np.ndarray] = {}
            self._rows = 0              # rows ever written (monotonic)
            self._last_slot: int | None = None
            self._counter_cum: dict[str, float] = {}
            self._counter_mark: dict[str, float] = {}  # cum at last sample
            self._gauge_now: dict[str, float] = {}
            self._hist_pending: dict[str, list[float]] = {}

    # -- feed (mirrored from api.metrics on every metric touch) ----------

    def record(self, kind: str, name: str, value: float) -> None:
        with self._lock:
            if kind == "counter":
                self._counter_cum[name] = (
                    self._counter_cum.get(name, 0.0) + float(value))
            elif kind == "gauge":
                self._gauge_now[name] = float(value)
            else:  # histogram observation
                buf = self._hist_pending.get(name)
                if buf is None:
                    buf = self._hist_pending[name] = []
                if len(buf) < _MAX_PENDING:
                    buf.append(float(value))

    def counter_total(self, name: str) -> float:
        """Cumulative counter value as accounted by the sampler."""
        with self._lock:
            return self._counter_cum.get(name, 0.0)

    # -- sampling --------------------------------------------------------

    def _row_arr(self, name: str) -> np.ndarray:
        arr = self._series.get(name)
        if arr is None:
            arr = np.full(self.window, np.nan, dtype=np.float64)
            self._series[name] = arr
        return arr

    def sample(self, slot: int) -> None:
        """Snapshot every catalog metric into the row for ``slot``.

        The same-slot re-sample merge below mutates ``_series`` rows in
        place; every branch (merge or fresh row) runs under ``_lock``.
        """
        catalog = _catalog()           # import (if any) outside the lock
        slot = int(slot)
        with self._lock:
            if self._last_slot is not None and slot < self._last_slot:
                self.reset()           # new network epoch (see module doc)
            merge = self._last_slot == slot and self._rows > 0
            if not merge:
                self._rows += 1
            row = (self._rows - 1) % self.window
            if not merge:
                self._slots[row] = slot
                for arr in self._series.values():
                    arr[row] = np.nan
            self._last_slot = slot
            for name, (kind, _help) in catalog.items():
                if kind == "counter":
                    cum = self._counter_cum.get(name, 0.0)
                    delta = cum - self._counter_mark.get(name, 0.0)
                    self._counter_mark[name] = cum
                    arr = self._row_arr(name)
                    prev = arr[row] if merge and not np.isnan(arr[row]) else 0.0
                    arr[row] = float(prev) + delta
                elif kind == "gauge":
                    v = self._gauge_now.get(name)
                    if v is not None or not merge:
                        self._row_arr(name)[row] = (
                            np.nan if v is None else v)
                else:
                    buf = self._hist_pending.pop(name, None)
                    carr = self._row_arr(name + ".count")
                    p50 = self._row_arr(name + ".p50")
                    p95 = self._row_arr(name + ".p95")
                    if buf:
                        buf.sort()
                        prev_n = (carr[row]
                                  if merge and not np.isnan(carr[row])
                                  else 0.0)
                        carr[row] = float(prev_n) + len(buf)
                        # on a merge the drained batch stands in for the
                        # whole slot; exact cross-drain percentiles would
                        # need the raw samples we already released
                        p50[row] = _percentile(buf, 50)
                        p95[row] = _percentile(buf, 95)
                    elif not merge:
                        carr[row] = 0.0

    # -- reads -----------------------------------------------------------

    def _order(self) -> np.ndarray:
        filled = min(self._rows, self.window)
        start = (self._rows - filled) % self.window
        return (start + np.arange(filled)) % self.window

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def latest_slot(self) -> int | None:
        with self._lock:
            return self._last_slot

    def series(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """(slots, values) in chronological order; empty when unknown."""
        with self._lock:
            arr = self._series.get(name)
            if arr is None or self._rows == 0:
                return (np.empty(0, dtype=np.int64),
                        np.empty(0, dtype=np.float64))
            idx = self._order()
            return self._slots[idx].copy(), arr[idx].copy()

    def latest(self, name: str) -> float | None:
        """Most recent sampled value, or None when absent/NaN."""
        with self._lock:
            arr = self._series.get(name)
            if arr is None or self._rows == 0:
                return None
            row = (self._rows - 1) % self.window
            v = arr[row]
            return None if np.isnan(v) else float(v)

    def window_dict(self) -> dict:
        """JSON-ready dump of the whole window (NaN -> None)."""
        with self._lock:
            if self._rows == 0:
                return {"window": self.window, "slots": [], "series": {}}
            idx = self._order()
            slots = [int(s) for s in self._slots[idx]]
            series = {}
            for name, arr in sorted(self._series.items()):
                vals = arr[idx]
                series[name] = [None if np.isnan(v) else float(v)
                                for v in vals]
            return {"window": self.window, "slots": slots,
                    "series": series}


_SAMPLER = SlotSampler()


def get_sampler() -> SlotSampler:
    return _SAMPLER


def record(kind: str, name: str, value: float) -> None:
    """Feed hook called by ``api.metrics`` on every metric touch."""
    if kind not in ("counter", "gauge"):
        # import-stage busy-seconds tap (graftpath occupancy gauges)
        occupancy.on_observation(name, value)
    _SAMPLER.record(kind, name, value)


def sample(slot: int) -> None:
    _SAMPLER.sample(slot)
