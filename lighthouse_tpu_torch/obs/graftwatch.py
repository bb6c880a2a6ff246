"""graftwatch — the always-on observer built on graftscope.

One process-global facade owning the slot sampler (:mod:`timeseries`),
the SLO engine (:mod:`slo`), and the flight recorder (:mod:`flight`).
``BeaconChain`` registers itself at construction and calls
:func:`on_slot` from ``per_slot_task``; the first tick of each slot
samples every catalog metric into the rings and evaluates every SLO.
``BeaconProcessor`` registers too so dumps can include queue depths.

Registrations are weak: graftwatch never keeps a chain or processor
alive, and a slot moving backwards (a fresh in-process harness or
LocalNetwork starting over at slot 0) resets rings *and* incidents —
the old records described a different chain.

Auto-dump (write a flight dump the moment an incident opens) is OFF by
default: hundreds of unit tests tick harness slots without gossip and
would open head-lag incidents by design.  Scenario tests and real
nodes opt in with :func:`configure` / ``set_auto_dump``.
"""
from __future__ import annotations

import threading
import weakref

from . import device, flight, occupancy, slo, timeseries


class Graftwatch:
    def __init__(self):
        self.sampler = timeseries.get_sampler()
        self.engine = slo.SLOEngine(self.sampler)
        self.recorder = flight.FlightRecorder(self)
        self._chains: list = []          # weakrefs
        self._processors: list = []      # weakrefs
        self._servings: list = []        # weakrefs (api serving tiers)
        self._replays: list = []         # weakrefs (graftflow engines)
        self._lock = threading.Lock()
        self._last_slot: int | None = None
        self.auto_dump = False

    # -- registration ----------------------------------------------------

    def register_chain(self, chain) -> None:
        with self._lock:
            self._chains = [r for r in self._chains if r() is not None]
            if not any(r() is chain for r in self._chains):
                self._chains.append(weakref.ref(chain))

    def register_processor(self, proc) -> None:
        with self._lock:
            self._processors = [r for r in self._processors
                                if r() is not None]
            if not any(r() is proc for r in self._processors):
                self._processors.append(weakref.ref(proc))

    def register_serving(self, tier) -> None:
        with self._lock:
            self._servings = [r for r in self._servings
                              if r() is not None]
            if not any(r() is tier for r in self._servings):
                self._servings.append(weakref.ref(tier))

    def register_replay(self, engine) -> None:
        with self._lock:
            self._replays = [r for r in self._replays
                             if r() is not None]
            if not any(r() is engine for r in self._replays):
                self._replays.append(weakref.ref(engine))

    def chains(self) -> list:
        with self._lock:
            return [c for c in (r() for r in self._chains)
                    if c is not None]

    def processors(self) -> list:
        with self._lock:
            return [p for p in (r() for r in self._processors)
                    if p is not None]

    def servings(self) -> list:
        with self._lock:
            return [s for s in (r() for r in self._servings)
                    if s is not None]

    def replays(self) -> list:
        with self._lock:
            return [e for e in (r() for r in self._replays)
                    if e is not None]

    # -- configuration ---------------------------------------------------

    def configure(self, *, auto_dump: bool | None = None,
                  dump_dir: str | None = None) -> None:
        if auto_dump is not None:
            self.auto_dump = bool(auto_dump)
        if dump_dir is not None:
            self.recorder.dump_dir = dump_dir

    def reset(self) -> None:
        """Fresh rings, no incidents, registrations kept."""
        with self._lock:
            self._last_slot = None
        self.sampler.reset()
        self.engine.reset()
        occupancy.get().reset()

    # -- the per-slot tick ----------------------------------------------

    def on_slot(self, slot: int) -> None:
        """Called from every chain's ``per_slot_task``; the first caller
        per slot does the sampling + evaluation, later callers (other
        nodes of the same in-process network) are no-ops."""
        slot = int(slot)
        with self._lock:
            if self._last_slot is not None and slot < self._last_slot:
                # new harness/network epoch — see module docstring
                self.sampler.reset()
                self.engine.reset()
            elif self._last_slot == slot:
                return
            self._last_slot = slot
        # fold stage busy-seconds into the occupancy gauges before the
        # snapshot so the sampler rows carry this slot's fractions
        occupancy.publish()
        # device/HBM + host-health gauges land in the same slot row
        device.publish()
        self.sampler.sample(slot)
        opened = self.engine.evaluate(slot, tuple(self.chains()))
        if opened and self.auto_dump:
            try:
                self.recorder.dump(
                    reason="incident:" + ",".join(i.slo for i in opened))
            except Exception:  # pragma: no cover - never kill slot task
                pass


_WATCH: Graftwatch | None = None
_WATCH_LOCK = threading.Lock()


def get() -> Graftwatch:
    global _WATCH
    if _WATCH is None:
        with _WATCH_LOCK:
            if _WATCH is None:
                _WATCH = Graftwatch()
    return _WATCH


def on_slot(slot: int) -> None:
    get().on_slot(slot)


def register_chain(chain) -> None:
    get().register_chain(chain)


def register_processor(proc) -> None:
    get().register_processor(proc)


def register_serving(tier) -> None:
    get().register_serving(tier)


def register_replay(engine) -> None:
    get().register_replay(engine)
