"""graftwatch SLOs — declarative objectives evaluated each slot.

Each :class:`SLO` names the catalog metric it watches (tier-1 asserts
the reference exists), a budget, and a check that reads the
:mod:`timeseries` rings (and, for head-lag, the live chains) and
returns ``(value, breached, detail)``.  The :class:`SLOEngine` runs
every registered check once per slot and maintains **Incident**
records: a breach opens an incident (fires on-open callbacks — the
flight recorder hangs off these), continued breaches update its worst
value, and ``resolve_after`` consecutive clean slots close it.

The default objectives encode the budgets the scenario envelopes
(SCENARIOS.md) and the perf model (PERF_MODEL.md) already enforce by
hand:

==========================  ============================================
``block_pipeline_p95``      gossip-arrival -> imported p95 within the
                            5 s envelope every scenario asserts
``head_lag``                last *complete* slot minus head slot <= 1;
                            at evaluation time (start of slot ``s``)
                            the block for ``s`` cannot have arrived, so
                            lag is measured against ``s - 1``
``kernel_build_steady``     no runtime nvcc builds after warmup (every
                            kernel library is built once, up front)
``shuffle_cache_hit_ratio`` the shared shuffling cache keeps
                            serving; re-shuffle storms tank epoch time
``processor_shedding``      the beacon processor sheds no work at queue
                            capacity (floods intentionally breach this)
``sync_progress``           while range-syncing (``sync_state`` gauge
                            != 0) the node keeps importing blocks; a
                            byzantine-majority peer pool may slow sync
                            down but must never stop it
``serving_p95``             Beacon-API serving-tier request p95 (the
                            ``api_request`` graftscope span) stays
                            inside budget — a cached/coalesced tier
                            keeps VC hot-path reads fast under load
``serving_shed_rate``       the serving tier's admission queue sheds at
                            most a budgeted fraction of requests per
                            slot; sustained shedding above it means the
                            tier is drowning, not just clipping bursts
``propagation_p95``         publish -> import block propagation across
                            the in-process fleet (graftpath's stitched
                            lens on gossip health)
``replay_throughput``       while graftflow is replaying a segment the
                            pipeline commits >= 1 block per
                            slot-equivalent — a stalled stage surfaces
                            instead of wedging sync
``hbm_headroom``            device memory headroom (1 - in_use/limit)
                            stays above budget; unevaluable where CUDA
                            is not initialised (the CPU)
``compile_cache_hit_ratio`` the ``_build/`` kernel-library cache keeps
                            serving the process's builds after warmup
==========================  ============================================
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np

from . import timeseries


@dataclass
class EvalContext:
    """What a check may look at."""
    sampler: timeseries.SlotSampler
    slot: int
    chains: tuple = ()          # live registered BeaconChains
    slots_seen: int = 0         # evaluations since engine (re)start


#: check signature: (value, breached, detail); value None = not enough
#: data this slot (counts as clean — an unevaluable objective is not
#: breaching, and it lets open incidents resolve once traffic stops)
Check = Callable[[EvalContext], tuple[float | None, bool, str]]


@dataclass
class SLO:
    name: str
    metric: str                 # CATALOG name the objective watches
    budget: float
    description: str
    check: Check
    resolve_after: int = 2      # consecutive clean slots to close


@dataclass
class Incident:
    slo: str
    metric: str
    budget: float
    opened_slot: int
    resolved_slot: int | None = None
    worst_value: float = 0.0
    detail: str = ""

    @property
    def open(self) -> bool:
        return self.resolved_slot is None

    def to_dict(self) -> dict:
        return {"slo": self.slo, "metric": self.metric,
                "budget": self.budget, "opened_slot": self.opened_slot,
                "resolved_slot": self.resolved_slot,
                "worst_value": self.worst_value, "detail": self.detail}


# -- default objective checks ------------------------------------------------


def _check_pipeline_p95(budget_s: float) -> Check:
    def check(ctx: EvalContext):
        p95 = ctx.sampler.latest("beacon_block_pipeline_seconds.p95")
        n = ctx.sampler.latest("beacon_block_pipeline_seconds.count")
        if p95 is None or not n:
            return None, False, "no pipeline traffic this slot"
        return p95, p95 > budget_s, f"pipeline p95 {p95 * 1e3:.1f}ms"
    return check


def _check_head_lag(budget_slots: float) -> Check:
    def check(ctx: EvalContext):
        if not ctx.chains:
            return None, False, "no chains registered"
        worst, who = -1.0, ""
        for ch in ctx.chains:
            try:
                clock_slot = int(ch.slot())
                head_slot = int(ch.head().head_state.slot)
            except Exception:
                continue
            # chains whose clock disagrees with the evaluated slot belong
            # to another (stopped) network still alive in-process — their
            # frozen heads must not pollute the objective
            if abs(clock_slot - ctx.slot) > 1:
                continue
            lag = max(0, (ctx.slot - 1) - head_slot)
            if lag > worst:
                worst, who = float(lag), f"head at slot {int(head_slot)}"
        if worst < 0:
            return None, False, "no readable heads"
        return worst, worst > budget_slots, \
            f"worst head lag {int(worst)} slots ({who})"
    return check


def _check_counter_quiet(metric: str, what: str,
                         warmup_slots: int) -> Check:
    """Breach when the counter moved this slot (after warmup)."""
    def check(ctx: EvalContext):
        delta = ctx.sampler.latest(metric)
        if delta is None:
            return None, False, "not sampled yet"
        if ctx.slots_seen <= warmup_slots:
            return delta, False, f"warmup ({what} {delta:.0f})"
        return delta, delta > 0, f"{what} {delta:.0f} this slot"
    return check


def _check_shuffle_hit_ratio(budget_ratio: float,
                             min_lookups: int) -> Check:
    def check(ctx: EvalContext):
        _, hits = ctx.sampler.series("shuffle_cache_hits_total")
        _, misses = ctx.sampler.series("shuffle_cache_misses_total")
        h = float(np.nansum(hits)) if hits.size else 0.0
        m = float(np.nansum(misses)) if misses.size else 0.0
        if h + m < min_lookups:
            return None, False, \
                f"only {h + m:.0f} lookups in window (< {min_lookups})"
        ratio = h / (h + m)
        return ratio, ratio < budget_ratio, \
            f"hit ratio {ratio:.2f} over {h + m:.0f} lookups"
    return check


def _check_sync_progress(floor_blocks: float, stall_slots: int) -> Check:
    """Breach after `stall_slots` CONSECUTIVE syncing slots that import
    fewer than `floor_blocks` blocks.  Single stalled slots are normal
    (requests in flight, a backoff pause after a byzantine serve); a
    run of them while still `sync_state != synced` means the deadline /
    validation / quarantine machinery failed to route around bad peers.
    """
    stalled = {"n": 0}      # closure state: consecutive stalled slots

    def check(ctx: EvalContext):
        state = ctx.sampler.latest("sync_state")
        if state is None or state == 0:
            stalled["n"] = 0
            return None, False, "not syncing"
        delta = ctx.sampler.latest("sync_range_blocks_imported_total")
        delta = 0.0 if delta is None else delta
        if delta >= floor_blocks:
            stalled["n"] = 0
            return delta, False, \
                f"{delta:.0f} blocks imported this slot"
        stalled["n"] += 1
        return delta, stalled["n"] >= stall_slots, (
            f"syncing but {delta:.0f} blocks imported this slot "
            f"({stalled['n']} consecutive below floor "
            f"{floor_blocks:.0f})")
    return check


def _check_replay_throughput(floor_blocks: float,
                             stall_slots: int) -> Check:
    """Breach after `stall_slots` CONSECUTIVE slots with a replay
    segment in flight (``replay_active`` gauge) committing fewer than
    `floor_blocks` blocks — the 1 block/slot-equivalent floor a
    replaying node must sustain to ever catch up.  Single
    slow slots are normal (an epoch batch commits in bursts); a run of
    them means a pipeline stage stalled."""
    stalled = {"n": 0}      # closure state: consecutive stalled slots

    def check(ctx: EvalContext):
        active = ctx.sampler.latest("replay_active")
        if active is None or active == 0:
            stalled["n"] = 0
            return None, False, "no replay in flight"
        delta = ctx.sampler.latest("replay_blocks_committed_total")
        delta = 0.0 if delta is None else delta
        if delta >= floor_blocks:
            stalled["n"] = 0
            return delta, False, \
                f"{delta:.0f} blocks committed this slot"
        stalled["n"] += 1
        return delta, stalled["n"] >= stall_slots, (
            f"replay active but {delta:.0f} blocks committed this slot "
            f"({stalled['n']} consecutive below floor "
            f"{floor_blocks:.0f})")
    return check


def _check_propagation_p95(budget_s: float) -> Check:
    def check(ctx: EvalContext):
        p95 = ctx.sampler.latest("block_propagation_seconds.p95")
        n = ctx.sampler.latest("block_propagation_seconds.count")
        if p95 is None or not n:
            return None, False, "no propagation traffic this slot"
        return p95, p95 > budget_s, f"propagation p95 {p95 * 1e3:.1f}ms"
    return check


def _check_serving_p95(budget_s: float) -> Check:
    def check(ctx: EvalContext):
        p95 = ctx.sampler.latest("api_request_seconds.p95")
        n = ctx.sampler.latest("api_request_seconds.count")
        if p95 is None or not n:
            return None, False, "no serving traffic this slot"
        return p95, p95 > budget_s, f"serving p95 {p95 * 1e3:.1f}ms"
    return check


def _check_serving_shed_rate(budget_ratio: float,
                             min_requests: int) -> Check:
    """Shed fraction per slot (both are per-slot counter deltas)."""
    def check(ctx: EvalContext):
        reqs = ctx.sampler.latest("api_requests_total")
        if reqs is None or reqs < min_requests:
            return None, False, \
                f"fewer than {min_requests} serving requests this slot"
        shed = ctx.sampler.latest("api_shed_total") or 0.0
        ratio = shed / reqs
        return ratio, ratio > budget_ratio, \
            f"shed {shed:.0f}/{reqs:.0f} requests ({ratio:.2f})"
    return check


def _check_hbm_headroom(budget_ratio: float) -> Check:
    """Breach when device memory headroom (1 - in_use/limit) drops
    below budget. Unevaluable where CUDA is not initialised (the CPU) —
    the ledger's honesty contract: absent stats are not clean-by-lie,
    they are explicitly not evaluated."""
    def check(ctx: EvalContext):
        in_use = ctx.sampler.latest("device_hbm_bytes_in_use")
        limit = ctx.sampler.latest("device_hbm_bytes_limit")
        if in_use is None or limit is None or limit <= 0:
            return None, False, "HBM stats unavailable on this platform"
        headroom = 1.0 - in_use / limit
        return headroom, headroom < budget_ratio, (
            f"HBM headroom {headroom:.2f} "
            f"({in_use / 2**30:.2f}/{limit / 2**30:.2f} GiB in use)")
    return check


def _check_compile_cache_hit_ratio(budget_ratio: float,
                                   warmup_slots: int,
                                   min_events: int) -> Check:
    """Kernel-library cache hit ratio over the window stays above
    budget after warmup (``kernels.build_all`` counts a library found in
    ``_build/`` as a hit, one nvcc had to build as a miss).  The warmup
    gate matters: the first run on a cold cache is all misses by
    design."""
    def check(ctx: EvalContext):
        _, hits = ctx.sampler.series("kernel_build_cache_hits_total")
        _, misses = ctx.sampler.series("kernel_build_cache_misses_total")
        h = float(np.nansum(hits)) if hits.size else 0.0
        m = float(np.nansum(misses)) if misses.size else 0.0
        if h + m < min_events:
            return None, False, \
                f"only {h + m:.0f} cache events in window (< {min_events})"
        if ctx.slots_seen <= warmup_slots:
            return None, False, \
                f"warmup ({h:.0f} hits / {m:.0f} misses so far)"
        ratio = h / (h + m)
        return ratio, ratio < budget_ratio, \
            f"compile-cache hit ratio {ratio:.2f} over {h + m:.0f} events"
    return check


def default_slos(pipeline_p95_s: float = 5.0,
                 head_lag_slots: int = 1,
                 compile_warmup_slots: int = 8,
                 shuffle_hit_ratio: float = 0.5,
                 shuffle_min_lookups: int = 20,
                 sync_floor_blocks: float = 1.0,
                 sync_stall_slots: int = 3,
                 serving_p95_s: float = 0.5,
                 serving_shed_ratio: float = 0.5,
                 serving_min_requests: int = 8,
                 replay_floor_blocks: float = 1.0,
                 replay_stall_slots: int = 3,
                 # propagation subsumes the whole verify->import pipeline,
                 # so its budget tracks pipeline_p95_s, not gossip alone
                 propagation_p95_s: float = 5.0,
                 hbm_headroom_ratio: float = 0.10,
                 compile_cache_hit_ratio: float = 0.5,
                 compile_cache_warmup_slots: int = 8,
                 compile_cache_min_events: int = 4) -> list[SLO]:
    return [
        SLO("block_pipeline_p95", "beacon_block_pipeline_seconds",
            pipeline_p95_s,
            "p95 of gossip arrival -> imported stays inside the "
            "scenario envelope (SCENARIOS.md)",
            _check_pipeline_p95(pipeline_p95_s)),
        SLO("head_lag", "beacon_head_slot", float(head_lag_slots),
            "every registered chain's head tracks the last complete "
            "slot within budget",
            _check_head_lag(float(head_lag_slots)),
            resolve_after=2),
        SLO("kernel_build_steady", "kernel_build_total", 0.0,
            "zero runtime nvcc builds per slot after warmup (a kernel "
            "library is built once, up front)",
            _check_counter_quiet("kernel_build_total", "builds",
                                 compile_warmup_slots)),
        SLO("shuffle_cache_hit_ratio", "shuffle_cache_hits_total",
            shuffle_hit_ratio,
            "the shared (seed, epoch) shuffling cache keeps absorbing "
            "committee lookups",
            _check_shuffle_hit_ratio(shuffle_hit_ratio,
                                     shuffle_min_lookups)),
        SLO("processor_shedding", "beacon_processor_work_dropped_total",
            0.0,
            "the beacon processor sheds no work at queue capacity; "
            "high-water floods intentionally trip this",
            _check_counter_quiet("beacon_processor_work_dropped_total",
                                 "shed items", warmup_slots=0)),
        SLO("sync_progress", "sync_range_blocks_imported_total",
            sync_floor_blocks,
            "while range-syncing the node keeps importing blocks every "
            "slot; byzantine peers may slow sync but never stop it",
            _check_sync_progress(sync_floor_blocks, sync_stall_slots),
            resolve_after=2),
        SLO("serving_p95", "api_request_seconds", serving_p95_s,
            "Beacon-API serving-tier request p95 stays inside budget "
            "(coalescing + response caches keep VC hot-path reads fast)",
            _check_serving_p95(serving_p95_s)),
        SLO("serving_shed_rate", "api_shed_total", serving_shed_ratio,
            "the serving tier's admission queue sheds at most a "
            "budgeted fraction of requests per slot",
            _check_serving_shed_rate(serving_shed_ratio,
                                     serving_min_requests)),
        SLO("replay_throughput", "replay_blocks_committed_total",
            replay_floor_blocks,
            "while a graftflow replay segment is in flight the pipeline "
            "commits at least 1 block per slot-equivalent; a stalled "
            "stage must surface, not silently wedge sync",
            _check_replay_throughput(replay_floor_blocks,
                                     replay_stall_slots),
            resolve_after=2),
        SLO("propagation_p95", "block_propagation_seconds",
            propagation_p95_s,
            "publish -> import block propagation p95 across the fleet "
            "stays inside budget (graftpath)",
            _check_propagation_p95(propagation_p95_s)),
        SLO("hbm_headroom", "device_hbm_bytes_in_use",
            hbm_headroom_ratio,
            "device memory headroom stays above budget; unevaluable "
            "where CUDA is not initialised (the CPU)",
            _check_hbm_headroom(hbm_headroom_ratio),
            resolve_after=2),
        SLO("compile_cache_hit_ratio", "kernel_build_cache_hits_total",
            compile_cache_hit_ratio,
            "the _build/ kernel-library cache keeps serving the "
            "process's builds after warmup",
            _check_compile_cache_hit_ratio(compile_cache_hit_ratio,
                                           compile_cache_warmup_slots,
                                           compile_cache_min_events)),
    ]


class SLOEngine:
    """Evaluates registered SLOs each slot; owns incident lifecycle."""

    def __init__(self, sampler: timeseries.SlotSampler | None = None,
                 slos: list[SLO] | None = None):
        self.sampler = sampler or timeseries.get_sampler()
        self.slos: dict[str, SLO] = {}
        self.incidents: list[Incident] = []
        self.on_open: list[Callable[[Incident], None]] = []
        self._open: dict[str, Incident] = {}
        self._clean: dict[str, int] = {}
        self._last_value: dict[str, float | None] = {}
        self._last_detail: dict[str, str] = {}
        self._slots_seen = 0
        self._lock = threading.Lock()
        for s in (default_slos() if slos is None else slos):
            self.register(s)

    def register(self, slo: SLO) -> None:
        with self._lock:
            self.slos[slo.name] = slo

    def reset(self) -> None:
        with self._lock:
            self.incidents = []
            self._open = {}
            self._clean = {}
            self._last_value = {}
            self._last_detail = {}
            self._slots_seen = 0

    # -- evaluation ------------------------------------------------------

    def evaluate(self, slot: int, chains: tuple = ()) -> list[Incident]:
        """Run every check against the rings; returns newly opened
        incidents (callbacks already fired, outside the lock)."""
        opened: list[Incident] = []
        with self._lock:
            self._slots_seen += 1
            ctx = EvalContext(self.sampler, int(slot), tuple(chains),
                              self._slots_seen)
            for slo in self.slos.values():
                try:
                    value, breached, detail = slo.check(ctx)
                except Exception as exc:  # a broken check never kills
                    value, breached = None, False  # the slot task
                    detail = f"check error: {exc!r}"
                self._last_value[slo.name] = value
                self._last_detail[slo.name] = detail
                inc = self._open.get(slo.name)
                if breached:
                    self._clean[slo.name] = 0
                    if inc is None:
                        inc = Incident(slo.name, slo.metric, slo.budget,
                                       opened_slot=int(slot),
                                       worst_value=(0.0 if value is None
                                                    else float(value)),
                                       detail=detail)
                        self._open[slo.name] = inc
                        self.incidents.append(inc)
                        opened.append(inc)
                    elif value is not None and value > inc.worst_value:
                        inc.worst_value = float(value)
                        inc.detail = detail
                elif inc is not None:
                    n = self._clean.get(slo.name, 0) + 1
                    self._clean[slo.name] = n
                    if n >= slo.resolve_after:
                        inc.resolved_slot = int(slot)
                        del self._open[slo.name]
        for inc in opened:
            for cb in list(self.on_open):
                try:
                    cb(inc)
                except Exception:
                    pass
        return opened

    # -- reads -----------------------------------------------------------

    def open_incidents(self) -> list[Incident]:
        with self._lock:
            return list(self._open.values())

    def all_incidents(self) -> list[Incident]:
        with self._lock:
            return list(self.incidents)

    def incidents_for(self, slo_name: str) -> list[Incident]:
        with self._lock:
            return [i for i in self.incidents if i.slo == slo_name]

    def status(self) -> dict:
        """Per-SLO snapshot for /lighthouse/graftwatch/slo."""
        with self._lock:
            out = {}
            for name, slo in self.slos.items():
                inc = self._open.get(name)
                out[name] = {
                    "metric": slo.metric,
                    "budget": slo.budget,
                    "description": slo.description,
                    "last_value": self._last_value.get(name),
                    "last_detail": self._last_detail.get(name, ""),
                    "open_incident": inc.to_dict() if inc else None,
                }
            return out
