"""graftscope tracing core: spans, thread-local context, span ring.

The two north-star hot spots (batched BLS verification, BeaconState
merkleization — PAPER.md "compute hot spots") were invisible at runtime:
the metrics catalog declared the histograms but the import pipeline never
fed most of them.  This module is the single timing substrate:

- :func:`span` is a context manager that opens a :class:`Span` carrying a
  trace id through thread-local context.  Exiting the span pushes it into
  a process-wide ring buffer AND observes the matching catalog histogram
  (``SPAN_KINDS`` maps every kind to a ``metrics_defs.CATALOG`` name), so
  tracing and Prometheus can never drift apart.
- Context crosses threads explicitly: :func:`capture` at the spawn/submit
  site, :class:`attach` in the worker.  ``utils.threads.ThreadGroup`` and
  the beacon processor's ``Work`` items do this automatically, so one
  gossip block is ONE trace from gossip-verify to db-write.
- Root spans are slot-anchored: when a slot clock is registered
  (:func:`set_slot_clock`), every trace root records the slot and the
  delay from slot start — the lateness signal the block-times cache and
  validator monitor read.

Deliberately stdlib-only and import-light: the ring is plain Python, the
metrics feed goes through ``sys.modules`` (never imports the api package
itself), so library users of crypto/ssz stay weightless and there are no
import cycles.  Spans time host-side orchestration; CUDA launches are
asynchronous, so a span closes before the device work it enqueued unless
the code inside it reads a result back.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
import time

#: span kind -> metrics_defs.CATALOG histogram fed on span exit.
#: Every kind MUST map to a declared histogram (tier-1 asserts this), so
#: adding a span kind forces the catalog entry and vice versa.
SPAN_KINDS: dict[str, str] = {
    # block import pipeline (one trace per gossip block)
    "block_pipeline": "beacon_block_pipeline_seconds",
    "block_import": "beacon_block_processing_seconds",
    "gossip_verify": "beacon_block_processing_gossip_verification_seconds",
    "batch_signature": "beacon_block_processing_signature_seconds",
    "state_transition": "beacon_block_processing_state_transition_seconds",
    "state_root": "beacon_block_processing_state_root_seconds",
    "fork_choice": "beacon_block_processing_fork_choice_seconds",
    "db_write": "beacon_block_processing_db_write_seconds",
    "block_production": "beacon_block_production_seconds",
    # attestation plane
    "attestation_verify": "beacon_attestation_processing_seconds",
    "aggregate_verify": "beacon_aggregate_processing_seconds",
    # crypto hot spots
    "bls_batch_verify": "beacon_batch_verify_seconds",
    "tree_hash": "tree_hash_root_seconds",
    "kzg_verify": "kzg_blob_verification_seconds",
    # beacon processor + store + execution layer
    "processor_work": "beacon_processor_work_seconds",
    "store_migration": "store_migration_seconds",
    "cold_state_replay": "store_cold_state_replay_seconds",
    "el_new_payload": "execution_layer_new_payload_seconds",
    "el_forkchoice": "execution_layer_forkchoice_seconds",
    # bench harness stages (bench.py --trace)
    "bench_stage": "bench_stage_seconds",
    # mainnet-envelope STF (slot.py epoch boundary, bench.py stf mode)
    "stf_epoch": "stf_epoch_seconds",
    "stf_block": "stf_block_seconds",
    # Beacon-API serving tier (api/serving/tier.py)
    "api_request": "api_request_seconds",
    # graftflow replay pipeline stages (chain/replay/)
    "replay_admission": "replay_stage_admission_seconds",
    "replay_signature": "replay_stage_signature_seconds",
    "replay_stf": "replay_stage_stf_seconds",
    "replay_merkle": "replay_stage_merkle_seconds",
    "replay_commit": "replay_stage_commit_seconds",
    # graftpath cross-node causal annotation points (obs/causal.py)
    "gossip_publish": "gossipsub_publish_seconds",
    "gossip_deliver": "gossipsub_deliver_seconds",
    "rpc_request": "rpc_request_seconds",
    "rpc_serve": "rpc_serve_seconds",
}

_RING_CAPACITY = 4096
_PID = os.getpid()


class Span:
    """One finished (or in-flight) timed region."""

    __slots__ = ("trace_id", "span_id", "parent_id", "kind", "start",
                 "end", "thread_id", "thread_name", "attrs", "scopes")

    def __init__(self, trace_id: str, span_id: str, parent_id: str | None,
                 kind: str):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.kind = kind
        self.start = 0.0           # perf_counter seconds
        self.end = 0.0
        t = threading.current_thread()
        self.thread_id = t.ident or 0
        self.thread_name = t.name
        self.attrs: dict = {}
        #: capture-scope ids this span belongs to (see capture_scope)
        self.scopes: frozenset = frozenset()

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    def annotate(self, **kw) -> "Span":
        self.attrs.update(kw)
        return self

    def to_json(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "kind": self.kind,
            "start_s": round(self.start, 9), "dur_s": round(self.duration, 9),
            "thread": self.thread_name,
            "attrs": {k: (v.hex() if isinstance(v, bytes) else v)
                      for k, v in self.attrs.items()},
        }


class SpanRing:
    """Fixed-capacity ring of finished spans.

    Lock-free-ish: writers reserve a monotonically increasing sequence
    number from ``itertools.count`` (atomic under the GIL) and store
    ``(seq, span)`` into ``slots[seq % capacity]``; readers snapshot the
    slot list and sort by sequence.  A torn read can at worst miss or
    duplicate a span at the wrap boundary — acceptable for a debug
    facility that must never contend with the import hot path.
    """

    def __init__(self, capacity: int = _RING_CAPACITY):
        self.capacity = capacity
        self._slots: list = [None] * capacity
        self._seq = itertools.count()

    def push(self, s: Span) -> None:
        i = next(self._seq)
        self._slots[i % self.capacity] = (i, s)

    def snapshot(self) -> list[Span]:
        return [e[1] for e in sorted(
            (e for e in list(self._slots) if e is not None),
            key=lambda t: t[0])]

    def clear(self) -> None:
        self._slots = [None] * self.capacity


class _Ctx(threading.local):
    def __init__(self):
        self.stack: list[Span] = []
        #: (trace_id, span_id) adopted from another thread via attach()
        self.inherited: tuple[str, str] | None = None
        #: capture scopes explicitly bound to this thread (propagated by
        #: capture()/attach); None = unscoped thread, whose *root* spans
        #: adopt every globally active scope (see capture_scope)
        self.scopes: frozenset | None = None


_ctx = _Ctx()
_ids = itertools.count(1)
_ring = SpanRing()
_slot_clock = None

# -- capture scopes ----------------------------------------------------------
# A capture scope tags spans so concurrent captures (and background
# traffic outside any capture) can be told apart when reading the shared
# ring.  Scope membership propagates two ways:
#  - explicitly: capture()/attach hand a thread's scope set across
#    spawns and work-queue hops together with the trace context;
#  - implicitly: a root span on a thread with NO explicit scope set
#    (e.g. a transport read-loop spawned at connection time, long before
#    any capture existed) is tagged with every scope active at that
#    moment — such traffic cannot be attributed to one capture, so every
#    live capture sees it rather than none (the envelopes assert on
#    pipeline spans that are born exactly there).
_scope_ids = itertools.count(1)
_active_scopes: set[int] = set()
_scopes_lock = threading.Lock()


def _active_scope_snapshot() -> frozenset:
    if not _active_scopes:          # fast path; benign race
        return frozenset()
    with _scopes_lock:
        return frozenset(_active_scopes)


class capture_scope:
    """Context manager opening one capture scope: spans started while
    it is active (per the propagation rules above) carry ``self.id`` in
    ``Span.scopes``.  Nests: a thread inside two scopes tags both."""

    def __init__(self):
        self.id: int | None = None
        self._prev: frozenset | None = None

    def __enter__(self) -> "capture_scope":
        self.id = next(_scope_ids)
        with _scopes_lock:
            _active_scopes.add(self.id)
        self._prev = _ctx.scopes
        base = self._prev if self._prev is not None else frozenset()
        _ctx.scopes = base | {self.id}
        return self

    def __exit__(self, *exc):
        with _scopes_lock:
            _active_scopes.discard(self.id)
        _ctx.scopes = self._prev
        return False


def set_slot_clock(clock) -> None:
    """Register the node's slot clock; trace roots then carry slot +
    delay-from-slot-start attributes (block_times_cache anchoring)."""
    global _slot_clock
    _slot_clock = clock


def _new_id() -> str:
    return f"{_PID:x}-{next(_ids):x}"


def current_span() -> Span | None:
    return _ctx.stack[-1] if _ctx.stack else None


def current_context() -> tuple[str, str] | None:
    """(trace_id, span_id) of the active span, or the context inherited
    from a parent thread, or None."""
    s = current_span()
    if s is not None:
        return (s.trace_id, s.span_id)
    return _ctx.inherited


def capture() -> tuple | None:
    """Snapshot the calling thread's context for explicit hand-off to
    another thread / work queue (pair with :class:`attach`).

    Returns ``(trace_id, span_id, scopes)`` — the scope element rides
    along so work queued from inside a capture window stays attributed
    to it when a worker thread executes later.  ``attach`` also still
    accepts the historical 2-tuple shape."""
    s = current_span()
    if s is not None:
        return (s.trace_id, s.span_id, s.scopes)
    scopes = _ctx.scopes
    if _ctx.inherited is not None:
        return _ctx.inherited + (scopes,)
    if scopes is not None:
        return (None, None, scopes)
    return None


def annotate(**kw) -> None:
    """Attach attributes to the current span (no-op without one)."""
    s = current_span()
    if s is not None:
        s.attrs.update(kw)


class attach:
    """Re-attach a captured context in a worker thread::

        ctx = tracing.capture()          # submitting thread
        with tracing.attach(ctx):        # worker thread
            with tracing.span(...): ...  # joins the submitter's trace
    """

    def __init__(self, ctx: tuple | None):
        ctx = tuple(ctx) if ctx is not None else None
        self.scopes: frozenset | None = None
        if ctx is not None and len(ctx) == 3:
            self.scopes = ctx[2]
            ctx = None if ctx[0] is None else ctx[:2]
        self.ctx = ctx
        self._prev: tuple[str, str] | None = None
        self._prev_scopes: frozenset | None = None

    def __enter__(self):
        self._prev = _ctx.inherited
        self._prev_scopes = _ctx.scopes
        if self.ctx is not None:
            _ctx.inherited = self.ctx
        if self.scopes is not None:
            _ctx.scopes = self.scopes
        return self

    def __exit__(self, *exc):
        _ctx.inherited = self._prev
        _ctx.scopes = self._prev_scopes
        return False


def _observe_metric(name: str, value: float) -> None:
    """Feed the catalog histogram WITHOUT importing the api package: a
    pure-crypto library user must not drag in the HTTP/metrics stack just
    because a span closed.  Once the node imported metrics_defs (the
    chain always does), every span lands in Prometheus."""
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    if md is not None:
        md.observe(name, value)


class span:
    """Context manager opening a child of the current span (or a new
    trace root).  ``kind`` must be a registered ``SPAN_KINDS`` key."""

    def __init__(self, kind: str, **attrs):
        assert kind in SPAN_KINDS, \
            f"unknown span kind {kind!r} — register it in SPAN_KINDS"
        self.kind = kind
        self._attrs = attrs
        self._span: Span | None = None

    def __enter__(self) -> Span:
        parent = current_span()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
            scopes = parent.scopes
        else:
            if _ctx.inherited is not None:
                trace_id, parent_id = _ctx.inherited
            else:
                trace_id, parent_id = _new_id(), None
            scopes = (_ctx.scopes if _ctx.scopes is not None
                      else _active_scope_snapshot())
        s = Span(trace_id, _new_id(), parent_id, self.kind)
        s.scopes = scopes
        s.attrs.update(self._attrs)
        if parent_id is None and _slot_clock is not None:
            # slot-anchored root: how late into the slot did this start?
            try:
                s.attrs.setdefault("slot", _slot_clock.now())
                s.attrs["slot_offset_s"] = round(
                    _slot_clock.seconds_into_slot(), 6)
            except Exception:
                pass
        _ctx.stack.append(s)
        s.start = time.perf_counter()
        self._span = s
        return s

    def __exit__(self, exc_type, exc, tb):
        s = self._span
        s.end = time.perf_counter()
        if exc_type is not None:
            s.attrs.setdefault("error", exc_type.__name__)
        # pop by identity — a mis-nested exit must not corrupt the stack
        if _ctx.stack and _ctx.stack[-1] is s:
            _ctx.stack.pop()
        elif s in _ctx.stack:
            _ctx.stack.remove(s)
        _ring.push(s)
        metric = SPAN_KINDS[self.kind]
        if metric:
            _observe_metric(metric, s.duration)
        return False


# -- ring access / export ----------------------------------------------------

def snapshot() -> list[Span]:
    return _ring.snapshot()


def clear() -> None:
    _ring.clear()


def chrome_trace(spans: list[Span] | None = None) -> dict:
    """Chrome trace-event JSON (load at ui.perfetto.dev or
    chrome://tracing).  Timestamps are perf_counter-relative
    microseconds, so ts is monotonic and nesting is exact."""
    spans = snapshot() if spans is None else spans
    base = min((s.start for s in spans), default=0.0)
    events = []
    for s in spans:
        args = {"trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        for k, v in s.attrs.items():
            args[k] = v.hex() if isinstance(v, bytes) else v
        events.append({
            "name": s.kind,
            "cat": "lighthouse_tpu_torch",
            "ph": "X",
            "ts": round((s.start - base) * 1e6, 3),
            "dur": round(s.duration * 1e6, 3),
            "pid": _PID,
            "tid": s.thread_id,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
