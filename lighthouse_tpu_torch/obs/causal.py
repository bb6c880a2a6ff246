"""graftpath causal stitching — cross-node trace DAGs without wire bytes.

graftscope (tracing.py) records one span ring per *process*, but an
in-process LocalNetwork runs many nodes in that one process and causality
dies at the transport: node A's ``gossip_publish`` span and node B's
``block_pipeline`` span belong to different traces even though one caused
the other.  The wire already carries everything needed to reconnect them
— eth2 gossip message-ids are content-derived (SHA256 over topic + data,
``network/gossip.py``) and req/resp payload bytes are identical on both
sides of a stream — so the annotation sites stamp those identifiers as
span attrs and this module stitches after the fact:

- :func:`stitch` unions traces that share a causal key (``message_id``,
  ``block_root``/``root``, ``req_id``) into :class:`StitchedTrace`
  components and materializes cross-trace edges: ``propagation``
  (publish -> deliver, keyed by message-id), ``rpc`` (request -> serve,
  keyed by req-id) and ``import`` (publish -> import keyed by root, for
  sync-path imports that never saw the gossip message).
- :class:`PropagationTracker` is the *online* counterpart: the network
  service reports publish/import/deliver events and the tracker feeds
  the ``block_propagation_seconds`` / ``attestation_propagation_seconds``
  histograms graftwatch samples per slot and the ``propagation_p95`` SLO
  watches.
- :func:`stitched_chrome_trace` exports one Chrome-trace *process per
  node* (plus flow arrows for the cross-node edges), so a whole scenario
  run loads in Perfetto as a fleet, not a soup.

Stdlib-only; metrics feed through ``sys.modules`` like the rest of obs.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import OrderedDict

#: span attrs that carry causal identity (graftlint's trace-safety rule
#: requires delivery callbacks to attach one of these)
CAUSAL_KEYS = ("message_id", "block_root", "root", "req_id")

_EPS = 1e-9


def _observe(name: str, value: float) -> None:
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    if md is not None:
        md.observe(name, value)


# -- online propagation accounting -------------------------------------------

class PropagationTracker:
    """Bounded publish->deliver latency accounting.

    ``on_block_published`` stamps the publish instant per block root;
    every later ``on_block_imported`` for that root (each receiving node
    imports once) observes ``block_propagation_seconds``.  The proposer's
    own import happens *before* publish and is therefore a lookup miss —
    exactly right, self-import is not propagation.  Aggregate attestation
    messages use the gossip message-id the same way.  Both maps are
    LRU-bounded so an adversarial flood cannot grow them.
    """

    capacity = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._blocks: OrderedDict[str, float] = OrderedDict()
        self._atts: OrderedDict[str, float] = OrderedDict()

    @staticmethod
    def _key(ident) -> str:
        return ident.hex() if isinstance(ident, (bytes, bytearray)) else str(ident)

    def _put(self, table: OrderedDict, key: str, now: float) -> None:
        with self._lock:
            table[key] = now
            table.move_to_end(key)
            while len(table) > self.capacity:
                table.popitem(last=False)

    def _elapsed(self, table: OrderedDict, key: str, now: float) -> float | None:
        with self._lock:
            t0 = table.get(key)
        if t0 is None:
            return None
        return max(0.0, now - t0)

    # -- blocks ----------------------------------------------------------

    def on_block_published(self, root, now: float | None = None) -> None:
        self._put(self._blocks, self._key(root),
                  time.perf_counter() if now is None else now)

    def on_block_imported(self, root, now: float | None = None) -> float | None:
        dt = self._elapsed(self._blocks, self._key(root),
                           time.perf_counter() if now is None else now)
        if dt is not None:
            _observe("block_propagation_seconds", dt)
        return dt

    # -- aggregates ------------------------------------------------------

    def on_attestation_published(self, message_id,
                                 now: float | None = None) -> None:
        self._put(self._atts, self._key(message_id),
                  time.perf_counter() if now is None else now)

    def on_attestation_delivered(self, message_id,
                                 now: float | None = None) -> float | None:
        dt = self._elapsed(self._atts, self._key(message_id),
                           time.perf_counter() if now is None else now)
        if dt is not None:
            _observe("attestation_propagation_seconds", dt)
        return dt

    def reset(self) -> None:
        with self._lock:
            self._blocks.clear()
            self._atts.clear()


_TRACKER = PropagationTracker()


def tracker() -> PropagationTracker:
    return _TRACKER


# -- offline stitching -------------------------------------------------------

class _UnionFind:
    def __init__(self):
        self._parent: dict = {}

    def find(self, x):
        p = self._parent.setdefault(x, x)
        while p != x:
            self._parent[x] = p = self._parent.setdefault(p, p)
            x, p = p, self._parent[p]
        return p

    def union(self, a, b) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # deterministic: smaller representative wins
            lo, hi = sorted((ra, rb))
            self._parent[hi] = lo


def _attr(s, *names) -> str | None:
    for n in names:
        v = s.attrs.get(n)
        if v is not None:
            return v.hex() if isinstance(v, (bytes, bytearray)) else str(v)
    return None


def node_map(spans) -> dict[str, str]:
    """trace_id -> node label, from any span in the trace carrying a
    ``node`` attr (the graftpath annotation sites all stamp it)."""
    out: dict[str, str] = {}
    for s in spans:
        n = s.attrs.get("node")
        if n is not None and s.trace_id not in out:
            out[s.trace_id] = str(n)
    return out


class StitchedTrace:
    """One causal component: spans from every participating trace plus
    the cross-trace edges that join them."""

    __slots__ = ("spans", "edges", "nodes")

    def __init__(self, spans, edges, nodes):
        self.spans = spans            # sorted by (start, span_id)
        self.edges = edges            # [(src span_id, dst span_id, kind)]
        self.nodes = nodes            # trace_id -> node label (subset)

    @property
    def start(self) -> float:
        return self.spans[0].start if self.spans else 0.0

    @property
    def end(self) -> float:
        return max((s.end for s in self.spans), default=0.0)

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    def trace_ids(self) -> list[str]:
        return sorted({s.trace_id for s in self.spans})

    def block_roots(self) -> list[str]:
        roots = set()
        for s in self.spans:
            r = _attr(s, "block_root", "root")
            if r is not None:
                roots.add(r)
        return sorted(roots)

    def node_labels(self) -> list[str]:
        return sorted(set(self.nodes.values()))


def _latest_enabler(cands, dst):
    """The publisher/requester that most recently finished before the
    receiver started — the tightest causal constraint.  Falls back to
    the earliest candidate when every one overlaps the receiver."""
    before = [c for c in cands if c.end <= dst.start + _EPS]
    if before:
        return max(before, key=lambda s: (s.end, s.span_id))
    return min(cands, key=lambda s: (s.start, s.span_id))


def stitch(spans) -> list[StitchedTrace]:
    """Union every trace in ``spans`` that shares a causal key into one
    :class:`StitchedTrace` per component (single-trace components
    included), each with its propagation/rpc/import edges."""
    spans = sorted(spans, key=lambda s: (s.start, s.span_id))
    uf = _UnionFind()
    for s in spans:
        uf.find(s.trace_id)
    by_mid: dict[str, list] = {}
    by_root: dict[str, list] = {}
    by_rid: dict[str, list] = {}
    for s in spans:
        mid = _attr(s, "message_id")
        if mid is not None:
            by_mid.setdefault(mid, []).append(s)
        root = _attr(s, "block_root", "root")
        if root is not None:
            by_root.setdefault(root, []).append(s)
        rid = _attr(s, "req_id")
        if rid is not None:
            by_rid.setdefault(rid, []).append(s)
    for table in (by_mid, by_root, by_rid):
        for group in table.values():
            first = group[0].trace_id
            for s in group[1:]:
                uf.union(first, s.trace_id)

    edges: list[tuple[str, str, str]] = []
    linked: set[str] = set()          # span_ids with an incoming edge
    for mid, group in sorted(by_mid.items()):
        pubs = [s for s in group if s.kind == "gossip_publish"]
        for dst in group:
            if dst.kind not in ("block_pipeline", "gossip_deliver"):
                continue
            cands = [p for p in pubs if p.trace_id != dst.trace_id]
            if not cands:
                continue
            src = _latest_enabler(cands, dst)
            edges.append((src.span_id, dst.span_id, "propagation"))
            linked.add(dst.span_id)
    for rid, group in sorted(by_rid.items()):
        reqs = [s for s in group if s.kind == "rpc_request"]
        for dst in group:
            if dst.kind != "rpc_serve":
                continue
            cands = [r for r in reqs if r.trace_id != dst.trace_id]
            if not cands:
                continue
            src = _latest_enabler(cands, dst)
            edges.append((src.span_id, dst.span_id, "rpc"))
            linked.add(dst.span_id)
    for root, group in sorted(by_root.items()):
        pubs = [s for s in group if s.kind == "gossip_publish"]
        if not pubs:
            continue
        for dst in group:
            if dst.kind != "block_import" or dst.span_id in linked:
                continue
            # the pipeline root usually owns the propagation edge; the
            # import edge covers traces with no message-id (sync path)
            cands = [p for p in pubs if p.trace_id != dst.trace_id]
            if not cands:
                continue
            src = _latest_enabler(cands, dst)
            edges.append((src.span_id, dst.span_id, "import"))
            linked.add(dst.span_id)

    nodes = node_map(spans)
    comp_spans: dict[str, list] = {}
    for s in spans:
        comp_spans.setdefault(uf.find(s.trace_id), []).append(s)
    comp_edges: dict[str, list] = {}
    span_comp = {s.span_id: uf.find(s.trace_id) for s in spans}
    for e in edges:
        comp_edges.setdefault(span_comp[e[0]], []).append(e)
    out = []
    for rep in sorted(comp_spans,
                      key=lambda r: (comp_spans[r][0].start, r)):
        members = comp_spans[rep]
        tids = {s.trace_id for s in members}
        out.append(StitchedTrace(
            members, sorted(comp_edges.get(rep, ())),
            {t: n for t, n in nodes.items() if t in tids}))
    return out


def propagation_digest(spans) -> dict:
    """Structure-only fingerprint of a capture: for every published
    block root, who published it and which nodes imported it.  Timing-
    free, so two seeded runs of the same scenario produce the same
    digest even though wall-clock jitters."""
    publishers: dict[str, str] = {}
    importers: dict[str, set] = {}
    nodes = node_map(spans)
    for s in spans:
        root = _attr(s, "block_root", "root")
        if root is None:
            continue
        node = s.attrs.get("node") or nodes.get(s.trace_id, "?")
        if s.kind == "gossip_publish" and root not in publishers:
            publishers[root] = str(node)
        elif s.kind == "block_import":
            importers.setdefault(root, set()).add(str(node))
    return {root: {"publisher": pub,
                   "importers": sorted(importers.get(root, ()))}
            for root, pub in sorted(publishers.items())}


def stitched_chrome_trace(spans) -> dict:
    """Chrome-trace JSON with one *pid per node* (process_name metadata
    rows) and flow arrows for every cross-node edge — the Perfetto view
    of a whole in-process fleet."""
    spans = sorted(spans, key=lambda s: (s.start, s.span_id))
    nodes = node_map(spans)
    labels = sorted(set(nodes.values()))
    pid_of_label = {lab: i + 1 for i, lab in enumerate(labels)}
    unknown_pid = len(labels) + 1
    base = min((s.start for s in spans), default=0.0)
    events = []
    for lab in labels:
        events.append({"name": "process_name", "ph": "M",
                       "pid": pid_of_label[lab], "tid": 0,
                       "args": {"name": lab}})
    if any(s.trace_id not in nodes for s in spans):
        events.append({"name": "process_name", "ph": "M",
                       "pid": unknown_pid, "tid": 0,
                       "args": {"name": "(unattributed)"}})

    def _pid(s) -> int:
        lab = nodes.get(s.trace_id)
        return pid_of_label[lab] if lab is not None else unknown_pid

    ts_of: dict[str, tuple[int, int, float, float]] = {}
    for s in spans:
        args = {"trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        for k, v in s.attrs.items():
            args[k] = v.hex() if isinstance(v, (bytes, bytearray)) else v
        pid = _pid(s)
        ts = round((s.start - base) * 1e6, 3)
        dur = round(s.duration * 1e6, 3)
        ts_of[s.span_id] = (pid, s.thread_id, ts, dur)
        events.append({"name": s.kind, "cat": "lighthouse_tpu_torch", "ph": "X",
                       "ts": ts, "dur": dur, "pid": pid,
                       "tid": s.thread_id, "args": args})
    flow = 0
    for comp in stitch(spans):
        for src_id, dst_id, kind in comp.edges:
            if src_id not in ts_of or dst_id not in ts_of:
                continue
            flow += 1
            sp, st, sts, sdur = ts_of[src_id]
            dp, dt, dts, _ = ts_of[dst_id]
            events.append({"name": kind, "cat": "graftpath", "ph": "s",
                           "id": flow, "pid": sp, "tid": st,
                           "ts": round(sts + sdur, 3)})
            events.append({"name": kind, "cat": "graftpath", "ph": "f",
                           "bp": "e", "id": flow, "pid": dp, "tid": dt,
                           "ts": dts})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
