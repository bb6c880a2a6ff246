"""graftpath critical-path extraction over graftscope span DAGs.

Given a trace — one node's span tree or a cross-node component stitched
by :mod:`obs.causal` — :func:`critical_path` walks *backwards* from the
last-finishing span and reports the longest dependent chain: which spans
the end-to-end latency actually waited on, with per-stage self-time and
the queue-wait vs service-time split (beacon-processor work spans stamp
``queue_wait_s`` at the enqueue hop).  The walk is the classic trace
profiler recursion: inside a span the path descends into the latest
child that finished before the cursor, gaps between children are the
span's own self-time, and at a span's start the path hops across a
causal edge (``propagation``/``rpc``/``import``) or re-enters the
parent.  Everything is deterministic — ties break on span ids — so the
synthetic-DAG golden test pins the output shape.

This is the number ROADMAP item 4 (pipelined import) needs: overlap
headroom is exactly the critical path's self-time that a stage pipeline
could hide.  Consumers: ``tools/trace/report.py --critpath``,
``tools/obs/diff.py``, the flight recorder (worst trace of an incident
window) and ``bench.py`` (PERF_MODEL §12).
"""
from __future__ import annotations

_EPS = 1e-9

#: stage kinds reported for the 1M-validator import decomposition
IMPORT_STAGES = ("batch_signature", "state_transition", "state_root",
                 "db_write")


class SpanView:
    """Duck-typed stand-in for ``tracing.Span`` built from serialized
    captures (flight dumps, Chrome traces, span-list JSON)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "kind", "start",
                 "end", "thread_id", "thread_name", "attrs", "scopes")

    def __init__(self, trace_id, span_id, parent_id, kind, start, end,
                 attrs=None, thread_id=0, thread_name=""):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.kind = kind
        self.start = float(start)
        self.end = float(end)
        self.thread_id = thread_id
        self.thread_name = thread_name
        self.attrs = dict(attrs or {})
        self.scopes = frozenset()

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)


_CORE_ARGS = ("trace_id", "span_id", "parent_id")


def spans_from_chrome(doc: dict) -> list[SpanView]:
    """Rehydrate spans from Chrome-trace JSON (``tracing.chrome_trace``
    or ``causal.stitched_chrome_trace`` output)."""
    out = []
    for i, ev in enumerate(doc.get("traceEvents", ())):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args", {})
        start = float(ev.get("ts", 0.0)) / 1e6
        out.append(SpanView(
            args.get("trace_id", f"t{i}"), args.get("span_id", f"s{i}"),
            args.get("parent_id"), ev.get("name", "?"), start,
            start + float(ev.get("dur", 0.0)) / 1e6,
            {k: v for k, v in args.items() if k not in _CORE_ARGS},
            thread_id=ev.get("tid", 0)))
    return out


def spans_from_json(items) -> list[SpanView]:
    """Rehydrate spans from ``Span.to_json`` dicts (the ``/tracing``
    endpoint's ``{"data": [...]}`` shape)."""
    out = []
    for i, d in enumerate(items):
        start = float(d.get("start_s", 0.0))
        out.append(SpanView(
            d.get("trace_id", f"t{i}"), d.get("span_id", f"s{i}"),
            d.get("parent_id"), d.get("kind", "?"), start,
            start + float(d.get("dur_s", 0.0)), d.get("attrs"),
            thread_name=d.get("thread", "")))
    return out


def _qwait(s) -> float:
    v = s.attrs.get("queue_wait_s")
    return float(v) if isinstance(v, (int, float)) and v > 0 else 0.0


def _ms(x: float) -> float:
    return round(x * 1e3, 3)


def critical_path(spans, edges=(), nodes=None) -> dict:
    """Longest dependent chain ending at the last-finishing span.

    ``edges`` are cross-trace ``(src_span_id, dst_span_id, kind)``
    triples from :func:`obs.causal.stitch`; ``nodes`` maps trace_id to
    a node label for attribution.  Returns ``{"total_ms", "terminal",
    "segments", "stages"}`` where segments run in chronological order
    and every stage row splits queue-wait from service time.
    """
    spans = [s for s in spans if s.end + _EPS >= s.start]
    if not spans:
        return {"total_ms": 0.0, "terminal": None, "segments": [],
                "stages": {}}
    nodes = nodes or {}
    by_id = {s.span_id: s for s in spans}
    children: dict[str, list] = {}
    for s in spans:
        if s.parent_id in by_id:
            children.setdefault(s.parent_id, []).append(s)
    preds: dict[str, list] = {}
    for src, dst, kind in edges:
        if src in by_id and dst in by_id:
            preds.setdefault(dst, []).append((by_id[src], kind))

    terminal = max(spans, key=lambda s: (s.end, s.span_id))
    segments: list[dict] = []          # built last -> first
    self_ms: dict[str, float] = {}     # span_id -> attributed self time

    def _node(s) -> str | None:
        n = s.attrs.get("node")
        return str(n) if n is not None else nodes.get(s.trace_id)

    def _emit(s, type_, dur):
        if dur <= _EPS:
            return
        seg = {"kind": s.kind, "span_id": s.span_id, "type": type_,
               "dur_ms": _ms(dur)}
        n = _node(s)
        if n is not None:
            seg["node"] = n
        segments.append(seg)
        if type_ == "self":
            self_ms[s.span_id] = self_ms.get(s.span_id, 0.0) + dur

    visited: set[str] = set()          # guards child/cross cycles only
    cur, t = terminal, terminal.end
    start_t = terminal.end
    for _ in range(4 * len(spans) + 16):
        visited.add(cur.span_id)
        kids = [c for c in children.get(cur.span_id, ())
                if c.span_id not in visited
                and c.end <= t + _EPS and c.end > cur.start + _EPS]
        if kids:
            c = max(kids, key=lambda k: (k.end, k.start, k.span_id))
            _emit(cur, "self", t - c.end)
            cur, t = c, c.end
            continue
        _emit(cur, "self", t - cur.start)
        t = min(t, cur.start)
        qw = _qwait(cur)
        if qw > _EPS:
            _emit(cur, "queue", qw)
            t -= qw
        cands = [(min(p.end, t), 1, p, kind)
                 for p, kind in preds.get(cur.span_id, ())
                 if p.span_id not in visited]
        par = by_id.get(cur.parent_id)
        if par is not None and par.start <= t + _EPS:
            cands.append((min(par.end, t), 0, par, "parent"))
        if not cands:
            start_t = t
            break
        _, _, p, kind = max(cands, key=lambda c: (c[0], c[1], c[2].span_id))
        if kind != "parent":
            wait = t - min(p.end, t)
            if wait > _EPS:
                _emit(cur, kind, wait)
            t = min(p.end, t)
        else:
            t = min(par.end, t)
        cur = p
        start_t = t
    segments.reverse()

    stages: dict[str, dict] = {}
    counted: set[str] = set()
    for sid, ms in self_ms.items():
        s = by_id[sid]
        row = stages.setdefault(s.kind, {
            "count": 0, "self_ms": 0.0, "queue_wait_ms": 0.0,
            "service_ms": 0.0})
        row["self_ms"] += _ms(ms)
        if sid not in counted:
            counted.add(sid)
            row["count"] += 1
            row["service_ms"] += _ms(s.duration)
            row["queue_wait_ms"] += _ms(_qwait(s))
    for row in stages.values():
        for k in ("self_ms", "queue_wait_ms", "service_ms"):
            row[k] = round(row[k], 3)

    term = {"kind": terminal.kind, "span_id": terminal.span_id,
            "trace_id": terminal.trace_id}
    n = _node(terminal)
    if n is not None:
        term["node"] = n
    return {
        "total_ms": _ms(max(0.0, terminal.end - start_t)),
        "terminal": term,
        "segments": segments,
        "stages": {k: stages[k] for k in sorted(stages)},
    }


def worst_component(spans, kinds=("block_pipeline", "block_import")):
    """The stitched component containing the slowest span of the given
    kinds (falling back to the slowest component outright); returns a
    ``causal.StitchedTrace`` or None."""
    from . import causal
    comps = causal.stitch(spans)
    if not comps:
        return None

    def _score(c):
        best = max((s.duration for s in c.spans if s.kind in kinds),
                   default=-1.0)
        return (best, c.duration)

    return max(comps, key=_score)


def component_report(comp) -> dict:
    """Critical-path report for one stitched component."""
    return critical_path(comp.spans, comp.edges, comp.nodes)


def render_critical_path(report: dict, title: str = "critical path") -> str:
    """Deterministic text table (doctor / trace report / diff share it)."""
    lines = []
    term = report.get("terminal")
    where = ""
    if term:
        where = f" ending in {term['kind']}"
        if term.get("node"):
            where += f" on {term['node']}"
    lines.append(f"{title}: {report.get('total_ms', 0.0):.3f} ms{where}")
    stages = report.get("stages") or {}
    if stages:
        w = max(len(k) for k in stages)
        w = max(w, len("stage"))
        lines.append(f"  {'stage':<{w}}  {'count':>5}  {'self_ms':>10}  "
                     f"{'queue_ms':>10}  {'service_ms':>10}")
        for kind in sorted(stages, key=lambda k: -stages[k]["self_ms"]):
            row = stages[kind]
            lines.append(
                f"  {kind:<{w}}  {row['count']:>5}  "
                f"{row['self_ms']:>10.3f}  {row['queue_wait_ms']:>10.3f}  "
                f"{row['service_ms']:>10.3f}")
    waits = [s for s in report.get("segments", ())
             if s["type"] not in ("self", "queue")]
    if waits:
        hop = sum(s["dur_ms"] for s in waits)
        kinds = ",".join(sorted({s["type"] for s in waits}))
        lines.append(f"  cross-node hops: {len(waits)} ({kinds}), "
                     f"{hop:.3f} ms waiting")
    return "\n".join(lines)
