"""graftpath differential profile — where did the time go between runs.

    python -m lighthouse_tpu_torch.tools.obs_diff old_trace.json new_trace.json
    python -m lighthouse_tpu_torch.tools.obs_diff --json old.json new.json
    python -m lighthouse_tpu_torch.tools.obs_diff --top 8 old_capture.json new_capture.json

Aligns two trace captures (Chrome trace-event documents from
`/lighthouse/tracing` / `obs.tracing.chrome_trace`, the `{"data": [span...]}`
form of `/lighthouse/tracing/spans`, or whole flight-recorder dumps) by
stage kind and attributes the wall-clock delta per stage: count, total
and p95 in both captures, the total-ms delta, and each stage's share of
the overall regression.  It then extracts both captures' critical paths
(obs/critpath.py, stitched cross-node when the captures carry node
attrs) and reports how the path itself moved — the stage whose
self-time grew is the one a regression is really made of.

Exit codes: 0 report produced, 2 unreadable input.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..obs import critpath


def load_spans(path: str) -> list:
    """SpanViews from any supported capture shape (Chrome trace,
    span-list JSON, or a flight-recorder dump's chrome_trace)."""
    raw = sys.stdin.read() if path == "-" else Path(path).read_text()
    doc = json.loads(raw)
    if isinstance(doc, dict) and doc.get("format") == "graftwatch-dump":
        doc = doc.get("chrome_trace") or {}
    if isinstance(doc, dict) and "traceEvents" in doc:
        return critpath.spans_from_chrome(doc)
    items = doc.get("data", doc) if isinstance(doc, dict) else doc
    return critpath.spans_from_json(items)


def _pctl(sorted_vals: list[float], pct: float) -> float:
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(pct / 100.0 * len(sorted_vals) + 0.5)) - 1))
    return sorted_vals[k]


def stage_stats(spans) -> dict[str, dict]:
    """Per-kind {count, total_ms, p50_ms, p95_ms} over a capture."""
    by_kind: dict[str, list[float]] = {}
    for s in spans:
        by_kind.setdefault(s.kind, []).append(s.duration * 1e3)
    out = {}
    for kind, vals in by_kind.items():
        vals.sort()
        out[kind] = {"count": len(vals),
                     "total_ms": round(sum(vals), 3),
                     "p50_ms": round(_pctl(vals, 50), 3),
                     "p95_ms": round(_pctl(vals, 95), 3)}
    return out


def _critpath_report(spans) -> dict | None:
    comp = critpath.worst_component(spans)
    if comp is None:
        return None
    rep = critpath.component_report(comp)
    return rep if rep["segments"] else None


def diff_captures(old_spans, new_spans) -> dict:
    """The full differential: per-stage deltas plus critical-path
    movement.  Pure over its inputs, so tests pin it with fixtures."""
    old_st, new_st = stage_stats(old_spans), stage_stats(new_spans)
    stages = []
    for kind in sorted(set(old_st) | set(new_st)):
        o = old_st.get(kind)
        n = new_st.get(kind)
        delta = round((n["total_ms"] if n else 0.0)
                      - (o["total_ms"] if o else 0.0), 3)
        stages.append({"stage": kind, "old": o, "new": n,
                       "delta_total_ms": delta})
    total_delta = round(sum(s["delta_total_ms"] for s in stages), 3)
    for s in stages:
        s["share"] = (round(s["delta_total_ms"] / total_delta, 3)
                      if abs(total_delta) > 1e-9 else None)
    stages.sort(key=lambda s: (-abs(s["delta_total_ms"]), s["stage"]))

    old_cp, new_cp = _critpath_report(old_spans), _critpath_report(new_spans)
    cp: dict | None = None
    if old_cp and new_cp:
        moves = []
        keys = set(old_cp["stages"]) | set(new_cp["stages"])
        for kind in sorted(keys):
            o = old_cp["stages"].get(kind, {})
            n = new_cp["stages"].get(kind, {})
            d = round(n.get("self_ms", 0.0) - o.get("self_ms", 0.0), 3)
            if abs(d) > 1e-9:
                moves.append({"stage": kind,
                              "old_self_ms": o.get("self_ms", 0.0),
                              "new_self_ms": n.get("self_ms", 0.0),
                              "delta_self_ms": d})
        moves.sort(key=lambda m: (-abs(m["delta_self_ms"]), m["stage"]))
        cp = {"old_total_ms": old_cp["total_ms"],
              "new_total_ms": new_cp["total_ms"],
              "delta_total_ms": round(new_cp["total_ms"]
                                      - old_cp["total_ms"], 3),
              "old": old_cp, "new": new_cp, "moved": moves}
    return {"stages": stages, "total_delta_ms": total_delta,
            "critical_path": cp}


def render(diff: dict, top: int = 12) -> str:
    lines = [f"differential profile: {diff['total_delta_ms']:+.3f} ms "
             "total stage time (new - old)"]
    rows = diff["stages"][:top]
    if rows:
        w = max([len("stage")] + [len(r["stage"]) for r in rows])
        lines.append(f"  {'stage':<{w}}  {'old_ms':>10}  {'new_ms':>10}  "
                     f"{'delta_ms':>10}  {'share':>6}")
        for r in rows:
            o = r["old"]["total_ms"] if r["old"] else 0.0
            n = r["new"]["total_ms"] if r["new"] else 0.0
            share = "-" if r["share"] is None else f"{r['share']:.0%}"
            lines.append(f"  {r['stage']:<{w}}  {o:>10.3f}  {n:>10.3f}  "
                         f"{r['delta_total_ms']:>+10.3f}  {share:>6}")
        dropped = len(diff["stages"]) - len(rows)
        if dropped > 0:
            lines.append(f"  ... {dropped} more stage(s), see --json")
    cp = diff.get("critical_path")
    if cp:
        lines.append(f"critical path: {cp['old_total_ms']:.3f} ms -> "
                     f"{cp['new_total_ms']:.3f} ms "
                     f"({cp['delta_total_ms']:+.3f} ms)")
        for m in cp["moved"][:top]:
            lines.append(f"  {m['stage']}: self "
                         f"{m['old_self_ms']:.3f} -> "
                         f"{m['new_self_ms']:.3f} ms "
                         f"({m['delta_self_ms']:+.3f})")
    else:
        lines.append("critical path: not comparable "
                     "(a capture has no spans)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("old", help="baseline capture, or '-' for stdin")
    ap.add_argument("new", help="candidate capture")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable diff instead of the table")
    ap.add_argument("--top", type=int, default=12, metavar="N",
                    help="stage rows shown in the table (default 12)")
    args = ap.parse_args(argv)
    try:
        old_spans = load_spans(args.old)
        new_spans = load_spans(args.new)
    except (OSError, ValueError, AttributeError) as e:
        print(f"unreadable capture: {e}", file=sys.stderr)
        return 2
    diff = diff_captures(old_spans, new_spans)
    print(json.dumps(diff, indent=2) if args.json
          else render(diff, args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
