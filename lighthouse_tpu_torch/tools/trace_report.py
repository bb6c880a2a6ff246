"""graftscope trace report — per-stage latency table from a trace.

    python -m lighthouse_tpu_torch.tools.trace_report trace.json    # Chrome trace file
    curl -s $BN/lighthouse/tracing | python -m lighthouse_tpu_torch.tools.trace_report -
    python -m lighthouse_tpu_torch.tools.trace_report --format json trace.json
    python -m lighthouse_tpu_torch.tools.trace_report --since-slot 64 --kind block_pipeline t.json
    python -m lighthouse_tpu_torch.tools.trace_report --critpath trace.json

Accepts the Chrome trace-event document served by /lighthouse/tracing
(or written by `obs.tracing.chrome_trace`), or the {"data": [span...]} form of
/lighthouse/tracing/spans.  Prints count / p50 / p95 / max / total per
stage, widest-total first.

--critpath switches to the graftpath view: the critical path of the
slowest block trace in the capture (stitched cross-node when the spans
carry node attrs), with per-stage self-time and the queue-wait vs
service-time split from obs/critpath.py.

Filters compose:
  --kind K          only stages named K (repeatable)
  --since-slot N    only traces whose ROOT span is slot-anchored at
                    slot >= N; the root's slot decides the whole trace,
                    so children (which carry no slot) follow their root.
                    Traces with no slot-anchored root are dropped.

Exit codes: 0 ok, 2 unreadable input.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..obs import critpath as critpath_mod
from ..obs.report import render_table, summarize_chrome, summarize_durations


def _norm_spans(doc) -> list[dict] | None:
    """The /lighthouse/tracing/spans shape, if that is what `doc` is."""
    if isinstance(doc, dict) and "traceEvents" in doc:
        return None
    return doc.get("data", doc) if isinstance(doc, dict) else doc


def _trace_slots_chrome(events: list[dict]) -> dict[str, int]:
    """trace_id -> root slot, from slot-anchored root events."""
    out: dict[str, int] = {}
    for ev in events:
        args = ev.get("args") or {}
        if "slot" in args and "parent_id" not in args:
            tid = args.get("trace_id")
            if tid is not None:
                out[tid] = int(args["slot"])
    return out


def _trace_slots_spans(spans: list[dict]) -> dict[str, int]:
    out: dict[str, int] = {}
    for s in spans:
        attrs = s.get("attrs") or {}
        if "slot" in attrs and s.get("parent_id") is None:
            tid = s.get("trace_id")
            if tid is not None:
                out[tid] = int(attrs["slot"])
    return out


def filter_doc(doc, kinds: list[str] | None,
               since_slot: int | None):
    """Apply --kind / --since-slot to either document shape."""
    spans = _norm_spans(doc)
    if spans is None:                        # Chrome trace-event document
        events = [ev for ev in doc.get("traceEvents", [])
                  if ev.get("ph") == "X"]
        if since_slot is not None:
            by_trace = _trace_slots_chrome(events)
            events = [ev for ev in events
                      if by_trace.get((ev.get("args") or {})
                                      .get("trace_id"), -1) >= since_slot]
        if kinds:
            events = [ev for ev in events if ev.get("name") in kinds]
        return {"traceEvents": events}
    if since_slot is not None:
        by_trace = _trace_slots_spans(spans)
        spans = [s for s in spans
                 if by_trace.get(s.get("trace_id"), -1) >= since_slot]
    if kinds:
        spans = [s for s in spans if s.get("kind") in kinds]
    return {"data": spans}


def summarize_any(doc) -> dict:
    """Summary from either supported document shape."""
    if isinstance(doc, dict) and "traceEvents" in doc:
        return summarize_chrome(doc)
    spans = _norm_spans(doc)
    by_stage: dict[str, list[float]] = {}
    for s in spans:
        by_stage.setdefault(s.get("kind", "?"), []).append(
            float(s.get("dur_s", 0.0)))
    return summarize_durations(by_stage)


def critpath_report(doc) -> dict | None:
    """Critical path of the slowest block trace in either document
    shape; None when the capture is empty."""
    if isinstance(doc, dict) and "traceEvents" in doc:
        spans = critpath_mod.spans_from_chrome(doc)
    else:
        spans = critpath_mod.spans_from_json(_norm_spans(doc) or [])
    comp = critpath_mod.worst_component(spans)
    if comp is None:
        return None
    rep = critpath_mod.component_report(comp)
    if not rep["segments"]:
        return None
    rep["nodes"] = comp.node_labels()
    rep["block_roots"] = comp.block_roots()
    return rep


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="trace file, or '-' for stdin")
    ap.add_argument("--format", choices=("table", "json"),
                    default="table", dest="fmt",
                    help="output format (default: table)")
    ap.add_argument("--json", action="store_true",
                    help="alias for --format json")
    ap.add_argument("--kind", action="append", default=None,
                    metavar="K", help="only this stage (repeatable)")
    ap.add_argument("--since-slot", type=int, default=None, metavar="N",
                    help="only traces whose slot-anchored root is at "
                         "slot >= N")
    ap.add_argument("--critpath", action="store_true",
                    help="critical path of the slowest block trace "
                         "instead of the per-stage table")
    args = ap.parse_args(argv)
    try:
        raw = sys.stdin.read() if args.path == "-" else \
            Path(args.path).read_text()
        doc = json.loads(raw)
    except (OSError, json.JSONDecodeError) as e:
        print(f"unreadable trace input: {e}", file=sys.stderr)
        return 2
    doc = filter_doc(doc, args.kind, args.since_slot)
    want_json = args.json or args.fmt == "json"
    if args.critpath:
        rep = critpath_report(doc)
        if rep is None:
            print("no spans in capture", file=sys.stderr)
            return 2
        print(json.dumps(rep, indent=2) if want_json
              else critpath_mod.render_critical_path(
                  rep, "slowest block trace"))
        return 0
    summary = summarize_any(doc)
    print(json.dumps(summary, indent=2)
          if want_json else render_table(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
