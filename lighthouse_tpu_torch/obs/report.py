"""Per-stage latency summaries over traces.

Shared by the HTTP debug endpoint (``/lighthouse/tracing/summary``) and
the ``tools/trace/report.py`` CLI: group spans (or Chrome trace events)
by stage name and reduce to count / p50 / p95 / max / total.
"""
from __future__ import annotations


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def summarize_durations(by_stage: dict[str, list[float]]) -> dict:
    """stage -> {count, p50_ms, p95_ms, max_ms, total_ms} (input seconds)."""
    out = {}
    for stage, durs in sorted(by_stage.items()):
        vals = sorted(d * 1e3 for d in durs)
        out[stage] = {
            "count": len(vals),
            "p50_ms": round(_percentile(vals, 0.50), 3),
            "p95_ms": round(_percentile(vals, 0.95), 3),
            "max_ms": round(vals[-1] if vals else 0.0, 3),
            "total_ms": round(sum(vals), 3),
        }
    return out


def summarize_spans(spans) -> dict:
    by_stage: dict[str, list[float]] = {}
    for s in spans:
        by_stage.setdefault(s.kind, []).append(s.duration)
    return summarize_durations(by_stage)


def summarize_chrome(doc: dict) -> dict:
    """Summary from a Chrome trace-event document ('X' complete events;
    ts/dur are microseconds)."""
    by_stage: dict[str, list[float]] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        by_stage.setdefault(ev.get("name", "?"), []).append(
            float(ev.get("dur", 0.0)) / 1e6)
    return summarize_durations(by_stage)


def render_table(summary: dict) -> str:
    """Fixed-width text table, widest-total stages first."""
    header = f"{'stage':<22} {'count':>7} {'p50 ms':>10} " \
             f"{'p95 ms':>10} {'max ms':>10} {'total ms':>11}"
    lines = [header, "-" * len(header)]
    for stage, row in sorted(summary.items(),
                             key=lambda kv: -kv[1]["total_ms"]):
        lines.append(f"{stage:<22} {row['count']:>7} {row['p50_ms']:>10.3f} "
                     f"{row['p95_ms']:>10.3f} {row['max_ms']:>10.3f} "
                     f"{row['total_ms']:>11.3f}")
    return "\n".join(lines)
