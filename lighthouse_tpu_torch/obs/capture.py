"""Scenario-scoped trace capture.

The adversarial scenarios (testing/scenarios.py) assert on graftscope
output — p95 pipeline latency, span counts, queue behavior — not just on
end-state liveness.  ``scenario_capture()`` brackets a scenario run in a
:class:`tracing.capture_scope`, so envelopes see exactly the spans that
belong to the bracket: setup traffic (genesis import, initial dials)
started before the scope opened is excluded, and a *concurrent* capture
(or explicitly-scoped background work) no longer bleeds in — spans are
selected by scope membership, not by wall-clock overlap, which is what
the old ``start >= t0`` filter got wrong.
"""
from __future__ import annotations

from contextlib import contextmanager

from . import tracing
from .report import render_table, summarize_spans


class ScenarioTrace:
    """Spans captured during one scenario window, with the accessors the
    degradation-envelope assertions use."""

    def __init__(self, spans: list):
        self.spans = spans
        self.summary = summarize_spans(spans)

    def count(self, kind: str) -> int:
        row = self.summary.get(kind)
        return int(row["count"]) if row else 0

    def p95_ms(self, kind: str) -> float:
        row = self.summary.get(kind)
        return float(row["p95_ms"]) if row else 0.0

    def max_ms(self, kind: str) -> float:
        row = self.summary.get(kind)
        return float(row["max_ms"]) if row else 0.0

    def table(self) -> str:
        return render_table(self.summary)


@contextmanager
def scenario_capture():
    """Yield a ScenarioTrace that is filled in when the block exits.

        with scenario_capture() as trace:
            ...drive the scenario...
        assert trace.p95_ms("block_pipeline") < 1500

    The global ring buffer is not cleared — other captures (and the
    /lighthouse/tracing endpoint) keep seeing the same spans; selection
    is by capture-scope membership (``tracing.capture_scope``), so
    concurrent captures stay disjoint except for genuinely shared
    infrastructure traffic, which every live capture sees."""
    trace = ScenarioTrace([])
    with tracing.capture_scope() as scope:
        try:
            yield trace
        finally:
            spans = [s for s in tracing.snapshot()
                     if scope.id in s.scopes]
            trace.spans = spans
            trace.summary = summarize_spans(spans)
