"""graftscope + graftwatch of the port — tracing, accounting, SLOs,
flight dumps (the JAX package's L9 observability layer, on the card).

The JAX package's exports, with ``cuda_accounting`` (nvcc builds, the
``_build/`` cache, host<->device bytes) in the place of
``jax_accounting``; ``device`` is the CUDA memory ledger and ``roofline``
scores each kernel launch against the card's peak. Everything here is
stdlib+numpy at import time: torch is touched only at call time.
"""
from .cuda_accounting import (
    account_transfer, host_readback, snapshot as cuda_counters,
)
from .capture import ScenarioTrace, scenario_capture
from .report import render_table, summarize_chrome, summarize_spans
from .tracing import (
    SPAN_KINDS, Span, annotate, attach, capture, capture_scope,
    chrome_trace, clear, current_context, current_span, set_slot_clock,
    snapshot, span,
)
from . import (
    causal, critpath, cuda_accounting, device, flight, graftwatch,
    occupancy, roofline, slo, timeseries,
)

__all__ = [
    "SPAN_KINDS", "Span", "annotate", "attach", "capture",
    "capture_scope", "chrome_trace",
    "clear", "current_context", "current_span", "set_slot_clock",
    "snapshot", "span", "ScenarioTrace", "scenario_capture",
    "account_transfer", "host_readback", "cuda_counters",
    "render_table", "summarize_chrome", "summarize_spans",
    "causal", "critpath", "cuda_accounting", "device", "flight",
    "graftwatch", "occupancy", "roofline", "slo", "timeseries",
]
