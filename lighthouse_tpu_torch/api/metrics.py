"""Prometheus metrics (lighthouse_metrics + http_metrics equivalent).

A global registry with the reference's metric-name conventions; scrape
server on demand.  Uses prometheus_client when present; when it is
absent every helper (including the ``timer``/``start_timer`` hot-path
instrumentation) is a TRUE no-op — no lock, no dict churn, no exception
— so instrumented library code costs nothing on a bare interpreter."""
from __future__ import annotations

import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

try:
    from prometheus_client import (
        CollectorRegistry, Counter, Gauge, Histogram, generate_latest,
    )
    _HAVE_PROM = True
except Exception:  # pragma: no cover
    _HAVE_PROM = False
    Counter = Gauge = Histogram = None

REGISTRY = CollectorRegistry() if _HAVE_PROM else None
_metrics: dict[str, object] = {}
_lock = threading.Lock()


def _get(kind, name: str, help_: str, **kw):
    if not _HAVE_PROM:
        return None
    with _lock:
        m = _metrics.get(name)
        if m is None:
            m = kind(name, help_, registry=REGISTRY, **kw)
            _metrics[name] = m
        return m


def _recorder():
    """graftwatch's slot sampler, when loaded (obs.timeseries mirrors
    every metric touch into its per-slot rings).  Same sys.modules
    hand-off graftscope uses toward this module — no import cycle, and
    a bare interpreter that never imported obs pays one dict probe."""
    ts = sys.modules.get("lighthouse_tpu_torch.obs.timeseries")
    return None if ts is None else ts.record


def inc_counter(name: str, help_: str = "", amount: float = 1) -> None:
    rec = _recorder()
    if rec is not None:
        rec("counter", name, amount)
    if not _HAVE_PROM:
        return
    _get(Counter, name, help_ or name).inc(amount)


def set_gauge(name: str, value: float, help_: str = "",
              labels: dict | None = None) -> None:
    """Set gauge ``name``; with ``labels``, its series of those label
    values (the sampler keeps the last value set, whatever its labels)."""
    rec = _recorder()
    if rec is not None:
        rec("gauge", name, value)
    if not _HAVE_PROM:
        return
    if labels:
        _get(Gauge, name, help_ or name,
             labelnames=sorted(labels)).labels(**labels).set(value)
        return
    _get(Gauge, name, help_ or name).set(value)


def observe(name: str, value: float, help_: str = "") -> None:
    rec = _recorder()
    if rec is not None:
        rec("hist", name, value)
    if not _HAVE_PROM:
        return
    _get(Histogram, name, help_ or name).observe(value)


def counter_value(name: str) -> float:
    """Current value of a registered counter (0.0 when unregistered or
    prometheus is absent).  Scenario assertions read counters through
    this instead of scraping /metrics."""
    if not _HAVE_PROM:
        ts = sys.modules.get("lighthouse_tpu_torch.obs.timeseries")
        return ts.get_sampler().counter_total(name) if ts else 0.0
    m = _metrics.get(name)
    if m is None:
        return 0.0
    return float(m._value.get())


class MetricsServer:
    """/metrics scrape endpoint (beacon_node/http_metrics)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path != "/metrics" or not _HAVE_PROM:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = generate_latest(REGISTRY)
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if getattr(self, "_thread", None) is not None:
            self._thread.join(timeout=2)
            self._thread = None


class timer:
    """Context-manager histogram timer for hot sections, the
    lighthouse_metrics::start_timer equivalent:

        with metrics.timer("beacon_block_processing_seconds"):
            ...

    Also usable as an explicit handle via :func:`start_timer`.  When
    prometheus is absent, enter/exit never reads the clock and never
    touches the registry."""

    __slots__ = ("name", "help_", "_t0")

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help_ = help_
        self._t0: float | None = None

    def __enter__(self):
        if _HAVE_PROM or _recorder() is not None:
            self._t0 = time.perf_counter()
        return self

    def observe_duration(self) -> None:
        """Record the elapsed time since start (once; lighthouse's
        StartedTimer::observe_duration)."""
        if self._t0 is not None:
            observe(self.name, time.perf_counter() - self._t0,
                    self.help_ or self.name)
            self._t0 = None

    stop = observe_duration

    def __exit__(self, *exc):
        self.observe_duration()
        return False


def start_timer(name: str, help_: str = "") -> timer:
    """lighthouse_metrics::start_timer: returns a started handle whose
    ``observe_duration()``/``stop()`` records into the histogram.  A
    dropped handle records nothing (unlike the Rust drop-guard, Python
    finalization is not prompt enough to be a timing primitive)."""
    t = timer(name, help_)
    t.__enter__()
    return t
