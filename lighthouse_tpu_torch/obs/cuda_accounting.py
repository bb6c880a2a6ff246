"""CUDA runtime accounting: kernel builds and host<->device bytes.

The port's counterpart of the JAX package's ``obs/jax_accounting.py``.
Where JAX compiles XLA programs at run time and keeps a persistent
compile cache, the port builds each kernel library once with ``nvcc``
into ``_build/`` (``kernels.build_all``) and binds it with ``ctypes``.
So this module counts:

- the build accounting of ``kernels.build_all``: a library found built in
  ``_build/`` is a cache hit; a library ``nvcc`` had to build is a miss
  and a build, with its seconds (the port's "compile"); each build's
  ``-Xptxas -v`` report (registers, stack, spills a kernel entry); the
  libraries bound in this process;
- :func:`account_transfer`, an explicit host<->device copy
  (``parallel.mesh.shard_batch`` routes through it), and
  :func:`host_readback`, the accounted device->host read
  (``parallel.bls``'s validity gates);
- :func:`snapshot`, the counters the flight recorder dumps under
  ``cuda``;
- from the first library bound, the process's kernel launches
  (``kernels.launch_counts``): on ``/metrics`` as the counter
  ``kernel_launches_total`` (label ``kernel``), read at each scrape, and,
  where ``LHTPU_LAUNCH_COUNTS`` names a file, written there as JSON when
  the process exits (a command-line process that serves no metrics).

The JAX package's ``TrackedJit`` and ``install_monitoring`` have no
counterpart: PyTorch runs eagerly, so nothing recompiles behind a call,
and there is no runtime event stream to listen to. A kernel is built
once, up front or at its first launch, and that build is counted here.

Import-light: nothing here imports torch, and the metrics feed goes
through ``sys.modules`` like ``tracing._observe_metric``.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import sys
import threading

_lock = threading.Lock()
_counters = {
    "builds": 0,
    "build_seconds": 0.0,
    "cache_hits": 0,
    "cache_misses": 0,
    "libraries_loaded": 0,
    "h2d_bytes": 0,
    "d2h_bytes": 0,
}
#: build key (source, and the lowering past mode 0) -> the last build of
#: it in this process: its library, seconds and ptxas report
_builds: dict[str, dict] = {}
_bound: set = set()


def _metrics():
    return sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")


def snapshot() -> dict:
    """Copy of the process-local counters, with ``libraries``: each
    library built in this process, its seconds and its kernel entries'
    registers, stack and spills."""
    with _lock:
        out = dict(_counters)
        out["libraries"] = {k: dict(v) for k, v in _builds.items()}
    return out


def ptxas_summary(log: str) -> list[dict]:
    """The kernel entries of one ``nvcc -Xptxas -v`` report: each entry's
    registers, stack frame and spill stores / loads."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m and "stack" not in cur:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(m.group(1)), int(m.group(2)), int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and "registers" not in cur:
            cur["registers"] = int(m.group(1))
    return rows


def record_hit(key: str) -> None:
    """A library ``build_all`` found already built in ``_build/``."""
    with _lock:
        _counters["cache_hits"] += 1
    md = _metrics()
    if md is not None:
        md.count("kernel_build_cache_hits_total", 1)


def record_build(key: str, library: str, seconds: float, log: str) -> None:
    """A library ``nvcc`` had to build: a cache miss, a build and its
    seconds, and its ptxas report."""
    with _lock:
        _counters["cache_misses"] += 1
        _counters["builds"] += 1
        _counters["build_seconds"] += seconds
        _builds[key] = {"library": library, "seconds": seconds,
                        "entries": ptxas_summary(log)}
    md = _metrics()
    if md is not None:
        md.count("kernel_build_cache_misses_total", 1)
        md.count("kernel_build_total", 1)
        md.count("kernel_build_seconds_total", seconds)
    from . import tracing
    tracing.annotate(kernel_built=key)


def record_bound(library: str) -> None:
    """A library bound with ``ctypes`` (each file counts once); the first
    exposes the process's launch counts (``expose_launches``)."""
    with _lock:
        if library in _bound:
            return
        _bound.add(library)
        _counters["libraries_loaded"] = len(_bound)
        n = len(_bound)
    if n == 1:
        expose_launches()
    md = _metrics()
    if md is not None:
        md.gauge("kernel_libraries_loaded", n)


class _LaunchCollector:
    """``kernel_launches_total{kernel=...}``: ``kernels.launch_counts()``
    as it stands at the scrape."""

    def collect(self):
        from prometheus_client.core import CounterMetricFamily

        from .. import kernels
        fam = CounterMetricFamily(
            "kernel_launches", "CUDA kernel launches in this process, by "
            "kernel (a multiply variant under its own name)",
            labels=["kernel"])
        for name, count in kernels.launch_counts().items():
            fam.add_metric([name], count)
        yield fam


_exposed = False


def expose_launches() -> None:
    """Once a process: the launch counts on the metrics registry, where
    the process has loaded ``api.metrics`` (a node has, before its first
    launch) and prometheus_client is installed; and, where
    ``LHTPU_LAUNCH_COUNTS`` names a file, their JSON written there at the
    process's exit."""
    global _exposed
    with _lock:
        if _exposed:
            return
        _exposed = True
    metrics = sys.modules.get("lighthouse_tpu_torch.api.metrics")
    if metrics is not None and metrics.REGISTRY is not None:
        metrics.REGISTRY.register(_LaunchCollector())
    path = os.environ.get("LHTPU_LAUNCH_COUNTS")
    if path:
        atexit.register(_write_launches, path)


def _write_launches(path: str) -> None:
    from .. import kernels
    with open(path, "w") as f:
        json.dump(kernels.launch_counts(), f)


def account_transfer(nbytes: int, direction: str = "h2d") -> None:
    """Record an accounted host<->device transfer of ``nbytes``."""
    key = "d2h_bytes" if direction == "d2h" else "h2d_bytes"
    nbytes = int(nbytes or 0)
    with _lock:
        _counters[key] += nbytes
    md = _metrics()
    if md is not None:
        md.count("device_transfer_device_to_host_bytes_total" if key ==
                 "d2h_bytes" else "device_transfer_host_to_device_bytes_total",
                 nbytes)


def host_readback(t):
    """Accounted device->host read: ``t.cpu()`` with its bytes counted."""
    account_transfer(t.numel() * t.element_size(), "d2h")
    return t.cpu()
