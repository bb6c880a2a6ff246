"""Device memory ledger of the port: the cards' memory, who holds it,
and the high-water marks of device sections.

A per-card snapshot (platform, card count and kind, the caching
allocator's bytes in use and peak, the card's total, and what every
process on the card uses, host RSS + CoW chunk accounting) sampled once
per slot into the graftwatch rings, an attribution registry tagging
tensors by owning subsystem, and an :func:`hbm_watermark` scope that
stamps the memory high-water delta of a device section onto the
enclosing graftscope span.

Each card's row: ``bytes_in_use`` (``torch.cuda.memory_allocated``),
``peak_bytes_in_use`` (``max_memory_allocated``), ``reserved``
(``memory_reserved``: the allocator's cached blocks), ``bytes_limit``
(the card's total, ``mem_get_info``) and ``used_by_all`` (that total less
the free memory ``mem_get_info`` reports): memory the kernels' C entries,
NCCL or other processes take outside torch's allocator still shows
there.

Honesty contract: the ledger never starts a backend. Where CUDA is not
initialised in this process (``torch.cuda.is_initialized()`` false, and
always on the CPU) every surface says ``"unavailable"`` instead of
guessing, and the ``hbm_headroom`` SLO reads as unevaluable-not-breached.
torch is looked at only through ``sys.modules``: a process that never
imported it pays nothing for a ledger read.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import weakref

#: marker used wherever a device stat cannot be read on this platform
UNAVAILABLE = "unavailable"


def _cuda():
    """``torch.cuda`` when torch is imported and CUDA is initialised in
    this process, else None. The ledger never initialises CUDA itself."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        return torch.cuda if torch.cuda.is_initialized() else None
    except (AttributeError, RuntimeError):
        return None


def _cow_stats() -> dict | None:
    cow = sys.modules.get("lighthouse_tpu_torch.containers.cow")
    if cow is None:
        return None
    return dict(cow.STATS)


def _metrics():
    return sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")


# -- device memory -------------------------------------------------------------


def device_memory_stats() -> list[dict] | None:
    """A row per card this process uses (its current card, and any card
    its allocator holds memory on; see the module docstring), or None
    where CUDA is not initialised in this process. Another card is left
    out: asking it for its free memory would open a context there (an
    NCCL rank holds one card of several)."""
    cuda = _cuda()
    if cuda is None:
        return None
    rows = []
    current = cuda.current_device()
    for i in range(cuda.device_count()):
        if i != current and not cuda.memory_reserved(i):
            continue
        free, total = cuda.mem_get_info(i)
        rows.append({
            "id": i,
            "kind": cuda.get_device_name(i),
            "bytes_in_use": int(cuda.memory_allocated(i)),
            "peak_bytes_in_use": int(cuda.max_memory_allocated(i)),
            "reserved": int(cuda.memory_reserved(i)),
            "bytes_limit": int(total),
            "used_by_all": int(total - free),
        })
    return rows or None


def hbm_bytes() -> tuple[int, int] | None:
    """(total bytes_in_use, total bytes_limit) across cards, or None
    where CUDA is not initialised.  Tests monkeypatch this to drive
    deterministic watermark/SLO scenarios."""
    rows = device_memory_stats()
    if not rows:
        return None
    return (sum(r["bytes_in_use"] for r in rows),
            sum(r["bytes_limit"] for r in rows))


# -- the ledger snapshot ------------------------------------------------------


def ledger_snapshot() -> dict:
    """One JSON-ready per-card + host memory snapshot.

    ``platform``/``chip_count``/``device_kind`` come from CUDA when it is
    initialised in this process; ``hbm`` is the per-card rows or the
    explicit ``"unavailable"`` marker — never a silent omission."""
    out: dict = {"platform": UNAVAILABLE, "device_kind": UNAVAILABLE,
                 "chip_count": 0, "hbm": UNAVAILABLE}
    rows = device_memory_stats()
    if rows:
        out["platform"] = "cuda"
        out["chip_count"] = len(rows)
        out["device_kind"] = rows[0]["kind"]
        out["hbm"] = rows
    host: dict = {}
    try:
        import resource
        host["rss_bytes"] = (resource.getrusage(resource.RUSAGE_SELF)
                             .ru_maxrss * 1024)
    except ImportError:  # pragma: no cover - resource is POSIX-only
        host["rss_bytes"] = None
    cow = _cow_stats()
    if cow is not None:
        host["cow"] = cow
    out["host"] = host
    out["attribution"] = attributed_bytes()
    return out


# -- attribution registry -----------------------------------------------------

_attr_lock = threading.Lock()
#: (owner, label) -> list of (weakref-or-None, nbytes); the weakref lets
#: the registry report LIVE bytes, the nbytes snapshot keeps the record
#: meaningful for objects that refuse weak references
_attr: dict[tuple[str, str], list] = {}
#: (owner, label) -> peak concurrent bytes ever attributed
_attr_peak: dict[tuple[str, str], int] = {}


def _nbytes(t) -> int:
    """A tensor's storage bytes (``untyped_storage().nbytes()``), else
    ``nbytes``."""
    storage = getattr(t, "untyped_storage", None)
    if storage is not None:
        return int(storage().nbytes())
    return int(getattr(t, "nbytes", 0) or 0)


def attribute(owner: str, label: str, *tensors) -> None:
    """Tag tensors as owned by ``owner`` (a subsystem name, e.g.
    ``parallel.bls``).  Liveness is tracked by weakref, so
    ``attributed_bytes`` reports what is still resident, not what was
    ever allocated."""
    key = (owner, label)
    with _attr_lock:
        entries = _attr.setdefault(key, [])
        # drop dead entries so repeated tagging never grows unbounded
        entries[:] = [e for e in entries
                      if e[0] is None or e[0]() is not None]
        for t in tensors:
            try:
                ref = weakref.ref(t)
            except TypeError:
                ref = None
            entries.append((ref, _nbytes(t)))
        live = sum(e[1] for e in entries
                   if e[0] is None or e[0]() is not None)
        if live > _attr_peak.get(key, 0):
            _attr_peak[key] = live


def attributed_bytes() -> dict:
    """{owner: {label: {"live_bytes", "peak_bytes"}}} over the registry."""
    out: dict = {}
    with _attr_lock:
        for (owner, label), entries in _attr.items():
            live = sum(e[1] for e in entries
                       if e[0] is None or e[0]() is not None)
            out.setdefault(owner, {})[label] = {
                "live_bytes": live,
                "peak_bytes": _attr_peak.get((owner, label), live),
            }
    return out


def reset_attribution() -> None:
    with _attr_lock:
        _attr.clear()
        _attr_peak.clear()


# -- span watermarks ----------------------------------------------------------


class hbm_watermark:
    """Context manager stamping the device memory delta of a device
    section onto the enclosing graftscope span (``parallel/`` wraps its
    sharded pipelines in one).  Where the stats are unavailable the span
    is annotated ``hbm_delta_bytes="unavailable"`` — the absence is
    recorded, not skipped."""

    def __init__(self, owner: str):
        self.owner = owner
        self.delta_bytes: int | str = UNAVAILABLE
        self._before: tuple[int, int] | None = None

    def __enter__(self):
        self._before = hbm_bytes()
        return self

    def __exit__(self, *exc):
        from . import tracing
        after = hbm_bytes()
        if self._before is None or after is None:
            tracing.annotate(hbm_owner=self.owner,
                             hbm_delta_bytes=UNAVAILABLE)
            return False
        self.delta_bytes = after[0] - self._before[0]
        tracing.annotate(hbm_owner=self.owner,
                         hbm_delta_bytes=int(self.delta_bytes),
                         hbm_bytes_in_use=int(after[0]))
        return False


# -- the per-slot publish (graftwatch tick) -----------------------------------


def publish() -> None:
    """Feed the device + host gauges once per slot (called from
    ``graftwatch.on_slot`` right after ``occupancy.publish``).  Cheap:
    one /proc read, one getrusage, and — only when CUDA is initialised —
    one pass over the cards' allocator counters.  Never raises."""
    md = _metrics()
    if md is None:  # metrics layer not loaded: nothing to feed
        return
    try:
        stats = hbm_bytes()
        if stats is not None:
            md.gauge("device_hbm_bytes_in_use", float(stats[0]))
            md.gauge("device_hbm_bytes_limit", float(stats[1]))
        # host-memory trajectory in the rings, not just on-demand
        # snapshots
        from ..utils import system_health
        system_health.sample_gauges()
    except Exception:  # pragma: no cover - never kill the slot task
        pass


# -- flight-dump section ------------------------------------------------------


def flight_section() -> dict:
    """``doc["device"]`` for the flight recorder: the ledger snapshot
    plus the roofline records and the kernel-library cache's hits and
    misses.  Never raises."""
    try:
        out = ledger_snapshot()
    except Exception as exc:  # pragma: no cover - never block a dump
        return {"error": repr(exc)}
    try:
        from . import roofline
        out["roofline"] = roofline.snapshot()
    except Exception as exc:  # pragma: no cover
        out["roofline"] = {"error": repr(exc)}
    try:
        from . import cuda_accounting
        counters = cuda_accounting.snapshot()
        out["compile_cache"] = {
            "hits": counters.get("cache_hits", 0),
            "misses": counters.get("cache_misses", 0),
        }
    except Exception as exc:  # pragma: no cover
        out["compile_cache"] = {"error": repr(exc)}
    return out


# -- staged device-health probe -----------------------------------------------

_PROBE_STAGES = [("import", "import torch"),
                 ("devices",
                  "import torch; torch.cuda.init(); "
                  "print(torch.cuda.device_count())")]


def staged_probe(timeout: int = 90, env: dict | None = None,
                 cwd: str | None = None) -> dict:
    """Staged device-acquisition probe: how far does torch get on this
    host — importing, then initialising CUDA and counting the cards?
    Each stage is its own subprocess with a hard timeout, so a wedged
    driver can't hang the caller — the record says exactly which stage
    died and how long it took."""
    stage_env = dict(os.environ if env is None else env)
    out: dict = {"timeout_s": timeout}
    stage_reached = None
    stages = {}
    for stage, code in _PROBE_STAGES:
        stage_reached = stage
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-c", code], env=stage_env, cwd=cwd,
                capture_output=True, text=True, timeout=timeout)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            rc = None
        wall = round(time.perf_counter() - t0, 2)
        stages[stage] = {"wall_s": wall, "rc": rc}
        if rc != 0:
            break
    out["default"] = {"stage_reached": stage_reached, "stages": stages}
    return out
