"""Roofline accounting of the port's kernel launches.

Every launch wrapper of ``ops/`` (and each sharded program of
``parallel/``) is built with :func:`track_roofline` and a declared
``cost``: the function's work at the call's shapes, on the call's data
where the work depends on it, counted as the kernel table of PERF.md
counts it (``sha256.HASH64_INT_OPS``, ``SHA256_COMPRESS_INT_OPS``,
``bls_cost.*`` field multiplies x ``FP_MUL_INT_OPS``; the affine
conversion's least work, ``bls_cost.affine_least``). The cost is the
function's, not the implementation's, so a kernel's roofline reads the
same work whatever implements it.

For the first :data:`SAMPLE_CALLS` calls of each (kernel, multiply
variant, shapes) the wrapper times the call — CUDA events on the current
stream of the call's card (the stream the kernels launch on), then a
wait on the end event; the host clock for a CPU tensor — and evaluates
the cost. Each record then holds the shapes, its calls, the platform,
the device kind and index, the bytes and integer ops, the device ms, the
least time the device could take (``bound_ms``, ``bound_by``, from
``measure.Bounds`` at the peak of :func:`peak_for`) and
``utilization_of_peak`` = ``bound_ms / ms`` (the best sampled call).
Later calls pass straight through. Inside :func:`capture` every call is
timed and its own record collected (``chip_smoke.py`` reads its bounds
so). What the wrapper never does: catch the wrapped call's exception, or
give way to the plain version. A ``cost`` that raises leaves the record
``cost: "unavailable"``, and nothing else.

No TPU row: the peak table holds the H100 (NVIDIA's data-sheet rates of
``measure.py`` at the card's maximum SM clock, read with ``nvidia-smi``
once a process) and a deliberately generous CPU row, so a CPU run can
never flatter its utilization. A card of another kind is not scored.
"""
from __future__ import annotations

import functools
import statistics
import subprocess
import sys
import threading
import time

#: timed calls per (kernel, variant, shapes); later calls pass through
SAMPLE_CALLS = 3

#: shape signatures recorded per wrapper; calls past them pass through
#: unrecorded (a long-running process meets ever new batch sizes)
MAX_SHAPES = 64

#: nominal peaks a record is scored against, matched case-insensitively
#: against the device kind first, then the platform. The H100 row's
#: integer rate and label are completed at run time (``_h100_peak``).
PEAKS: dict[str, dict] = {
    "h100": {"int_ops_per_sec": None, "bytes_per_sec": None,
             "label": "NVIDIA H100 (data sheet)"},
    "cpu": {"int_ops_per_sec": 200e9, "bytes_per_sec": 50e9,
            "label": "CPU (nominal AVX2 envelope)"},
}

_lock = threading.Lock()
_REGISTRY: dict[str, list] = {}
_local = threading.local()
_h100: dict | None = None


def _metrics():
    return sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")


def _h100_peak() -> dict | None:
    """The H100 row at this card's maximum SM clock, labelled with the
    card's name and power limit (``nvidia-smi``); None when that cannot
    be read. Asked once a process."""
    global _h100
    if _h100 is None:
        from .. import measure
        try:
            clock = float(measure.nvidia_smi("clocks.max.sm").split()[0])
            card = measure.nvidia_smi("name,power.limit")
        except (OSError, ValueError, IndexError,
                subprocess.SubprocessError):
            _h100 = {}
        else:
            _h100 = {
                "int_ops_per_sec": (measure.SMS * measure.INT32_LANES_PER_SM
                                    * clock * 1e6),
                "bytes_per_sec": measure.HBM_BYTES_PER_S,
                "label": f"{card} (HBM {measure.HBM_BYTES_PER_S / 1e12:g} "
                         f"TB/s, INT32 {measure.SMS} SMs x "
                         f"{measure.INT32_LANES_PER_SM} lanes x "
                         f"{clock:.0f} MHz)"}
    return _h100 or None


def peak_for(platform: str, device_kind: str = "") -> dict | None:
    """The peak row a record on ``platform`` / ``device_kind`` is scored
    against, or None (a card of a kind the table lacks)."""
    for key in ((device_kind or "").lower(), (platform or "").lower()):
        for match, peak in PEAKS.items():
            if key and match in key:
                if match == "h100":
                    row = _h100_peak()
                    return None if row is None else dict(row, match=match)
                return dict(peak, match=match)
    return None


def _bound(peak: dict, n_bytes, n_ops, link_bytes=0):
    from ..measure import Bounds
    return Bounds(int_ops_per_s=peak["int_ops_per_sec"],
                  bytes_per_s=peak["bytes_per_sec"])(n_bytes, n_ops,
                                                     link_bytes)


def _sig(a):
    """Hashable signature of one argument: a tensor's or array's shape,
    dtype (and device), a sequence's members, a scalar's value."""
    shape = getattr(a, "shape", None)
    if shape is not None and hasattr(a, "dtype"):
        dev = getattr(a, "device", None)
        return ("t", tuple(shape), str(a.dtype), str(dev))
    if isinstance(a, (list, tuple)):
        return ("s", tuple(_sig(x) for x in a))
    if a is None or isinstance(a, (bool, int, float, str)):
        return ("v", a)
    return ("o", type(a).__name__)


def _label(args) -> str:
    parts = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None and hasattr(a, "dtype"):
            dt = str(a.dtype).replace("torch.", "")
            parts.append(f"{dt}[{','.join(str(s) for s in shape)}]")
        elif isinstance(a, (list, tuple)):
            parts.append(f"[{_label(a)}]")
        elif a is None:
            parts.append("None")
        elif isinstance(a, (bool, int)) and a.bit_length() <= 32:
            parts.append(str(a))
        else:
            parts.append(type(a).__name__)
    return ",".join(parts)


def _device(args):
    """The torch device of the call's first tensor (searched through
    sequences), or None."""
    for a in args:
        dev = getattr(a, "device", None)
        if dev is not None and hasattr(a, "data_ptr"):
            return dev
        if isinstance(a, (list, tuple)):
            dev = _device(a)
            if dev is not None:
                return dev
    return None


def tensor_bytes(*values) -> int:
    """Bytes of the tensors among ``values`` (through tuples and lists):
    the declared cost's bytes where a kernel reads each input tensor once
    and writes each output once."""
    total = 0
    for v in values:
        if isinstance(v, (list, tuple)):
            total += tensor_bytes(*v)
        elif hasattr(v, "element_size") and hasattr(v, "numel"):
            total += v.numel() * v.element_size()
    return total


class _Record:
    """One (variant, shapes) of a tracked wrapper."""

    __slots__ = ("kernel", "variant", "shapes", "calls", "samples",
                 "platform", "device_kind", "device")

    def __init__(self, kernel, variant, shapes, platform, kind, index):
        self.kernel = kernel
        self.variant = variant
        self.shapes = shapes
        self.calls = 0
        self.samples: list[dict] = []
        self.platform = platform
        self.device_kind = kind
        self.device = index

    def record(self) -> dict:
        out: dict = {"kernel": self.kernel, "variant": self.variant,
                     "shapes": self.shapes, "calls": self.calls,
                     "timed_calls": len(self.samples),
                     "platform": self.platform,
                     "device_kind": self.device_kind, "device": self.device}
        costed = [s for s in self.samples if "ops" in s]
        if self.samples and not costed:
            out["cost"] = "unavailable"
        if not costed:
            return out
        best = max(costed, key=lambda s: s.get("utilization_of_peak") or 0)
        out.update({k: v for k, v in best.items() if k != "shapes"})
        out["ms_all"] = [s["ms"] for s in self.samples]
        out["ms_median"] = statistics.median(out["ms_all"])
        return out


def _where(args) -> tuple[str, str, int | None]:
    """(platform, device kind, card index) of a call, from its first
    tensor: ``cuda`` and the card's name, or ``cpu``."""
    dev = _device(args)
    if dev is not None and dev.type == "cuda":
        import torch
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        return "cuda", torch.cuda.get_device_name(index), index
    import platform
    return "cpu", platform.processor() or platform.machine() or "cpu", None


class Tracked:
    """A launch wrapper with roofline accounting (see the module
    docstring); calls ``fn`` and returns what it returns."""

    def __init__(self, name: str, fn, cost):
        functools.update_wrapper(self, fn)
        self.name = name
        self.cost = cost
        self._fn = fn
        self._records: dict = {}
        self._lock = threading.Lock()

    def _variant(self) -> str:
        """The kernel's variant for the current multiply lowering
        (``fp_ops_mxu1``), or the name itself."""
        kernels = sys.modules.get("lighthouse_tpu_torch.kernels")
        k = None if kernels is None else kernels.KERNELS.get(self.name)
        return self.name if k is None else k.current().name

    def __call__(self, *args, **kwargs):
        variant = self._variant()
        key = (variant, tuple(_sig(a) for a in args),
               tuple(sorted((k, _sig(v)) for k, v in kwargs.items())))
        rec = self._records.get(key)
        sink = getattr(_local, "sink", None)
        if sink is None and (len(rec.samples) >= SAMPLE_CALLS
                             if rec is not None
                             else len(self._records) >= MAX_SHAPES):
            if rec is not None:
                rec.calls += 1
            return self._fn(*args, **kwargs)
        where = _where(args)
        out, ms = self._timed(args, kwargs, where[0])
        sample = self._sample(out, ms, where, args, kwargs)
        with self._lock:
            rec = self._records.get(key)
            if rec is None and len(self._records) < MAX_SHAPES:
                rec = self._records[key] = _Record(
                    self.name, variant, sample["shapes"], *where)
            if rec is not None:
                rec.calls += 1
                rec.samples.append(sample)
        if sink is not None:
            sink.append(dict(sample, kernel=self.name, variant=variant))
        util = sample.get("utilization_of_peak")
        md = _metrics()
        if md is not None and util is not None:
            md.gauge("roofline_utilization_ratio", float(util),
                     kernel=variant)
        return out

    def _timed(self, args, kwargs, platform: str):
        """(the call's result, its ms): CUDA events on the current stream
        of the call's card around it, then a wait on the end event; the
        host clock for a CPU call."""
        if platform == "cuda":
            import torch
            stream = torch.cuda.current_stream(_device(args))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = self._fn(*args, **kwargs)
            end.record(stream)
            end.synchronize()
            return out, start.elapsed_time(end)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        return out, (time.perf_counter() - t0) * 1e3

    def _sample(self, out, ms, where, args, kwargs) -> dict:
        sample: dict = {"ms": ms, "shapes": _label(args),
                        "platform": where[0]}
        try:
            work = self.cost(out, *args, **kwargs)
        except Exception:     # a broken count never fails the call
            return sample
        n_bytes, n_ops = work[0], work[1]
        extra = dict(work[2]) if len(work) > 2 else {}
        sample.update(bytes=int(n_bytes), ops=int(n_ops), **extra)
        peak = peak_for(where[0], where[1])
        if peak is not None:
            bound_ms, bound_by = _bound(peak, n_bytes, n_ops,
                                        extra.get("link_bytes", 0))
            sample.update(peak=peak["label"], bound_ms=bound_ms,
                          bound_by=bound_by,
                          utilization_of_peak=(bound_ms / ms if ms > 0
                                               else None))
        return sample

    def records(self) -> list[dict]:
        with self._lock:
            recs = list(self._records.values())
        return [r.record() for r in recs]


def track_roofline(name: str, fn, cost) -> Tracked:
    """Wrap ``fn`` (a launch wrapper) with roofline accounting under
    ``name`` (a kernel of ``kernels.KERNELS``, whose multiply variant the
    records then carry, or a program name). ``cost(out, *args,
    **kwargs)`` -> ``(n_bytes, n_int_ops)`` or ``(n_bytes, n_int_ops,
    extra)``: the function's work for this call given its result; an
    ``extra`` dict goes into the record (``link_bytes`` adds the bytes a
    collective brings in from the other cards to the bound)."""
    t = Tracked(name, fn, cost)
    with _lock:
        _REGISTRY.setdefault(name, []).append(t)
    return t


def tracked(name: str, cost):
    """Decorator form of :func:`track_roofline`."""
    return lambda fn: track_roofline(name, fn, cost)


class capture:
    """Time every tracked call made inside the block, whatever its
    sample count, and collect each call's own record (bytes, ops,
    ``bound_ms``, ``bound_by``, ``ms``, ``kernel``, ``variant``) in the
    list the block gets, in the order the calls returned."""

    def __enter__(self) -> list:
        self._prev = getattr(_local, "sink", None)
        _local.sink = []
        return _local.sink

    def __exit__(self, *exc):
        _local.sink = self._prev
        return False


def snapshot() -> dict:
    """{kernel or program name: [per-(variant, shapes) records]} over
    every tracked wrapper."""
    with _lock:
        wrappers = {k: list(v) for k, v in _REGISTRY.items()}
    out: dict = {}
    for name, ts in wrappers.items():
        recs = [r for t in ts for r in t.records()]
        if recs:
            out[name] = recs
    return out


def reset() -> None:
    """Forget every record (the wrappers stay registered)."""
    with _lock:
        wrappers = [t for ts in _REGISTRY.values() for t in ts]
    for t in wrappers:
        with t._lock:
            t._records.clear()
