"""graftwatch flight recorder — preserve telemetry at breach time.

The Security Review of Ethereum Beacon Clients (PAPERS.md) observes
that client incidents get diagnosed from whatever telemetry happened to
be retained when things went wrong.  The flight recorder makes that
deliberate: on incident-open (when auto-dump is enabled), on an API
request, or on SIGUSR2 it atomically writes one versioned JSON document
bundling everything the doctor (``python -m lighthouse_tpu_torch.obs.doctor``)
needs to correlate a breach offline:

- the recent span ring as a Perfetto-loadable Chrome trace
- the critical path of the window's worst block trace (obs/critpath.py,
  stitched cross-node when the ring holds an in-process fleet)
- the full graftwatch time-series window
- ``cuda_accounting.snapshot()`` under ``cuda`` (nvcc builds, their
  seconds, the ``_build/`` cache hits and misses, libraries bound, each
  library's registers and spills, host<->device transfer bytes)
- the device ledger (``obs/device.flight_section``: platform, the cards'
  memory rows or an explicit ``unavailable``, subsystem attribution,
  roofline records, the kernel-library cache's hit/miss counts)
- beacon-processor queue depths / drop / high-water counts
- a fork-choice head summary per registered chain
- a sync summary per chain (state, in-flight request deadlines, peer
  backoff/quarantine, recent download-validation rejects)
- a serving-tier summary per registered API tier (queue depth, cache
  hit ratio, shed counts, slowest endpoints)
- a graftflow replay summary per registered engine (stage queue
  depths, epoch commit seq, per-stage occupancy)
- the trace-stamped ``log_buffer`` tail
- every incident (open and resolved) plus current SLO status
- the last store-recovery report (``chain.persistence.LAST_RECOVERY``),
  so post-restart incidents can be read against what boot repaired

Writes are tmp-file + ``os.replace`` so a reader never sees a torn
dump.  ``FORMAT_VERSION`` gates the doctor's parser.
"""
from __future__ import annotations

import json
import math
import os
import signal
import sys
import tempfile
import threading

from . import cuda_accounting, device, tracing
from ..utils.log_buffer import global_log_buffer

FORMAT_VERSION = 1

#: log_buffer lines preserved in a dump
LOG_TAIL = 200


def _json_safe(obj):
    """NaN/Inf -> None, bytes -> hex, sets -> lists (strict-JSON dump)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, (bytes, bytearray)):
        return obj.hex()
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    return repr(obj)


def _critpath_summary() -> dict | None:
    """Critical path of the worst block trace in the span ring — the
    incident window's 'what did the latency wait on' answer, stitched
    across nodes when the ring holds a whole in-process fleet
    (graftpath).  None when the ring has no spans."""
    from . import critpath
    try:
        spans = tracing.snapshot()
        comp = critpath.worst_component(spans)
        if comp is None:
            return None
        rep = critpath.component_report(comp)
        if not rep["segments"]:
            return None
        rep["nodes"] = comp.node_labels()
        rep["block_roots"] = comp.block_roots()
        return rep
    except Exception as exc:  # pragma: no cover - never block a dump
        return {"error": repr(exc)}


def _recovery_report():
    """Last `resume_chain` report, when the process ever resumed.

    Looked up lazily through sys.modules so the recorder never imports
    the chain package itself (dumps work from store-less test rigs)."""
    persistence = sys.modules.get("lighthouse_tpu_torch.chain.persistence")
    if persistence is None:
        return None
    try:
        return persistence.last_recovery_report()
    except Exception:  # pragma: no cover - best effort
        return None


def _chain_summary(chain) -> dict:
    out: dict = {}
    try:
        head = chain.head()
        out["head_root"] = head.head_block_root.hex()
        out["head_slot"] = int(head.head_state.slot)
        out["clock_slot"] = int(chain.slot())
        out["finalized_epoch"] = int(chain.fork_choice
                                     .finalized_checkpoint[0])
        out["justified_epoch"] = int(chain.fork_choice
                                     .justified_checkpoint[0])
        out["proto_nodes"] = len(getattr(chain.fork_choice.proto_array,
                                         "nodes", ()))
        out["validators"] = int(len(head.head_state.validators))
    except Exception as exc:  # a half-shutdown chain must not block dumps
        out["error"] = repr(exc)
    return out


def _sync_summary(chain) -> dict | None:
    """SyncManager snapshot for one chain: state, in-flight requests
    with their deadlines, per-peer backoff/quarantine, recent
    validation rejects.  None when the chain has no network service
    (store-less rigs, unit-test stubs) — the doctor treats a missing
    section as 'not recorded'."""
    try:
        sync = getattr(getattr(chain, "network_service", None), "sync",
                       None)
        if sync is None:
            return None
        return sync.snapshot()
    except Exception as exc:
        return {"error": repr(exc)}


def _serving_summary(tier) -> dict:
    try:
        return tier.snapshot()
    except Exception as exc:
        return {"error": repr(exc)}


def _replay_summary(engine) -> dict:
    """graftflow engine snapshot: stage queue depths / high-water,
    per-stage busy seconds, epoch commit sequence, last-segment
    occupancy."""
    try:
        return engine.snapshot()
    except Exception as exc:
        return {"error": repr(exc)}


def _processor_summary(proc) -> dict:
    out: dict = {}
    try:
        out["queues"] = {getattr(kind, "name", str(kind)): len(q)
                         for kind, q in proc.queues.items()}
        out["dropped"] = int(getattr(proc, "dropped", 0))
        out["processed"] = int(getattr(proc, "processed", 0))
        out["high_water"] = int(getattr(proc, "high_water", 0))
    except Exception as exc:
        out["error"] = repr(exc)
    return out


class FlightRecorder:
    """Builds and writes graftwatch dumps.  ``watch`` is the graftwatch
    facade (sampler + SLO engine + registries); kept lazy so the
    recorder can also serialize a standalone sampler in tests."""

    def __init__(self, watch=None, dump_dir: str | None = None):
        self.watch = watch
        self.dump_dir = dump_dir
        self._seq = 0
        self._lock = threading.Lock()
        self.last_path: str | None = None

    # -- document --------------------------------------------------------

    def build(self, reason: str = "manual") -> dict:
        w = self.watch
        doc: dict = {
            "format": "graftwatch-dump",
            "version": FORMAT_VERSION,
            "reason": reason,
        }
        sampler = w.sampler if w is not None else None
        if sampler is not None:
            doc["slot"] = sampler.latest_slot()
            doc["timeseries"] = sampler.window_dict()
        else:
            doc["slot"] = None
            doc["timeseries"] = {"window": 0, "slots": [], "series": {}}
        doc["chrome_trace"] = tracing.chrome_trace()
        doc["critpath"] = _critpath_summary()
        doc["cuda"] = cuda_accounting.snapshot()
        doc["device"] = device.flight_section()
        if w is not None:
            doc["incidents"] = [i.to_dict()
                                for i in w.engine.all_incidents()]
            doc["slo"] = w.engine.status()
            doc["chains"] = [_chain_summary(c) for c in w.chains()]
            doc["processors"] = [_processor_summary(p)
                                 for p in w.processors()]
            sync = [s for s in (_sync_summary(c) for c in w.chains())
                    if s is not None]
            doc["sync"] = sync or None
            serving = [_serving_summary(t) for t in w.servings()]
            doc["serving"] = serving or None
            replay = [_replay_summary(e) for e in w.replays()]
            doc["replay"] = replay or None
        else:
            doc["incidents"] = []
            doc["slo"] = {}
            doc["chains"] = []
            doc["processors"] = []
            doc["sync"] = None
            doc["serving"] = None
            doc["replay"] = None
        doc["recovery"] = _recovery_report()
        doc["log_tail"] = global_log_buffer().tail(LOG_TAIL)
        return _json_safe(doc)

    # -- persistence -----------------------------------------------------

    def dump(self, reason: str = "manual",
             path: str | None = None) -> str:
        """Atomically write a dump; returns the final path."""
        doc = self.build(reason)
        if path is None:
            with self._lock:
                self._seq += 1
                seq = self._seq
            base = self.dump_dir or tempfile.gettempdir()
            slot = doc.get("slot")
            slot_part = "na" if slot is None else str(slot)
            safe_reason = "".join(c if c.isalnum() or c in "-_" else "_"
                                  for c in reason)[:48]
            path = os.path.join(
                base,
                f"graftwatch_{slot_part}_{seq:03d}_{safe_reason}.json")
        dir_ = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(dir_, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".graftwatch_", suffix=".tmp",
                                   dir=dir_)
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(doc, fh, allow_nan=False, indent=1)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.last_path = path
        return path

    # -- SIGUSR2 ---------------------------------------------------------

    def install_signal_handler(self, signum=signal.SIGUSR2) -> bool:
        """Dump on signal; main-thread only (signal module contract)."""
        if threading.current_thread() is not threading.main_thread():
            return False

        def _on_signal(_sig, _frame):
            try:
                self.dump(reason="sigusr2")
            except Exception:  # pragma: no cover - best effort
                pass

        signal.signal(signum, _on_signal)
        return True
