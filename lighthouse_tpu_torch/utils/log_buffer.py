"""In-process log ring buffer + SSE tail.

The reference streams recent log records over HTTP
(common/logging/src/sse_logging_components.rs, served at
http_api/src/lib.rs:4521 /lighthouse/logs).  This is the equivalent: a
logging.Handler that keeps the last N records and fans new ones out to
SSE subscribers.
"""
from __future__ import annotations

import collections
import json
import logging
import queue
import threading
import time

MAX_RECORDS = 512


class LogBuffer(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records: collections.deque = collections.deque(
            maxlen=MAX_RECORDS)
        self._subs: list[queue.Queue] = []
        self._lock = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry = {
                "time": time.strftime(
                    "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
                "level": record.levelname,
                "logger": record.name,
                "msg": record.getMessage(),
            }
        except Exception:
            return
        # stamp the active graftscope trace so /lighthouse/logs output is
        # correlatable with /lighthouse/tracing spans (best-effort: a log
        # record must never be lost to tracing trouble)
        try:
            from ..obs.tracing import current_context
            ctx = current_context()
            if ctx is not None:
                entry["trace_id"], entry["span_id"] = ctx
        except Exception:
            pass
        with self._lock:
            self.records.append(entry)
            for q in self._subs:
                try:
                    q.put_nowait(entry)
                except queue.Full:
                    pass

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=256)
        with self._lock:
            self._subs.append(q)
            for entry in self.records:
                try:
                    q.put_nowait(entry)
                except queue.Full:
                    break
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def tail(self, n: int = 100) -> list[dict]:
        with self._lock:
            return list(self.records)[-n:]


_GLOBAL: LogBuffer | None = None


def global_log_buffer() -> LogBuffer:
    """Install (once) on the lighthouse_tpu_torch logger tree."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = LogBuffer()
        logging.getLogger("lighthouse_tpu_torch").addHandler(_GLOBAL)
        logging.getLogger("lighthouse_tpu_torch").setLevel(logging.INFO)
    return _GLOBAL


def to_sse(entry: dict) -> bytes:
    return f"data: {json.dumps(entry)}\n\n".encode()
