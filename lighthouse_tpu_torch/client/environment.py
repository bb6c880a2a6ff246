"""Runtime environment: task spawning with graceful shutdown.

Equivalent of the reference's {common/task_executor, lighthouse/environment}:
named daemon tasks, a shutdown signal every task can trigger, and
block-until-shutdown for the binaries.
"""
from __future__ import annotations

import logging
import signal
import threading


class RuntimeContext:
    """Per-service context: child logger + executor (service_context)."""

    def __init__(self, env: "Environment", name: str):
        self.env = env
        self.log = logging.getLogger(f"lighthouse_tpu_torch.{name}")

    def spawn(self, fn, name: str) -> threading.Thread:
        return self.env.spawn(fn, name)


class Environment:
    def __init__(self, log_level: str = "INFO"):
        logging.basicConfig(
            level=getattr(logging, log_level.upper(), logging.INFO),
            format="%(asctime)s %(levelname)-5s %(name)s: %(message)s")
        self.log = logging.getLogger("lighthouse_tpu_torch")
        self._shutdown = threading.Event()
        # guards shutdown_reason: shutdown() is called from any dying
        # task thread, and the FIRST reason must win (a second task
        # failing while SIGTERM lands must not overwrite the cause the
        # operator sees) — graftrace data-race fix
        self._lock = threading.Lock()
        self.shutdown_reason: str | None = None
        self._tasks: list[threading.Thread] = []

    def service_context(self, name: str) -> RuntimeContext:
        return RuntimeContext(self, name)

    def spawn(self, fn, name: str) -> threading.Thread:
        def wrapped():
            try:
                fn()
            except Exception:
                self.log.exception("task %s died", name)
                self.shutdown("task failure: " + name)
        t = threading.Thread(target=wrapped, name=name, daemon=True)
        t.start()
        self._tasks.append(t)
        return t

    def shutdown(self, reason: str) -> None:
        with self._lock:
            if self.shutdown_reason is None:
                self.shutdown_reason = reason
        self._shutdown.set()

    def shutdown_requested(self) -> bool:
        return self._shutdown.is_set()

    def block_until_shutdown(self) -> str:
        try:
            signal.signal(signal.SIGTERM,
                          lambda *a: self.shutdown("SIGTERM"))
            signal.signal(signal.SIGINT,
                          lambda *a: self.shutdown("SIGINT"))
        except ValueError:
            pass  # not main thread
        self._shutdown.wait()
        with self._lock:
            return self.shutdown_reason or "unknown"
