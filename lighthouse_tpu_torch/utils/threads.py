"""ThreadGroup: tracked spawning with a join-all shutdown path.

The reference makes shutdown ordering structural — every task runs under
the TaskExecutor and the environment drains them on shutdown
(the reference's common/task_executor/src/lib.rs:12-28). Unhandled
thread exceptions come from exactly the opposite pattern: fire-and-forget
daemon threads (`threading.Thread(...)
.start()` with the object dropped) racing socket/executor teardown.

``ThreadGroup`` is the minimal structural fix: services spawn through a
group they own and `join_all()` in their stop path *before* closing the
resources those threads touch. Threads stay daemonic (a wedged peer
must never block interpreter exit) — the join timeout bounds shutdown.
graftlint's thread-lifecycle rule recognizes ``group.spawn(...)`` as an
accounted-for spawn, and graftrace's data-race rule treats the spawn
target as a thread-boundary escape: the receiving class is seeded into
the shared-state model and its lockset discipline checked.
"""
from __future__ import annotations

import threading


class ThreadGroup:
    """Tracked thread spawning + bounded join-all."""

    def __init__(self, name: str = "threads"):
        self.name = name
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []

    def spawn(self, target, *args, name: str | None = None,
              daemon: bool = True) -> threading.Thread:
        # propagate the spawner's trace context so spans opened in the
        # child join the same trace (graftscope cross-thread rule; the
        # beacon processor's Work items do the same for queue hops)
        from ..obs import tracing
        ctx = tracing.capture()
        run = target
        if ctx is not None:
            def run(*a, _target=target, _ctx=ctx):
                with tracing.attach(_ctx):
                    _target(*a)
        t = threading.Thread(target=run, args=args, name=name,
                             daemon=daemon)
        self.track(t)
        t.start()
        return t

    def track(self, t: threading.Thread) -> threading.Thread:
        """Adopt an externally-created Thread (or Timer) into the group."""
        with self._lock:
            self._threads.append(t)
            # keep the list from growing unboundedly on long-lived
            # services that spawn per-peer/per-request threads
            if len(self._threads) > 64:
                self._threads = [x for x in self._threads if x.is_alive()]
        return t

    def join_all(self, timeout: float = 2.0) -> list[threading.Thread]:
        """Cancel pending Timers and join everything else under ONE
        shared deadline (a handful of wedged peers must not multiply
        shutdown time). Returns threads still alive afterwards so
        callers can log/assert on stragglers."""
        import time
        with self._lock:
            threads = list(self._threads)
            self._threads = []
        me = threading.current_thread()
        deadline = time.monotonic() + timeout
        alive = []
        for t in threads:
            if isinstance(t, threading.Timer):
                t.cancel()
            if t is me or not t.is_alive():
                continue
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                alive.append(t)
        return alive
