"""The processor itself."""
from __future__ import annotations

import enum
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ..obs import tracing


class WorkType(enum.Enum):
    # priority order (beacon_processor/src/lib.rs queue drain order)
    CHAIN_SEGMENT_BACKFILL = 0
    GOSSIP_BLOCK = 1
    GOSSIP_BLOB_SIDECAR = 2
    RPC_BLOCK = 3
    CHAIN_SEGMENT = 4
    GOSSIP_AGGREGATE = 5
    GOSSIP_AGGREGATE_BATCH = 6
    GOSSIP_ATTESTATION = 7
    GOSSIP_ATTESTATION_BATCH = 8
    STATUS = 9
    GOSSIP_VOLUNTARY_EXIT = 10
    GOSSIP_PROPOSER_SLASHING = 11
    GOSSIP_ATTESTER_SLASHING = 12
    API_REQUEST = 13


#: queues drained in this order each scheduling round
PRIORITY_ORDER = [
    WorkType.GOSSIP_BLOCK, WorkType.GOSSIP_BLOB_SIDECAR, WorkType.RPC_BLOCK,
    WorkType.CHAIN_SEGMENT, WorkType.STATUS, WorkType.GOSSIP_AGGREGATE,
    WorkType.GOSSIP_ATTESTATION, WorkType.GOSSIP_VOLUNTARY_EXIT,
    WorkType.GOSSIP_PROPOSER_SLASHING, WorkType.GOSSIP_ATTESTER_SLASHING,
    WorkType.API_REQUEST, WorkType.CHAIN_SEGMENT_BACKFILL,
]

#: per-queue caps (scaled by validator count in the reference, lib.rs:97-130)
DEFAULT_CAPS = {
    WorkType.GOSSIP_ATTESTATION: 16384,
    WorkType.GOSSIP_AGGREGATE: 4096,
    WorkType.GOSSIP_BLOCK: 1024,
    WorkType.GOSSIP_BLOB_SIDECAR: 1024,
    WorkType.RPC_BLOCK: 1024,
    WorkType.CHAIN_SEGMENT: 64,
    WorkType.CHAIN_SEGMENT_BACKFILL: 64,
}


@dataclass
class Work:
    kind: WorkType
    run: Callable[[], Any]
    batchable_payload: Any = None  # set for attestation work, enables batching
    #: (trace_id, span_id) captured at submit time so the worker's spans
    #: join the submitting thread's trace (graftscope queue-hop rule)
    trace_ctx: Any = None
    #: perf_counter at submit — the worker's span reports the queue wait
    #: (enqueue -> execution start) so the critical path can split
    #: queue-wait from service time (obs/critpath.py)
    enqueued_at: float = 0.0


class BeaconProcessor:
    """Manager + bounded blocking worker pool. Gossip attestation/aggregate
    queues are drained opportunistically into batch work items
    (lib.rs:561)."""

    MAX_BATCH = 64

    def __init__(self, num_workers: int = 4,
                 batch_handler: Callable | None = None,
                 aggregate_batch_handler: Callable | None = None):
        from .reprocess import ReprocessQueue
        from ..utils.threads import ThreadGroup
        self.queues: dict[WorkType, deque] = {w: deque() for w in WorkType}
        self.reprocess = ReprocessQueue(self.submit)
        self.caps = dict(DEFAULT_CAPS)
        self.batch_handler = batch_handler
        self.aggregate_batch_handler = aggregate_batch_handler
        self._idle = threading.Semaphore(num_workers)
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._stop = False
        self.num_workers = num_workers
        self._workers = ThreadGroup("beacon_processor")
        self._manager = threading.Thread(target=self._run, daemon=True,
                                         name="beacon_processor.manager")
        self.dropped = 0
        self.processed = 0
        self.high_water = 0     # max total pending ever seen (scenarios)
        # graftwatch flight dumps include per-queue depths
        from ..obs import graftwatch
        graftwatch.register_processor(self)

    def start(self) -> None:
        self._manager.start()

    def stop(self, join: bool = True) -> None:
        """Stop the manager loop; by default JOIN it and the in-flight
        workers so no processor thread outlives the chain/network it
        touches (clean-shutdown discipline, task_executor/src/lib.rs)."""
        self._stop = True
        self.reprocess.close()
        self._event.set()
        if join:
            if self._manager.is_alive() and \
                    self._manager is not threading.current_thread():
                self._manager.join(timeout=2)
            self._workers.join_all(timeout=2)

    def submit(self, work: Work) -> bool:
        if work.trace_ctx is None:
            work.trace_ctx = tracing.capture()
        if not work.enqueued_at:
            work.enqueued_at = time.perf_counter()
        with self._lock:
            q = self.queues[work.kind]
            cap = self.caps.get(work.kind, 4096)
            shed = len(q) >= cap
            if shed:
                # drop oldest (gossip) — lossy under overload by design
                q.popleft()
                self.dropped += 1
            q.append(work)
            pending = sum(len(qq) for qq in self.queues.values())
            if pending > self.high_water:
                self.high_water = pending
        from ..api import metrics_defs as M
        if shed:
            M.count("beacon_processor_work_dropped_total")
        M.count("beacon_processor_work_events_total")
        M.gauge("beacon_processor_queue_length", pending)
        self._event.set()
        return True

    def _next_work(self) -> Work | list[Work] | None:
        with self._lock:
            for kind in PRIORITY_ORDER:
                q = self.queues[kind]
                if not q:
                    continue
                if kind in (WorkType.GOSSIP_ATTESTATION,
                            WorkType.GOSSIP_AGGREGATE) and len(q) > 1:
                    batch = []
                    while q and len(batch) < self.MAX_BATCH:
                        batch.append(q.popleft())
                    return batch
                return q.popleft()
        return None

    def _run(self) -> None:
        while not self._stop:
            work = self._next_work()
            if work is None:
                self._event.wait(timeout=0.05)
                self._event.clear()
                continue
            self._idle.acquire()
            self._workers.spawn(self._execute, work,
                                name="beacon_processor.worker")

    def _execute(self, work) -> None:
        first = work[0] if isinstance(work, list) else work
        batch = len(work) if isinstance(work, list) else 1
        from ..api import metrics_defs as M
        idle = getattr(self._idle, "_value", None)
        if idle is not None:
            M.gauge("beacon_processor_workers_active",
                    self.num_workers - idle)
        # re-attach the submitter's trace so the queue hop doesn't break
        # the block's gossip->db-write trace; batches adopt the first
        # item's context (they are one fused device call anyway)
        with tracing.attach(first.trace_ctx), \
                tracing.span("processor_work", work_kind=first.kind.name,
                             batch=batch) as s:
            if first.enqueued_at:
                s.annotate(queue_wait_s=round(
                    max(0.0, s.start - first.enqueued_at), 9))
            self._execute_inner(work)

    def _execute_inner(self, work) -> None:
        try:
            if isinstance(work, list):
                kind = work[0].kind
                handler = (self.batch_handler
                           if kind == WorkType.GOSSIP_ATTESTATION
                           else self.aggregate_batch_handler)
                if handler is not None:
                    payloads = [w.batchable_payload for w in work
                                if w.batchable_payload is not None]
                    if payloads:
                        handler(payloads)
                    # replayed (parked) items carry no payload — they
                    # re-run their full verification closure
                    for w in work:
                        if w.batchable_payload is None:
                            w.run()
                else:
                    for w in work:
                        w.run()
                with self._lock:
                    self.processed += len(work)
            else:
                handler = (self.batch_handler
                           if work.kind == WorkType.GOSSIP_ATTESTATION
                           else self.aggregate_batch_handler
                           if work.kind == WorkType.GOSSIP_AGGREGATE
                           else None)
                if handler is not None and work.batchable_payload is not None:
                    # a lone gossip item is a batch of one — its run() is
                    # a no-op placeholder and the payload must still reach
                    # the handler
                    handler([work.batchable_payload])
                else:
                    work.run()
                with self._lock:
                    self.processed += 1
        except Exception:
            import logging
            logging.getLogger("lighthouse_tpu_torch.processor").exception(
                "work item failed")
        finally:
            self._idle.release()
            self._event.set()

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Test helper: block until all queues drained and workers idle."""
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                empty = all(not q for q in self.queues.values())
            if empty:
                got = 0
                for _ in range(self.num_workers):
                    if self._idle.acquire(timeout=0.2):
                        got += 1
                for _ in range(got):
                    self._idle.release()
                if got == self.num_workers:
                    return True
            time.sleep(0.01)
        return False
