"""Server-sent-event style chain event bus
(the reference's beacon_node/beacon_chain/src/events.rs)."""
from __future__ import annotations

import queue
import threading


EVENT_KINDS = ("head", "block", "attestation", "finalized_checkpoint",
               "chain_reorg", "voluntary_exit", "blob_sidecar",
               "payload_attributes", "block_gossip")


class EventHandler:
    def __init__(self, capacity: int = 1024):
        self._subs: list[tuple[set[str], queue.Queue]] = []
        #: synchronous listeners: (kinds, fn) called inline from emit().
        #: emit() runs under the chain lock, so listeners must be cheap
        #: and must never raise (the serving tier's cache invalidation
        #: is the intended consumer).
        self._listeners: list[tuple[set[str], object]] = []
        self._lock = threading.Lock()
        self.capacity = capacity

    def subscribe(self, kinds=None) -> queue.Queue:
        q: queue.Queue = queue.Queue(self.capacity)
        with self._lock:
            self._subs.append((set(kinds or EVENT_KINDS), q))
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            self._subs = [(k, s) for k, s in self._subs if s is not q]

    def add_listener(self, kinds, fn) -> None:
        with self._lock:
            self._listeners.append((set(kinds or EVENT_KINDS), fn))

    def remove_listener(self, fn) -> None:
        with self._lock:
            self._listeners = [(k, f) for k, f in self._listeners
                               if f is not fn]

    def emit(self, kind: str, payload) -> None:
        with self._lock:
            subs = list(self._subs)
            listeners = list(self._listeners)
        for kinds, fn in listeners:
            if kind in kinds:
                try:
                    fn(kind, payload)
                except Exception:
                    pass
        for kinds, q in subs:
            if kind in kinds:
                try:
                    q.put_nowait((kind, payload))
                except queue.Full:
                    pass

    def has_subscribers(self) -> bool:
        return bool(self._subs)
