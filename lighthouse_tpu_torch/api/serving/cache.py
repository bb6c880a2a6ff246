"""Fork-aware pre-encoded response cache (serving tier).

Entries are keyed ``(endpoint, key, head_root)`` and store the fully
encoded wire bytes, so a hit is a memcpy — no re-serialization, no
backend call.  Invalidation is event-driven, not TTL-driven: when fork
choice moves the head (or reorgs), :meth:`ResponseCache.on_head_change`
drops every entry built under any other head root.  Because lookups
always use the *current* head root as part of the key, a stale entry
can never be served even in the window before the pruning runs — the
pruning only reclaims memory.
"""
from __future__ import annotations

import threading
from collections import OrderedDict


class CachedResponse:
    """Encoded wire bytes plus the metadata needed to write them."""

    __slots__ = ("body", "content_type", "version", "head_root")

    def __init__(self, body: bytes, content_type: str = "application/json",
                 version: str | None = None,
                 head_root: bytes = b""):
        self.body = body
        self.content_type = content_type
        self.version = version
        self.head_root = head_root


class ResponseCache:
    """Bounded LRU of :class:`CachedResponse`, invalidated by head."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidated = 0

    def get(self, endpoint: str, key, head_root: bytes):
        k = (endpoint, key, head_root)
        with self._lock:
            entry = self._entries.get(k)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(k)
            self.hits += 1
            return entry

    def put(self, endpoint: str, key, head_root: bytes,
            entry: CachedResponse) -> None:
        k = (endpoint, key, head_root)
        with self._lock:
            self._entries[k] = entry
            self._entries.move_to_end(k)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def on_head_change(self, new_head_root: bytes) -> int:
        """Drop every entry built under a different head. Returns the
        number of entries invalidated.

        Runs on the fork-choice event thread while serving workers hit
        get/put concurrently; the whole scan-and-prune holds ``_lock``,
        which graftrace pins ('guarded' on hits/misses/invalidated)."""
        with self._lock:
            stale = [k for k in self._entries if k[2] != new_head_root]
            for k in stale:
                del self._entries[k]
            self.invalidated += len(stale)
            return len(stale)

    def clear(self) -> None:
        with self._lock:
            self.invalidated += len(self._entries)
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
