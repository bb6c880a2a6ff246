"""The serving tier: coalescing + fork-aware cache + shedding.

Sits between ``http_server.py`` and ``backend.py`` for the endpoints a
validator-client fleet hammers every slot.  One :class:`ServingTier`
request does, in order:

1. count ``api_requests_total`` and open a graftscope ``api_request``
   span (feeds the ``api_request_seconds`` histogram → ``serving_p95``
   SLO);
2. pass the priority gate (:mod:`.shed`) — under pressure the lowest-
   priority waiting request is shed with :class:`~.shed.ShedError`
   (HTTP 503), never stalled;
3. look up the fork-aware response cache (:mod:`.cache`) under the
   *current* head root — a hit returns pre-encoded bytes (a memcpy);
4. on miss, run the backend computation single-flight (:mod:`.coalesce`)
   so N concurrent identical misses pay for ONE computation, encode
   once, and cache the encoded bytes under the head they were built for.

Invalidation is event-driven: the tier subscribes to the chain's
``head``/``chain_reorg`` events and prunes every entry built under any
other head root.  This module must NOT import ``..backend`` — backend
imports the coalescer from this package (attester-cache priming), so the
dependency points strictly serving ← backend.
"""
from __future__ import annotations

import json
import threading
import time

from ...obs import graftwatch, tracing
from ...ssz import serialize
from .. import metrics_defs
from .cache import CachedResponse, ResponseCache
from .coalesce import Coalescer
from .shed import (
    BLOCKS, BULK, CRITICAL, PRIORITY_NAMES, AdmissionQueue, ShedError,
)


class ServingTier:
    """Coalescing, caching, shedding front for an :class:`ApiBackend`."""

    def __init__(self, backend, cache_capacity: int = 4096,
                 queue_workers: int = 8, queue_capacity: int = 64):
        self.backend = backend
        self.cache = ResponseCache(cache_capacity)
        self.coalescer = Coalescer()
        self.queue = AdmissionQueue(queue_workers, queue_capacity)
        #: head key used when the backend has no live chain (bench
        #: harness, tests); writable so tests can simulate head moves
        self.static_head_root = b"\x00" * 32
        self.requests = 0
        self._lock = threading.Lock()
        self._slowest: dict[str, float] = {}
        # fork-choice-driven invalidation: listeners run synchronously
        # under the chain lock, so keep _on_event cheap and non-raising
        chain = getattr(backend, "chain", None)
        events = getattr(chain, "events", None)
        if events is not None and hasattr(events, "add_listener"):
            events.add_listener(("head", "chain_reorg"), self._on_event)
        graftwatch.register_serving(self)

    # -- head / invalidation -------------------------------------------------

    def _head_root(self) -> bytes:
        chain = getattr(self.backend, "chain", None)
        head_fn = getattr(chain, "head", None)
        if callable(head_fn):
            try:
                return head_fn().head_block_root
            except Exception:
                pass
        return self.static_head_root

    def _on_event(self, kind: str, payload) -> None:
        root = payload.get("block") if isinstance(payload, dict) else None
        if isinstance(root, bytes):
            self.cache.on_head_change(root)
        else:
            self.cache.clear()

    # -- core ----------------------------------------------------------------

    def request(self, endpoint: str, key, produce,
                priority: int = CRITICAL,
                cacheable: bool = True) -> CachedResponse:
        """Serve one logical request: returns pre-encoded wire bytes.

        ``produce()`` must return the JSON payload the uncached route
        would have passed to ``json.dumps`` — byte equality with the
        uncached path is a tested invariant.
        """
        with self._lock:
            self.requests += 1
        metrics_defs.count("api_requests_total")
        t0 = time.perf_counter()
        try:
            with tracing.span("api_request", endpoint=endpoint,
                              priority=PRIORITY_NAMES.get(priority,
                                                          str(priority))):
                with self.queue.admit(priority):
                    head = self._head_root()
                    if cacheable:
                        entry = self.cache.get(endpoint, key, head)
                        if entry is not None:
                            metrics_defs.count("api_cache_hits_total")
                            return entry
                        metrics_defs.count("api_cache_misses_total")

                    def _flight() -> CachedResponse:
                        return CachedResponse(
                            json.dumps(produce()).encode(),
                            head_root=head)

                    entry, led = self.coalescer.do((endpoint, key, head),
                                                   _flight)
                    if cacheable and led:
                        self.cache.put(endpoint, key, head, entry)
                    return entry
        except ShedError:
            metrics_defs.count("api_shed_total")
            raise
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                if dt > self._slowest.get(endpoint, 0.0):
                    self._slowest[endpoint] = dt

    # -- coalesced endpoints (renderings byte-match http_server's) -----------

    def attestation_data(self, slot: int,
                         committee_index: int) -> CachedResponse:
        def produce():
            data = self.backend.attestation_data(slot, committee_index)
            t = type(data).ssz_type
            return {"data": {"ssz": serialize(t, data).hex()}}
        return self.request("attestation_data", (slot, committee_index),
                            produce, CRITICAL)

    def proposer_duties(self, epoch: int) -> CachedResponse:
        def produce():
            return {"data": [
                {"slot": str(s), "validator_index": str(v),
                 "pubkey": "0x00"}
                for s, v in self.backend.get_proposer_duties(epoch)]}
        return self.request("proposer_duties", (epoch,), produce, CRITICAL)

    def attester_duties(self, epoch: int, indices) -> CachedResponse:
        idx = tuple(int(i) for i in indices)

        def produce():
            duties = self.backend.get_attester_duties(epoch, list(idx))
            return {"data": [
                {"slot": str(s), "committee_index": str(ci),
                 "validator_index": str(vi),
                 "committee_length": str(cl),
                 "validator_committee_index": str(pos)}
                for s, ci, vi, cl, pos in duties]}
        return self.request("attester_duties", (epoch, idx), produce,
                            CRITICAL)

    def headers(self, slot: int | None,
                parent_root: bytes | None) -> CachedResponse:
        def produce():
            return {"data": self.backend.headers(slot, parent_root)}
        return self.request("headers", (slot, parent_root), produce, BLOCKS)

    def light_client_bootstrap(self, block_root_hex: str) -> CachedResponse:
        def produce():
            return {"data":
                    self.backend.light_client_bootstrap(block_root_hex)}
        return self.request("light_client_bootstrap", (block_root_hex,),
                            produce, BULK)

    def light_client_finality_update(self) -> CachedResponse:
        def produce():
            return {"data": self.backend.light_client_finality_update()}
        return self.request("light_client_finality_update", (), produce,
                            BULK)

    def light_client_optimistic_update(self) -> CachedResponse:
        def produce():
            return {"data": self.backend.light_client_optimistic_update()}
        return self.request("light_client_optimistic_update", (), produce,
                            BULK)

    def light_client_updates(self, start_period: int,
                             count: int) -> CachedResponse:
        def produce():
            return {"data": self.backend.light_client_updates(start_period,
                                                              count)}
        return self.request("light_client_updates", (start_period, count),
                            produce, BULK)

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        """Flight-recorder / doctor section: one cheap dict, no locks
        held across backend calls."""
        c, q = self.cache, self.queue
        lookups = c.hits + c.misses
        with self._lock:
            slowest = sorted(self._slowest.items(),
                             key=lambda kv: -kv[1])[:5]
        return {
            "requests": self.requests,
            "queue_depth": q.depth(),
            "queue_active": q.active,
            "queue_high_water": q.high_water,
            "cache_entries": len(c),
            "cache_hits": c.hits,
            "cache_misses": c.misses,
            "cache_hit_ratio": (c.hits / lookups) if lookups else None,
            "cache_invalidated": c.invalidated,
            "coalesced": self.coalescer.coalesced,
            "flights": self.coalescer.flights,
            "shed": {PRIORITY_NAMES.get(p, str(p)): n
                     for p, n in sorted(q.shed_counts.items())},
            "shed_total": sum(q.shed_counts.values()),
            "slowest": [{"endpoint": e, "worst_ms": round(v * 1000, 3)}
                        for e, v in slowest],
        }
