"""SyncManager: event routing + the real network context.

Equivalent of the reference's `SyncManager` task (network/src/sync/
manager.rs:177): owns the three strategies — range sync (range_sync.py),
backfill (backfill.py), block lookups (lookups.py) — and routes network
events to them.  The machines themselves are synchronous and testable with
synthetic events; this module supplies the production context that issues
real req/resp calls over the libp2p transport with a bounded worker pool
(parallel downloads, the blst-multicore analog of the reference's
tokio-concurrent batch requests), decodes SSZ+fork-digest payloads, and
funnels processing into `BeaconChain.process_chain_segment`.

The public entry points (service.py and the simulator drive them
synchronously): `maybe_sync()`, `backfill()`, `lookup_unknown_parent()`.
"""
from __future__ import annotations

import random
import sys
import threading
import time
from collections import deque
from concurrent.futures import (
    FIRST_COMPLETED, Future, ThreadPoolExecutor, wait,
)

from ...chain.errors import BlockError
from ...ssz import deserialize, htr, serialize
from .backfill import BackfillSync
from .lookups import BlockLookups
from .range_sync import EPOCHS_PER_BATCH, RangeSync

REQUEST_TIMEOUT = 20.0


def _metrics():
    """metrics_defs, sys.modules-gated (the sync machines run in wire
    tests without the metrics stack loaded).  A module that is still
    mid-import — sync threads can race the api package's first import —
    is treated as absent rather than letting an AttributeError escape
    into the status/pump threads."""
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    return md if hasattr(md, "count") and hasattr(md, "gauge") else None


class _DecodeError(Exception):
    """A response chunk failed SSZ/fork-digest decoding — near-certain
    peer malice, attributed separately from a timeout."""


class PeerBackoff:
    """Jittered exponential re-dispatch backoff + per-peer quarantine.

    Every failed request charges the serving peer a growing, jittered
    delay before sync will dispatch to it again; QUARANTINE_AFTER
    consecutive failures quarantines the peer outright for
    QUARANTINE_SECS (`maybe_sync`/`backfill` skip quarantined peers when
    building pools).  Any success clears the slate.  Seeded RNG keeps
    scenarios deterministic.
    """

    BASE_DELAY = 0.5
    MAX_DELAY = 8.0
    QUARANTINE_AFTER = 3
    QUARANTINE_SECS = 30.0

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._fails: dict[str, int] = {}
        self._delay_until: dict[str, float] = {}
        self._quarantine_until: dict[str, float] = {}
        self._lock = threading.Lock()

    def note_failure(self, peer_id: str) -> float:
        """Record a failed request; returns the backoff delay applied."""
        quarantined = False
        with self._lock:
            n = self._fails.get(peer_id, 0) + 1
            self._fails[peer_id] = n
            delay = min(self.MAX_DELAY, self.BASE_DELAY * 2 ** (n - 1))
            delay *= 0.5 + self._rng.random()
            self._delay_until[peer_id] = time.monotonic() + delay
            if n == self.QUARANTINE_AFTER:
                self._quarantine_until[peer_id] = (
                    time.monotonic() + self.QUARANTINE_SECS)
                quarantined = True
        if quarantined:
            md = _metrics()
            if md is not None:
                md.count("sync_peer_quarantined_total")
        return delay

    def note_success(self, peer_id: str) -> None:
        with self._lock:
            self._fails.pop(peer_id, None)
            self._delay_until.pop(peer_id, None)
            self._quarantine_until.pop(peer_id, None)

    def quarantined(self, peer_id: str) -> bool:
        with self._lock:
            until = self._quarantine_until.get(peer_id)
            if until is None:
                return False
            if time.monotonic() >= until:
                del self._quarantine_until[peer_id]
                return False
            return True

    def delay_remaining(self, peer_id: str) -> float:
        with self._lock:
            until = self._delay_until.get(peer_id)
        if until is None:
            return 0.0
        return max(0.0, until - time.monotonic())

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                "failing": dict(self._fails),
                "backoff_remaining": {
                    p: round(max(0.0, t - now), 3)
                    for p, t in self._delay_until.items()
                    if t > now},
                "quarantined": {
                    p: round(max(0.0, t - now), 3)
                    for p, t in self._quarantine_until.items()
                    if t > now},
            }


class _RealSyncContext:
    """Production context: request IO on a worker pool, chain hooks."""

    MAX_WORKERS = 4

    def __init__(self, chain, rpc, peer_manager):
        self.chain = chain
        self.rpc = rpc
        self.peers = peer_manager
        self._digest_map = None
        self._next_req = 0
        self._pool = None
        self._closed = False
        # req_id -> (owner, peer_id, future, kind, deadline)
        self.inflight: dict[int, tuple] = {}
        self.imported_total = 0
        self._lock = threading.Lock()
        # per-request deadline; instance attr so scenarios can tighten it
        self.request_timeout = REQUEST_TIMEOUT
        self.backoff = PeerBackoff()
        # newest-last (peer, start, count, reason) validation rejects,
        # surfaced by the flight recorder's doc["sync"] section
        self.validation_rejects: deque = deque(maxlen=32)

    # -- chain views ---------------------------------------------------------

    def slots_per_epoch(self) -> int:
        return self.chain.spec.preset.slots_per_epoch

    def max_request_blocks(self) -> int:
        return self.chain.spec.max_request_blocks

    def local_status(self) -> tuple[int, int]:
        head = self.chain.head()
        fin_epoch = int(self.chain.fork_choice.finalized_checkpoint[0])
        return head.head_state.slot, fin_epoch

    def block_known(self, root: bytes) -> bool:
        return self.chain.fork_choice.contains_block(root)

    def block_root(self, signed_block) -> bytes:
        return htr(signed_block.message)

    def process_segment(self, blocks: list) -> tuple[int, str | None]:
        # graftflow (chain/replay/): epoch-pipelined replay with
        # batched signatures, deferred merkleization and one atomic store
        # commit per epoch — the sequential process_chain_segment stays as
        # its bit-exact oracle
        try:
            n = self.chain.replay_engine().replay_segment(blocks)
        except BlockError as e:
            return 0, e.kind
        with self._lock:
            self.imported_total += n
        return n, None

    def penalize(self, peer_id: str, reason: str) -> None:
        if reason == "shutdown":
            return                      # our own close path, not the peer's
        md = _metrics()
        if md is not None:
            md.count("sync_penalties_total")
            md.count(f"sync_penalties_total_{reason}")
        self.peers.report(peer_id, reason)

    def note_validation_reject(self, peer_id: str, start: int, count: int,
                               reason: str) -> None:
        self.validation_rejects.append(
            {"peer": peer_id, "start": start, "count": count,
             "reason": reason})

    def finalized_slot(self) -> int:
        fin_epoch = int(self.chain.fork_choice.finalized_checkpoint[0])
        return fin_epoch * self.slots_per_epoch()

    def note_pre_finalization(self, root: bytes) -> None:
        self.chain.pre_finalization_cache.insert(root)

    def on_lookup_imported(self, root: bytes) -> None:
        proc = getattr(self.chain, "processor", None)
        if proc is not None and getattr(proc, "reprocess", None) is not None:
            proc.reprocess.on_block_imported(root)

    # -- backfill store hooks ------------------------------------------------

    def backfill_anchor(self):
        return self.chain.store.backfill_anchor()

    def set_backfill_anchor(self, slot: int, root: bytes) -> None:
        self.chain.store.set_backfill_anchor(slot, root)

    def store_backfill_block(self, root: bytes, sb) -> None:
        from ...store import StoreOp
        # hot block first, freezer root second: a crash between the two
        # leaves a re-downloadable gap, never a freezer root pointing at
        # a block the store doesn't have
        self.chain.store.do_atomically([StoreOp.put_block(root, sb)],
                                       fsync=False)
        self.chain.store.freezer_put_block_root(sb.message.slot, root)

    def store_backfill_batch(self, pairs: list) -> None:
        # whole validated batch as ONE atomic hot batch + freezer roots
        # (graftflow backfill commit, same hot-first crash ordering)
        self.chain.replay_engine().backfill_batch(pairs)

    # -- request IO ----------------------------------------------------------

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.MAX_WORKERS)
        return self._pool

    def close(self) -> None:
        """Shutdown path (task_executor/src/lib.rs:12-28 ordering): no
        new downloads may be submitted once closed — late callers get an
        already-failed future instead of `RuntimeError: cannot schedule
        new futures after shutdown` escaping on a status-exchange
        thread."""
        with self._lock:
            self._closed = True
            pool = self._pool
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    def _submit(self, fn, *args) -> Future:
        with self._lock:
            if self._closed:
                fut: Future = Future()
                fut.set_exception(TimeoutError("sync context closed"))
                return fut
            pool = self._executor()
        try:
            return pool.submit(fn, *args)
        except RuntimeError:            # raced an interpreter-level shutdown
            fut = Future()
            fut.set_exception(TimeoutError("sync context closed"))
            return fut

    def _decode_block(self, hex_payload: str, strict: bool = False):
        try:
            raw = bytes.fromhex(hex_payload)
            dmap = self._digest_map
            if dmap is None:
                dmap = self._digest_map = digest_to_fork(self.chain)
            cls = self.chain.T.SignedBeaconBlock[dmap[raw[:4]]]
            return deserialize(cls.ssz_type, raw[4:])
        except Exception:
            # an undecodable chunk must not masquerade as an empty
            # response: the fetcher raises so
            # the pump attributes "decode_error" to the serving peer
            if strict:
                raise _DecodeError(hex_payload[:16])
            return None

    def _pace(self, peer_id: str) -> None:
        """Honor this peer's backoff delay inside the worker thread (never
        under a lock); bails out promptly if the context closes."""
        end = time.monotonic() + self.backoff.delay_remaining(peer_id)
        while True:
            left = end - time.monotonic()
            if left <= 0:
                return
            if self._closed:
                raise TimeoutError("sync context closed")
            time.sleep(min(0.1, left))

    def _fetch_range(self, peer_id: str, start: int, count: int):
        self._pace(peer_id)
        peer = self.rpc.transport.peers.get(peer_id)
        if peer is None:
            raise TimeoutError("peer gone")
        resp = self.rpc.request(peer, "beacon_blocks_by_range",
                                {"start_slot": start, "count": count},
                                timeout=self.request_timeout)
        return [self._decode_block(b, strict=True) for b in resp or []]

    def _fetch_root(self, peer_id: str, root: bytes):
        self._pace(peer_id)
        peer = self.rpc.transport.peers.get(peer_id)
        if peer is None:
            raise TimeoutError("peer gone")
        resp = self.rpc.request(peer, "beacon_blocks_by_root",
                                {"roots": [root.hex()]},
                                timeout=self.request_timeout)
        if not resp:
            return None
        return self._decode_block(resp[0], strict=True)

    def _deadline(self, peer_id: str) -> float:
        # the deadline covers the request's own budget PLUS whatever
        # backoff pause the worker will sit out first
        return (time.monotonic() + self.request_timeout
                + self.backoff.delay_remaining(peer_id))

    def send_range(self, peer_id: str, start: int, count: int, owner) -> int:
        # submit BEFORE taking the lock (submission takes it internally),
        # then allocate the id and record the request atomically: a
        # concurrent close() can no longer observe the id without the
        # inflight entry, and a post-close caller records the pre-failed
        # future instead of racing `RuntimeError: cannot schedule new
        # futures after shutdown` on a status-exchange thread
        fut = self._submit(self._fetch_range, peer_id, start, count)
        with self._lock:
            req_id = self._next_req
            self._next_req += 1
            self.inflight[req_id] = (owner, peer_id, fut, "range",
                                     self._deadline(peer_id))
        return req_id

    def send_root(self, peer_id: str, root: bytes, owner) -> int:
        fut = self._submit(self._fetch_root, peer_id, root)
        with self._lock:
            req_id = self._next_req
            self._next_req += 1
            self.inflight[req_id] = (owner, peer_id, fut, "root",
                                     self._deadline(peer_id))
        return req_id

    # -- event pump ----------------------------------------------------------

    @staticmethod
    def _classify(fut) -> tuple[object, str]:
        """(result, failure-reason) for a completed future.  The reason
        only matters when result is None; "shutdown" carries no penalty,
        the rest map to distinct peer_manager SCORES weights."""
        try:
            return fut.result(timeout=0), "timeout"
        except _DecodeError:
            return None, "decode_error"
        except TimeoutError as exc:
            msg = str(exc)
            if msg == "peer gone":
                return None, "peer_gone"
            if msg == "sync context closed":
                return None, "shutdown"
            return None, "timeout"
        except Exception:
            return None, "timeout"

    def pump(self) -> None:
        """Deliver completed request results to their owners until no
        request is in flight.

        Per-request deadline wheel: each in-flight request
        carries its own deadline; the pump waits only until the nearest
        one, then expires overdue requests *individually* — failing that
        request alone and penalizing that peer alone.  A slowloris peer
        can no longer mass-fail the honest pool the way the old global
        20 s stall window did (`sync_pump_global_stall_total` is the
        structurally-zero tripwire for that behavior).
        """
        while True:
            with self._lock:
                if not self.inflight:
                    return
                futs = {rec[2]: rid for rid, rec in self.inflight.items()}
                nearest = min(rec[4] for rec in self.inflight.values())
            done, _ = wait(list(futs),
                           timeout=max(0.0, nearest - time.monotonic()),
                           return_when=FIRST_COMPLETED)
            now = time.monotonic()
            deliveries = []                 # (rid, record, expired)
            with self._lock:
                for fut in done:
                    rec = self.inflight.pop(futs[fut], None)
                    if rec is not None:
                        deliveries.append((futs[fut], rec, False))
                for rid, rec in list(self.inflight.items()):
                    if rec[4] <= now:
                        del self.inflight[rid]
                        deliveries.append((rid, rec, True))
            md = _metrics()
            for rid, (owner, peer_id, fut, kind, _dl), expired in deliveries:
                if expired:
                    fut.cancel()
                    if md is not None:
                        md.count("sync_request_deadline_expired_total")
                    result, reason = None, "stall"
                else:
                    result, reason = self._classify(fut)
                if result is None and reason != "shutdown":
                    self.backoff.note_failure(peer_id)
                elif result is not None:
                    self.backoff.note_success(peer_id)
                if kind == "range":
                    owner.on_range_response(rid, result, reason=reason)
                else:
                    owner.on_root_response(rid, result, peer_id,
                                           reason=reason)

    def snapshot(self) -> dict:
        """Flight-recorder view: in-flight requests, backoff/quarantine
        state, and the most recent validation rejects."""
        now = time.monotonic()
        with self._lock:
            inflight = [
                {"req_id": rid, "peer": rec[1], "kind": rec[3],
                 "deadline_in": round(rec[4] - now, 3)}
                for rid, rec in self.inflight.items()]
        return {
            "inflight": inflight,
            "backoff": self.backoff.snapshot(),
            "validation_rejects": list(self.validation_rejects),
            "imported_total": self.imported_total,
            "request_timeout": self.request_timeout,
        }


class SyncManager:
    """Facade over the three sync strategies (manager.rs:177)."""

    def __init__(self, chain, rpc, peer_manager):
        self.chain = chain
        self.rpc = rpc
        self.peers = peer_manager
        self.ctx = _RealSyncContext(chain, rpc, peer_manager)
        self.range = RangeSync(self.ctx)
        self.lookups = BlockLookups(self.ctx)
        self.state = "synced"          # synced | range_syncing (property
        #                                feeds the sync_state gauge)
        # one strategy drives at a time: the service loop, gossip handlers
        # and tests all enter through these methods (manager.rs: the sync
        # manager is a single task; here a lock provides the same
        # exclusion).  Deltas are measured from BEFORE the lock so a
        # caller that waited on a concurrent sync still reports its
        # progress.
        self._drive_lock = threading.RLock()

    @property
    def state(self) -> str:
        return self._state

    @state.setter
    def state(self, value: str) -> None:
        self._state = value
        md = _metrics()
        if md is not None:
            md.gauge("sync_state", 0 if value == "synced" else 1)

    def stop(self) -> None:
        """Refuse new downloads and cancel queued ones; in-flight request
        threads drain into failed results instead of raising into a
        closed transport."""
        self.ctx.close()

    # -- entry points --------------------------------------------------------

    def maybe_sync(self) -> int:
        """Classify STATUS-ahead peers into chains and sync the best one
        to completion (or failure), pumping download events."""
        before = self.ctx.imported_total
        with self._drive_lock:
            while True:
                # (re-)classify peers each pass: when a finalized chain
                # completes, still-ahead peers regroup into head chains
                # (chain_collection.rs re-grouping)
                for p in self.peers.connected():
                    if (p.status is not None and p.score >= 0
                            and not self.ctx.backoff.quarantined(p.node_id)):
                        self.range.add_peer(p.node_id, p.status)
                chain = self.range.drive()
                if chain is None or not self.ctx.inflight:
                    break               # nothing dispatchable remained
                self.state = "range_syncing"
                self.ctx.pump()
            self.state = "synced"
        return self.ctx.imported_total - before

    def backfill(self, batch_slots: int | None = None) -> int:
        """Run the backfill machine against the current peer pool until it
        stops (anchor at genesis, stall, or misbehavior)."""
        with self._drive_lock:
            machine = BackfillSync(self.ctx, batch_slots)
            pool = [p.node_id for p in self.peers.connected()
                    if p.status is not None and p.score >= 0
                    and not p.banned
                    and not self.ctx.backoff.quarantined(p.node_id)]
            if not pool:
                best = self.peers.best_peer_for_sync()
                if best is None:
                    return 0
                pool = [best.node_id]
            while not machine.stopped and not machine.complete:
                machine.drive(pool)
                if not machine.in_flight:
                    break
                self.ctx.pump()
            return machine.stored

    # -- helpers -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Sync-layer view for the flight recorder's doc["sync"]."""
        snap = self.ctx.snapshot()
        snap["state"] = self.state
        return snap

    def _decode_block(self, hex_payload: str):
        return self.ctx._decode_block(hex_payload)

    def _sync_peer_pool(self, min_head: int) -> list:
        """Non-banned, non-negative-score peers whose head is past
        min_head (range peer pool view, used by tests/monitoring)."""
        return [p for p in self.peers.connected()
                if p.status is not None and p.status.head_slot > min_head
                and p.score >= 0]

    def lookup_unknown_parent(self, block_root: bytes, peer_id: str,
                              max_depth: int | None = None) -> int:
        """Resolve an unknown-parent/unknown-root block by walking its
        ancestry (depth-limited in BlockLookups)."""
        before = self.ctx.imported_total
        with self._drive_lock:
            self.lookups.search(block_root, peer_id, max_depth=max_depth)
            self.ctx.pump()
        return self.ctx.imported_total - before


def digest_to_fork(chain) -> dict:
    """4-byte fork-digest -> ForkName, for the chunk context bytes the
    real req/resp protocol leads block chunks with
    (rpc/codec/ssz_snappy.rs context_bytes)."""
    from ...specs.chain_spec import ForkName, compute_fork_digest
    return {compute_fork_digest(chain.spec.fork_version(f),
                                chain.genesis_validators_root): f
            for f in ForkName}


def encode_block(signed_block, chain) -> str:
    """fork-digest context (4B) + SSZ, as one response chunk payload."""
    from ...specs.chain_spec import compute_fork_digest
    digest = compute_fork_digest(
        chain.spec.fork_version(signed_block.fork_name),
        chain.genesis_validators_root)
    return (digest
            + serialize(type(signed_block).ssz_type, signed_block)).hex()
