"""Range sync: finalized/head syncing chains with per-chain peer pools.

Equivalent of the reference's range sync (network/src/sync/range_sync/
{range.rs,chain.rs,chain_collection.rs}): peers whose STATUS is ahead of
the local chain are grouped into *chains* keyed by their claimed target
(finalized root for finalized sync, head root for head sync).  One chain
syncs at a time — finalized chains take priority and the best chain is the
one with the most peers.  Each chain pipelines up to BATCH_BUFFER
epoch-aligned batches from its pool, imports them strictly in slot order,
attributes processing failures to the serving peer, retries from other
peers, and fails the chain (penalizing its pool) after bounded attempts.

The machine is synchronous and network-agnostic: it emits requests through
a context object (`ctx.send_range(peer, start, count, owner)`) and consumes
`on_range_response` / `on_download_error` / local processing results — the
test suite drives it with synthetic events exactly like the reference's
sync tests (network/src/sync/block_lookups/tests.rs style).
"""
from __future__ import annotations

import sys

from ...chain.errors import PARENT_UNKNOWN
from .batches import Batch, BatchState
from .validation import validate_range_batch

EPOCHS_PER_BATCH = 2


def _count(name: str, amount: float = 1) -> None:
    """Catalog counter, sys.modules-gated (synthetic-event tests drive
    the machines without the metrics stack).  getattr-guarded so a
    module still mid-import reads as absent."""
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    count = getattr(md, "count", None)
    if count is not None:
        count(name, amount)


class SyncingChain:
    BATCH_BUFFER = 5          # in-flight batches beyond the processing head
    # a pool whose every batch comes back empty while nothing imports is
    # lying about its target (a fake-ahead STATUS): fail fast instead of
    # walking millions of empty slots toward a fabricated head
    MAX_CONSEC_EMPTY = 8

    def __init__(self, chain_id: int, kind: str, target_root: bytes,
                 target_slot: int, start_slot: int, batch_slots: int,
                 ctx=None):
        assert kind in ("finalized", "head")
        self.ctx = ctx
        self.id = chain_id
        self.kind = kind
        self.target_root = target_root
        self.target_slot = target_slot
        self.start_slot = start_slot          # first slot to download
        self.batch_slots = batch_slots
        self.peers: set[str] = set()
        self.batches: dict[int, Batch] = {}   # batch_id -> Batch
        self.next_batch_id = 0                # next batch to create
        self.process_ptr = 0                  # next batch to process in order
        self.imported = 0
        self.failed = False
        self.complete = False
        # req_id -> batch_id for in-flight downloads
        self.requests: dict[int, int] = {}
        self._consec_empty = 0
        # batch_id -> root of the last *processed* block at/below that
        # batch's end (empty batches inherit the tail below them); feeds
        # the download-time continuity check
        self._tail_roots: dict[int, bytes] = {}

    # -- pool ----------------------------------------------------------------

    def add_peer(self, peer_id: str) -> None:
        self.peers.add(peer_id)

    def remove_peer(self, peer_id: str) -> None:
        self.peers.discard(peer_id)

    @property
    def available_peers(self) -> list[str]:
        busy = {b.peer for b in self.batches.values()
                if b.state == BatchState.DOWNLOADING}
        return sorted(self.peers - busy)

    # -- batch creation / scheduling ----------------------------------------

    def _batch_start(self, batch_id: int) -> int:
        return self.start_slot + batch_id * self.batch_slots

    def _total_batches(self) -> int:
        span = self.target_slot - self.start_slot + 1
        return max(0, -(-span // self.batch_slots))

    def request_batches(self, ctx=None) -> None:
        """Create/dispatch downloads up to BATCH_BUFFER beyond the
        processing pointer, one per available pool peer."""
        ctx = ctx if ctx is not None else self.ctx
        if self.failed or self.complete:
            return
        total = self._total_batches()
        # instantiate lazily
        while (self.next_batch_id < total
               and self.next_batch_id < self.process_ptr + self.BATCH_BUFFER):
            bid = self.next_batch_id
            start = self._batch_start(bid)
            count = min(self.batch_slots, self.target_slot - start + 1)
            self.batches[bid] = Batch(bid, start, count)
            self.next_batch_id += 1
        for bid in sorted(self.batches):
            batch = self.batches[bid]
            if batch.state != BatchState.AWAITING_DOWNLOAD:
                continue
            pool = self.available_peers
            fresh = [p for p in pool if p not in batch.attempted_peers]
            # rotate seeded on (attempt, batch id) so a deterministic
            # fresh[0] can't hand every retry to the same failed peer
            salt = batch.download_attempts + batch.id
            if fresh:
                peer = fresh[salt % len(fresh)]
            elif self.peers - batch.attempted_peers:
                continue                    # a fresh peer exists but is busy:
                                            # defer rather than re-ask a
                                            # peer that already failed this
            else:
                peer = batch.pick_peer(pool, salt=salt)
                if peer is None:
                    return                  # no free peers right now
            req_id = ctx.send_range(peer, batch.start_slot, batch.count, self)
            batch.start_download(peer, req_id)
            self.requests[req_id] = bid

    # -- event handlers ------------------------------------------------------

    def on_range_response(self, req_id: int, blocks: list | None,
                          ctx=None, reason: str = "timeout") -> None:
        """blocks=None means the download failed; `reason` says why
        (timeout/stall/peer_gone/decode_error/shutdown) and picks the
        penalty weight — "shutdown" is our own close path and carries
        none."""
        ctx = ctx if ctx is not None else self.ctx
        bid = self.requests.pop(req_id, None)
        if bid is None:
            return                          # stale response for a dropped req
        batch = self.batches[bid]
        if blocks is None:
            ctx.penalize(batch.peer, reason)
            if batch.download_failed() == BatchState.FAILED:
                self._fail(ctx)
                return
        elif not self._validate_download(ctx, batch, blocks):
            return
        else:
            _count("sync_range_batches_downloaded_total")
            batch.downloaded(blocks)
        self._process_ready(ctx)
        self.request_batches(ctx)

    def _validate_download(self, ctx, batch, blocks) -> bool:
        """Download-time structural validation (validation.py): a junk /
        wrong-range / miscounted response is charged `bad_segment` in
        O(batch) and never reaches process_segment.  A continuity break
        against an already-processed previous batch is the *previous*
        batch's truncated tail (this response already proved internally
        linked): roll that batch back instead of blaming this peer.
        Returns True when the caller should accept the download."""
        prev_tail = self._tail_roots.get(batch.id - 1)
        res = validate_range_batch(
            blocks, batch.start_slot, batch.count,
            block_root=ctx.block_root, prev_tail_root=prev_tail)
        if res.ok:
            return True
        note = getattr(ctx, "note_validation_reject", None)
        if res.reason == "continuity" and batch.id > 0:
            prev = self.batches.get(batch.id - 1)
            if (prev is not None and prev.state == BatchState.PROCESSED
                    and prev.peer is not None):
                if note is not None:
                    note(prev.peer, prev.start_slot, prev.count,
                         "continuity")
                ctx.penalize(prev.peer, "truncated_batch")
                self._rollback_processed(prev)
                _count("sync_range_batches_downloaded_total")
                batch.downloaded(blocks)    # this response stands
                self.request_batches(ctx)
                return False
        _count("sync_batch_validation_rejects_total")
        if note is not None:
            note(batch.peer, batch.start_slot, batch.count, res.reason)
        ctx.penalize(batch.peer, "bad_segment")
        if batch.download_failed() == BatchState.FAILED:
            self._fail(ctx)
            return False
        self.request_batches(ctx)
        return False

    def _rollback_processed(self, prev: Batch) -> None:
        """Re-download an already-processed batch whose tail proved
        truncated, preserving its attempt bookkeeping."""
        redo = Batch(prev.id, prev.start_slot, prev.count)
        redo.processing_attempts = prev.processing_attempts
        redo.attempted_peers = set(prev.attempted_peers)
        self.batches[prev.id] = redo
        self._tail_roots.pop(prev.id, None)
        self.process_ptr = min(self.process_ptr, prev.id)

    def _process_ready(self, ctx) -> None:
        """Import batches strictly in order while the frontier is ready."""
        while not self.failed and not self.complete:
            batch = self.batches.get(self.process_ptr)
            if batch is None or batch.state != BatchState.AWAITING_PROCESSING:
                return
            blocks = batch.start_processing()
            imported, err = ctx.process_segment(blocks) if blocks else (0, None)
            if err is None:
                self.imported += imported
                if imported:
                    _count("sync_range_blocks_imported_total", imported)
                if blocks:
                    self._consec_empty = 0
                    self._tail_roots[batch.id] = ctx.block_root(blocks[-1])
                else:
                    self._consec_empty += 1
                    tail = self._tail_roots.get(batch.id - 1)
                    if tail is not None:
                        self._tail_roots[batch.id] = tail
                batch.processed()
                self.process_ptr += 1
                if (self.imported == 0
                        and self._consec_empty >= self.MAX_CONSEC_EMPTY):
                    # every batch empty, nothing imported: the pool's
                    # claimed target is a fabrication (lying STATUS) —
                    # fail fast instead of draining it to the fake head
                    self.failed = True
                    for p in sorted(self.peers):
                        ctx.penalize(p, "empty_batch")
                    return
                if self.process_ptr >= self._total_batches():
                    self._finish(ctx)
                    return
            elif err == PARENT_UNKNOWN and self.process_ptr > 0:
                # download-time validation proved this batch internally
                # linked and in-range, so an unknown parent at its head
                # pins the gap on the PREVIOUS batch's truncated tail:
                # roll back and re-download batch k-1 with precise blame
                # (range_sync/chain.rs re-downloads the prior batch)
                prev = self.batches[self.process_ptr - 1]
                if prev.peer is not None:
                    ctx.penalize(prev.peer, "truncated_batch")
                if prev.processing_attempts >= Batch.MAX_PROCESSING_ATTEMPTS:
                    self._fail(ctx)
                    return
                redo = Batch(prev.id, prev.start_slot, prev.count)
                redo.processing_attempts = prev.processing_attempts
                redo.attempted_peers = set(prev.attempted_peers)
                self.batches[prev.id] = redo
                self._tail_roots.pop(prev.id, None)
                batch.state = BatchState.AWAITING_PROCESSING  # retry after
                self.process_ptr -= 1
                self.request_batches(ctx)
                return
            else:
                # the serving peer gave us an unusable segment
                ctx.penalize(batch.peer, "bad_segment")
                if batch.processing_failed() == BatchState.FAILED:
                    self._fail(ctx)
                    return
                self.request_batches(ctx)
                return                      # wait for the re-download

    def _finish(self, ctx) -> None:
        """All batches processed.  An entirely-empty chain whose peers all
        claimed a higher head is a lie — penalize the pool.  But if the
        local head advanced past our start while we synced (gossip imports
        make process_segment return 0 for known blocks), the peers were
        honest and the work just raced."""
        self.complete = True
        if self.imported == 0 and ctx.local_status()[0] < self.start_slot:
            for p in sorted(self.peers):
                ctx.penalize(p, "empty_batch")

    def _fail(self, ctx) -> None:
        self.failed = True
        for p in sorted(self.peers):
            ctx.penalize(p, "ignore")

    @property
    def in_flight(self) -> int:
        return len(self.requests)


class RangeSync:
    """Chain collection: groups STATUS-ahead peers into chains, syncs the
    best one (finalized > head, then most peers), drops completed/failed
    chains (chain_collection.rs behavior)."""

    def __init__(self, ctx, batch_slots: int | None = None):
        self.ctx = ctx
        self.chains: dict[tuple, SyncingChain] = {}
        self.retired: set[tuple] = set()   # completed targets
        # failed target -> the pool that failed it.  A FAILED target is
        # only dead to the peers that failed to serve it: a byzantine
        # pool must not be able to poison a real target for honest peers
        # that show up later.  Completed targets stay retired
        # for everyone — a stale STATUS can't resurrect them.
        self.failed_from: dict[tuple, set[str]] = {}
        self._next_chain_id = 0
        self.batch_slots = batch_slots or (
            EPOCHS_PER_BATCH * ctx.slots_per_epoch())

    # -- peer intake ---------------------------------------------------------

    def add_peer(self, peer_id: str, status) -> None:
        """Classify the peer by its STATUS against our local view: a
        finalized-ahead peer joins a finalized chain; once that target is
        retired (synced or proven bad) a still-head-ahead peer falls
        through to a head chain (our own finality may lag the imported
        blocks' epoch processing)."""
        local_head, local_fin_epoch = self.ctx.local_status()
        spe = self.ctx.slots_per_epoch()
        candidates = []
        if status.finalized_epoch > local_fin_epoch:
            candidates.append(("finalized", status.finalized_root,
                               status.finalized_epoch * spe))
        if status.head_slot > local_head:
            candidates.append(("head", status.head_root, status.head_slot))
        for key in candidates:
            if key in self.retired or key[2] <= local_head:
                continue
            if peer_id in self.failed_from.get(key, ()):
                continue   # this peer already failed to serve this target
            chain = self.chains.get(key)
            if chain is not None and (chain.failed or chain.complete):
                # purge hasn't run yet — retire the dead chain here so
                # the new peer never lands in a failed pool's blame set
                if chain.complete:
                    self.retired.add(key)
                else:
                    self.failed_from.setdefault(key, set()) \
                        .update(chain.peers)
                del self.chains[key]
                if key in self.retired \
                        or peer_id in self.failed_from.get(key, ()):
                    continue
                chain = None
            if chain is None:
                chain = SyncingChain(
                    self._next_chain_id, key[0], key[1], key[2],
                    start_slot=local_head + 1,
                    batch_slots=self.batch_slots, ctx=self.ctx)
                self._next_chain_id += 1
                self.chains[key] = chain
            chain.add_peer(peer_id)
            return

    def remove_peer(self, peer_id: str) -> None:
        for chain in self.chains.values():
            chain.remove_peer(peer_id)

    # -- scheduling ----------------------------------------------------------

    def best_chain(self) -> SyncingChain | None:
        """Finalized chains beat head chains; more peers beats fewer —
        purging dead chains first.  Completed targets are retired for
        everyone (a stale STATUS can't resurrect them); failed targets
        are retired only from the pool that failed them, so honest
        peers arriving later can still serve the same target."""
        self.retired |= {k for k, c in self.chains.items() if c.complete}
        for k, c in self.chains.items():
            if c.failed and not c.complete:
                self.failed_from.setdefault(k, set()).update(c.peers)
        self.chains = {k: c for k, c in self.chains.items()
                       if not c.failed and not c.complete and c.peers}
        ranked = sorted(
            self.chains.values(),
            key=lambda c: (c.kind != "finalized", -len(c.peers), c.id))
        return ranked[0] if ranked else None

    def drive(self) -> SyncingChain | None:
        """Dispatch requests on the currently-best chain."""
        chain = self.best_chain()
        if chain is not None:
            chain.request_batches(self.ctx)
        return chain

    def on_range_response(self, req_id: int, blocks: list | None,
                          reason: str = "timeout") -> None:
        for chain in list(self.chains.values()):
            if req_id in chain.requests:
                chain.on_range_response(req_id, blocks, self.ctx,
                                        reason=reason)
                return

    @property
    def syncing(self) -> bool:
        return any(c.in_flight or (not c.complete and not c.failed
                                   and c.peers)
                   for c in self.chains.values())
