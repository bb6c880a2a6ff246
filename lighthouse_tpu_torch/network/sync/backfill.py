"""Backfill sync: download history backwards from a checkpoint anchor.

Equivalent of the reference's backfill machine (network/src/sync/
backfill_sync/mod.rs): after checkpoint sync the node holds [anchor, head]
and must recover [genesis, anchor) — batches walk DOWN from the anchor and
every received block must hash-link into the trusted chain
(`expected_root`), which subsumes signature verification the way the
reference's `historical_blocks.rs` chain-linkage does.

Batch downloads pipeline in parallel (fixed descending windows) but are
*verified* strictly newest-first, because linkage is only checkable against
the already-verified chain above.  Empty windows are legitimate (runs of
skipped slots) but an all-empty history down to genesis — which must
contain the genesis block — or an endless run of empty claims is
misbehavior: the peer is penalized and the machine stops (the caller
rotates peers on the next drive).
"""
from __future__ import annotations

import sys

from .batches import Batch, BatchState
from .validation import validate_range_batch


def _count(name: str, amount: float = 1) -> None:
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    count = getattr(md, "count", None)
    if count is not None:
        count(name, amount)


class BackfillSync:
    MAX_EMPTY_WINDOWS = 64
    BATCH_BUFFER = 4

    def __init__(self, ctx, batch_slots: int | None = None):
        self.ctx = ctx
        self.batch_slots = batch_slots or (
            2 * ctx.slots_per_epoch())
        self.batches: dict[int, Batch] = {}
        self.requests: dict[int, int] = {}
        self.next_batch_id = 0
        self.process_ptr = 0
        self.stored = 0
        self.empty_windows = 0
        self.stopped = False
        # [window_low, window_high) spans, high -> low as batch ids grow
        self._spans: dict[int, tuple[int, int]] = {}
        self._req_end: int | None = None      # exclusive top of next window
        # (batch_id, peer) that last advanced the anchor, for fault
        # attribution when the NEXT batch's top block fails to link: a
        # peer that truncated its window's lower edge still hash-links
        # and advances the anchor, leaving the gap inside ITS span
        self._advanced_by: tuple[int, str] | None = None
        self._rewindowed = False              # one re-window per advance

    # -- scheduling ----------------------------------------------------------

    def _anchor(self):
        return self.ctx.backfill_anchor()

    def drive(self, peers: list[str]) -> None:
        """Create/dispatch descending windows to the peer pool."""
        if self.stopped:
            return
        anchor = self._anchor()
        if anchor is None or anchor[0] == 0:
            return
        if self._req_end is None:
            self._req_end = anchor[0]
        cap = self.ctx.max_request_blocks()
        window = min(self.batch_slots, cap)
        while (self._req_end > 0
               and self.next_batch_id < self.process_ptr + self.BATCH_BUFFER):
            high = self._req_end
            low = max(0, high - window)
            bid = self.next_batch_id
            self.batches[bid] = Batch(bid, low, high - low)
            self._spans[bid] = (low, high)
            self.next_batch_id += 1
            self._req_end = low
        for bid in sorted(self.batches):
            batch = self.batches[bid]
            if batch.state != BatchState.AWAITING_DOWNLOAD:
                continue
            busy = {b.peer for b in self.batches.values()
                    if b.state == BatchState.DOWNLOADING}
            pool = [p for p in peers if p not in busy]
            peer = batch.pick_peer(
                pool, salt=batch.download_attempts + batch.id)
            if peer is None:
                return
            req_id = self.ctx.send_range(peer, batch.start_slot, batch.count,
                                         self)
            batch.start_download(peer, req_id)
            self.requests[req_id] = bid

    # -- events --------------------------------------------------------------

    def on_range_response(self, req_id: int, blocks: list | None,
                          reason: str = "timeout") -> None:
        bid = self.requests.pop(req_id, None)
        if bid is None:
            return
        batch = self.batches[bid]
        if blocks is None:
            if reason != "shutdown":        # our close path: no penalty
                self.ctx.penalize(batch.peer, reason)
            if batch.download_failed() == BatchState.FAILED:
                self.stopped = True
            return
        # download-time structural validation: a wrong-range / reordered
        # / miscounted response never reaches the anchor-linkage stage
        # (which could otherwise mis-advance the anchor on junk)
        res = validate_range_batch(blocks, batch.start_slot, batch.count,
                                   block_root=self.ctx.block_root)
        if not res.ok:
            _count("sync_batch_validation_rejects_total")
            note = getattr(self.ctx, "note_validation_reject", None)
            if note is not None:
                note(batch.peer, batch.start_slot, batch.count, res.reason)
            self.ctx.penalize(batch.peer, "bad_segment")
            if batch.download_failed() == BatchState.FAILED:
                self.stopped = True
            return
        batch.downloaded(blocks)
        self._process_ready()

    def _process_ready(self) -> None:
        """Link-verify batches newest-first into the trusted anchor."""
        while not self.stopped:
            batch = self.batches.get(self.process_ptr)
            if batch is None or batch.state != BatchState.AWAITING_PROCESSING:
                return
            blocks = batch.start_processing()
            anchor = self._anchor()
            if anchor is None:
                self.stopped = True
                return
            _, expected_root = anchor
            ok = True
            pairs = []
            for sb in reversed(blocks):
                root = self.ctx.block_root(sb)
                if root != expected_root:
                    ok = False
                    break
                pairs.append((root, sb))
                expected_root = sb.message.parent_root
            # the linked prefix lands as ONE atomic hot batch (graftflow)
            # — per-block stores remain for bare test contexts
            store_batch = getattr(self.ctx, "store_backfill_batch", None)
            if store_batch is not None:
                store_batch(pairs)
            else:
                for root, sb in pairs:
                    self.ctx.store_backfill_block(root, sb)
            stored_here = len(pairs)
            if not ok:
                if (stored_here == 0 and self._advanced_by is not None
                        and self._advanced_by[0] != batch.id
                        and not self._rewindowed):
                    # nothing in THIS batch linked: either the batch that
                    # advanced the anchor truncated its lower edge (gap in
                    # ITS span) or this batch is garbage.  Blame is
                    # ambiguous, so — like range_sync's previous-batch
                    # PARENT_UNKNOWN rollback — penalize BOTH peers, then
                    # re-window from the stored anchor so a truncated span
                    # gets re-downloaded.
                    self.ctx.penalize(self._advanced_by[1],
                                      "truncated_batch")
                    # intermediate batches that claimed EMPTY windows are
                    # equally suspect (a falsely-empty claim produces the
                    # same signature); penalize every peer in the
                    # ambiguous span so a liar can't hide behind honest
                    # neighbours
                    blamed = {self._advanced_by[1]}
                    for mid in range(self._advanced_by[0] + 1, batch.id + 1):
                        b = self.batches.get(mid)
                        if b is not None and b.peer is not None \
                                and b.peer not in blamed:
                            blamed.add(b.peer)
                            self.ctx.penalize(b.peer, "bad_segment")
                    self._rewindow()
                    return
                self.ctx.penalize(batch.peer, "bad_segment")
                if batch.processing_failed() == BatchState.FAILED:
                    self.stopped = True
                return
            if blocks:
                self.empty_windows = 0
                self.stored += stored_here
                self._advanced_by = (batch.id, batch.peer)
                self._rewindowed = False
                new_anchor = blocks[0].message.slot
                self.ctx.set_backfill_anchor(new_anchor, expected_root)
                if new_anchor == 0:
                    self.stopped = True       # reached the genesis block
                    return
            else:
                low, _high = self._spans[batch.id]
                self.empty_windows += 1
                if low == 0 or self.empty_windows > self.MAX_EMPTY_WINDOWS:
                    # an empty [0, x) claims there is no genesis block
                    self.ctx.penalize(batch.peer, "empty_batch")
                    self.stopped = True
                    return
            batch.processed()
            _count("sync_backfill_batches_total")
            self.process_ptr += 1

    def _rewindow(self) -> None:
        """Drop all windows (incl. in-flight) and restart from the stored
        anchor, so a span truncated by a lying peer gets re-downloaded."""
        anchor = self._anchor()
        self.batches.clear()
        self._spans.clear()
        self.requests.clear()         # stale responses are ignored
        self.process_ptr = self.next_batch_id
        self._req_end = anchor[0] if anchor else None
        self._rewindowed = True
        # the re-downloaded span re-serves the same legitimately-empty
        # windows; counting them twice could falsely trip
        # MAX_EMPTY_WINDOWS and stop an honest backfill
        self.empty_windows = 0

    @property
    def in_flight(self) -> int:
        return len(self.requests)

    @property
    def complete(self) -> bool:
        anchor = self._anchor()
        return anchor is None or anchor[0] == 0
