"""Synthetic-event tests for the sync state machines.

Style of the reference's sync tests (network/src/sync/block_lookups/
tests.rs, 2,395 LoC driven by fake RpcEvents): no network, no chain — a
fake context records every request the machines emit and the test injects
responses/errors, asserting state transitions, retry/ban behavior, peer
attribution, chain selection, and depth limits.

The same cases as the JAX package's tests/test_sync_machines.py, run on the port
(imports switched to lighthouse_tpu_torch).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import pytest

from lighthouse_tpu_torch.chain.errors import PARENT_UNKNOWN
from lighthouse_tpu_torch.network.sync.backfill import BackfillSync
from lighthouse_tpu_torch.network.sync.batches import Batch, BatchState
from lighthouse_tpu_torch.network.sync.lookups import BlockLookups, Lookup
from lighthouse_tpu_torch.network.sync.manager import (
    PeerBackoff, _RealSyncContext,
)
from lighthouse_tpu_torch.network.sync.range_sync import RangeSync, SyncingChain


# ---------------------------------------------------------------------------
# fakes
# ---------------------------------------------------------------------------

@dataclass
class FakeBlockMsg:
    slot: int
    parent_root: bytes


@dataclass
class FakeBlock:
    root: bytes
    message: FakeBlockMsg


def mk_chain_blocks(start_slot, n, prefix=b"blk"):
    """A hash-linked run of fake blocks starting at start_slot."""
    blocks = []
    parent = b"genesis".ljust(32, b"\0")
    for i in range(n):
        root = (prefix + str(start_slot + i).encode()).ljust(32, b"\0")
        blocks.append(FakeBlock(root, FakeBlockMsg(start_slot + i, parent)))
        parent = root
    return blocks


@dataclass
class FakeStatus:
    finalized_root: bytes
    finalized_epoch: int
    head_root: bytes
    head_slot: int


class FakeCtx:
    """Records requests; test injects results via the owners directly."""

    def __init__(self, spe=8, head_slot=0, fin_epoch=0):
        self.spe = spe
        self.head_slot = head_slot
        self.fin_epoch = fin_epoch
        self.sent = []                # (req_id, peer, start, count)
        self.root_reqs = []           # (req_id, peer, root)
        self.penalties = []           # (peer, reason)
        self.process_results = []     # queue of (imported, err) to return
        self.processed = []           # segments passed to process_segment
        self.known = set()            # known block roots
        self.anchor = None            # backfill anchor
        self.stored = []              # backfill stored blocks
        self.lookup_imports = []
        self.pre_finalized = []       # roots noted pre-finalization
        self._next = 0

    # chain views
    def slots_per_epoch(self):
        return self.spe

    def max_request_blocks(self):
        return 1024

    def local_status(self):
        return self.head_slot, self.fin_epoch

    def block_known(self, root):
        return root in self.known

    def block_root(self, b):
        return b.root

    def process_segment(self, blocks):
        self.processed.append(list(blocks))
        if self.process_results:
            return self.process_results.pop(0)
        return len(blocks), None

    def penalize(self, peer, reason):
        self.penalties.append((peer, reason))

    def on_lookup_imported(self, root):
        self.lookup_imports.append(root)

    def finalized_slot(self):
        return self.fin_epoch * self.spe

    def note_pre_finalization(self, root):
        self.pre_finalized.append(root)

    # backfill hooks
    def backfill_anchor(self):
        return self.anchor

    def set_backfill_anchor(self, slot, root):
        self.anchor = (slot, root)

    def store_backfill_block(self, root, sb):
        self.stored.append((root, sb))

    # request IO
    def send_range(self, peer, start, count, owner):
        rid = self._next
        self._next += 1
        self.sent.append((rid, peer, start, count))
        return rid

    def send_root(self, peer, root, owner):
        rid = self._next
        self._next += 1
        self.root_reqs.append((rid, peer, root))
        return rid


def status_ahead(fin_epoch=2, head_slot=40):
    return FakeStatus(b"fin".ljust(32, b"\0"), fin_epoch,
                      b"head".ljust(32, b"\0"), head_slot)


# ---------------------------------------------------------------------------
# Batch state machine
# ---------------------------------------------------------------------------

def test_batch_lifecycle_happy_path():
    b = Batch(0, 8, 16)
    assert b.state == BatchState.AWAITING_DOWNLOAD
    b.start_download("p1", 7)
    assert b.state == BatchState.DOWNLOADING
    b.downloaded(["blk"])
    assert b.state == BatchState.AWAITING_PROCESSING
    assert b.start_processing() == ["blk"]
    b.processed()
    assert b.state == BatchState.PROCESSED


def test_batch_download_retries_then_fails():
    b = Batch(0, 8, 16)
    for i in range(Batch.MAX_DOWNLOAD_ATTEMPTS - 1):
        b.start_download(f"p{i}", i)
        assert b.download_failed() == BatchState.AWAITING_DOWNLOAD
    b.start_download("px", 99)
    assert b.download_failed() == BatchState.FAILED


def test_batch_prefers_fresh_peer_on_retry():
    b = Batch(0, 8, 16)
    b.start_download("p1", 0)
    b.download_failed()
    assert b.pick_peer(["p1", "p2"]) == "p2"
    # pool exhausted -> falls back to an attempted peer
    assert b.pick_peer(["p1"]) == "p1"


def test_batch_pick_peer_salt_rotates_the_choice():
    """A deterministic pool[0] pick would hand every retry to the same
    failed peer; the salt must rotate through both fresh peers and (once
    exhausted) the whole pool."""
    b = Batch(3, 8, 16)
    pool = ["p0", "p1", "p2"]
    assert {b.pick_peer(pool, salt=s) for s in range(3)} == set(pool)
    for p in pool:
        b.attempted_peers.add(p)
    assert {b.pick_peer(pool, salt=s) for s in range(3)} == set(pool)
    assert b.pick_peer([], salt=7) is None


def test_batch_processing_exhaustion_fails_at_exact_cap():
    b = Batch(0, 8, 16)
    for i in range(Batch.MAX_PROCESSING_ATTEMPTS):
        b.start_download(f"p{i}", i)
        b.downloaded(["blk"])
        b.start_processing()
        expect = (BatchState.FAILED
                  if i == Batch.MAX_PROCESSING_ATTEMPTS - 1
                  else BatchState.AWAITING_DOWNLOAD)
        assert b.processing_failed() == expect
    assert b.state == BatchState.FAILED


def test_batch_illegal_transitions_assert():
    b = Batch(0, 8, 16)
    with pytest.raises(AssertionError):
        b.downloaded(["blk"])                  # not downloading yet
    with pytest.raises(AssertionError):
        b.start_processing()                   # nothing downloaded
    b.start_download("p1", 0)
    with pytest.raises(AssertionError):
        b.start_download("p2", 1)              # already in flight
    b.downloaded(["blk"])
    with pytest.raises(AssertionError):
        b.download_failed()                    # download already done
    b.start_processing()
    b.processed()
    with pytest.raises(AssertionError):
        b.processing_failed()                  # already processed


# ---------------------------------------------------------------------------
# Range sync: chain selection
# ---------------------------------------------------------------------------

def test_range_groups_peers_into_chains_by_target():
    ctx = FakeCtx(spe=8, head_slot=0, fin_epoch=0)
    rs = RangeSync(ctx)
    st = status_ahead(fin_epoch=2, head_slot=40)
    rs.add_peer("p1", st)
    rs.add_peer("p2", st)
    other = FakeStatus(b"fin2".ljust(32, b"\0"), 3, b"h2".ljust(32, b"\0"), 50)
    rs.add_peer("p3", other)
    assert len(rs.chains) == 2
    best = rs.best_chain()
    assert len(best.peers) == 2        # most-peers chain wins
    assert best.kind == "finalized"


def test_range_finalized_chain_beats_bigger_head_chain():
    ctx = FakeCtx(spe=8, head_slot=0, fin_epoch=1)
    rs = RangeSync(ctx)
    # two peers only ahead on head (same finalized)
    head_st = FakeStatus(b"f".ljust(32, b"\0"), 1, b"h".ljust(32, b"\0"), 60)
    rs.add_peer("h1", head_st)
    rs.add_peer("h2", head_st)
    fin_st = status_ahead(fin_epoch=4, head_slot=60)
    rs.add_peer("f1", fin_st)
    best = rs.best_chain()
    assert best.kind == "finalized" and best.peers == {"f1"}


def test_range_peer_not_ahead_is_ignored():
    ctx = FakeCtx(spe=8, head_slot=50, fin_epoch=5)
    rs = RangeSync(ctx)
    rs.add_peer("p1", status_ahead(fin_epoch=2, head_slot=40))
    assert rs.chains == {}


def test_range_chain_switch_when_better_target_appears():
    """A new finalized chain gathering more peers takes over scheduling."""
    ctx = FakeCtx(spe=8, head_slot=0, fin_epoch=0)
    rs = RangeSync(ctx)
    rs.add_peer("p1", status_ahead(fin_epoch=2, head_slot=40))
    first = rs.drive()
    assert first is not None and ctx.sent
    st2 = FakeStatus(b"better".ljust(32, b"\0"), 6, b"h".ljust(32, b"\0"), 99)
    rs.add_peer("q1", st2)
    rs.add_peer("q2", st2)
    second = rs.best_chain()
    assert second is not first and second.target_slot == 6 * 8
    # the old chain's in-flight response is still routed to it
    rid = ctx.sent[0][0]
    rs.on_range_response(rid, [])
    assert first.batches[0].state == BatchState.PROCESSED


# ---------------------------------------------------------------------------
# Range sync: batch pipelining + retry + malicious batches
# ---------------------------------------------------------------------------

def mk_synced_chain(ctx, n_peers=3, target_slot=47):
    rs = RangeSync(ctx)
    st = status_ahead(fin_epoch=(target_slot + 1) // 8, head_slot=target_slot)
    for i in range(n_peers):
        rs.add_peer(f"p{i}", st)
    chain = rs.drive()
    return rs, chain


def test_chain_pipelines_batches_across_pool():
    ctx = FakeCtx(spe=8)
    rs, chain = mk_synced_chain(ctx, n_peers=3, target_slot=47)
    # 48 slots / 16-slot batches = 3 batches, one per peer in parallel
    assert len(ctx.sent) == 3
    peers_used = {p for _, p, _, _ in ctx.sent}
    assert len(peers_used) == 3
    spans = [(s, c) for _, _, s, c in ctx.sent]
    assert spans == [(1, 16), (17, 16), (33, 16)]


def test_chain_imports_in_order_despite_out_of_order_responses():
    ctx = FakeCtx(spe=8)
    rs, chain = mk_synced_chain(ctx, n_peers=3, target_slot=47)
    reqs = {bid: rid for rid, (bid) in
            [(rid, chain.requests[rid]) for rid in list(chain.requests)]}
    blocks1 = mk_chain_blocks(17, 3)
    rs.on_range_response(reqs[1], blocks1)     # middle batch arrives first
    assert ctx.processed == []                 # can't process out of order
    blocks0 = mk_chain_blocks(1, 4)
    rs.on_range_response(reqs[0], blocks0)
    assert ctx.processed == [blocks0, blocks1]  # both drained in order
    rs.on_range_response(reqs[2], [])
    assert chain.complete and chain.imported == 7


def test_download_error_retries_on_different_peer():
    ctx = FakeCtx(spe=8)
    rs, chain = mk_synced_chain(ctx, n_peers=2, target_slot=31)
    (rid0, peer0, _, _) = ctx.sent[0]
    (rid1, peer1, _, _) = ctx.sent[1]
    rs.on_range_response(rid0, None)           # download failed
    assert ("timeout" in [r for p, r in ctx.penalties if p == peer0])
    # the retry DEFERS while the only fresh peer (peer1) is busy...
    assert chain.batches[0].state == BatchState.AWAITING_DOWNLOAD
    # ...and dispatches to it as soon as it frees up
    rs.on_range_response(rid1, mk_chain_blocks(17, 2))
    retry = [(r, p, s, c) for r, p, s, c in ctx.sent[2:] if s == 1]
    assert retry and retry[0][1] == peer1


def test_malicious_batch_penalized_and_retried_elsewhere():
    ctx = FakeCtx(spe=8)
    rs, chain = mk_synced_chain(ctx, n_peers=2, target_slot=31)
    (rid0, peer0, _, _) = ctx.sent[0]
    (rid1, peer1, _, _) = ctx.sent[1]
    ctx.process_results.append((0, "bad_signature"))
    rs.on_range_response(rid0, mk_chain_blocks(1, 4, b"evil"))
    assert (peer0, "bad_segment") in ctx.penalties
    b0 = chain.batches[0]
    # free the honest peer; the bad batch re-downloads from it
    rs.on_range_response(rid1, mk_chain_blocks(17, 2))
    assert b0.state == BatchState.DOWNLOADING
    assert b0.peer == peer1
    rid_retry = b0.req_id
    rs.on_range_response(rid_retry, mk_chain_blocks(1, 4))
    assert b0.state == BatchState.PROCESSED


def test_chain_fails_after_repeated_bad_batches():
    ctx = FakeCtx(spe=8)
    rs, chain = mk_synced_chain(ctx, n_peers=2, target_slot=15)
    for _ in range(Batch.MAX_PROCESSING_ATTEMPTS):
        b0 = chain.batches[0]
        rid = b0.req_id
        ctx.process_results.append((0, "bad_signature"))
        rs.on_range_response(rid, mk_chain_blocks(1, 4, b"evil"))
    assert chain.failed
    assert rs.best_chain() is not chain        # dropped from the collection
    # pool peers all penalized on chain failure
    assert {p for p, r in ctx.penalties if r == "ignore"} == chain.peers


def test_all_empty_chain_penalizes_lying_pool():
    ctx = FakeCtx(spe=8)
    rs, chain = mk_synced_chain(ctx, n_peers=2, target_slot=31)
    for rid in list(chain.requests):
        rs.on_range_response(rid, [])
    assert chain.complete and chain.imported == 0
    assert {p for p, r in ctx.penalties if r == "empty_batch"} == chain.peers


def test_stale_response_after_chain_drop_is_ignored():
    ctx = FakeCtx(spe=8)
    rs, chain = mk_synced_chain(ctx, n_peers=1, target_slot=15)
    rid = ctx.sent[0][0]
    chain.requests.pop(rid)                    # simulate dropped request
    rs.on_range_response(rid, mk_chain_blocks(1, 4))
    assert ctx.processed == []


def test_download_failure_reason_selects_penalty():
    """The pump's failure classification rides through on_range_response
    and picks the penalty weight (reason-aware attribution)."""
    for reason in ("stall", "peer_gone", "decode_error", "timeout"):
        ctx = FakeCtx(spe=8)
        rs, chain = mk_synced_chain(ctx, n_peers=1, target_slot=15)
        rid, peer, _, _ = ctx.sent[0]
        rs.on_range_response(rid, None, reason=reason)
        assert (peer, reason) in ctx.penalties
    # "shutdown" is our own close path: the batch still fails over, but
    # real contexts drop the penalty (FakeCtx records it verbatim)


# ---------------------------------------------------------------------------
# Range sync: download-time validation + per-peer failed-target memory
# ---------------------------------------------------------------------------

def test_out_of_range_batch_rejected_before_processing():
    ctx = FakeCtx(spe=8)
    rs, chain = mk_synced_chain(ctx, n_peers=2, target_slot=31)
    rid0, peer0, _, _ = ctx.sent[0]
    junk = mk_chain_blocks(100, 4)             # real-looking, wrong range
    rs.on_range_response(rid0, junk)
    assert (peer0, "bad_segment") in ctx.penalties
    assert ctx.processed == []                 # never reached the chain
    assert chain.batches[0].state == BatchState.AWAITING_DOWNLOAD


def test_truncated_tail_blamed_on_previous_batch():
    """Batch k passes validation but breaks continuity against the
    PROCESSED batch k-1: blame (and roll back) k-1's truncated tail,
    accept k's response, and complete after an honest re-serve."""
    ctx = FakeCtx(spe=8)
    rs, chain = mk_synced_chain(ctx, n_peers=2, target_slot=31)
    blocks = mk_chain_blocks(1, 32)            # slots 1..32, hash-linked
    (rid0, peer0, _, _), (rid1, peer1, _, _) = ctx.sent[:2]
    rs.on_range_response(rid0, blocks[:12])    # [1,17) minus its tail
    assert chain.batches[0].state == BatchState.PROCESSED
    rs.on_range_response(rid1, blocks[16:32])  # [17,33), can't link
    assert (peer0, "truncated_batch") in ctx.penalties
    assert (peer1, "bad_segment") not in ctx.penalties
    assert chain.process_ptr == 0              # k-1 rolled back
    assert chain.batches[1].state == BatchState.AWAITING_PROCESSING
    redo = chain.batches[0]
    assert redo.state == BatchState.DOWNLOADING and redo.peer == peer1
    rs.on_range_response(redo.req_id, blocks[:16])
    assert chain.complete


def test_parent_unknown_rolls_back_previous_batch_with_blame():
    ctx = FakeCtx(spe=8)
    rs, chain = mk_synced_chain(ctx, n_peers=2, target_slot=31)
    blocks = mk_chain_blocks(1, 32)
    (rid0, peer0, _, _), (rid1, peer1, _, _) = ctx.sent[:2]
    rs.on_range_response(rid0, blocks[:16])
    # batch 1 passes download validation but the chain reports its
    # parent unknown at processing (k-1's tail lied deeper than roots)
    ctx.process_results.append((0, PARENT_UNKNOWN))
    rs.on_range_response(rid1, blocks[16:32])
    assert (peer0, "truncated_batch") in ctx.penalties
    assert chain.process_ptr == 0
    assert chain.batches[1].state == BatchState.AWAITING_PROCESSING
    assert chain.batches[0].state == BatchState.DOWNLOADING


def test_parent_unknown_exhaustion_fails_chain():
    ctx = FakeCtx(spe=8)
    rs, chain = mk_synced_chain(ctx, n_peers=2, target_slot=31)
    blocks = mk_chain_blocks(1, 32)
    (rid0, _, _, _), (rid1, _, _, _) = ctx.sent[:2]
    rs.on_range_response(rid0, blocks[:16])
    chain.batches[0].processing_attempts = Batch.MAX_PROCESSING_ATTEMPTS
    ctx.process_results.append((0, PARENT_UNKNOWN))
    rs.on_range_response(rid1, blocks[16:32])
    assert chain.failed


def test_failed_target_blocked_only_for_failed_pool():
    """A byzantine pool that fails a chain must not poison its
    target for honest peers that show up later."""
    ctx = FakeCtx(spe=8)
    rs = RangeSync(ctx)
    st = status_ahead(fin_epoch=2, head_slot=40)
    rs.add_peer("bad1", st)
    rs.add_peer("bad2", st)
    chain = rs.drive()
    fin_key = ("finalized", st.finalized_root, 16)
    assert fin_key in rs.chains
    chain.failed = True
    assert rs.best_chain() is None             # purged
    assert rs.failed_from[fin_key] == {"bad1", "bad2"}
    rs.add_peer("bad1", st)                    # falls through to head
    assert fin_key not in rs.chains
    rs.add_peer("fresh", st)                   # honest newcomer: re-forms
    assert fin_key in rs.chains
    assert rs.chains[fin_key].peers == {"fresh"}


def test_completed_target_retired_for_everyone():
    ctx = FakeCtx(spe=8)
    rs = RangeSync(ctx)
    st = status_ahead(fin_epoch=2, head_slot=40)
    rs.add_peer("p1", st)
    chain = rs.drive()
    fin_key = ("finalized", st.finalized_root, 16)
    chain.complete = True
    rs.best_chain()
    assert fin_key in rs.retired
    rs.add_peer("newcomer", st)                # stale STATUS for a done
    assert fin_key not in rs.chains            # target can't resurrect it


def test_stale_failed_chain_does_not_blame_newcomers():
    """add_peer may find a failed chain the lazy purge hasn't swept yet;
    the arriving peer must not be folded into that pool's blame set."""
    ctx = FakeCtx(spe=8)
    rs = RangeSync(ctx)
    st = status_ahead(fin_epoch=2, head_slot=40)
    rs.add_peer("bad1", st)
    chain = rs.drive()
    chain.failed = True                        # no best_chain() purge yet
    fin_key = ("finalized", st.finalized_root, 16)
    rs.add_peer("fresh", st)
    assert "fresh" not in rs.failed_from.get(fin_key, set())
    assert rs.chains[fin_key].peers == {"fresh"}


# ---------------------------------------------------------------------------
# PeerBackoff
# ---------------------------------------------------------------------------

def test_backoff_grows_exponentially_with_jitter_bounds():
    bo = PeerBackoff(seed=7)
    expected = [0.5, 1.0, 2.0, 4.0, 8.0, 8.0]  # BASE * 2^n capped at MAX
    for base in expected:
        d = bo.note_failure("p1")
        assert 0.5 * base <= d <= 1.5 * base
    assert bo.delay_remaining("p1") > 0.0
    assert bo.delay_remaining("other") == 0.0


def test_backoff_quarantines_at_exact_threshold():
    bo = PeerBackoff(seed=1)
    for _ in range(PeerBackoff.QUARANTINE_AFTER - 1):
        bo.note_failure("p1")
        assert not bo.quarantined("p1")
    bo.note_failure("p1")
    assert bo.quarantined("p1")
    assert not bo.quarantined("p2")


def test_backoff_success_clears_the_slate():
    bo = PeerBackoff(seed=1)
    for _ in range(PeerBackoff.QUARANTINE_AFTER):
        bo.note_failure("p1")
    assert bo.quarantined("p1")
    bo.note_success("p1")
    assert not bo.quarantined("p1")
    assert bo.delay_remaining("p1") == 0.0
    d = bo.note_failure("p1")                  # counter restarted
    assert d <= 1.5 * PeerBackoff.BASE_DELAY


def test_backoff_quarantine_expires():
    bo = PeerBackoff(seed=1)
    bo.QUARANTINE_SECS = 0.05                  # instance shadow
    for _ in range(PeerBackoff.QUARANTINE_AFTER):
        bo.note_failure("p1")
    assert bo.quarantined("p1")
    time.sleep(0.06)
    assert not bo.quarantined("p1")


# ---------------------------------------------------------------------------
# _RealSyncContext deadline pump (stub rpc, no network)
# ---------------------------------------------------------------------------

@dataclass
class _StubPeer:
    node_id: str


class _StubTransport:
    def __init__(self, peers):
        self.peers = {p: _StubPeer(p) for p in peers}


class _StubRpc:
    """Per-peer canned behavior: 'hang' sleeps past any deadline, 'empty'
    answers immediately, 'garbage' returns an undecodable payload."""

    def __init__(self, behaviors):
        self.behaviors = behaviors
        self.transport = _StubTransport(list(behaviors))

    def request(self, peer, protocol, payload, timeout=None):
        kind = self.behaviors[peer.node_id]
        if kind == "hang":
            time.sleep(1.0)
            return []
        if kind == "garbage":
            return ["zz-not-hex"]
        return []


class _StubPeerManager:
    def __init__(self):
        self.reports = []

    def report(self, node_id, event):
        self.reports.append((node_id, event))


class _RecordingOwner:
    def __init__(self):
        self.responses = []

    def on_range_response(self, rid, blocks, reason="timeout"):
        self.responses.append((rid, blocks, reason))


def _mk_ctx(behaviors, timeout=0.15):
    ctx = _RealSyncContext(chain=None, rpc=_StubRpc(behaviors),
                           peer_manager=_StubPeerManager())
    ctx.request_timeout = timeout
    ctx.backoff.BASE_DELAY = 0.0               # keep deadlines tight
    ctx.backoff.MAX_DELAY = 0.0
    return ctx


def test_pump_expires_stalled_request_individually():
    ctx = _mk_ctx({"slow": "hang", "fast": "empty"})
    owner = _RecordingOwner()
    try:
        rid_slow = ctx.send_range("slow", 1, 4, owner)
        rid_fast = ctx.send_range("fast", 5, 4, owner)
        t0 = time.monotonic()
        ctx.pump()
        elapsed = time.monotonic() - t0
        got = dict((rid, (blocks, reason))
                   for rid, blocks, reason in owner.responses)
        # the stalled request expired alone, with the "stall" reason...
        assert got[rid_slow] == (None, "stall")
        # ...while the honest peer's response was delivered intact
        assert got[rid_fast][0] == []
        assert elapsed < 0.8                   # did NOT ride out the hang
        assert ctx.inflight == {}
        # only the stalling peer was charged a backoff failure
        assert ctx.backoff._fails.get("slow", 0) == 1
        assert ctx.backoff._fails.get("fast", 0) == 0
    finally:
        ctx.close()


def test_pump_classifies_peer_gone_and_decode_error():
    ctx = _mk_ctx({"garbler": "garbage"})
    owner = _RecordingOwner()
    try:
        rid_gone = ctx.send_range("vanished", 1, 4, owner)
        rid_bad = ctx.send_range("garbler", 1, 4, owner)
        ctx.pump()
        got = dict((rid, (blocks, reason))
                   for rid, blocks, reason in owner.responses)
        assert got[rid_gone] == (None, "peer_gone")
        assert got[rid_bad] == (None, "decode_error")
    finally:
        ctx.close()


def test_closed_context_fails_requests_as_shutdown():
    ctx = _mk_ctx({"fast": "empty"})
    owner = _RecordingOwner()
    ctx.close()
    rid = ctx.send_range("fast", 1, 4, owner)
    ctx.pump()
    assert owner.responses == [(rid, None, "shutdown")]
    # our own close path never charges the peer
    assert ctx.backoff._fails.get("fast", 0) == 0


# ---------------------------------------------------------------------------
# Backfill
# ---------------------------------------------------------------------------

def linked_history(n_slots):
    """blocks for slots 0..n_slots-1 hash-linked; returns (blocks, anchor)."""
    blocks = mk_chain_blocks(0, n_slots)
    anchor_root = blocks[-1].root
    return blocks, anchor_root


def test_backfill_walks_to_genesis():
    ctx = FakeCtx(spe=8)
    blocks, _ = linked_history(33)
    # anchor: slot 32 block is trusted; history [0,32) must backfill
    ctx.anchor = (32, blocks[31].root)
    bf = BackfillSync(ctx)                     # 16-slot windows
    bf.drive(["p1", "p2"])
    assert len(ctx.sent) == 2                  # [16,32) and [0,16)
    rid0 = ctx.sent[0][0]
    rid1 = ctx.sent[1][0]
    bf.on_range_response(rid0, blocks[16:32])
    bf.on_range_response(rid1, blocks[0:16])
    assert bf.complete and ctx.anchor[0] == 0
    assert len(ctx.stored) == 32


def test_backfill_bad_link_penalizes_peer():
    ctx = FakeCtx(spe=8)
    blocks, _ = linked_history(33)
    ctx.anchor = (32, blocks[31].root)
    bf = BackfillSync(ctx)
    bf.drive(["p1"])
    rid0, peer0, _, _ = ctx.sent[0]
    evil = mk_chain_blocks(16, 16, b"evil")
    bf.on_range_response(rid0, evil)
    assert (peer0, "bad_segment") in ctx.penalties
    assert ctx.stored == []
    # batch went back to awaiting; a re-drive retries it
    bf.drive(["p1", "p2"])
    retry_peer = [p for _, p, s, _ in ctx.sent[1:] if s == 16]
    assert retry_peer and retry_peer[0] == "p2"


def test_backfill_truncated_lower_edge_rewindows():
    """ADVICE r4: a peer that truncates the LOWER edge of its window still
    hash-links and advances the anchor; the gap then surfaces as a link
    mismatch in the NEXT batch.  The machine must attribute the fault to
    the truncating peer and re-download from the stored anchor (where the
    missing blocks actually live) instead of burning the next batch."""
    ctx = FakeCtx(spe=8)
    blocks, _ = linked_history(33)
    ctx.anchor = (32, blocks[31].root)
    bf = BackfillSync(ctx)                     # 16-slot windows
    bf.drive(["p1", "p2"])
    (rid0, peer0, _, _), (rid1, peer1, _, _) = ctx.sent[:2]
    # p1 serves [16,32) but truncates the bottom 4 slots
    bf.on_range_response(rid0, blocks[20:32])
    assert ctx.anchor == (20, blocks[19].root)
    # p2's honest [0,16) now can't link (its top parent is in [16,20));
    # blame is ambiguous, so BOTH peers are penalized (range_sync-style)
    bf.on_range_response(rid1, blocks[0:16])
    assert (peer0, "truncated_batch") in ctx.penalties
    assert (peer1, "bad_segment") in ctx.penalties
    # the machine re-windows from the anchor and completes with honest serves
    bf.drive(["p2", "p3"])
    new = [(rid, s, c) for rid, _p, s, c in ctx.sent[2:]]
    assert new and new[0][1:] == (4, 16)       # window [4, 20) re-covers gap
    bf.on_range_response(ctx.sent[2][0], blocks[4:20])
    bf.drive(["p2", "p3"])
    bf.on_range_response(ctx.sent[3][0], blocks[0:4])
    assert bf.complete and ctx.anchor[0] == 0


def test_backfill_partial_batch_links_and_continues():
    """A window where only some slots have blocks still links correctly."""
    ctx = FakeCtx(spe=8)
    blocks, _ = linked_history(20)             # blocks at slots 0..19
    ctx.anchor = (20, blocks[19].root)
    bf = BackfillSync(ctx, batch_slots=16)
    bf.drive(["p1"])
    # window [4, 20): serve all; window [0, 4): serve rest
    spans = [(s, c) for _, _, s, c in ctx.sent]
    assert spans[0] == (4, 16)
    bf.on_range_response(ctx.sent[0][0], blocks[4:20])
    assert ctx.anchor == (4, blocks[3].root)
    bf.drive(["p1"])
    bf.on_range_response(ctx.sent[1][0], blocks[0:4])
    assert bf.complete and ctx.anchor[0] == 0


def test_backfill_all_empty_history_is_misbehavior():
    ctx = FakeCtx(spe=8)
    ctx.anchor = (32, b"anchor".ljust(32, b"\0"))
    bf = BackfillSync(ctx)
    while not bf.stopped and not bf.complete:
        bf.drive(["p1"])
        pending = [r for r in ctx.sent if r[0] in bf.requests]
        if not pending:
            break
        for rid, *_ in pending:
            bf.on_range_response(rid, [])
    assert bf.stopped
    assert any(r == "empty_batch" for _, r in ctx.penalties)


# ---------------------------------------------------------------------------
# Block lookups
# ---------------------------------------------------------------------------

def test_lookup_single_block_connects_and_imports():
    ctx = FakeCtx()
    ctx.known.add(b"parent".ljust(32, b"\0"))
    lk = BlockLookups(ctx)
    root = b"child".ljust(32, b"\0")
    lk.search(root, "p1")
    rid, peer, req_root = ctx.root_reqs[0]
    assert req_root == root
    blk = FakeBlock(root, FakeBlockMsg(9, b"parent".ljust(32, b"\0")))
    lk.on_root_response(rid, blk, peer)
    assert ctx.processed == [[blk]]
    assert ctx.lookup_imports == [root]
    assert lk.lookups == {}


def test_lookup_walks_parent_chain_then_imports_oldest_first():
    ctx = FakeCtx()
    ctx.known.add(b"genesis".ljust(32, b"\0"))
    chain = mk_chain_blocks(5, 3)              # slots 5,6,7 linked to genesis
    lk = BlockLookups(ctx)
    lk.search(chain[2].root, "p1")
    # walk: 7 -> 6 -> 5 -> genesis known
    for blk in reversed(chain):
        rid, peer, req_root = ctx.root_reqs[-1]
        assert req_root == blk.root
        lk.on_root_response(rid, blk, peer)
    assert ctx.processed == [[chain[0], chain[1], chain[2]]]


def test_lookup_depth_limit_penalizes_and_drops():
    ctx = FakeCtx()
    lk = BlockLookups(ctx)
    deep = mk_chain_blocks(0, BlockLookups.PARENT_DEPTH_TOLERANCE + 2,
                           b"deep")
    lk.search(deep[-1].root, "badpeer")
    for blk in reversed(deep):
        if not ctx.root_reqs or lk.lookups == {}:
            break
        rid, peer, _ = ctx.root_reqs[-1]
        lk.on_root_response(rid, blk, peer)
    assert lk.lookups == {}                    # dropped at the limit
    assert ("badpeer", "bad_segment") in ctx.penalties
    assert ctx.processed == []


def test_lookup_dedup_concurrent_triggers():
    ctx = FakeCtx()
    lk = BlockLookups(ctx)
    root = b"dup".ljust(32, b"\0")
    lk.search(root, "p1")
    lk.search(root, "p2")                      # joins, no second request
    assert len(ctx.root_reqs) == 1
    assert len(lk.lookups) == 1
    only = next(iter(lk.lookups.values()))
    assert only.peers == {"p1", "p2"}


def test_lookup_error_rotates_to_joined_peer():
    ctx = FakeCtx()
    lk = BlockLookups(ctx)
    root = b"rot".ljust(32, b"\0")
    lk.search(root, "p1")
    lk.search(root, "p2")
    rid, peer, _ = ctx.root_reqs[0]
    lk.on_root_response(rid, None, peer)       # p1 fails
    assert (peer, "timeout") in ctx.penalties
    rid2, peer2, _ = ctx.root_reqs[1]
    assert peer2 != peer
    blk = FakeBlock(root, FakeBlockMsg(3, b"genesis".ljust(32, b"\0")))
    ctx.known.add(b"genesis".ljust(32, b"\0"))
    lk.on_root_response(rid2, blk, peer2)
    assert ctx.processed == [[blk]]


def test_lookup_wrong_block_answer_penalized():
    ctx = FakeCtx()
    lk = BlockLookups(ctx)
    root = b"want".ljust(32, b"\0")
    lk.search(root, "p1")
    rid, peer, _ = ctx.root_reqs[0]
    wrong = FakeBlock(b"other".ljust(32, b"\0"), FakeBlockMsg(3, b"x" * 32))
    lk.on_root_response(rid, wrong, peer)
    assert (peer, "bad_segment") in ctx.penalties


def test_lookup_invalid_segment_penalizes_servers():
    ctx = FakeCtx()
    ctx.known.add(b"genesis".ljust(32, b"\0"))
    lk = BlockLookups(ctx)
    root = b"bad".ljust(32, b"\0")
    lk.search(root, "p1")
    rid, peer, _ = ctx.root_reqs[0]
    blk = FakeBlock(root, FakeBlockMsg(3, b"genesis".ljust(32, b"\0")))
    ctx.process_results.append((0, "bad_signature"))
    lk.on_root_response(rid, blk, peer)
    assert (peer, "bad_segment") in ctx.penalties
    assert lk.imported == 0


def test_lookup_known_root_is_noop():
    ctx = FakeCtx()
    ctx.known.add(b"known".ljust(32, b"\0"))
    lk = BlockLookups(ctx)
    lk.search(b"known".ljust(32, b"\0"), "p1")
    assert ctx.root_reqs == []


def test_lookup_pre_finalization_block_noted_and_dropped():
    """An unknown block at/below the finalized slot can never become
    canonical: the lookup dies and the root is remembered
    (pre_finalization_cache.rs)."""
    ctx = FakeCtx(spe=8, fin_epoch=2)          # finalized slot 16
    lk = BlockLookups(ctx)
    root = b"old".ljust(32, b"\0")
    lk.search(root, "p1")
    rid, peer, _ = ctx.root_reqs[0]
    old_block = FakeBlock(root, FakeBlockMsg(10, b"x" * 32))
    lk.on_root_response(rid, old_block, peer)
    assert lk.lookups == {}
    assert ctx.pre_finalized == [root]
    assert ctx.processed == []


def test_lookup_concurrency_cap():
    ctx = FakeCtx()
    lk = BlockLookups(ctx)
    for i in range(BlockLookups.MAX_CONCURRENT + 5):
        lk.search(f"r{i}".encode().ljust(32, b"\0"), "p1")
    assert len(lk.lookups) == BlockLookups.MAX_CONCURRENT
