"""Park-and-replay depth (work_reprocessing_queue.rs equivalents).

An attestation for an unknown block is parked and SUCCEEDS after its block imports.  Also covers early-block
parking to the slot boundary, future-slot attestation parking, by-root
expiry, and bucket bounds.  The same cases as the JAX package's
tests/test_reprocess.py on the port.
"""
from __future__ import annotations

import pytest

from lighthouse_tpu_torch.beacon_processor import (
    BeaconProcessor, ReprocessQueue, Work, WorkType,
)
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec


@pytest.fixture(autouse=True)
def fake_bls():
    prev, saved = set_device("cpu"), bls._current
    bls.set_backend("fake")
    yield
    bls._current = saved
    set_device(prev)


def _single(att):
    return type(att)(
        aggregation_bits=[j == 0 for j in range(len(att.aggregation_bits))],
        data=att.data, signature=att.signature)


# ---------------------------------------------------------------------------
# queue unit behavior
# ---------------------------------------------------------------------------

def test_slot_parking_replays_in_order():
    ran = []
    q = ReprocessQueue(lambda w: ran.append(w))
    q.park_until_slot(5, "a")
    q.park_until_slot(3, "b")
    q.park_until_slot(9, "c")
    assert q.on_slot(4) == 1 and ran == ["b"]
    assert q.on_slot(5) == 1 and ran == ["b", "a"]
    assert q.parked == 1                     # "c" still waiting


def test_root_parking_replays_on_import():
    ran = []
    q = ReprocessQueue(lambda w: ran.append(w))
    root = b"r" * 32
    q.park_until_block(root, "x", current_slot=10)
    q.park_until_block(root, "y", current_slot=10)
    assert q.on_block_imported(root) == 2
    assert ran == ["x", "y"]
    assert q.on_block_imported(root) == 0    # drained


def test_root_parking_expires():
    ran = []
    q = ReprocessQueue(lambda w: ran.append(w))
    q.park_until_block(b"r" * 32, "x", current_slot=10)
    q.on_slot(10 + ReprocessQueue.EXPIRY_SLOTS)      # not yet expired
    assert q.parked == 1
    q.on_slot(11 + ReprocessQueue.EXPIRY_SLOTS)
    assert q.parked == 0 and q.expired_total == 1
    assert q.on_block_imported(b"r" * 32) == 0


def test_bucket_bound():
    q = ReprocessQueue(lambda w: None)
    q.max_per_bucket = 4
    for i in range(10):
        q.park_until_slot(7, i)
    assert q.parked == 4


def test_by_root_global_cap():
    """Random-root gossip (pre-signature-check) can't open unbounded
    buckets: total by-root parks are globally capped, new parks refused
    at the cap, and the budget is returned on replay AND expiry."""
    q = ReprocessQueue(lambda w: None)
    q.max_by_root_total = 8
    for i in range(20):
        q.park_until_block(bytes([i]) * 32, i, current_slot=0)
    assert q.parked == 8 and q.refused_total == 12
    # replay frees budget
    assert q.on_block_imported(bytes([3]) * 32) == 1
    q.park_until_block(b"z" * 32, "late", current_slot=0)
    assert q.parked == 8
    # expiry frees budget too
    q.on_slot(1 + ReprocessQueue.EXPIRY_SLOTS)
    assert q.parked == 0
    q.park_until_block(b"y" * 32, "fresh", current_slot=70)
    assert q.parked == 1


# ---------------------------------------------------------------------------
# end-to-end through chain + processor
# ---------------------------------------------------------------------------

def _chain_with_processor():
    h = BeaconChainHarness(minimal_spec(), 64)
    proc = BeaconProcessor(num_workers=2)
    h.chain.processor = proc
    return h, proc


def test_unknown_root_attestation_parked_then_succeeds():
    """THE done-criterion: attestation for a not-yet-imported block parks,
    the block imports, the replay verifies and lands in fork choice."""
    h, proc = _chain_with_processor()
    h.extend_chain(2, attest=False)
    chain = h.chain
    # produce the next block but DON'T import it yet
    h.advance_slot()
    signed, post = h.produce_signed_block()
    from lighthouse_tpu_torch.ssz import htr
    root = htr(signed.message)
    # an attestation pointing at that future import
    atts = h.sh.produce_attestations(post, chain.slot(), root)
    single = _single(atts[0])
    from lighthouse_tpu_torch.chain.errors import AttestationError
    with pytest.raises(AttestationError) as e:
        chain.verify_unaggregated_attestation_for_gossip(single)
    assert e.value.kind == "unknown_head_block"
    # park it the way the network service does
    applied = []

    def replay():
        v = chain.verify_unaggregated_attestation_for_gossip(single)
        chain.apply_attestation_to_fork_choice(v)
        applied.append(v)

    proc.reprocess.park_until_block(
        root, Work(WorkType.GOSSIP_ATTESTATION, replay),
        current_slot=chain.slot())
    assert proc.reprocess.parked == 1
    # import the block -> chain hook wakes the parked attestation
    proc.start()
    chain.process_block(signed)
    assert proc.wait_idle(10)
    assert applied and applied[0].indexed.attesting_indices
    proc.stop()


def test_early_block_parked_until_slot_then_imports():
    h, proc = _chain_with_processor()
    h.extend_chain(2, attest=False)
    chain = h.chain
    # a block for NEXT slot arrives early (clock not advanced yet)
    next_slot = chain.slot() + 1
    signed, _post = h.produce_signed_block(next_slot)
    from lighthouse_tpu_torch.chain.errors import BlockError
    with pytest.raises(BlockError) as e:
        chain.verify_block_for_gossip(signed)
    assert e.value.kind == "future_slot"
    imported = []
    proc.reprocess.park_until_slot(
        next_slot,
        Work(WorkType.GOSSIP_BLOCK,
             lambda: imported.append(chain.process_block(signed))))
    proc.start()
    # the slot arrives; per_slot_task replays the parked block
    h.advance_slot()
    assert proc.wait_idle(10)
    from lighthouse_tpu_torch.ssz import htr
    assert imported == [htr(signed.message)]
    assert chain.head().head_block_root == imported[0]
    proc.stop()


def test_network_service_parks_unknown_root_attestation():
    """The service's gossip path parks and the chain import replays —
    full wiring, no manual park calls."""
    from lighthouse_tpu_torch.network import NetworkService
    from lighthouse_tpu_torch.ssz import htr, serialize
    h = BeaconChainHarness(minimal_spec(), 64)
    proc = BeaconProcessor(num_workers=2)
    svc = NetworkService(h.chain, processor=proc)
    h.extend_chain(2, attest=False)
    chain = h.chain
    h.advance_slot()
    signed, post = h.produce_signed_block()
    root = htr(signed.message)
    atts = h.sh.produce_attestations(post, chain.slot(), root)
    single = _single(atts[0])
    raw = serialize(type(single).ssz_type, single)
    action, ctx = svc._validate_gossip("beacon_attestation_0", raw)
    assert action == "ignore" and proc.reprocess.parked == 1
    chain.process_block(signed)
    assert proc.wait_idle(10)
    # replay applied the vote
    assert proc.reprocess.parked == 0
    proc.stop()
