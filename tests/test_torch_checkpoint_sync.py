"""Checkpoint (weak-subjectivity) sync + backfill over the network.

SURVEY.md §5.4: boot from a finalized state+block, follow the chain forward
via range sync, then backfill history in reverse verifying hash-chain
linkage into the trusted anchor.  The same cases as the JAX package's
tests/test_checkpoint_sync.py, run on the port (imports switched to
lighthouse_tpu_torch; the port on the CPU, its BLS backend put back
after each test).
"""
import time

import pytest

# Range sync / backfill here runs over real loopback sockets with a REAL
# noise XX handshake; the stubbed primitives raise without cryptography.
pytest.importorskip("cryptography")

from lighthouse_tpu_torch.chain import BeaconChainBuilder, BeaconChainHarness
from lighthouse_tpu_torch.containers.state import BeaconState
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.network import NetworkService
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.ssz import htr
from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock


@pytest.fixture(autouse=True)
def fake_crypto():
    prev, saved = set_device("cpu"), bls._current
    bls.set_backend("fake")
    yield
    bls._current = saved
    set_device(prev)


def _wait(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def test_checkpoint_boot_and_backfill():
    spec = minimal_spec()
    src = BeaconChainHarness(spec, 64)
    src.extend_chain(5 * spec.preset.slots_per_epoch)
    chain_a = src.chain
    fin_epoch, fin_root = chain_a.finalized_checkpoint()
    assert fin_epoch >= 2
    fin_block = chain_a.store.get_block(fin_root)
    fin_state = chain_a.store.get_hot_state(fin_block.message.state_root)
    assert fin_state is not None

    # serialize the anchor (as a checkpoint-sync provider would)
    raw_state = bytes([fin_state.fork_name.value]) + fin_state.serialize()
    state2 = BeaconState.from_ssz_bytes(raw_state[1:], fin_state.T, spec,
                                        fin_state.fork_name)

    clock = ManualSlotClock(0, spec.seconds_per_slot,
                            current_slot=chain_a.slot())
    chain_b = (BeaconChainBuilder(spec)
               .weak_subjectivity_anchor(state2, fin_block)
               .slot_clock(clock)
               .build())
    assert chain_b.head().head_state.slot == fin_state.slot
    assert chain_b.genesis_block_root == fin_root

    na = NetworkService(chain_a)
    nb = NetworkService(chain_b)
    na.start()
    nb.start()
    try:
        nb.dial("127.0.0.1", na.port)
        # forward range sync to A's head
        assert _wait(lambda: chain_b.head().head_block_root ==
                     chain_a.head().head_block_root), \
            (chain_b.head().head_state.slot, chain_a.head().head_state.slot)
        # backfill history down to genesis with linkage verification
        stored = nb.sync.backfill()
        assert stored > 0
        anchor = chain_b.store.backfill_anchor()
        assert anchor is not None and anchor[0] == 0
        # historical roots now served from B's freezer
        root3_a = chain_a.block_root_at_slot(3)
        blk3 = chain_b.store.get_block(
            chain_b.store.freezer_block_root_at_slot(3))
        assert blk3 is not None and htr(blk3.message) == root3_a
    finally:
        na.stop()
        nb.stop()


def test_backfill_rejects_bad_linkage():
    spec = minimal_spec()
    src = BeaconChainHarness(spec, 64)
    src.extend_chain(2 * spec.preset.slots_per_epoch)
    chain_a = src.chain
    head = chain_a.head()
    blk = head.head_block
    state = head.head_state
    chain_b = (BeaconChainBuilder(spec)
               .weak_subjectivity_anchor(state.copy(), blk)
               .slot_clock(ManualSlotClock(0, spec.seconds_per_slot,
                                           chain_a.slot()))
               .build())
    # poison the anchor: wrong expected parent root
    chain_b.store.set_backfill_anchor(blk.message.slot, b"\x66" * 32)
    na = NetworkService(chain_a)
    nb = NetworkService(chain_b)
    na.start()
    nb.start()
    try:
        nb.dial("127.0.0.1", na.port)
        assert _wait(lambda: nb.peers.connected())
        stored = nb.sync.backfill()
        assert stored == 0  # first mismatching root aborts the backfill
    finally:
        na.stop()
        nb.stop()


def test_backfill_ignores_empty_batch_claims():
    """A lazy/malicious peer answering by_range with
    empty batches must not walk the backfill anchor down to 'complete'."""
    spec = minimal_spec()
    src = BeaconChainHarness(spec, 64)
    src.extend_chain(2 * spec.preset.slots_per_epoch)
    chain_a = src.chain
    head = chain_a.head()
    chain_b = (BeaconChainBuilder(spec)
               .weak_subjectivity_anchor(head.head_state.copy(),
                                         head.head_block)
               .slot_clock(ManualSlotClock(0, spec.seconds_per_slot,
                                           chain_a.slot()))
               .build())
    na = NetworkService(chain_a)
    nb = NetworkService(chain_b)
    # lazy provider: claims every range is empty
    na.rpc.register("beacon_blocks_by_range", lambda peer, payload: [])
    na.start()
    nb.start()
    try:
        nb.dial("127.0.0.1", na.port)
        assert _wait(lambda: nb.peers.best_peer_for_sync() is not None
                     and nb.rpc.transport.peers)
        anchor_before = chain_b.store.backfill_anchor()
        stored = nb.sync.backfill()
        assert stored == 0
        anchor_after = chain_b.store.backfill_anchor()
        assert anchor_after == anchor_before      # anchor did not move
        assert anchor_after[0] > 0                # never marked complete
        # the lazy peer was penalized
        info = nb.peers.peers.get(list(nb.peers.peers)[0])
        assert info.score < 0
    finally:
        na.stop()
        nb.stop()
