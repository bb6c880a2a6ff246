"""Eth1 tracker: follow distance, voting, deposit inclusion end-to-end.

The same cases as the JAX package's tests/test_eth1.py, run on the port
(imports switched to lighthouse_tpu_torch).
"""
import pytest

from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.eth1 import Eth1Service, MockEth1Endpoint
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.state_transition.genesis import genesis_deposits
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True)
def fake_crypto():
    prev, saved = set_device("cpu"), bls._current
    bls.set_backend("fake")
    yield
    bls._current = saved
    set_device(prev)


def test_follow_distance_and_deposit_cache():
    spec = minimal_spec(eth1_follow_distance=4)
    h = BeaconChainHarness(spec, 16)
    endpoint = MockEth1Endpoint(spec, h.chain.T)
    svc = Eth1Service(spec, h.chain.T, endpoint)
    dd = genesis_deposits(spec, [bls.keygen_interop(100)])[0].data
    endpoint.add_block(deposits=[dd])
    for _ in range(3):
        endpoint.add_block()
    svc.update()
    # head=4, follow=4 -> only block 0 followed, no deposits imported yet
    assert len(svc.block_cache) == 1
    assert len(svc.deposit_logs) == 0
    for _ in range(4):
        endpoint.add_block()
    svc.update()
    assert svc.block_cache[-1].number == 4
    assert len(svc.deposit_logs) == 1


def test_deposit_flows_into_chain():
    """eth1 vote adopted by majority -> mandatory deposit included ->
    validator appears in the registry."""
    spec = minimal_spec(eth1_follow_distance=1)
    h = BeaconChainHarness(spec, 16)
    chain = h.chain
    endpoint = MockEth1Endpoint(spec, chain.T)
    svc = Eth1Service(spec, chain.T, endpoint)
    chain.eth1_service = svc

    # the eth1 chain contains the 16 genesis deposits, then a 17th
    genesis_dds = [d.data for d in genesis_deposits(spec, h.secret_keys)]
    new_key = bls.keygen_interop(500)
    dd = genesis_deposits(spec, [new_key])[0].data
    endpoint.add_block(timestamp=1, deposits=genesis_dds)
    endpoint.add_block(timestamp=2, deposits=[dd])
    endpoint.add_block(timestamp=3)
    svc.update()
    assert len(svc.deposit_logs) == 17

    n0 = len(chain.head().head_state.validators)
    # voting period = 8 slots; majority lands mid-period, deposit follows
    h.extend_chain(3 * spec.preset.slots_per_epoch)
    st = chain.head().head_state
    assert st.eth1_data.deposit_count == 17, st.eth1_data
    assert st.eth1_deposit_index == 17
    assert len(st.validators) == n0 + 1
    assert st.validators.index_of(bls.sk_to_pk(new_key)) is not None


def test_eip4881_deposit_tree_snapshot_roundtrip():
    """EIP-4881: finalize a prefix, snapshot it, resume a FRESH tree from
    the snapshot, extend both — roots must agree at every step."""
    import hashlib
    from lighthouse_tpu_torch.eth1.deposit_snapshot import (
        DepositTree, DepositTreeSnapshot,
    )
    leaves = [hashlib.sha256(bytes([i])).digest() for i in range(20)]
    full = DepositTree()
    for l in leaves[:12]:
        full.push_leaf(l)
    root_at_12 = full.root()
    full.finalize(9, b"\xbb" * 32, 777)
    assert full.root() == root_at_12, "finalizing must not change the root"
    snap = full.get_snapshot()
    assert snap.deposit_count == 9
    assert snap.execution_block_height == 777
    # O(log n) storage: 9 = 8+1 -> two finalized node hashes
    assert len(snap.finalized) == 2
    # resume from the snapshot and catch up
    resumed = DepositTree.from_snapshot(snap)
    for l in leaves[9:12]:
        resumed.push_leaf(l)
    assert resumed.root() == full.root() == root_at_12
    # both trees keep agreeing as new deposits land
    for l in leaves[12:]:
        full.push_leaf(l)
        resumed.push_leaf(l)
    assert resumed.root() == full.root()
    # tampered snapshot is rejected
    bad = DepositTreeSnapshot(list(snap.finalized), b"\x13" * 32,
                              snap.deposit_count,
                              snap.execution_block_hash,
                              snap.execution_block_height)
    with pytest.raises(ValueError):
        DepositTree.from_snapshot(bad)
    # malformed hash count (popcount mismatch) rejects cleanly too
    short = DepositTreeSnapshot(snap.finalized[:1], snap.deposit_root,
                                snap.deposit_count,
                                snap.execution_block_hash,
                                snap.execution_block_height)
    with pytest.raises(ValueError):
        DepositTree.from_snapshot(short)


def test_eth1_service_serves_snapshot():
    """Service twin-tree + finalize hook -> resumable snapshot; root
    matches the legacy proof tree's contract root."""
    from lighthouse_tpu_torch.chain import BeaconChainHarness
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.specs import minimal_spec
    from lighthouse_tpu_torch.ssz import htr, mix_in_length
    bls.set_backend("fake")
    try:
        h = BeaconChainHarness(minimal_spec(), 16)
        spec = h.chain.spec
        endpoint = MockEth1Endpoint(spec, h.chain.T)
        svc = Eth1Service(spec, h.chain.T, endpoint)
        from lighthouse_tpu_torch.state_transition.genesis import genesis_deposits
        dds = [d.data for d in genesis_deposits(spec, [101, 102, 103])]
        for dd in dds:
            endpoint.add_block(deposits=[dd])
        for _ in range(spec.eth1_follow_distance):
            endpoint.add_block()
        svc.update()
        assert svc.deposit_tree_4881.count == 3
        # contract roots agree between the legacy tree and the 4881 twin
        assert svc.deposit_tree_4881.root() == \
            mix_in_length(svc.deposit_tree.hash(), 3)
        svc.finalize({"deposit_root": b"\x00" * 32, "deposit_count": 2,
                      "deposit_index": 2})
        snap = svc.get_deposit_snapshot()
        assert snap.deposit_count == 2 and len(snap.finalized) == 1
        from lighthouse_tpu_torch.eth1.deposit_snapshot import DepositTree
        resumed = DepositTree.from_snapshot(snap)
        resumed.push_leaf(htr(dds[2]))
        assert resumed.root() == svc.deposit_tree_4881.root()
    finally:
        bls.set_backend("python")
