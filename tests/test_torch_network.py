"""Two-node in-process network tests over real TCP loopback.

Equivalent of the reference's multi-node simulation approach (SURVEY.md §4:
testing/simulator LocalNetwork — production objects, real sockets, one
process).

The same cases as the JAX package's tests/test_network.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after each test).
"""
import time

import pytest

# The loopback transport performs a REAL noise XX handshake; without the
# cryptography package the stubbed primitives raise at connect time.
pytest.importorskip("cryptography")

from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.network import NetworkConfig, NetworkService
from lighthouse_tpu_torch.specs import minimal_spec


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


def test_range_sync_and_gossip():
    spec = minimal_spec()
    ha = BeaconChainHarness(spec, 64)
    hb = BeaconChainHarness(spec, 64)
    ha.extend_chain(2 * spec.preset.slots_per_epoch)
    hb.set_slot(ha.chain.slot())

    na = NetworkService(ha.chain)
    nb = NetworkService(hb.chain)
    na.start()
    nb.start()
    try:
        nb.dial("127.0.0.1", na.port)
        # status exchange triggers range sync on B
        assert _wait(lambda: hb.chain.head().head_block_root ==
                     ha.chain.head().head_block_root), \
            (hb.chain.head().head_state.slot,
             ha.chain.head().head_state.slot)

        # gossip: A produces one more block and floods it
        ha.advance_slot()
        hb.set_slot(ha.chain.slot())
        signed, _post = ha.produce_signed_block()
        ha.chain.process_block(signed)
        na.publish_block(signed)
        assert _wait(lambda: hb.chain.head().head_block_root ==
                     ha.chain.head().head_block_root)
        # peer scores stayed healthy
        assert all(not p.banned for p in na.peers.connected())
    finally:
        na.stop()
        nb.stop()


def test_garbage_gossip_downscores_and_bans():
    spec = minimal_spec()
    ha = BeaconChainHarness(spec, 64)
    hb = BeaconChainHarness(spec, 64)
    na = NetworkService(ha.chain)
    nb = NetworkService(hb.chain)
    na.start()
    nb.start()
    try:
        peer = nb.dial("127.0.0.1", na.port)
        assert _wait(lambda: na.peers.connected())
        # B floods garbage block gossip; A must reject and eventually ban.
        # Mesh publish only targets peers KNOWN to subscribe — wait for
        # A's SUBSCRIBE control messages to land first.
        from lighthouse_tpu_torch.network.gossip import Topic
        assert _wait(lambda: any(Topic.BLOCK in tps
                                 for tps in nb.gossip.peer_topics.values()))
        for i in range(8):
            nb.gossip.publish(Topic.BLOCK, b"garbage" + bytes([i]))
        assert _wait(lambda: any(
            p.banned for p in na.peers.peers.values()) or
            not na.peers.connected(), timeout=10)
    finally:
        na.stop()
        nb.stop()


def test_rpc_blocks_by_root():
    spec = minimal_spec()
    ha = BeaconChainHarness(spec, 64)
    hb = BeaconChainHarness(spec, 64)
    roots = ha.extend_chain(4)
    na = NetworkService(ha.chain)
    nb = NetworkService(hb.chain)
    na.start()
    nb.start()
    try:
        peer = nb.dial("127.0.0.1", na.port)
        resp = nb.rpc.request(peer, "beacon_blocks_by_root",
                              {"roots": [roots[1].hex()]})
        assert len(resp) == 1
        from lighthouse_tpu_torch.network.sync import SyncManager
        blk = nb.sync._decode_block(resp[0])
        from lighthouse_tpu_torch.ssz import htr
        assert htr(blk.message) == roots[1]
    finally:
        na.stop()
        nb.stop()


def test_range_sync_downloads_from_peer_pool():
    """Range sync pipelines batches across MULTIPLE peers
    (range_sync/range.rs:27-40), not one sequential peer."""
    spec = minimal_spec()
    src = BeaconChainHarness(spec, 64)
    src.extend_chain(6 * spec.preset.slots_per_epoch)  # 6 batches of work
    providers = []
    counts = []
    for _ in range(3):
        svc = NetworkService(src.chain)
        n = []
        orig = svc._blocks_by_range
        svc.rpc.register("beacon_blocks_by_range",
                         (lambda orig, n: lambda peer, p:
                          (n.append(p["start_slot"]), orig(peer, p))[1])(
                              orig, n))
        providers.append(svc)
        counts.append(n)
    follower_chain = BeaconChainHarness(spec, 64).chain
    nb = NetworkService(follower_chain)
    for svc in providers:
        svc.start()
    nb.start()
    try:
        follower_chain.slot_clock.set_slot(src.chain.slot())
        for svc in providers:
            nb.dial("127.0.0.1", svc.port)
        assert _wait(lambda: len(nb.sync._sync_peer_pool(0)) == 3, 10)
        # the service thread's own maybe_sync (triggered by the status
        # exchange) may race this call and import part of the span; the
        # invariant is that after OUR call returns the follower is synced
        # and the work came from multiple peers
        nb.sync.maybe_sync()
        assert _wait(lambda: follower_chain.head().head_block_root ==
                     src.chain.head().head_block_root, 10)
        served = [len(n) for n in counts]
        # all batches arrived over real sockets; WHICH peers served is
        # racy (the service's own sync may win with the first-dialed
        # peer) — multi-peer batch distribution is asserted
        # deterministically in test_sync_machines.py
        assert sum(served) >= 3, served
    finally:
        nb.stop()
        for svc in providers:
            svc.stop()


def test_light_client_protocols_over_rpc():
    """light-client bootstrap/updates served over the real req/resp
    streams: the server cache's objects arrive
    as fork-context-prefixed SSZ chunks and deserialize."""
    from lighthouse_tpu_torch.ssz import deserialize
    spec = minimal_spec(altair_fork_epoch=0)
    ha = BeaconChainHarness(spec, 64)
    hb = BeaconChainHarness(spec, 64)
    ha.extend_chain(spec.preset.slots_per_epoch + 2)
    hb.set_slot(ha.chain.slot())
    na = NetworkService(ha.chain)
    nb = NetworkService(hb.chain)
    na.start()
    nb.start()
    try:
        peer = nb.dial("127.0.0.1", na.port)
        assert peer is not None
        T = ha.chain.T
        head_root = ha.chain.head().head_block_root
        chunks = nb.rpc.request(peer, "light_client_bootstrap",
                                {"root": head_root.hex()})
        assert chunks, "no bootstrap served"
        raw = bytes.fromhex(chunks[0])
        assert raw[:4] == nb.gossip.fork_digest
        boot = deserialize(T.LightClientBootstrap.ssz_type, raw[4:])
        assert boot.header.beacon.slot <= ha.chain.head().head_state.slot
        assert len(boot.current_sync_committee_branch) == 5
        # optimistic + finality updates (populated as blocks import)
        chunks = nb.rpc.request(peer, "light_client_optimistic_update", {})
        if chunks:           # requires sync-aggregate participation
            upd = deserialize(T.LightClientOptimisticUpdate.ssz_type,
                              bytes.fromhex(chunks[0])[4:])
            assert upd.signature_slot > 0
        chunks = nb.rpc.request(peer, "light_client_updates_by_range",
                                {"start_period": 0, "count": 4})
        for c in chunks:
            upd = deserialize(T.LightClientUpdate.ssz_type,
                              bytes.fromhex(c)[4:])
            assert len(upd.next_sync_committee_branch) == 5
    finally:
        na.stop()
        nb.stop()
