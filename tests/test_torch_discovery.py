"""discv5 discovery: ENRs, sessions, Kademlia lookups, subnet predicates,
and the NetworkService integration (3 nodes mesh through one bootnode).

The cases of the JAX package's tests/test_discovery.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after each test).  The node API case waits for the
port's ``api`` package.  The service case polls for the dialed mesh under
a deadline where the reference sleeps a fixed 0.3 s, which a loaded
machine can outlast."""
import time

import pytest

from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.network import NetworkService
from lighthouse_tpu_torch.network.discovery import BootNode, Discovery
from lighthouse_tpu_torch.network.discv5 import (
    Discv5, KBuckets, LocalEnr, attnets_int, log2_distance,
)
from lighthouse_tpu_torch.network.enr import Enr, EnrError
from lighthouse_tpu_torch.specs import minimal_spec


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_enr_roundtrip_and_tamper():
    local = LocalEnr("127.0.0.1", 9999, tcp_port=9000)
    local.set_attnets(0b1010)
    blob = local.record.to_rlp()
    dec = Enr.from_rlp(blob)
    assert dec.node_id == local.node_id
    assert dec.ip() == "127.0.0.1" and dec.udp() == 9999
    assert dec.tcp() == 9000 and attnets_int(dec) == 0b1010
    # seq bumps on every update and old records lose to new ones
    seq0 = dec.seq
    local.set_syncnets(0b1)
    assert local.record.seq == seq0 + 1
    # any bit flip breaks the secp256k1 signature
    bad = bytearray(blob)
    bad[-1] ^= 1
    with pytest.raises(EnrError):
        Enr.from_rlp(bytes(bad))


def test_kbuckets_distance_and_eviction():
    a = LocalEnr("127.0.0.1", 1).node_id
    assert log2_distance(a, a) == 0
    table = KBuckets(a)
    enrs = [LocalEnr("127.0.0.1", 2 + i).record for i in range(8)]
    for e in enrs:
        table.update(e)
    assert len(table) == 8
    # closest() sorts by XOR distance to the target
    target = enrs[3].node_id
    assert table.closest(target, 1)[0].node_id == target
    # updates with an equal/newer seq replace; remove() evicts
    table.update(enrs[0])
    assert len(table) == 8
    table.remove(enrs[0].node_id)
    assert len(table) == 7


def test_discv5_mesh_sessions_and_subnet_predicates():
    """5 nodes + bootnode: encrypted sessions form on demand, lookups
    populate tables, ENR seq bumps propagate, subnet queries find the
    advertisers."""
    boot = Discv5()
    boot.start()
    nodes = [Discv5(bootnodes=[boot.local_enr.record]) for _ in range(5)]
    try:
        for n in nodes:
            n.start()
        for n in nodes:
            n.bootstrap()
        # UDP under CI load can drop packets — retry lookups until the
        # tables fill (the protocol is idempotent)
        for _ in range(10):
            for n in nodes:
                n.lookup()
            if all(len(n.table) >= 3 for n in nodes):
                break
        assert all(len(n.table) >= 3 for n in nodes), \
            [len(n.table) for n in nodes]
        # liveness
        assert nodes[0].ping(nodes[1].local_enr.record)
        # subnet advertisement + rediscovery after seq bump
        nodes[2].local_enr.set_attnets(1 << 7)
        nodes[3].local_enr.set_attnets(1 << 7)
        for src in (nodes[2], nodes[3]):
            for e in src.table.all():
                src.ping(e)   # announces the new seq; peers re-fetch
        time.sleep(0.5)
        found = nodes[0].discover_subnet_peers(7, n=4)
        want = {nodes[2].local_enr.node_id, nodes[3].local_enr.node_id}
        assert {e.node_id for e in found} & want
        # a dead node is evicted from the table on ping failure
        dead = nodes[4].local_enr.record
        nodes[4].stop()
        nodes[0].table.update(dead)
        assert not nodes[0].ping(dead)
        assert all(e.node_id != dead.node_id
                   for e in nodes[0].table.all())
    finally:
        for n in nodes[:4] + [boot]:
            n.stop()


def test_network_service_discovers_and_dials():
    """NetworkService nodes find each other via the bootnode's discv5
    table and dial over TCP (the reference's discovery->libp2p flow)."""
    bls.set_backend("fake")
    spec = minimal_spec()
    boot = BootNode()
    boot.start()
    services, discos = [], []
    try:
        for _ in range(3):
            h = BeaconChainHarness(spec, 64)
            svc = NetworkService(h.chain)
            svc.start()
            disco = Discovery(svc, bootnode_enrs=[boot.enr])
            services.append(svc)
            discos.append(disco)
        total_new = 0
        for disco in discos:
            total_new += disco.discover_once()
        _wait(lambda: sum(1 for svc in services
                          if len(svc.transport.peers) >= 2) >= 2)
        assert total_new >= 2
        mesh_ok = sum(1 for svc in services
                      if len(svc.transport.peers) >= 2)
        assert mesh_ok >= 2, [len(s.transport.peers) for s in services]
        # ENR carries the dialable TCP port
        for svc, disco in zip(services, discos):
            assert disco.enr.tcp() == svc.port
    finally:
        for disco in discos:
            disco.stop()
        for svc in services:
            svc.stop()
        boot.stop()

