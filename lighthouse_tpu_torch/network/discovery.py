"""Peer discovery: discv5 UDP Kademlia + standalone bootnode.

Equivalent of the reference's discovery service and boot_node binary
(lighthouse_network/src/discovery/mod.rs — discv5 queries feeding dialable
peers to the network; boot_node/src/server.rs — a discv5 server with no
libp2p stack).  The wire layer lives in `discv5.py` (signed ENRs,
WHOAREYOU/ECDH sessions, FINDNODE lookups, subnet predicates); this module
binds it to the NetworkService: our ENR advertises the TCP (noise
transport) port, lookups surface ENRs, and new peers are dialed over TCP
until target_peers.

Run standalone:  python -m lighthouse_tpu_torch.network.discovery --port 9100
"""
from __future__ import annotations

import argparse
import sys
import time

from .discv5 import Discv5
from .enr import Enr


class Discovery:
    """Attach to a NetworkService: discv5 lookups -> TCP dials."""

    def __init__(self, service, udp_port: int = 0,
                 bootnode_enrs: list[Enr] | None = None):
        self.service = service
        self.disc = Discv5(ip=service.transport.host, port=udp_port,
                           tcp_port=service.port,
                           bootnodes=bootnode_enrs)
        # only after the UDP bind succeeded
        service.chain.discovery = self    # /eth/v1/node/identity ENR view
        self.disc.start()
        # addr -> transport peer id of the last successful dial, so a
        # dropped connection can be re-dialed on a later round
        self._dialed: dict[tuple[str, int], str] = {}
        if bootnode_enrs:
            self.disc.bootstrap()

    # -- identity ------------------------------------------------------------

    @property
    def enr(self) -> Enr:
        return self.disc.local_enr.record

    def add_bootnode(self, enr: Enr) -> None:
        self.disc.bootnodes.append(enr)
        self.disc.table.update(enr)

    # -- ENR subnet advertisement (discovery/enr.rs attnets/syncnets) --------

    def update_attnets(self, bitfield: int) -> None:
        self.disc.local_enr.set_attnets(bitfield)

    def update_syncnets(self, bitfield: int) -> None:
        self.disc.local_enr.set_syncnets(bitfield)

    # -- discovery -----------------------------------------------------------

    def _try_dial(self, enr: Enr) -> bool:
        """Dial an ENR's TCP endpoint unless we already hold a live
        connection from a previous dial of that address."""
        svc = self.service
        if not enr.tcp():
            return False   # bootnode-style record: not dialable over TCP
        addr = (enr.ip(), enr.tcp())
        if addr == (svc.transport.host, svc.port):
            return False
        live = self._dialed.get(addr)
        if live is not None and live in svc.transport.peers:
            return False   # still connected
        peer = svc.dial(*addr)
        if peer is None:
            self._dialed.pop(addr, None)   # retry on a later round
            return False
        self._dialed[addr] = peer.node_id
        return True

    def discover_once(self) -> int:
        """One lookup round; dial found peers until target_peers.
        Returns new connections made.  (Runs on the per-slot timer: only
        re-bootstrap — serial bootnode pings with 2 s timeouts — when the
        table is empty, so an unreachable bootnode cannot stall slots.)"""
        svc = self.service
        if len(self.disc.table) == 0 and self.disc.bootnodes:
            self.disc.bootstrap()
        made = 0
        for enr in self.disc.lookup():
            if len(svc.transport.peers) >= svc.peers.target_peers:
                break
            if self._try_dial(enr):
                made += 1
        return made

    def discover_subnet_peers(self, subnet_id: int, n: int = 4,
                              sync: bool = False) -> int:
        """Find + dial peers advertising a subnet in their ENR
        (discovery/mod.rs subnet predicate queries).  Returns dials made."""
        made = 0
        for enr in self.disc.discover_subnet_peers(subnet_id, n=n,
                                                   sync=sync):
            if self._try_dial(enr):
                made += 1
        return made

    def stop(self) -> None:
        self.disc.stop()

    # -- routing-table persistence (network/src/persisted_dht.rs) ------------

    def load_persisted(self, store) -> int:
        """Seed the K-buckets from the database — restart without
        bootnodes (invalid records are dropped at decode)."""
        from .persisted_dht import load_dht
        enrs = load_dht(store)
        for e in enrs:
            self.disc.table.update(e)
        return len(enrs)

    def persist(self, store) -> int:
        """Write the current routing table to the database."""
        from .persisted_dht import persist_dht
        return persist_dht(store, self.disc.table.all())


class BootNode:
    """Standalone discv5 server: routing table only, no beacon stack
    (boot_node/src/server.rs)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.disc = Discv5(ip=host, port=port, tcp_port=0)

    @property
    def enr(self) -> Enr:
        return self.disc.local_enr.record

    @property
    def port(self) -> int:
        return self.disc.port

    def start(self) -> None:
        self.disc.start()

    def stop(self) -> None:
        self.disc.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9100)
    args = ap.parse_args(argv)
    node = BootNode(args.host, args.port)
    node.start()
    print(f"bootnode listening on {args.host}:{node.port} (udp)")
    print(f"enr: {node.enr.to_text()}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
