"""discv5 v5.1 UDP node discovery over the REAL wire protocol.

Records are EIP-778 RLP ENRs (`enr.py`), packets are masked discv5 v5.1 frames,
sessions are established by the spec WHOAREYOU handshake with
id-signatures and HKDF session keys (`discv5_wire.py`), and messages are
the spec RLP payloads (PING/PONG/FINDNODE/NODES).

Service behavior mirrors the reference's discovery stack
(beacon_node/lighthouse_network/src/discovery/mod.rs — subnet predicate
queries; discovery/enr.rs — eth2/attnets/syncnets fields;
boot_node/src/server.rs — standalone bootnode): a Kademlia XOR routing
table with k-buckets, PING liveness, recursive FINDNODE lookups, and
attestation/sync-committee subnet peer discovery.
"""
from __future__ import annotations

import os
import secrets
import socket
import threading

from cryptography.exceptions import InvalidTag

from ..utils.threads import ThreadGroup
from . import discv5_wire as wire
from . import rlp, secp256k1
from .enr import Enr, EnrError

K_BUCKET_SIZE = 16          # spec k
LOOKUP_PARALLELISM = 3      # spec alpha
REQUEST_TIMEOUT = 2.0
#: a signed ENR with eth2/attnets/syncnets is ~190 bytes of RLP; 4 per
#: NODES message stays beneath the 1280-byte packet bound
MAX_NODES_PER_RESPONSE = 4
MAX_PENDING_OUT = 8         # queued messages per address awaiting session


class Discv5Error(Exception):
    pass


def attnets_int(enr: Enr) -> int:
    """Attestation-subnet bitfield as an int (Bitvector[64] bit order)."""
    return int.from_bytes(enr.attnets() or b"\x00" * 8, "little")


def syncnets_int(enr: Enr) -> int:
    return int.from_bytes(enr.syncnets() or b"\x00", "little")


def enr_addr(enr: Enr) -> tuple[str, int]:
    return (enr.ip() or "127.0.0.1", enr.udp() or 0)


def log2_distance(a: bytes, b: bytes) -> int:
    """0 for identical ids, else 1 + floor(log2(a xor b))."""
    x = int.from_bytes(a, "big") ^ int.from_bytes(b, "big")
    return x.bit_length()


class LocalEnr:
    """Our own signed record; every mutation bumps seq and re-signs."""

    def __init__(self, ip: str, udp_port: int, tcp_port: int = 0,
                 key: int | None = None):
        self.key = key or int.from_bytes(secrets.token_bytes(32), "big") \
            % (secp256k1.N - 1) + 1
        self.seq = 0
        self._fields = dict(ip=ip, udp=udp_port,
                            tcp=tcp_port or None)
        self.record: Enr = None  # set by _bump
        self._bump()

    def _bump(self) -> None:
        self.seq += 1
        rec = Enr(seq=self.seq).set_fields(**self._fields)
        self.record = rec.sign(self.key)

    def set_attnets(self, bitfield: int) -> None:
        self._fields["attnets"] = bitfield.to_bytes(8, "little")
        self._bump()

    def set_syncnets(self, bitfield: int) -> None:
        self._fields["syncnets"] = bitfield.to_bytes(1, "little")
        self._bump()

    def set_eth2(self, fork_digest: bytes) -> None:
        self._fields["eth2"] = fork_digest
        self._bump()

    def set_quic(self, port: int) -> None:
        self._fields["quic"] = port
        self._bump()

    @property
    def node_id(self) -> bytes:
        return self.record.node_id


class KBuckets:
    def __init__(self, local_id: bytes):
        self.local_id = local_id
        self.buckets: list[list[Enr]] = [[] for _ in range(257)]
        self._lock = threading.Lock()

    def update(self, enr: Enr) -> None:
        nid = enr.node_id
        if nid == self.local_id:
            return
        d = log2_distance(self.local_id, nid)
        with self._lock:
            bucket = self.buckets[d]
            for i, e in enumerate(bucket):
                if e.node_id == nid:
                    if enr.seq >= e.seq:
                        bucket.pop(i)
                        bucket.append(enr)   # move to tail (most recent)
                    return
            if len(bucket) < K_BUCKET_SIZE:
                bucket.append(enr)
            # full bucket: drop (liveness eviction happens via remove())

    def remove(self, node_id: bytes) -> None:
        d = log2_distance(self.local_id, node_id)
        with self._lock:
            self.buckets[d] = [e for e in self.buckets[d]
                               if e.node_id != node_id]

    def at_distance(self, d: int) -> list[Enr]:
        with self._lock:
            return list(self.buckets[d]) if 0 <= d <= 256 else []

    def closest(self, target: bytes, limit: int = K_BUCKET_SIZE
                ) -> list[Enr]:
        with self._lock:
            all_enrs = [e for b in self.buckets for e in b]
        all_enrs.sort(key=lambda e: int.from_bytes(e.node_id, "big")
                      ^ int.from_bytes(target, "big"))
        return all_enrs[:limit]

    def by_id(self, node_id: bytes) -> Enr | None:
        d = log2_distance(self.local_id, node_id)
        with self._lock:
            for e in self.buckets[d]:
                if e.node_id == node_id:
                    return e
        return None

    def all(self) -> list[Enr]:
        with self._lock:
            return [e for b in self.buckets for e in b]

    def __len__(self) -> int:
        with self._lock:
            return sum(len(b) for b in self.buckets)


class _Session:
    """Established session keys for one peer address."""

    def __init__(self, write_key: bytes, read_key: bytes, peer_id: bytes):
        self.write_key = write_key
        self.read_key = read_key
        self.peer_id = peer_id


class _Challenge:
    """State we keep after sending WHOAREYOU (spec: challenge record)."""

    def __init__(self, challenge_data: bytes, src_id: bytes):
        self.challenge_data = challenge_data
        self.src_id = src_id


class Discv5:
    """One UDP socket, a routing table, and the request state machine."""

    def __init__(self, ip: str = "127.0.0.1", port: int = 0,
                 tcp_port: int = 0, key: int | None = None,
                 bootnodes: list[Enr] | None = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((ip, port))
        self.sock.settimeout(0.25)
        self.ip, self.port = self.sock.getsockname()
        self.local_enr = LocalEnr(self.ip, self.port, tcp_port, key)
        self.table = KBuckets(self.local_enr.node_id)
        self.sessions: dict[tuple, _Session] = {}
        self.pending_challenges: dict[tuple, _Challenge] = {}
        self.pending_out: dict[tuple, list[bytes]] = {}   # awaiting session
        self.requests: dict[bytes, dict] = {}             # req_id -> state
        self._lock = threading.Lock()
        self._running = False
        self._thread = None
        self._threads = ThreadGroup("discv5")
        self.bootnodes = list(bootnodes or [])
        for b in self.bootnodes:
            self.table.update(b)

    @property
    def node_id(self) -> bytes:
        return self.local_enr.node_id

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._running = True
        with self._lock:
            if self._thread is not None:    # idempotent: one pump only
                return
            self._thread = threading.Thread(target=self._recv_loop,
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._running = False
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None:
            thread.join(timeout=2)
        self._threads.join_all(timeout=2)
        self.sock.close()

    # -- packet pump ---------------------------------------------------------

    def _recv_loop(self) -> None:
        while self._running:
            try:
                data, addr = self.sock.recvfrom(wire.MAX_PACKET)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._handle_packet(data, addr)
            except (Discv5Error, wire.WireError, EnrError, rlp.RlpError,
                    InvalidTag, IndexError, ValueError, KeyError):
                continue   # malformed / unauthenticated: drop silently

    def _handle_packet(self, data: bytes, addr) -> None:
        header, ct = wire.decode_packet(self.node_id, data)
        if header.flag == wire.FLAG_ORDINARY:
            src_id = header.authdata
            sess = self.sessions.get(addr)
            if sess is None:
                self._challenge(addr, header, src_id)
                return
            try:
                msg = wire.open_message(sess.read_key, header, ct)
            except InvalidTag:
                # stale session (peer restarted): drop it and re-challenge
                del self.sessions[addr]
                self._challenge(addr, header, src_id)
                return
            self._handle_message(msg, addr)
        elif header.flag == wire.FLAG_WHOAREYOU:
            self._complete_handshake(header, addr)
        elif header.flag == wire.FLAG_HANDSHAKE:
            self._accept_handshake(header, ct, addr)

    # -- handshake -----------------------------------------------------------

    def _challenge(self, addr, header, src_id: bytes) -> None:
        """Issue a WHOAREYOU challenge (bounded pending state)."""
        if len(self.pending_challenges) > 1024:
            self.pending_challenges.pop(next(iter(self.pending_challenges)))
        id_nonce = os.urandom(16)
        known = self.table.by_id(src_id)
        pkt = wire.encode_whoareyou(src_id, header.nonce, id_nonce,
                                    known.seq if known else 0)
        # reconstruct challenge-data exactly as the peer will see it
        # (iv || static-header || authdata of OUR whoareyou packet)
        chal_header, _ = wire.decode_packet(src_id, pkt)
        self.pending_challenges[addr] = _Challenge(
            chal_header.challenge_data, src_id)
        self.sock.sendto(pkt, addr)

    def _complete_handshake(self, header, addr) -> None:
        """We got challenged: prove our identity and establish keys."""
        # Only honor a WHOAREYOU when we actually have traffic in flight
        # toward that address (queued messages or an outstanding request):
        # an unsolicited challenge from a spoofed source must not be able
        # to evict a live session (session-churn DoS).
        with self._lock:
            queued = self.pending_out.pop(addr, [])
            outstanding = any(st.get("addr") == addr
                              for st in self.requests.values())
        if not queued and not outstanding:
            return
        # being challenged means the peer cannot decrypt us: our session
        # is stale (peer restarted) — drop it so requests re-handshake
        self.sessions.pop(addr, None)
        if not queued:
            return   # in-flight request times out; its retry re-queues
        dest = self._enr_for_addr(addr)
        if dest is None:
            return
        dest_id = dest.node_id
        dest_pub = secp256k1.decompress(dest.public_key)
        enr_seq = int.from_bytes(header.authdata[16:24], "big")
        challenge_data = header.challenge_data
        eph_priv = int.from_bytes(secrets.token_bytes(32), "big") \
            % (secp256k1.N - 1) + 1
        eph_pub = secp256k1.compress(secp256k1.pubkey(eph_priv))
        secret = secp256k1.ecdh(dest_pub, eph_priv)
        ikey, rkey = wire.session_keys(secret, challenge_data,
                                       self.node_id, dest_id)
        id_sig = wire.id_sign(self.local_enr.key, challenge_data, eph_pub,
                              dest_id)
        record = self.local_enr.record.to_rlp() \
            if enr_seq < self.local_enr.seq else None
        sess = _Session(write_key=ikey, read_key=rkey, peer_id=dest_id)
        self.sessions[addr] = sess
        nonce = os.urandom(12)
        pkt = wire.encode_handshake(dest_id, self.node_id, nonce, ikey,
                                    queued[0], id_sig, eph_pub, record)
        self.sock.sendto(pkt, addr)
        for msg in queued[1:]:
            self._send_ordinary(addr, sess, msg)

    def _accept_handshake(self, header, ct: bytes, addr) -> None:
        chal = self.pending_challenges.pop(addr, None)
        if chal is None:
            return
        src_id, id_sig, eph_pub, record_rlp = \
            wire.parse_handshake_authdata(header.authdata)
        if src_id != chal.src_id:
            return
        if record_rlp:
            enr = Enr.from_rlp(record_rlp)      # verifies the signature
            if enr.node_id != src_id:
                raise Discv5Error("handshake record id mismatch")
        else:
            enr = self.table.by_id(src_id)
            if enr is None:
                return                          # can't authenticate
        static_pub = secp256k1.decompress(enr.public_key)
        if not wire.id_verify(static_pub, id_sig, chal.challenge_data,
                              eph_pub, self.node_id):
            raise Discv5Error("bad id signature")
        secret = secp256k1.ecdh(secp256k1.decompress(eph_pub),
                                self.local_enr.key)
        ikey, rkey = wire.session_keys(secret, chal.challenge_data,
                                       src_id, self.node_id)
        # we are the recipient: write with rkey, read with ikey
        sess = _Session(write_key=rkey, read_key=ikey, peer_id=src_id)
        self.sessions[addr] = sess
        self.table.update(enr)
        msg = wire.open_message(ikey, header, ct)
        self._handle_message(msg, addr)

    def _enr_for_addr(self, addr) -> Enr | None:
        for e in self.table.all():
            if enr_addr(e) == addr:
                return e
        return None

    # -- message handling ----------------------------------------------------

    def _send_ordinary(self, addr, sess: _Session, msg: bytes) -> None:
        nonce = os.urandom(12)
        pkt = wire.encode_ordinary(sess.peer_id, self.node_id, nonce,
                                   sess.write_key, msg)
        self.sock.sendto(pkt, addr)

    def _handle_message(self, msg: bytes, addr) -> None:
        if not self._running:
            return          # raced stop(): don't spawn past join_all
        t, body = wire.decode_message(msg)
        req_id = bytes(body[0])
        if t == wire.MSG_PING:
            seq = rlp.decode_int(body[1]) if body[1] else 0
            enr = self._enr_for_addr(addr)
            if enr is not None and seq > enr.seq:
                # the peer advertises a newer record: re-fetch it
                # (FINDNODE distance 0 returns the local ENR) off-thread —
                # the recv loop must not block on its own request
                self._threads.spawn(self._refresh_enr, enr,
                                    name="discv5.refresh_enr")
            self._reply(addr, wire.enc_pong(req_id, self.local_enr.seq,
                                            addr[0], addr[1]))
        elif t == wire.MSG_FINDNODE:
            dists = [rlp.decode_int(d) if d else 0 for d in body[1]]
            out: list[Enr] = []
            for d in dists:
                if d == 0:
                    out.append(self.local_enr.record)
                else:
                    out.extend(self.table.at_distance(d))
            out = out[:MAX_NODES_PER_RESPONSE]
            self._reply(addr, wire.enc_nodes(
                req_id, 1, [rlp.decode(e.to_rlp()) for e in out]))
        elif t in (wire.MSG_PONG, wire.MSG_NODES):
            with self._lock:
                st = self.requests.pop(req_id, None)
            if st is None:
                return
            st["response"] = (t, body)
            st["event"].set()

    def _reply(self, addr, msg: bytes) -> None:
        sess = self.sessions.get(addr)
        if sess is not None:
            self._send_ordinary(addr, sess, msg)

    # -- requests ------------------------------------------------------------

    def _request(self, enr: Enr, msg_fn, timeout: float = REQUEST_TIMEOUT):
        addr = enr_addr(enr)
        req_id = secrets.token_bytes(8)
        msg = msg_fn(req_id)
        ev = threading.Event()
        st = {"event": ev, "response": None, "addr": addr}
        with self._lock:
            self.requests[req_id] = st
        sess = self.sessions.get(addr)
        if sess is not None:
            self._send_ordinary(addr, sess, msg)
        else:
            self.table.update(enr)   # need the ENR to finish the handshake
            with self._lock:
                if len(self.pending_out) > 1024:        # bounded state
                    self.pending_out.pop(next(iter(self.pending_out)))
                queue = self.pending_out.setdefault(addr, [])
                if len(queue) >= MAX_PENDING_OUT:
                    queue.pop(0)   # drop the oldest (its request timed out)
                queue.append(msg)
            # spec "random packet": elicits WHOAREYOU from the peer
            self.sock.sendto(
                wire.encode_random(enr.node_id, self.node_id), addr)
        if not ev.wait(timeout):
            with self._lock:
                self.requests.pop(req_id, None)
            raise Discv5Error("request timed out")
        return st["response"]

    # -- public API ----------------------------------------------------------

    def _refresh_enr(self, enr: Enr) -> None:
        try:
            self.find_node(enr, [0])   # table.update stores the result
        except Discv5Error:
            pass

    def ping(self, enr: Enr) -> bool:
        try:
            t, body = self._request(
                enr, lambda rid: wire.enc_ping(rid, self.local_enr.seq))
            if t == wire.MSG_PONG:
                seq = rlp.decode_int(body[1]) if body[1] else 0
                if seq > enr.seq:
                    self._refresh_enr(enr)
                return True
            return False
        except Discv5Error:
            self.table.remove(enr.node_id)
            return False

    def find_node(self, enr: Enr, distances: list[int]) -> list[Enr]:
        t, body = self._request(
            enr, lambda rid: wire.enc_findnode(rid, distances))
        if t != wire.MSG_NODES:
            return []
        found = []
        for item in body[2]:
            try:
                found.append(Enr.from_rlp(rlp.encode(item)))
            except (EnrError, rlp.RlpError):
                continue
        for e in found:
            self.table.update(e)
        return found

    def lookup(self, target: bytes | None = None,
               predicate=None, rounds: int = 3) -> list[Enr]:
        """Recursive Kademlia lookup toward `target` (random if None),
        optionally filtering results with `predicate(enr) -> bool`."""
        target = target or os.urandom(32)
        seen: set[bytes] = {self.node_id}
        # seed with our own table: known peers count as results even when
        # no third party reports them (two-node networks must connect)
        results: dict[bytes, Enr] = {
            e.node_id: e for e in self.table.closest(target, K_BUCKET_SIZE)}
        frontier = self.table.closest(target, LOOKUP_PARALLELISM)
        for _ in range(rounds):
            if not frontier:
                break
            next_frontier: list[Enr] = []
            for enr in frontier[:LOOKUP_PARALLELISM]:
                if enr.node_id in seen:
                    continue
                seen.add(enr.node_id)
                d = log2_distance(enr.node_id, target)
                dists = [d] if d else [256]
                if d > 1:
                    dists.append(d - 1)
                if d < 256:
                    dists.append(d + 1)
                try:
                    found = self.find_node(enr, dists)
                except Discv5Error:
                    self.table.remove(enr.node_id)
                    continue
                for f in found:
                    if f.node_id == self.node_id:
                        continue
                    results[f.node_id] = f
                    if f.node_id not in seen:
                        next_frontier.append(f)
            next_frontier.sort(
                key=lambda e: int.from_bytes(e.node_id, "big")
                ^ int.from_bytes(target, "big"))
            frontier = next_frontier
        out = list(results.values())
        if predicate is not None:
            out = [e for e in out if predicate(e)]
        return out

    def discover_subnet_peers(self, subnet_id: int, n: int = 4,
                              sync: bool = False) -> list[Enr]:
        """Peers advertising an attestation/sync subnet in their ENR
        (discovery/mod.rs subnet predicate queries)."""
        if sync:
            pred = lambda e: syncnets_int(e) & (1 << subnet_id)  # noqa: E731
        else:
            pred = lambda e: attnets_int(e) & (1 << subnet_id)   # noqa: E731
        local = [e for e in self.table.all() if pred(e)]
        if len(local) >= n:
            return local[:n]
        found = {e.node_id: e for e in local}
        for e in self.lookup(predicate=pred):
            found[e.node_id] = e
            if len(found) >= n:
                break
        return list(found.values())[:n]

    def bootstrap(self) -> int:
        """Ping bootnodes and run one self-lookup; returns table size."""
        for b in self.bootnodes:
            self.ping(b)
        self.lookup(self.node_id)
        return len(self.table)
