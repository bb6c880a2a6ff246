"""Gossipsub mesh pubsub — REAL meshsub wire format.

The engine implements the gossipsub v1.1 mechanics the reference vendors
(lighthouse_network/gossipsub/src/behaviour.rs): per-topic MESH of degree
D (GRAFT/PRUNE with prune-backoff), lazy gossip (IHAVE windows over a
message cache + IWANT pulls), subscription tracking, and validation
results feeding peer scores (accept/ignore/reject -> PeerManager) —
plus v1.2 IDONTWANT (the feature the reference's vendored fork exists
for): on receiving a large message, mesh peers are told not to forward
us their copy, cutting duplicate bandwidth for blocks/blobs.
Delivery is O(mesh degree), not O(peers).

Wire: varint-delimited gossipsub RPC
protobufs (gossipsub_pb.py) on /meshsub/1.2.0 yamux streams — the exact
frames every libp2p gossipsub speaks.  Topics are the eth2 full form
`/eth2/<fork_digest>/<name>/ssz_snappy` (types/topics.rs:109), payloads
are raw-snappy compressed SSZ, and message ids follow the eth2 p2p spec:
SHA256(MESSAGE_DOMAIN_VALID_SNAPPY || len(topic) || topic ||
decompressed)[:20] (altair+ form).
"""
from __future__ import annotations

import hashlib
import random
import struct
import threading
from collections import OrderedDict

from ..obs import tracing
from . import gossipsub_pb as pb
from . import snappy


def _count(name: str, amount: float = 1) -> None:
    """Catalog counter, sys.modules-gated (wire tests run the engine
    without the metrics stack)."""
    import sys
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    if md is not None:
        md.count(name, amount)


def _gauge(name: str, value: float) -> None:
    """Catalog gauge, same sys.modules gating as _count."""
    import sys
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    if md is not None:
        md.gauge(name, value)

MESSAGE_DOMAIN_VALID_SNAPPY = b"\x01\x00\x00\x00"
MESSAGE_DOMAIN_INVALID_SNAPPY = b"\x00\x00\x00\x00"


class Topic:
    BLOCK = "beacon_block"
    AGGREGATE = "beacon_aggregate_and_proof"
    VOLUNTARY_EXIT = "voluntary_exit"
    PROPOSER_SLASHING = "proposer_slashing"
    ATTESTER_SLASHING = "attester_slashing"
    BLS_CHANGE = "bls_to_execution_change"
    LC_FINALITY_UPDATE = "light_client_finality_update"
    LC_OPTIMISTIC_UPDATE = "light_client_optimistic_update"

    @staticmethod
    def attestation_subnet(subnet: int) -> str:
        return f"beacon_attestation_{subnet}"

    @staticmethod
    def sync_subnet(subnet: int) -> str:
        return f"sync_committee_{subnet}"

    @staticmethod
    def blob_sidecar(index: int) -> str:
        return f"blob_sidecar_{index}"

    @staticmethod
    def data_column_subnet(subnet: int) -> str:
        return f"data_column_sidecar_{subnet}"


def full_topic(name: str, fork_digest: bytes) -> str:
    """types/topics.rs topic string form."""
    return f"/eth2/{fork_digest.hex()}/{name}/ssz_snappy"


def parse_topic(topic: str) -> tuple[bytes, str] | None:
    """full topic string -> (fork_digest, bare name), or None."""
    parts = topic.split("/")
    if len(parts) != 5 or parts[1] != "eth2" or parts[4] != "ssz_snappy":
        return None
    try:
        return bytes.fromhex(parts[2]), parts[3]
    except ValueError:
        return None


class GossipEngine:
    """validator(topic, data) -> ('accept'|'ignore'|'reject', ctx)."""

    SEEN_CAP = 16384
    D = 8
    D_LO = 6
    D_HI = 12
    HEARTBEAT_SECS = 1.0
    MCACHE_WINDOWS = 5          # kept windows
    GOSSIP_WINDOWS = 3          # advertised via IHAVE
    PRUNE_BACKOFF = 60.0
    MAX_IHAVE_PER_MSG = 64
    MAX_PAYLOAD = 10 * 1024 * 1024
    #: messages at least this large trigger IDONTWANT to mesh peers
    #: (gossipsub v1.2: only worth the control traffic for big payloads)
    IDONTWANT_THRESHOLD = 4 * 1024
    MAX_DONTWANT_PER_PEER = 256

    def __init__(self, transport, fork_digest: bytes):
        self.transport = transport
        # graftpath node attribution: every causal span this engine opens
        # is stamped with the node's label so cross-node stitching can
        # tell the fleet apart (the network service overrides this with
        # the simulator's n<i> label when it has one)
        self.node_label = (getattr(transport, "label", None)
                           or str(getattr(transport, "node_id", ""))[:8])
        self.fork_digest = fork_digest
        self.subscriptions: set[str] = set()      # bare names
        self.validator = lambda topic, data: ("accept", None)
        self.on_message = lambda topic, data, peer, ctx: None
        # fires when the validator IGNOREs a message but attaches a ctx —
        # e.g. an unknown-parent block that sync should chase rather than
        # forward (ignored messages are never propagated to the mesh)
        self.on_ignored = lambda topic, data, peer, ctx: None
        self.on_validation_result = lambda peer, topic, result: None
        self.peer_score = lambda node_id: 0.0   # injected by the service
        self.mesh: dict[str, set[str]] = {}       # bare name -> node ids
        self.peer_topics: dict[str, set[str]] = {}
        self._backoff: dict[tuple[str, str], float] = {}
        self._seen: OrderedDict[bytes, bool] = OrderedDict()
        # mcache: mid -> (bare topic, data); windows: list of sets of mids
        self._mcache: dict[bytes, tuple[str, bytes]] = {}
        self._windows: list[set[bytes]] = [set()]
        self._iwant_budget: dict[str, int] = {}
        self._iwant_served: dict[str, set[bytes]] = {}
        # peer -> {mid: heartbeat count at receipt}: mids that peer told
        # us NOT to forward to it (v1.2)
        self._dontwant: dict[str, OrderedDict[bytes, int]] = {}
        self._hb_count = 0
        self._lock = threading.Lock()
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self._rng = random.Random()

    # -- lifecycle -----------------------------------------------------------

    def start_heartbeat(self) -> None:
        if self._hb_thread is None:
            with self._lock:                # double-checked: one loop only
                if self._hb_thread is None:
                    self._hb_thread = threading.Thread(target=self._hb_loop,
                                                       daemon=True)
                    self._hb_thread.start()

    def stop(self, join: bool = True) -> None:
        """Stop the heartbeat; by default WAIT for the thread to exit so
        callers can tear sockets down afterwards without the heartbeat
        racing a closed transport (clean-shutdown discipline,
        task_executor/src/lib.rs:12-28)."""
        self._hb_stop.set()
        t = self._hb_thread
        if join and t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=2)

    def on_peer_connected(self, peer) -> None:
        rpc = pb.Rpc(subscriptions=[
            pb.SubOpts(True, full_topic(t, self.fork_digest))
            for t in sorted(self.subscriptions)])
        if rpc.subscriptions:
            self._send_rpc(peer, rpc)

    def on_peer_disconnected(self, node_id: str) -> None:
        with self._lock:
            self.peer_topics.pop(node_id, None)
            self._dontwant.pop(node_id, None)
            for members in self.mesh.values():
                members.discard(node_id)
        self._mesh_gauge()

    def _mesh_gauge(self) -> None:
        """Feed gossipsub_mesh_peers (total mesh size across topics)
        after any mesh mutation; called outside self._lock."""
        with self._lock:
            total = sum(len(m) for m in self.mesh.values())
        _gauge("gossipsub_mesh_peers", total)

    # -- subscriptions -------------------------------------------------------

    def subscribe(self, topic: str) -> None:
        self.subscriptions.add(topic)
        self.mesh.setdefault(topic, set())
        self._mesh_gauge()
        rpc = pb.Rpc(subscriptions=[
            pb.SubOpts(True, full_topic(topic, self.fork_digest))])
        for peer in list(self.transport.peers.values()):
            self._send_rpc(peer, rpc)

    def unsubscribe(self, topic: str) -> None:
        self.subscriptions.discard(topic)
        with self._lock:
            members = self.mesh.pop(topic, set())
        self._mesh_gauge()
        ft = full_topic(topic, self.fork_digest)
        prune = pb.Rpc(control=pb.ControlMessage(
            prune=[pb.ControlPrune(ft)]))
        for pid in members:
            self._send_rpc_id(pid, prune)
        unsub = pb.Rpc(subscriptions=[pb.SubOpts(False, ft)])
        for peer in list(self.transport.peers.values()):
            self._send_rpc(peer, unsub)

    # -- publish / deliver ---------------------------------------------------

    def _message_id(self, topic: str, data: bytes) -> bytes:
        """eth2 p2p spec (altair+): SHA256(domain || u64le(len(topic)) ||
        topic || decompressed_data)[:20] over the FULL topic string."""
        ft = full_topic(topic, self.fork_digest).encode()
        return hashlib.sha256(
            MESSAGE_DOMAIN_VALID_SNAPPY
            + struct.pack("<Q", len(ft)) + ft + data).digest()[:20]

    def _mark_seen(self, mid: bytes) -> bool:
        with self._lock:
            if mid in self._seen:
                return True
            self._seen[mid] = True
            while len(self._seen) > self.SEEN_CAP:
                self._seen.popitem(last=False)
            return False

    def _cache_put(self, mid: bytes, topic: str, data: bytes) -> None:
        with self._lock:
            self._mcache[mid] = (topic, data)
            self._windows[0].add(mid)

    def _pub_msg(self, topic: str, data: bytes) -> pb.PubMessage:
        return pb.PubMessage(topic=full_topic(topic, self.fork_digest),
                             data=snappy.compress_block(data))

    def publish(self, topic: str, data: bytes,
                exclude_peer: str | None = None,
                root: bytes | None = None) -> int:
        mid = self._message_id(topic, data)
        if topic == Topic.BLOCK:
            # causal publish span: the content-derived message id is the
            # cross-node stitch key (obs/causal.py); the origin publish
            # (service.publish_block) also passes the block root so the
            # sync-path import edge has an anchor — mesh forwards don't
            attrs = {"topic": topic, "message_id": mid,
                     "node": self.node_label}
            if root is not None:
                attrs["root"] = root
            cm = tracing.span("gossip_publish", **attrs)
        else:
            cm = tracing.attach(None)
        with cm:
            return self._fan_out(topic, data, mid, exclude_peer)

    def _fan_out(self, topic: str, data: bytes, mid: bytes,
                        exclude_peer: str | None) -> int:
        self._mark_seen(mid)
        self._cache_put(mid, topic, data)
        _count("gossipsub_messages_published_total")
        framed = pb.frame(pb.Rpc(publish=[self._pub_msg(topic, data)]))
        with self._lock:
            members = set(self.mesh.get(topic, ()))
            if not members:
                # no mesh yet (just subscribed / tiny nets): fall back to
                # topic-subscribed peers up to D
                members = {pid for pid, tps in self.peer_topics.items()
                           if topic in tps}
                members = set(self._sample(members, self.D))
            # v1.2: honor IDONTWANT — peers that already have the message
            # asked us not to send a duplicate
            members = {pid for pid in members
                       if mid not in self._dontwant.get(pid, ())}
        sent = 0
        for pid in members:
            if pid == exclude_peer:
                continue
            peer = self.transport.peers.get(pid)
            if peer is not None:
                # encode ONCE: a 5 MB block re-framed per mesh peer would
                # be ~40 MB of redundant copying on the hot forward path
                peer.send_gossip_rpc(framed)
                sent += 1
        return sent

    # -- inbound -------------------------------------------------------------

    def handle_rpc(self, peer, rpc: pb.Rpc) -> None:
        try:
            for sub in rpc.subscriptions:
                self._handle_sub(peer, sub)
            for msg in rpc.publish:
                self._handle_data(peer, msg)
            if rpc.control is not None:
                for graft in rpc.control.graft:
                    self._handle_graft(peer, graft.topic)
                for prune in rpc.control.prune:
                    self._handle_prune(peer, prune)
                for ihave in rpc.control.ihave:
                    self._handle_ihave(peer, ihave)
                for iwant in rpc.control.iwant:
                    self._handle_iwant(peer, iwant.message_ids)
                for idw in rpc.control.idontwant:
                    self._handle_idontwant(peer, idw.message_ids)
        except (ValueError, IndexError, struct.error, pb.PbError):
            self.on_validation_result(peer, "?", "reject")

    def _bare(self, peer, topic_str: str) -> str | None:
        """Full wire topic -> bare name; wrong-digest topics reject."""
        parsed = parse_topic(topic_str)
        if parsed is None:
            return None
        digest, name = parsed
        if digest != self.fork_digest:
            self.on_validation_result(peer, name, "reject")
            return None
        return name

    def _handle_sub(self, peer, sub: pb.SubOpts) -> None:
        topic = self._bare(peer, sub.topic)
        if topic is None:
            return
        with self._lock:
            tps = self.peer_topics.setdefault(peer.node_id, set())
            (tps.add if sub.subscribe else tps.discard)(topic)

    def _handle_data(self, peer, msg: pb.PubMessage) -> None:
        topic = self._bare(peer, msg.topic)
        if topic is None:
            return
        if topic not in self.subscriptions:
            return             # before decompression: no CPU for spam topics
        data = snappy.decompress_block(msg.data, self.MAX_PAYLOAD)
        mid = self._message_id(topic, data)
        _count("gossipsub_messages_received_total")
        if self._mark_seen(mid):
            _count("gossipsub_duplicates_dropped_total")
            return
        self._cache_put(mid, topic, data)
        if len(data) >= self.IDONTWANT_THRESHOLD:
            # v1.2: tell the rest of the mesh we have it BEFORE validating,
            # so duplicates stop flowing while validation runs
            with self._lock:
                others = [pid for pid in self.mesh.get(topic, ())
                          if pid != peer.node_id]
            idw = pb.Rpc(control=pb.ControlMessage(
                idontwant=[pb.ControlIWant([mid])]))
            for pid in others:
                self._send_rpc_id(pid, idw)
            if others:
                _count("gossipsub_idontwant_sent_total", len(others))
        # one slot-anchored trace per block message: validation (which
        # runs gossip_verify) and delivery (which submits processor work
        # carrying this context) share the trace id, so the block's path
        # from wire to db-write is a single graftscope trace.  The span
        # carries the causal scope (content-derived message id + node
        # label) so obs/causal.py can stitch it to the publisher's span
        # on another node; aggregates get a lighter gossip_deliver span
        # (per-attestation subnet traffic stays span-free — a flood
        # would churn the 4096-span ring out from under the envelopes).
        if topic == Topic.BLOCK:
            cm = tracing.span("block_pipeline", topic=topic,
                              message_id=mid, node=self.node_label)
        elif topic == Topic.AGGREGATE:
            cm = tracing.span("gossip_deliver", topic=topic,
                              message_id=mid, node=self.node_label)
        else:
            cm = tracing.attach(None)
        with cm:
            result, ctx = self.validator(topic, data)
            _count(f"gossipsub_validation_{result}_total")
            self.on_validation_result(peer, topic, result)
            if result == "accept":
                # forward to the topic mesh only (gossipsub), never flood
                self.publish(topic, data, exclude_peer=peer.node_id)
                self.on_message(topic, data, peer, ctx)
            elif result == "ignore" and ctx is not None:
                self.on_ignored(topic, data, peer, ctx)

    def _handle_graft(self, peer, topic_str: str) -> None:
        topic = self._bare(peer, topic_str)
        if topic is None:
            return
        now = _now()
        with self._lock:
            backoff_until = self._backoff.get((peer.node_id, topic), 0)
            subscribed = topic in self.subscriptions
            score = self.peer_score(peer.node_id)
        if not subscribed or now < backoff_until or score < 0:
            # reject the graft; a backoff violation is penalized
            if now < backoff_until:
                self.on_validation_result(peer, topic, "reject")
            self._send_rpc(peer, pb.Rpc(control=pb.ControlMessage(
                prune=[pb.ControlPrune(
                    full_topic(topic, self.fork_digest),
                    backoff=int(self.PRUNE_BACKOFF))])))
            return
        with self._lock:
            self.mesh.setdefault(topic, set()).add(peer.node_id)
        self._mesh_gauge()

    def _handle_prune(self, peer, prune: pb.ControlPrune) -> None:
        topic = self._bare(peer, prune.topic)
        if topic is None:
            return
        backoff = prune.backoff or self.PRUNE_BACKOFF
        with self._lock:
            self.mesh.get(topic, set()).discard(peer.node_id)
            self._backoff[(peer.node_id, topic)] = _now() + float(backoff)
        self._mesh_gauge()

    def _handle_ihave(self, peer, ihave: pb.ControlIHave) -> None:
        topic = self._bare(peer, ihave.topic)
        if topic is None:
            return
        mids = [m for m in ihave.message_ids[:self.MAX_IHAVE_PER_MSG]
                if len(m) == 20]
        budget = self._iwant_budget.get(peer.node_id, 32)
        want = []
        with self._lock:
            for mid in mids:
                if mid not in self._seen and budget > 0:
                    want.append(mid)
                    budget -= 1
        self._iwant_budget[peer.node_id] = budget
        if want and topic in self.subscriptions:
            self._send_rpc(peer, pb.Rpc(control=pb.ControlMessage(
                iwant=[pb.ControlIWant(want)])))

    MAX_IWANT_SERVED = 128     # per peer per heartbeat (anti-amplification)

    def _handle_iwant(self, peer, mids: list[bytes]) -> None:
        send: list[pb.PubMessage] = []
        for mid in mids[:self.MAX_IHAVE_PER_MSG]:
            with self._lock:
                served = self._iwant_served.setdefault(peer.node_id, set())
                if mid in served or len(served) >= self.MAX_IWANT_SERVED:
                    continue   # each mid served once; bounded reflection
                entry = self._mcache.get(mid)
                if entry is None:
                    continue
                served.add(mid)
                topic, data = entry
            send.append(self._pub_msg(topic, data))
        if send:
            self._send_rpc(peer, pb.Rpc(publish=send))

    def _handle_idontwant(self, peer, mids: list[bytes]) -> None:
        """v1.2: record mids the peer does not want forwarded (bounded
        per peer; entries age out with the mcache windows)."""
        with self._lock:
            dw = self._dontwant.setdefault(peer.node_id, OrderedDict())
            for mid in mids[:self.MAX_IHAVE_PER_MSG]:
                if len(mid) != 20:
                    continue
                dw[mid] = self._hb_count
                while len(dw) > self.MAX_DONTWANT_PER_PEER:
                    dw.popitem(last=False)

    # -- heartbeat -----------------------------------------------------------

    def _hb_loop(self) -> None:
        while not self._hb_stop.wait(self.HEARTBEAT_SECS):
            try:
                self.heartbeat()
            except Exception:
                import logging
                logging.getLogger("lighthouse_tpu_torch.network").exception(
                    "gossip heartbeat failed")

    def heartbeat(self) -> None:
        now = _now()
        with self._lock:
            self._backoff = {k: v for k, v in self._backoff.items()
                             if v > now}
            self._iwant_budget.clear()
            self._iwant_served.clear()
            plans_graft: list[tuple[str, str]] = []
            plans_prune: list[tuple[str, str]] = []
            for topic in self.subscriptions:
                members = self.mesh.setdefault(topic, set())
                members &= set(self.transport.peers)
                if len(members) < self.D_LO:
                    candidates = [
                        pid for pid, tps in self.peer_topics.items()
                        if topic in tps and pid not in members
                        and pid in self.transport.peers
                        and self._backoff.get((pid, topic), 0) <= now
                        and self.peer_score(pid) >= 0]
                    for pid in self._sample(candidates,
                                            self.D - len(members)):
                        members.add(pid)
                        plans_graft.append((pid, topic))
                elif len(members) > self.D_HI:
                    for pid in self._sample(members,
                                            len(members) - self.D):
                        members.discard(pid)
                        plans_prune.append((pid, topic))
            # gossip: IHAVE recent mids to a few non-mesh subscribers
            recent: dict[str, list[bytes]] = {}
            for w in self._windows[:self.GOSSIP_WINDOWS]:
                for mid in w:
                    entry = self._mcache.get(mid)
                    if entry:
                        recent.setdefault(entry[0], []).append(mid)
            plans_ihave: list[tuple[str, str, list[bytes]]] = []
            for topic, mids in recent.items():
                members = self.mesh.get(topic, set())
                targets = [pid for pid, tps in self.peer_topics.items()
                           if topic in tps and pid not in members
                           and pid in self.transport.peers]
                for pid in self._sample(targets, self.D_LO):
                    plans_ihave.append(
                        (pid, topic, mids[:self.MAX_IHAVE_PER_MSG]))
            # shift mcache windows
            self._windows.insert(0, set())
            for mid in (self._windows.pop()
                        if len(self._windows) > self.MCACHE_WINDOWS
                        else set()):
                self._mcache.pop(mid, None)
            # IDONTWANT entries age out by heartbeat count, NOT mcache
            # membership: the entries that matter are exactly the ones for
            # messages we have not received yet (pre-receipt suppression),
            # which are never in our mcache
            self._hb_count += 1
            horizon = self._hb_count - self.MCACHE_WINDOWS
            for pid in list(self._dontwant):
                dw = self._dontwant[pid]
                while dw and next(iter(dw.values())) < horizon:
                    dw.popitem(last=False)
                if not dw:
                    del self._dontwant[pid]
        self._mesh_gauge()
        for pid, topic in plans_graft:
            self._send_rpc_id(pid, pb.Rpc(control=pb.ControlMessage(
                graft=[pb.ControlGraft(
                    full_topic(topic, self.fork_digest))])))
        for pid, topic in plans_prune:
            self._send_rpc_id(pid, pb.Rpc(control=pb.ControlMessage(
                prune=[pb.ControlPrune(full_topic(topic, self.fork_digest),
                                       backoff=int(self.PRUNE_BACKOFF))])))
        for pid, topic, mids in plans_ihave:
            self._send_rpc_id(pid, pb.Rpc(control=pb.ControlMessage(
                ihave=[pb.ControlIHave(full_topic(topic, self.fork_digest),
                                       mids)])))

    # -- helpers -------------------------------------------------------------

    def _sample(self, population, k: int):
        pop = list(population)
        if k >= len(pop):
            return pop
        return self._rng.sample(pop, k)

    def _send_rpc(self, peer, rpc: pb.Rpc) -> bool:
        peer.send_gossip_rpc(pb.frame(rpc))
        return True

    def _send_rpc_id(self, node_id: str, rpc: pb.Rpc) -> bool:
        peer = self.transport.peers.get(node_id)
        if peer is None:
            return False
        return self._send_rpc(peer, rpc)


def _now() -> float:
    import time
    return time.monotonic()
