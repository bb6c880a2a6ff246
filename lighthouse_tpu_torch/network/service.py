"""NetworkService: wires transport/gossip/rpc/peers/sync to the chain.

Equivalent of the reference's beacon_node/network/src/{service.rs:160,
router.rs:33} + network_beacon_processor/{gossip_methods,rpc_methods}.rs:
gossip is validated through the chain's gossip pipelines then imported;
RPC serves blocks from the store; status exchange drives sync.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

from ..chain.errors import AttestationError, BlockError
from ..obs import causal
from ..specs.chain_spec import compute_fork_digest
from ..ssz import deserialize, htr, serialize
from ..utils.threads import ThreadGroup
from .gossip import GossipEngine, Topic
from .peer_manager import PeerManager
from .rpc import RpcHandler, StatusMessage
from .sync import SyncManager, encode_block
from .transport import Transport
from .yamux import YamuxError


@dataclass
class NetworkConfig:
    host: str = "127.0.0.1"
    port: int = 0
    target_peers: int = 16
    boot_nodes: list = None
    # UPnP port-mapping attempt at startup (network/src/nat.rs); off by
    # default — it multicasts on the LAN
    upnp_enabled: bool = False
    # False -> serve only two node-id-derived attestation subnets (the
    # reference's default per-node load); the ENR advertisement must
    # match what is actually subscribed
    subscribe_all_subnets: bool = True
    # "noise" | "plaintext" | None (auto: noise when the cryptography
    # package is available, else the plaintext fallback — transport.py)
    security: str | None = None
    # True -> attestation gossip defers SIGNATURE verification to the
    # beacon processor's batch queues (structural checks stay inline on
    # the socket thread); requires a processor.  This is the reference's
    # batch path (batch.rs) and what the signature-flood scenario leans
    # on: one multi-set verification per drained batch, per-item
    # fallback splitting when a batch contains an invalid signature.
    batch_gossip_verification: bool = False


@dataclass
class DeferredAttestation:
    """Gossip attestation that passed structural checks inline; its
    signature verification rides the processor's batch queue.  The
    sender's node id rides along so a failed signature can still be
    charged to the peer that gossiped it (the inline path reports
    validation results synchronously; the batch path must not lose
    that attribution)."""
    attestation: object
    subnet_id: int
    peer_id: str | None = None


class NetworkService:
    def __init__(self, chain, config: NetworkConfig | None = None,
                 processor=None, transport_factory=None,
                 label: str | None = None):
        """`processor`: optional BeaconProcessor — accepted gossip is then
        imported through its priority queues (with attestation batching)
        instead of inline on the socket reader thread.
        `transport_factory`: optional (host, port) -> Transport hook so a
        fault-injecting transport (network/faults.py) can be swapped in
        without subclassing the service.
        `label`: graftpath node label stamped on every causal span this
        node opens (defaults to the transport's label / node-id prefix)."""
        self.chain = chain
        self.config = config or NetworkConfig()
        self.processor = processor
        self._threads = ThreadGroup("network_service")
        self._stopping = False
        if processor is not None:
            processor.batch_handler = self._attestation_batch
            processor.start()
            # chain hooks drive the park-and-replay queue (slot ticks +
            # block imports, work_reprocessing_queue.rs)
            chain.processor = processor
        if transport_factory is not None:
            self.transport = transport_factory(self.config.host,
                                               self.config.port)
        else:
            self.transport = Transport(self.config.host, self.config.port,
                                       security=self.config.security)
        digest = compute_fork_digest(
            chain.head().head_state.fork.current_version,
            chain.genesis_validators_root)
        self.gossip = GossipEngine(self.transport, digest)
        self.rpc = RpcHandler(self.transport)
        if label is not None:
            self.gossip.node_label = label
            self.rpc.node_label = label
        self.node_label = self.gossip.node_label
        self.peers = PeerManager(self.config.target_peers)
        self.sync = SyncManager(chain, self.rpc, self.peers)

        self.transport.on_peer = self._on_peer
        self.transport.on_gossip_rpc = \
            lambda peer, rpc: self.gossip.handle_rpc(peer, rpc)
        self.transport.on_disconnect = self._on_disconnect
        self.gossip.validator = self._validate_gossip
        self.gossip.on_message = self._deliver_gossip
        self.gossip.on_ignored = self._on_ignored_gossip
        self.gossip.on_validation_result = \
            lambda peer, topic, result: self.peers.report(peer.node_id,
                                                          result)
        # unknown-parent chases in flight, keyed by block root (bounded:
        # a spammer gossiping orphan blocks must not fan out lookups)
        self._parent_lookups: set[bytes] = set()
        self._parent_lookup_lock = threading.Lock()
        self.gossip.peer_score = self.peers.score
        self.rpc.on_rate_limited = \
            lambda peer, proto: self.peers.report(peer.node_id,
                                                  "rate_limited")
        self.peers.on_ban = self._ban

        self.gossip.subscribe(Topic.BLOCK)
        self.gossip.subscribe(Topic.AGGREGATE)
        self.gossip.subscribe(Topic.VOLUNTARY_EXIT)
        self.gossip.subscribe(Topic.PROPOSER_SLASHING)
        self.gossip.subscribe(Topic.ATTESTER_SLASHING)
        n_subnets = chain.spec.preset.max_committees_per_slot
        if self.config.subscribe_all_subnets:
            self.attnet_subnets = list(range(n_subnets))
        else:
            nid = int(self.transport.node_id[:16], 16)
            self.attnet_subnets = sorted({nid % n_subnets,
                                          (nid + 1) % n_subnets})
        for subnet in self.attnet_subnets:
            self.gossip.subscribe(Topic.attestation_subnet(subnet))
        # all four sync-committee subnets (SYNC_COMMITTEE_SUBNET_COUNT);
        # recorded so /eth/v1/node/identity can report syncnets honestly
        self.syncnet_subnets = list(range(4))
        for subnet in self.syncnet_subnets:
            self.gossip.subscribe(Topic.sync_subnet(subnet))
        # PeerDAS custody subnets derived from our authenticated node id
        from ..chain.data_columns import (
            compute_subnet_for_column, get_custody_columns,
        )
        self.custody_columns = get_custody_columns(
            bytes.fromhex(self.transport.node_id))
        for subnet in sorted({compute_subnet_for_column(c)
                              for c in self.custody_columns}):
            self.gossip.subscribe(Topic.data_column_subnet(subnet))

        self.rpc.register("status", self._handle_status)
        self.rpc.register("ping", lambda peer, p: {"seq": 1})
        self.rpc.register("metadata",
                          lambda peer, p: {"seq_number": 1, "attnets": "ff"})
        self.rpc.register("goodbye", self._handle_goodbye)
        self.rpc.register("beacon_blocks_by_range", self._blocks_by_range)
        self.rpc.register("beacon_blocks_by_root", self._blocks_by_root)
        # light-client protocols served straight from the server cache
        # (ref: lighthouse_network/src/rpc/protocol.rs:236-266 entries)
        self.rpc.register("light_client_bootstrap", self._lc_bootstrap)
        self.rpc.register("light_client_finality_update",
                          self._lc_finality_update)
        self.rpc.register("light_client_optimistic_update",
                          self._lc_optimistic_update)
        self.rpc.register("light_client_updates_by_range",
                          self._lc_updates_by_range)
        # LAST: only a fully-constructed service may serve the
        # /eth/v1/node/* API view (a failed Transport bind must leave
        # chain.network_service unset — r5 review)
        chain.network_service = self

    @property
    def port(self) -> int:
        return self.transport.port

    def start(self) -> None:
        self.transport.start()
        self.gossip.start_heartbeat()
        for (host, port) in (self.config.boot_nodes or []):
            self.dial(host, port)

    def stop(self) -> None:
        # Shutdown ordering is structural (task_executor/src/lib.rs:12-28):
        # first refuse new work (the
        # _stopping flag parks status exchanges before they can call into
        # a closing sync executor), then stop the things that CREATE work
        # (heartbeat, sync downloads), then join the service threads that
        # might be mid-request, then close the sockets they would have
        # written to, and only then stop the work sink.
        self._stopping = True
        self.gossip.stop(join=True)
        self.sync.stop()                    # no new download futures
        self._threads.join_all(timeout=3)   # status exchanges, timers
        self.transport.stop()
        if self.processor is not None:
            self.processor.stop(join=True)

    def dial(self, host: str, port: int):
        peer = self.transport.dial(host, port)
        return peer

    # -- plumbing ------------------------------------------------------------

    def _on_peer(self, peer) -> None:
        if self._stopping:
            return
        self.peers.on_connect(peer.node_id)
        self.gossip.on_peer_connected(peer)
        self._threads.spawn(self._status_exchange, peer,
                            name="status_exchange")

    def _on_disconnect(self, peer) -> None:
        self.peers.on_disconnect(peer.node_id)
        self.gossip.on_peer_disconnected(peer.node_id)
        # drop the peer from range-sync chain pools too: a banned or
        # vanished peer left in a pool burns a download attempt per
        # batch on guaranteed "peer gone" failures
        self.sync.range.remove_peer(peer.node_id)

    def _ban(self, node_id: str) -> None:
        peer = self.transport.peers.get(node_id)
        if peer is not None:
            peer.close()

    def local_status(self) -> StatusMessage:
        chain = self.chain
        head = chain.head()
        fin_epoch, fin_root = chain.finalized_checkpoint()
        return StatusMessage(
            fork_digest=self.gossip.fork_digest,
            finalized_root=fin_root, finalized_epoch=fin_epoch,
            head_root=head.head_block_root,
            head_slot=head.head_state.slot)

    def _status_exchange(self, peer) -> None:
        if self._stopping:
            return
        try:
            resp = self.rpc.request(peer, "status",
                                    self.local_status().to_json())
            status = StatusMessage.from_json(resp)
        except (TimeoutError, RuntimeError, KeyError, ValueError,
                OSError, YamuxError):
            # OSError/YamuxError: the peer tore down mid-exchange — this
            # runs on its own thread, so failures must not escape
            return
        if status.fork_digest != self.gossip.fork_digest:
            try:
                # spec goodbye reason codes: 1 shutdown, 2 irrelevant
                # network, 3 fault/error
                self.rpc.request(peer, "goodbye", {"reason": 2},
                                 timeout=2.0)
            except (TimeoutError, RuntimeError):
                pass
            finally:
                peer.close()
            return
        if self._stopping:
            # stop() won the race while we waited on the exchange: don't
            # kick a sync drive against the closed download executor
            return
        self.peers.set_status(peer.node_id, status)
        self.sync.maybe_sync()

    def _handle_status(self, peer, payload) -> dict:
        try:
            status = StatusMessage.from_json(payload)
            self.peers.set_status(peer.node_id, status)
        except (KeyError, ValueError):
            pass
        return self.local_status().to_json()

    def _handle_goodbye(self, peer, payload) -> dict:
        # respond first, close shortly after, so the requester sees the
        # ack; the tracked timer is cancelled if the service stops first
        timer = threading.Timer(0.2, peer.close)
        timer.daemon = True
        self._threads.track(timer)
        timer.start()
        return {}

    def _blocks_by_range(self, peer, payload) -> list[str]:
        start = int(payload["start_slot"])
        count = min(int(payload["count"]),
                    self.chain.spec.max_request_blocks)
        out = []
        seen = None
        for slot in range(start, start + count):
            root = self.chain.block_root_at_slot(slot)
            if root is None or root == seen:
                continue
            seen = root
            blk = self.chain.store.get_block(root)
            if blk is not None and blk.message.slot >= start:
                out.append(encode_block(blk, self.chain))
        return out

    def _blocks_by_root(self, peer, payload) -> list[str]:
        out = []
        for root_hex in payload.get("roots", [])[:64]:
            blk = self.chain.store.get_block(bytes.fromhex(root_hex))
            if blk is not None:
                out.append(encode_block(blk, self.chain))
        return out

    # -- light-client req/resp serving ---------------------------------------

    def _lc_chunk(self, obj) -> str:
        data = serialize(type(obj).ssz_type, obj)
        return (self.gossip.fork_digest + data).hex()

    def _lc_bootstrap(self, peer, payload) -> list[str]:
        from ..chain.light_client import bootstrap_ssz
        b = self.chain.light_client_cache.produce_bootstrap(
            bytes.fromhex(payload["root"]))
        try:
            return [self._lc_chunk(bootstrap_ssz(self.chain.T, b))] \
                if b is not None else []
        except ValueError:
            return []      # electra-depth branches don't fit the wire form

    def _lc_finality_update(self, peer, payload) -> list[str]:
        from ..chain.light_client import finality_update_ssz
        u = self.chain.light_client_cache.latest_finality_update
        try:
            return [self._lc_chunk(finality_update_ssz(self.chain.T, u))] \
                if u is not None else []
        except ValueError:
            return []

    def _lc_optimistic_update(self, peer, payload) -> list[str]:
        from ..chain.light_client import optimistic_update_ssz
        u = self.chain.light_client_cache.latest_optimistic_update
        return [self._lc_chunk(optimistic_update_ssz(self.chain.T, u))] \
            if u is not None else []

    def _lc_updates_by_range(self, peer, payload) -> list[str]:
        from ..chain.light_client import update_ssz
        updates = self.chain.light_client_cache.updates_by_range(
            int(payload["start_period"]), int(payload["count"]))
        out = []
        for u in updates:
            try:
                out.append(self._lc_chunk(update_ssz(self.chain.T, u)))
            except ValueError:
                continue
        return out

    # -- gossip validation / delivery ----------------------------------------

    def _validate_gossip(self, topic: str, data: bytes):
        """Returns (result, ctx): ctx carries the verified object to
        delivery on this thread (no shared mutable hand-off)."""
        chain = self.chain
        try:
            if topic == Topic.BLOCK:
                fork = chain.spec.fork_name_at_slot(max(chain.slot(), 0))
                signed = deserialize(
                    chain.T.SignedBeaconBlock[fork].ssz_type, data)
                try:
                    chain.verify_block_for_gossip(signed)
                except BlockError as e:
                    if e.kind == "future_slot":
                        self._park_early_block(signed)
                    elif e.kind == "parent_unknown":
                        # a fork at our height gossips blocks whose whole
                        # branch we missed (post-partition): range sync
                        # never triggers (peer STATUS isn't ahead), so
                        # the gossip pipeline must chase the ancestry —
                        # hand the block to on_ignored for a parent
                        # lookup against the peer that sent it
                        return "ignore", ("unknown_parent", signed)
                    raise
                return "accept", signed
            if topic.startswith("beacon_attestation_"):
                att = deserialize(chain.T.Attestation.ssz_type, data)
                if self.config.batch_gossip_verification and \
                        self.processor is not None:
                    from ..chain.attestation_verification import (
                        verify_unaggregated_checks,
                    )
                    try:
                        # structural checks inline (cheap rejects stay on
                        # the socket thread); signature check deferred to
                        # the processor's batch drain
                        verify_unaggregated_checks(chain, att)
                    except AttestationError as e:
                        self._maybe_park_attestation(att, e,
                                                     aggregated=False)
                        raise
                    subnet = int(topic.rsplit("_", 1)[-1])
                    return "accept", DeferredAttestation(att, subnet)
                try:
                    v = chain.verify_unaggregated_attestation_for_gossip(att)
                except AttestationError as e:
                    self._maybe_park_attestation(att, e, aggregated=False)
                    raise
                return "accept", v
            if topic == Topic.AGGREGATE:
                agg = deserialize(
                    chain.T.SignedAggregateAndProof.ssz_type, data)
                try:
                    v = chain.verify_aggregated_attestation_for_gossip(agg)
                except AttestationError as e:
                    self._maybe_park_attestation(agg, e, aggregated=True)
                    raise
                return "accept", v
            if topic.startswith("data_column_sidecar_"):
                sc = deserialize(chain.T.DataColumnSidecar.ssz_type, data)
                chain.process_data_column_sidecar(sc)
                return "accept", sc
            if topic.startswith("sync_committee_"):
                msg = deserialize(chain.T.SyncCommitteeMessage.ssz_type,
                                  data)
                chain.sync_committee_pool.verify_and_add_message(msg)
                return "accept", None
            return "accept", None
        except BlockError as e:
            if e.kind in ("parent_unknown",):
                return "ignore", None
            return ("reject" if e.kind in ("repeat_proposal",
                                           "invalid_signature",
                                           "incorrect_proposer",
                                           "invalid_block")
                    else "ignore"), None
        except AttestationError as e:
            return ("ignore" if e.kind in ("prior_attestation_known",
                                           "unknown_head_block",
                                           "future_slot") else "reject"), \
                None
        except Exception:
            return "reject", None

    # -- park-and-replay (work_reprocessing_queue.rs) ------------------------

    def _park_early_block(self, signed) -> None:
        """Early-arriving gossip block: park until its slot starts, then
        re-enter the processor as GOSSIP_BLOCK work (early-block parking,
        work_reprocessing_queue.rs:1-60)."""
        if self.processor is None:
            return
        from ..beacon_processor import Work, WorkType
        self.processor.reprocess.park_until_slot(
            signed.message.slot,
            Work(WorkType.GOSSIP_BLOCK,
                 lambda: self._replay_block(signed)),
            current_slot=self.chain.slot())

    def _replay_block(self, signed) -> None:
        """Replayed early block goes through the SAME pipeline as fresh
        gossip: gossip verification first (equivocation/observed-proposer
        bookkeeping), then import with an unknown-parent lookup fallback."""
        try:
            self.chain.verify_block_for_gossip(signed)
        except BlockError:
            return
        try:
            self.chain.process_block(signed, proposal_already_verified=True)
        except BlockError as e:
            if e.kind == "parent_unknown":
                best = self.peers.best_peer_for_sync()
                if best is not None:
                    self.sync.lookup_unknown_parent(htr(signed.message),
                                                    best.node_id)

    def _maybe_park_attestation(self, att_or_agg, err, aggregated) -> None:
        """Unknown-root attestations wait for their block; future-slot
        attestations wait for their slot (unknown-root replay,
        work_reprocessing_queue.rs:1-60)."""
        if self.processor is None:
            return
        from ..beacon_processor import Work, WorkType
        data = (att_or_agg.message.aggregate.data if aggregated
                else att_or_agg.data)
        kind = (WorkType.GOSSIP_AGGREGATE if aggregated
                else WorkType.GOSSIP_ATTESTATION)
        work = Work(kind, lambda: self._replay_attestation(att_or_agg,
                                                           aggregated))
        if err.kind == "unknown_head_block":
            self.processor.reprocess.park_until_block(
                bytes(data.beacon_block_root), work,
                current_slot=self.chain.slot())
        elif err.kind == "future_slot":
            self.processor.reprocess.park_until_slot(
                data.slot, work, current_slot=self.chain.slot())

    def _replay_attestation(self, att_or_agg, aggregated) -> None:
        try:
            if aggregated:
                v = self.chain.verify_aggregated_attestation_for_gossip(
                    att_or_agg)
            else:
                v = self.chain.verify_unaggregated_attestation_for_gossip(
                    att_or_agg)
            self._apply_verified(v)
        except AttestationError:
            pass

    def _deliver_gossip(self, topic: str, data: bytes, peer, ctx) -> None:
        """Route accepted gossip into the priority processor when present
        (network_beacon_processor role), else import inline."""
        if ctx is None or self._stopping:
            return
        if topic == Topic.AGGREGATE:
            # publish->deliver latency, keyed by the content-derived
            # message id the publisher stamped (obs/causal.py)
            causal.tracker().on_attestation_delivered(
                self.gossip._message_id(topic, data))
        if self.processor is not None:
            from ..beacon_processor import Work, WorkType
            if topic == Topic.BLOCK:
                self.processor.submit(Work(
                    WorkType.GOSSIP_BLOCK,
                    lambda: self._import_gossip_block(ctx, peer)))
            elif topic.startswith("beacon_attestation_"):
                if isinstance(ctx, DeferredAttestation):
                    ctx.peer_id = peer.node_id
                self.processor.submit(Work(
                    WorkType.GOSSIP_ATTESTATION, lambda: None,
                    batchable_payload=ctx))
            elif topic == Topic.AGGREGATE:
                self.processor.submit(Work(
                    WorkType.GOSSIP_AGGREGATE,
                    lambda: self._apply_verified(ctx),
                    batchable_payload=ctx))
            return
        try:
            if topic == Topic.BLOCK:
                self._import_gossip_block(ctx, peer)
            elif topic.startswith("beacon_attestation_") or \
                    topic == Topic.AGGREGATE:
                self._apply_verified(ctx)
        except Exception:
            import logging
            logging.getLogger("lighthouse_tpu_torch.network").exception(
                "gossip delivery failed")

    MAX_PARENT_LOOKUPS = 4

    def _on_ignored_gossip(self, topic: str, data: bytes, peer,
                           ctx) -> None:
        """An IGNOREd message the validator wants chased: today that is
        only ("unknown_parent", signed_block) — a fork branch we missed
        entirely (e.g. the far side of a healed partition at equal
        height, where no peer STATUS ever looks 'ahead' and range sync
        stays idle).  Resolve it with a by-root ancestry walk against
        the peer that gossiped the tip."""
        if self._stopping or not isinstance(ctx, tuple) \
                or ctx[0] != "unknown_parent":
            return
        signed = ctx[1]
        root = htr(signed.message)
        with self._parent_lookup_lock:
            if root in self._parent_lookups \
                    or len(self._parent_lookups) >= self.MAX_PARENT_LOOKUPS:
                return
            self._parent_lookups.add(root)
        try:
            self.sync.lookup_unknown_parent(root, peer.node_id)
        except Exception:
            import logging
            logging.getLogger("lighthouse_tpu_torch.network").exception(
                "unknown-parent lookup failed (root %s)", root.hex())
        finally:
            with self._parent_lookup_lock:
                self._parent_lookups.discard(root)

    def _import_gossip_block(self, signed, peer) -> None:
        try:
            self.chain.process_block(signed, proposal_already_verified=True)
        except BlockError as e:
            if e.kind == "parent_unknown":
                self.sync.lookup_unknown_parent(htr(signed.message),
                                                peer.node_id)

    def _apply_verified(self, v) -> None:
        self.chain.apply_attestation_to_fork_choice(v)
        self.chain.add_to_op_pool(v)

    def _attestation_batch(self, verified_list) -> None:
        deferred = []
        for v in verified_list:
            if isinstance(v, DeferredAttestation):
                deferred.append(v)
            elif v is not None:
                self._apply_verified(v)
        if deferred:
            # one multi-set verification for the whole drained batch;
            # invalid entries come back as AttestationError after the
            # per-item fallback split (attestation_verification.py)
            results = self.chain \
                .batch_verify_unaggregated_attestations_for_gossip(
                    [(d.attestation, d.subnet_id) for d in deferred])
            for d, r in zip(deferred, results):
                if not isinstance(r, Exception):
                    self._apply_verified(r)
                elif isinstance(r, AttestationError) \
                        and r.kind == "bad_signature" \
                        and d.peer_id is not None:
                    # deferred-path parity with the inline path: a peer
                    # gossiping provably invalid signatures is charged a
                    # reject even though validation ran on the batch
                    self.peers.report(d.peer_id, "reject")

    # -- publishing ----------------------------------------------------------

    def publish_block(self, signed_block) -> None:
        data = serialize(type(signed_block).ssz_type, signed_block)
        root = htr(signed_block.message)
        # propagation clock starts at the origin publish; every other
        # node's import of this root observes block_propagation_seconds
        causal.tracker().on_block_published(root)
        self.gossip.publish(Topic.BLOCK, data, root=root)

    def publish_attestation(self, attestation, subnet: int = 0) -> None:
        data = serialize(type(attestation).ssz_type, attestation)
        self.gossip.publish(Topic.attestation_subnet(subnet), data)

    def publish_aggregate(self, signed_aggregate) -> None:
        data = serialize(type(signed_aggregate).ssz_type, signed_aggregate)
        causal.tracker().on_attestation_published(
            self.gossip._message_id(Topic.AGGREGATE, data))
        self.gossip.publish(Topic.AGGREGATE, data)

    def publish_sync_committee_message(self, msg, subnet: int = 0) -> None:
        data = serialize(type(msg).ssz_type, msg)
        self.gossip.publish(Topic.sync_subnet(subnet), data)
