"""Staged client builder + the per-slot notifier.

Mirrors the reference's beacon_node/client/src/builder.rs stage order:
store -> slasher -> beacon chain (genesis / checkpoint sync) -> execution
layer -> slot clock -> network -> timer -> http api -> metrics -> notifier.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from ..api import ApiBackend, BeaconApiServer
from ..api.metrics import MetricsServer, set_gauge
from ..chain import BeaconChainBuilder
from ..chain.execution import MockExecutionLayer
from ..crypto import bls
from ..network import NetworkConfig, NetworkService
from ..slasher import Slasher, SlasherConfig, record_to_operation
from ..specs.chain_spec import ChainSpec
from ..store import HotColdDB, MemoryStore, NativeKvStore
from ..utils.slot_clock import SystemTimeSlotClock
from .environment import Environment


@dataclass
class ClientConfig:
    datadir: str | None = None
    http_port: int = 5052
    http_enabled: bool = True
    metrics_port: int = 5054
    metrics_enabled: bool = False
    network: NetworkConfig = field(default_factory=NetworkConfig)
    slasher_enabled: bool = False
    crypto_backend: str = "gpu"
    checkpoint_sync_state: bytes | None = None
    checkpoint_sync_block: bytes | None = None
    interop_validator_count: int = 0
    genesis_time: int | None = None
    genesis_state: object | None = None     # testnet-dir genesis.ssz
    # beacon_node/src/cli.rs flag surface
    discovery_port: int = 0                 # discv5 UDP (0 = ephemeral)
    graffiti: bytes | None = None           # 32B default block graffiti
    suggested_fee_recipient: bytes | None = None   # 20B
    snapshot_cache_size: int = 8
    reorg_threshold_pct: int = 20
    light_client_server: bool = True
    validator_monitor_pubkeys: list = field(default_factory=list)
    purge_db: bool = False


class Client:
    def __init__(self):
        self.chain = None
        self.network: NetworkService | None = None
        self.api_server: BeaconApiServer | None = None
        self.metrics_server: MetricsServer | None = None
        self.slasher: Slasher | None = None
        self.discovery = None
        self.nat = None                 # NatOutcome when UPnP attempted
        self.env: Environment | None = None

    def stop(self) -> None:
        if self.api_server:
            self.api_server.stop()
        if self.metrics_server:
            self.metrics_server.stop()
        if self.discovery:
            if self.chain is not None:
                try:
                    # persist the routing table for a bootnode-free
                    # restart (network/src/persisted_dht.rs)
                    self.discovery.persist(self.chain.store)
                except Exception:       # advisory: shutdown continues
                    pass
            self.discovery.stop()   # owns a UDP socket + recv thread
        if self.network:
            self.network.stop()


class ClientBuilder:
    def __init__(self, spec: ChainSpec, env: Environment | None = None):
        self.spec = spec
        self.env = env or Environment()
        self.config = ClientConfig()

    def with_config(self, config: ClientConfig) -> "ClientBuilder":
        self.config = config
        return self

    def build(self) -> Client:
        cfg = self.config
        client = Client()
        client.env = self.env
        bls.set_backend(cfg.crypto_backend)

        # store
        if cfg.datadir:
            os.makedirs(cfg.datadir, exist_ok=True)
            if cfg.purge_db:
                import shutil
                for name in ("chain_db", "freezer_db"):
                    shutil.rmtree(os.path.join(cfg.datadir, name),
                                  ignore_errors=True)
            store = HotColdDB(
                NativeKvStore(os.path.join(cfg.datadir, "chain_db")),
                NativeKvStore(os.path.join(cfg.datadir, "freezer_db")),
                self.spec)
        else:
            store = HotColdDB(MemoryStore(), MemoryStore(), self.spec)

        # beacon chain (resume / genesis / checkpoint sync)
        from ..chain.beacon_chain import ChainConfig
        cb = BeaconChainBuilder(self.spec).store(store).chain_config(
            ChainConfig(
                snapshot_cache_size=cfg.snapshot_cache_size,
                reorg_threshold_pct=cfg.reorg_threshold_pct,
                enable_light_client_server=cfg.light_client_server))
        resume_anchor = (store.anchor_state()
                         if cfg.datadir and cfg.checkpoint_sync_state is None
                         else None)
        if resume_anchor is not None:
            # ClientGenesis::FromStore — restart resume
            cb.resume_from_store(store, anchor=resume_anchor)
        elif cfg.checkpoint_sync_state is not None:
            from ..containers import get_types
            from ..containers.state import BeaconState
            from ..specs.chain_spec import ForkName
            raw = cfg.checkpoint_sync_state
            state = BeaconState.from_ssz_bytes(
                raw[1:], get_types(self.spec.preset), self.spec,
                ForkName(raw[0]))
            blk = None
            if cfg.checkpoint_sync_block is not None:
                from ..ssz import deserialize
                braw = cfg.checkpoint_sync_block
                T = get_types(self.spec.preset)
                blk = deserialize(
                    T.SignedBeaconBlock[ForkName(braw[0])].ssz_type,
                    braw[1:])
            cb.weak_subjectivity_anchor(state, blk)
        elif cfg.genesis_state is not None:
            cb.genesis_state(cfg.genesis_state)
        elif cfg.interop_validator_count:
            cb.interop_genesis(
                [bls.keygen_interop(i)
                 for i in range(cfg.interop_validator_count)],
                genesis_time=cfg.genesis_time or int(time.time()))
        else:
            raise ValueError("no genesis source configured")
        # no explicit slot clock: BeaconChainBuilder derives it from the
        # genesis state's own genesis_time (a mismatch here breaks
        # checkpoint-sync slot math)
        cb.execution_layer(MockExecutionLayer())
        client.chain = cb.build()
        if cfg.graffiti is not None:
            client.chain.default_graffiti = cfg.graffiti
        if cfg.suggested_fee_recipient is not None:
            client.chain.default_fee_recipient = cfg.suggested_fee_recipient
        registry = client.chain.head().head_state.validators
        for pk in cfg.validator_monitor_pubkeys:
            idx = registry.index_of(pk)
            if idx is not None:
                client.chain.validator_monitor.register_validator(idx)
            else:
                # not in the registry yet (deposit pending / checkpoint
                # sync): re-resolved each slot by per_slot_task
                self.env.log.info(
                    "validator-monitor pubkey %s not yet in registry; "
                    "will watch for it", "0x" + pk.hex()[:16])
                client.chain.watch_validator_pubkey(pk)

        # slasher
        if cfg.slasher_enabled:
            client.slasher = Slasher(SlasherConfig(),
                                     store=client.chain.store.hot)
            # gossip verification feeds the slasher authenticated
            # headers/attestations through this back-pointer
            client.chain.slasher = client.slasher

        # network, fed through the priority beacon processor
        from ..beacon_processor import BeaconProcessor
        from ..network.discovery import Discovery
        client.processor = BeaconProcessor(num_workers=os.cpu_count() or 4)
        client.network = NetworkService(client.chain, cfg.network,
                                        processor=client.processor)
        client.network.start()
        client.discovery = Discovery(client.network,
                                     udp_port=cfg.discovery_port)
        try:
            # bootnode-free restart from the persisted routing table
            client.discovery.load_persisted(client.chain.store)
        except Exception:               # advisory
            pass
        if cfg.network.upnp_enabled:
            from ..network.nat import establish_mappings
            client.nat = establish_mappings(client.network.port,
                                            client.discovery.disc.port)
            client.chain.nat_outcome = client.nat   # /lighthouse/nat
        # advertise EXACTLY the attestation subnets the service
        # subscribed (all, or the two node-id-derived defaults) — an ENR
        # must not under/over-claim what the node serves
        attnets = 0
        for subnet in client.network.attnet_subnets:
            attnets |= 1 << subnet
        client.discovery.update_attnets(attnets)
        client.discovery.update_syncnets(0b1111)

        # http api + metrics
        if cfg.http_enabled:
            client.api_server = BeaconApiServer(
                ApiBackend(client.chain), port=cfg.http_port)
            client.api_server.start()
        if cfg.metrics_enabled:
            client.metrics_server = MetricsServer(port=cfg.metrics_port)
            client.metrics_server.start()

        # per-slot timer + notifier (timer/src/lib.rs + client/notifier.rs)
        def timer():
            chain = client.chain
            log = self.env.log
            last = -1
            while not self.env.shutdown_requested():
                slot = chain.slot()
                if slot != last:
                    last = slot
                    chain.per_slot_task()
                    if slot % 8 == 0:
                        try:
                            client.discovery.discover_once()
                        except Exception:
                            pass
                    if client.slasher is not None:
                        found = client.slasher.process_queued(chain.epoch())
                        for rec in found:
                            op = record_to_operation(rec, chain.T)
                            if op is None:
                                continue
                            if hasattr(op, "signed_header_1"):
                                chain.op_pool.insert_proposer_slashing(op)
                            else:
                                chain.op_pool.insert_attester_slashing(op)
                    head = chain.head()
                    set_gauge("beacon_head_slot", head.head_state.slot)
                    set_gauge("beacon_finalized_epoch",
                              chain.finalized_checkpoint()[0])
                    log.info(
                        "slot %d | head %s @ %d | finalized epoch %d | "
                        "peers %d", slot,
                        head.head_block_root.hex()[:8],
                        head.head_state.slot,
                        chain.finalized_checkpoint()[0],
                        len(client.network.peers.connected())
                        if client.network else 0)
                time.sleep(
                    min(1.0, client.chain.slot_clock.duration_to_next_slot()
                        + 0.05))
        self.env.spawn(timer, "timer")
        return client
