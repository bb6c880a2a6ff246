"""Multi-node in-process simulator.

Equivalent of the reference's testing/simulator (basic_sim.rs:29,
local_network.rs:107, checks.rs): N beacon nodes (production objects) on
real TCP loopback with validators split across per-node validator clients,
asserting liveness, full participation, sync and finalization — the
"multi-node without a real cluster" tier of SURVEY.md §4.

The adversarial tier layers on top: a shared ``FaultInjector``
swaps every node's transport for a ``FaultyTransport`` so scenarios
(testing/scenarios.py) can ``partition()``/``heal()`` the network, nodes
can run the priority beacon processor with batched gossip verification,
and a per-node slasher can be armed.

Run directly:  python -m lighthouse_tpu_torch.testing.simulator --nodes 3
Scenarios:     python -m lighthouse_tpu_torch.testing.simulator \
                   --scenario partition_heal --seed 7
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass

from ..api import ApiBackend, BeaconApiServer
from ..chain import BeaconChainHarness
from ..crypto import bls
from ..network import NetworkService
from ..network.faults import FaultInjector, FaultyTransport
from ..network.service import NetworkConfig
from ..specs import minimal_spec
from ..validator_client import (
    BeaconNodeFallback, ValidatorClient, ValidatorStore,
)
from ..validator_client.http_client import BeaconNodeHttpClient


@dataclass
class LocalNode:
    harness: object                      # BeaconChainHarness or anchor shim
    network: NetworkService
    backend: ApiBackend
    vc: ValidatorClient | None = None
    api_server: object | None = None     # BeaconApiServer in HTTP mode
    slasher: object | None = None
    dead: bool = False


class GossipingBackend(ApiBackend):
    """API publish also floods the gossip network (http_api/src/
    publish_blocks.rs -> network channel behavior).  Block broadcast goes
    through the backend's publish_fn hook so the
    broadcast-validation ordering applies (gossip mode broadcasts after
    gossip checks; consensus mode only after full import)."""

    def __init__(self, chain, network: NetworkService):
        super().__init__(chain)
        self.network = network
        self.publish_fn = network.publish_block

    def publish_attestation(self, attestation) -> None:
        super().publish_attestation(attestation)
        self.network.publish_attestation(attestation)

    def publish_aggregate(self, signed_aggregate) -> None:
        super().publish_aggregate(signed_aggregate)
        self.network.publish_aggregate(signed_aggregate)

    def publish_sync_committee_message(self, msg) -> None:
        super().publish_sync_committee_message(msg)
        self.network.publish_sync_committee_message(msg)


@dataclass
class CheckResult:
    name: str
    ok: bool
    detail: str = ""


class _AnchorHarness:
    """Harness shim for a checkpoint-synced node: it owns a chain and a
    clock but no genesis validators of its own."""

    def __init__(self, chain, clock):
        self.chain = chain
        self.clock = clock

    def advance_slot(self) -> None:
        self.clock.advance_slot()
        self.chain.per_slot_task()


class LocalNetwork:
    """node_test_rig LocalNetwork equivalent."""

    def __init__(self, spec, node_count: int, validator_count: int = 64,
                 use_http: bool = False, topology: str = "star",
                 security: str | None = None,
                 injector: FaultInjector | None = None,
                 use_processor: bool = False,
                 batch_gossip_verification: bool = False,
                 with_slasher: bool = False):
        """`use_http=True` drives every VC through a REAL per-node HTTP
        API server (BeaconNodeHttpClient -> BeaconApiServer -> backend),
        with every OTHER node's URL as a fallback — the reference's
        fallback_sim topology; block publication then takes the real
        POST /eth/v1/beacon/blocks path (publish_blocks.rs role) instead
        of an in-process shortcut.

        `topology`: "star" (everyone dials node 0 — the seed layout) or
        "mesh" (full peering — required for partition scenarios, where a
        severed hub would otherwise isolate every spoke at once).
        `injector`: a FaultInjector; each node then runs a
        FaultyTransport labeled "n{i}" so scenarios can cut/degrade
        links.  `with_slasher` arms a per-node slasher fed by gossip
        verification; run_slots drains it into the op pool exactly like
        the production client loop."""
        if topology not in ("star", "mesh"):
            raise ValueError(f"unknown topology {topology!r}")
        bls.set_backend("fake")
        self.spec = spec
        self.validator_count = validator_count
        self.use_http = use_http
        self.topology = topology
        self.security = security
        self.injector = injector
        self.use_processor = use_processor
        self.batch_gossip_verification = batch_gossip_verification
        self.with_slasher = with_slasher
        self.nodes: list[LocalNode] = []
        self.partitions: list[list[int]] | None = None
        self.convergence_failures: list[CheckResult] = []
        for i in range(node_count):
            h = BeaconChainHarness(spec, validator_count)
            node = self._wire_node(h, f"n{i}")
            self.nodes.append(node)
            for j in self._dial_targets(i):
                node.network.dial("127.0.0.1", self.nodes[j].network.port)
        # split validators across nodes, each slice driven by that node's VC
        per = validator_count // node_count
        for i, node in enumerate(self.nodes):
            store = ValidatorStore(
                spec, node.harness.chain.genesis_validators_root)
            lo = i * per
            hi = validator_count if i == node_count - 1 else (i + 1) * per
            for sk in node.harness.secret_keys[lo:hi]:
                store.add_validator(sk)
            node.vc = ValidatorClient(spec, store, self._fallback_for(node))

    # -- construction --------------------------------------------------------

    def _wire_node(self, harness, label: str) -> LocalNode:
        chain = harness.chain
        cfg = NetworkConfig(
            security=self.security,
            batch_gossip_verification=self.batch_gossip_verification)
        processor = None
        if self.use_processor:
            from ..beacon_processor import BeaconProcessor
            processor = BeaconProcessor(num_workers=2)
        transport_factory = None
        if self.injector is not None:
            inj = self.injector
            transport_factory = lambda host, port: FaultyTransport(
                host, port, security=self.security, injector=inj,
                label=label)
        net = NetworkService(chain, cfg, processor=processor,
                             transport_factory=transport_factory,
                             label=label)
        backend = GossipingBackend(chain, net)
        net.start()
        node = LocalNode(harness, net, backend)
        if self.with_slasher:
            from ..slasher import Slasher, SlasherConfig
            node.slasher = Slasher(SlasherConfig(history_length=64))
            chain.slasher = node.slasher
        if self.use_http:
            node.api_server = BeaconApiServer(backend)
            node.api_server.start()
        return node

    def _fallback_for(self, node: LocalNode) -> BeaconNodeFallback:
        if self.use_http:
            # own node first, every other node as failover
            order = [node] + [n for n in self.nodes if n is not node]
            clients = [BeaconNodeHttpClient(
                f"http://127.0.0.1:{n.api_server.port}", self.spec,
                timeout=5.0) for n in order]
            return BeaconNodeFallback(clients)
        return BeaconNodeFallback([node.backend])

    def _dial_targets(self, i: int) -> list[int]:
        if i == 0:
            return []
        return [0] if self.topology == "star" else list(range(i))

    def add_node(self, anchor_from: int, dial: list[int] | None = None,
                 group: int | None = None) -> int:
        """Join a FRESH node mid-run via weak-subjectivity checkpoint
        sync against `anchor_from`'s finalized state (the fresh node has
        no validators — it follows, which is exactly the
        checkpoint-sync-into-partition victim).  `dial` overrides the
        topology's default peers; `group` places the node into an active
        partition group so convergence checks score it correctly."""
        from ..chain import BeaconChainBuilder
        from ..containers.state import BeaconState
        from ..utils.slot_clock import ManualSlotClock
        src = self.nodes[anchor_from].harness.chain
        fin_epoch, fin_root = src.finalized_checkpoint()
        fin_block = src.store.get_block(fin_root)
        fin_state = src.store.get_hot_state(fin_block.message.state_root)
        # serialize round-trip: exactly what a checkpoint provider serves
        state2 = BeaconState.from_ssz_bytes(
            fin_state.serialize(), fin_state.T, self.spec,
            fin_state.fork_name)
        clock = ManualSlotClock(0, self.spec.seconds_per_slot,
                                current_slot=src.slot())
        chain = (BeaconChainBuilder(self.spec)
                 .weak_subjectivity_anchor(state2, fin_block)
                 .slot_clock(clock)
                 .build())
        i = len(self.nodes)
        node = self._wire_node(_AnchorHarness(chain, clock), f"n{i}")
        self.nodes.append(node)
        if group is not None and self.partitions is not None:
            self.partitions[group].append(i)
            if self.injector is not None:
                labels = [[f"n{j}" for j in g] for g in self.partitions]
                self.injector.partition(*labels)
        for j in (dial if dial is not None else self._dial_targets(i)):
            node.network.dial("127.0.0.1", self.nodes[j].network.port)
        return i

    def add_fresh_node(self, dial: list[int] | None = None) -> int:
        """Join a GENESIS-state node mid-run: it shares the network's
        deterministic interop genesis but has imported nothing, so it
        must RANGE-SYNC the whole history from its peers — the
        byzantine-sync victim.  Runs no validators.  `dial=[]`
        suppresses dialing so a scenario can tune the node's sync knobs
        before any STATUS exchange triggers `maybe_sync`."""
        h = BeaconChainHarness(self.spec, self.validator_count)
        h.set_slot(int(self.live_nodes[0].harness.chain.slot()))
        i = len(self.nodes)
        node = self._wire_node(h, f"n{i}")
        self.nodes.append(node)
        for j in (dial if dial is not None else self._dial_targets(i)):
            node.network.dial("127.0.0.1", self.nodes[j].network.port)
        return i

    # -- fault control -------------------------------------------------------

    def kill_node(self, i: int) -> None:
        """Fault injection (fallback_sim.rs role): the node's API server
        and network die.  Its VC KEEPS RUNNING — in HTTP mode its duties
        fail over to the surviving nodes' URLs, which is the behavior
        the fallback simulation exists to prove."""
        node = self.nodes[i]
        node.dead = True
        if node.api_server is not None:
            node.api_server.stop()
        node.network.stop()

    def partition(self, *groups) -> None:
        """Split the network into node-index groups; requires the fault
        injector.  Cross-group TCP sessions are closed and re-dials
        refused until heal()."""
        if self.injector is None:
            raise RuntimeError("partition() needs a FaultInjector")
        self.partitions = [list(g) for g in groups]
        self.injector.partition(*[[f"n{i}" for i in g] for g in groups])

    def heal(self, redial: bool = True) -> None:
        """Clear every link fault and (by default) re-establish the
        topology's severed edges."""
        if self.injector is None:
            raise RuntimeError("heal() needs a FaultInjector")
        self.injector.heal()
        self.partitions = None
        if not redial:
            return
        for i, node in enumerate(self.nodes):
            if node.dead:
                continue
            for j in self._dial_targets(i):
                if not self.nodes[j].dead and not self._connected(i, j):
                    node.network.dial("127.0.0.1",
                                      self.nodes[j].network.port)

    def _connected(self, i: int, j: int) -> bool:
        other = self.nodes[j].network.transport.node_id
        return any(p.node_id == other for p in
                   self.nodes[i].network.transport.peers.values())

    @property
    def live_nodes(self) -> list[LocalNode]:
        live = [n for n in self.nodes if not n.dead]
        if not live:
            raise RuntimeError("no live nodes left in the simulation")
        return live

    # -- driving -------------------------------------------------------------

    def _groups(self) -> list[list[LocalNode]]:
        """Live nodes, grouped by the active partition (one group when
        the network is whole)."""
        if self.partitions is None:
            return [self.live_nodes]
        return [[self.nodes[i] for i in g if not self.nodes[i].dead]
                for g in self.partitions]

    def _wait_convergence(self, timeout: float = 5.0) -> bool:
        """Wait until every partition group internally agrees on a head.
        A timeout is RECORDED (convergence_failures) and reported —
        silently proceeding made partition regressions invisible."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            converged = True
            for group in self._groups():
                heads = {n.harness.chain.recompute_head() for n in group}
                if len(heads) > 1:
                    converged = False
                    break
            if converged:
                return True
            time.sleep(0.02)
        detail = []
        for gi, group in enumerate(self._groups()):
            heads = {n.harness.chain.recompute_head() for n in group}
            detail.append(f"group{gi}: {len(heads)} heads")
        self.convergence_failures.append(
            CheckResult("convergence", False,
                        f"timeout {timeout}s; " + ", ".join(detail)))
        return False

    def _run_duty(self, node: LocalNode, fn, *args) -> None:
        """Dead/HTTP duty policy in ONE place: a dead node's VC runs
        only when HTTP failover exists, and only a dead node's
        CONNECTION-LEVEL errors are swallowed — a live node's duty
        failure, and any non-transport error, must stay loud."""
        if node.dead:
            if not self.use_http:
                return                 # no failover path without HTTP
            try:
                fn(*args)
            except (OSError, TimeoutError):
                return                 # dead-primary hiccup: next slot
        else:
            fn(*args)

    def _tick_faults(self) -> None:
        if self.injector is not None:
            self.injector.tick()

    def _pump_slashers(self) -> None:
        """Production-loop parity (client/builder.py slot task): drain
        each armed slasher and pack provable records into the op pool."""
        from ..slasher import record_to_operation
        for node in self.live_nodes:
            if node.slasher is None:
                continue
            chain = node.harness.chain
            for rec in node.slasher.process_queued(chain.epoch()):
                op = record_to_operation(rec, chain.T)
                if op is None:
                    continue
                if hasattr(op, "signed_header_1"):
                    chain.op_pool.insert_proposer_slashing(op)
                else:
                    chain.op_pool.insert_attester_slashing(op)

    def run_slots(self, num_slots: int, mid_slot=None) -> None:
        """Each slot mirrors the real duty schedule: propose at 0s,
        attest + sync-sign at slot/3 (after block propagation),
        aggregate at 2*slot/3.  A dead node's chain stops, but its VC
        keeps running — in HTTP mode its duties fail over to the
        surviving nodes' APIs (fallback_sim behavior).  The fault
        injector's scenario clock advances once per duty phase.
        `mid_slot(slot)` runs after block propagation and BEFORE the
        attestation phase — the window where adversarial gossip lands on
        mainnet (scenarios inject floods here)."""
        def propose(node, slot):
            vc = node.vc
            epoch = slot // self.spec.preset.slots_per_epoch
            if epoch not in vc._duties or epoch + 1 not in vc._duties:
                vc.update_duties(epoch)
            vc.propose_if_due(slot)

        def attest(node, slot):
            node.vc.attest(slot)
            node.vc.sync_committee_duty(slot)

        for _ in range(num_slots):
            for node in self.live_nodes:
                node.harness.advance_slot()
            slot = self.live_nodes[0].harness.chain.slot()
            for node in self.nodes:
                if node.vc is not None:
                    self._run_duty(node, propose, node, slot)
            self._tick_faults()
            self._wait_convergence()
            if mid_slot is not None:
                mid_slot(slot)
            for node in self.nodes:
                if node.vc is not None:
                    self._run_duty(node, attest, node, slot)
            for node in self.nodes:
                if node.vc is not None:
                    self._run_duty(node, node.vc.aggregate, slot)
            self._tick_faults()
            self._wait_convergence()
            self._pump_slashers()

    # -- checks (testing/simulator/src/checks.rs) ----------------------------

    def checks(self, min_epochs: int) -> list[CheckResult]:
        out = []
        groups = self._groups()
        for gi, group in enumerate(groups):
            heads = {n.harness.chain.head().head_block_root
                     for n in group}
            name = ("all_nodes_agree_on_head" if len(groups) == 1
                    else f"group{gi}_agrees_on_head")
            out.append(CheckResult(name, len(heads) == 1,
                                   f"{len(heads)} distinct heads"))
        ref = groups[0][0].harness.chain
        slot = ref.slot()
        head_slot = ref.head().head_state.slot
        out.append(CheckResult(
            "liveness", head_slot >= slot - 1,
            f"head {head_slot} vs clock {slot}"))
        fin = ref.finalized_checkpoint()[0]
        out.append(CheckResult(
            "finalization", fin >= max(0, min_epochs - 2),
            f"finalized epoch {fin}"))
        blocks_per_node = [n.vc.published_blocks for n in self.nodes
                           if n.vc is not None]
        out.append(CheckResult(
            "all_nodes_proposed", all(b > 0 for b in blocks_per_node),
            f"{blocks_per_node}"))
        out.append(CheckResult(
            "convergence_clean", not self.convergence_failures,
            f"{len(self.convergence_failures)} timeouts"))
        # sync-aggregate participation on recent blocks
        body = ref.head().head_block.message.body
        if hasattr(body, "sync_aggregate"):
            bits = body.sync_aggregate.sync_committee_bits
            rate = sum(1 for b in bits if b) / max(1, len(bits))
            out.append(CheckResult("sync_participation", rate > 0.5,
                                   f"{rate:.2f}"))
        return out

    def stop(self) -> None:
        for n in self.nodes:
            if not n.dead:
                n.network.stop()
            if n.api_server is not None and not n.dead:
                n.api_server.stop()


def write_stitched_trace(path: str, spans=None) -> str:
    """Dump the span ring (the whole in-process fleet shares one) as a
    stitched Chrome trace: one pid per node label, graftpath flow arrows
    for the cross-node publish->deliver/import edges — loads in Perfetto
    as a fleet, not a soup (obs/causal.py)."""
    import json
    from ..obs import causal, tracing
    doc = causal.stitched_chrome_trace(
        tracing.snapshot() if spans is None else spans)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--validators", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--http", action="store_true",
                    help="drive VCs through real per-node HTTP APIs")
    ap.add_argument("--scenario", default=None,
                    help="run a named adversarial scenario "
                         "(see testing/scenarios.py) instead of the "
                         "plain liveness sim")
    ap.add_argument("--seed", type=int, default=0,
                    help="fault-injection seed (scenarios only)")
    ap.add_argument("--dump-trace", default=None, metavar="PATH",
                    help="after the run, write the stitched cross-node "
                         "Chrome trace (one pid per node) to PATH")
    args = ap.parse_args(argv)
    if args.scenario:
        from .scenarios import run_scenario, scenario_names
        if args.scenario == "list":
            for name in scenario_names():
                print(name)
            return 0
        result = run_scenario(args.scenario, seed=args.seed)
        print(result.render())
        if args.dump_trace:
            print(f"stitched trace -> "
                  f"{write_stitched_trace(args.dump_trace)}")
        return 0 if result.ok else 1
    spec = minimal_spec(altair_fork_epoch=0)
    net = LocalNetwork(spec, args.nodes, args.validators,
                       use_http=args.http)
    try:
        net.run_slots(args.epochs * spec.preset.slots_per_epoch)
        results = net.checks(args.epochs)
    finally:
        net.stop()
    if args.dump_trace:
        print(f"stitched trace -> {write_stitched_trace(args.dump_trace)}")
    ok = True
    for r in results:
        print(f"[{'PASS' if r.ok else 'FAIL'}] {r.name}: {r.detail}")
        ok &= r.ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
