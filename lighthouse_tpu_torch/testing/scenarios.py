"""Adversarial mainnet scenarios over the fault-injecting LocalNetwork.

Each scenario drives production nodes through a mainnet incident shape —
long non-finality, partition + heal, slashable equivocation, checkpoint
sync into a partitioned network, an invalid-signature gossip flood — and
asserts a DEGRADATION ENVELOPE
evaluated by the graftwatch SLO engine (pipeline-p95 and head-lag
objectives over the slot-sampled rings, plus the scoped graftscope
capture) alongside the correctness outcome.
"Didn't crash and eventually agreed" is not a pass; "stayed inside the
envelope while degraded and recovered the invariants afterwards" is.

Every scenario is a pure function of its seed: the fault schedule comes
from ``FaultInjector(seed)``'s RNG on a logical tick clock, and the spam
in the flood scenario is generated from the same seed.

Run one:    python -m lighthouse_tpu_torch.testing.simulator \
                --scenario partition_heal --seed 7
List:       python -m lighthouse_tpu_torch.testing.simulator --scenario list
"""
from __future__ import annotations

import random
import shutil
import tempfile
import time
from dataclasses import dataclass, field

from ..api.metrics import counter_value
from ..network.faults import FaultInjector, PeerBehavior
from ..network.sync import range_sync as range_sync_mod
from ..obs import doctor as flight_doctor
from ..obs import graftwatch, timeseries
from ..obs.capture import ScenarioTrace, scenario_capture
from ..specs import minimal_spec
from ..ssz import htr
from ..validator_client.byzantine import ByzantineValidatorClient
from .simulator import CheckResult, LocalNetwork

#: wall-clock p95 envelope for one gossip block through the full
#: verify->import pipeline under fault load (generous: CI boxes are slow,
#: and the assertion exists to catch order-of-magnitude regressions like
#: a lock convoy or a state-replay storm, not 10% noise)
PIPELINE_P95_MS = 5000.0


@dataclass
class ScenarioResult:
    name: str
    seed: int
    checks: list[CheckResult] = field(default_factory=list)
    trace: ScenarioTrace | None = None
    dump_path: str | None = None        # flight dump, if one was written
    diagnosis: str | None = None        # rendered doctor report over it

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    def render(self) -> str:
        lines = [f"scenario {self.name} (seed {self.seed}): "
                 f"{'PASS' if self.ok else 'FAIL'}"]
        for c in self.checks:
            lines.append(f"  [{'PASS' if c.ok else 'FAIL'}] "
                         f"{c.name}: {c.detail}")
        if self.trace is not None and self.trace.spans:
            lines.append(self.trace.table())
        return "\n".join(lines)


_REGISTRY: dict[str, object] = {}
#: scenarios too long for tier-1; tests put these behind the slow marker
SLOW_SCENARIOS = frozenset({"long_nonfinality",
                            "checkpoint_sync_partition",
                            "sync_byzantine_pool",
                            "backfill_under_stall",
                            "checkpoint_backfill_replay"})


def scenario(name: str):
    def wrap(fn):
        _REGISTRY[name] = fn
        return fn
    return wrap


def scenario_names() -> list[str]:
    return sorted(_REGISTRY)


def run_scenario(name: str, seed: int = 0) -> ScenarioResult:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; have "
                       f"{scenario_names()}")
    return _REGISTRY[name](seed)


# -- shared assertion helpers -------------------------------------------------

def _chk(result: ScenarioResult, name: str, ok: bool, detail: str) -> bool:
    result.checks.append(CheckResult(name, bool(ok), detail))
    return bool(ok)


def _envelope_checks(result: ScenarioResult, net: LocalNetwork,
                     trace: ScenarioTrace, max_head_lag: int = 1,
                     require_propagation: bool = False) -> None:
    """The degradation envelope every scenario ends on, evaluated by the
    graftwatch SLO engine — the same objectives a live node watches each
    slot: blocks kept flowing through the pipeline, the pipeline-p95
    objective never breached, and the head-lag objective is clean (any
    mid-scenario incident resolved) by scenario end.  With
    ``require_propagation`` the graftpath publish->import propagation
    histogram must have seen traffic and the propagation_p95 SLO must be
    clean."""
    _chk(result, "pipeline_active", trace.count("block_pipeline") > 0,
         f"{trace.count('block_pipeline')} gossip block pipelines traced")
    status = graftwatch.get().engine.status()
    p95 = trace.p95_ms("block_pipeline")
    pipe = status["block_pipeline_p95"]
    _chk(result, "pipeline_p95",
         pipe["open_incident"] is None and p95 < PIPELINE_P95_MS,
         f"SLO clean ({pipe['last_detail']}); capture p95 {p95:.1f}ms "
         f"< {PIPELINE_P95_MS:.0f}ms")
    chain = net.live_nodes[0].harness.chain
    lag = chain.slot() - chain.head().head_state.slot
    head = status["head_lag"]
    _chk(result, "head_lag",
         head["open_incident"] is None and lag <= max_head_lag,
         f"SLO clean ({head['last_detail']}); live lag {lag} slots "
         f"(max {max_head_lag})")
    if require_propagation:
        _propagation_check(result, status)


def _propagation_check(result: ScenarioResult, status: dict) -> None:
    """Assert the graftpath publish->import propagation histogram saw
    traffic over the scenario and the propagation_p95 SLO ended clean."""
    import numpy as np
    sampler = timeseries.get_sampler()
    _slots, counts = sampler.series("block_propagation_seconds.count")
    total = float(np.nansum(counts)) if counts.size else 0.0
    p95_s = sampler.latest("block_propagation_seconds.p95")
    prop = status["propagation_p95"]
    _chk(result, "propagation_p95",
         prop["open_incident"] is None and total > 0,
         f"SLO clean ({prop['last_detail']}); {total:.0f} stitched "
         f"publish->import propagations sampled, last-slot p95 "
         f"{(p95_s or 0.0) * 1000.0:.1f}ms")


def _chain_blocks(chain, max_back: int = 128):
    """Head-chain blocks, newest first."""
    root = chain.head().head_block_root
    for _ in range(max_back):
        blk = chain.store.get_block(root)
        if blk is None:
            return
        yield blk
        if blk.message.slot == 0:
            return
        root = bytes(blk.message.parent_root)


def _head_ancestors(chain, max_back: int = 256) -> set[bytes]:
    out = set()
    root = chain.head().head_block_root
    for _ in range(max_back):
        out.add(root)
        blk = chain.store.get_block(root)
        if blk is None or blk.message.slot == 0:
            return out
        root = bytes(blk.message.parent_root)
    return out


def _fork_slot(chain_a, chain_b) -> int:
    """Slot of the last block both heads descend from."""
    seen = _head_ancestors(chain_a)
    root = chain_b.head().head_block_root
    for _ in range(256):
        if root in seen:
            blk = chain_b.store.get_block(root)
            return int(blk.message.slot) if blk is not None else 0
        blk = chain_b.store.get_block(root)
        if blk is None:
            return 0
        root = bytes(blk.message.parent_root)
    return 0


def _wait_statuses(node, node_ids, timeout: float = 8.0) -> bool:
    """Block until `node` holds a STATUS for every peer in node_ids —
    the connect-time exchange runs on background threads."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        infos = node.network.peers.peers
        if all(infos.get(n) is not None and infos[n].status is not None
               for n in node_ids):
            return True
        time.sleep(0.02)
    return False


# -- 1. slashable equivocation ------------------------------------------------

@scenario("equivocation")
def scenario_equivocation(seed: int = 0) -> ScenarioResult:
    """A byzantine VC double-proposes for one epoch, then double-votes
    for two slots.  The honest pipeline must reject the equivocations
    from gossip, the slasher must mint records carrying BOTH signed
    messages, and the resulting slashing operations must reach a block
    and flip validators.slashed."""
    result = ScenarioResult("equivocation", seed)
    spec = minimal_spec(altair_fork_epoch=0)
    spe = spec.preset.slots_per_epoch
    net = LocalNetwork(spec, 2, 32, with_slasher=True)
    try:
        byz = ByzantineValidatorClient(net.nodes[1].vc,
                                       mode="double_propose")
        net.nodes[1].vc = byz
        with scenario_capture() as trace:
            net.run_slots(spe)               # double proposals
            byz.mode = "double_vote"
            net.run_slots(2)                 # a couple of double votes
            byz.mode = "honest"
            net.run_slots(2 * spe)           # recovery: slashings land
        result.trace = trace
        _chk(result, "equivocations_published", byz.equivocations > 0,
             f"{byz.equivocations} second messages published")
        records = net.nodes[1].slasher.slashings
        prop = [r for r in records
                if r.kind == "double" and hasattr(r.attestation_1,
                                                  "message")]
        att = [r for r in records
               if r.kind == "double" and hasattr(r.attestation_1,
                                                 "attesting_indices")]
        _chk(result, "proposer_records", len(prop) > 0,
             f"{len(prop)} double-proposal records (both headers "
             "attached)")
        _chk(result, "attester_records", len(att) > 0,
             f"{len(att)} double-vote records (both attestations "
             "attached)")
        # the slashings must have been packed into canonical blocks
        chain = net.nodes[0].harness.chain
        packed_prop = packed_att = 0
        for blk in _chain_blocks(chain):
            packed_prop += len(blk.message.body.proposer_slashings)
            packed_att += len(blk.message.body.attester_slashings)
        _chk(result, "slashings_in_blocks",
             packed_prop > 0 and packed_att > 0,
             f"{packed_prop} proposer + {packed_att} attester slashings "
             "on the canonical chain")
        slashed = int(chain.head().head_state.validators.slashed.sum())
        _chk(result, "validators_slashed", slashed > 0,
             f"{slashed} validators slashed in the head state")
        heads = {n.harness.chain.head().head_block_root
                 for n in net.live_nodes}
        _chk(result, "converged", len(heads) == 1,
             f"{len(heads)} distinct heads after recovery")
        _envelope_checks(result, net, trace)
    finally:
        net.stop()
    return result


# -- 2. invalid-signature gossip flood ----------------------------------------

@scenario("signature_flood")
def scenario_signature_flood(seed: int = 0) -> ScenarioResult:
    """One node floods the attestation subnets with structurally valid,
    wrongly-signed attestations.  The victim runs batched gossip
    verification behind the priority processor with a lowered
    attestation queue cap: the batch verifier must take the per-item
    fallback split, the queue must shed load (counter + high-water), and
    honest block flow must stay inside the envelope.

    Doubles as the serving-tier load test: while the flood
    runs, a VC-fleet-shaped read load (duties + attestation_data every
    slot) hammers the victim's API through the serving tier — the tier
    must coalesce/cache the reads and the ``serving_p95`` SLO must be
    clean at scenario end."""
    result = ScenarioResult("signature_flood", seed)
    spec = minimal_spec(altair_fork_epoch=0)
    spe = spec.preset.slots_per_epoch
    rng = random.Random(seed)
    net = LocalNetwork(spec, 2, 32, use_processor=True,
                       batch_gossip_verification=True)
    try:
        from ..beacon_processor import WorkType
        from ..containers import get_types
        from ..state_transition.helpers import get_beacon_committee
        victim = net.nodes[0]
        proc = victim.network.processor
        CAP = 32
        proc.caps[WorkType.GOSSIP_ATTESTATION] = CAP
        # peer scoring would (correctly) ban the flooding peer after its
        # first garbage batch — on mainnet the attacker just reconnects
        # from the next Sybil identity, so model that by disabling the
        # cut-off and asserting the ban-worthy downscore happened instead
        victim.network.peers.BAN_THRESHOLD = float("-inf")
        # fake-BLS verification is free; restore a mainnet-shaped cost
        # (~1ms/signature) on the victim so the flood actually pressures
        # the queue the way real BLS would
        chain0 = victim.harness.chain
        real_batch = chain0.batch_verify_unaggregated_attestations_for_gossip

        def costed_batch(pairs):
            time.sleep(0.001 * len(pairs))
            return real_batch(pairs)

        chain0.batch_verify_unaggregated_attestations_for_gossip = \
            costed_batch
        T = get_types(spec.preset)
        net.run_slots(spe)                   # honest warm-up
        drop0 = counter_value("beacon_processor_work_dropped_total")
        fb0 = counter_value("beacon_batch_verify_fallback_total")
        flooded = 0
        # the victim also serves a VC fleet while under flood: route the
        # per-slot hot-path reads through the serving tier (keep a strong
        # ref — the graftwatch registry is weak)
        from ..api.serving import ServingTier
        serving = ServingTier(victim.backend)

        def flood(slot: int) -> None:
            # structurally valid for the victim's inline checks; only
            # the (deferred) signature is garbage — so every one of
            # these rides the batch queue to the verifier
            nonlocal flooded
            src = net.nodes[1]
            state = src.harness.chain.head().head_state
            data = src.backend.attestation_data(slot, 0)
            committee = get_beacon_committee(state, slot, 0)
            for _ in range(300):
                pos = rng.randrange(len(committee))
                bits = [i == pos for i in range(len(committee))]
                # leading 0xff = invalid under every backend (poison
                # byte on fake, non-canonical G2 on real); random tail
                # keeps every message id distinct so gossip dedup
                # doesn't thin the flood
                att = T.Attestation(
                    aggregation_bits=bits, data=data,
                    signature=b"\xff" + bytes(rng.getrandbits(8)
                                              for _ in range(95)))
                src.network.publish_attestation(att, subnet=0)
                flooded += 1
            # the VC fleet's reads for this slot: identical per-slot
            # requests the tier should collapse to one computation each
            for _ in range(40):
                serving.proposer_duties(slot // spe)
                serving.attestation_data(slot, 0)

        with scenario_capture() as trace:
            net.run_slots(3, mid_slot=flood)
            proc.wait_idle()
            net.run_slots(spe - 3)           # drain + recover
        result.trace = trace
        fallback = counter_value("beacon_batch_verify_fallback_total") - fb0
        dropped = counter_value("beacon_processor_work_dropped_total") \
            - drop0
        _chk(result, "flood_sent", flooded >= 900,
             f"{flooded} invalid attestations flooded")
        _chk(result, "batch_fallback_split", fallback > 0,
             f"batch verifier split into per-item retries {fallback:.0f} "
             "times")
        _chk(result, "load_shed", dropped > 0 and proc.dropped > 0,
             f"{dropped:.0f} work items shed at the cap "
             f"(processor.dropped={proc.dropped})")
        shed_incs = graftwatch.get().engine.incidents_for(
            "processor_shedding")
        _chk(result, "slo_shedding_incident", len(shed_incs) > 0,
             f"flood tripped the processor_shedding SLO "
             f"{len(shed_incs)} time(s), first at slot "
             f"{shed_incs[0].opened_slot if shed_incs else '-'}")
        _chk(result, "queue_high_water", proc.high_water >= CAP,
             f"queue high-water {proc.high_water} >= cap {CAP}")
        ssnap = serving.snapshot()
        _chk(result, "serving_coalesced",
             ssnap["requests"] >= 200
             and (ssnap["cache_hits"] + ssnap["coalesced"]) > 0,
             f"{ssnap['requests']} VC reads served, "
             f"{ssnap['cache_hits']} cache hits + "
             f"{ssnap['coalesced']} coalesced (hit ratio "
             f"{(ssnap['cache_hit_ratio'] or 0.0):.2f})")
        sp = graftwatch.get().engine.status()["serving_p95"]
        _chk(result, "serving_p95", sp["open_incident"] is None,
             f"serving-tier p95 SLO clean at scenario end "
             f"({sp['last_detail']})")
        flooder_score = victim.network.peers.score(
            net.nodes[1].network.transport.node_id)
        _chk(result, "flooder_downscored", flooder_score < -20.0,
             f"flooding peer's score {flooder_score:.1f} crossed the "
             "default ban threshold (-20)")
        heads = {n.harness.chain.head().head_block_root
                 for n in net.live_nodes}
        _chk(result, "converged", len(heads) == 1,
             f"{len(heads)} distinct heads after the flood")
        _envelope_checks(result, net, trace, require_propagation=True)
    finally:
        net.stop()
    return result


# -- 3. partition and heal ----------------------------------------------------

@scenario("partition_heal")
def scenario_partition_heal(seed: int = 0) -> ScenarioResult:
    """Split a 4-node mesh 2|2 for two epochs, then heal.  Both sides
    must keep producing on their fork; after healing every node must
    re-org onto one winner, with the measured re-org depth bounded by
    the partition length and convergence inside a wall-clock budget."""
    result = ScenarioResult("partition_heal", seed)
    spec = minimal_spec(altair_fork_epoch=0)
    spe = spec.preset.slots_per_epoch
    injector = FaultInjector(seed)
    net = LocalNetwork(spec, 4, 32, topology="mesh", injector=injector)
    # the partition must surface through graftwatch, not just the
    # hand-rolled fork checks: auto-dump a flight recording the moment
    # an incident opens, assert the head-lag incident lifecycle, and
    # round-trip the dump through the offline doctor
    watch = graftwatch.get()
    dump_dir = tempfile.mkdtemp(prefix="graftwatch_scn_")
    watch.configure(auto_dump=True, dump_dir=dump_dir)
    try:
        net.run_slots(spe)                   # healthy baseline
        part_start = int(net.nodes[0].harness.chain.slot())
        net.partition([0, 1], [2, 3])
        partition_slots = 2 * spe
        with scenario_capture() as trace:
            net.run_slots(partition_slots)
            chain_a = net.nodes[0].harness.chain
            chain_b = net.nodes[2].harness.chain
            head_a = chain_a.head()
            head_b = chain_b.head()
            _chk(result, "links_severed", injector.links_severed > 0,
                 f"{injector.links_severed} cross-partition connections "
                 "closed")
            _chk(result, "sides_diverged",
                 head_a.head_block_root != head_b.head_block_root,
                 "partition sides built distinct forks")
            _chk(result, "both_sides_advanced",
                 head_a.head_state.slot > spe
                 and head_b.head_state.slot > spe,
                 f"side heads at slots {head_a.head_state.slot} / "
                 f"{head_b.head_state.slot}")
            fork_slot = _fork_slot(chain_a, chain_b)
            t0 = time.monotonic()
            net.heal()
            net.run_slots(spe)
            converged = net._wait_convergence(timeout=20.0)
            t_heal = time.monotonic() - t0
        result.trace = trace
        _chk(result, "reconverged", converged,
             f"all nodes on one head {t_heal:.1f}s after heal")
        _chk(result, "convergence_time", t_heal < 60.0,
             f"{t_heal:.1f}s < 60s")
        # the losing side's fork is fully re-orged out; its depth is
        # bounded by what the partition could have built
        final = net.nodes[0].harness.chain.head().head_block_root
        loser = (head_b if final in _head_ancestors(chain_a)
                 or head_a.head_block_root == final else head_a)
        depth = int(loser.head_state.slot) - fork_slot
        _chk(result, "reorg_depth_bounded",
             0 < depth <= partition_slots,
             f"re-org depth {depth} slots (fork at {fork_slot}, "
             f"partition lasted {partition_slots})")
        # SLO-engine view of the same event: the partition opened a
        # head-lag incident, and the heal let every incident resolve
        incs = [i for i in watch.engine.incidents_for("head_lag")
                if i.opened_slot > part_start]
        _chk(result, "slo_incident_opened", len(incs) > 0,
             f"head-lag incidents opened at slots "
             f"{[i.opened_slot for i in incs]} "
             f"(partition began after slot {part_start})")
        _chk(result, "slo_incident_resolved",
             bool(incs) and all(not i.open for i in incs)
             and not watch.engine.open_incidents(),
             f"resolved at slots {[i.resolved_slot for i in incs]}; "
             "no incident still open after heal")
        # incident-open wrote a flight dump; the offline doctor must
        # turn it into a non-empty correlated diagnosis
        result.dump_path = watch.recorder.last_path
        dumped = result.dump_path is not None
        _chk(result, "flight_dump_written", dumped,
             f"auto-dump wrote {result.dump_path}")
        if dumped:
            diag = flight_doctor.diagnose(
                flight_doctor.load(result.dump_path))
            result.diagnosis = flight_doctor.render(diag)
            lag_diags = [d for d in diag["incidents"]
                         if d["slo"] == "head_lag" and d["correlations"]]
            _chk(result, "doctor_diagnosis", len(lag_diags) > 0,
                 f"doctor correlated {len(lag_diags)} head-lag "
                 f"incident(s) with "
                 f"{sum(len(d['correlations']) for d in lag_diags)} "
                 "co-occurring signals")
        # graftpath: blocks still crossed the (healed) mesh under
        # observation, and the propagation objective ended clean — the
        # second scenario envelope asserting through propagation_p95
        _propagation_check(result, watch.engine.status())
    finally:
        watch.configure(auto_dump=False)
        watch.recorder.dump_dir = None
        shutil.rmtree(dump_dir, ignore_errors=True)
        net.stop()
    return result


# -- 4. long non-finality -----------------------------------------------------

@scenario("long_nonfinality")
def scenario_long_nonfinality(seed: int = 0) -> ScenarioResult:
    """Half the stake goes vote-silent (still proposing) for six epochs:
    finality must stall, the head must keep tracking the slot clock, and
    proto-array growth must stay bounded.  When the silent stake returns,
    finality must resume and maybe_prune must reclaim the fork-choice
    array."""
    result = ScenarioResult("long_nonfinality", seed)
    spec = minimal_spec(altair_fork_epoch=0)
    spe = spec.preset.slots_per_epoch
    net = LocalNetwork(spec, 2, 32)
    try:
        net.run_slots(4 * spe)               # establish finality
        chain = net.nodes[0].harness.chain
        fin0 = chain.finalized_checkpoint()[0]
        _chk(result, "finality_established", fin0 >= 1,
             f"finalized epoch {fin0} before the outage")
        byz = ByzantineValidatorClient(net.nodes[1].vc, mode="silent")
        net.nodes[1].vc = byz
        stall_epochs = 6
        with scenario_capture() as trace:
            net.run_slots(stall_epochs * spe)
        result.trace = trace
        fin_stalled = chain.finalized_checkpoint()[0]
        _chk(result, "finality_stalled", fin_stalled <= fin0 + 1,
             f"finalized epoch {fin_stalled} after {stall_epochs} silent "
             f"epochs (was {fin0})")
        nodes_peak = len(chain.fork_choice.proto_array.nodes)
        slots_elapsed = (4 + stall_epochs) * spe
        _chk(result, "proto_array_bounded",
             nodes_peak <= slots_elapsed + 16,
             f"proto-array holds {nodes_peak} nodes <= "
             f"{slots_elapsed + 16}")
        _envelope_checks(result, net, trace)
        # recovery: votes return, finality advances, prune reclaims.
        # The production prune_threshold (256) exists to amortize index
        # rewrites on mainnet-sized arrays; drop it so this ~100-node run
        # exercises the reclaim path itself.
        for n in net.nodes:
            n.harness.chain.fork_choice.proto_array.prune_threshold = 0
        byz.mode = "honest"
        net.run_slots(4 * spe)
        fin_rec = chain.finalized_checkpoint()[0]
        _chk(result, "finality_recovered", fin_rec > fin_stalled,
             f"finalized epoch {fin_rec} > {fin_stalled}")
        nodes_after = len(chain.fork_choice.proto_array.nodes)
        _chk(result, "proto_array_pruned", nodes_after < nodes_peak,
             f"maybe_prune reclaimed {nodes_peak - nodes_after} "
             f"proto-array nodes ({nodes_peak} -> {nodes_after})")
    finally:
        net.stop()
    return result


# -- 5. checkpoint sync into a partition --------------------------------------

@scenario("checkpoint_sync_partition")
def scenario_checkpoint_sync_partition(seed: int = 0) -> ScenarioResult:
    """A fresh node weak-subjectivity-syncs against a node that, unknown
    to it, sits on the minority side of a partition.  It must follow the
    minority fork (that is all it can see), then re-org onto the
    majority chain once the partition heals — checkpoint sync must not
    pin it to the minority."""
    result = ScenarioResult("checkpoint_sync_partition", seed)
    spec = minimal_spec(altair_fork_epoch=0)
    spe = spec.preset.slots_per_epoch
    injector = FaultInjector(seed)
    net = LocalNetwork(spec, 3, 48, topology="mesh", injector=injector)
    try:
        net.run_slots(4 * spe)               # finality for the anchor
        fin0 = net.nodes[2].harness.chain.finalized_checkpoint()[0]
        _chk(result, "anchor_finalized", fin0 >= 2,
             f"anchor node finalized epoch {fin0}")
        net.partition([0, 1], [2])
        net.run_slots(spe)                   # sides diverge
        with scenario_capture() as trace:
            i3 = net.add_node(anchor_from=2, dial=[2], group=1)
            net.run_slots(spe)
            chain3 = net.nodes[i3].harness.chain
            chain_minor = net.nodes[2].harness.chain
            chain_major = net.nodes[0].harness.chain
            _chk(result, "synced_past_anchor",
                 chain3.head().head_state.slot >
                 fin0 * spe,
                 f"synced node head at slot "
                 f"{chain3.head().head_state.slot}")
            _chk(result, "follows_minority",
                 chain3.head().head_block_root ==
                 chain_minor.head().head_block_root,
                 "synced node sits on the minority head")
            _chk(result, "minority_is_fork",
                 chain3.head().head_block_root !=
                 chain_major.head().head_block_root,
                 "minority head differs from the majority head")
            net.heal()
            net.run_slots(2 * spe)
            converged = net._wait_convergence(timeout=20.0)
        result.trace = trace
        _chk(result, "healed_converged", converged,
             "all four nodes agree after heal")
        _chk(result, "reorged_to_majority",
             chain3.head().head_block_root ==
             chain_major.head().head_block_root,
             "synced node re-orged onto the majority chain")
        _envelope_checks(result, net, trace, max_head_lag=2)
    finally:
        net.stop()
    return result


# -- 6. byzantine range-sync pool ---------------------------------------------

@scenario("sync_byzantine_pool")
def scenario_sync_byzantine_pool(seed: int = 0) -> ScenarioResult:
    """A fresh node range-syncs with 3 of its 5 serving peers byzantine
    (one each stall / junk / truncate).  Per-request deadlines, the
    download-time batch validator and precise truncation blame must
    penalize each adversary below the ban threshold WITHOUT a single
    rejected batch reaching process_chain_segment and without any
    global pump stall, and the sync must then complete from the honest
    peers that the failed byzantine pool must not be able to poison."""
    result = ScenarioResult("sync_byzantine_pool", seed)
    spec = minimal_spec(altair_fork_epoch=0)
    spe = spec.preset.slots_per_epoch
    injector = FaultInjector(seed)
    # behaviors are label-keyed, so the victim n5's links can be rigged
    # before it exists
    injector.set_behavior("n0", "n5",
                          PeerBehavior("stall", stall_secs=6.0))
    injector.set_behavior("n1", "n5", PeerBehavior("junk"))
    injector.set_behavior("n2", "n5",
                          PeerBehavior("truncate", keep_fraction=0.5))
    net = LocalNetwork(spec, 5, 40, topology="mesh", injector=injector)
    watch = graftwatch.get()
    rejects0 = counter_value("sync_batch_validation_rejects_total")
    expired0 = counter_value("sync_request_deadline_expired_total")
    gstall0 = counter_value("sync_pump_global_stall_total")
    restore = []
    try:
        net.run_slots(3 * spe)               # history worth syncing
        vi = net.add_fresh_node(dial=[])     # knobs first, dial after
        victim = net.nodes[vi]
        sync = victim.network.sync
        peers = victim.network.peers
        chain5 = victim.harness.chain
        # scenario-speed knobs: tight deadlines and near-zero backoff so
        # the stall adversary burns 0.75s per hit instead of 20s, small
        # batches so every adversary serves several times.  Quarantine is
        # disabled (scenario 7 exercises it): here the SCORE ledger alone
        # must cross the ban line, which is lowered to what a pool-scoped
        # penalty run can reach before the pool excludes negative peers.
        sync.ctx.request_timeout = 0.75
        bo = sync.ctx.backoff
        bo.BASE_DELAY = 0.05
        bo.MAX_DELAY = 0.2
        bo.QUARANTINE_AFTER = 10 ** 6
        sync.range.batch_slots = 2
        peers.BAN_THRESHOLD = -8.0
        # a banned peer disconnects and its PeerInfo is dropped, after
        # which score() reads 0.0 — mirror the ledger here
        tally: dict[str, float] = {}
        real_report = peers.report

        def tallied_report(node_id, event):
            tally[node_id] = (tally.get(node_id, 0.0)
                              + peers.SCORES.get(event, 0.0))
            real_report(node_id, event)

        peers.report = tallied_report
        restore.append(lambda: setattr(peers, "report", real_report))
        # reject spy: the exact list object a validation reject discarded
        # must never reach process_chain_segment (the junk adversary
        # serves REAL blocks from the wrong range, so root-based matching
        # would false-positive on their later honest arrival)
        real_validate = range_sync_mod.validate_range_batch
        rejected_lists: list = []

        def spying_validate(blocks, start, count, **kw):
            res = real_validate(blocks, start, count, **kw)
            if not res.ok and res.reason != "continuity" and blocks:
                rejected_lists.append(blocks)
            return res

        range_sync_mod.validate_range_batch = spying_validate
        restore.append(lambda: setattr(
            range_sync_mod, "validate_range_batch", real_validate))
        real_process = chain5.process_chain_segment
        leaked: list = []

        def guarded_process(blocks):
            if any(blocks is r for r in rejected_lists):
                leaked.append(len(blocks))
            return real_process(blocks)

        chain5.process_chain_segment = guarded_process
        nid = [net.nodes[j].network.transport.node_id for j in range(5)]
        with scenario_capture() as trace:
            # phase A: only the three byzantine peers serve
            for j in (0, 1, 2):
                victim.network.dial("127.0.0.1",
                                    net.nodes[j].network.port)
            _wait_statuses(victim, nid[:3])
            deadline = time.monotonic() + 25.0
            while time.monotonic() < deadline:
                sync.maybe_sync()
                if all(tally.get(n, 0.0) < peers.BAN_THRESHOLD
                       for n in nid[:3]):
                    break
                time.sleep(0.05)
            # phase B: honest peers arrive; the targets the byzantine
            # pool failed must still be syncable from them
            for j in (3, 4):
                victim.network.dial("127.0.0.1",
                                    net.nodes[j].network.port)
            _wait_statuses(victim, nid[3:5])
            target = net.nodes[3].harness.chain.head().head_block_root
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                sync.maybe_sync()
                if chain5.head().head_block_root == target:
                    break
                time.sleep(0.05)
            net.run_slots(spe)               # envelope traffic
        result.trace = trace
        _chk(result, "synced_from_honest",
             chain5.head().head_block_root ==
             net.nodes[3].harness.chain.head().head_block_root,
             f"victim head at slot {chain5.head().head_state.slot} "
             "matches the honest peers'")
        for j, kind in ((0, "stall"), (1, "junk"), (2, "truncate")):
            _chk(result, f"{kind}_peer_banned",
                 tally.get(nid[j], 0.0) < peers.BAN_THRESHOLD,
                 f"n{j} ({kind}) penalty ledger "
                 f"{tally.get(nid[j], 0.0):.1f} < ban threshold "
                 f"{peers.BAN_THRESHOLD}")
        rejects = counter_value("sync_batch_validation_rejects_total") \
            - rejects0
        _chk(result, "batches_rejected_at_download", rejects > 0,
             f"{rejects:.0f} batches rejected by download-time "
             "validation")
        _chk(result, "rejects_never_processed",
             len(rejected_lists) > 0 and not leaked,
             f"{len(rejected_lists)} rejected batches, "
             f"{len(leaked)} reached process_chain_segment")
        expired = counter_value("sync_request_deadline_expired_total") \
            - expired0
        _chk(result, "per_request_deadlines_fired", expired > 0,
             f"{expired:.0f} per-request deadline expiries (stall peer)")
        gstall = counter_value("sync_pump_global_stall_total") - gstall0
        _chk(result, "zero_global_stalls", gstall == 0,
             f"{gstall:.0f} global pump stalls (per-request deadlines "
             "replace them)")
        sp = watch.engine.status()["sync_progress"]
        sp_incs = watch.engine.incidents_for("sync_progress")
        _chk(result, "slo_sync_progress_clean",
             sp["open_incident"] is None
             and all(not i.open for i in sp_incs),
             f"sync_progress SLO open_incident={sp['open_incident']}, "
             f"{len(sp_incs)} incident(s) all resolved")
        _envelope_checks(result, net, trace, max_head_lag=2)
    finally:
        for undo in restore:
            undo()
        net.stop()
    return result


# -- 7. backfill under stall --------------------------------------------------

@scenario("backfill_under_stall")
def scenario_backfill_under_stall(seed: int = 0) -> ScenarioResult:
    """A checkpoint-synced node backfills its pre-anchor history while
    one serving peer stalls every by-range request and another truncates
    its responses.  The per-request deadline must fail the stalled
    requests individually, consecutive failures must QUARANTINE the
    stall peer, and backfill must still walk the anchor to genesis with
    a complete block history."""
    result = ScenarioResult("backfill_under_stall", seed)
    spec = minimal_spec(altair_fork_epoch=0)
    spe = spec.preset.slots_per_epoch
    injector = FaultInjector(seed)
    injector.set_behavior("n1", "n3",
                          PeerBehavior("stall", stall_secs=5.0))
    injector.set_behavior("n2", "n3",
                          PeerBehavior("truncate", keep_fraction=0.5))
    net = LocalNetwork(spec, 3, 48, topology="mesh", injector=injector)
    quar0 = counter_value("sync_peer_quarantined_total")
    expired0 = counter_value("sync_request_deadline_expired_total")
    gstall0 = counter_value("sync_pump_global_stall_total")
    try:
        net.run_slots(4 * spe)               # finality for the anchor
        fin0 = net.nodes[0].harness.chain.finalized_checkpoint()[0]
        _chk(result, "anchor_finalized", fin0 >= 2,
             f"anchor node finalized epoch {fin0}")
        i3 = net.add_node(anchor_from=0, dial=[])
        node3 = net.nodes[i3]
        sync3 = node3.network.sync
        chain3 = node3.harness.chain
        # peer-table entries can be popped by benign duplicate-dial
        # teardowns, so "never banned" is asserted on the on_ban
        # callback, not on the entry's survival
        bans: list[str] = []
        real_on_ban = node3.network.peers.on_ban

        def recording_on_ban(node_id):
            bans.append(node_id)
            real_on_ban(node_id)

        node3.network.peers.on_ban = recording_on_ban
        sync3.ctx.request_timeout = 0.75
        bo = sync3.ctx.backoff
        bo.BASE_DELAY = 0.05
        bo.MAX_DELAY = 0.2
        bo.QUARANTINE_AFTER = 2              # quarantine ON and quick
        nid = [net.nodes[j].network.transport.node_id for j in range(3)]
        for j in range(3):
            node3.network.dial("127.0.0.1", net.nodes[j].network.port)
        _wait_statuses(node3, nid)
        anchor_start = chain3.store.backfill_anchor()
        with scenario_capture() as trace:
            deadline = time.monotonic() + 25.0
            while time.monotonic() < deadline:
                sync3.backfill(batch_slots=4)
                anchor = chain3.store.backfill_anchor()
                if anchor is None or anchor[0] == 0:
                    break
                time.sleep(0.05)
            net.run_slots(spe)               # envelope traffic
        result.trace = trace
        anchor = chain3.store.backfill_anchor()
        _chk(result, "backfill_complete",
             anchor is None or anchor[0] == 0,
             f"backfill anchor {anchor} (started at {anchor_start})")
        # every canonical block below the original anchor must now be in
        # the synced node's store
        checked = missing = 0
        for blk in _chain_blocks(net.nodes[0].harness.chain):
            if (anchor_start is not None
                    and blk.message.slot < anchor_start[0]):
                checked += 1
                if chain3.store.get_block(htr(blk.message)) is None:
                    missing += 1
        _chk(result, "history_complete", checked > 0 and missing == 0,
             f"{checked} pre-anchor canonical blocks checked, "
             f"{missing} missing")
        quarantined = counter_value("sync_peer_quarantined_total") - quar0
        _chk(result, "stall_peer_quarantined", quarantined >= 1,
             f"{quarantined:.0f} peer quarantines (stall peer cut off "
             "after consecutive deadline failures)")
        expired = counter_value("sync_request_deadline_expired_total") \
            - expired0
        _chk(result, "per_request_deadlines_fired", expired > 0,
             f"{expired:.0f} per-request deadline expiries")
        gstall = counter_value("sync_pump_global_stall_total") - gstall0
        _chk(result, "zero_global_stalls", gstall == 0,
             f"{gstall:.0f} global pump stalls")
        served = injector.behaviors_served
        _chk(result, "adversaries_served",
             served.get("stall", 0) > 0 and served.get("truncate", 0) > 0,
             f"byzantine serves: {dict(served)}")
        info0 = node3.network.peers.peers.get(nid[0])
        _chk(result, "honest_peer_retained",
             nid[0] not in bans
             and (info0 is None or not info0.banned),
             "the honest serving peer was never banned")
        _envelope_checks(result, net, trace, max_head_lag=2)
    finally:
        net.stop()
    return result


# -- 8. lying STATUS chain ----------------------------------------------------

@scenario("lying_status_chain")
def scenario_lying_status_chain(seed: int = 0) -> ScenarioResult:
    """One peer answers STATUS with a fabricated far-ahead head and
    finalized checkpoint.  Range sync forms a chain toward the fake
    target, but every batch comes back empty: the consecutive-empty
    fail-fast must abandon the chain after a bounded number of batches
    (not walk 2000 fake slots), charge the liar `empty_batch`, and the
    per-peer failed-target memory must keep the same lie from re-forming
    the chain — all without disturbing the honest network."""
    result = ScenarioResult("lying_status_chain", seed)
    spec = minimal_spec(altair_fork_epoch=0)
    spe = spec.preset.slots_per_epoch
    injector = FaultInjector(seed)
    lie = {"head_slot": 256 * spe, "head_root": "ab" * 32,
           "finalized_epoch": 254, "finalized_root": "cd" * 32}
    injector.set_behavior("n2", "n0",
                          PeerBehavior("lying_status", status_lie=lie))
    net = LocalNetwork(spec, 3, 32, topology="mesh", injector=injector)
    watch = graftwatch.get()
    dl0 = counter_value("sync_range_batches_downloaded_total")
    eb0 = counter_value("sync_penalties_total_empty_batch")
    try:
        victim = net.nodes[0]
        nid2 = net.nodes[2].network.transport.node_id
        # the mesh dials both directions at once, so the victim can hold
        # two connections to the liar; when the duplicate is torn down
        # the PeerInfo entry goes with it.  That is a benign disconnect,
        # not a ban — so the ban oracle is the on_ban callback itself,
        # not the survival of the peer-table entry.
        bans: list[str] = []
        real_on_ban = victim.network.peers.on_ban

        def recording_on_ban(node_id):
            bans.append(node_id)
            real_on_ban(node_id)

        victim.network.peers.on_ban = recording_on_ban
        with scenario_capture() as trace:
            net.run_slots(spe)
            # the liar's own outbound STATUS (served honestly BY the
            # victim's transport) races the lie on the victim's peer
            # table; force one synchronous exchange so the fake-ahead
            # STATUS deterministically had the last word at least once.
            # The mesh dial itself can still be mid-handshake right
            # after warmup, so wait for the connection (re-dialing if
            # it never lands) before forcing the exchange.
            def _liar_conn():
                return next((p for p in
                             victim.network.transport.peers.values()
                             if p.node_id == nid2), None)
            deadline = time.monotonic() + 10.0
            peer2 = _liar_conn()
            while peer2 is None and time.monotonic() < deadline:
                time.sleep(0.05)
                peer2 = _liar_conn()
            if peer2 is None:
                victim.network.dial("127.0.0.1",
                                    net.nodes[2].network.port)
                while peer2 is None and time.monotonic() < deadline + 5.0:
                    time.sleep(0.05)
                    peer2 = _liar_conn()
            victim.network._status_exchange(peer2)
            net.run_slots(2 * spe)
        result.trace = trace
        served = injector.behaviors_served.get("lying_status", 0)
        _chk(result, "lie_served", served > 0,
             f"{served} fabricated STATUS responses served")
        empty_pen = counter_value("sync_penalties_total_empty_batch") \
            - eb0
        _chk(result, "liar_charged_empty_batch", empty_pen > 0,
             f"{empty_pen:.0f} empty_batch penalties for the fake "
             "target's pool")
        downloaded = counter_value("sync_range_batches_downloaded_total") \
            - dl0
        _chk(result, "fail_fast_bounded", 0 < downloaded < 40,
             f"{downloaded:.0f} batches downloaded before the "
             "consecutive-empty fail-fast (naive walk to the fake head "
             f"would be ~{(256 * spe) // (2 * spe)})")
        # the liar keeps gossiping honestly (it is a real validator
        # node), so its NET score stays positive — the precise outcome
        # is attribution: both fabricated targets are remembered as
        # failed *from this peer* and cannot re-form a chain
        fake_roots = {bytes.fromhex("ab" * 32), bytes.fromhex("cd" * 32)}
        blocked = {k for k, pool in
                   victim.network.sync.range.failed_from.items()
                   if k[1] in fake_roots and nid2 in pool}
        _chk(result, "fake_targets_blocked_for_liar", len(blocked) > 0,
             f"{len(blocked)} fabricated target(s) in the per-peer "
             "failed-target memory, pinned on the liar")
        info2 = victim.network.peers.peers.get(nid2)
        state = ("still connected (score "
                 f"{victim.network.peers.score(nid2):.1f})"
                 if info2 is not None else
                 "duplicate connection torn down, never banned")
        _chk(result, "liar_not_banned",
             nid2 not in bans and (info2 is None or not info2.banned),
             f"liar {state}: a STATUS lie alone is penalized, "
             "not ban-worthy")
        heads = {n.harness.chain.head().head_block_root
                 for n in net.live_nodes}
        _chk(result, "converged", len(heads) == 1,
             f"{len(heads)} distinct heads — honest traffic undisturbed")
        sp = watch.engine.status()["sync_progress"]
        _chk(result, "slo_sync_progress_clean",
             sp["open_incident"] is None,
             f"sync_progress SLO clean ({sp['last_detail']})")
        _envelope_checks(result, net, trace)
    finally:
        net.stop()
    return result


# -- 9. checkpoint sync + graftflow replay catch-up ---------------------------

@scenario("checkpoint_backfill_replay")
def scenario_checkpoint_backfill_replay(seed: int = 0) -> ScenarioResult:
    """A checkpoint-synced node catches up to the live head through
    range sync — which now routes every segment through graftflow's
    epoch-pipelined replay engine — and then backfills its pre-anchor
    history through the engine's atomic batch path.  The
    pipelined path must actually run (epoch commits observable on the
    replay counters and the engine snapshot), converge bit-exactly on
    the network head, complete the pre-anchor history, and end with the
    ``replay_throughput`` SLO clean — a wedged pipeline stage must
    surface as an incident, not as silent non-progress."""
    result = ScenarioResult("checkpoint_backfill_replay", seed)
    spec = minimal_spec(altair_fork_epoch=0)
    spe = spec.preset.slots_per_epoch
    injector = FaultInjector(seed)
    net = LocalNetwork(spec, 3, 48, topology="mesh", injector=injector)
    watch = graftwatch.get()
    blocks0 = counter_value("replay_blocks_committed_total")
    epochs0 = counter_value("replay_epochs_committed_total")
    try:
        net.run_slots(4 * spe)               # finality for the anchor
        fin0 = net.nodes[0].harness.chain.finalized_checkpoint()[0]
        _chk(result, "anchor_finalized", fin0 >= 2,
             f"anchor node finalized epoch {fin0}")
        i3 = net.add_node(anchor_from=0, dial=[])
        node3 = net.nodes[i3]
        sync3 = node3.network.sync
        chain3 = node3.harness.chain
        nid = [net.nodes[j].network.transport.node_id for j in range(3)]
        for j in range(3):
            node3.network.dial("127.0.0.1", net.nodes[j].network.port)
        _wait_statuses(node3, nid)
        anchor_start = chain3.store.backfill_anchor()
        with scenario_capture() as trace:
            # phase A: range-sync forward from the anchor to the head —
            # every accepted segment replays through the graftflow
            # pipeline behind process_segment
            target = net.nodes[0].harness.chain.head().head_block_root
            deadline = time.monotonic() + 25.0
            while time.monotonic() < deadline:
                sync3.maybe_sync()
                if chain3.head().head_block_root == target:
                    break
                time.sleep(0.05)
            # phase B: walk the pre-anchor history to genesis through
            # the engine's one-atomic-batch-per-response backfill path
            deadline = time.monotonic() + 25.0
            while time.monotonic() < deadline:
                sync3.backfill(batch_slots=spe)
                anchor = chain3.store.backfill_anchor()
                if anchor is None or anchor[0] == 0:
                    break
                time.sleep(0.05)
            net.run_slots(spe)               # envelope traffic
        result.trace = trace
        _chk(result, "caught_up_to_live_head",
             chain3.head().head_block_root ==
             net.nodes[0].harness.chain.head().head_block_root,
             f"synced node head at slot {chain3.head().head_state.slot} "
             "matches the network's")
        engine = chain3.replay_engine()
        snap = engine.snapshot()
        replayed = counter_value("replay_blocks_committed_total") - blocks0
        epochs = counter_value("replay_epochs_committed_total") - epochs0
        _chk(result, "segments_replayed_through_graftflow",
             snap["commit_seq"] >= 1 and replayed > 0,
             f"{replayed:.0f} blocks in {epochs:.0f} epoch commits "
             f"through the pipeline (engine commit_seq "
             f"{snap['commit_seq']})")
        last = snap["last_segment"]
        _chk(result, "stage_occupancy_observed",
             last is not None and set(last["occupancy"]) ==
             {"admission", "signature", "stf", "merkle", "commit"},
             "engine snapshot carries per-stage occupancy for the "
             "flight recorder")
        anchor = chain3.store.backfill_anchor()
        _chk(result, "backfill_complete",
             anchor is None or anchor[0] == 0,
             f"backfill anchor {anchor} (started at {anchor_start})")
        _chk(result, "backfill_batches_atomic",
             snap["backfill_batches"] >= 1,
             f"{snap['backfill_batches']} atomic backfill batches")
        checked = missing = 0
        for blk in _chain_blocks(net.nodes[0].harness.chain):
            if (anchor_start is not None
                    and blk.message.slot < anchor_start[0]):
                checked += 1
                if chain3.store.get_block(htr(blk.message)) is None:
                    missing += 1
        _chk(result, "history_complete", checked > 0 and missing == 0,
             f"{checked} pre-anchor canonical blocks checked, "
             f"{missing} missing")
        rt = watch.engine.status()["replay_throughput"]
        rt_incs = watch.engine.incidents_for("replay_throughput")
        _chk(result, "slo_replay_throughput_clean",
             rt["open_incident"] is None
             and all(not i.open for i in rt_incs),
             f"replay_throughput SLO open_incident="
             f"{rt['open_incident']}, {len(rt_incs)} incident(s) all "
             "resolved")
        _envelope_checks(result, net, trace, max_head_lag=2)
    finally:
        net.stop()
    return result
