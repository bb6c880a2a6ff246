"""The network slice as a whole, the port against the JAX package, over real
TCP loopback (minimal preset, 64 validators). Tolerance: exact bytes and
equal verdicts.

1. Range sync and a gossiped block, fake crypto: in each package node B
   dials node A two epochs behind, range-syncs its blocks over req/resp,
   then takes a block A gossips. B's head root, the count range sync
   imported and the root of every stored block on its chain equal the JAX
   package's.
2. Real signatures: eight single-bit attestations of slot 1, the last
   carrying its neighbour's signature, gossiped by node A to node B whose
   ``NetworkConfig(batch_gossip_verification=True)`` defers their
   signatures to a two-worker beacon processor, verified on the port's
   ``gpu`` backend (its plain versions here, ``LHTPU_BLS_LANES=8``). The
   bad one goes first and alone (its batch fails, the split fallback
   names it); the seven good ones are held back until they queue as one
   batch, so the test runs three verifies (~20 s each). B's verdicts, its
   fork-choice votes and its score of A equal what the JAX package's
   ``cpp`` backend gives on the same attestations.

Every wait has a deadline: 15 s on the network, 300 s on a signature
batch (two plain verifies of ~20 s each, more under a loaded machine);
every service stops in ``finally``."""
import threading
import time

import pytest

from lighthouse_tpu.chain import BeaconChainHarness as JHarness
from lighthouse_tpu.chain.errors import AttestationError as JAttestationError
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.network import NetworkConfig as JNetworkConfig
from lighthouse_tpu.network import NetworkService as JNetworkService
from lighthouse_tpu.specs import minimal_spec as j_minimal_spec
from lighthouse_tpu.ssz import deserialize as jdeserialize
from lighthouse_tpu_torch.beacon_processor import (
    BeaconProcessor, Work, WorkType,
)
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.chain.errors import AttestationError
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.network import NetworkConfig, NetworkService
from lighthouse_tpu_torch.network.noise_xx import HAVE_CRYPTOGRAPHY
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.specs.constants import (
    ATTESTATION_SUBNET_COUNT, DOMAIN_BEACON_ATTESTER,
)
from lighthouse_tpu_torch.specs.chain_spec import compute_signing_root
from lighthouse_tpu_torch.ssz import htr, serialize
from lighthouse_tpu_torch.state_transition.helpers import (
    committee_cache, get_domain,
)

VALIDATORS = 64
#: the security protocol, chosen here and never left to the transport
SECURITY = "noise" if HAVE_CRYPTOGRAPHY else "plaintext"
#: the signature test's attestation slot; the nodes sit one slot later
ATT_SLOT = 1


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev, saved = set_device("cpu"), (bls._current, jbls._current)
    yield
    bls._current, jbls._current = saved
    set_device(prev)


def _wait(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _stored_chain(chain) -> list[bytes]:
    """The roots of the stored blocks from the head back to genesis."""
    roots, root = [], chain.head().head_block_root
    while True:
        block = chain.store.get_block(root)
        if block is None:
            return roots
        roots.append(root)
        if int(block.message.slot) == 0:
            return roots
        root = bytes(block.message.parent_root)


def _sync_and_gossip(harness, service, config, spec):
    ha, hb = harness(spec, VALIDATORS), harness(spec, VALIDATORS)
    ha.extend_chain(2 * spec.preset.slots_per_epoch)
    hb.set_slot(ha.chain.slot())
    na = service(ha.chain, config(security=SECURITY))
    nb = service(hb.chain, config(security=SECURITY))
    na.start()
    nb.start()
    try:
        assert nb.dial("127.0.0.1", na.port) is not None
        assert _wait(lambda: hb.chain.head().head_block_root
                     == ha.chain.head().head_block_root)
        # the head moves at the last epoch's commit, the count when the
        # segment's replay returns
        n = 2 * spec.preset.slots_per_epoch
        _wait(lambda: nb.sync.ctx.imported_total >= n)
        synced = nb.sync.ctx.imported_total
        ha.advance_slot()
        hb.set_slot(ha.chain.slot())
        signed, _post = ha.produce_signed_block()
        ha.chain.process_block(signed)
        na.publish_block(signed)
        head = ha.chain.head().head_block_root
        assert bytes(signed.message.parent_root) != head
        assert _wait(lambda: hb.chain.head().head_block_root == head)
        assert not any(p.banned for p in nb.peers.peers.values())
        return (hb.chain.head().head_block_root, synced,
                _stored_chain(hb.chain),
                hb.chain.head().head_state.hash_tree_root(),
                nb.transport.security)
    finally:
        na.stop()
        nb.stop()


def test_range_sync_and_gossip_match_jax():
    bls.set_backend("fake")
    jbls.set_backend("fake")
    ours = _sync_and_gossip(BeaconChainHarness, NetworkService,
                            NetworkConfig, minimal_spec())
    theirs = _sync_and_gossip(JHarness, JNetworkService, JNetworkConfig,
                              j_minimal_spec())
    assert ours == theirs
    assert ours[1] == 2 * minimal_spec().preset.slots_per_epoch
    assert len(ours[2]) == ours[1] + 2       # the genesis and the gossiped
    assert ours[4] == SECURITY


def _attestations(harness, cpp) -> list[tuple]:
    """The single-bit attestations of ``ATT_SLOT``'s committees, signed on
    ``cpp`` with the members' interop keys, the last carrying its
    neighbour's signature: ``(attestation, subnet, validator)``."""
    chain = harness.chain
    state = chain.head().head_state.copy()
    from lighthouse_tpu_torch.state_transition import process_slots
    process_slots(state, ATT_SLOT)
    epoch = state.current_epoch()
    cache = committee_cache(state, epoch)
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, epoch)
    spe = harness.spec.preset.slots_per_epoch
    out = []
    for index in range(cache.committees_per_slot):
        committee = [int(v) for v in cache.committee(ATT_SLOT, index)]
        data = harness.sh.attestation_data(state, ATT_SLOT, index,
                                           chain.head().head_block_root)
        root = compute_signing_root(htr(data), domain)
        subnet = ((ATT_SLOT % spe) * cache.committees_per_slot
                  + index) % ATTESTATION_SUBNET_COUNT
        for pos, v in enumerate(committee):
            bits = [i == pos for i in range(len(committee))]
            att = harness.T.Attestation(
                aggregation_bits=bits, data=data,
                signature=cpp.sign(harness.secret_keys[v], root))
            out.append((att, subnet, v))
    bad, prev = out[-1][0], out[-2][0]
    out[-1] = (harness.T.Attestation(
        aggregation_bits=list(bad.aggregation_bits), data=bad.data,
        signature=prev.signature), out[-1][1], out[-1][2])
    return out


def _kinds(results, error) -> list[str]:
    return [r.kind if isinstance(r, error) else "ok" for r in results]


def test_gossip_attestation_verdicts_on_gpu_equal_jax_cpp(monkeypatch):
    monkeypatch.setenv("LHTPU_BLS_LANES", "8")
    spec = minimal_spec()
    bls.set_backend("cpp")
    ha, hb = (BeaconChainHarness(spec, VALIDATORS),
              BeaconChainHarness(spec, VALIDATORS))
    for h in (ha, hb):
        h.set_slot(ATT_SLOT + 1)
    atts = _attestations(ha, bls.get_backend())
    assert len(atts) == 8

    # the JAX package's cpp verdicts on the same attestations (SSZ bytes)
    jbls.set_backend("cpp")
    jh = JHarness(j_minimal_spec(), VALIDATORS)
    jh.set_slot(ATT_SLOT + 1)
    typ = jh.T.Attestation.ssz_type
    want = _kinds(jh.chain.batch_verify_unaggregated_attestations_for_gossip(
        [(jdeserialize(typ, serialize(type(a).ssz_type, a)), s)
         for a, s, _v in atts]), JAttestationError)
    assert want == ["ok"] * 7 + ["bad_signature"]

    bls.set_backend("gpu")
    got, batches = {}, []
    inner = hb.chain.batch_verify_unaggregated_attestations_for_gossip

    def recorded(pairs):
        results = inner(pairs)
        batches.append(len(pairs))
        for (att, _s), r in zip(pairs, results):
            got[htr(att)] = r
        return results

    hb.chain.batch_verify_unaggregated_attestations_for_gossip = recorded
    proc = BeaconProcessor(num_workers=2)
    config = NetworkConfig(batch_gossip_verification=True,
                           security="plaintext")
    na = NetworkService(ha.chain, NetworkConfig(security="plaintext"))
    nb = NetworkService(hb.chain, config, processor=proc)
    gate = threading.Event()
    na.start()
    nb.start()
    try:
        peer = nb.dial("127.0.0.1", na.port)
        assert peer is not None and nb.transport.security == "plaintext"
        a_id = na.transport.node_id
        topics = {f"beacon_attestation_{s}" for _a, s, _v in atts}
        assert _wait(lambda: topics <= na.gossip.peer_topics.get(
            nb.transport.node_id, set()))
        assert _wait(lambda: a_id in nb.peers.peers)
        score0 = nb.peers.score(a_id)
        # the bad attestation alone: one failed batch, one retry
        bad, subnet, _v = atts[-1]
        na.publish_attestation(bad, subnet)
        assert _wait(lambda: htr(bad) in got, timeout=300)
        assert proc.wait_idle(timeout=15)
        # the seven good ones queue behind three held items (both workers
        # and the manager's next pick), then drain as one batch
        for _ in range(3):
            proc.submit(Work(WorkType.GOSSIP_BLOCK,
                             lambda: gate.wait(timeout=60)))
        for att, subnet, _v in atts[:-1]:
            na.publish_attestation(att, subnet)
        assert _wait(lambda: len(proc.queues[WorkType.GOSSIP_ATTESTATION])
                     == 7)
        gate.set()
        assert _wait(lambda: len(got) == 8, timeout=300)
        assert proc.wait_idle(timeout=15)
        verdicts = _kinds([got[htr(a)] for a, _s, _v in atts],
                          AttestationError)
        assert verdicts == want
        assert batches == [1, 7]
        votes = hb.chain.fork_choice.votes
        head = hb.chain.head().head_block_root
        for (_a, _s, v), kind in zip(atts, verdicts):
            voted = v < len(votes) and votes[v].next_root == head
            assert voted == (kind == "ok"), (v, kind)
        # seven accepts inline (+0.1 each) and one reject (-5.0) for A
        delta = nb.peers.score(a_id) - score0
        assert delta == pytest.approx(8 * 0.1 - 5.0)
        assert not any(p.banned for p in nb.peers.peers.values())
    finally:
        gate.set()
        na.stop()
        nb.stop()
