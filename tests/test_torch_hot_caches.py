"""Hot-slot cache behavior: the "no state replay at slot start" tests.

The done-criterion: attestation production/verification
latency must not include a state replay once the caches are primed.  The
tests monkeypatch-count `process_slots` (the replay choke point) and
assert zero calls on the cached paths — shuffling cache
(shuffling_cache.rs), proposer cache (beacon_proposer_cache.rs),
early-attester cache (early_attester_cache.rs), the state-advance timer
(state_advance_timer.rs), and the pre-finalization reject cache
(pre_finalization_cache.rs).

The same cases as the JAX package's tests/test_hot_caches.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after the module).
"""
from __future__ import annotations

import pytest

from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


@pytest.fixture(autouse=True)
def fake_bls():
    bls.set_backend("fake")
    yield
    bls.set_backend("python")


@pytest.fixture()
def harness():
    return BeaconChainHarness(minimal_spec(), 64)


def _singles(att, n):
    """Exactly-one-bit unaggregated attestations from one committee
    aggregate (distinct validators)."""
    size = len(att.aggregation_bits)
    return [type(att)(
        aggregation_bits=[j == i for j in range(size)],
        data=att.data, signature=att.signature)
        for i in range(min(n, size))]


def _patch_replay_counter(monkeypatch, module, counter):
    orig = module.process_slots

    def counting(state, slot):
        counter["n"] += 1
        return orig(state, slot)

    monkeypatch.setattr(module, "process_slots", counting)


def test_shuffling_cache_eliminates_replay_for_same_target(harness,
                                                           monkeypatch):
    h = harness
    h.extend_chain(3, attest=False)
    chain = h.chain
    head = chain.head()
    atts = h.sh.produce_attestations(head.head_state, chain.slot(),
                                     head.head_block_root)
    singles = _singles(atts[0], 4)
    assert len(singles) >= 2
    chain.shuffling_cache._cache.clear()
    # first verify builds the epoch's shuffling (may replay once)...
    chain.verify_unaggregated_attestation_for_gossip(singles[0])
    hits_before = chain.shuffling_cache.hits
    # ...every later verify for the same shuffling must be replay-free
    counter = {"n": 0}
    import lighthouse_tpu_torch.chain.beacon_chain as bc
    _patch_replay_counter(monkeypatch, bc, counter)
    for s in singles[1:]:
        chain.verify_unaggregated_attestation_for_gossip(s)
    assert chain.shuffling_cache.hits >= hits_before + len(singles) - 1
    assert counter["n"] == 0, "cached verifies must not replay states"


def test_shuffling_cache_shared_across_committees(harness):
    """Different committees of the same slot/target share one cache
    entry (they all live in one CommitteeCache)."""
    h = harness
    h.extend_chain(3, attest=False)
    chain = h.chain
    head = chain.head()
    atts = h.sh.produce_attestations(head.head_state, chain.slot(),
                                     head.head_block_root)
    chain.shuffling_cache._cache.clear()
    chain.shuffling_cache.misses = 0
    for att in atts:
        chain.verify_unaggregated_attestation_for_gossip(_singles(att, 1)[0])
    assert chain.shuffling_cache.misses <= 1
    assert len(chain.shuffling_cache._cache) == 1


def test_proposer_cache_hits_across_epoch(harness):
    h = harness
    h.extend_chain(2, attest=False)
    pc = h.chain.proposer_cache
    misses_before = pc.misses
    hits_before = pc.hits
    # gossip-verify 4 consecutive blocks within the epoch: only the
    # first may miss (one state advance primes the whole epoch)
    for _ in range(4):
        h.advance_slot()
        signed, _post = h.produce_signed_block()
        h.chain.verify_block_for_gossip(signed)
        h.chain.process_block(signed)
    assert pc.misses - misses_before <= 1
    assert pc.hits - hits_before >= 3


def test_early_attester_cache_serves_state_free(harness, monkeypatch):
    h = harness
    h.extend_chain(3, attest=False)
    from lighthouse_tpu_torch.api.backend import ApiBackend
    api = ApiBackend(h.chain)
    counter = {"n": 0}
    import lighthouse_tpu_torch.api.backend as backend_mod
    _patch_replay_counter(monkeypatch, backend_mod, counter)
    data = api.attestation_data(h.chain.slot(), 0)
    assert data.beacon_block_root == h.chain.head().head_block_root
    assert counter["n"] == 0, "early-attester path must not touch states"
    # and it must agree with the state-backed slow path
    h.chain.early_attester_cache._entry = None
    slow = api.attestation_data(h.chain.slot(), 0)
    assert slow.beacon_block_root == data.beacon_block_root
    assert slow.target.root == data.target.root
    assert slow.source.root == data.source.root
    assert slow.source.epoch == data.source.epoch


def test_state_advance_timer_precomputes_epoch_transition(harness,
                                                          monkeypatch):
    h = harness
    spe = h.chain.spec.preset.slots_per_epoch
    h.extend_chain(spe - 2, attest=False)
    head_root = h.chain.head().head_block_root
    # tick the timer during the LAST slot of epoch 0
    h.set_slot(spe - 1)
    adv = h.chain._advanced
    assert adv is not None and adv[0] == head_root
    assert adv[1].slot == spe                 # advanced into epoch 1
    # proposer + shuffling caches primed for epoch 1
    assert h.chain.proposer_cache.get(head_root, 1) is not None
    assert h.chain.shuffling_cache.get(head_root, 1) is not None
    # the first production state of epoch 1 must reuse the advance
    counter = {"n": 0}
    import lighthouse_tpu_torch.chain.beacon_chain as bc
    _patch_replay_counter(monkeypatch, bc, counter)
    st = h.chain.state_for_block_production(head_root, spe)
    assert st.slot == spe
    assert counter["n"] == 0, "pre-advanced state must be reused"


def test_state_advance_timer_idempotent(harness):
    h = harness
    spe = h.chain.spec.preset.slots_per_epoch
    h.extend_chain(spe - 2, attest=False)
    h.set_slot(spe - 1)
    first = h.chain._advanced
    h.chain.per_slot_task()                   # second tick, same slot
    assert h.chain._advanced is first


def test_pre_finalization_cache_rejects_without_lookup(harness):
    """Gossip block whose parent is a known pre-finalization root is
    rejected as FINALIZED_SLOT (not PARENT_UNKNOWN -> no lookup storm)."""
    h = harness
    h.extend_chain(3, attest=False)
    chain = h.chain
    bad_parent = b"\xaa" * 32
    chain.pre_finalization_cache.insert(bad_parent)
    signed, _post = h.produce_signed_block(chain.slot() + 1)
    h.advance_slot()
    # graft the poisoned parent into a real signed block
    block = signed.message
    block.parent_root = bad_parent
    from lighthouse_tpu_torch.chain.errors import BlockError
    with pytest.raises(BlockError) as e:
        chain.verify_block_for_gossip(signed)
    assert e.value.kind == "would_revert_finalized"
    # unknown parents NOT in the cache still classify as parent_unknown
    block.parent_root = b"\xbb" * 32
    with pytest.raises(BlockError) as e2:
        chain.verify_block_for_gossip(signed)
    assert e2.value.kind == "parent_unknown"


def test_cache_lru_bounds():
    from lighthouse_tpu_torch.chain.hot_caches import (
        PreFinalizationCache, ProposerCache, ShufflingCache,
    )
    sc = ShufflingCache()
    for i in range(ShufflingCache.SIZE + 10):
        sc.insert(i.to_bytes(32, "big"), 0, object())
    assert len(sc._cache) == ShufflingCache.SIZE
    pc = ProposerCache()
    for i in range(ProposerCache.SIZE + 10):
        pc.insert(i.to_bytes(32, "big"), 0, {})
    assert len(pc._cache) == ProposerCache.SIZE
    pf = PreFinalizationCache()
    for i in range(PreFinalizationCache.SIZE + 10):
        pf.insert(i.to_bytes(32, "big"))
    assert len(pf._roots) == PreFinalizationCache.SIZE
    assert pf.contains((PreFinalizationCache.SIZE + 9).to_bytes(32, "big"))
    assert not pf.contains((0).to_bytes(32, "big"))


def test_attester_cache_serves_next_epoch_without_replay(harness,
                                                         monkeypatch):
    """THE done-criterion (attester_cache.rs): attestation data for a
    slot in an epoch the head state hasn't reached — where the early
    cache misses (different epoch) — is served from the attester cache
    with ZERO state replay once the state-advance timer primed it."""
    h = harness
    spe = h.chain.spec.preset.slots_per_epoch
    h.extend_chain(spe - 2, attest=False)
    h.set_slot(spe - 1)                   # timer primes epoch 1
    from lighthouse_tpu_torch.api.backend import ApiBackend
    api = ApiBackend(h.chain)
    counter = {"n": 0}
    import lighthouse_tpu_torch.api.backend as backend_mod
    _patch_replay_counter(monkeypatch, backend_mod, counter)
    h.set_slot(spe)                       # epoch 1, no block yet
    data = api.attestation_data(spe, 0)
    assert counter["n"] == 0, "attester cache path must not replay"
    assert data.beacon_block_root == h.chain.head().head_block_root
    assert data.target.epoch == 1
    # agreement with the state-backed slow path
    h.chain.attester_cache._map.clear()
    h.chain.early_attester_cache._entry = None
    slow = api.attestation_data(spe, 0)
    assert (slow.source.epoch, bytes(slow.source.root)) == \
        (data.source.epoch, bytes(data.source.root))
    assert bytes(slow.target.root) == bytes(data.target.root)
    assert counter["n"] >= 1              # the fallback replayed...
    # ...and primed the cache: the next request is replay-free again
    before = counter["n"]
    again = api.attestation_data(spe, 1)
    assert counter["n"] == before
    assert bytes(again.source.root) == bytes(data.source.root)


def test_eth1_finalization_cache_snapshot_and_prune(harness):
    """eth1_finalization_cache.rs: the finalized checkpoint's eth1
    snapshot is served from the cache (fork-checked), entries at/below
    it drop, and the eth1 tracker prunes its proof/block caches."""
    from lighthouse_tpu_torch.chain.hot_caches import Eth1FinalizationCache
    from lighthouse_tpu_torch.eth1 import Eth1Service, MockEth1Endpoint
    h = harness
    st = h.chain.head().head_state
    c = Eth1FinalizationCache()
    c.insert(st, b"r0" * 16)
    snap = c.finalize(st.current_epoch(), b"r0" * 16)
    assert snap is not None
    assert snap["deposit_count"] == int(st.eth1_data.deposit_count)
    assert snap["deposit_index"] == int(st.eth1_deposit_index)
    # entries at/below the finalized epoch are gone
    assert c.finalize(st.current_epoch(), b"r0" * 16) is None
    # wrong fork root -> no snapshot
    c.insert(st, b"r1" * 16)
    assert c.finalize(st.current_epoch(), b"XX" * 16) is None

    # chain integration: only a block AT the epoch boundary slot primes
    # the cache, keyed by the checkpoint (epoch, root) it will finalize as
    spe = h.chain.spec.preset.slots_per_epoch
    h.extend_chain(spe + 1, attest=False)     # crosses the epoch-1 boundary
    head_state = h.chain.head().head_state
    boundary_root = head_state.get_block_root_at_slot(spe)
    snap = h.chain.eth1_finalization_cache.finalize(1, boundary_root)
    assert snap is not None
    # a non-checkpoint root from the same epoch misses
    h.chain.eth1_finalization_cache.insert(head_state,
                                           h.chain.head().head_block_root)
    assert h.chain.eth1_finalization_cache.finalize(
        1, h.chain.head().head_block_root) is None

    spec = h.chain.spec
    endpoint = MockEth1Endpoint(spec, h.chain.T)
    svc = Eth1Service(spec, h.chain.T, endpoint)
    for _ in range(20 + spec.eth1_follow_distance):
        endpoint.add_block()
    svc.update()
    svc._proof_trees = {4: object(), 8: object(), 16: object()}
    n_blocks = len(svc.block_cache)
    assert n_blocks > 2
    mid = svc.block_cache[len(svc.block_cache) // 2]
    svc.finalize({"deposit_root": b"\x00" * 32,
                  "deposit_count": mid.deposit_count or 0,
                  "deposit_index": 8})
    assert svc.finalized_deposit_count == 8
    assert sorted(svc._proof_trees) == [8, 16]
    assert len(svc.block_cache) <= n_blocks
    # monotonic: an older snapshot is a no-op
    svc.finalize({"deposit_root": b"\x00" * 32, "deposit_count": 0,
                  "deposit_index": 2})
    assert svc.finalized_deposit_count == 8


def test_attestation_data_past_slot_votes_ancestor(harness):
    """An attestation produced for a PAST slot must vote the head-chain
    block at/below that slot — voting the newer head is rejected by fork
    choice ("attestation for block newer than slot")."""
    h = harness
    h.extend_chain(5, attest=False)
    from lighthouse_tpu_torch.api.backend import ApiBackend
    api = ApiBackend(h.chain)
    head_state = h.chain.head().head_state
    past = int(head_state.slot) - 2
    want_root = head_state.get_block_root_at_slot(past)
    # cache path
    data = h.chain.attester_cache.attestation_data(h.chain, past, 0)
    if data is not None:
        assert bytes(data.beacon_block_root) == want_root
    # slow path
    h.chain.attester_cache._map.clear()
    h.chain.early_attester_cache._entry = None
    slow = api.attestation_data(past, 0)
    assert bytes(slow.beacon_block_root) == want_root
    # both are acceptable fork-choice votes
    from lighthouse_tpu_torch.fork_choice.fork_choice import ForkChoiceError
    node = h.chain.fork_choice.proto_array.get(want_root)
    assert node.slot <= past


def test_eth1_finalization_cache_empty_boundary_primed(harness):
    """When the epoch-boundary slot is empty, the state-advance timer
    primes the snapshot under the checkpoint root the epoch will
    actually finalize as (the last pre-boundary block)."""
    h = harness
    spe = h.chain.spec.preset.slots_per_epoch
    h.extend_chain(spe - 2, attest=False)     # last block at slot spe-2
    last_root = h.chain.head().head_block_root
    h.set_slot(spe - 1)                       # timer advances through
    # the boundary slot spe is empty: checkpoint root for epoch 1 = the
    # pre-boundary block
    snap = h.chain.eth1_finalization_cache.finalize(1, last_root)
    assert snap is not None
    assert snap["deposit_index"] == 64


def test_attestation_data_rejects_out_of_range_committee(harness):
    """Satellite gate: a committee_index past the epoch's
    committees-per-slot must 400 on EVERY serving path (early cache,
    attester cache, state fallback) instead of silently returning data
    no committee can sign (attester_cache.rs CommitteeLengths)."""
    from lighthouse_tpu_torch.api.backend import ApiBackend, ApiError
    from lighthouse_tpu_torch.state_transition.helpers import (
        get_committee_count_per_slot,
    )
    h = harness
    h.extend_chain(3, attest=False)
    api = ApiBackend(h.chain)
    st = h.chain.head().head_state
    cps = get_committee_count_per_slot(st, st.current_epoch())
    slot = h.chain.slot()
    # valid index works on the (primed) early-cache path
    assert api.attestation_data(slot, cps - 1) is not None
    for path in ("early", "attester", "state"):
        if path == "attester":
            h.chain.early_attester_cache._entry = None
            h.chain.attester_cache.cache_state(h.chain, st)
        elif path == "state":
            h.chain.early_attester_cache._entry = None
            h.chain.attester_cache._map.clear()
        with pytest.raises(ApiError) as ei:
            api.attestation_data(slot, cps)
        assert ei.value.status == 400, path
        # valid indices still serve after the rejection
        assert api.attestation_data(slot, 0) is not None, path


def test_shared_shuffling_cache_dedupes_across_states(harness):
    """Tentpole: two distinct state objects on the same chain share one
    committee layout via the (seed, epoch)-keyed shuffling cache — the
    second state's committee_cache() is a shared hit, not a reshuffle."""
    from lighthouse_tpu_torch.state_transition.helpers import (
        committee_cache, shared_shufflings,
    )
    h = harness
    h.extend_chain(2, attest=False)
    st = h.chain.head().head_state
    epoch = st.current_epoch()
    shared_shufflings.clear()
    c1 = committee_cache(st, epoch)
    misses = shared_shufflings.misses
    other = st.copy()
    c2 = committee_cache(other, epoch)
    assert shared_shufflings.hits >= 1
    assert shared_shufflings.misses == misses
    assert c2 is c1                     # the layout object itself is shared
    # per-state front line: repeated calls don't touch the shared cache
    hits = shared_shufflings.hits
    assert committee_cache(other, epoch) is c1
    assert shared_shufflings.hits == hits
