"""Beacon chain core tests via the harness — the chain-level integration tier
of SURVEY.md §4 (beacon_chain/tests/{block_verification,attestation_verification,
store_tests,payload_invalidation}.rs style, fake crypto).

The same cases as the JAX package's tests/test_beacon_chain.py, run on the port
(imports switched to lighthouse_tpu_torch).
"""
import pytest

from lighthouse_tpu_torch.chain import BeaconChainHarness, BlockError
from lighthouse_tpu_torch.chain.errors import AttestationError
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import ForkName, minimal_spec
from lighthouse_tpu_torch.ssz import htr


@pytest.fixture(autouse=True)
def fake_crypto():
    prev, saved = set_device("cpu"), bls._current
    bls.set_backend("fake")
    yield
    bls._current = saved
    set_device(prev)


def make_harness(validators=64, **spec_kw):
    return BeaconChainHarness(minimal_spec(**spec_kw), validators)


def test_chain_extends_and_finalizes():
    h = make_harness()
    h.extend_chain(5 * h.spec.preset.slots_per_epoch)
    chain = h.chain
    assert chain.head().head_state.slot == 40
    assert chain.finalized_checkpoint()[0] >= 2
    # store has the head block
    head = chain.head()
    assert chain.store.get_block(head.head_block_root) is not None
    # freezer was populated by migration
    assert chain.store.split.slot > 0


def test_duplicate_block_import_is_noop():
    h = make_harness()
    h.advance_slot()
    signed, _ = h.produce_signed_block()
    r1 = h.chain.process_block(signed)
    r2 = h.chain.process_block(signed)
    assert r1 == r2


def test_unknown_parent_rejected():
    h = make_harness()
    h.advance_slot()
    signed, _ = h.produce_signed_block()
    signed.message.parent_root = b"\x13" * 32
    with pytest.raises(BlockError) as e:
        h.chain.process_block(signed)
    assert e.value.kind == "parent_unknown"


def test_gossip_verification_rejects_equivocation():
    h = make_harness()
    h.advance_slot()
    b1, _ = h.produce_signed_block()
    h.chain.verify_block_for_gossip(b1)
    # same proposer, same slot, different graffiti => slashable equivocation
    b2, _ = h.produce_signed_block()
    b2.message.body.graffiti = b"\x55" * 32
    with pytest.raises(BlockError) as e:
        h.chain.verify_block_for_gossip(b2)
    assert e.value.kind == "repeat_proposal"


def test_gossip_rejects_future_slot_and_wrong_proposer():
    h = make_harness()
    h.advance_slot()
    signed, _ = h.produce_signed_block(slot=5)
    with pytest.raises(BlockError) as e:
        h.chain.verify_block_for_gossip(signed)
    assert e.value.kind == "future_slot"


def test_attestation_gossip_and_fork_choice():
    h = make_harness()
    h.extend_chain(3, attest=False)
    chain = h.chain
    head = chain.head()
    state = head.head_state
    atts = h.sh.produce_attestations(state, chain.slot(),
                                     head.head_block_root)
    att = atts[0]
    # exactly-one-bit unaggregated form
    single = type(att)(
        aggregation_bits=[i == 0 for i in range(len(att.aggregation_bits))],
        data=att.data, signature=att.signature)
    v = chain.verify_unaggregated_attestation_for_gossip(single)
    chain.apply_attestation_to_fork_choice(v)
    # duplicate from the same validator is rejected
    with pytest.raises(AttestationError) as e:
        chain.verify_unaggregated_attestation_for_gossip(single)
    assert e.value.kind == "prior_attestation_known"
    # unknown head block rejected
    bad = type(att)(aggregation_bits=list(single.aggregation_bits),
                    data=type(att.data)(
                        slot=att.data.slot, index=att.data.index,
                        beacon_block_root=b"\x77" * 32,
                        source=att.data.source, target=att.data.target),
                    signature=att.signature)
    with pytest.raises(AttestationError):
        chain.verify_unaggregated_attestation_for_gossip(bad)


def test_batch_attestation_verification():
    h = make_harness()
    h.extend_chain(3, attest=False)
    chain = h.chain
    head = chain.head()
    atts = h.sh.produce_attestations(head.head_state, chain.slot(),
                                     head.head_block_root)
    singles = []
    for att in atts:
        committee_size = len(att.aggregation_bits)
        for i in range(min(3, committee_size)):
            singles.append((type(att)(
                aggregation_bits=[j == i for j in range(committee_size)],
                data=att.data, signature=att.signature), 0))
    results = chain.batch_verify_unaggregated_attestations_for_gossip(
        singles)
    ok = [r for r in results if not isinstance(r, Exception)]
    assert len(ok) == len(singles)
    for v in ok:
        chain.apply_attestation_to_fork_choice(v)
        chain.add_to_op_pool(v)
    assert chain.op_pool.num_attestations() > 0


def test_fork_and_reorg():
    """Two competing forks; attestations decide the head."""
    h = make_harness()
    h.extend_chain(4, attest=False)
    chain = h.chain
    common = chain.head().head_block_root
    # block A at slot 5 (imported first, becomes head)
    h.advance_slot()
    block_a, _ = h.produce_signed_block()
    root_a = chain.process_block(block_a)
    assert chain.head().head_block_root == root_a
    # competing block B at slot 6 building on the common parent (skip slot 5)
    state = chain._state_for(common).copy()
    sh = h.sh
    sh_state = state
    b_signed, b_post = sh.produce_block_on_state(
        sh_state, 6, attestations=[])
    h.set_slot(6)
    root_b = chain.process_block(b_signed)
    # A (earlier, attested) should still be head without votes for B…
    head_now = chain.recompute_head()
    assert head_now in (root_a, root_b)
    # all validators attest to B => B wins
    atts = sh.produce_attestations(b_post, 6, root_b)
    for att in atts:
        from lighthouse_tpu_torch.state_transition.helpers import (
            get_indexed_attestation,
        )
        indexed = get_indexed_attestation(b_post, att)
        chain.fork_choice.on_attestation(6, indexed, is_from_block=False)
    h.set_slot(7)
    assert chain.recompute_head() == root_b


def test_op_pool_packing_into_block():
    h = make_harness()
    h.extend_chain(2 * h.spec.preset.slots_per_epoch, attest=True)
    # attestations should have been packed into later blocks
    head = h.chain.head()
    assert len(head.head_block.message.body.attestations) > 0


def test_payload_invalidation_reverts_head():
    spec_kw = dict(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                   capella_fork_epoch=0)
    h = make_harness(**spec_kw)
    h.extend_chain(3, attest=False)
    chain = h.chain
    good_head = chain.head().head_block_root
    # import an optimistic block then invalidate it via the EL
    h.mock_el.syncing = True
    h.advance_slot()
    signed, _ = h.produce_signed_block()
    root = chain.process_block(signed)
    assert chain.is_optimistic_head()
    payload_hash = signed.message.body.execution_payload.block_hash
    chain.fork_choice.on_invalid_execution_payload(root, None)
    new_head = chain.recompute_head()
    assert new_head == good_head, "invalid payload must revert the head"


@pytest.mark.parametrize("registered", [False, True])
def test_builder_flow_takes_a_registered_proposers_bid(registered):
    """The JAX package's builder flow: a builder attached for a registered
    proposer is asked for a bid, and a bid that beats the local value
    gives the block the builder's payload, read back by
    execution_layer's payload_from_json; an unregistered proposer gets the
    local payload, and the builder is never asked for a bid."""
    from lighthouse_tpu_torch.execution_layer.builder import (
        BuilderHttpClient, MockBuilder,
    )
    h = make_harness(32, altair_fork_epoch=0, bellatrix_fork_epoch=0)
    chain = h.chain
    mock = MockBuilder(chain, bid_wei=chain.LOCAL_PAYLOAD_VALUE_WEI * 10)
    try:
        chain.builder = BuilderHttpClient(mock.start_http())
        if registered:
            chain.register_validators([{"message": {
                "fee_recipient": "0x" + "bb" * 20, "gas_limit": 30_000_000,
                "timestamp": 0, "pubkey": "0x" + chain.head().head_state
                .validators.pubkey(i).hex()}} for i in range(32)])
        h.extend_chain(2)
        assert chain.head().head_state.slot == 2
        payload = chain.head().head_block.message.body.execution_payload
        if registered:
            assert chain.block_production_log[-1]["source"] == "builder"
            assert payload.fee_recipient == b"\xbb" * 20
            assert mock.header_requests and mock.unblind_requests
        else:
            assert chain.block_production_log[-1]["source"] == "local"
            assert not mock.header_requests
    finally:
        mock.stop()
