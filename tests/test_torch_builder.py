"""Builder/MEV + proposer-preparation flows.

Mirrors execution_layer/src/lib.rs:807 (get_payload builder-vs-local),
test_utils/mock_builder.rs, and preparation_service.rs behaviors.

The cases of the JAX package's tests/test_builder.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after each test).
"""
import pytest

from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.execution_layer.builder import (
    BuilderHttpClient, MockBuilder,
)
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec


@pytest.fixture(autouse=True)
def fake_crypto():
    prev, saved = set_device("cpu"), bls._current
    bls.set_backend("fake")
    yield
    bls._current = saved
    set_device(prev)


def _bellatrix_harness():
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0)
    return BeaconChainHarness(spec, 32)


def test_prepared_fee_recipient_lands_in_local_payload():
    h = _bellatrix_harness()
    chain = h.chain
    fee = b"\xaa" * 20
    chain.register_proposer_preparation(
        [{"validator_index": i, "fee_recipient": "0x" + fee.hex()}
         for i in range(32)])
    h.extend_chain(2)
    payload = chain.head().head_block.message.body.execution_payload
    assert payload.fee_recipient == fee
    assert chain.block_production_log[-1]["source"] == "local"
    # payload-attribute preparation reaches the EL with the recipient
    chain.prepare_payload_attributes(chain.slot() + 1)
    assert any(c for c in chain.execution_layer.forkchoice_calls)


def test_builder_outbids_local_payload():
    h = _bellatrix_harness()
    chain = h.chain
    mock = MockBuilder(chain, bid_wei=chain.LOCAL_PAYLOAD_VALUE_WEI * 10)
    url = mock.start_http()
    try:
        chain.builder = BuilderHttpClient(url)
        builder_fee = b"\xbb" * 20
        regs = [{"message": {
            "fee_recipient": "0x" + builder_fee.hex(),
            "gas_limit": 30_000_000, "timestamp": 0,
            "pubkey": "0x" + chain.head().head_state.validators
            .pubkey(i).hex()}, "signature": "0x" + "00" * 96}
            for i in range(32)]
        chain.register_validators(regs)
        assert mock.registrations          # forwarded to the builder
        h.extend_chain(2)
        payload = chain.head().head_block.message.body.execution_payload
        assert chain.block_production_log[-1]["source"] == "builder"
        assert payload.fee_recipient == builder_fee
        assert mock.header_requests and mock.unblind_requests
    finally:
        mock.stop()


def test_low_bid_falls_back_to_local():
    h = _bellatrix_harness()
    chain = h.chain
    mock = MockBuilder(chain, bid_wei=1)   # below the local value
    url = mock.start_http()
    try:
        chain.builder = BuilderHttpClient(url)
        chain.register_validators([{"message": {
            "fee_recipient": "0x" + "bb" * 20,
            "gas_limit": 30_000_000, "timestamp": 0,
            "pubkey": "0x" + chain.head().head_state.validators
            .pubkey(i).hex()}} for i in range(32)])
        h.extend_chain(2)
        assert chain.block_production_log[-1]["source"] == "local"
        assert mock.header_requests        # the bid WAS solicited
        assert not mock.unblind_requests   # but never taken
    finally:
        mock.stop()


def test_unregistered_proposer_gets_no_bid():
    h = _bellatrix_harness()
    chain = h.chain
    mock = MockBuilder(chain, bid_wei=10**18)
    url = mock.start_http()
    try:
        chain.builder = BuilderHttpClient(url)
        h.extend_chain(2)
        assert chain.block_production_log[-1]["source"] == "local"
        assert not mock.header_requests    # no registration -> not asked
    finally:
        mock.stop()


def test_blind_unblind_helpers_preserve_root():
    from lighthouse_tpu_torch.containers.blinded import (
        UnblindError, blind_signed_block, unblind_signed_block,
    )
    from lighthouse_tpu_torch.ssz import htr, serialize

    h = _bellatrix_harness()
    h.extend_chain(1)
    signed = h.chain.head().head_block
    T = h.chain.T
    blinded = blind_signed_block(T, signed)
    assert htr(blinded.message) == htr(signed.message)
    full = unblind_signed_block(
        T, blinded, signed.message.body.execution_payload)
    assert serialize(type(full).ssz_type, full) == \
        serialize(type(signed).ssz_type, signed)
    wrong = T.ExecutionPayload[type(signed).fork_name](
        block_hash=b"\x77" * 32)
    import pytest as _pytest
    with _pytest.raises(UnblindError):
        unblind_signed_block(T, blinded, wrong)


def test_vc_preparation_service_over_http():
    """VC pushes prepare_beacon_proposer + register_validator each epoch;
    produced blocks carry the VC-configured fee recipient."""
    from lighthouse_tpu_torch.api import BeaconApiServer
    from lighthouse_tpu_torch.api.backend import ApiBackend
    from lighthouse_tpu_torch.validator_client import (
        BeaconNodeFallback, BeaconNodeHttpClient, ValidatorClient,
        ValidatorStore,
    )
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0)
    h = BeaconChainHarness(spec, 32)
    chain = h.chain
    mock = MockBuilder(chain, bid_wei=chain.LOCAL_PAYLOAD_VALUE_WEI * 5)
    chain.builder = BuilderHttpClient(mock.start_http())
    srv = BeaconApiServer(ApiBackend(chain))
    srv.start()
    try:
        client = BeaconNodeHttpClient(f"http://127.0.0.1:{srv.port}", spec)
        store = ValidatorStore(spec, chain.genesis_validators_root)
        for sk in h.secret_keys:
            store.add_validator(sk)
        vc = ValidatorClient(spec, store, BeaconNodeFallback([client]))
        vc.default_fee_recipient = b"\xcc" * 20
        vc.builder_proposals = True
        for _ in range(spec.preset.slots_per_epoch + 2):
            h.advance_slot()
            vc.on_slot(chain.slot())
            chain.recompute_head()
        # BN saw the preparation and registrations
        assert chain.prepared_proposers
        assert chain.validator_registrations
        # builder got the registrations and won at least one block
        assert mock.registrations
        assert any(e["source"] == "builder"
                   for e in chain.block_production_log)
        # the registered fee recipient is in the produced payloads
        assert any(e["fee_recipient"] == b"\xcc" * 20
                   for e in chain.block_production_log)
    finally:
        srv.stop()
        mock.stop()


def test_blinded_block_ssz_roundtrip_through_api():
    """Blinded production round-trips via REAL
    SSZ containers — GET blinded_blocks returns a BlindedBeaconBlock,
    the signed blinded form POSTs back, the backend unblinds from its
    withheld-payload cache and imports the full block."""
    from lighthouse_tpu_torch.api.backend import ApiBackend
    from lighthouse_tpu_torch.containers.blinded import blind_signed_block
    from lighthouse_tpu_torch.ssz import deserialize, htr, serialize
    from lighthouse_tpu_torch.state_transition import process_slots
    from lighthouse_tpu_torch.state_transition.helpers import (
        get_beacon_proposer_index,
    )

    h = _bellatrix_harness()
    chain = h.chain
    backend = ApiBackend(chain)
    h.extend_chain(2)
    h.advance_slot()
    slot = chain.slot()
    st = chain.head().head_state.copy()
    process_slots(st, slot)
    proposer = get_beacon_proposer_index(st, slot)
    reveal = h.randao_reveal(st, slot, proposer)

    raw = backend.produce_blinded_block_ssz(slot, reveal)
    fork = chain.spec.fork_name_at_slot(slot)
    blinded = deserialize(chain.T.BlindedBeaconBlock[fork].ssz_type, raw)
    # the blinded body carries the header, not the payload
    header = blinded.message.body.execution_payload_header \
        if hasattr(blinded, "message") else \
        blinded.body.execution_payload_header
    assert header.block_hash != b"\x00" * 32
    # sign the BLINDED root (what a real VC signs) and post it back
    from lighthouse_tpu_torch.specs.chain_spec import compute_signing_root
    from lighthouse_tpu_torch.specs.constants import DOMAIN_BEACON_PROPOSER
    from lighthouse_tpu_torch.state_transition.helpers import get_domain
    domain = get_domain(st, DOMAIN_BEACON_PROPOSER,
                        slot // chain.spec.preset.slots_per_epoch)
    from lighthouse_tpu_torch.crypto import bls as _bls
    sig = _bls.sign(h.sh.secret_keys[proposer],
                    compute_signing_root(htr(blinded), domain))
    signed_blinded = chain.T.SignedBlindedBeaconBlock[fork](
        message=blinded, signature=sig)
    backend.publish_blinded_block(
        serialize(type(signed_blinded).ssz_type, signed_blinded))
    # the FULL block (payload spliced back) became the head, and the
    # imported payload commits to EXACTLY the header the VC signed
    from lighthouse_tpu_torch.containers.blinded import payload_to_header
    head = chain.head()
    assert head.head_block.message.slot == slot
    imported = head.head_block.message.body.execution_payload
    assert htr(payload_to_header(chain.T, fork, imported)) == htr(header)
    assert imported.block_hash == header.block_hash
