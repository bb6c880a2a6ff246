"""Builder/MEV + proposer-preparation flows.

Mirrors execution_layer/src/lib.rs:807 (get_payload builder-vs-local),
test_utils/mock_builder.rs, and preparation_service.rs behaviors.

The chain-side cases and the blind/unblind helpers of the JAX package's
tests/test_builder.py, run on the port (imports switched to
lighthouse_tpu_torch); the cases that drive the HTTP API or the validator
client wait for those modules in the port.
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
