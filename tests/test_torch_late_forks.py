"""Deneb + electra exercised end-to-end through the chain harness.

The same cases as the JAX package's tests/test_late_forks.py, run on the port
(imports switched to lighthouse_tpu_torch).
"""
import numpy as np
import pytest

from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import ForkName, minimal_spec
from lighthouse_tpu_torch.testing import StateHarness


@pytest.fixture(autouse=True)
def fake_crypto():
    prev, saved = set_device("cpu"), bls._current
    bls.set_backend("fake")
    yield
    bls._current = saved
    set_device(prev)


def test_chain_through_deneb_and_electra():
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                        capella_fork_epoch=0, deneb_fork_epoch=1,
                        electra_fork_epoch=2)
    h = BeaconChainHarness(spec, 64)
    h.extend_chain(4 * spec.preset.slots_per_epoch)
    st = h.chain.head().head_state
    assert st.fork_name == ForkName.ELECTRA
    assert st.pending_deposits is not None
    assert st.latest_execution_payload_header.blob_gas_used == 0
    assert h.chain.finalized_checkpoint()[0] >= 1
    # electra attestations carried committee_bits and were packed
    body = h.chain.head().head_block.message.body
    if body.attestations:
        assert hasattr(body.attestations[0], "committee_bits")


def test_electra_genesis_direct():
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                        capella_fork_epoch=0, deneb_fork_epoch=0,
                        electra_fork_epoch=0)
    h = StateHarness(spec, 64)
    assert h.state.fork_name == ForkName.ELECTRA
    # earliest possible justification is the epoch 2 -> 3 boundary
    h.extend_chain(3 * spec.preset.slots_per_epoch)
    assert h.state.current_justified_checkpoint.epoch >= 1


def test_electra_deposit_request_flow():
    """EIP-6110 deposit request -> pending deposit -> activation path."""
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                        capella_fork_epoch=0, deneb_fork_epoch=0,
                        electra_fork_epoch=0)
    h = StateHarness(spec, 64)
    st = h.state
    T = h.T
    from lighthouse_tpu_torch.state_transition.block import process_deposit_request
    req = T.DepositRequest(pubkey=b"\x77" * 48,
                           withdrawal_credentials=b"\x01" + b"\x00" * 31,
                           amount=32 * 10**9, signature=b"\x88" * 96,
                           index=0)
    process_deposit_request(st, req)
    assert st.deposit_requests_start_index == 0
    assert len(st.pending_deposits) == 1
    # advance with finalization so the pending deposit becomes a validator
    h.extend_chain(4 * spec.preset.slots_per_epoch)
    assert h.state.finalized_checkpoint.epoch >= 1
    assert h.state.validators.index_of(b"\x77" * 48) is not None
    assert len(h.state.pending_deposits) == 0


def test_electra_withdrawal_request_full_exit():
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                        capella_fork_epoch=0, deneb_fork_epoch=0,
                        electra_fork_epoch=0,
                        shard_committee_period=0)
    h = StateHarness(spec, 64)
    st = h.state
    # give validator 5 an execution credential so requests can target it
    addr = b"\xee" * 20
    st.validators.set_field(5, "withdrawal_credentials",
                            b"\x01" + b"\x00" * 11 + addr)
    from lighthouse_tpu_torch.state_transition.block import (
        process_withdrawal_request,
    )
    from lighthouse_tpu_torch.specs.constants import (
        FAR_FUTURE_EPOCH, FULL_EXIT_REQUEST_AMOUNT,
    )
    req = h.T.WithdrawalRequest(
        source_address=addr,
        validator_pubkey=st.validators.pubkey(5),
        amount=FULL_EXIT_REQUEST_AMOUNT)
    process_withdrawal_request(st, req)
    assert st.validators.view(5).exit_epoch != FAR_FUTURE_EPOCH
    # wrong source address is a no-op
    st.validators.set_field(6, "withdrawal_credentials",
                            b"\x01" + b"\x00" * 11 + addr)
    req2 = h.T.WithdrawalRequest(source_address=b"\x00" * 20,
                                 validator_pubkey=st.validators.pubkey(6),
                                 amount=FULL_EXIT_REQUEST_AMOUNT)
    process_withdrawal_request(st, req2)
    assert st.validators.view(6).exit_epoch == FAR_FUTURE_EPOCH


def test_electra_consolidation_request():
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                        capella_fork_epoch=0, deneb_fork_epoch=0,
                        electra_fork_epoch=0,
                        shard_committee_period=0,
                        # enough balance churn that consolidation capacity
                        # exists at 64-validator scale
                        min_per_epoch_churn_limit_electra=256 * 10**9)
    h = StateHarness(spec, 64)
    st = h.state
    addr = b"\xcc" * 20
    st.validators.set_field(1, "withdrawal_credentials",
                            b"\x01" + b"\x00" * 11 + addr)   # source: eth1
    st.validators.set_field(2, "withdrawal_credentials",
                            b"\x02" + b"\x00" * 11 + addr)   # target: compounding
    from lighthouse_tpu_torch.state_transition.block import (
        process_consolidation_request,
    )
    req = h.T.ConsolidationRequest(
        source_address=addr,
        source_pubkey=st.validators.pubkey(1),
        target_pubkey=st.validators.pubkey(2))
    process_consolidation_request(st, req)
    assert len(st.pending_consolidations) == 1
    from lighthouse_tpu_torch.specs.constants import FAR_FUTURE_EPOCH
    assert st.validators.view(1).exit_epoch != FAR_FUTURE_EPOCH
    # switch-to-compounding form (source == target, eth1 cred)
    st.validators.set_field(3, "withdrawal_credentials",
                            b"\x01" + b"\x00" * 11 + addr)
    req2 = h.T.ConsolidationRequest(
        source_address=addr,
        source_pubkey=st.validators.pubkey(3),
        target_pubkey=st.validators.pubkey(3))
    process_consolidation_request(st, req2)
    assert st.validators.view(3).withdrawal_credentials[0] == 0x02
