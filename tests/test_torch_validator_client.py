"""Validator client end-to-end: VC drives a chain to finalization through
the API backend (the simulator's checks.rs assertion, in-process), plus
slashing-protection unit coverage.

The same cases as the JAX package's tests/test_validator_client.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after the module).
"""
import pytest

from lighthouse_tpu_torch.api import ApiBackend
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.validator_client import (
    BeaconNodeFallback, SlashingDatabase, SlashingError, ValidatorClient,
    ValidatorStore,
)
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


@pytest.fixture(autouse=True)
def fake_crypto():
    bls.set_backend("fake")
    yield


def test_slashing_protection_blocks():
    db = SlashingDatabase()
    pk = b"\xaa" * 48
    db.register_validator(pk)
    db.check_and_insert_block_proposal(pk, 5, b"\x01" * 32)
    # same proposal is fine (re-sign)
    db.check_and_insert_block_proposal(pk, 5, b"\x01" * 32)
    with pytest.raises(SlashingError):
        db.check_and_insert_block_proposal(pk, 5, b"\x02" * 32)
    with pytest.raises(SlashingError):
        db.check_and_insert_block_proposal(pk, 4, b"\x03" * 32)


def test_slashing_protection_attestations():
    db = SlashingDatabase()
    pk = b"\xbb" * 48
    db.register_validator(pk)
    db.check_and_insert_attestation(pk, 2, 3, b"\x01" * 32)
    with pytest.raises(SlashingError):  # double vote
        db.check_and_insert_attestation(pk, 2, 3, b"\x02" * 32)
    with pytest.raises(SlashingError):  # surrounds (1,4) ⊃ (2,3)
        db.check_and_insert_attestation(pk, 1, 4, b"\x03" * 32)
    db.check_and_insert_attestation(pk, 3, 5, b"\x04" * 32)
    with pytest.raises(SlashingError):  # surrounded (4,4)... inside (3,5)
        db.check_and_insert_attestation(pk, 4, 4, b"\x05" * 32)


def test_interchange_roundtrip():
    db = SlashingDatabase()
    pk = b"\xcc" * 48
    db.register_validator(pk)
    db.check_and_insert_block_proposal(pk, 9, b"\x01" * 32)
    db.check_and_insert_attestation(pk, 1, 2, b"\x02" * 32)
    gvr = b"\x42" * 32
    data = db.export_interchange(gvr)
    db2 = SlashingDatabase()
    db2.import_interchange(data, gvr)
    with pytest.raises(SlashingError):
        db2.check_and_insert_block_proposal(pk, 9, b"\xff" * 32)
    with pytest.raises(SlashingError):
        db2.import_interchange(data, b"\x43" * 32)


def test_vc_drives_chain_to_finalization():
    spec = minimal_spec()
    h = BeaconChainHarness(spec, 64)
    backend = ApiBackend(h.chain)
    store = ValidatorStore(spec, h.chain.genesis_validators_root)
    for sk in h.secret_keys:
        store.add_validator(sk)
    vc = ValidatorClient(spec, store, BeaconNodeFallback([backend]))

    for _ in range(5 * spec.preset.slots_per_epoch):
        h.advance_slot()
        vc.on_slot(h.chain.slot())
        h.chain.recompute_head()

    chain = h.chain
    assert vc.published_blocks >= 5 * spec.preset.slots_per_epoch - 2
    assert vc.published_attestations > 0
    assert chain.head().head_state.slot >= 5 * spec.preset.slots_per_epoch - 1
    assert chain.finalized_checkpoint()[0] >= 2, (
        chain.justified_checkpoint(), chain.finalized_checkpoint())


def test_vc_over_http():
    """The full VC loop against the real HTTP server (common/eth2 client)."""
    from lighthouse_tpu_torch.api import BeaconApiServer
    from lighthouse_tpu_torch.validator_client import BeaconNodeHttpClient
    spec = minimal_spec()
    h = BeaconChainHarness(spec, 64)
    srv = BeaconApiServer(ApiBackend(h.chain))
    srv.start()
    try:
        client = BeaconNodeHttpClient(f"http://127.0.0.1:{srv.port}", spec)
        assert client.is_healthy()
        store = ValidatorStore(spec, h.chain.genesis_validators_root)
        for sk in h.secret_keys:
            store.add_validator(sk)
        vc = ValidatorClient(spec, store, BeaconNodeFallback([client]))
        for _ in range(3 * spec.preset.slots_per_epoch):
            h.advance_slot()
            vc.on_slot(h.chain.slot())
            h.chain.recompute_head()
        assert vc.published_blocks >= 3 * spec.preset.slots_per_epoch - 2
        assert vc.published_attestations > 0
        assert h.chain.head().head_state.slot >= \
            3 * spec.preset.slots_per_epoch - 1
        assert h.chain.justified_checkpoint()[0] >= 1
    finally:
        srv.stop()


def test_vc_sync_committee_duty():
    """VC sync messages pool on the BN and land in the next block's
    SyncAggregate (altair), feeding the light-client cache."""
    spec = minimal_spec(altair_fork_epoch=0)
    h = BeaconChainHarness(spec, 64)
    backend = ApiBackend(h.chain)
    store = ValidatorStore(spec, h.chain.genesis_validators_root)
    for sk in h.secret_keys:
        store.add_validator(sk)
    vc = ValidatorClient(spec, store, BeaconNodeFallback([backend]))
    for _ in range(6):
        h.advance_slot()
        vc.on_slot(h.chain.slot())
        h.chain.recompute_head()
    assert vc.published_sync_messages > 0
    body = h.chain.head().head_block.message.body
    assert sum(1 for b in body.sync_aggregate.sync_committee_bits if b) > 0
    assert h.chain.light_client_cache.latest_optimistic_update is not None


def test_store_refuses_double_proposal():
    spec = minimal_spec()
    h = BeaconChainHarness(spec, 64)
    store = ValidatorStore(spec, h.chain.genesis_validators_root)
    pk = store.add_validator(h.secret_keys[0])
    T = h.chain.T
    from lighthouse_tpu_torch.specs import ForkName
    blk = T.BeaconBlock[ForkName.PHASE0](slot=3, proposer_index=0,
                                         parent_root=b"\x01" * 32,
                                         state_root=b"\x02" * 32,
                                         body=T.BeaconBlockBody[
                                             ForkName.PHASE0]())
    store.sign_block(pk, blk)
    blk2 = blk.copy()
    blk2.state_root = b"\x03" * 32
    with pytest.raises(SlashingError):
        store.sign_block(pk, blk2)
    # identical block re-sign is allowed
    store.sign_block(pk, blk)
