"""Blob availability: inclusion proofs, gating, completion (deneb).

The same cases as the JAX package's tests/test_data_availability.py, run on the port
(imports switched to lighthouse_tpu_torch).
"""
import numpy as np
import pytest

from lighthouse_tpu_torch.chain import BeaconChainHarness, BlockError
from lighthouse_tpu_torch.chain.data_availability import (
    commitment_inclusion_proof, produce_sidecars, verify_commitment_inclusion,
)
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.ssz import htr
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True)
def fake_crypto():
    prev, saved = set_device("cpu"), bls._current
    bls.set_backend("fake")
    yield
    bls._current = saved
    set_device(prev)


def _deneb_harness():
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                        capella_fork_epoch=0, deneb_fork_epoch=0)
    return BeaconChainHarness(spec, 64)


def _block_with_blobs(h, n_blobs):
    """Produce a valid deneb block carrying n_blobs commitments."""
    chain = h.chain
    kzg = chain.data_availability_checker.kzg
    blobs = [bytes([i + 1]) * (32 * h.T.preset.field_elements_per_blob)
             for i in range(n_blobs)]
    commitments = [kzg.blob_to_kzg_commitment(b) for b in blobs]
    h.advance_slot()
    slot = chain.slot()
    from lighthouse_tpu_torch.state_transition import process_slots
    from lighthouse_tpu_torch.state_transition.helpers import (
        get_beacon_proposer_index,
    )
    state = chain.head().head_state.copy()
    process_slots(state, slot)
    proposer = get_beacon_proposer_index(state, slot)
    reveal = h.randao_reveal(state, slot, proposer)
    block, _post = chain.produce_block(reveal, slot)
    block.body.blob_kzg_commitments = commitments
    # recompute state root with the commitments included
    post = state.copy()
    unsigned = h.T.SignedBeaconBlock[state.fork_name](
        message=block, signature=bls.INFINITY_SIGNATURE)
    from lighthouse_tpu_torch.state_transition import per_block_processing
    from lighthouse_tpu_torch.state_transition.block import VerifySignatures
    per_block_processing(post, unsigned, VerifySignatures.FALSE)
    block.state_root = post.hash_tree_root()
    signed = h.sign_block(block, state)
    return signed, blobs


def test_inclusion_proof_roundtrip():
    h = _deneb_harness()
    signed, blobs = _block_with_blobs(h, 2)
    T = h.T
    sidecars = produce_sidecars(T, signed, blobs,
                                h.chain.data_availability_checker.kzg)
    body_root = htr(signed.message.body)
    p = T.preset
    for sc in sidecars:
        assert len(sc.kzg_commitment_inclusion_proof) == \
            p.kzg_commitment_inclusion_proof_depth
        assert verify_commitment_inclusion(T, sc, body_root)
    # tampered commitment fails
    bad = sidecars[0].copy()
    bad.kzg_commitment = b"\x99" * 48
    assert not verify_commitment_inclusion(T, bad, body_root)
    # wrong index fails
    bad2 = sidecars[0].copy()
    bad2.index = 1
    assert not verify_commitment_inclusion(T, bad2, body_root)


def test_block_gated_until_blobs_arrive():
    from lighthouse_tpu_torch.chain.errors import AVAILABILITY_PENDING
    h = _deneb_harness()
    chain = h.chain
    signed, blobs = _block_with_blobs(h, 2)
    root = htr(signed.message)
    sidecars = produce_sidecars(h.T, signed, blobs,
                                chain.data_availability_checker.kzg)
    with pytest.raises(BlockError) as e:
        chain.process_block(signed)
    assert e.value.kind == AVAILABILITY_PENDING
    assert chain.process_blob_sidecar(sidecars[0]) is None  # still pending
    imported = chain.process_blob_sidecar(sidecars[1])      # completes
    assert imported == root
    assert chain.head().head_block_root == root


def test_blobs_before_block():
    h = _deneb_harness()
    chain = h.chain
    signed, blobs = _block_with_blobs(h, 1)
    root = htr(signed.message)
    sidecars = produce_sidecars(h.T, signed, blobs,
                                chain.data_availability_checker.kzg)
    assert chain.process_blob_sidecar(sidecars[0]) is None
    # block arrives after its blobs -> imports immediately
    imported = chain.process_block(signed)
    assert imported == root


def test_forged_sidecar_cannot_poison_observed_cache():
    """A sidecar with a bogus proposer_index must be
    rejected BEFORE it is observed, so the real proposer's sidecar still
    imports afterwards."""
    h = _deneb_harness()
    chain = h.chain
    signed, blobs = _block_with_blobs(h, 1)
    root = htr(signed.message)
    sidecars = produce_sidecars(h.T, signed, blobs,
                                chain.data_availability_checker.kzg)
    real = sidecars[0]
    hdr = real.signed_block_header.message
    forged_hdr = h.T.SignedBeaconBlockHeader(
        message=h.T.BeaconBlockHeader(
            slot=hdr.slot, proposer_index=hdr.proposer_index + 1,
            parent_root=hdr.parent_root, state_root=hdr.state_root,
            body_root=hdr.body_root),
        signature=real.signed_block_header.signature)
    forged = h.T.BlobSidecar(
        index=real.index, blob=real.blob, kzg_commitment=real.kzg_commitment,
        kzg_proof=real.kzg_proof, signed_block_header=forged_hdr,
        kzg_commitment_inclusion_proof=real.kzg_commitment_inclusion_proof)
    with pytest.raises(BlockError):
        chain.process_blob_sidecar(forged)
    # the real proposer's sidecar is unaffected (not observed-blocked)
    assert chain.process_blob_sidecar(real) is None  # pending, but accepted
    assert chain.data_availability_checker.contains_sidecar(root, 0)


def test_sidecar_unknown_parent_not_observed():
    h = _deneb_harness()
    chain = h.chain
    signed, blobs = _block_with_blobs(h, 1)
    sidecars = produce_sidecars(h.T, signed, blobs,
                                chain.data_availability_checker.kzg)
    real = sidecars[0]
    hdr = real.signed_block_header.message
    orphan_hdr = h.T.SignedBeaconBlockHeader(
        message=h.T.BeaconBlockHeader(
            slot=hdr.slot, proposer_index=hdr.proposer_index,
            parent_root=b"\x77" * 32, state_root=hdr.state_root,
            body_root=hdr.body_root),
        signature=real.signed_block_header.signature)
    orphan = h.T.BlobSidecar(
        index=real.index, blob=real.blob, kzg_commitment=real.kzg_commitment,
        kzg_proof=real.kzg_proof, signed_block_header=orphan_hdr,
        kzg_commitment_inclusion_proof=real.kzg_commitment_inclusion_proof)
    with pytest.raises(BlockError):
        chain.process_blob_sidecar(orphan)
    ohdr = orphan.signed_block_header.message
    assert not chain.observed_blob_sidecars.has_been_observed(
        ohdr.slot, ohdr.proposer_index, orphan.index)
