"""Signature-set constructors + block signature verifier.

Equivalent of the reference's consensus/state_processing/src/per_block_processing/
{signature_sets.rs:56-271, block_signature_verifier.rs:73-419}: every signature
in a block is turned into a `SignatureSet` and verified in ONE batched
`verify_signature_sets` call — the batch the card verifies.
"""
from __future__ import annotations

from ..containers.state import BeaconState
from ..crypto.bls import SignatureSet, verify_signature_sets
from ..specs.chain_spec import ForkName, compute_domain, compute_signing_root
from ..specs.constants import (
    DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER,
    DOMAIN_BLS_TO_EXECUTION_CHANGE, DOMAIN_DEPOSIT, DOMAIN_RANDAO,
    DOMAIN_SYNC_COMMITTEE, DOMAIN_VOLUNTARY_EXIT,
)
from ..ssz import htr, uint64, hash_tree_root
from .helpers import (
    compute_epoch_at_slot, get_domain, StateError,
)


class SignatureSetError(Exception):
    pass


def _pubkey(state: BeaconState, index: int) -> bytes:
    if index >= len(state.validators):
        raise SignatureSetError(f"unknown validator {index}")
    return state.validators.pubkey(index)


def block_proposal_signature_set(state: BeaconState, signed_block,
                                 block_root: bytes | None = None
                                 ) -> SignatureSet:
    block = signed_block.message
    epoch = compute_epoch_at_slot(block.slot, state.slots_per_epoch)
    domain = get_domain(state, DOMAIN_BEACON_PROPOSER, epoch)
    root = block_root if block_root is not None else htr(block)
    signing_root = compute_signing_root(root, domain)
    return SignatureSet(signed_block.signature,
                        [_pubkey(state, block.proposer_index)], signing_root)


def randao_signature_set(state: BeaconState, proposer_index: int,
                         randao_reveal: bytes,
                         block_slot: int | None = None) -> SignatureSet:
    slot = state.slot if block_slot is None else block_slot
    epoch = compute_epoch_at_slot(slot, state.slots_per_epoch)
    domain = get_domain(state, DOMAIN_RANDAO, epoch)
    signing_root = compute_signing_root(
        hash_tree_root(uint64, epoch), domain)
    return SignatureSet(randao_reveal, [_pubkey(state, proposer_index)],
                        signing_root)


def indexed_attestation_signature_set(state: BeaconState,
                                      indexed) -> SignatureSet:
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER,
                        indexed.data.target.epoch)
    signing_root = compute_signing_root(htr(indexed.data), domain)
    pks = [_pubkey(state, i) for i in indexed.attesting_indices]
    return SignatureSet(indexed.signature, pks, signing_root)


def proposer_slashing_signature_sets(state: BeaconState,
                                     slashing) -> list[SignatureSet]:
    out = []
    for signed_header in (slashing.signed_header_1,
                          slashing.signed_header_2):
        h = signed_header.message
        epoch = compute_epoch_at_slot(h.slot, state.slots_per_epoch)
        domain = get_domain(state, DOMAIN_BEACON_PROPOSER, epoch)
        signing_root = compute_signing_root(htr(h), domain)
        out.append(SignatureSet(signed_header.signature,
                                [_pubkey(state, h.proposer_index)],
                                signing_root))
    return out


def attester_slashing_signature_sets(state: BeaconState,
                                     slashing) -> list[SignatureSet]:
    return [indexed_attestation_signature_set(state, slashing.attestation_1),
            indexed_attestation_signature_set(state, slashing.attestation_2)]


def voluntary_exit_signature_set(state: BeaconState,
                                 signed_exit) -> SignatureSet:
    exit_ = signed_exit.message
    # EIP-7044 (deneb+): exits are always signed over the capella fork domain
    if state.fork_name >= ForkName.DENEB:
        domain = compute_domain(DOMAIN_VOLUNTARY_EXIT,
                                state.spec.capella_fork_version,
                                state.genesis_validators_root)
    else:
        domain = get_domain(state, DOMAIN_VOLUNTARY_EXIT, exit_.epoch)
    signing_root = compute_signing_root(htr(exit_), domain)
    return SignatureSet(signed_exit.signature,
                        [_pubkey(state, exit_.validator_index)], signing_root)


def bls_to_execution_change_signature_set(state: BeaconState,
                                          signed_change) -> SignatureSet:
    # signed over the GENESIS fork domain regardless of current fork
    domain = compute_domain(DOMAIN_BLS_TO_EXECUTION_CHANGE,
                            state.spec.genesis_fork_version,
                            state.genesis_validators_root)
    signing_root = compute_signing_root(htr(signed_change.message), domain)
    return SignatureSet(signed_change.signature,
                        [signed_change.message.from_bls_pubkey], signing_root)


def deposit_signature_set(deposit_data, genesis_fork_version: bytes,
                          T) -> SignatureSet:
    """Deposits use compute_domain with zeroed genesis_validators_root and may
    legitimately fail (invalid deposits are skipped, not rejected)."""
    domain = compute_domain(DOMAIN_DEPOSIT, genesis_fork_version, b"\x00" * 32)
    msg = T.DepositMessage(pubkey=deposit_data.pubkey,
                           withdrawal_credentials=deposit_data.withdrawal_credentials,
                           amount=deposit_data.amount)
    signing_root = compute_signing_root(htr(msg), domain)
    return SignatureSet(deposit_data.signature, [deposit_data.pubkey],
                        signing_root)


def sync_aggregate_signature_set(state: BeaconState, sync_aggregate,
                                 block_slot: int) -> SignatureSet | None:
    """Signed over the previous slot's block root. Returns None when no
    participants (empty aggregate with infinity signature is valid)."""
    from ..crypto.bls import INFINITY_SIGNATURE
    previous_slot = max(block_slot, 1) - 1
    epoch = compute_epoch_at_slot(previous_slot, state.slots_per_epoch)
    domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch)
    block_root = state.get_block_root_at_slot(previous_slot)
    signing_root = compute_signing_root(block_root, domain)
    committee = state.current_sync_committee
    pks = [pk for pk, bit in zip(committee.pubkeys,
                                 sync_aggregate.sync_committee_bits) if bit]
    if not pks:
        if sync_aggregate.sync_committee_signature != INFINITY_SIGNATURE:
            raise SignatureSetError("empty sync aggregate with non-infinity sig")
        return None
    return SignatureSet(sync_aggregate.sync_committee_signature, pks,
                        signing_root)


class BlockSignatureVerifier:
    """Collects all signature sets of a block, verifies once.

    Mirrors block_signature_verifier.rs:73-419 (`verify_entire_block`).
    """

    def __init__(self, state: BeaconState):
        self.state = state
        self.sets: list[SignatureSet] = []

    def include(self, s: SignatureSet | None) -> None:
        if s is not None:
            self.sets.append(s)

    def include_all(self, ss) -> None:
        for s in ss:
            self.include(s)

    def include_entire_block(self, signed_block,
                             block_root: bytes | None = None,
                             indexed_attestations=None) -> None:
        from .helpers import get_indexed_attestation
        st = self.state
        block = signed_block.message
        body = block.body
        self.include(block_proposal_signature_set(st, signed_block,
                                                  block_root))
        self.include(randao_signature_set(st, block.proposer_index,
                                          body.randao_reveal, block.slot))
        for ps in body.proposer_slashings:
            self.include_all(proposer_slashing_signature_sets(st, ps))
        for asl in body.attester_slashings:
            self.include_all(attester_slashing_signature_sets(st, asl))
        if indexed_attestations is None:
            indexed_attestations = [get_indexed_attestation(st, a)
                                    for a in body.attestations]
        for ia in indexed_attestations:
            self.include(indexed_attestation_signature_set(st, ia))
        for ex in body.voluntary_exits:
            self.include(voluntary_exit_signature_set(st, ex))
        if hasattr(body, "bls_to_execution_changes"):
            for ch in body.bls_to_execution_changes:
                self.include(bls_to_execution_change_signature_set(st, ch))
        if hasattr(body, "sync_aggregate"):
            self.include(sync_aggregate_signature_set(
                st, body.sync_aggregate, block.slot))
        # NOTE: deposit signatures are intentionally excluded — invalid
        # deposit signatures skip the deposit rather than invalidate the block

    def verify(self) -> bool:
        if not self.sets:
            return True
        return verify_signature_sets(self.sets)
