"""Block verification pipeline (type-state).

Equivalent of the reference's beacon_node/beacon_chain/src/block_verification.rs:
GossipVerifiedBlock (:662) -> SignatureVerifiedBlock (:671) ->
ExecutionPendingBlock (:693) -> ExecutedBlock. Each stage owns the evidence of
the checks already performed, so later stages never re-verify; the signature
stage funnels every signature in the block into ONE batched device-bound
`verify_signature_sets` call (signature_verify_chain_segment :591 batches
whole sync segments the same way).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..crypto import bls
from ..obs import tracing
from ..specs.chain_spec import ForkName
from ..ssz import htr
from ..state_transition import (
    VerifySignatures, per_block_processing, process_slots,
)
from ..state_transition.block import BlockProcessingError
from ..state_transition.helpers import (
    compute_epoch_at_slot, get_beacon_proposer_index,
)
from ..state_transition.signature_sets import (
    BlockSignatureVerifier, block_proposal_signature_set,
)
from .errors import (
    ALREADY_KNOWN, FINALIZED_SLOT, FUTURE_SLOT, INCORRECT_PROPOSER,
    INVALID_BLOCK, INVALID_SIGNATURE, PARENT_UNKNOWN, REPEAT_PROPOSAL,
    BlockError,
)


@dataclass
class GossipVerifiedBlock:
    """Gossip-propagation checks + proposer signature verified
    (block_verification.rs:793 GossipVerifiedBlock::new)."""
    signed_block: object
    block_root: bytes


@dataclass
class SignatureVerifiedBlock:
    """All block signatures verified against the parent-derived state."""
    signed_block: object
    block_root: bytes
    state: object           # parent state advanced to block.slot
    consensus_verified: bool = False


@dataclass
class ExecutionPendingBlock:
    """State transition applied; execution-payload status may still be
    optimistic (resolved by the execution layer)."""
    signed_block: object
    block_root: bytes
    post_state: object
    payload_status: str     # "valid" | "optimistic" | "irrelevant"


def verify_block_for_gossip(chain, signed_block) -> GossipVerifiedBlock:
    block = signed_block.message
    block_root = htr(block)
    with tracing.span("gossip_verify", slot=int(block.slot)):
        return _verify_block_for_gossip(chain, signed_block, block,
                                        block_root)


def _verify_block_for_gossip(chain, signed_block, block,
                             block_root: bytes) -> GossipVerifiedBlock:
    current_slot = chain.slot()
    disparity_slots = 0  # MAXIMUM_GOSSIP_CLOCK_DISPARITY folded into slot 0
    if block.slot > current_slot + disparity_slots:
        raise BlockError(FUTURE_SLOT, f"block slot {block.slot}")
    finalized_slot = chain.finalized_checkpoint()[0] * \
        chain.spec.preset.slots_per_epoch
    if block.slot <= finalized_slot:
        raise BlockError(FINALIZED_SLOT, f"slot {block.slot}")
    if chain.fork_choice.contains_block(block_root):
        raise BlockError(ALREADY_KNOWN, block_root.hex())

    seen = chain.observed_block_producers.proposer_has_been_observed(
        block.slot, block.proposer_index, block_root)
    if seen == "duplicate":
        raise BlockError(ALREADY_KNOWN, "proposal already seen")
    if seen == "slashable":
        chain.observed_slashable.observe(block.slot, block.proposer_index,
                                         block_root)
        # the equivocating second proposal is rejected from gossip, but
        # it is exactly what the slasher exists to see: authenticate it
        # (slasher feed discipline — signed input only) and hand the
        # header over before raising
        sl = getattr(chain, "slasher", None)
        if sl is not None:
            try:
                s = _proposer_signature_set(chain, signed_block, block,
                                            block_root)
                if bls.verify_signature_sets([s]):
                    sl.accept_block_header(
                        signed_header_of(chain.T, signed_block))
            except IndexError:
                pass
        raise BlockError(REPEAT_PROPOSAL,
                         f"proposer {block.proposer_index} equivocated")

    if not chain.fork_choice.contains_block(block.parent_root):
        if chain.pre_finalization_cache.contains(block.parent_root):
            # parent already proven pre-finalization garbage — reject
            # without re-triggering a lookup (pre_finalization_cache.rs)
            raise BlockError(FINALIZED_SLOT,
                             f"parent {block.parent_root.hex()} "
                             "pre-finalization")
        raise BlockError(PARENT_UNKNOWN, block.parent_root.hex())

    # proposer via the epoch-wide proposer cache (one state advance per
    # shuffling decision root, then dict hits — beacon_proposer_cache.rs;
    # replaying the parent state per block cost a state advance each,
    # beacon_chain.rs:2062)
    expected_proposer = chain.proposer_cache.proposer_at(
        chain, block.parent_root, block.slot)
    if block.proposer_index != expected_proposer:
        raise BlockError(INCORRECT_PROPOSER,
                         f"got {block.proposer_index}, "
                         f"expected {expected_proposer}")

    # proposer signature (beacon_chain.rs:2140): pubkey from the head
    # registry (append-only), domain from the spec fork schedule — no
    # state replay on this path either
    s = _proposer_signature_set(chain, signed_block, block, block_root)
    if not bls.verify_signature_sets([s]):
        raise BlockError(INVALID_SIGNATURE, "proposer signature")

    chain.observed_block_producers.observe(block.slot, block.proposer_index,
                                           block_root)
    chain.observed_slashable.observe(block.slot, block.proposer_index,
                                     block_root)
    sl = getattr(chain, "slasher", None)
    if sl is not None:
        sl.accept_block_header(signed_header_of(chain.T, signed_block))
    return GossipVerifiedBlock(signed_block, block_root)


def _proposer_signature_set(chain, signed_block, block, block_root: bytes):
    head_state = chain.head().head_state
    try:
        from ..specs.chain_spec import compute_domain, compute_signing_root
        from ..specs.constants import DOMAIN_BEACON_PROPOSER
        version = chain.spec.fork_version(
            chain.spec.fork_name_at_slot(block.slot))
        domain = compute_domain(DOMAIN_BEACON_PROPOSER, version,
                                head_state.genesis_validators_root)
        signing_root = compute_signing_root(block_root, domain)
        pk = head_state.validators.pubkey(block.proposer_index)
        return bls.SignatureSet(signed_block.signature, [pk], signing_root)
    except IndexError:
        state = chain.state_for_block_production(block.parent_root,
                                                 block.slot)
        return block_proposal_signature_set(state, signed_block, block_root)


def signed_header_of(T, signed_block):
    """SignedBeaconBlockHeader with the block's root-equivalent header
    (SSZ guarantees htr(header) == htr(block), so the block signature
    verifies against the header's signing root too)."""
    block = signed_block.message
    header = T.BeaconBlockHeader(
        slot=block.slot, proposer_index=block.proposer_index,
        parent_root=block.parent_root, state_root=block.state_root,
        body_root=htr(block.body))
    return T.SignedBeaconBlockHeader(message=header,
                                     signature=signed_block.signature)


def into_signature_verified(chain, signed_block, block_root: bytes,
                            proposal_already_verified: bool
                            ) -> SignatureVerifiedBlock:
    """Batch-verify every signature in the block
    (BlockSignatureVerifier::verify_entire_block via block_verification.rs:1286)."""
    block = signed_block.message
    state = chain.state_for_block_import(block.parent_root, block.slot)
    verifier = BlockSignatureVerifier(state)
    verifier.include_entire_block(signed_block, block_root)
    if proposal_already_verified:
        verifier.sets = verifier.sets[1:]  # proposal set is always first
    if not verifier.verify():
        raise BlockError(INVALID_SIGNATURE, "block signature batch")
    return SignatureVerifiedBlock(signed_block, block_root, state)


def into_execution_pending(chain, sv: SignatureVerifiedBlock
                           ) -> ExecutionPendingBlock:
    block = sv.signed_block.message
    state = sv.state
    with tracing.span("state_transition"):
        try:
            # stf_block: per_block_processing alone, excluding the state
            # root below (state_transition keeps the whole-stage timing)
            with tracing.span("stf_block", slot=int(block.slot)):
                per_block_processing(state, sv.signed_block,
                                     VerifySignatures.FALSE,
                                     block_root=sv.block_root)
        except BlockProcessingError as e:
            raise BlockError(INVALID_BLOCK, str(e)) from e
    with tracing.span("state_root"):
        computed_root = state.hash_tree_root()
    if block.state_root != computed_root:
        raise BlockError(INVALID_BLOCK, "state root mismatch")

    payload_status = "irrelevant"
    if state.fork_name >= ForkName.BELLATRIX and \
            hasattr(block.body, "execution_payload"):
        with tracing.span("el_new_payload"):
            payload_status = chain.execution_layer.notify_new_payload(
                block.body.execution_payload)
        if payload_status == "invalid":
            from .errors import EXECUTION_INVALID
            raise BlockError(EXECUTION_INVALID, "EL rejected payload")
    return ExecutionPendingBlock(sv.signed_block, sv.block_root, state,
                                 payload_status)


