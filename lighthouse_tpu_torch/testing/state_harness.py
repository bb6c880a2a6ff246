"""State-level harness: produce blocks/attestations against a bare state.

The state-transition core of the reference's BeaconChainHarness
(beacon_chain/src/test_utils.rs:611): extend a chain of blocks with full
attestation participation using deterministic keys, without fork
choice/store/network. The full chain harness (chain/harness.py) builds on it.
"""
from __future__ import annotations

import numpy as np

from ..containers import get_types
from ..containers.state import BeaconState
from ..crypto import bls
from ..specs.chain_spec import ChainSpec, ForkName, compute_signing_root
from ..specs.constants import (
    DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER, DOMAIN_RANDAO,
    DOMAIN_SYNC_COMMITTEE,
)
from ..ssz import hash_tree_root, htr, uint64
from ..state_transition import (
    BlockProcessingError, VerifySignatures, interop_genesis_state,
    per_block_processing, process_slots,
)
from ..state_transition.block import get_expected_withdrawals
from ..state_transition.helpers import (
    committee_cache, compute_epoch_at_slot, compute_start_slot_at_epoch,
    get_beacon_proposer_index, get_domain,
)


class StateHarness:
    def __init__(self, spec: ChainSpec, validator_count: int = 64,
                 genesis_time: int = 0):
        self.spec = spec
        self.T = get_types(spec.preset)
        self.secret_keys = [bls.keygen_interop(i)
                            for i in range(validator_count)]
        self.state = interop_genesis_state(spec, self.secret_keys,
                                           genesis_time=genesis_time)
        self.genesis_state = self.state.copy()

    # -- signing -------------------------------------------------------------

    def sign_block(self, state: BeaconState, block) -> object:
        epoch = compute_epoch_at_slot(block.slot, state.slots_per_epoch)
        domain = get_domain(state, DOMAIN_BEACON_PROPOSER, epoch)
        signing_root = compute_signing_root(htr(block), domain)
        sig = bls.sign(self.secret_keys[block.proposer_index], signing_root)
        fork = state.spec.fork_name_at_slot(block.slot)
        return self.T.SignedBeaconBlock[fork](message=block, signature=sig)

    def randao_reveal(self, state: BeaconState, slot: int,
                      proposer_index: int) -> bytes:
        epoch = compute_epoch_at_slot(slot, state.slots_per_epoch)
        domain = get_domain(state, DOMAIN_RANDAO, epoch)
        signing_root = compute_signing_root(
            hash_tree_root(uint64, epoch), domain)
        return bls.sign(self.secret_keys[proposer_index], signing_root)

    # -- attestations --------------------------------------------------------

    def attestation_data(self, state: BeaconState, slot: int,
                         index: int, head_root: bytes):
        T = self.T
        epoch = compute_epoch_at_slot(slot, state.slots_per_epoch)
        epoch_start = compute_start_slot_at_epoch(epoch,
                                                  state.slots_per_epoch)
        if epoch_start == slot or state.slot <= epoch_start:
            target_root = head_root
        else:
            target_root = state.get_block_root_at_slot(epoch_start)
        return T.AttestationData(
            slot=slot, index=index, beacon_block_root=head_root,
            source=state.current_justified_checkpoint,
            target=T.Checkpoint(epoch=epoch, root=target_root))

    def produce_attestations(self, state: BeaconState, slot: int,
                             head_root: bytes) -> list:
        """One fully-aggregated attestation per committee at `slot`.

        `state` must be at `slot` (or later within the epoch).
        """
        T = self.T
        epoch = compute_epoch_at_slot(slot, state.slots_per_epoch)
        cache = committee_cache(state, epoch)
        electra = state.fork_name >= ForkName.ELECTRA
        out = []
        for index in range(cache.committees_per_slot):
            committee = cache.committee(slot, index)
            data = self.attestation_data(
                state, slot, 0 if electra else index, head_root)
            domain = get_domain(state, DOMAIN_BEACON_ATTESTER, epoch)
            signing_root = compute_signing_root(htr(data), domain)
            sigs = [bls.sign(self.secret_keys[int(v)], signing_root)
                    for v in committee]
            agg = bls.aggregate_signatures(sigs)
            if electra:
                committee_bits = [i == index
                                  for i in range(
                                      self.T.preset.max_committees_per_slot)]
                att = T.AttestationElectra(
                    aggregation_bits=[True] * len(committee), data=data,
                    signature=agg, committee_bits=committee_bits)
            else:
                att = T.Attestation(
                    aggregation_bits=[True] * len(committee), data=data,
                    signature=agg)
            out.append(att)
        return out

    # -- sync aggregate ------------------------------------------------------

    def produce_sync_aggregate(self, state: BeaconState, block_slot: int,
                               head_root: bytes):
        T = self.T
        previous_slot = max(block_slot, 1) - 1
        epoch = compute_epoch_at_slot(previous_slot, state.slots_per_epoch)
        domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch)
        signing_root = compute_signing_root(head_root, domain)
        committee = state.current_sync_committee
        sigs, bits = [], []
        for pk in committee.pubkeys:
            idx = state.validators.index_of(pk)
            if idx is not None:
                sigs.append(bls.sign(self.secret_keys[idx], signing_root))
                bits.append(True)
            else:
                bits.append(False)
        agg = (bls.aggregate_signatures(sigs) if sigs
               else bls.INFINITY_SIGNATURE)
        return T.SyncAggregate(sync_committee_bits=bits,
                               sync_committee_signature=agg)

    # -- block production ----------------------------------------------------

    def produce_block_on_state(self, state: BeaconState, slot: int,
                               attestations: list | None = None,
                               deposits: list | None = None,
                               exits: list | None = None,
                               graffiti: bytes = b"\x00" * 32):
        """Advance `state` to `slot` and build+apply+sign a block on it.

        Returns (signed_block, post_state). Mirrors the 3-phase structure of
        beacon_chain.rs:4810 produce_block_on_state (packing, payload,
        completion) with the op pool replaced by explicit arguments.
        """
        T = self.T
        if state.slot < slot:
            process_slots(state, slot)
        fork = state.fork_name
        proposer_index = get_beacon_proposer_index(state)
        parent_root = htr(state.latest_block_header)

        body_cls = T.BeaconBlockBody[fork]
        body = body_cls(
            randao_reveal=self.randao_reveal(state, slot, proposer_index),
            eth1_data=state.eth1_data, graffiti=graffiti,
            attestations=list(attestations or []),
            deposits=list(deposits or []),
            voluntary_exits=list(exits or []))
        if fork >= ForkName.ALTAIR:
            body.sync_aggregate = self.produce_sync_aggregate(
                state, slot, parent_root)
        if fork >= ForkName.BELLATRIX:
            body.execution_payload = self._stub_payload(state, fork)

        block = T.BeaconBlock[fork](
            slot=slot, proposer_index=proposer_index,
            parent_root=parent_root, state_root=b"\x00" * 32, body=body)

        post = state.copy()
        signed = self.sign_block(state, block)
        per_block_processing(post, signed, VerifySignatures.FALSE)
        block.state_root = post.hash_tree_root()
        signed = self.sign_block(state, block)  # re-sign with state root
        return signed, post

    def _stub_payload(self, state: BeaconState, fork: ForkName):
        """Minimal valid local payload (mock-EL style)."""
        from ..state_transition.block import compute_timestamp_at_slot
        cls = self.T.ExecutionPayload[fork]
        parent_hash = (state.latest_execution_payload_header.block_hash
                       if state.fork_name >= ForkName.BELLATRIX
                       else b"\x00" * 32)
        kw = dict(
            parent_hash=parent_hash,
            prev_randao=state.get_randao_mix(state.current_epoch()),
            block_number=state.latest_execution_payload_header.block_number + 1,
            timestamp=compute_timestamp_at_slot(state, state.slot),
            block_hash=htr(self.T.Checkpoint(
                epoch=state.slot, root=parent_hash)),
            base_fee_per_gas=7,
        )
        if fork >= ForkName.CAPELLA:
            withdrawals, _ = get_expected_withdrawals(state)
            kw["withdrawals"] = withdrawals
        payload = cls(**kw)
        return payload

    # -- chain extension -----------------------------------------------------

    def extend_chain(self, num_blocks: int, attest: bool = True):
        """Produce `num_blocks` blocks with full attestations (one per slot),
        applying them to self.state. Returns the signed blocks."""
        blocks = []
        for _ in range(num_blocks):
            slot = self.state.slot + 1
            atts = []
            if attest and slot > 1:
                # attestations for the previous slot's head
                head_root = htr(self.state.latest_block_header)
                hdr = self.state.latest_block_header
                if hdr.state_root == b"\x00" * 32:
                    hdr = self.T.BeaconBlockHeader(
                        slot=hdr.slot, proposer_index=hdr.proposer_index,
                        parent_root=hdr.parent_root,
                        state_root=self.state.hash_tree_root(),
                        body_root=hdr.body_root)
                    head_root = htr(hdr)
                atts = self.produce_attestations(
                    self.state, self.state.slot, head_root)
            signed, post = self.produce_block_on_state(
                self.state, slot, attestations=atts)
            self.state = post
            blocks.append(signed)
        return blocks
