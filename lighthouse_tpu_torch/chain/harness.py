"""BeaconChainHarness: an in-process chain with manual clock, deterministic
keys and a mock EL.

Equivalent of the reference's beacon_node/beacon_chain/src/test_utils.rs:611:
extend chains, fork them, attest with arbitrary validator subsets — the
substrate for chain/store/API tests (SURVEY.md §4).
"""
from __future__ import annotations

from ..crypto import bls
from ..specs.chain_spec import ChainSpec, compute_signing_root
from ..specs.chain_spec import ForkName
from ..specs.constants import DOMAIN_BEACON_PROPOSER, DOMAIN_RANDAO
from ..ssz import hash_tree_root, htr, uint64
from ..state_transition.helpers import (
    committee_cache, compute_epoch_at_slot, get_domain,
)
from ..store import HotColdDB, MemoryStore
from ..testing.state_harness import StateHarness
from ..utils.slot_clock import ManualSlotClock
from .builder import BeaconChainBuilder
from .execution import MockExecutionLayer


class BeaconChainHarness:
    def __init__(self, spec: ChainSpec, validator_count: int = 64,
                 store: HotColdDB | None = None):
        self.spec = spec
        self.sh = StateHarness(spec, validator_count)
        self.secret_keys = self.sh.secret_keys
        self.mock_el = MockExecutionLayer()
        self.clock = ManualSlotClock(0, spec.seconds_per_slot, current_slot=0)
        builder = (BeaconChainBuilder(spec)
                   .genesis_state(self.sh.genesis_state.copy())
                   .slot_clock(self.clock)
                   .execution_layer(self.mock_el))
        if store is not None:
            builder.store(store)
        self.chain = builder.build()
        self.T = self.chain.T

    # -- clock ---------------------------------------------------------------

    def advance_slot(self) -> None:
        self.clock.advance_slot()
        self.chain.per_slot_task()

    def set_slot(self, slot: int) -> None:
        self.clock.set_slot(slot)
        self.chain.per_slot_task()

    # -- signing -------------------------------------------------------------

    def sign_block(self, block, state):
        epoch = compute_epoch_at_slot(block.slot,
                                      self.spec.preset.slots_per_epoch)
        domain = get_domain(state, DOMAIN_BEACON_PROPOSER, epoch)
        root = compute_signing_root(htr(block), domain)
        sig = bls.sign(self.secret_keys[block.proposer_index], root)
        fork = self.spec.fork_name_at_slot(block.slot)
        return self.T.SignedBeaconBlock[fork](message=block, signature=sig)

    def randao_reveal(self, state, slot: int, proposer_index: int) -> bytes:
        epoch = compute_epoch_at_slot(slot, self.spec.preset.slots_per_epoch)
        domain = get_domain(state, DOMAIN_RANDAO, epoch)
        root = compute_signing_root(hash_tree_root(uint64, epoch), domain)
        return bls.sign(self.secret_keys[proposer_index], root)

    # -- attesting -----------------------------------------------------------

    def attest_to_head(self, validators: list[int] | None = None) -> int:
        """Produce attestations for the current head at the current slot,
        feed them through gossip verification into fork choice + op pool.
        Returns the number accepted."""
        chain = self.chain
        head = chain.head()
        slot = chain.slot()
        state = head.head_state
        if state.slot < slot:
            state = state.copy()
            from ..state_transition import process_slots
            process_slots(state, slot)
        atts = self.sh.produce_attestations(state, slot,
                                            head.head_block_root)
        if validators is not None:
            allowed = set(validators)
            from ..state_transition.helpers import get_attesting_indices
            filtered = []
            epoch = compute_epoch_at_slot(slot,
                                          self.spec.preset.slots_per_epoch)
            cache = committee_cache(state, epoch)
            for index, att in enumerate(atts):
                committee = cache.committee(slot, att.data.index)
                bits = [bool(int(v) in allowed) for v in committee]
                if not any(bits):
                    continue
                att.aggregation_bits = bits
                filtered.append(att)
            atts = filtered
        accepted = 0
        # split each committee attestation into per-validator singles for the
        # unaggregated gossip path, then insert the aggregate into the pool
        for att in atts:
            chain.op_pool.insert_attestation(att)
            from ..state_transition.helpers import get_indexed_attestation
            try:
                indexed = get_indexed_attestation(state, att)
                chain.fork_choice.on_attestation(slot, indexed,
                                                 is_from_block=False)
                accepted += 1
            except Exception:
                pass
        return accepted

    # -- block production ----------------------------------------------------

    def produce_signed_block(self, slot: int | None = None):
        chain = self.chain
        slot = slot if slot is not None else chain.slot()
        head_state = chain.head().head_state
        proposer_state = head_state
        if proposer_state.slot < slot:
            proposer_state = proposer_state.copy()
            from ..state_transition import process_slots
            process_slots(proposer_state, slot)
        from ..state_transition.helpers import get_beacon_proposer_index
        proposer = get_beacon_proposer_index(proposer_state, slot)
        reveal = self.randao_reveal(proposer_state, slot, proposer)
        sync_agg = None
        if proposer_state.fork_name >= ForkName.ALTAIR:
            sync_agg = self.sh.produce_sync_aggregate(
                proposer_state, slot, chain.head().head_block_root)
        block, post = chain.produce_block(reveal, slot,
                                          sync_aggregate=sync_agg)
        return self.sign_block(block, proposer_state), post

    def extend_chain(self, num_blocks: int, attest: bool = True) -> list:
        """Advance slot, attest, produce + import — the canonical harness
        loop (test_utils.rs extend_chain)."""
        roots = []
        for _ in range(num_blocks):
            self.advance_slot()
            signed, _post = self.produce_signed_block()
            root = self.chain.process_block(signed)
            roots.append(root)
            if attest:
                self.attest_to_head()
        return roots
