"""Spec fork choice wrapper over the proto-array.

Equivalent of the reference's consensus/fork_choice/src/fork_choice.rs
(ForkChoice :305; get_head :468, on_block :642, on_attestation :1037,
invalid-payload propagation :604-642): queued attestations, unrealized
justification (pull-up tips), proposer boost, equivocation tracking.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..containers.state import BeaconState
from ..specs.chain_spec import ChainSpec, ForkName
from ..specs.constants import TIMELY_TARGET_FLAG_INDEX
from ..state_transition.epoch import (
    _attesting_mask_phase0, _unslashed_participating_mask,
)
from ..state_transition.helpers import (
    compute_epoch_at_slot, compute_start_slot_at_epoch,
    get_total_active_balance,
)
from .proto_array import (
    ExecutionStatus, ProtoArray, ProtoArrayError, ProtoNode, VoteTracker,
    compute_deltas,
)


class ForkChoiceError(Exception):
    pass


@dataclass
class QueuedAttestation:
    slot: int
    attesting_indices: list[int]
    block_root: bytes
    target_epoch: int


def _unrealized_checkpoints(state: BeaconState):
    """Justification/finalization as they WOULD be after epoch processing —
    without mutating the state (the progressive-balances shortcut the
    reference uses for pulled-up tips)."""
    from ..state_transition.epoch import weigh_justification_and_finalization
    inc = state.T.preset.effective_balance_increment
    eb = state.validators.effective_balance

    class _Shadow:
        pass

    sh = _Shadow()
    sh.T = state.T
    sh.justification_bits = list(state.justification_bits)
    sh.previous_justified_checkpoint = state.previous_justified_checkpoint
    sh.current_justified_checkpoint = state.current_justified_checkpoint
    sh.finalized_checkpoint = state.finalized_checkpoint
    sh.current_epoch = state.current_epoch
    sh.previous_epoch = state.previous_epoch
    sh.get_block_root = state.get_block_root

    if state.current_epoch() <= 1:
        return (state.current_justified_checkpoint,
                state.finalized_checkpoint)
    total = get_total_active_balance(state)
    if state.fork_name == ForkName.PHASE0:
        prev_mask = _attesting_mask_phase0(
            state, list(state.previous_epoch_attestations),
            require_target=True)
        cur_mask = _attesting_mask_phase0(
            state, [a for a in state.current_epoch_attestations
                    if a.data.target.root ==
                    state.get_block_root(a.data.target.epoch)])
    else:
        prev_mask = _unslashed_participating_mask(
            state, TIMELY_TARGET_FLAG_INDEX, state.previous_epoch())
        cur_mask = _unslashed_participating_mask(
            state, TIMELY_TARGET_FLAG_INDEX, state.current_epoch())
    prev_target = max(inc, int(eb[prev_mask].sum()))
    cur_target = max(inc, int(eb[cur_mask].sum()))
    weigh_justification_and_finalization(sh, total, prev_target, cur_target)
    return sh.current_justified_checkpoint, sh.finalized_checkpoint


def _ckpt(checkpoint) -> tuple[int, bytes]:
    return (checkpoint.epoch, checkpoint.root)


def _active_effective_balances(state: BeaconState) -> np.ndarray:
    """Effective balance for validators active at the state's epoch, 0 for
    the rest (the reference's JustifiedBalances::from_justified_state)."""
    epoch = state.current_epoch()
    v = state.validators
    active = ((v.activation_epoch <= epoch) & (epoch < v.exit_epoch)
              & ~v.slashed)
    return np.where(active, v.effective_balance, 0).astype(np.uint64)


class ForkChoice:
    """One instance per beacon chain; all methods assume external locking
    (the chain layer provides the canonical-head write lock)."""

    def __init__(self, spec: ChainSpec, genesis_block_root: bytes,
                 anchor_state: BeaconState):
        """Anchored at the given block (genesis OR a checkpoint-sync anchor):
        spec get_forkchoice_store — justified = finalized = the anchor
        checkpoint itself, since nothing older exists in the proto array."""
        self.spec = spec
        anchor_epoch = anchor_state.slot // spec.preset.slots_per_epoch
        justified = (anchor_epoch, genesis_block_root)
        finalized = (anchor_epoch, genesis_block_root)
        self.proto_array = ProtoArray(justified, finalized)
        self.votes: list[VoteTracker] = []
        self.balances = anchor_state.validators.effective_balance.copy()
        self.queued_attestations: list[QueuedAttestation] = []
        self.equivocating_indices: set[int] = set()
        self.justified_checkpoint = justified
        self.finalized_checkpoint = finalized
        self.unrealized_justified_checkpoint = justified
        self.unrealized_finalized_checkpoint = finalized
        self.proposer_boost_root: bytes = b"\x00" * 32
        self.current_slot = anchor_state.slot
        self.genesis_block_root = genesis_block_root
        # balances snapshot used for the previous delta application
        self._old_balances = np.zeros(0, dtype=np.uint64)
        # LMD weights come from the JUSTIFIED-checkpoint state's active
        # effective balances (fork_choice.rs:642 / JustifiedBalances), not
        # the latest block's.  The chain layer installs a provider
        # (justified root -> balances); `self.balances` (latest block) is
        # only the fallback when the justified state is unavailable.
        self.balances_provider = None
        self._justified_balances: np.ndarray | None = \
            _active_effective_balances(anchor_state)
        # keyed by the full (epoch, root) checkpoint: the same root can be
        # re-justified at a later epoch across empty boundary slots, and
        # activations/exits at that epoch change the weights
        self._justified_balances_ckpt: tuple[int, bytes] = justified

        anchor_root = genesis_block_root
        epoch = anchor_state.current_epoch()
        self.proto_array.on_block(ProtoNode(
            slot=anchor_state.slot, root=anchor_root, parent=None,
            state_root=anchor_state.hash_tree_root()
            if anchor_state.slot == 0 else b"\x00" * 32,
            target_root=anchor_root,
            justified_checkpoint=justified,
            finalized_checkpoint=finalized,
            execution_status=(ExecutionStatus.OPTIMISTIC
                              if anchor_state.fork_name >= ForkName.BELLATRIX
                              else ExecutionStatus.IRRELEVANT)))

    # -- time ----------------------------------------------------------------

    def update_time(self, current_slot: int) -> None:
        while self.current_slot < current_slot:
            self.current_slot += 1
            self._on_tick(self.current_slot)

    def _on_tick(self, slot: int) -> None:
        self.proposer_boost_root = b"\x00" * 32
        if slot % self.spec.preset.slots_per_epoch == 0:
            # pull-up tick: adopt unrealized checkpoints
            if self.unrealized_justified_checkpoint[0] > \
                    self.justified_checkpoint[0]:
                self.justified_checkpoint = \
                    self.unrealized_justified_checkpoint
            if self.unrealized_finalized_checkpoint[0] > \
                    self.finalized_checkpoint[0]:
                self._update_finalized(self.unrealized_finalized_checkpoint)
        self._process_queued_attestations(slot)

    # -- blocks --------------------------------------------------------------

    def on_block(self, current_slot: int, block, block_root: bytes,
                 state: BeaconState,
                 block_delay_seconds: float | None = None,
                 execution_status: ExecutionStatus | None = None) -> None:
        """Register a fully-verified block (fork_choice.rs:642)."""
        self.update_time(current_slot)
        if block.parent_root not in self.proto_array and \
                len(self.proto_array.nodes) > 0:
            raise ForkChoiceError("on_block: unknown parent")

        # proposer boost: timely current-slot block
        if block.slot == current_slot and block_delay_seconds is not None:
            if block_delay_seconds < self.spec.seconds_per_slot / 3:
                self.proposer_boost_root = block_root

        state_justified = _ckpt(state.current_justified_checkpoint)
        state_finalized = _ckpt(state.finalized_checkpoint)
        if state_justified[0] > self.justified_checkpoint[0]:
            self.justified_checkpoint = state_justified
        if state_finalized[0] > self.finalized_checkpoint[0]:
            self._update_finalized(state_finalized)

        unrealized_j, unrealized_f = _unrealized_checkpoints(state)
        uj, uf = _ckpt(unrealized_j), _ckpt(unrealized_f)
        if uj[0] > self.unrealized_justified_checkpoint[0]:
            self.unrealized_justified_checkpoint = uj
        if uf[0] > self.unrealized_finalized_checkpoint[0]:
            self.unrealized_finalized_checkpoint = uf
        # blocks from prior epochs are pulled up immediately
        block_epoch = compute_epoch_at_slot(
            block.slot, self.spec.preset.slots_per_epoch)
        current_epoch = compute_epoch_at_slot(
            current_slot, self.spec.preset.slots_per_epoch)
        if block_epoch < current_epoch:
            if uj[0] > self.justified_checkpoint[0]:
                self.justified_checkpoint = uj
            if uf[0] > self.finalized_checkpoint[0]:
                self._update_finalized(uf)

        target_slot = compute_start_slot_at_epoch(
            block_epoch, self.spec.preset.slots_per_epoch)
        target_root = (block_root if block.slot == target_slot
                       else state.get_block_root_at_slot(target_slot))

        if execution_status is None:
            has_payload = state.fork_name >= ForkName.BELLATRIX and \
                hasattr(block.body, "execution_payload")
            execution_status = (ExecutionStatus.OPTIMISTIC if has_payload
                               else ExecutionStatus.IRRELEVANT)
        payload_hash = None
        if hasattr(block.body, "execution_payload"):
            payload_hash = block.body.execution_payload.block_hash

        self.proto_array.on_block(ProtoNode(
            slot=block.slot, root=block_root,
            parent=self.proto_array.indices.get(block.parent_root),
            state_root=block.state_root, target_root=target_root,
            justified_checkpoint=state_justified,
            finalized_checkpoint=state_finalized,
            unrealized_justified_checkpoint=uj,
            unrealized_finalized_checkpoint=uf,
            execution_status=execution_status,
            execution_block_hash=payload_hash))

        self.balances = state.validators.effective_balance.copy()

    def _update_finalized(self, finalized: tuple[int, bytes]) -> None:
        self.finalized_checkpoint = finalized

    # -- attestations --------------------------------------------------------

    def on_attestation(self, current_slot: int, indexed_attestation,
                       is_from_block: bool = False) -> None:
        """LMD vote intake (fork_choice.rs:1037). Attestations only affect
        fork choice from the slot after they were created."""
        self.update_time(current_slot)
        data = indexed_attestation.data
        target_epoch = data.target.epoch
        epoch_now = compute_epoch_at_slot(current_slot,
                                          self.spec.preset.slots_per_epoch)
        if not is_from_block:
            if target_epoch not in (epoch_now, epoch_now - 1):
                raise ForkChoiceError("attestation target epoch not current")
            if data.slot > current_slot:
                raise ForkChoiceError("attestation from the future")
        if data.beacon_block_root not in self.proto_array:
            raise ForkChoiceError("attestation for unknown block")
        block = self.proto_array.get(data.beacon_block_root)
        if block.slot > data.slot:
            raise ForkChoiceError("attestation for block newer than slot")
        if data.slot < current_slot:
            self._apply_vote(indexed_attestation.attesting_indices,
                             data.beacon_block_root, target_epoch)
        else:
            self.queued_attestations.append(QueuedAttestation(
                slot=data.slot,
                attesting_indices=list(indexed_attestation.attesting_indices),
                block_root=data.beacon_block_root,
                target_epoch=target_epoch))

    def _process_queued_attestations(self, current_slot: int) -> None:
        remaining = []
        for qa in self.queued_attestations:
            if qa.slot < current_slot:
                self._apply_vote(qa.attesting_indices, qa.block_root,
                                 qa.target_epoch)
            else:
                remaining.append(qa)
        self.queued_attestations = remaining

    def _apply_vote(self, indices, block_root: bytes,
                    target_epoch: int) -> None:
        for i in indices:
            i = int(i)
            while len(self.votes) <= i:
                self.votes.append(VoteTracker())
            v = self.votes[i]
            if i in self.equivocating_indices:
                continue
            # an empty tracker is always replaceable (epoch-0 votes must
            # register; spec: `i not in store.latest_messages`)
            if target_epoch > v.next_epoch or v.next_root == b"\x00" * 32:
                v.next_epoch = target_epoch
                v.next_root = block_root

    def on_attester_slashing(self, indexed_attestation) -> None:
        for i in indexed_attestation.attesting_indices:
            self.equivocating_indices.add(int(i))

    # -- head ----------------------------------------------------------------

    def _current_justified_balances(self) -> np.ndarray:
        """Active effective balances of the justified-checkpoint state,
        refreshed through the chain-installed provider when the justified
        checkpoint moves; falls back to latest-block balances."""
        ckpt = self.justified_checkpoint
        if ckpt != self._justified_balances_ckpt and \
                self.balances_provider is not None:
            bal = self.balances_provider(ckpt)
            if bal is not None:
                self._justified_balances = np.asarray(bal, dtype=np.uint64)
                self._justified_balances_ckpt = ckpt
        if self._justified_balances is not None and \
                self._justified_balances_ckpt == ckpt:
            return self._justified_balances
        return self.balances

    def get_head(self, current_slot: int) -> bytes:
        """Recompute and return the head root (fork_choice.rs:468)."""
        self.update_time(current_slot)
        new_balances = self._current_justified_balances()
        deltas = compute_deltas(self.proto_array.indices, self.votes,
                                self._old_balances, new_balances,
                                self.equivocating_indices)
        boost = (self.proposer_boost_root,
                 self._proposer_boost_amount(new_balances))
        self.proto_array.apply_score_changes(
            deltas, self.justified_checkpoint, self.finalized_checkpoint,
            boost)
        self._old_balances = new_balances.copy()
        return self.proto_array.find_head(self.justified_checkpoint[1])

    def _proposer_boost_amount(self, balances: np.ndarray) -> int:
        if self.proposer_boost_root == b"\x00" * 32:
            return 0
        total = int(balances.sum())
        committee_weight = total // self.spec.preset.slots_per_epoch
        return committee_weight * self.spec.proposer_score_boost // 100

    # -- optimistic sync -----------------------------------------------------

    def on_valid_execution_payload(self, block_root: bytes) -> None:
        self.proto_array.process_execution_payload_validation(block_root)

    def on_invalid_execution_payload(self, head_block_root: bytes,
                                     latest_valid_hash: bytes | None) -> None:
        self.proto_array.process_execution_payload_invalidation(
            head_block_root, latest_valid_hash)

    def is_optimistic(self, block_root: bytes) -> bool:
        node = self.proto_array.get(block_root)
        return node is not None and \
            node.execution_status == ExecutionStatus.OPTIMISTIC

    # -- pruning / persistence ----------------------------------------------

    def prune(self) -> None:
        fin_root = self.finalized_checkpoint[1]
        if fin_root in self.proto_array:
            self.proto_array.maybe_prune(fin_root)

    def contains_block(self, root: bytes) -> bool:
        return root in self.proto_array
