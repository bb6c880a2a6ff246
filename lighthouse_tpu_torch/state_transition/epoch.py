"""Per-epoch processing, vectorized.

Equivalent of the reference's consensus/state_processing/src/per_epoch_processing
with the single-pass design of per_epoch_processing/single_pass.rs (1022 LoC):
where the reference fuses its per-validator loops into one pass, this module
expresses the same computation as numpy column arithmetic over the SoA state.
"""
from __future__ import annotations

import numpy as np

from ..containers.state import BeaconState
from ..crypto import bls
from ..specs.chain_spec import ForkName
from ..specs.constants import (
    BASE_REWARDS_PER_EPOCH, FAR_FUTURE_EPOCH, GENESIS_EPOCH,
    PARTICIPATION_FLAG_WEIGHTS, PROPOSER_WEIGHT, TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX, TIMELY_TARGET_FLAG_INDEX, WEIGHT_DENOMINATOR,
)
from ..ssz import htr
from .helpers import (
    compute_activation_exit_epoch, compute_start_slot_at_epoch,
    get_activation_exit_churn_limit, get_active_validator_indices,
    get_attesting_indices, get_base_reward_phase0, get_beacon_proposer_index,
    get_next_sync_committee, get_total_active_balance, get_total_balance,
    get_validator_activation_churn_limit, get_validator_churn_limit,
    has_compounding_withdrawal_credential, initiate_validator_exit,
    integer_squareroot, is_active_validator_mask,
)

MIN_EPOCHS_TO_INACTIVITY_PENALTY = 4


def per_epoch_processing(state: BeaconState) -> None:
    fork = state.fork_name
    if fork == ForkName.PHASE0:
        _per_epoch_phase0(state)
    else:
        _per_epoch_altair(state, fork)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _finality_delay(state: BeaconState) -> int:
    return state.previous_epoch() - state.finalized_checkpoint.epoch


def is_in_inactivity_leak(state: BeaconState) -> bool:
    return _finality_delay(state) > MIN_EPOCHS_TO_INACTIVITY_PENALTY


def eligible_validator_mask(state: BeaconState) -> np.ndarray:
    prev = state.previous_epoch()
    v = state.validators
    active_prev = is_active_validator_mask(state, prev)
    return active_prev | (v.slashed & (prev + 1 < v.withdrawable_epoch))


def weigh_justification_and_finalization(state: BeaconState, total: int,
                                         prev_target: int,
                                         cur_target: int) -> None:
    T = state.T
    previous_epoch = state.previous_epoch()
    current_epoch = state.current_epoch()
    old_previous = state.previous_justified_checkpoint
    old_current = state.current_justified_checkpoint

    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = state.justification_bits
    state.justification_bits = [False] + bits[:-1]
    if prev_target * 3 >= total * 2:
        state.current_justified_checkpoint = T.Checkpoint(
            epoch=previous_epoch, root=state.get_block_root(previous_epoch))
        state.justification_bits[1] = True
    if cur_target * 3 >= total * 2:
        state.current_justified_checkpoint = T.Checkpoint(
            epoch=current_epoch, root=state.get_block_root(current_epoch))
        state.justification_bits[0] = True

    b = state.justification_bits
    if all(b[1:4]) and old_previous.epoch + 3 == current_epoch:
        state.finalized_checkpoint = old_previous
    if all(b[1:3]) and old_previous.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_previous
    if all(b[0:3]) and old_current.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_current
    if all(b[0:2]) and old_current.epoch + 1 == current_epoch:
        state.finalized_checkpoint = old_current


# ---------------------------------------------------------------------------
# Altair+ single pass
# ---------------------------------------------------------------------------

def _unslashed_participating_mask(state: BeaconState, flag_index: int,
                                  epoch: int) -> np.ndarray:
    participation = (state.current_epoch_participation
                     if epoch == state.current_epoch()
                     else state.previous_epoch_participation)
    active = is_active_validator_mask(state, epoch)
    has = (participation & np.uint8(1 << flag_index)) != 0
    return active & has & ~state.validators.slashed


def process_justification_and_finalization(state: BeaconState,
                                           total_active: int | None = None
                                           ) -> None:
    """Altair+ justification/finalization from participation flags (also
    the ef_tests epoch_processing handler's entry point)."""
    inc = state.T.preset.effective_balance_increment
    if state.current_epoch() <= GENESIS_EPOCH + 1:
        return
    if total_active is None:
        total_active = get_total_active_balance(state)
    prev_target = max(inc, int(state.validators.effective_balance[
        _unslashed_participating_mask(
            state, TIMELY_TARGET_FLAG_INDEX,
            state.previous_epoch())].sum()))
    cur_target = max(inc, int(state.validators.effective_balance[
        _unslashed_participating_mask(
            state, TIMELY_TARGET_FLAG_INDEX,
            state.current_epoch())].sum()))
    weigh_justification_and_finalization(state, total_active,
                                         prev_target, cur_target)


def _per_epoch_altair(state: BeaconState, fork: ForkName) -> None:
    total_active = get_total_active_balance(state)
    process_justification_and_finalization(state, total_active)
    _process_inactivity_updates(state)
    _process_rewards_and_penalties_altair(state, fork, total_active)
    _process_registry_updates(state, fork)
    _process_slashings(state, fork, total_active)
    _process_eth1_data_reset(state)
    if fork >= ForkName.ELECTRA:
        _process_pending_deposits(state)
        _process_pending_consolidations(state)
    _process_effective_balance_updates(state)
    _process_slashings_reset(state)
    _process_randao_mixes_reset(state)
    _process_historical_update(state)
    _process_participation_flag_updates(state)
    _process_sync_committee_updates(state)


def _process_inactivity_updates(state: BeaconState) -> None:
    if state.current_epoch() == GENESIS_EPOCH:
        return
    p = state.T.preset
    eligible = eligible_validator_mask(state)
    target_ok = _unslashed_participating_mask(
        state, TIMELY_TARGET_FLAG_INDEX, state.previous_epoch())
    scores = state.inactivity_scores.astype(np.int64)
    scores = np.where(eligible & target_ok,
                      scores - np.minimum(1, scores), scores)
    scores = np.where(eligible & ~target_ok,
                      scores + p.inactivity_score_bias, scores)
    if not is_in_inactivity_leak(state):
        scores = np.where(
            eligible,
            scores - np.minimum(p.inactivity_score_recovery_rate, scores),
            scores)
    # chunk-scatter the changed rows instead of rebinding the column:
    # steady state most scores stay 0, so the CoW column keeps its
    # shared chunks and the incremental tree only re-hashes the delta
    new = scores.astype(np.uint64)
    changed = np.flatnonzero(new != state.inactivity_scores)
    if len(changed):
        state.inactivity_scores[changed] = new[changed]


def _inactivity_penalty_quotient(p, fork: ForkName) -> int:
    if fork >= ForkName.BELLATRIX:
        return p.inactivity_penalty_quotient_bellatrix
    return p.inactivity_penalty_quotient_altair


def altair_flag_deltas(state: BeaconState, total_active: int,
                       flag_index: int) -> tuple[np.ndarray, np.ndarray]:
    """Spec get_flag_index_deltas (per-validator rewards/penalties int64
    arrays) — the EF `rewards` runner's source/target/head components."""
    p = state.T.preset
    inc = p.effective_balance_increment
    eligible = eligible_validator_mask(state)
    eb = state.validators.effective_balance.astype(np.int64)
    base_per_inc = (inc * p.base_reward_factor
                    // integer_squareroot(total_active))
    base_rewards = (eb // inc) * base_per_inc
    active_increments = total_active // inc
    leak = is_in_inactivity_leak(state)
    weight = PARTICIPATION_FLAG_WEIGHTS[flag_index]
    rewards = np.zeros(len(eb), dtype=np.int64)
    penalties = np.zeros(len(eb), dtype=np.int64)
    participating = _unslashed_participating_mask(state, flag_index,
                                                  state.previous_epoch())
    part_increments = int(eb[participating].sum()) // inc
    if not leak:
        reward_num = base_rewards * weight * part_increments
        rewards += np.where(
            eligible & participating,
            reward_num // (active_increments * WEIGHT_DENOMINATOR), 0)
    if flag_index != TIMELY_HEAD_FLAG_INDEX:
        penalties += np.where(eligible & ~participating,
                              base_rewards * weight // WEIGHT_DENOMINATOR,
                              0)
    return rewards, penalties


def altair_inactivity_deltas(state: BeaconState, fork: ForkName
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Spec get_inactivity_penalty_deltas (rewards always zero)."""
    p = state.T.preset
    eligible = eligible_validator_mask(state)
    eb = state.validators.effective_balance.astype(np.int64)
    target_ok = _unslashed_participating_mask(state, TIMELY_TARGET_FLAG_INDEX,
                                              state.previous_epoch())
    quotient = _inactivity_penalty_quotient(p, fork)
    scores = state.inactivity_scores.astype(np.int64)
    penalties = np.where(
        eligible & ~target_ok,
        eb * scores // (p.inactivity_score_bias * quotient), 0)
    return np.zeros(len(eb), dtype=np.int64), penalties


def _process_rewards_and_penalties_altair(state: BeaconState, fork: ForkName,
                                          total_active: int) -> None:
    if state.current_epoch() == GENESIS_EPOCH:
        return
    rewards = np.zeros(len(state.validators), dtype=np.int64)
    penalties = np.zeros(len(state.validators), dtype=np.int64)
    for flag_index in range(len(PARTICIPATION_FLAG_WEIGHTS)):
        r, pen = altair_flag_deltas(state, total_active, flag_index)
        rewards += r
        penalties += pen
    r, pen = altair_inactivity_deltas(state, fork)
    rewards += r
    penalties += pen

    balances = state.balances.astype(np.int64)
    balances = np.maximum(0, balances + rewards - penalties)
    state.balances = balances.astype(np.uint64)


def _process_registry_updates(state: BeaconState, fork: ForkName) -> None:
    p = state.T.preset
    v = state.validators
    current = state.current_epoch()
    # eligibility for the activation queue
    if fork >= ForkName.ELECTRA:
        queue_eligible = (
            (v.activation_eligibility_epoch == np.uint64(FAR_FUTURE_EPOCH))
            & (v.effective_balance >= np.uint64(p.min_activation_balance)))
    else:
        queue_eligible = (
            (v.activation_eligibility_epoch == np.uint64(FAR_FUTURE_EPOCH))
            & (v.effective_balance == np.uint64(p.max_effective_balance)))
    for i in np.flatnonzero(queue_eligible):
        v.set_field(int(i), "activation_eligibility_epoch", current + 1)
    # ejections
    active = is_active_validator_mask(state, current)
    ejectable = active & (v.effective_balance <=
                          np.uint64(state.spec.ejection_balance))
    for i in np.flatnonzero(ejectable):
        if int(v.exit_epoch[i]) == FAR_FUTURE_EPOCH:
            initiate_validator_exit(state, int(i))
    # activations
    pending = np.flatnonzero(
        (v.activation_eligibility_epoch <=
         np.uint64(state.finalized_checkpoint.epoch))
        & (v.activation_epoch == np.uint64(FAR_FUTURE_EPOCH)))
    order = sorted(pending,
                   key=lambda i: (int(v.activation_eligibility_epoch[i]),
                                  int(i)))
    if fork < ForkName.ELECTRA:
        order = order[:get_validator_activation_churn_limit(state)]
    target_epoch = compute_activation_exit_epoch(current,
                                                 p.max_seed_lookahead)
    for i in order:
        v.set_field(int(i), "activation_epoch", target_epoch)


def _process_slashings(state: BeaconState, fork: ForkName,
                       total_active: int) -> None:
    p = state.T.preset
    inc = p.effective_balance_increment
    epoch = state.current_epoch()
    if fork >= ForkName.BELLATRIX:
        mult = p.proportional_slashing_multiplier_bellatrix
    elif fork >= ForkName.ALTAIR:
        mult = p.proportional_slashing_multiplier_altair
    else:
        mult = p.proportional_slashing_multiplier
    adjusted = min(int(state.slashings.sum()) * mult, total_active)
    v = state.validators
    target = epoch + p.epochs_per_slashings_vector // 2
    mask = v.slashed & (v.withdrawable_epoch == np.uint64(target))
    eb = v.effective_balance.astype(np.int64)
    if fork >= ForkName.ELECTRA:
        per_increment = adjusted // (total_active // inc)
        penalties = (eb // inc) * per_increment
    else:
        penalties = (eb // inc) * adjusted // total_active * inc
    rows = np.flatnonzero(mask)
    if len(rows):
        # scatter-write only the slashed validators' balances (the mask
        # is sparse; a wholesale rebind would drop the shared chunks)
        bal = state.balances[rows].astype(np.int64)
        state.balances[rows] = np.maximum(
            0, bal - penalties[rows]).astype(np.uint64)


def _process_eth1_data_reset(state: BeaconState) -> None:
    p = state.T.preset
    next_epoch = state.current_epoch() + 1
    if next_epoch % p.epochs_per_eth1_voting_period == 0:
        state.eth1_data_votes = []


def _process_effective_balance_updates(state: BeaconState) -> None:
    p = state.T.preset
    inc = p.effective_balance_increment
    hysteresis_inc = inc // p.hysteresis_quotient
    down = hysteresis_inc * p.hysteresis_downward_multiplier
    up = hysteresis_inc * p.hysteresis_upward_multiplier
    v = state.validators
    balances = state.balances.astype(np.int64)
    eb = v.effective_balance.astype(np.int64)
    if state.fork_name >= ForkName.ELECTRA:
        compounding = np.array(
            [has_compounding_withdrawal_credential(
                v.withdrawal_credentials[i].tobytes())
             for i in range(len(v))], dtype=bool)
        max_eb = np.where(compounding, p.max_effective_balance_electra,
                          p.min_activation_balance)
    else:
        max_eb = np.full(len(v), p.max_effective_balance, dtype=np.int64)
    needs = (balances + down < eb) | (eb + up < balances)
    new_eb = np.minimum(balances - balances % inc, max_eb)
    updated = np.where(needs, new_eb, eb).astype(np.uint64)
    changed = np.flatnonzero(updated != v.effective_balance)
    if len(changed):
        # chunk-scatter write through the CoW column + vector dirty mark
        # (rebinding would orphan the shared chunks of the whole column)
        v.effective_balance[changed] = updated[changed]
        if len(changed) * 8 < len(v):
            v.mark_dirty_many(changed)
        else:
            v.mark_dirty()


def _process_slashings_reset(state: BeaconState) -> None:
    p = state.T.preset
    next_epoch = state.current_epoch() + 1
    state.slashings[next_epoch % p.epochs_per_slashings_vector] = 0


def _process_randao_mixes_reset(state: BeaconState) -> None:
    p = state.T.preset
    current = state.current_epoch()
    next_epoch = current + 1
    state.randao_mixes[next_epoch % p.epochs_per_historical_vector] = \
        np.frombuffer(state.get_randao_mix(current), np.uint8)


def _process_historical_update(state: BeaconState) -> None:
    p = state.T.preset
    T = state.T
    next_epoch = state.current_epoch() + 1
    if next_epoch % (p.slots_per_historical_root // p.slots_per_epoch) != 0:
        return
    from .slot import roots_vector_htr
    block_root = roots_vector_htr(state.block_roots)
    state_root = roots_vector_htr(state.state_roots)
    if state.fork_name >= ForkName.CAPELLA:
        state.historical_summaries.append(T.HistoricalSummary(
            block_summary_root=block_root, state_summary_root=state_root))
    else:
        from ..utils.hash import hash_concat
        state.historical_roots.append(hash_concat(block_root, state_root))


def _process_participation_flag_updates(state: BeaconState) -> None:
    # previous <- current hands the primed column tree off O(1)
    state.rotate_participation()


def _process_sync_committee_updates(state: BeaconState) -> None:
    p = state.T.preset
    next_epoch = state.current_epoch() + 1
    if next_epoch % p.epochs_per_sync_committee_period == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(state)


# -- electra epoch steps -----------------------------------------------------

def _apply_pending_deposit(state: BeaconState, deposit) -> None:
    from .block import (_deposit_signature_is_valid,
                        get_validator_from_deposit)
    index = state.validators.index_of(deposit.pubkey)
    if index is None:
        if _deposit_signature_is_valid(state, deposit.pubkey,
                                       deposit.withdrawal_credentials,
                                       deposit.amount, deposit.signature):
            v = get_validator_from_deposit(state, deposit.pubkey,
                                           deposit.withdrawal_credentials,
                                           deposit.amount)
            state.validators.append(**v)
            state.balances = np.append(state.balances,
                                       np.uint64(deposit.amount))
            state.previous_epoch_participation = np.append(
                state.previous_epoch_participation, np.uint8(0))
            state.current_epoch_participation = np.append(
                state.current_epoch_participation, np.uint8(0))
            state.inactivity_scores = np.append(state.inactivity_scores,
                                                np.uint64(0))
    else:
        from .helpers import increase_balance
        increase_balance(state, index, deposit.amount)


def _process_pending_deposits(state: BeaconState) -> None:
    from ..specs.constants import GENESIS_SLOT
    next_epoch = state.current_epoch() + 1
    available = state.deposit_balance_to_consume + \
        get_activation_exit_churn_limit(state)
    processed_amount = 0
    next_deposit_index = 0
    postponed = []
    churn_reached = False
    finalized_slot = compute_start_slot_at_epoch(
        state.finalized_checkpoint.epoch, state.slots_per_epoch)
    max_per_epoch = state.T.preset.max_pending_deposits_per_epoch
    # Bounded sweep: at most max_per_epoch entries are consumed per epoch,
    # and the two slot gates are loop-invariant (nothing in this loop
    # moves eth1_deposit_index or the finalized slot), so the stop point
    # over the window is one vectorized scan instead of per-entry checks.
    window = state.pending_deposits[:max_per_epoch + 1]
    bridge_gated = (state.deposit_requests_start_index != FAR_FUTURE_EPOCH
                    and state.eth1_deposit_index <
                    state.deposit_requests_start_index)
    slots = np.fromiter((int(d.slot) for d in window), np.int64, len(window))
    gated = slots > finalized_slot
    if bridge_gated:
        gated |= slots > GENESIS_SLOT
    stop = np.flatnonzero(gated)
    limit = int(stop[0]) if stop.size else len(window)
    for deposit in window[:limit]:
        if next_deposit_index >= max_per_epoch:
            break
        v_index = state.validators.index_of(deposit.pubkey)
        if v_index is not None:
            view = state.validators.view(v_index)
            if view.withdrawable_epoch < next_epoch:
                # exited + withdrawable: balance returns via withdrawal
                _apply_pending_deposit(state, deposit)
                next_deposit_index += 1
                continue
            if view.exit_epoch < FAR_FUTURE_EPOCH:
                postponed.append(deposit)
                next_deposit_index += 1
                continue
        if processed_amount + deposit.amount > available:
            churn_reached = True
            break
        processed_amount += deposit.amount
        _apply_pending_deposit(state, deposit)
        next_deposit_index += 1
    state.pending_deposits = \
        state.pending_deposits[next_deposit_index:] + postponed
    if churn_reached:
        state.deposit_balance_to_consume = available - processed_amount
    else:
        state.deposit_balance_to_consume = 0


def _process_pending_consolidations(state: BeaconState) -> None:
    from .helpers import decrease_balance, increase_balance
    next_epoch = state.current_epoch() + 1
    next_index = 0
    for c in state.pending_consolidations:
        src = state.validators.view(c.source_index)
        if src.slashed:
            next_index += 1
            continue
        if src.withdrawable_epoch > next_epoch:
            break
        balance = min(int(state.balances[c.source_index]),
                      src.effective_balance)
        decrease_balance(state, c.source_index, balance)
        increase_balance(state, c.target_index, balance)
        next_index += 1
    state.pending_consolidations = state.pending_consolidations[next_index:]


# ---------------------------------------------------------------------------
# Phase0 classic epoch processing
# ---------------------------------------------------------------------------

def _attesting_mask_phase0(state: BeaconState, attestations,
                           require_target: bool = False,
                           require_head: bool = False) -> np.ndarray:
    """Mask of unslashed validators attesting in the given attestations."""
    n = len(state.validators)
    mask = np.zeros(n, dtype=bool)
    for a in attestations:
        if require_target and a.data.target.root != \
                state.get_block_root(a.data.target.epoch):
            continue
        if require_head and a.data.beacon_block_root != \
                state.get_block_root_at_slot(a.data.slot):
            continue
        idx = get_attesting_indices(state, a)
        mask[idx] = True
    return mask & ~state.validators.slashed


def _per_epoch_phase0(state: BeaconState) -> None:
    p = state.T.preset
    inc = p.effective_balance_increment
    total_active = get_total_active_balance(state)

    matching_source = list(state.previous_epoch_attestations)
    if state.current_epoch() > GENESIS_EPOCH + 1:
        prev_target_mask = _attesting_mask_phase0(
            state, matching_source, require_target=True)
        cur_target_mask = _attesting_mask_phase0(
            state, [a for a in state.current_epoch_attestations
                    if a.data.target.root ==
                    state.get_block_root(a.data.target.epoch)])
        prev_target = max(inc, int(state.validators.effective_balance[
            prev_target_mask].sum()))
        cur_target = max(inc, int(state.validators.effective_balance[
            cur_target_mask].sum()))
        weigh_justification_and_finalization(state, total_active,
                                             prev_target, cur_target)

    _process_rewards_and_penalties_phase0(state, total_active)
    _process_registry_updates(state, ForkName.PHASE0)
    _process_slashings(state, ForkName.PHASE0, total_active)
    _process_eth1_data_reset(state)
    _process_effective_balance_updates(state)
    _process_slashings_reset(state)
    _process_randao_mixes_reset(state)
    _process_historical_update(state)
    # participation record rotation
    state.previous_epoch_attestations = state.current_epoch_attestations
    state.current_epoch_attestations = []


def phase0_reward_deltas(state: BeaconState, total_active: int
                         ) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Per-component (rewards, penalties) int64 arrays matching the spec's
    get_attestation_deltas split — the EF `rewards` runner's handlers:
    source/target/head (get_{source,target,head}_deltas),
    inclusion_delay (get_inclusion_delay_deltas, no penalties),
    inactivity (get_inactivity_penalty_deltas, no rewards)."""
    p = state.T.preset
    n = len(state.validators)
    eligible = eligible_validator_mask(state)
    eb = state.validators.effective_balance.astype(np.int64)
    sqrt_total = integer_squareroot(total_active)
    base = eb * p.base_reward_factor // sqrt_total // BASE_REWARDS_PER_EPOCH
    inc = p.effective_balance_increment
    leak = is_in_inactivity_leak(state)

    atts = list(state.previous_epoch_attestations)
    source_mask = _attesting_mask_phase0(state, atts)
    target_mask = _attesting_mask_phase0(state, atts, require_target=True)
    head_mask = _attesting_mask_phase0(state, atts, require_target=True,
                                       require_head=True)

    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for name, mask in (("source", source_mask), ("target", target_mask),
                       ("head", head_mask)):
        rewards = np.zeros(n, dtype=np.int64)
        att_balance = int(state.validators.effective_balance[mask].sum())
        if leak:
            # full base reward during a leak (cancelled by the inactivity
            # delta below) — spec get_attestation_component_delta
            rewards += np.where(eligible & mask, base, 0)
        else:
            rewards += np.where(
                eligible & mask,
                base * (att_balance // inc) // (total_active // inc), 0)
        penalties = np.where(eligible & ~mask, base, 0)
        out[name] = (rewards, penalties)

    # inclusion delay rewards: min-delay attestation per attester
    proposer_reward = base // p.proposer_reward_quotient
    best_delay = np.full(n, 2**62, dtype=np.int64)
    best_proposer = np.zeros(n, dtype=np.int64)
    for a in atts:
        idx = get_attesting_indices(state, a)
        better = a.inclusion_delay < best_delay[idx]
        best_delay[idx] = np.where(better, a.inclusion_delay,
                                   best_delay[idx])
        best_proposer[idx] = np.where(better, a.proposer_index,
                                      best_proposer[idx])
    incl_rewards = np.zeros(n, dtype=np.int64)
    for i in np.flatnonzero(source_mask):
        incl_rewards[best_proposer[i]] += int(proposer_reward[i])
        max_attester = int(base[i]) - int(proposer_reward[i])
        incl_rewards[i] += max_attester * p.min_attestation_inclusion_delay \
            // int(best_delay[i])
    out["inclusion_delay"] = (incl_rewards, np.zeros(n, dtype=np.int64))

    inact_penalties = np.zeros(n, dtype=np.int64)
    if leak:
        finality_delay = _finality_delay(state)
        inact_penalties += np.where(
            eligible, BASE_REWARDS_PER_EPOCH * base - proposer_reward, 0)
        inact_penalties += np.where(eligible & ~target_mask,
                                    eb * finality_delay
                                    // p.inactivity_penalty_quotient, 0)
    out["inactivity"] = (np.zeros(n, dtype=np.int64), inact_penalties)
    return out


def _process_rewards_and_penalties_phase0(state: BeaconState,
                                          total_active: int) -> None:
    if state.current_epoch() == GENESIS_EPOCH:
        return
    components = phase0_reward_deltas(state, total_active)
    rewards = np.zeros(len(state.validators), dtype=np.int64)
    penalties = np.zeros(len(state.validators), dtype=np.int64)
    for r, pen in components.values():
        rewards += r
        penalties += pen

    balances = state.balances.astype(np.int64)
    state.balances = np.maximum(0, balances + rewards - penalties).astype(
        np.uint64)
