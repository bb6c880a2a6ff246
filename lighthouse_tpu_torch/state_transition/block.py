"""Per-block processing.

Equivalent of the reference's consensus/state_processing/src/per_block_processing.rs
(:100-667) and per_block_processing/process_operations.rs. Signature handling
follows the reference: either verified individually, collected into a
BlockSignatureVerifier batch (the card's path), or skipped.
"""
from __future__ import annotations

import enum
import hashlib

import numpy as np

from ..containers.state import BeaconState
from ..crypto import bls
from ..specs.chain_spec import ForkName
from ..specs.constants import (
    BLS_WITHDRAWAL_PREFIX, COMPOUNDING_WITHDRAWAL_PREFIX,
    DEPOSIT_CONTRACT_TREE_DEPTH, ETH1_ADDRESS_WITHDRAWAL_PREFIX,
    FAR_FUTURE_EPOCH, FULL_EXIT_REQUEST_AMOUNT, GENESIS_SLOT,
    PARTICIPATION_FLAG_WEIGHTS, PROPOSER_WEIGHT, SYNC_REWARD_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX, TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX, UNSET_DEPOSIT_REQUESTS_START_INDEX,
    WEIGHT_DENOMINATOR,
)
from ..ssz import htr
from ..ssz.merkle_proof import verify_merkle_proof
from .helpers import (
    StateError, compute_activation_exit_epoch, compute_epoch_at_slot,
    compute_exit_epoch_and_update_churn,
    compute_consolidation_epoch_and_update_churn,
    decrease_balance, get_attesting_indices, get_balance_churn_limit,
    get_base_reward_altair, get_base_reward_per_increment,
    get_beacon_committee, get_beacon_proposer_index, get_committee_count_per_slot,
    get_indexed_attestation, get_pending_balance_to_withdraw,
    get_total_active_balance, has_compounding_withdrawal_credential,
    has_eth1_withdrawal_credential, has_execution_withdrawal_credential,
    has_flag, add_flag, increase_balance, indexed_attestation_is_structurally_valid,
    initiate_validator_exit, integer_squareroot, is_slashable_attestation_data,
    is_slashable_validator, slash_validator,
)
from .signature_sets import (
    BlockSignatureVerifier, block_proposal_signature_set,
    bls_to_execution_change_signature_set, deposit_signature_set,
    indexed_attestation_signature_set, proposer_slashing_signature_sets,
    randao_signature_set, sync_aggregate_signature_set,
    voluntary_exit_signature_set,
)


class BlockProcessingError(StateError):
    pass


class VerifySignatures(enum.Enum):
    TRUE = "true"        # verify inline (one batch at the end)
    FALSE = "false"      # skip (already verified upstream)


def err(cond: bool, msg: str) -> None:
    if not cond:
        raise BlockProcessingError(msg)


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def per_block_processing(state: BeaconState, signed_block,
                         verify_signatures: VerifySignatures = VerifySignatures.TRUE,
                         block_root: bytes | None = None,
                         payload_verifier=None,
                         verify_block_root: bool = True) -> None:
    """Apply `signed_block` to `state` (state.slot must equal block.slot).

    Signatures: when TRUE, all block signatures (incl. proposal) are collected
    and verified in one batched call, per the reference design.
    """
    block = signed_block.message
    err(block.slot == state.slot, "block slot mismatch")
    fork = state.fork_name

    verifier = None
    if verify_signatures == VerifySignatures.TRUE:
        verifier = BlockSignatureVerifier(state)
        verifier.include_entire_block(signed_block, block_root)

    process_block_header(state, block)
    if fork >= ForkName.BELLATRIX and is_execution_enabled(state, block.body):
        if fork >= ForkName.CAPELLA:
            process_withdrawals(state, block.body.execution_payload)
        process_execution_payload(state, block.body, payload_verifier)
    process_randao(state, block.body, VerifySignatures.FALSE
                   if verifier else verify_signatures)
    process_eth1_data(state, block.body.eth1_data)
    process_operations(state, block.body, VerifySignatures.FALSE
                       if verifier else verify_signatures)
    if fork >= ForkName.ALTAIR:
        process_sync_aggregate(state, block.body.sync_aggregate, block.slot,
                               VerifySignatures.FALSE
                               if verifier else verify_signatures)

    if verifier is not None:
        err(verifier.verify(), "block signature batch invalid")


# ---------------------------------------------------------------------------
# Header / randao / eth1
# ---------------------------------------------------------------------------

def process_block_header(state: BeaconState, block) -> None:
    T = state.T
    err(block.slot == state.slot, "header slot mismatch")
    err(block.slot > state.latest_block_header.slot,
        "block not newer than latest header")
    err(block.proposer_index == get_beacon_proposer_index(state),
        "incorrect proposer")
    err(block.parent_root == htr(state.latest_block_header),
        "parent root mismatch")
    state.latest_block_header = T.BeaconBlockHeader(
        slot=block.slot, proposer_index=block.proposer_index,
        parent_root=block.parent_root, state_root=b"\x00" * 32,
        body_root=htr(block.body))
    err(not state.validators.slashed[block.proposer_index],
        "proposer slashed")


def process_randao(state: BeaconState, body,
                   verify_signatures: VerifySignatures) -> None:
    epoch = state.current_epoch()
    if verify_signatures == VerifySignatures.TRUE:
        s = randao_signature_set(state, get_beacon_proposer_index(state),
                                 body.randao_reveal)
        err(bls.verify_signature_sets([s]), "randao signature invalid")
    mix = bytes(a ^ b for a, b in zip(
        state.get_randao_mix(epoch),
        hashlib.sha256(body.randao_reveal).digest()))
    state.set_randao_mix(epoch, mix)


def process_eth1_data(state: BeaconState, eth1_data) -> None:
    state.eth1_data_votes.append(eth1_data)
    period_slots = state.T.eth1_votes_limit
    count = sum(1 for v in state.eth1_data_votes if v == eth1_data)
    if count * 2 > period_slots:
        state.eth1_data = eth1_data


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------

def expected_deposit_count(state: BeaconState) -> int:
    p = state.T.preset
    if state.fork_name >= ForkName.ELECTRA:
        limit = min(state.eth1_data.deposit_count,
                    state.deposit_requests_start_index)
        if state.eth1_deposit_index < limit:
            return min(p.max_deposits, limit - state.eth1_deposit_index)
        return 0
    return min(p.max_deposits,
               state.eth1_data.deposit_count - state.eth1_deposit_index)


def process_operations(state: BeaconState, body,
                       verify_signatures: VerifySignatures) -> None:
    err(len(body.deposits) == expected_deposit_count(state),
        "incorrect deposit count")
    for ps in body.proposer_slashings:
        process_proposer_slashing(state, ps, verify_signatures)
    for asl in body.attester_slashings:
        process_attester_slashing(state, asl, verify_signatures)
    for att in body.attestations:
        process_attestation(state, att, verify_signatures)
    for dep in body.deposits:
        process_deposit(state, dep)
    for ex in body.voluntary_exits:
        process_voluntary_exit(state, ex, verify_signatures)
    if state.fork_name >= ForkName.CAPELLA:
        for ch in body.bls_to_execution_changes:
            process_bls_to_execution_change(state, ch, verify_signatures)
    if state.fork_name >= ForkName.ELECTRA:
        reqs = body.execution_requests
        for dr in reqs.deposits:
            process_deposit_request(state, dr)
        for wr in reqs.withdrawals:
            process_withdrawal_request(state, wr)
        for cr in reqs.consolidations:
            process_consolidation_request(state, cr)


def process_proposer_slashing(state: BeaconState, slashing,
                              verify_signatures: VerifySignatures) -> None:
    h1 = slashing.signed_header_1.message
    h2 = slashing.signed_header_2.message
    err(h1.slot == h2.slot, "proposer slashing: slots differ")
    err(h1.proposer_index == h2.proposer_index,
        "proposer slashing: proposers differ")
    err(htr(h1) != htr(h2), "proposer slashing: identical headers")
    err(h1.proposer_index < len(state.validators),
        "proposer slashing: unknown validator")
    err(is_slashable_validator(state, h1.proposer_index,
                               state.current_epoch()),
        "proposer slashing: not slashable")
    if verify_signatures == VerifySignatures.TRUE:
        sets = proposer_slashing_signature_sets(state, slashing)
        err(bls.verify_signature_sets(sets),
            "proposer slashing: bad signature")
    slash_validator(state, h1.proposer_index)


def process_attester_slashing(state: BeaconState, slashing,
                              verify_signatures: VerifySignatures) -> None:
    a1, a2 = slashing.attestation_1, slashing.attestation_2
    err(is_slashable_attestation_data(a1.data, a2.data),
        "attester slashing: data not slashable")
    for a in (a1, a2):
        err(indexed_attestation_is_structurally_valid(a),
            "attester slashing: malformed indexed attestation")
        err(all(i < len(state.validators) for i in a.attesting_indices),
            "attester slashing: unknown validator")
        if verify_signatures == VerifySignatures.TRUE:
            err(bls.verify_signature_sets(
                [indexed_attestation_signature_set(state, a)]),
                "attester slashing: bad signature")
    slashed_any = False
    common = sorted(set(a1.attesting_indices) & set(a2.attesting_indices))
    for index in common:
        if is_slashable_validator(state, index, state.current_epoch()):
            slash_validator(state, index)
            slashed_any = True
    err(slashed_any, "attester slashing: no one slashed")


def get_attestation_participation_flag_indices(state: BeaconState, data,
                                               inclusion_delay: int
                                               ) -> list[int]:
    p = state.T.preset
    if data.target.epoch == state.current_epoch():
        justified = state.current_justified_checkpoint
    else:
        justified = state.previous_justified_checkpoint
    is_matching_source = (data.source == justified)
    err(is_matching_source, "attestation: source checkpoint mismatch")
    is_matching_target = is_matching_source and \
        data.target.root == state.get_block_root(data.target.epoch)
    is_matching_head = is_matching_target and \
        data.beacon_block_root == state.get_block_root_at_slot(data.slot)
    flags = []
    if state.fork_name >= ForkName.DENEB:
        # EIP-7045: target flag has no inclusion-delay cap
        if is_matching_source and inclusion_delay <= integer_squareroot(
                p.slots_per_epoch):
            flags.append(TIMELY_SOURCE_FLAG_INDEX)
        if is_matching_target:
            flags.append(TIMELY_TARGET_FLAG_INDEX)
    else:
        if is_matching_source and inclusion_delay <= integer_squareroot(
                p.slots_per_epoch):
            flags.append(TIMELY_SOURCE_FLAG_INDEX)
        if is_matching_target and inclusion_delay <= p.slots_per_epoch:
            flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == p.min_attestation_inclusion_delay:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def process_attestation(state: BeaconState, attestation,
                        verify_signatures: VerifySignatures) -> None:
    p = state.T.preset
    data = attestation.data
    err(data.target.epoch in (state.previous_epoch(), state.current_epoch()),
        "attestation: target epoch out of range")
    err(data.target.epoch == compute_epoch_at_slot(data.slot,
                                                   p.slots_per_epoch),
        "attestation: slot/target mismatch")
    err(data.slot + p.min_attestation_inclusion_delay <= state.slot,
        "attestation: too recent")
    if state.fork_name < ForkName.DENEB:
        err(state.slot <= data.slot + p.slots_per_epoch,
            "attestation: too old")

    if state.fork_name >= ForkName.ELECTRA:
        err(data.index == 0, "attestation: nonzero committee index (electra)")
        committee_count = get_committee_count_per_slot(state,
                                                       data.target.epoch)
        total_len = 0
        bits = attestation.aggregation_bits
        for idx, present in enumerate(attestation.committee_bits):
            if present:
                err(idx < committee_count,
                    "attestation: committee bit out of range")
                clen = len(get_beacon_committee(state, data.slot, idx))
                err(any(bits[total_len + i] for i in range(clen)
                        if total_len + i < len(bits)),
                    "attestation: committee with no attesters")
                total_len += clen
        err(len(bits) == total_len,
            "attestation: aggregation bits length mismatch")
    else:
        err(data.index < get_committee_count_per_slot(state,
                                                      data.target.epoch),
            "attestation: committee index out of range")

    indexed = get_indexed_attestation(state, attestation)
    err(indexed_attestation_is_structurally_valid(indexed),
        "attestation: empty or unsorted indices")
    if verify_signatures == VerifySignatures.TRUE:
        err(bls.verify_signature_sets(
            [indexed_attestation_signature_set(state, indexed)]),
            "attestation: bad signature")

    if state.fork_name == ForkName.PHASE0:
        # FFG source must match the justified checkpoint for the target epoch
        if data.target.epoch == state.current_epoch():
            err(data.source == state.current_justified_checkpoint,
                "attestation: source != current justified checkpoint")
        else:
            err(data.source == state.previous_justified_checkpoint,
                "attestation: source != previous justified checkpoint")
        T = state.T
        pending = T.PendingAttestation(
            aggregation_bits=list(attestation.aggregation_bits),
            data=data,
            inclusion_delay=state.slot - data.slot,
            proposer_index=get_beacon_proposer_index(state))
        if data.target.epoch == state.current_epoch():
            state.current_epoch_attestations.append(pending)
        else:
            state.previous_epoch_attestations.append(pending)
        return

    # altair+: participation flags + proposer reward
    inclusion_delay = state.slot - data.slot
    flag_indices = get_attestation_participation_flag_indices(
        state, data, inclusion_delay)
    if data.target.epoch == state.current_epoch():
        participation = state.current_epoch_participation
    else:
        participation = state.previous_epoch_participation
    # Masked column ops over the SoA participation array: the scalar spec
    # walks each attesting index and each flag; here one gather + one
    # boolean mask per flag covers the whole committee.  Rewards stay
    # exact: base_reward(i) = (eff[i] // increment) * base_per_increment,
    # summed over indices whose flag was newly set, per flag weight.
    total_active = get_total_active_balance(state)
    idx = np.asarray(indexed.attesting_indices, dtype=np.int64)
    before = participation[idx].astype(np.int64)
    base_rewards = (
        state.validators.effective_balance[idx].astype(np.int64)
        // p.effective_balance_increment) \
        * get_base_reward_per_increment(state, total_active)
    proposer_reward_numerator = 0
    after = before
    for fi in flag_indices:
        newly = (after & (1 << fi)) == 0
        proposer_reward_numerator += int(base_rewards[newly].sum()) \
            * PARTICIPATION_FLAG_WEIGHTS[fi]
        after = after | (1 << fi)
    changed = after != before
    if changed.any():
        touched = idx[changed]
        participation[touched] = after[changed].astype(participation.dtype)
        state.mark_participation_dirty(
            touched, participation is state.current_epoch_participation)
    denom = (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT) * WEIGHT_DENOMINATOR \
        // PROPOSER_WEIGHT
    increase_balance(state, get_beacon_proposer_index(state),
                     proposer_reward_numerator // denom)


# -- deposits ----------------------------------------------------------------

def get_validator_from_deposit(state: BeaconState, pubkey: bytes,
                               withdrawal_credentials: bytes,
                               amount: int):
    p = state.T.preset
    if state.fork_name >= ForkName.ELECTRA:
        max_eb = (p.max_effective_balance_electra
                  if has_compounding_withdrawal_credential(
                      withdrawal_credentials) else p.min_activation_balance)
    else:
        max_eb = p.max_effective_balance
    eff = min(amount - amount % p.effective_balance_increment, max_eb)
    return dict(pubkey=pubkey, withdrawal_credentials=withdrawal_credentials,
                effective_balance=eff, slashed=False,
                activation_eligibility_epoch=FAR_FUTURE_EPOCH,
                activation_epoch=FAR_FUTURE_EPOCH,
                exit_epoch=FAR_FUTURE_EPOCH,
                withdrawable_epoch=FAR_FUTURE_EPOCH)


def apply_deposit(state: BeaconState, pubkey: bytes,
                  withdrawal_credentials: bytes, amount: int,
                  signature: bytes) -> None:
    T = state.T
    index = state.validators.index_of(pubkey)
    if state.fork_name >= ForkName.ELECTRA:
        if index is None:
            if not _deposit_signature_is_valid(state, pubkey,
                                               withdrawal_credentials,
                                               amount, signature):
                return
            v = get_validator_from_deposit(state, pubkey,
                                           withdrawal_credentials, 0)
            v["effective_balance"] = 0
            state.validators.append(**v)
            state.balances = np.append(state.balances, np.uint64(0))
            state.previous_epoch_participation = np.append(
                state.previous_epoch_participation, np.uint8(0))
            state.current_epoch_participation = np.append(
                state.current_epoch_participation, np.uint8(0))
            state.inactivity_scores = np.append(
                state.inactivity_scores, np.uint64(0))
        state.pending_deposits.append(T.PendingDeposit(
            pubkey=pubkey, withdrawal_credentials=withdrawal_credentials,
            amount=amount, signature=signature,
            slot=GENESIS_SLOT))
        return
    if index is None:
        if not _deposit_signature_is_valid(state, pubkey,
                                           withdrawal_credentials, amount,
                                           signature):
            return
        v = get_validator_from_deposit(state, pubkey, withdrawal_credentials,
                                       amount)
        state.validators.append(**v)
        state.balances = np.append(state.balances, np.uint64(amount))
        if state.fork_name >= ForkName.ALTAIR:
            state.previous_epoch_participation = np.append(
                state.previous_epoch_participation, np.uint8(0))
            state.current_epoch_participation = np.append(
                state.current_epoch_participation, np.uint8(0))
            state.inactivity_scores = np.append(
                state.inactivity_scores, np.uint64(0))
    else:
        increase_balance(state, index, amount)


def _deposit_signature_is_valid(state: BeaconState, pubkey, wc, amount,
                                signature) -> bool:
    T = state.T
    dd = T.DepositData(pubkey=pubkey, withdrawal_credentials=wc,
                       amount=amount, signature=signature)
    s = deposit_signature_set(dd, state.spec.genesis_fork_version, T)
    return bls.verify(s.pubkeys[0], s.message, s.signature)


def process_deposit(state: BeaconState, deposit) -> None:
    root = state.eth1_data.deposit_root
    leaf = htr(deposit.data)
    err(verify_merkle_proof(leaf, list(deposit.proof),
                            DEPOSIT_CONTRACT_TREE_DEPTH + 1,
                            state.eth1_deposit_index, root),
        "deposit: bad merkle proof")
    state.eth1_deposit_index += 1
    apply_deposit(state, deposit.data.pubkey,
                  deposit.data.withdrawal_credentials, deposit.data.amount,
                  deposit.data.signature)


# -- exits -------------------------------------------------------------------

def process_voluntary_exit(state: BeaconState, signed_exit,
                           verify_signatures: VerifySignatures) -> None:
    exit_ = signed_exit.message
    err(exit_.validator_index < len(state.validators),
        "exit: unknown validator")
    v = state.validators.view(exit_.validator_index)
    epoch = state.current_epoch()
    err(v.activation_epoch <= epoch < v.exit_epoch or
        (v.activation_epoch <= epoch and v.exit_epoch == FAR_FUTURE_EPOCH),
        "exit: not active")
    err(v.exit_epoch == FAR_FUTURE_EPOCH, "exit: already exiting")
    err(epoch >= exit_.epoch, "exit: not yet valid")
    err(epoch >= v.activation_epoch + state.spec.shard_committee_period,
        "exit: too young")
    if state.fork_name >= ForkName.ELECTRA:
        err(get_pending_balance_to_withdraw(
            state, exit_.validator_index) == 0,
            "exit: pending partial withdrawals outstanding")
    if verify_signatures == VerifySignatures.TRUE:
        err(bls.verify_signature_sets(
            [voluntary_exit_signature_set(state, signed_exit)]),
            "exit: bad signature")
    initiate_validator_exit(state, exit_.validator_index)


def process_bls_to_execution_change(state: BeaconState, signed_change,
                                    verify_signatures: VerifySignatures
                                    ) -> None:
    change = signed_change.message
    err(change.validator_index < len(state.validators),
        "bls change: unknown validator")
    wc = state.validators.view(change.validator_index).withdrawal_credentials
    err(wc[0] == BLS_WITHDRAWAL_PREFIX, "bls change: not a BLS credential")
    err(wc[1:] == hashlib.sha256(change.from_bls_pubkey).digest()[1:],
        "bls change: pubkey hash mismatch")
    if verify_signatures == VerifySignatures.TRUE:
        err(bls.verify_signature_sets(
            [bls_to_execution_change_signature_set(state, signed_change)]),
            "bls change: bad signature")
    new_wc = bytes([ETH1_ADDRESS_WITHDRAWAL_PREFIX]) + b"\x00" * 11 \
        + change.to_execution_address
    state.validators.set_field(change.validator_index,
                               "withdrawal_credentials", new_wc)


# -- electra execution requests ---------------------------------------------

def process_deposit_request(state: BeaconState, request) -> None:
    T = state.T
    if state.deposit_requests_start_index == \
            UNSET_DEPOSIT_REQUESTS_START_INDEX:
        state.deposit_requests_start_index = request.index
    state.pending_deposits.append(T.PendingDeposit(
        pubkey=request.pubkey,
        withdrawal_credentials=request.withdrawal_credentials,
        amount=request.amount, signature=request.signature,
        slot=state.slot))


def process_withdrawal_request(state: BeaconState, request) -> None:
    p = state.T.preset
    amount = request.amount
    is_full_exit = amount == FULL_EXIT_REQUEST_AMOUNT
    index = state.validators.index_of(request.validator_pubkey)
    if index is None:
        return
    v = state.validators.view(index)
    # source address must match the execution credential
    if not has_execution_withdrawal_credential(v.withdrawal_credentials):
        return
    if v.withdrawal_credentials[12:] != request.source_address:
        return
    epoch = state.current_epoch()
    if not (v.activation_epoch <= epoch < v.exit_epoch):
        return
    if epoch < v.activation_epoch + state.spec.shard_committee_period:
        return
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    pending = get_pending_balance_to_withdraw(state, index)
    if is_full_exit:
        if pending == 0:
            initiate_validator_exit(state, index)
        return
    if len(state.pending_partial_withdrawals) >= \
            p.pending_partial_withdrawals_limit:
        return
    has_sufficient = (
        has_compounding_withdrawal_credential(v.withdrawal_credentials)
        and v.effective_balance >= p.min_activation_balance
        and int(state.balances[index]) - pending > p.min_activation_balance)
    if not has_sufficient:
        return
    to_withdraw = min(
        int(state.balances[index]) - p.min_activation_balance - pending,
        amount)
    exit_epoch = compute_exit_epoch_and_update_churn(state, to_withdraw)
    withdrawable = exit_epoch + state.spec.min_validator_withdrawability_delay
    state.pending_partial_withdrawals.append(
        state.T.PendingPartialWithdrawal(
            validator_index=index, amount=to_withdraw,
            withdrawable_epoch=withdrawable))


def process_consolidation_request(state: BeaconState, request) -> None:
    p = state.T.preset
    if _is_valid_switch_to_compounding(state, request):
        idx = state.validators.index_of(request.source_pubkey)
        _switch_to_compounding_validator(state, idx)
        return
    # spec: no capacity when the consolidation churn can't fit one validator
    from .helpers import get_consolidation_churn_limit
    if get_consolidation_churn_limit(state) <= p.min_activation_balance:
        return
    if len(state.pending_consolidations) >= p.pending_consolidations_limit:
        return
    src = state.validators.index_of(request.source_pubkey)
    tgt = state.validators.index_of(request.target_pubkey)
    if src is None or tgt is None or src == tgt:
        return
    sv = state.validators.view(src)
    tv = state.validators.view(tgt)
    if not has_execution_withdrawal_credential(sv.withdrawal_credentials):
        return
    if not has_compounding_withdrawal_credential(tv.withdrawal_credentials):
        return
    if sv.withdrawal_credentials[12:] != request.source_address:
        return
    epoch = state.current_epoch()
    if not (sv.activation_epoch <= epoch < sv.exit_epoch):
        return
    if not (tv.activation_epoch <= epoch < tv.exit_epoch):
        return
    if sv.exit_epoch != FAR_FUTURE_EPOCH or tv.exit_epoch != FAR_FUTURE_EPOCH:
        return
    if epoch < sv.activation_epoch + state.spec.shard_committee_period:
        return
    if get_pending_balance_to_withdraw(state, src) > 0:
        return
    exit_epoch = compute_consolidation_epoch_and_update_churn(
        state, sv.effective_balance)
    state.validators.set_field(src, "exit_epoch", exit_epoch)
    state.validators.set_field(
        src, "withdrawable_epoch",
        exit_epoch + state.spec.min_validator_withdrawability_delay)
    state.pending_consolidations.append(
        state.T.PendingConsolidation(source_index=src, target_index=tgt))


def _is_valid_switch_to_compounding(state: BeaconState, request) -> bool:
    if request.source_pubkey != request.target_pubkey:
        return False
    idx = state.validators.index_of(request.source_pubkey)
    if idx is None:
        return False
    v = state.validators.view(idx)
    if not has_eth1_withdrawal_credential(v.withdrawal_credentials):
        return False
    if v.withdrawal_credentials[12:] != request.source_address:
        return False
    epoch = state.current_epoch()
    if not (v.activation_epoch <= epoch < v.exit_epoch):
        return False
    return v.exit_epoch == FAR_FUTURE_EPOCH


def _switch_to_compounding_validator(state: BeaconState, index: int) -> None:
    v = state.validators.view(index)
    wc = bytes([COMPOUNDING_WITHDRAWAL_PREFIX]) + v.withdrawal_credentials[1:]
    state.validators.set_field(index, "withdrawal_credentials", wc)
    _queue_excess_active_balance(state, index)


def _queue_excess_active_balance(state: BeaconState, index: int) -> None:
    p = state.T.preset
    balance = int(state.balances[index])
    if balance > p.min_activation_balance:
        excess = balance - p.min_activation_balance
        state.balances[index] = p.min_activation_balance
        state.mark_balances_dirty(index)
        v = state.validators.view(index)
        state.pending_deposits.append(state.T.PendingDeposit(
            pubkey=v.pubkey, withdrawal_credentials=v.withdrawal_credentials,
            amount=excess, signature=bls.INFINITY_SIGNATURE,
            slot=GENESIS_SLOT))


# ---------------------------------------------------------------------------
# Sync aggregate (altair+)
# ---------------------------------------------------------------------------

def process_sync_aggregate(state: BeaconState, sync_aggregate, block_slot: int,
                           verify_signatures: VerifySignatures) -> None:
    p = state.T.preset
    if verify_signatures == VerifySignatures.TRUE:
        s = sync_aggregate_signature_set(state, sync_aggregate, block_slot)
        if s is not None:
            err(bls.verify_signature_sets([s]),
                "sync aggregate: bad signature")
    total_active = get_total_active_balance(state)
    total_increments = total_active // p.effective_balance_increment
    base_per_inc = get_base_reward_per_increment(state, total_active)
    total_base_rewards = base_per_inc * total_increments
    max_participant_rewards = (total_base_rewards * SYNC_REWARD_WEIGHT
                               // WEIGHT_DENOMINATOR // p.slots_per_epoch)
    participant_reward = max_participant_rewards // p.sync_committee_size
    proposer_reward = (participant_reward * PROPOSER_WEIGHT
                       // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT))
    proposer_index = get_beacon_proposer_index(state)
    committee = state.current_sync_committee
    for pk, bit in zip(committee.pubkeys,
                       sync_aggregate.sync_committee_bits):
        index = state.validators.index_of(pk)
        err(index is not None, "sync aggregate: unknown committee pubkey")
        if bit:
            increase_balance(state, index, participant_reward)
            increase_balance(state, proposer_index, proposer_reward)
        else:
            decrease_balance(state, index, participant_reward)


# ---------------------------------------------------------------------------
# Execution payload + withdrawals
# ---------------------------------------------------------------------------

def is_merge_transition_complete(state: BeaconState) -> bool:
    if state.fork_name < ForkName.BELLATRIX:
        return False
    h = state.latest_execution_payload_header
    default = type(h)()
    return htr(h) != htr(default)


def is_execution_enabled(state: BeaconState, body) -> bool:
    if state.fork_name < ForkName.BELLATRIX:
        return False
    if is_merge_transition_complete(state):
        return True
    default = type(body.execution_payload)()
    return htr(body.execution_payload) != htr(default)


def compute_timestamp_at_slot(state: BeaconState, slot: int) -> int:
    return state.genesis_time + slot * state.spec.seconds_per_slot


def process_execution_payload(state: BeaconState, body,
                              payload_verifier=None) -> None:
    from ..ssz import List as SSZList, ByteList, hash_tree_root
    p = state.T.preset
    payload = body.execution_payload
    if is_merge_transition_complete(state):
        err(payload.parent_hash ==
            state.latest_execution_payload_header.block_hash,
            "payload: parent hash mismatch")
    err(payload.prev_randao == state.get_randao_mix(state.current_epoch()),
        "payload: prev_randao mismatch")
    err(payload.timestamp == compute_timestamp_at_slot(state, state.slot),
        "payload: bad timestamp")
    if state.fork_name >= ForkName.DENEB:
        err(len(body.blob_kzg_commitments) <= p.max_blobs_per_block,
            "payload: too many blob commitments")
    if payload_verifier is not None:
        err(payload_verifier(state, payload), "payload: execution invalid")

    header_cls = state.T.ExecutionPayloadHeader[
        max(state.fork_name, ForkName.BELLATRIX)]
    kw = dict(
        parent_hash=payload.parent_hash, fee_recipient=payload.fee_recipient,
        state_root=payload.state_root, receipts_root=payload.receipts_root,
        logs_bloom=payload.logs_bloom, prev_randao=payload.prev_randao,
        block_number=payload.block_number, gas_limit=payload.gas_limit,
        gas_used=payload.gas_used, timestamp=payload.timestamp,
        extra_data=payload.extra_data,
        base_fee_per_gas=payload.base_fee_per_gas,
        block_hash=payload.block_hash,
        transactions_root=hash_tree_root(
            SSZList(ByteList(p.max_bytes_per_transaction),
                    p.max_transactions_per_payload), payload.transactions))
    if state.fork_name >= ForkName.CAPELLA:
        kw["withdrawals_root"] = hash_tree_root(
            SSZList(state.T.Withdrawal.ssz_type,
                    p.max_withdrawals_per_payload), payload.withdrawals)
    if state.fork_name >= ForkName.DENEB:
        kw["blob_gas_used"] = payload.blob_gas_used
        kw["excess_blob_gas"] = payload.excess_blob_gas
    state.latest_execution_payload_header = header_cls(**kw)


def get_expected_withdrawals(state: BeaconState):
    """Returns (withdrawals, processed_partial_count)."""
    p = state.T.preset
    T = state.T
    epoch = state.current_epoch()
    withdrawal_index = state.next_withdrawal_index
    validator_index = state.next_withdrawal_validator_index
    withdrawals = []
    processed_partials = 0
    if state.fork_name >= ForkName.ELECTRA:
        for w in state.pending_partial_withdrawals:
            if w.withdrawable_epoch > epoch or \
                    len(withdrawals) == p.max_pending_partials_per_withdrawals_sweep:
                break
            v = state.validators.view(w.validator_index)
            has_excess = int(state.balances[w.validator_index]) > \
                p.min_activation_balance
            if (v.exit_epoch == FAR_FUTURE_EPOCH
                    and v.effective_balance >= p.min_activation_balance
                    and has_excess):
                withdrawable = min(
                    int(state.balances[w.validator_index])
                    - p.min_activation_balance, w.amount)
                withdrawals.append(T.Withdrawal(
                    index=withdrawal_index,
                    validator_index=w.validator_index,
                    address=v.withdrawal_credentials[12:],
                    amount=withdrawable))
                withdrawal_index += 1
            processed_partials += 1
    # Bounded vectorized sweep: evaluate the full/partial predicates for
    # the whole window with column ops, then materialize only the (rare)
    # candidates in sweep order.  Window positions are distinct validators
    # (bound <= n), so a swept validator never re-sees its own appended
    # withdrawal; only the pending-partial stage above affects `balance`.
    n = len(state.validators)
    bound = min(n, p.max_validators_per_withdrawals_sweep)
    v = state.validators
    electra = state.fork_name >= ForkName.ELECTRA
    sweep = (validator_index + np.arange(bound, dtype=np.int64)) % n
    prefix = v.withdrawal_credentials[sweep, 0]
    balance = state.balances[sweep].astype(np.int64)
    if electra:
        partial_sums: dict[int, int] = {}
        for w in withdrawals:
            partial_sums[w.validator_index] = \
                partial_sums.get(w.validator_index, 0) + w.amount
        for vi, amount in partial_sums.items():
            pos = (vi - validator_index) % n
            if pos < bound:
                balance[pos] -= amount
        compounding = prefix == COMPOUNDING_WITHDRAWAL_PREFIX
        max_eb_arr = np.where(compounding, p.max_effective_balance_electra,
                              p.min_activation_balance).astype(np.int64)
        fully_creds = (prefix == ETH1_ADDRESS_WITHDRAWAL_PREFIX) | compounding
    else:
        max_eb_arr = np.full(bound, p.max_effective_balance, np.int64)
        fully_creds = prefix == ETH1_ADDRESS_WITHDRAWAL_PREFIX
    full_w = fully_creds \
        & (v.withdrawable_epoch[sweep] <= np.uint64(epoch)) & (balance > 0)
    part_w = fully_creds & (v.effective_balance[sweep].astype(np.int64)
                            == max_eb_arr) & (balance > max_eb_arr)
    for pos in np.flatnonzero(full_w | part_w):
        vi = int(sweep[pos])
        wc = v.withdrawal_credentials[vi].tobytes()
        amount = int(balance[pos]) if full_w[pos] \
            else int(balance[pos] - max_eb_arr[pos])
        withdrawals.append(T.Withdrawal(
            index=withdrawal_index, validator_index=vi,
            address=wc[12:], amount=amount))
        withdrawal_index += 1
        if len(withdrawals) == p.max_withdrawals_per_payload:
            break
    return withdrawals, processed_partials


def process_withdrawals(state: BeaconState, payload) -> None:
    p = state.T.preset
    expected, processed_partials = get_expected_withdrawals(state)
    got = list(payload.withdrawals)
    err(len(got) == len(expected), "withdrawals: count mismatch")
    for g, e in zip(got, expected):
        err(g == e, "withdrawals: mismatch")
    for w in expected:
        decrease_balance(state, w.validator_index, w.amount)
    if state.fork_name >= ForkName.ELECTRA and processed_partials:
        state.pending_partial_withdrawals = \
            state.pending_partial_withdrawals[processed_partials:]
    if expected:
        state.next_withdrawal_index = expected[-1].index + 1
    n = len(state.validators)
    if len(expected) == p.max_withdrawals_per_payload:
        state.next_withdrawal_validator_index = \
            (expected[-1].validator_index + 1) % n
    else:
        state.next_withdrawal_validator_index = \
            (state.next_withdrawal_validator_index
             + p.max_validators_per_withdrawals_sweep) % n
