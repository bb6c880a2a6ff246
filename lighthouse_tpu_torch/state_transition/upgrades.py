"""In-place fork upgrades (per_slot_processing.rs:50-60 equivalents)."""
from __future__ import annotations

import numpy as np

from ..containers.state import BeaconState
from ..crypto.bls import INFINITY_SIGNATURE
from ..specs.chain_spec import ForkName
from ..specs.constants import (
    FAR_FUTURE_EPOCH, GENESIS_SLOT, UNSET_DEPOSIT_REQUESTS_START_INDEX,
)
from .helpers import (
    compute_activation_exit_epoch, get_attesting_indices,
    get_next_sync_committee, has_compounding_withdrawal_credential,
)


def _bump_fork(state: BeaconState, fork: ForkName) -> None:
    T = state.T
    state.fork = T.Fork(previous_version=state.fork.current_version,
                        current_version=state.spec.fork_version(fork),
                        epoch=state.current_epoch())
    state.fork_name = fork
    state._init_fork_fields(fork)


def upgrade_to_altair(state: BeaconState) -> None:
    from .block import get_attestation_participation_flag_indices
    from .helpers import add_flag
    n = len(state.validators)
    pending = list(state.previous_epoch_attestations or [])
    _bump_fork(state, ForkName.ALTAIR)
    state.previous_epoch_participation = np.zeros(n, np.uint8)
    state.current_epoch_participation = np.zeros(n, np.uint8)
    state.inactivity_scores = np.zeros(n, np.uint64)
    # translate_participation: replay previous-epoch pending attestations
    touched = []
    for att in pending:
        try:
            flags = get_attestation_participation_flag_indices(
                state, att.data, att.inclusion_delay)
        except Exception:
            continue
        for i in get_attesting_indices(state, att):
            cur = int(state.previous_epoch_participation[i])
            for fi in flags:
                cur = add_flag(cur, fi)
            state.previous_epoch_participation[i] = cur
            touched.append(i)
    if touched:
        # in-place column writes must report dirty rows (state.py
        # _column_root invariant)
        state.mark_participation_dirty(touched, current=False)
    committee = get_next_sync_committee(state)
    state.current_sync_committee = committee
    state.next_sync_committee = get_next_sync_committee(state)


def upgrade_to_bellatrix(state: BeaconState) -> None:
    _bump_fork(state, ForkName.BELLATRIX)
    state.latest_execution_payload_header = \
        state.T.ExecutionPayloadHeader[ForkName.BELLATRIX]()


def upgrade_to_capella(state: BeaconState) -> None:
    old = state.latest_execution_payload_header
    _bump_fork(state, ForkName.CAPELLA)
    cls = state.T.ExecutionPayloadHeader[ForkName.CAPELLA]
    kw = {f: getattr(old, f) for f, _ in type(old).__ssz_fields__.items()}
    state.latest_execution_payload_header = cls(**kw, withdrawals_root=b"\x00" * 32)
    state.next_withdrawal_index = 0
    state.next_withdrawal_validator_index = 0
    state.historical_summaries = []


def upgrade_to_deneb(state: BeaconState) -> None:
    old = state.latest_execution_payload_header
    _bump_fork(state, ForkName.DENEB)
    cls = state.T.ExecutionPayloadHeader[ForkName.DENEB]
    kw = {f: getattr(old, f) for f, _ in type(old).__ssz_fields__.items()}
    state.latest_execution_payload_header = cls(**kw, blob_gas_used=0,
                                                excess_blob_gas=0)


def upgrade_to_electra(state: BeaconState) -> None:
    _bump_fork(state, ForkName.ELECTRA)
    v = state.validators
    state.deposit_requests_start_index = UNSET_DEPOSIT_REQUESTS_START_INDEX
    state.deposit_balance_to_consume = 0
    state.exit_balance_to_consume = 0
    # spec: max(exit_epochs + [current_epoch]) + 1
    exit_epochs = v.exit_epoch[v.exit_epoch != np.uint64(FAR_FUTURE_EPOCH)]
    state.earliest_exit_epoch = max(
        [int(e) for e in exit_epochs] + [state.current_epoch()]) + 1
    state.consolidation_balance_to_consume = 0
    state.earliest_consolidation_epoch = compute_activation_exit_epoch(
        state.current_epoch(), state.T.preset.max_seed_lookahead)
    state.pending_deposits = []
    state.pending_partial_withdrawals = []
    state.pending_consolidations = []
    # re-queue not-yet-activated validators through the new deposit flow
    pre_activation = sorted(
        np.flatnonzero(v.activation_epoch == np.uint64(FAR_FUTURE_EPOCH)),
        key=lambda i: (int(v.activation_eligibility_epoch[i]), int(i)))
    for i in pre_activation:
        i = int(i)
        balance = int(state.balances[i])
        state.balances[i] = 0
        state.mark_balances_dirty(i)
        v.set_field(i, "effective_balance", 0)
        v.set_field(i, "activation_eligibility_epoch", FAR_FUTURE_EPOCH)
        view = v.view(i)
        state.pending_deposits.append(state.T.PendingDeposit(
            pubkey=view.pubkey,
            withdrawal_credentials=view.withdrawal_credentials,
            amount=balance, signature=INFINITY_SIGNATURE, slot=GENESIS_SLOT))
    # compounding validators queue their excess balance
    from .block import _queue_excess_active_balance
    for i in range(len(v)):
        if has_compounding_withdrawal_credential(
                v.withdrawal_credentials[i].tobytes()):
            _queue_excess_active_balance(state, i)
