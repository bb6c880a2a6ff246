"""Corpus generators of the capella + electra operations and electra
epoch-processing families.

Every post-state written here is verified at GENERATION time against the
independent scalar transcription in scalar_spec_electra.py — the same
de-circularization discipline as the altair families (gen_corpus_r3.py):
a fork-specific STF bug (withdrawal sweep, churn accounting, pending
queues) cannot be enshrined as an expected post-state because generation
fails when the vectorized implementation disagrees with the scalar spec.

Reference parity targets: process_operations.rs electra arms,
capella::process_withdrawals, per_epoch_processing/single_pass.rs.
"""
from __future__ import annotations

from . import scalar_spec_electra as sse
from .gen_corpus import _write_state, w_ssz, wcase

ETH = 10**9


# ---------------------------------------------------------------------------
# state builders
# ---------------------------------------------------------------------------

def _spec(last_fork: str, n_extra: dict | None = None):
    from ..specs.chain_spec import minimal_spec
    epochs = {"altair_fork_epoch": 0}
    if last_fork in ("bellatrix", "capella", "deneb", "electra"):
        epochs["bellatrix_fork_epoch"] = 0
    if last_fork in ("capella", "deneb", "electra"):
        epochs["capella_fork_epoch"] = 0
    if last_fork in ("deneb", "electra"):
        epochs["deneb_fork_epoch"] = 0
    if last_fork == "electra":
        epochs["electra_fork_epoch"] = 0
    epochs.update(n_extra or {})
    return minimal_spec(**epochs)


def _genesis(last_fork: str, n: int):
    from ..crypto import bls
    bls.set_backend("python")
    from ..state_transition.genesis import interop_genesis_state
    spec = _spec(last_fork)
    keys = [bls.keygen_interop(i) for i in range(n)]
    state = interop_genesis_state(spec, keys, genesis_time=0)
    return state, keys, spec


def _set_wc(state, idx: int, prefix: int, address: bytes | None = None):
    """Give validator `idx` an execution credential with `address`
    (default: 20 bytes derived from the index)."""
    address = address or bytes([0xAA, idx % 256] * 10)
    wc = bytes([prefix]) + b"\x00" * 11 + address
    state.validators.set_field(idx, "withdrawal_credentials", wc)
    return address


def _set_balance(state, idx: int, amount: int):
    state.balances[idx] = amount
    state.mark_balances_dirty(idx)


def _age(state, epoch: int):
    """Jump the clock so current_epoch() == epoch (operations/epoch
    vectors only need field consistency, not a replayed chain)."""
    state.slot = epoch * state.slots_per_epoch


def _age_last_slot(state, epoch: int):
    """Last slot of `epoch` — where epoch sub-transitions run."""
    state.slot = (epoch + 1) * state.slots_per_epoch - 1


def _deposit_sig(spec, sk: int, pubkey: bytes, wc: bytes, amount: int
                 ) -> bytes:
    from ..crypto import bls
    from ..specs.chain_spec import compute_domain, compute_signing_root
    from ..specs.constants import DOMAIN_DEPOSIT
    from ..containers import get_types
    from ..ssz import htr
    T = get_types(spec.preset)
    domain = compute_domain(DOMAIN_DEPOSIT, spec.genesis_fork_version,
                            b"\x00" * 32)
    msg = T.DepositMessage(pubkey=pubkey, withdrawal_credentials=wc,
                           amount=amount)
    return bls.sign(sk, compute_signing_root(htr(msg), domain))


# ---------------------------------------------------------------------------
# electra operations
# ---------------------------------------------------------------------------

def gen_electra_operations(root) -> int:
    from ..containers import get_types
    from ..ssz import serialize
    from ..state_transition import block as blk
    n = 0

    def case(handler, name):
        return wcase(root, "minimal", "electra", "operations", handler,
                     "pyspec_tests", name)

    # ---- deposit_request ------------------------------------------------
    state, keys, spec = _genesis("electra", 16)
    T = get_types(spec.preset)
    _age(state, 3)
    new_sk = 10**6 + 7
    from ..crypto import bls
    new_pk = bls.sk_to_pk(new_sk)
    new_wc = b"\x02" + b"\x00" * 11 + b"\xbb" * 20
    req = T.DepositRequest(
        pubkey=new_pk, withdrawal_credentials=new_wc, amount=32 * ETH,
        signature=_deposit_sig(spec, new_sk, new_pk, new_wc, 32 * ETH),
        index=77)
    d = case("deposit_request", "sets_start_index_and_queues")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "deposit_request.ssz_snappy",
          serialize(T.DepositRequest.ssz_type, req))
    post = state.copy()
    blk.process_deposit_request(post, req)
    sse.verify_deposit_request_op(state, req, post)
    _write_state(d, "post.ssz_snappy", post)
    n += 1

    # second request: start index already set
    req2 = T.DepositRequest(
        pubkey=bytes(state.validators.pubkeys[2]),
        withdrawal_credentials=b"\x01" + b"\x00" * 31, amount=1 * ETH,
        signature=b"\x00" * 96, index=78)
    d = case("deposit_request", "top_up_keeps_start_index")
    _write_state(d, "pre.ssz_snappy", post)
    w_ssz(d, "deposit_request.ssz_snappy",
          serialize(T.DepositRequest.ssz_type, req2))
    post2 = post.copy()
    blk.process_deposit_request(post2, req2)
    sse.verify_deposit_request_op(post, req2, post2)
    _write_state(d, "post.ssz_snappy", post2)
    n += 1

    # ---- withdrawal_request --------------------------------------------
    state, keys, spec = _genesis("electra", 16)
    T = get_types(spec.preset)
    _age(state, sse.SHARD_COMMITTEE_PERIOD + 3)
    addr5 = _set_wc(state, 5, sse.ETH1_PREFIX)
    addr6 = _set_wc(state, 6, sse.COMPOUNDING_PREFIX)
    _set_balance(state, 6, 40 * ETH)

    # full exit
    req = T.WithdrawalRequest(source_address=addr5,
                              validator_pubkey=bytes(
                                  state.validators.pubkeys[5]),
                              amount=sse.FULL_EXIT_REQUEST_AMOUNT)
    d = case("withdrawal_request", "full_exit_via_churn")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "withdrawal_request.ssz_snappy",
          serialize(T.WithdrawalRequest.ssz_type, req))
    post = state.copy()
    blk.process_withdrawal_request(post, req)
    sse.verify_withdrawal_request_op(state, req, post)
    assert int(post.validators.exit_epoch[5]) != sse.FAR_FUTURE
    _write_state(d, "post.ssz_snappy", post)
    n += 1

    # partial withdrawal (compounding, excess balance)
    req = T.WithdrawalRequest(source_address=addr6,
                              validator_pubkey=bytes(
                                  state.validators.pubkeys[6]),
                              amount=5 * ETH)
    d = case("withdrawal_request", "partial_withdrawal_queued")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "withdrawal_request.ssz_snappy",
          serialize(T.WithdrawalRequest.ssz_type, req))
    post = state.copy()
    blk.process_withdrawal_request(post, req)
    sse.verify_withdrawal_request_op(state, req, post)
    assert len(post.pending_partial_withdrawals) == 1
    _write_state(d, "post.ssz_snappy", post)
    n += 1

    # wrong source address: no-op (post == pre)
    req = T.WithdrawalRequest(source_address=b"\xde" * 20,
                              validator_pubkey=bytes(
                                  state.validators.pubkeys[5]),
                              amount=sse.FULL_EXIT_REQUEST_AMOUNT)
    d = case("withdrawal_request", "wrong_source_address_noop")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "withdrawal_request.ssz_snappy",
          serialize(T.WithdrawalRequest.ssz_type, req))
    post = state.copy()
    blk.process_withdrawal_request(post, req)
    sse.verify_withdrawal_request_op(state, req, post)
    _write_state(d, "post.ssz_snappy", post)
    n += 1

    # ---- consolidation_request -----------------------------------------
    # 192 validators: total 6144 ETH -> balance churn 192 ETH, activation
    # churn 128 ETH, consolidation churn 64 ETH > MIN_ACTIVATION
    state, keys, spec = _genesis("electra", 192)
    T = get_types(spec.preset)
    _age(state, sse.SHARD_COMMITTEE_PERIOD + 5)
    src_addr = _set_wc(state, 7, sse.ETH1_PREFIX)
    _set_wc(state, 9, sse.COMPOUNDING_PREFIX)
    req = T.ConsolidationRequest(
        source_address=src_addr,
        source_pubkey=bytes(state.validators.pubkeys[7]),
        target_pubkey=bytes(state.validators.pubkeys[9]))
    d = case("consolidation_request", "valid_consolidation")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "consolidation_request.ssz_snappy",
          serialize(T.ConsolidationRequest.ssz_type, req))
    post = state.copy()
    blk.process_consolidation_request(post, req)
    sse.verify_consolidation_request_op(state, req, post)
    assert len(post.pending_consolidations) == 1
    _write_state(d, "post.ssz_snappy", post)
    n += 1

    # switch to compounding (source == target, eth1 creds, excess balance)
    sw_addr = _set_wc(state, 11, sse.ETH1_PREFIX)
    _set_balance(state, 11, 34 * ETH)
    req = T.ConsolidationRequest(
        source_address=sw_addr,
        source_pubkey=bytes(state.validators.pubkeys[11]),
        target_pubkey=bytes(state.validators.pubkeys[11]))
    d = case("consolidation_request", "switch_to_compounding")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "consolidation_request.ssz_snappy",
          serialize(T.ConsolidationRequest.ssz_type, req))
    post = state.copy()
    blk.process_consolidation_request(post, req)
    sse.verify_consolidation_request_op(state, req, post)
    assert bytes(post.validators.withdrawal_credentials[11])[0] == 0x02
    assert len(post.pending_deposits) == 1    # the 2 ETH excess
    _write_state(d, "post.ssz_snappy", post)
    n += 1

    # insufficient consolidation churn (small registry): no-op
    small, _k, spec16 = _genesis("electra", 16)
    T16 = get_types(spec16.preset)
    _age(small, sse.SHARD_COMMITTEE_PERIOD + 5)
    a = _set_wc(small, 1, sse.ETH1_PREFIX)
    _set_wc(small, 2, sse.COMPOUNDING_PREFIX)
    req = T16.ConsolidationRequest(
        source_address=a,
        source_pubkey=bytes(small.validators.pubkeys[1]),
        target_pubkey=bytes(small.validators.pubkeys[2]))
    d = case("consolidation_request", "insufficient_churn_noop")
    _write_state(d, "pre.ssz_snappy", small)
    w_ssz(d, "consolidation_request.ssz_snappy",
          serialize(T16.ConsolidationRequest.ssz_type, req))
    post = small.copy()
    blk.process_consolidation_request(post, req)
    sse.verify_consolidation_request_op(small, req, post)
    _write_state(d, "post.ssz_snappy", post)
    n += 1

    # ---- withdrawals (electra: partial sweep + regular sweep) ----------
    state, keys, spec = _genesis("electra", 16)
    T = get_types(spec.preset)
    _age(state, 10)
    _set_wc(state, 3, sse.COMPOUNDING_PREFIX)
    _set_balance(state, 3, 40 * ETH)
    state.pending_partial_withdrawals = [
        T.PendingPartialWithdrawal(validator_index=3, amount=4 * ETH,
                                   withdrawable_epoch=9)]
    # a fully-withdrawable validator for the sweep arm
    _set_wc(state, 0, sse.ETH1_PREFIX)
    state.validators.set_field(0, "withdrawable_epoch", 8)
    state.validators.set_field(0, "exit_epoch", 7)
    from ..specs.chain_spec import ForkName
    expected, _p = blk.get_expected_withdrawals(state)
    payload = T.ExecutionPayload[ForkName.ELECTRA](withdrawals=expected)
    d = case("withdrawals", "partial_sweep_and_full_withdrawal")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "execution_payload.ssz_snappy",
          serialize(T.ExecutionPayload[ForkName.ELECTRA].ssz_type, payload))
    post = state.copy()
    blk.process_withdrawals(post, payload)
    sse.verify_withdrawals_op(state, payload, post)
    assert len(post.pending_partial_withdrawals) == 0
    _write_state(d, "post.ssz_snappy", post)
    n += 1

    # invalid: payload withdrawal amount tampered -> must raise
    bad = [T.Withdrawal(index=int(w.index),
                        validator_index=int(w.validator_index),
                        address=bytes(w.address),
                        amount=int(w.amount) + 1) for w in expected]
    payload_bad = T.ExecutionPayload[ForkName.ELECTRA](withdrawals=bad)
    d = case("withdrawals", "invalid_tampered_amount")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "execution_payload.ssz_snappy",
          serialize(T.ExecutionPayload[ForkName.ELECTRA].ssz_type,
                    payload_bad))
    n += 1
    return n


# ---------------------------------------------------------------------------
# capella operations
# ---------------------------------------------------------------------------

def gen_capella_operations(root) -> int:
    from ..containers import get_types
    from ..crypto import bls
    from ..specs.chain_spec import (
        ForkName, compute_domain, compute_signing_root,
    )
    from ..specs.constants import DOMAIN_BLS_TO_EXECUTION_CHANGE
    from ..ssz import htr, serialize
    from ..state_transition import block as blk
    from ..state_transition.block import VerifySignatures
    n = 0

    def case(handler, name):
        return wcase(root, "minimal", "capella", "operations", handler,
                     "pyspec_tests", name)

    state, keys, spec = _genesis("capella", 16)
    T = get_types(spec.preset)
    _age(state, 10)
    # full withdrawal: exited validator with eth1 creds
    _set_wc(state, 2, sse.ETH1_PREFIX)
    state.validators.set_field(2, "withdrawable_epoch", 9)
    state.validators.set_field(2, "exit_epoch", 8)
    # partial withdrawal: active with balance above 32 ETH
    _set_wc(state, 4, sse.ETH1_PREFIX)
    _set_balance(state, 4, 35 * ETH)
    expected, _p = blk.get_expected_withdrawals(state)
    assert len(expected) == 2, "capella sweep should find full+partial"
    payload = T.ExecutionPayload[ForkName.CAPELLA](withdrawals=expected)
    d = case("withdrawals", "full_and_partial_sweep")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "execution_payload.ssz_snappy",
          serialize(T.ExecutionPayload[ForkName.CAPELLA].ssz_type, payload))
    post = state.copy()
    blk.process_withdrawals(post, payload)
    sse.verify_withdrawals_op(state, payload, post)
    _write_state(d, "post.ssz_snappy", post)
    n += 1

    # invalid: missing withdrawal -> raise
    payload_bad = T.ExecutionPayload[ForkName.CAPELLA](
        withdrawals=expected[:1])
    d = case("withdrawals", "invalid_missing_withdrawal")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "execution_payload.ssz_snappy",
          serialize(T.ExecutionPayload[ForkName.CAPELLA].ssz_type,
                    payload_bad))
    n += 1

    # ---- bls_to_execution_change ---------------------------------------
    idx = 8
    pk = bls.sk_to_pk(keys[idx])          # interop: wc == 00||sha(pk)[1:]
    change = T.BLSToExecutionChange(
        validator_index=idx, from_bls_pubkey=pk,
        to_execution_address=b"\xcc" * 20)
    domain = compute_domain(DOMAIN_BLS_TO_EXECUTION_CHANGE,
                            spec.genesis_fork_version,
                            state.genesis_validators_root)
    sig = bls.sign(keys[idx], compute_signing_root(htr(change), domain))
    signed = T.SignedBLSToExecutionChange(message=change, signature=sig)
    d = case("bls_to_execution_change", "valid_change")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "address_change.ssz_snappy",
          serialize(T.SignedBLSToExecutionChange.ssz_type, signed))
    post = state.copy()
    blk.process_bls_to_execution_change(post, signed,
                                        VerifySignatures.TRUE)
    sse.verify_bls_change_op(state, signed, post)
    _write_state(d, "post.ssz_snappy", post)
    n += 1

    # invalid: from_bls_pubkey does not hash to the credential
    wrong = T.BLSToExecutionChange(
        validator_index=idx, from_bls_pubkey=bls.sk_to_pk(keys[0]),
        to_execution_address=b"\xcc" * 20)
    signed_bad = T.SignedBLSToExecutionChange(
        message=wrong, signature=sig)
    d = case("bls_to_execution_change", "invalid_pubkey_hash")
    _write_state(d, "pre.ssz_snappy", state)
    w_ssz(d, "address_change.ssz_snappy",
          serialize(T.SignedBLSToExecutionChange.ssz_type, signed_bad))
    n += 1
    return n


# ---------------------------------------------------------------------------
# electra epoch processing
# ---------------------------------------------------------------------------

def gen_electra_epoch(root) -> int:
    from ..containers import get_types
    from ..crypto import bls
    from ..state_transition import epoch as ep
    n = 0

    def case(handler, name):
        return wcase(root, "minimal", "electra", "epoch_processing",
                     handler, "pyspec_tests", name)

    def run(handler, name, pre, fn, verify):
        nonlocal n
        d = case(handler, name)
        _write_state(d, "pre.ssz_snappy", pre)
        post = pre.copy()
        fn(post)
        verify(pre, post)
        _write_state(d, "post.ssz_snappy", post)
        n += 1

    # ---- pending_deposits ----------------------------------------------
    state, keys, spec = _genesis("electra", 16)
    T = get_types(spec.preset)
    _age_last_slot(state, 6)
    state.finalized_checkpoint = T.Checkpoint(epoch=4, root=b"\x11" * 32)
    new_sk = 10**6 + 19
    new_pk = bls.sk_to_pk(new_sk)
    new_wc = b"\x02" + b"\x00" * 11 + b"\xdd" * 20
    state.pending_deposits = [
        # top-up for a known key (no signature needed)
        T.PendingDeposit(pubkey=bytes(state.validators.pubkeys[3]),
                         withdrawal_credentials=b"\x00" * 32,
                         amount=1 * ETH, signature=b"\x00" * 96, slot=0),
        # brand-new validator with a valid deposit signature
        T.PendingDeposit(pubkey=new_pk, withdrawal_credentials=new_wc,
                         amount=32 * ETH,
                         signature=_deposit_sig(spec, new_sk, new_pk,
                                                new_wc, 32 * ETH),
                         slot=0),
        # not yet finalized: slot beyond the finalized checkpoint
        T.PendingDeposit(pubkey=bytes(state.validators.pubkeys[4]),
                         withdrawal_credentials=b"\x00" * 32,
                         amount=1 * ETH, signature=b"\x00" * 96,
                         slot=45),
    ]
    run("pending_deposits", "top_up_new_validator_and_unfinalized",
        state, ep._process_pending_deposits,
        sse.verify_pending_deposits_sub)

    # churn limit: deposits beyond the per-epoch balance churn stay queued
    state2 = state.copy()
    state2.pending_deposits = [
        T.PendingDeposit(pubkey=bytes(state2.validators.pubkeys[i]),
                         withdrawal_credentials=b"\x00" * 32,
                         amount=70 * ETH, signature=b"\x00" * 96, slot=0)
        for i in (1, 2, 5)]          # 210 ETH > 128 ETH activation churn
    run("pending_deposits", "churn_limit_carries_balance",
        state2, ep._process_pending_deposits,
        sse.verify_pending_deposits_sub)

    # postponed: deposit for an exiting-but-not-withdrawable validator
    state3 = state.copy()
    state3.pending_deposits = [
        T.PendingDeposit(pubkey=bytes(state3.validators.pubkeys[7]),
                         withdrawal_credentials=b"\x00" * 32,
                         amount=2 * ETH, signature=b"\x00" * 96, slot=0)]
    state3.validators.set_field(7, "exit_epoch", 20)
    state3.validators.set_field(7, "withdrawable_epoch", 276)
    run("pending_deposits", "exiting_validator_postponed",
        state3, ep._process_pending_deposits,
        sse.verify_pending_deposits_sub)

    # ---- pending_consolidations ----------------------------------------
    state, keys, spec = _genesis("electra", 16)
    T = get_types(spec.preset)
    _age_last_slot(state, 30)
    # consolidation ready: source withdrawable at next epoch
    state.validators.set_field(1, "exit_epoch", 25)
    state.validators.set_field(1, "withdrawable_epoch", 31)
    # slashed source: skipped without transfer
    state.validators.set_field(2, "slashed", True)
    state.validators.set_field(2, "exit_epoch", 25)
    state.validators.set_field(2, "withdrawable_epoch", 31)
    # not yet withdrawable: processing stops here
    state.validators.set_field(3, "exit_epoch", 30)
    state.validators.set_field(3, "withdrawable_epoch", 40)
    state.pending_consolidations = [
        T.PendingConsolidation(source_index=1, target_index=10),
        T.PendingConsolidation(source_index=2, target_index=10),
        T.PendingConsolidation(source_index=3, target_index=11),
    ]
    run("pending_consolidations", "apply_skip_slashed_and_break",
        state, ep._process_pending_consolidations,
        sse.verify_pending_consolidations_sub)

    # ---- effective_balance_updates (compounding ceiling) ---------------
    state, keys, spec = _genesis("electra", 16)
    _age_last_slot(state, 5)
    _set_wc(state, 0, sse.COMPOUNDING_PREFIX)
    _set_balance(state, 0, 100 * ETH)     # rises to 100 ETH effective
    _set_wc(state, 1, sse.ETH1_PREFIX)
    _set_balance(state, 1, 100 * ETH)     # capped at 32 ETH effective
    _set_balance(state, 2, 31 * ETH + int(0.7 * ETH))  # hysteresis: hold

    def verify_ebu(pre, post):
        from .scalar_spec import _ck
        _ck([int(x) for x in post.validators.effective_balance]
            == sse.effective_balance_updates_electra(pre),
            "electra effective balances")

    run("effective_balance_updates", "compounding_vs_eth1_ceilings",
        state, ep._process_effective_balance_updates, verify_ebu)

    # ---- registry_updates ----------------------------------------------
    from ..specs.chain_spec import ForkName
    state, keys, spec = _genesis("electra", 16)
    T = get_types(spec.preset)
    _age_last_slot(state, 8)
    state.finalized_checkpoint = T.Checkpoint(epoch=7, root=b"\x22" * 32)
    # new depositors awaiting eligibility + activation
    for i in (3, 4):
        state.validators.set_field(i, "activation_eligibility_epoch", 5)
        state.validators.set_field(i, "activation_epoch",
                                   sse.FAR_FUTURE)
    # ejectable: effective balance at the ejection floor
    state.validators.set_field(6, "effective_balance", 16 * ETH)

    def run_ru(st):
        ep._process_registry_updates(st, ForkName.ELECTRA)

    def verify_ru(pre, post):
        sse.verify_registry_updates_electra(pre, post)

    run("registry_updates", "activation_ejection_churn", state, run_ru,
        verify_ru)

    # ---- slashings (per-increment penalty) -----------------------------
    state, keys, spec = _genesis("electra", 16)
    _age_last_slot(state, 40)
    epoch = 40
    target = epoch + 32                    # EPOCHS_PER_SLASHINGS_VECTOR/2
    for i in (2, 9):
        state.validators.set_field(i, "slashed", True)
        state.validators.set_field(i, "withdrawable_epoch", target)
    state.slashings[3] = 64 * ETH

    def run_sl(st):
        from ..state_transition.helpers import get_total_active_balance
        ep._process_slashings(st, ForkName.ELECTRA,
                              get_total_active_balance(st))

    run("slashings", "per_increment_penalty", state, run_sl,
        sse.verify_slashings_electra)
    return n


def gen_electra_sanity(root) -> int:
    """electra sanity/slots: the COMPOSED epoch transition on an electra
    state (pending queues + compounding balances + electra registry),
    scalar-verified piecewise at generation time."""
    from ..containers import get_types
    from ..state_transition import process_slots
    from .gen_corpus import w_yaml
    n = 0
    state, _keys, spec = _genesis("electra", 16)
    T = get_types(spec.preset)
    # the GENESIS-epoch boundary: rewards/justification/inactivity are
    # skipped by spec, so the composed transition's balance effects come
    # EXACTLY from the electra queues — piecewise scalar-checkable
    _age_last_slot(state, 0)
    # make the boundary DO electra-specific work: a queued finalized
    # deposit, a due consolidation, and a compounding balance excess
    state.pending_deposits = [
        T.PendingDeposit(pubkey=bytes(state.validators.pubkeys[2]),
                         withdrawal_credentials=b"\x00" * 32,
                         amount=3 * ETH, signature=b"\x00" * 96, slot=0)]
    state.validators.set_field(4, "exit_epoch", 0)
    state.validators.set_field(4, "withdrawable_epoch", 1)
    state.pending_consolidations = [
        T.PendingConsolidation(source_index=4, target_index=5)]
    _set_wc(state, 6, sse.COMPOUNDING_PREFIX)
    _set_balance(state, 6, 80 * ETH)

    # scalar expectations computed on the PRE state (the epoch order
    # runs these sub-transitions before effective-balance updates read
    # the moved balances — so compose them scalar-side too)
    exp_deposits = sse.pending_deposits_expected(state)
    d = wcase(root, "minimal", "electra", "sanity", "slots",
              "pyspec_tests", "epoch_boundary_queues")
    _write_state(d, "pre.ssz_snappy", state)
    w_yaml(d, "slots.yaml", 1)
    post = state.copy()
    process_slots(post, state.slot + 1)
    # piecewise scalar verification of the electra-specific outcomes
    from .scalar_spec import _ck
    _ck(len(post.pending_deposits) == len(exp_deposits["queue"]),
        "sanity: pending deposit queue")
    _ck(int(post.balances[2])
        == int(state.balances[2]) + 3 * ETH, "sanity: deposit applied")
    _ck(len(post.pending_consolidations) == 0,
        "sanity: consolidation consumed")
    _ck(int(post.balances[5]) > int(state.balances[5]),
        "sanity: consolidation moved balance")
    _ck(int(post.validators.effective_balance[6])
        == sse.effective_balance_updates_electra(_pre_eb_state(state,
                                                               post))[6],
        "sanity: compounding effective balance")
    _write_state(d, "post.ssz_snappy", post)
    n += 1
    return n


def _pre_eb_state(pre, post):
    """Effective-balance updates read balances AFTER the earlier epoch
    steps ran; lend the scalar transcription that intermediate view:
    pre-state rows with post-step balances."""
    class _View:
        pass
    v = _View()
    v.validators = pre.validators
    v.balances = post.balances
    v.slot = pre.slot
    return v


def gen_mid_fork_epoch(root) -> int:
    """bellatrix/capella/deneb epoch_processing: the fork-specific
    pieces between altair and electra (bellatrix slashings multiplier,
    capella/deneb effective-balance + registry behavior) — previously
    these forks had NO epoch vectors at all."""
    from ..specs.chain_spec import ForkName
    from ..state_transition import epoch as ep
    from ..state_transition.helpers import get_total_active_balance
    from .scalar_spec import _ck, effective_balance_updates
    n = 0

    def run(fork_dir, handler, name, pre, fn, verify):
        nonlocal n
        d = wcase(root, "minimal", fork_dir, "epoch_processing", handler,
                  "pyspec_tests", name)
        _write_state(d, "pre.ssz_snappy", pre)
        post = pre.copy()
        fn(post)
        verify(pre, post)
        _write_state(d, "post.ssz_snappy", post)
        n += 1

    # bellatrix slashings: multiplier 3 with the pre-electra formula
    state, _k, _spec_ = _genesis("bellatrix", 16)
    _age_last_slot(state, 40)
    for i in (1, 8):
        state.validators.set_field(i, "slashed", True)
        state.validators.set_field(i, "withdrawable_epoch", 40 + 32)
    state.slashings[3] = 48 * ETH

    def run_sl(st):
        ep._process_slashings(st, ForkName.BELLATRIX,
                              get_total_active_balance(st))

    run("bellatrix", "slashings", "multiplier_three", state, run_sl,
        lambda pre, post: _ck(
            [int(b) for b in post.balances]
            == sse.slashings_penalties_pre_electra(pre, 3),
            "bellatrix slashings"))

    # capella effective balances: pre-electra ceiling semantics
    state, _k, _spec_ = _genesis("capella", 16)
    _age_last_slot(state, 5)
    _set_balance(state, 0, 40 * ETH)          # capped at 32 ETH effective
    _set_balance(state, 1, 29 * ETH)          # hysteresis drop

    run("capella", "effective_balance_updates", "pre_electra_ceiling",
        state, ep._process_effective_balance_updates,
        lambda pre, post: _ck(
            [int(x) for x in post.validators.effective_balance]
            == effective_balance_updates(pre), "capella effective"))

    # deneb registry updates: 160 active validators make the validator
    # churn limit 5, so the EIP-7514 activation cap (4 on minimal)
    # BINDS — 6 eligible pending validators, exactly 4 may activate
    state, _k, _spec_ = _genesis("deneb", 160)
    _age_last_slot(state, 8)
    from ..containers import get_types
    T = get_types(_spec_.preset)
    state.finalized_checkpoint = T.Checkpoint(epoch=7, root=b"\x44" * 32)
    for i in (3, 4, 5, 6, 7, 10):
        state.validators.set_field(i, "activation_eligibility_epoch", 5)
        state.validators.set_field(i, "activation_epoch", sse.FAR_FUTURE)
    state.validators.set_field(9, "effective_balance", 16 * ETH)

    def run_ru(st):
        ep._process_registry_updates(st, ForkName.DENEB)

    def verify_ru(pre, post):
        exp = sse.registry_updates_deneb(pre)
        v = post.validators
        for i, r in enumerate(exp):
            _ck(int(v.activation_epoch[i]) == r["activation_epoch"],
                f"deneb activation[{i}]")
            _ck(int(v.exit_epoch[i]) == r["exit_epoch"],
                f"deneb exit[{i}]")
        activated = sum(
            1 for i in (3, 4, 5, 6, 7, 10)
            if int(v.activation_epoch[i]) != sse.FAR_FUTURE)
        _ck(activated == 4, "EIP-7514 cap must bind at exactly 4")

    run("deneb", "registry_updates", "eip7514_activation_cap_binds",
        state, run_ru, verify_ru)
    return n


def generate_all(root, only: list[str] | None = None) -> int:
    gens = {
        "electra_operations": gen_electra_operations,
        "capella_operations": gen_capella_operations,
        "electra_epoch": gen_electra_epoch,
        "electra_sanity": gen_electra_sanity,
        "mid_fork_epoch": gen_mid_fork_epoch,
    }
    n = 0
    for name, fn in gens.items():
        if only and name not in only:
            continue
        n += fn(root)
    return n
