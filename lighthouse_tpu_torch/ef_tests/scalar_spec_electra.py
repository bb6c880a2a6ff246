"""Independent SCALAR transcription of the consensus spec — capella+electra.

Extends scalar_spec.py (altair) through the fork-specific state-transition
logic of capella (withdrawals, BLS→execution changes) and electra
(EIP-7251/EIP-7002/EIP-6110: execution-layer requests, balance-churn
accounting, pending deposit/consolidation queues, compounding credentials)
so bellatrix→electra corpus post-states stop being implementation pins.  Same discipline as scalar_spec.py:
plain ints, bytes and loops straight from the spec pseudocode, importing NOTHING from
``lighthouse_tpu_torch.state_transition``.

Shared (documented, independently validated) dependencies:
- hashlib sha256 for the deposit-domain merkle bits (hand-rolled here);
- the pure-python BLS oracle for deposit-signature validity (validated by
  the EF bls vectors against the byte-exact C++ backend).

Reference parity: per_block_processing/process_operations.rs electra
arms, per_epoch_processing/single_pass.rs (registry/balance single-pass),
capella withdrawals processing (process_withdrawals in
per_block_processing.rs).
"""
from __future__ import annotations

import hashlib

from .scalar_spec import (
    INCREMENT, SLOTS_PER_EPOCH, _ck, current_epoch, is_active,
    total_active_balance,
)

FAR_FUTURE = 2**64 - 1
GENESIS_SLOT = 0
MAX_SEED_LOOKAHEAD = 4

# minimal-preset electra values (specs/presets.py MINIMAL_PRESET + minimal
# ChainSpec — transcribed as literals so a preset regression can't
# propagate here)
MIN_ACTIVATION_BALANCE = 32 * 10**9
MAX_EFFECTIVE_ELECTRA = 2048 * 10**9
MIN_PER_EPOCH_CHURN_ELECTRA = 64 * 10**9
MAX_PER_EPOCH_ACTIVATION_EXIT_CHURN = 128 * 10**9
CHURN_QUOTIENT = 32
EJECTION_BALANCE = 16 * 10**9
MIN_VALIDATOR_WITHDRAWABILITY_DELAY = 256
SHARD_COMMITTEE_PERIOD = 64
MAX_WITHDRAWALS_PER_PAYLOAD = 4          # minimal
MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP = 16
MAX_PENDING_PARTIALS_PER_SWEEP = 2     # minimal (mainnet: 8)
MAX_PENDING_DEPOSITS_PER_EPOCH = 16
PENDING_PARTIAL_WITHDRAWALS_LIMIT = 64
PENDING_CONSOLIDATIONS_LIMIT = 64
FULL_EXIT_REQUEST_AMOUNT = 0
UNSET_DEPOSIT_REQUESTS_START_INDEX = 2**64 - 1
MAX_EFFECTIVE_BALANCE = 32 * 10**9       # pre-electra ceiling (capella)
MIN_SLASHING_PENALTY_QUOTIENT_ELECTRA = 4096

BLS_PREFIX = 0x00
ETH1_PREFIX = 0x01
COMPOUNDING_PREFIX = 0x02

HYSTERESIS_QUOTIENT = 4
HYSTERESIS_DOWN = 1
HYSTERESIS_UP = 5


# ---------------------------------------------------------------------------
# plain views
# ---------------------------------------------------------------------------

def vrows_full(state) -> list[dict]:
    """vrows + the byte columns the capella/electra logic reads."""
    v = state.validators
    return [{
        "pubkey": bytes(v.pubkeys[i]),
        "withdrawal_credentials": bytes(v.withdrawal_credentials[i]),
        "effective_balance": int(v.effective_balance[i]),
        "slashed": bool(v.slashed[i]),
        "activation_eligibility_epoch": int(
            v.activation_eligibility_epoch[i]),
        "activation_epoch": int(v.activation_epoch[i]),
        "exit_epoch": int(v.exit_epoch[i]),
        "withdrawable_epoch": int(v.withdrawable_epoch[i]),
    } for i in range(len(v))]


def has_eth1_wc(wc: bytes) -> bool:
    return wc[0] == ETH1_PREFIX


def has_compounding_wc(wc: bytes) -> bool:
    return wc[0] == COMPOUNDING_PREFIX


def has_execution_wc(wc: bytes) -> bool:
    return has_eth1_wc(wc) or has_compounding_wc(wc)


def max_effective_balance_for(row: dict) -> int:
    if has_compounding_wc(row["withdrawal_credentials"]):
        return MAX_EFFECTIVE_ELECTRA
    return MIN_ACTIVATION_BALANCE


def pending_balance_to_withdraw(state, index: int) -> int:
    return sum(int(w.amount) for w in state.pending_partial_withdrawals
               if int(w.validator_index) == index)


# ---------------------------------------------------------------------------
# electra churn accounting (EIP-7251)
# ---------------------------------------------------------------------------

def balance_churn_limit(state) -> int:
    churn = max(MIN_PER_EPOCH_CHURN_ELECTRA,
                total_active_balance(state) // CHURN_QUOTIENT)
    return churn - churn % INCREMENT


def activation_exit_churn_limit(state) -> int:
    return min(MAX_PER_EPOCH_ACTIVATION_EXIT_CHURN,
               balance_churn_limit(state))


def consolidation_churn_limit(state) -> int:
    return balance_churn_limit(state) - activation_exit_churn_limit(state)


def exit_epoch_and_churn(earliest: int, to_consume: int, epoch: int,
                         per_epoch_churn: int, exit_balance: int
                         ) -> tuple[int, int, int]:
    """compute_exit_epoch_and_update_churn as a pure function:
    (earliest_exit_epoch, exit_balance_to_consume) -> (exit_epoch,
    new_earliest, new_to_consume).  Also used for the consolidation
    variant with the consolidation churn."""
    new_earliest = max(earliest, epoch + 1 + MAX_SEED_LOOKAHEAD)
    if earliest < new_earliest:
        balance_to_consume = per_epoch_churn
    else:
        balance_to_consume = to_consume
    if exit_balance > balance_to_consume:
        to_process = exit_balance - balance_to_consume
        additional = (to_process - 1) // per_epoch_churn + 1
        new_earliest += additional
        balance_to_consume += additional * per_epoch_churn
    return new_earliest, new_earliest, balance_to_consume - exit_balance


# ---------------------------------------------------------------------------
# capella/electra withdrawals
# ---------------------------------------------------------------------------

def expected_withdrawals(state, electra: bool
                         ) -> tuple[list[dict], int]:
    """get_expected_withdrawals -> ([{index, validator_index, address,
    amount}], processed_partials)."""
    rows = vrows_full(state)
    balances = [int(b) for b in state.balances]
    epoch = current_epoch(state)
    windex = int(state.next_withdrawal_index)
    vindex = int(state.next_withdrawal_validator_index)
    out: list[dict] = []
    processed_partials = 0
    if electra:
        for w in state.pending_partial_withdrawals:
            if int(w.withdrawable_epoch) > epoch or \
                    len(out) == MAX_PENDING_PARTIALS_PER_SWEEP:
                break
            r = rows[int(w.validator_index)]
            bal = balances[int(w.validator_index)]
            if (r["exit_epoch"] == FAR_FUTURE
                    and r["effective_balance"] >= MIN_ACTIVATION_BALANCE
                    and bal > MIN_ACTIVATION_BALANCE):
                out.append({
                    "index": windex,
                    "validator_index": int(w.validator_index),
                    "address": r["withdrawal_credentials"][12:],
                    "amount": min(bal - MIN_ACTIVATION_BALANCE,
                                  int(w.amount)),
                })
                windex += 1
            processed_partials += 1
    n = len(rows)
    for _ in range(min(n, MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)):
        r = rows[vindex]
        balance = balances[vindex]
        if electra:
            balance -= sum(w["amount"] for w in out
                           if w["validator_index"] == vindex)
            max_eb = max_effective_balance_for(r)
            withdrawable_wc = has_execution_wc(r["withdrawal_credentials"])
        else:
            max_eb = MAX_EFFECTIVE_BALANCE
            withdrawable_wc = has_eth1_wc(r["withdrawal_credentials"])
        if withdrawable_wc and r["withdrawable_epoch"] <= epoch \
                and balance > 0:
            out.append({"index": windex, "validator_index": vindex,
                        "address": r["withdrawal_credentials"][12:],
                        "amount": balance})
            windex += 1
        elif withdrawable_wc and r["effective_balance"] == max_eb \
                and balance > max_eb:
            out.append({"index": windex, "validator_index": vindex,
                        "address": r["withdrawal_credentials"][12:],
                        "amount": balance - max_eb})
            windex += 1
        if len(out) == MAX_WITHDRAWALS_PER_PAYLOAD:
            break
        vindex = (vindex + 1) % n
    return out, processed_partials


def verify_withdrawals_op(pre, payload, post) -> None:
    exp, partials = expected_withdrawals(pre, electra=_is_electra(pre))
    got = list(payload.withdrawals)
    _ck(len(got) == len(exp), "withdrawal count")
    for g, e in zip(got, exp):
        _ck(int(g.index) == e["index"], "withdrawal index")
        _ck(int(g.validator_index) == e["validator_index"],
            "withdrawal validator")
        _ck(bytes(g.address) == e["address"], "withdrawal address")
        _ck(int(g.amount) == e["amount"], "withdrawal amount")
    balances = [int(b) for b in pre.balances]
    for e in exp:
        balances[e["validator_index"]] = max(
            0, balances[e["validator_index"]] - e["amount"])
    _ck([int(b) for b in post.balances] == balances,
        "balances after withdrawals")
    if _is_electra(pre):
        _ck(len(post.pending_partial_withdrawals)
            == len(pre.pending_partial_withdrawals) - partials,
            "pending partials consumed")
    if exp:
        _ck(int(post.next_withdrawal_index) == exp[-1]["index"] + 1,
            "next withdrawal index")
    n = len(pre.validators)
    if len(exp) == MAX_WITHDRAWALS_PER_PAYLOAD:
        want_next = (exp[-1]["validator_index"] + 1) % n
    else:
        want_next = (int(pre.next_withdrawal_validator_index)
                     + MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP) % n
    _ck(int(post.next_withdrawal_validator_index) == want_next,
        "next withdrawal validator")


def _is_electra(state) -> bool:
    return getattr(state, "pending_deposits", None) is not None


# ---------------------------------------------------------------------------
# capella bls_to_execution_change
# ---------------------------------------------------------------------------

def verify_bls_change_op(pre, signed_change, post) -> None:
    change = signed_change.message
    idx = int(change.validator_index)
    wc = bytes(pre.validators.withdrawal_credentials[idx])
    _ck(wc[0] == BLS_PREFIX, "bls change pre-credential")
    _ck(wc[1:] == hashlib.sha256(
        bytes(change.from_bls_pubkey)).digest()[1:], "bls change hash")
    new_wc = bytes(post.validators.withdrawal_credentials[idx])
    _ck(new_wc == bytes([ETH1_PREFIX]) + b"\x00" * 11
        + bytes(change.to_execution_address), "bls change new credential")
    for i in range(len(pre.validators)):
        if i != idx:
            _ck(bytes(post.validators.withdrawal_credentials[i])
                == bytes(pre.validators.withdrawal_credentials[i]),
                "bls change untouched rows")


# ---------------------------------------------------------------------------
# electra operations (EIP-6110 / EIP-7002 / EIP-7251)
# ---------------------------------------------------------------------------

def verify_deposit_request_op(pre, request, post) -> None:
    if int(pre.deposit_requests_start_index) == \
            UNSET_DEPOSIT_REQUESTS_START_INDEX:
        _ck(int(post.deposit_requests_start_index) == int(request.index),
            "deposit_requests_start_index set")
    else:
        _ck(int(post.deposit_requests_start_index)
            == int(pre.deposit_requests_start_index),
            "deposit_requests_start_index unchanged")
    _ck(len(post.pending_deposits) == len(pre.pending_deposits) + 1,
        "pending deposit appended")
    d = post.pending_deposits[-1]
    _ck(bytes(d.pubkey) == bytes(request.pubkey), "pending deposit pubkey")
    _ck(bytes(d.withdrawal_credentials)
        == bytes(request.withdrawal_credentials), "pending deposit wc")
    _ck(int(d.amount) == int(request.amount), "pending deposit amount")
    _ck(int(d.slot) == int(pre.slot), "pending deposit slot")


def _withdrawal_request_expected(pre, request) -> dict | None:
    """None => the request is a no-op; else what it must do."""
    rows = vrows_full(pre)
    epoch = current_epoch(pre)
    amount = int(request.amount)
    pk = bytes(request.validator_pubkey)
    idx = next((i for i, r in enumerate(rows) if r["pubkey"] == pk), None)
    if idx is None:
        return None
    r = rows[idx]
    wc = r["withdrawal_credentials"]
    if not has_execution_wc(wc):
        return None
    if wc[12:] != bytes(request.source_address):
        return None
    if not is_active(r, epoch):
        return None
    if epoch < r["activation_epoch"] + SHARD_COMMITTEE_PERIOD:
        return None
    if r["exit_epoch"] != FAR_FUTURE:
        return None
    pending = pending_balance_to_withdraw(pre, idx)
    if amount == FULL_EXIT_REQUEST_AMOUNT:
        if pending != 0:
            return None
        exit_epoch, new_earliest, new_consume = exit_epoch_and_churn(
            int(pre.earliest_exit_epoch), int(pre.exit_balance_to_consume),
            epoch, activation_exit_churn_limit(pre), r["effective_balance"])
        return {"kind": "full", "index": idx, "exit_epoch": exit_epoch,
                "earliest": new_earliest, "consume": new_consume}
    if len(pre.pending_partial_withdrawals) >= \
            PENDING_PARTIAL_WITHDRAWALS_LIMIT:
        return None
    balance = int(pre.balances[idx])
    if not (has_compounding_wc(wc)
            and r["effective_balance"] >= MIN_ACTIVATION_BALANCE
            and balance - pending > MIN_ACTIVATION_BALANCE):
        return None
    to_withdraw = min(balance - MIN_ACTIVATION_BALANCE - pending, amount)
    exit_epoch, new_earliest, new_consume = exit_epoch_and_churn(
        int(pre.earliest_exit_epoch), int(pre.exit_balance_to_consume),
        epoch, activation_exit_churn_limit(pre), to_withdraw)
    return {"kind": "partial", "index": idx, "amount": to_withdraw,
            "withdrawable": exit_epoch
            + MIN_VALIDATOR_WITHDRAWABILITY_DELAY,
            "earliest": new_earliest, "consume": new_consume}


def verify_withdrawal_request_op(pre, request, post) -> None:
    exp = _withdrawal_request_expected(pre, request)
    if exp is None:
        _ck(pre.hash_tree_root() == post.hash_tree_root(),
            "withdrawal request no-op")
        return
    if exp["kind"] == "full":
        i = exp["index"]
        _ck(int(post.validators.exit_epoch[i]) == exp["exit_epoch"],
            "full exit epoch")
        _ck(int(post.validators.withdrawable_epoch[i])
            == exp["exit_epoch"] + MIN_VALIDATOR_WITHDRAWABILITY_DELAY,
            "full exit withdrawable")
        _ck(int(post.earliest_exit_epoch) == exp["earliest"],
            "earliest exit epoch")
        _ck(int(post.exit_balance_to_consume) == exp["consume"],
            "exit balance to consume")
        return
    _ck(len(post.pending_partial_withdrawals)
        == len(pre.pending_partial_withdrawals) + 1, "partial appended")
    w = post.pending_partial_withdrawals[-1]
    _ck(int(w.validator_index) == exp["index"], "partial index")
    _ck(int(w.amount) == exp["amount"], "partial amount")
    _ck(int(w.withdrawable_epoch) == exp["withdrawable"],
        "partial withdrawable epoch")
    _ck(int(post.earliest_exit_epoch) == exp["earliest"],
        "earliest exit epoch (partial)")
    _ck(int(post.exit_balance_to_consume) == exp["consume"],
        "exit balance to consume (partial)")


def verify_consolidation_request_op(pre, request, post) -> None:
    rows = vrows_full(pre)
    epoch = current_epoch(pre)
    spk = bytes(request.source_pubkey)
    tpk = bytes(request.target_pubkey)
    src = next((i for i, r in enumerate(rows) if r["pubkey"] == spk), None)

    # switch-to-compounding arm
    if spk == tpk:
        valid = (src is not None
                 and has_eth1_wc(rows[src]["withdrawal_credentials"])
                 and rows[src]["withdrawal_credentials"][12:]
                 == bytes(request.source_address)
                 and is_active(rows[src], epoch)
                 and rows[src]["exit_epoch"] == FAR_FUTURE)
        if not valid:
            _ck(pre.hash_tree_root() == post.hash_tree_root(),
                "switch no-op")
            return
        new_wc = bytes(post.validators.withdrawal_credentials[src])
        _ck(new_wc == bytes([COMPOUNDING_PREFIX])
            + rows[src]["withdrawal_credentials"][1:], "switched credential")
        balance = int(pre.balances[src])
        if balance > MIN_ACTIVATION_BALANCE:
            excess = balance - MIN_ACTIVATION_BALANCE
            _ck(int(post.balances[src]) == MIN_ACTIVATION_BALANCE,
                "excess balance removed")
            d = post.pending_deposits[-1]
            _ck(int(d.amount) == excess and bytes(d.pubkey) == spk
                and int(d.slot) == GENESIS_SLOT, "excess queued")
        else:
            _ck(int(post.balances[src]) == balance, "balance unchanged")
        return

    tgt = next((i for i, r in enumerate(rows) if r["pubkey"] == tpk), None)
    ok = (consolidation_churn_limit(pre) > MIN_ACTIVATION_BALANCE
          and len(pre.pending_consolidations) < PENDING_CONSOLIDATIONS_LIMIT
          and src is not None and tgt is not None and src != tgt)
    if ok:
        sr, tr = rows[src], rows[tgt]
        ok = (has_execution_wc(sr["withdrawal_credentials"])
              and has_compounding_wc(tr["withdrawal_credentials"])
              and sr["withdrawal_credentials"][12:]
              == bytes(request.source_address)
              and is_active(sr, epoch) and is_active(tr, epoch)
              and sr["exit_epoch"] == FAR_FUTURE
              and tr["exit_epoch"] == FAR_FUTURE
              and epoch >= sr["activation_epoch"] + SHARD_COMMITTEE_PERIOD
              and pending_balance_to_withdraw(pre, src) == 0)
    if not ok:
        _ck(pre.hash_tree_root() == post.hash_tree_root(),
            "consolidation no-op")
        return
    exit_epoch, new_earliest, new_consume = exit_epoch_and_churn(
        int(pre.earliest_consolidation_epoch),
        int(pre.consolidation_balance_to_consume),
        epoch, consolidation_churn_limit(pre),
        rows[src]["effective_balance"])
    _ck(int(post.validators.exit_epoch[src]) == exit_epoch,
        "consolidation source exit")
    _ck(int(post.validators.withdrawable_epoch[src])
        == exit_epoch + MIN_VALIDATOR_WITHDRAWABILITY_DELAY,
        "consolidation source withdrawable")
    _ck(int(post.earliest_consolidation_epoch) == new_earliest,
        "earliest consolidation epoch")
    _ck(int(post.consolidation_balance_to_consume) == new_consume,
        "consolidation balance to consume")
    _ck(len(post.pending_consolidations)
        == len(pre.pending_consolidations) + 1, "consolidation appended")
    c = post.pending_consolidations[-1]
    _ck(int(c.source_index) == src and int(c.target_index) == tgt,
        "consolidation indices")


# ---------------------------------------------------------------------------
# electra epoch processing
# ---------------------------------------------------------------------------

def _deposit_signature_valid(state, pubkey: bytes, wc: bytes, amount: int,
                             signature: bytes) -> bool:
    """Deposit-domain proof of possession, hand-rolled merkle + the
    python BLS oracle (shared validated dep)."""
    def hp(a, b):
        return hashlib.sha256(a + b).digest()

    pk_root = hp(pubkey[:32], pubkey[32:48] + b"\x00" * 16)
    msg_root = hp(hp(pk_root, wc),
                  hp(amount.to_bytes(8, "little") + b"\x00" * 24,
                     b"\x00" * 32))
    # deposit domain: genesis fork version + ZERO validators root
    fork_data_root = hp(_genesis_fork_version(state).ljust(32, b"\x00"),
                        b"\x00" * 32)
    domain = bytes([3, 0, 0, 0]) + fork_data_root[:28]
    signing_root = hp(msg_root, domain)
    from ..crypto.bls import PythonBackend
    try:
        return PythonBackend().verify(pubkey, signing_root, signature)
    except Exception:
        return False


def _genesis_fork_version(state) -> bytes:
    return bytes(state.spec.genesis_fork_version)


def pending_deposits_expected(state) -> dict:
    """process_pending_deposits on plain views.  Returns the expected
    queue suffix + postponed list, applied (pubkey, amount) effects and
    the new deposit_balance_to_consume."""
    rows = vrows_full(state)
    next_epoch = current_epoch(state) + 1
    available = int(state.deposit_balance_to_consume) + \
        activation_exit_churn_limit(state)
    processed = 0
    next_index = 0
    postponed = []
    churn_reached = False
    finalized_slot = int(state.finalized_checkpoint.epoch) * SLOTS_PER_EPOCH
    applied: list[tuple[bytes, int]] = []
    pubkeys = {r["pubkey"]: i for i, r in enumerate(rows)}
    for d in state.pending_deposits:
        if int(d.slot) > GENESIS_SLOT and int(state.eth1_deposit_index) < \
                int(state.deposit_requests_start_index):
            break
        if int(d.slot) > finalized_slot:
            break
        if next_index >= MAX_PENDING_DEPOSITS_PER_EPOCH:
            break
        i = pubkeys.get(bytes(d.pubkey))
        exited = i is not None and rows[i]["exit_epoch"] < FAR_FUTURE
        withdrawn = i is not None and \
            rows[i]["withdrawable_epoch"] < next_epoch
        if withdrawn:
            applied.append((bytes(d.pubkey), int(d.amount)))
        elif exited:
            postponed.append(d)
        else:
            if processed + int(d.amount) > available:
                churn_reached = True
                break
            processed += int(d.amount)
            applied.append((bytes(d.pubkey), int(d.amount)))
        next_index += 1
    return {
        "queue": list(state.pending_deposits)[next_index:] + postponed,
        "applied": applied,
        "to_consume": (available - processed) if churn_reached else 0,
    }


def verify_pending_deposits_sub(pre, post) -> None:
    exp = pending_deposits_expected(pre)
    _ck(len(post.pending_deposits) == len(exp["queue"]),
        "pending deposit queue length")
    for got, want in zip(post.pending_deposits, exp["queue"]):
        _ck(bytes(got.pubkey) == bytes(want.pubkey)
            and int(got.amount) == int(want.amount)
            and int(got.slot) == int(want.slot), "pending deposit queue")
    _ck(int(post.deposit_balance_to_consume) == exp["to_consume"],
        "deposit balance to consume")
    # balance effects: top-ups for known keys; new validators for unknown
    # keys with valid signatures
    balances = [int(b) for b in pre.balances]
    rows = vrows_full(pre)
    known = {r["pubkey"]: i for i, r in enumerate(rows)}
    for pk, amount in exp["applied"]:
        if pk in known:
            balances[known[pk]] += amount
        else:
            dep = next(d for d in pre.pending_deposits
                       if bytes(d.pubkey) == pk)
            if _deposit_signature_valid(
                    pre, pk, bytes(dep.withdrawal_credentials),
                    int(dep.amount), bytes(dep.signature)):
                known[pk] = len(balances)
                balances.append(amount)
    _ck([int(b) for b in post.balances] == balances,
        "balances after pending deposits")
    _ck(len(post.validators) == len(balances), "registry growth")


def verify_pending_consolidations_sub(pre, post) -> None:
    rows = vrows_full(pre)
    next_epoch = current_epoch(pre) + 1
    balances = [int(b) for b in pre.balances]
    next_index = 0
    for c in pre.pending_consolidations:
        src = rows[int(c.source_index)]
        if src["slashed"]:
            next_index += 1
            continue
        if src["withdrawable_epoch"] > next_epoch:
            break
        moved = min(balances[int(c.source_index)], src["effective_balance"])
        balances[int(c.source_index)] -= moved
        balances[int(c.target_index)] += moved
        next_index += 1
    _ck(len(post.pending_consolidations)
        == len(pre.pending_consolidations) - next_index,
        "pending consolidations consumed")
    _ck([int(b) for b in post.balances] == balances,
        "balances after consolidations")


def effective_balance_updates_electra(state) -> list[int]:
    rows = vrows_full(state)
    balances = [int(b) for b in state.balances]
    hyst = INCREMENT // HYSTERESIS_QUOTIENT
    down, up = hyst * HYSTERESIS_DOWN, hyst * HYSTERESIS_UP
    out = []
    for r, b in zip(rows, balances):
        eb = r["effective_balance"]
        max_eb = max_effective_balance_for(r)
        if b + down < eb or eb + up < b:
            eb = min(b - b % INCREMENT, max_eb)
        out.append(eb)
    return out


def registry_updates_electra(state) -> list[dict]:
    """Single pass: eligibility, ejections (serial churn accounting),
    activations without a per-epoch cap (churn moved to deposit
    processing)."""
    rows = vrows_full(state)
    epoch = current_epoch(state)
    finalized = int(state.finalized_checkpoint.epoch)
    out = [dict(r) for r in rows]
    earliest = int(state.earliest_exit_epoch)
    consume = int(state.exit_balance_to_consume)
    churn = activation_exit_churn_limit(state)
    for i, r in enumerate(out):
        if r["activation_eligibility_epoch"] == FAR_FUTURE and \
                r["effective_balance"] >= MIN_ACTIVATION_BALANCE:
            r["activation_eligibility_epoch"] = epoch + 1
    for i, r in enumerate(out):
        if is_active(rows[i], epoch) and \
                r["effective_balance"] <= EJECTION_BALANCE and \
                r["exit_epoch"] == FAR_FUTURE:
            exit_epoch, earliest, consume = exit_epoch_and_churn(
                earliest, consume, epoch, churn, r["effective_balance"])
            r["exit_epoch"] = exit_epoch
            r["withdrawable_epoch"] = exit_epoch + \
                MIN_VALIDATOR_WITHDRAWABILITY_DELAY
    for r, orig in zip(out, rows):
        if orig["activation_eligibility_epoch"] <= finalized and \
                orig["activation_epoch"] == FAR_FUTURE:
            r["activation_epoch"] = epoch + 1 + MAX_SEED_LOOKAHEAD
    return out


def verify_registry_updates_electra(pre, post) -> None:
    exp = registry_updates_electra(pre)
    v = post.validators
    for i, r in enumerate(exp):
        _ck(int(v.activation_eligibility_epoch[i])
            == r["activation_eligibility_epoch"], f"eligibility[{i}]")
        _ck(int(v.activation_epoch[i]) == r["activation_epoch"],
            f"activation[{i}]")
        _ck(int(v.exit_epoch[i]) == r["exit_epoch"], f"exit[{i}]")
        _ck(int(v.withdrawable_epoch[i]) == r["withdrawable_epoch"],
            f"withdrawable[{i}]")


def registry_updates_deneb(state) -> list[dict]:
    """Pre-electra registry updates with the EIP-7514 activation-churn
    cap: activations per epoch = min(MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT
    = 4 on minimal, validator churn limit)."""
    from .scalar_spec import active_indices, registry_updates, vrows
    rows = registry_updates(state)          # altair semantics first
    epoch = current_epoch(state)
    orig = vrows(state)
    churn = max(2, len(active_indices(orig, epoch)) // CHURN_QUOTIENT)
    cap = min(4, churn)                     # minimal preset cap
    fin = int(state.finalized_checkpoint.epoch)
    queue = sorted(
        (i for i, r in enumerate(orig)
         if r["activation_eligibility_epoch"] <= fin
         and r["activation_epoch"] == FAR_FUTURE),
        key=lambda i: (orig[i]["activation_eligibility_epoch"], i))
    for k, i in enumerate(queue):
        rows[i]["activation_epoch"] = (
            epoch + 1 + MAX_SEED_LOOKAHEAD if k < cap else FAR_FUTURE)
    return rows


def slashings_penalties_pre_electra(state, multiplier: int) -> list[int]:
    """The pre-electra slashings formula (bellatrix/capella/deneb use
    multiplier 3, altair 2): penalty = (eb // INC) * adjusted // total
    * INC — integer-division order matters and differs from electra's
    per-increment variant below."""
    rows = vrows_full(state)
    epoch = current_epoch(state)
    total = total_active_balance(state)
    adjusted = min(sum(int(s) for s in state.slashings) * multiplier,
                   total)
    target = epoch + 32                # EPOCHS_PER_SLASHINGS_VECTOR // 2
    out = []
    for i, r in enumerate(rows):
        b = int(state.balances[i])
        if r["slashed"] and r["withdrawable_epoch"] == target:
            penalty = (r["effective_balance"] // INCREMENT) * adjusted \
                // total * INCREMENT
            b = max(0, b - penalty)
        out.append(b)
    return out


def slashings_penalties_electra(state) -> list[int]:
    rows = vrows_full(state)
    epoch = current_epoch(state)
    total = total_active_balance(state)
    adjusted = min(sum(int(s) for s in state.slashings) * 3, total)
    per_increment = adjusted // (total // INCREMENT)
    target = epoch + 32  # EPOCHS_PER_SLASHINGS_VECTOR // 2 (minimal: 64/2)
    out = []
    for i, r in enumerate(rows):
        b = int(state.balances[i])
        if r["slashed"] and r["withdrawable_epoch"] == target:
            penalty = (r["effective_balance"] // INCREMENT) * per_increment
            b = max(0, b - penalty)
        out.append(b)
    return out


def verify_slashings_electra(pre, post) -> None:
    _ck([int(b) for b in post.balances] == slashings_penalties_electra(pre),
        "balances after electra slashings")
