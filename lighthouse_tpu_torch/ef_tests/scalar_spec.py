"""Independent SCALAR transcription of the consensus spec (altair).

De-circularizes the self-generated EF corpus: the
families whose expected post-states used to be regression pins from the
implementation under test are now verified at GENERATION time against
this module — a direct, loop-by-loop transcription of the spec
pseudocode that deliberately imports NOTHING from
``lighthouse_tpu_torch.state_transition`` (the vectorized implementation being
validated).  A transition bug present from the start can no longer be
enshrined as an expected post-state: generation fails when the
vectorized post disagrees with the scalar computation.

What IS shared with the implementation:
- the SSZ container layer (reads/writes of state fields) — validated
  independently by the hand-built ssz_static/ssz_generic vectors;
- ``lighthouse_tpu.ssz.htr`` for state/block roots — validated by the
  same hand-built vectors and the merkle_proof re-hashing family;
- the pure-python BLS oracle for pubkey aggregation — validated by the
  EF bls vectors via the byte-exact C++ backend.

Everything else — committees, shuffling, rewards, justification,
registry churn, slashings, flag updates, sync-committee selection, the
block operations — is recomputed here from the spec pseudocode with
plain ints and loops.
"""
from __future__ import annotations

import hashlib

# independent scalar constants (minimal preset, altair)
WEIGHTS = (14, 26, 14)                 # source, target, head
WEIGHT_DENOM = 64
PROPOSER_WEIGHT = 8
SYNC_REWARD_WEIGHT = 2
BASE_REWARD_FACTOR = 64
INCREMENT = 10**9
MAX_EFFECTIVE = 32 * 10**9
HYSTERESIS_QUOTIENT = 4
HYSTERESIS_DOWN = 1
HYSTERESIS_UP = 5
EPOCHS_PER_ETH1_PERIOD = 4             # minimal
SLOTS_PER_EPOCH = 8                    # minimal
EPOCHS_PER_RANDAO_VECTOR = 64          # minimal EPOCHS_PER_HISTORICAL_VECTOR
EPOCHS_PER_SLASHINGS_VECTOR = 64
SLOTS_PER_HISTORICAL_ROOT = 64
MIN_SEED_LOOKAHEAD = 1
MAX_SEED_LOOKAHEAD = 4
MIN_PER_EPOCH_CHURN = 2                # minimal min_per_epoch_churn_limit = 2
CHURN_QUOTIENT = 32                    # minimal churn_limit_quotient
MIN_ACTIVATION_BALANCE = 16 * 10**9    # ejection balance
SHARD_COMMITTEE_PERIOD = 64
MIN_VALIDATOR_WITHDRAWABILITY_DELAY = 256
EPOCHS_PER_SLASHINGS = 64
PROPORTIONAL_SLASHING_MULT_ALTAIR = 2
MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR = 64
WHISTLEBLOWER_REWARD_QUOTIENT = 512
PROPOSER_REWARD_QUOTIENT = 8
INACTIVITY_SCORE_BIAS = 4
INACTIVITY_SCORE_RECOVERY_RATE = 16
INACTIVITY_PENALTY_QUOTIENT_ALTAIR = 3 * 2**24
MIN_EPOCHS_TO_INACTIVITY_PENALTY = 4
SYNC_COMMITTEE_SIZE = 32               # minimal
EPOCHS_PER_SYNC_COMMITTEE_PERIOD = 8   # minimal
SHUFFLE_ROUNDS = 10                    # minimal
DOMAIN_BEACON_ATTESTER = 1
DOMAIN_SYNC_COMMITTEE = 7
TIMELY_SOURCE, TIMELY_TARGET, TIMELY_HEAD = 1, 2, 4
MAX_RANDOM_BYTE = 255


def sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def isqrt(n: int) -> int:
    x = n
    y = (x + 1) // 2
    while y < x:
        x = y
        y = (x + n // x) // 2
    return x


# ---------------------------------------------------------------------------
# scalar state views
# ---------------------------------------------------------------------------

def vrows(state) -> list[dict]:
    """Plain-python rows of the validator registry."""
    v = state.validators
    return [{
        "effective_balance": int(v.effective_balance[i]),
        "slashed": bool(v.slashed[i]),
        "activation_eligibility_epoch": int(
            v.activation_eligibility_epoch[i]),
        "activation_epoch": int(v.activation_epoch[i]),
        "exit_epoch": int(v.exit_epoch[i]),
        "withdrawable_epoch": int(v.withdrawable_epoch[i]),
    } for i in range(len(v))]


def is_active(row: dict, epoch: int) -> bool:
    return row["activation_epoch"] <= epoch < row["exit_epoch"]


def current_epoch(state) -> int:
    return int(state.slot) // SLOTS_PER_EPOCH


def active_indices(rows, epoch: int) -> list[int]:
    return [i for i, r in enumerate(rows) if is_active(r, epoch)]


def total_active_balance(state, rows=None) -> int:
    rows = rows if rows is not None else vrows(state)
    epoch = current_epoch(state)
    tot = sum(r["effective_balance"] for r in rows if is_active(r, epoch))
    return max(INCREMENT, tot)


def get_randao_mix(state, epoch: int) -> bytes:
    return bytes(state.randao_mixes[epoch % EPOCHS_PER_RANDAO_VECTOR])


def get_seed(state, epoch: int, domain: int) -> bytes:
    mix = get_randao_mix(
        state, epoch + EPOCHS_PER_RANDAO_VECTOR - MIN_SEED_LOOKAHEAD - 1)
    return sha(domain.to_bytes(4, "little") + epoch.to_bytes(8, "little")
               + mix)


def shuffled_index(index: int, count: int, seed: bytes) -> int:
    """compute_shuffled_index, straight from the phase0 pseudocode."""
    assert index < count
    for rnd in range(SHUFFLE_ROUNDS):
        pivot = int.from_bytes(
            sha(seed + rnd.to_bytes(1, "little"))[:8], "little") % count
        flip = (pivot + count - index) % count
        position = max(index, flip)
        source = sha(seed + rnd.to_bytes(1, "little")
                     + (position // 256).to_bytes(4, "little"))
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) % 2:
            index = flip
    return index


def get_committee(state, rows, slot: int, index: int) -> list[int]:
    """get_beacon_committee via scalar shuffle."""
    epoch = slot // SLOTS_PER_EPOCH
    active = active_indices(rows, epoch)
    seed = get_seed(state, epoch, DOMAIN_BEACON_ATTESTER)
    per_slot = max(1, min(
        4,                               # minimal max_committees_per_slot
        len(active) // SLOTS_PER_EPOCH // 4))  # target_committee_size 4
    count = per_slot * SLOTS_PER_EPOCH
    i = (slot % SLOTS_PER_EPOCH) * per_slot + index
    n = len(active)
    start = n * i // count
    end = n * (i + 1) // count
    return [active[shuffled_index(pos, n, seed)]
            for pos in range(start, end)]


def committees_per_slot(rows, epoch: int) -> int:
    active = active_indices(rows, epoch)
    return max(1, min(4, len(active) // SLOTS_PER_EPOCH // 4))


# ---------------------------------------------------------------------------
# epoch processing (altair), field by field
# ---------------------------------------------------------------------------

def unslashed_participating_indices(state, rows, flag_bit: int,
                                    epoch: int) -> list[int]:
    cur = current_epoch(state)
    part = (state.current_epoch_participation if epoch == cur
            else state.previous_epoch_participation)
    return [i for i, r in enumerate(rows)
            if is_active(r, epoch) and not r["slashed"]
            and int(part[i]) & flag_bit]


def justification_and_finalization(state) -> dict:
    """Expected {justification_bits, previous/current_justified,
    finalized} after process_justification_and_finalization."""
    epoch = current_epoch(state)
    if epoch <= 1:
        return {
            "bits": list(state.justification_bits),
            "previous_justified": (int(state.current_justified_checkpoint
                                       .epoch),
                                   bytes(state.current_justified_checkpoint
                                         .root)),
            "current_justified": (int(state.current_justified_checkpoint
                                      .epoch),
                                  bytes(state.current_justified_checkpoint
                                        .root)),
            "finalized": (int(state.finalized_checkpoint.epoch),
                          bytes(state.finalized_checkpoint.root)),
        }
    rows = vrows(state)
    total = total_active_balance(state, rows)
    prev_target = sum(
        rows[i]["effective_balance"] for i in
        unslashed_participating_indices(state, rows, TIMELY_TARGET,
                                        epoch - 1))
    cur_target = sum(
        rows[i]["effective_balance"] for i in
        unslashed_participating_indices(state, rows, TIMELY_TARGET, epoch))

    def block_root_at_epoch_start(e):
        slot = e * SLOTS_PER_EPOCH
        return bytes(state.block_roots[slot % SLOTS_PER_HISTORICAL_ROOT])

    bits = list(state.justification_bits)
    old_prev_j = (int(state.previous_justified_checkpoint.epoch),
                  bytes(state.previous_justified_checkpoint.root))
    old_cur_j = (int(state.current_justified_checkpoint.epoch),
                 bytes(state.current_justified_checkpoint.root))
    prev_j = old_cur_j
    cur_j = old_cur_j
    bits = [False] + bits[:3]
    if prev_target * 3 >= total * 2:
        cur_j = (epoch - 1, block_root_at_epoch_start(epoch - 1))
        bits[1] = True
    if cur_target * 3 >= total * 2:
        cur_j = (epoch, block_root_at_epoch_start(epoch))
        bits[0] = True
    fin = (int(state.finalized_checkpoint.epoch),
           bytes(state.finalized_checkpoint.root))
    # the four finalization rules operate on the OLD justified checkpoints
    if all(bits[1:4]) and old_prev_j[0] + 3 == epoch:
        fin = old_prev_j
    if all(bits[1:3]) and old_prev_j[0] + 2 == epoch:
        fin = old_prev_j
    if all(bits[0:3]) and old_cur_j[0] + 2 == epoch:
        fin = old_cur_j
    if all(bits[0:2]) and old_cur_j[0] + 1 == epoch:
        fin = old_cur_j
    return {"bits": bits, "previous_justified": prev_j,
            "current_justified": cur_j, "finalized": fin}


def inactivity_updates(state) -> list[int]:
    """Expected inactivity_scores."""
    epoch = current_epoch(state)
    scores = [int(s) for s in state.inactivity_scores]
    if epoch == 0:
        return scores
    rows = vrows(state)
    target = set(unslashed_participating_indices(
        state, rows, TIMELY_TARGET, epoch - 1))
    leaking = (epoch - int(state.finalized_checkpoint.epoch)
               > MIN_EPOCHS_TO_INACTIVITY_PENALTY)
    out = list(scores)
    for i, r in enumerate(rows):
        if not (is_active(r, epoch - 1)
                or (r["slashed"] and epoch - 1 < r["withdrawable_epoch"])):
            continue                    # eligible set per spec
        if i in target:
            out[i] -= min(1, out[i])
        else:
            out[i] += INACTIVITY_SCORE_BIAS
        if not leaking:
            out[i] -= min(INACTIVITY_SCORE_RECOVERY_RATE, out[i])
    return out


def base_reward_per_increment(total: int) -> int:
    return INCREMENT * BASE_REWARD_FACTOR // isqrt(total)


def rewards_and_penalties(state) -> list[int]:
    """Expected balances after process_rewards_and_penalties."""
    epoch = current_epoch(state)
    balances = [int(b) for b in state.balances]
    if epoch == 0:
        return balances
    rows = vrows(state)
    total = total_active_balance(state, rows)
    brpi = base_reward_per_increment(total)
    leaking = (epoch - int(state.finalized_checkpoint.epoch)
               > MIN_EPOCHS_TO_INACTIVITY_PENALTY)
    eligible = [i for i, r in enumerate(rows)
                if is_active(r, epoch - 1)
                or (r["slashed"] and epoch - 1 < r["withdrawable_epoch"])]
    out = list(balances)
    for flag_i, (bit, weight) in enumerate(
            zip((TIMELY_SOURCE, TIMELY_TARGET, TIMELY_HEAD), WEIGHTS)):
        participating = set(unslashed_participating_indices(
            state, rows, bit, epoch - 1))
        part_incs = sum(rows[i]["effective_balance"] // INCREMENT
                        for i in participating)
        active_incs = total // INCREMENT
        for i in eligible:
            base = (rows[i]["effective_balance"] // INCREMENT) * brpi
            if i in participating:
                if not leaking:
                    num = base * weight * part_incs
                    out[i] += num // (active_incs * WEIGHT_DENOM)
            elif bit != TIMELY_HEAD:
                out[i] -= base * weight // WEIGHT_DENOM
    # inactivity penalties
    target = set(unslashed_participating_indices(
        state, rows, TIMELY_TARGET, epoch - 1))
    scores = [int(s) for s in state.inactivity_scores]
    for i in eligible:
        if i not in target:
            num = rows[i]["effective_balance"] * scores[i]
            out[i] -= num // (INACTIVITY_SCORE_BIAS
                              * INACTIVITY_PENALTY_QUOTIENT_ALTAIR)
    return [max(0, b) for b in out]


def churn_limit(rows, epoch: int) -> int:
    return max(MIN_PER_EPOCH_CHURN,
               len(active_indices(rows, epoch)) // CHURN_QUOTIENT)


def exit_epoch_and_update(rows, epoch: int, exiting: list[int]
                          ) -> list[tuple[int, int, int]]:
    """initiate_validator_exit for each index in order; returns
    (index, exit_epoch, withdrawable_epoch) updates."""
    out = []
    exit_epochs = [r["exit_epoch"] for r in rows
                   if r["exit_epoch"] != 2**64 - 1]
    for idx in exiting:
        candidates = exit_epochs + [epoch + 1 + MAX_SEED_LOOKAHEAD]
        exit_q = max(candidates)
        churn = sum(1 for e in exit_epochs if e == exit_q)
        if churn >= churn_limit(rows, epoch):
            exit_q += 1
        exit_epochs.append(exit_q)
        out.append((idx, exit_q,
                    exit_q + MIN_VALIDATOR_WITHDRAWABILITY_DELAY))
        rows[idx]["exit_epoch"] = exit_q
        rows[idx]["withdrawable_epoch"] = \
            exit_q + MIN_VALIDATOR_WITHDRAWABILITY_DELAY
    return out


def registry_updates(state) -> list[dict]:
    """Expected registry rows after process_registry_updates (altair)."""
    rows = vrows(state)
    epoch = current_epoch(state)
    # eligibility
    for r in rows:
        if (r["activation_eligibility_epoch"] == 2**64 - 1
                and r["effective_balance"] == MAX_EFFECTIVE):
            r["activation_eligibility_epoch"] = epoch + 1
    # ejections
    ejected = [i for i, r in enumerate(rows)
               if is_active(r, epoch)
               and r["effective_balance"] <= MIN_ACTIVATION_BALANCE]
    exit_epoch_and_update(rows, epoch, ejected)
    # activation queue: eligible, finalized-confirmed, ordered
    fin = int(state.finalized_checkpoint.epoch)
    queue = sorted(
        (i for i, r in enumerate(rows)
         if r["activation_eligibility_epoch"] <= fin
         and r["activation_epoch"] == 2**64 - 1),
        key=lambda i: (rows[i]["activation_eligibility_epoch"], i))
    for i in queue[:churn_limit(rows, epoch)]:
        rows[i]["activation_epoch"] = epoch + 1 + MAX_SEED_LOOKAHEAD
    return rows


def slashings_penalties(state) -> list[int]:
    """Expected balances after process_slashings."""
    rows = vrows(state)
    epoch = current_epoch(state)
    total = total_active_balance(state, rows)
    slash_sum = sum(int(s) for s in state.slashings)
    adj = min(slash_sum * PROPORTIONAL_SLASHING_MULT_ALTAIR, total)
    out = [int(b) for b in state.balances]
    for i, r in enumerate(rows):
        if r["slashed"] and epoch + EPOCHS_PER_SLASHINGS // 2 == \
                r["withdrawable_epoch"]:
            inc = INCREMENT
            # spec order: penalty_numerator // total_balance * increment
            # (the earlier transcription divided by total//inc — an
            # increment-factor error masked by the zero-slashings altair
            # vector; caught by the r5 bellatrix transcription)
            penalty_num = r["effective_balance"] // inc * adj
            penalty = penalty_num // total * inc
            out[i] = max(0, out[i] - penalty)
    return out


def effective_balance_updates(state) -> list[int]:
    rows = vrows(state)
    out = []
    for i, r in enumerate(rows):
        bal = int(state.balances[i])
        eff = r["effective_balance"]
        hyst = INCREMENT // HYSTERESIS_QUOTIENT
        if (bal + hyst * HYSTERESIS_DOWN < eff
                or eff + hyst * HYSTERESIS_UP < bal):
            eff = min(bal - bal % INCREMENT, MAX_EFFECTIVE)
        out.append(eff)
    return out


def eth1_data_reset_expected(state):
    next_epoch = current_epoch(state) + 1
    if next_epoch % EPOCHS_PER_ETH1_PERIOD == 0:
        return []                       # votes cleared
    return None                         # unchanged


def slashings_reset_expected(state) -> tuple[int, int]:
    next_epoch = current_epoch(state) + 1
    return (next_epoch % EPOCHS_PER_SLASHINGS_VECTOR, 0)


def randao_mixes_reset_expected(state) -> tuple[int, bytes]:
    epoch = current_epoch(state)
    next_epoch = epoch + 1
    return (next_epoch % EPOCHS_PER_RANDAO_VECTOR,
            get_randao_mix(state, epoch))


def sync_committee_update_expected(state):
    """Expected (pubkeys, aggregate_pubkey) of next_sync_committee after
    process_sync_committee_updates, or None when not at a period
    boundary.  Selection via the scalar shuffle; aggregation via the
    pure-python curve oracle (independent of the vectorized path)."""
    next_epoch = current_epoch(state) + 1
    if next_epoch % EPOCHS_PER_SYNC_COMMITTEE_PERIOD != 0:
        return None
    rows = vrows(state)
    base_epoch = next_epoch + 1
    active = active_indices(rows, base_epoch)
    seed = get_seed(state, base_epoch, DOMAIN_SYNC_COMMITTEE)
    indices = []
    i = 0
    while len(indices) < SYNC_COMMITTEE_SIZE:
        pos = shuffled_index(i % len(active), len(active), seed)
        candidate = active[pos]
        rnd = sha(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        if rows[candidate]["effective_balance"] * MAX_RANDOM_BYTE >= \
                MAX_EFFECTIVE * rnd:
            indices.append(candidate)
        i += 1
    pubkeys = [bytes(state.validators.pubkeys[i]) for i in indices]
    from ..crypto.bls12_381 import g1_decompress, g1_compress
    agg = None
    for pk in pubkeys:
        pt = g1_decompress(pk)
        agg = pt if agg is None else agg.add(pt)
    return pubkeys, g1_compress(agg)


# ---------------------------------------------------------------------------
# generation-time verifiers (called by gen_corpus*)
# ---------------------------------------------------------------------------

class ScalarMismatch(AssertionError):
    pass


def _ck(cond, what):
    if not cond:
        raise ScalarMismatch(f"scalar spec disagrees on {what}")


def verify_epoch_subtransition(sub: str, pre, post) -> None:
    """Check the implementation's post against the scalar expectation for
    one epoch_processing sub-transition (pre = state at the last slot of
    an epoch, post = after running the sub-transition only)."""
    if sub == "effective_balance_updates":
        exp = effective_balance_updates(pre)
        got = [int(x) for x in post.validators.effective_balance]
        _ck(exp == got, "effective balances")
    elif sub == "slashings_reset":
        idx, val = slashings_reset_expected(pre)
        _ck(int(post.slashings[idx]) == val, "slashings reset")
    elif sub == "randao_mixes_reset":
        idx, mix = randao_mixes_reset_expected(pre)
        _ck(bytes(post.randao_mixes[idx]) == mix, "randao mixes reset")
    elif sub == "eth1_data_reset":
        exp = eth1_data_reset_expected(pre)
        if exp is not None:
            _ck(len(post.eth1_data_votes) == 0, "eth1 votes cleared")
        else:
            _ck(len(post.eth1_data_votes) == len(pre.eth1_data_votes),
                "eth1 votes unchanged")
    elif sub == "registry_updates":
        exp = registry_updates(pre)
        for i, r in enumerate(exp):
            v = post.validators
            _ck(int(v.activation_eligibility_epoch[i])
                == r["activation_eligibility_epoch"],
                f"eligibility[{i}]")
            _ck(int(v.activation_epoch[i]) == r["activation_epoch"],
                f"activation[{i}]")
            _ck(int(v.exit_epoch[i]) == r["exit_epoch"], f"exit[{i}]")
            _ck(int(v.withdrawable_epoch[i]) == r["withdrawable_epoch"],
                f"withdrawable[{i}]")
    elif sub == "sync_committee_updates":
        exp = sync_committee_update_expected(pre)
        if exp is not None:
            pubkeys, agg = exp
            got = [bytes(pk) for pk in post.next_sync_committee.pubkeys]
            _ck(got == pubkeys, "next sync committee pubkeys")
            _ck(bytes(post.next_sync_committee.aggregate_pubkey) == agg,
                "next sync committee aggregate")
    elif sub == "justification_and_finalization":
        exp = justification_and_finalization(pre)
        _ck(list(post.justification_bits) == exp["bits"],
            "justification bits")
        _ck((int(post.current_justified_checkpoint.epoch),
             bytes(post.current_justified_checkpoint.root))
            == exp["current_justified"], "current justified")
        _ck((int(post.finalized_checkpoint.epoch),
             bytes(post.finalized_checkpoint.root)) == exp["finalized"],
            "finalized")
    elif sub == "inactivity_updates":
        _ck([int(s) for s in post.inactivity_scores]
            == inactivity_updates(pre), "inactivity scores")
    elif sub == "rewards_and_penalties":
        _ck([int(b) for b in post.balances] == rewards_and_penalties(pre),
            "balances after rewards")
    elif sub == "slashings":
        _ck([int(b) for b in post.balances] == slashings_penalties(pre),
            "balances after slashings")
    else:
        raise ValueError(f"no scalar check for {sub}")


def verify_epoch_transition(pre_last_slot, post) -> None:
    """Scalar check of the COMPOSED epoch transition (sanity/slots across
    a boundary): run the scalar sub-transitions in spec order on plain
    views of `pre` and compare the fields they own against `post`."""
    jf = justification_and_finalization(pre_last_slot)
    _ck(list(post.justification_bits) == jf["bits"], "bits (composed)")
    _ck((int(post.finalized_checkpoint.epoch),
         bytes(post.finalized_checkpoint.root)) == jf["finalized"],
        "finalized (composed)")
    # balances: rewards then slashings use pre-epoch state views
    bal_after_rewards = rewards_and_penalties(pre_last_slot)
    _bal_check_possible = all(
        not (bool(pre_last_slot.validators.slashed[i]))
        for i in range(len(pre_last_slot.validators)))
    if _bal_check_possible:
        # without mid-epoch slashings the slashings step is a no-op and
        # scalar balances must match exactly
        _ck([int(b) for b in post.balances] == bal_after_rewards,
            "balances (composed)")
    _ck([int(x) for x in post.validators.effective_balance]
        == _effective_after(pre_last_slot, bal_after_rewards),
        "effective balances (composed)")


def _effective_after(pre, balances: list[int]) -> list[int]:
    rows = vrows(pre)
    out = []
    for i, r in enumerate(rows):
        bal = balances[i]
        eff = r["effective_balance"]
        hyst = INCREMENT // HYSTERESIS_QUOTIENT
        if (bal + hyst * HYSTERESIS_DOWN < eff
                or eff + hyst * HYSTERESIS_UP < bal):
            eff = min(bal - bal % INCREMENT, MAX_EFFECTIVE)
        out.append(eff)
    return out


# ---------------------------------------------------------------------------
# scalar block operations
# ---------------------------------------------------------------------------

def verify_block_header_op(pre, block, post) -> None:
    """process_block_header: header caching semantics."""
    h = post.latest_block_header
    _ck(int(h.slot) == int(block.slot), "header slot")
    _ck(int(h.proposer_index) == int(block.proposer_index),
        "header proposer")
    _ck(bytes(h.parent_root) == bytes(block.parent_root), "header parent")
    _ck(bytes(h.state_root) == b"\x00" * 32, "header state root zeroed")
    from ..ssz import htr
    _ck(bytes(h.body_root) == htr(block.body), "header body root")


def verify_voluntary_exit_op(pre, signed_exit, post) -> None:
    rows = vrows(pre)
    epoch = current_epoch(pre)
    updates = exit_epoch_and_update(
        rows, epoch, [int(signed_exit.message.validator_index)])
    idx, exit_q, wd = updates[0]
    _ck(int(post.validators.exit_epoch[idx]) == exit_q, "exit epoch")
    _ck(int(post.validators.withdrawable_epoch[idx]) == wd,
        "withdrawable epoch")


def slash_validator_expected(pre, idx: int, whistleblower: int | None,
                             proposer: int) -> dict:
    """Scalar slash_validator: returns expected balance/registry deltas."""
    rows = vrows(pre)
    epoch = current_epoch(pre)
    exit_epoch_and_update(rows, epoch, [idx])
    wd = max(rows[idx]["withdrawable_epoch"],
             epoch + EPOCHS_PER_SLASHINGS_VECTOR)
    eff = rows[idx]["effective_balance"]
    penalty = eff // MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR
    wb_reward = eff // WHISTLEBLOWER_REWARD_QUOTIENT
    prop_reward = wb_reward * PROPOSER_WEIGHT // WEIGHT_DENOM
    wb = whistleblower if whistleblower is not None else proposer
    return {
        "index": idx, "withdrawable_epoch": wd,
        "exit_epoch": rows[idx]["exit_epoch"],
        "penalty": penalty,
        "proposer": proposer, "proposer_reward": prop_reward,
        "whistleblower": wb,
        "whistleblower_reward": wb_reward - prop_reward,
        "slashings_slot": epoch % EPOCHS_PER_SLASHINGS_VECTOR,
        "slashings_add": eff,
    }


def verify_slashing_op(pre, slashed_index: int, proposer: int,
                       post) -> None:
    exp = slash_validator_expected(pre, slashed_index, None, proposer)
    _ck(bool(post.validators.slashed[slashed_index]), "slashed flag")
    _ck(int(post.validators.withdrawable_epoch[slashed_index])
        == exp["withdrawable_epoch"], "slashed withdrawable")
    _ck(int(post.slashings[exp["slashings_slot"]])
        - int(pre.slashings[exp["slashings_slot"]]) == exp["slashings_add"],
        "slashings accumulator")
    expected_bal = (int(pre.balances[slashed_index]) - exp["penalty"])
    if proposer == slashed_index:
        expected_bal += exp["proposer_reward"] + exp["whistleblower_reward"]
        _ck(int(post.balances[slashed_index]) == expected_bal,
            "self-slash balance")
    else:
        _ck(int(post.balances[slashed_index]) == expected_bal,
            "slashed balance")
        _ck(int(post.balances[proposer]) - int(pre.balances[proposer])
            == exp["proposer_reward"] + exp["whistleblower_reward"],
            "proposer reward")


def attestation_expected(pre, att) -> tuple[list[int], list[int], int]:
    """(participating indices, new flags per index, proposer reward).

    Scalar process_attestation for altair: committee from the scalar
    shuffle, timeliness from inclusion delay, flag updates and the
    proposer reward (spec pseudocode)."""
    rows = vrows(pre)
    data = att.data
    committee = get_committee(pre, rows, int(data.slot), int(data.index))
    bits = list(att.aggregation_bits)
    _ck(len(bits) == len(committee), "aggregation bits length")
    attesting = [v for v, b in zip(committee, bits) if b]
    delay = int(pre.slot) - int(data.slot)
    epoch = current_epoch(pre)
    is_current = int(data.target.epoch) == epoch
    # justified checkpoint matching determines source timeliness
    jc = (pre.current_justified_checkpoint if is_current
          else pre.previous_justified_checkpoint)
    source_ok = (int(data.source.epoch) == int(jc.epoch)
                 and bytes(data.source.root) == bytes(jc.root))
    _ck(source_ok, "attestation source must match justified")
    target_start = int(data.target.epoch) * SLOTS_PER_EPOCH
    target_ok = bytes(data.target.root) == bytes(
        pre.block_roots[target_start % SLOTS_PER_HISTORICAL_ROOT]) \
        if target_start < int(pre.slot) else \
        bytes(data.target.root) == bytes(pre.latest_block_header_root()) \
        if hasattr(pre, "latest_block_header_root") else True
    head_ok = bytes(data.beacon_block_root) == bytes(
        pre.block_roots[int(data.slot) % SLOTS_PER_HISTORICAL_ROOT]) \
        if int(data.slot) < int(pre.slot) else True
    flags = 0
    if source_ok and delay <= isqrt(SLOTS_PER_EPOCH):
        flags |= TIMELY_SOURCE
    if target_ok:                        # altair: within 32 slots, always
        flags |= TIMELY_TARGET
    if head_ok and delay == 1:
        flags |= TIMELY_HEAD
    # proposer reward: sum weights of NEWLY set flags
    part = (pre.current_epoch_participation if is_current
            else pre.previous_epoch_participation)
    total = total_active_balance(pre, rows)
    brpi = base_reward_per_increment(total)
    reward_num = 0
    for v in attesting:
        have = int(part[v])
        for bit, weight in zip((TIMELY_SOURCE, TIMELY_TARGET, TIMELY_HEAD),
                               WEIGHTS):
            if flags & bit and not have & bit:
                base = rows[v]["effective_balance"] // INCREMENT * brpi
                reward_num += base * weight
    prop_reward = (reward_num // WEIGHT_DENOM) * PROPOSER_WEIGHT \
        // (WEIGHT_DENOM - PROPOSER_WEIGHT)
    return attesting, flags, prop_reward


def verify_upgrade(pre, post, expected_prev: bytes, expected_cur: bytes
                   ) -> None:
    """Scalar check of an in-place fork upgrade: version rotation, epoch
    stamping, and preservation of the registry/balances (the upgrade
    functions must only rotate versions and initialize new fields)."""
    _ck(bytes(post.fork.previous_version) == expected_prev,
        "upgrade previous_version")
    _ck(bytes(post.fork.current_version) == expected_cur,
        "upgrade current_version")
    _ck(int(post.fork.epoch) == current_epoch(pre), "upgrade fork epoch")
    _ck(int(post.slot) == int(pre.slot), "upgrade slot unchanged")
    _ck(len(post.validators) == len(pre.validators),
        "upgrade registry size")
    _ck([int(b) for b in post.balances] == [int(b) for b in pre.balances],
        "upgrade balances unchanged")
    _ck([int(x) for x in post.validators.effective_balance]
        == [int(x) for x in pre.validators.effective_balance],
        "upgrade effective balances unchanged")


def verify_genesis_registry(deposit_rows: list[tuple[bytes, bytes, int]],
                            post) -> None:
    """Scalar check of genesis-state registry construction from deposits:
    (pubkey, withdrawal_credentials, amount) rows -> validator rows +
    balances + activations, straight from initialize_beacon_state /
    apply_deposit pseudocode (first-deposit-wins per pubkey)."""
    seen: dict[bytes, int] = {}
    balances: list[int] = []
    rows: list[dict] = []
    for pk, wc, amount in deposit_rows:
        if pk in seen:
            balances[seen[pk]] += amount
            continue
        seen[pk] = len(rows)
        eff = min(amount - amount % INCREMENT, MAX_EFFECTIVE)
        rows.append({"pubkey": pk, "wc": wc, "eff": eff})
        balances.append(amount)
    # genesis activation: validators at max effective balance activate
    for r in rows:
        r["active"] = r["eff"] == MAX_EFFECTIVE
    _ck(len(post.validators) == len(rows), "genesis registry size")
    for i, r in enumerate(rows):
        v = post.validators
        _ck(bytes(v.pubkeys[i]) == r["pubkey"], f"genesis pubkey[{i}]")
        _ck(int(v.effective_balance[i]) == r["eff"],
            f"genesis effective balance[{i}]")
        _ck(int(post.balances[i]) == balances[i], f"genesis balance[{i}]")
        if r["active"]:
            _ck(int(v.activation_epoch[i]) == 0, f"genesis active[{i}]")
    _ck(bytes(post.fork.current_version)
        == bytes(post.fork.previous_version), "genesis fork versions")


def verify_attestation_op(pre, att, post) -> None:
    attesting, flags, prop_reward = attestation_expected(pre, att)
    is_current = int(att.data.target.epoch) == current_epoch(pre)
    pre_part = (pre.current_epoch_participation if is_current
                else pre.previous_epoch_participation)
    post_part = (post.current_epoch_participation if is_current
                 else post.previous_epoch_participation)
    att_set = set(attesting)
    for i in range(len(pre_part)):
        want = int(pre_part[i]) | (flags if i in att_set else 0)
        _ck(int(post_part[i]) == want, f"participation[{i}]")
