"""Beacon chain accessors/mutators (spec helpers).

Reference: consensus/state_processing + the accessor impls under
consensus/types/src/beacon_state.rs. Array-oriented: everything that sweeps
validators is a numpy column operation on the SoA BeaconState.
"""
from __future__ import annotations

import hashlib
import math
import threading
from collections import OrderedDict

import numpy as np

from ..containers.state import BeaconState
from ..specs.chain_spec import ForkName, compute_domain
from ..specs.constants import (
    BASE_REWARDS_PER_EPOCH, COMPOUNDING_WITHDRAWAL_PREFIX,
    DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER,
    ETH1_ADDRESS_WITHDRAWAL_PREFIX, FAR_FUTURE_EPOCH, GENESIS_EPOCH,
    PROPOSER_WEIGHT, WEIGHT_DENOMINATOR,
)
from .shuffle import compute_shuffled_index_batch, compute_shuffled_indices


class StateError(Exception):
    pass


def integer_squareroot(n: int) -> int:
    return math.isqrt(n)


def compute_epoch_at_slot(slot: int, slots_per_epoch: int) -> int:
    return slot // slots_per_epoch


def compute_start_slot_at_epoch(epoch: int, slots_per_epoch: int) -> int:
    return epoch * slots_per_epoch


def compute_activation_exit_epoch(epoch: int, max_seed_lookahead: int) -> int:
    return epoch + 1 + max_seed_lookahead


# -- validator predicates (vectorized over columns) --------------------------

def is_active_validator_mask(state: BeaconState, epoch: int) -> np.ndarray:
    v = state.validators
    return (v.activation_epoch <= epoch) & (epoch < v.exit_epoch)


def get_active_validator_indices(state: BeaconState, epoch: int) -> np.ndarray:
    return np.flatnonzero(is_active_validator_mask(state, epoch))


def is_slashable_validator(state: BeaconState, index: int, epoch: int) -> bool:
    v = state.validators.view(index)
    return (not v.slashed and v.activation_epoch <= epoch
            and epoch < v.withdrawable_epoch)


def get_total_balance(state: BeaconState, indices: np.ndarray) -> int:
    inc = state.T.preset.effective_balance_increment
    total = int(state.validators.effective_balance[indices].sum())
    return max(inc, total)


def get_total_active_balance(state: BeaconState) -> int:
    """Cached per epoch on the state instance (total-active-balance cache,
    mirrors the reference's progressive balances cache). Effective balances
    only change at epoch boundaries, so the epoch key is sufficient."""
    epoch = state.current_epoch()
    cache = getattr(state, "_tab_cache", None)
    if cache is not None and cache[0] == epoch:
        return cache[1]
    total = get_total_balance(
        state, get_active_validator_indices(state, epoch))
    state._tab_cache = (epoch, total)
    return total


def increase_balance(state: BeaconState, index: int, delta: int) -> None:
    state.balances[index] = int(state.balances[index]) + delta
    state.mark_balances_dirty(index)


def decrease_balance(state: BeaconState, index: int, delta: int) -> None:
    cur = int(state.balances[index])
    state.balances[index] = 0 if delta > cur else cur - delta
    state.mark_balances_dirty(index)


def latest_block_header_root(state: BeaconState) -> bytes:
    """Root of the latest block, filling in the state root if not yet set
    (it is zeroed by process_block_header until the next process_slot)."""
    from ..ssz import htr
    hdr = state.latest_block_header
    if hdr.state_root == b"\x00" * 32:
        hdr = state.T.BeaconBlockHeader(
            slot=hdr.slot, proposer_index=hdr.proposer_index,
            parent_root=hdr.parent_root, state_root=state.hash_tree_root(),
            body_root=hdr.body_root)
    return htr(hdr)


# -- randomness / seeds ------------------------------------------------------

def get_seed(state: BeaconState, epoch: int, domain_type: int) -> bytes:
    p = state.T.preset
    mix = state.get_randao_mix(
        epoch + p.epochs_per_historical_vector - p.min_seed_lookahead - 1)
    return hashlib.sha256(
        domain_type.to_bytes(4, "little") + epoch.to_bytes(8, "little") + mix
    ).digest()


# -- committees --------------------------------------------------------------

def get_committee_count_per_slot(state: BeaconState, epoch: int) -> int:
    p = state.T.preset
    n_active = len(get_active_validator_indices(state, epoch))
    return max(1, min(
        p.max_committees_per_slot,
        n_active // p.slots_per_epoch // p.target_committee_size))


class CommitteeCache:
    """Shuffling + committee layout for one epoch.

    Equivalent of consensus/types/src/beacon_state/committee_cache.rs.
    The whole layout is precomputed: the shuffled vector plus the
    committee boundary table, so `committee()` is two table lookups and a
    slice. Instances are immutable after construction and shared across
    states through the process-wide shuffling cache below.
    """

    def __init__(self, state: BeaconState, epoch: int,
                 active: np.ndarray | None = None,
                 seed: bytes | None = None):
        p = state.T.preset
        self.epoch = epoch
        self.active = (active if active is not None
                       else get_active_validator_indices(state, epoch))
        self.seed = (seed if seed is not None
                     else get_seed(state, epoch, DOMAIN_BEACON_ATTESTER))
        sigma = compute_shuffled_indices(
            len(self.active), self.seed, p.shuffle_round_count)
        self.shuffled = self.active[sigma]
        self.committees_per_slot = max(1, min(
            p.max_committees_per_slot,
            len(self.active) // p.slots_per_epoch // p.target_committee_size))
        self.slots_per_epoch = p.slots_per_epoch
        count = self.committees_per_slot * self.slots_per_epoch
        self._bounds = (len(self.shuffled)
                        * np.arange(count + 1, dtype=np.int64)) // count

    def committee(self, slot: int, index: int) -> np.ndarray:
        i = (slot % self.slots_per_epoch) * self.committees_per_slot + index
        return self.shuffled[self._bounds[i]:self._bounds[i + 1]]

    def committees_at_slot(self, slot: int) -> list[np.ndarray]:
        return [self.committee(slot, i)
                for i in range(self.committees_per_slot)]


class _SharedShufflingCache:
    """Process-wide (seed, epoch, n_active) -> CommitteeCache.

    The per-state `_committee_caches` dict dies with its state: sibling
    states, advanced clones, and replayed forks each re-shuffled the full
    permutation for the SAME shuffling. The seed already commits to the
    randao decision point, so it plays the role of the reference's
    shuffling decision root (shuffle_cache.rs keying); the active-set
    length rides in the key and the full active vector is confirmed on
    hit before an entry is shared.
    """

    SIZE = 16

    def __init__(self):
        self._cache: OrderedDict[tuple, CommitteeCache] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple) -> CommitteeCache | None:
        with self._lock:
            cc = self._cache.get(key)
            if cc is not None:
                self._cache.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        return cc

    def insert(self, key: tuple, cc: CommitteeCache) -> None:
        with self._lock:
            self._cache[key] = cc
            self._cache.move_to_end(key)
            while len(self._cache) > self.SIZE:
                self._cache.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self.hits = 0
            self.misses = 0


shared_shufflings = _SharedShufflingCache()


def committee_cache(state: BeaconState, epoch: int) -> CommitteeCache:
    caches = getattr(state, "_committee_caches", None)
    if caches is None:
        caches = {}
        state._committee_caches = caches
    c = caches.get(epoch)
    if c is None or c.epoch != epoch:
        active = get_active_validator_indices(state, epoch)
        seed = get_seed(state, epoch, DOMAIN_BEACON_ATTESTER)
        key = (seed, epoch, len(active))
        c = shared_shufflings.get(key)
        if c is not None and not np.array_equal(c.active, active):
            c = None                    # seed collision across active sets
        if c is None:
            c = CommitteeCache(state, epoch, active=active, seed=seed)
            shared_shufflings.insert(key, c)
        caches[epoch] = c
        # keep at most 3 epochs (previous, current, next)
        for k in sorted(caches):
            if len(caches) <= 3:
                break
            del caches[k]
    return c


def get_beacon_committee(state: BeaconState, slot: int,
                         index: int) -> np.ndarray:
    epoch = compute_epoch_at_slot(slot, state.slots_per_epoch)
    cache = committee_cache(state, epoch)
    if index >= cache.committees_per_slot:
        raise StateError(f"committee index {index} out of range")
    return cache.committee(slot, index)


# -- proposer selection ------------------------------------------------------

#: candidates sampled per batch round; a multiple of 32 (and 16) so draws
#: stay digest-aligned for both the 1-byte and 2-byte randomness widths
_SAMPLE_BATCH = 1024


def _candidate_randomness(seed: bytes, i0: int, count: int,
                          electra: bool) -> np.ndarray:
    """Rejection-sampling draws r_i for candidates [i0, i0+count).

    One SHA-256 of seed||u64(hash_index) covers 16 two-byte draws
    (electra) or 32 one-byte draws; all digests for the window go through
    the native short-message batch in one FFI call, with a hashlib loop
    as fallback.  `i0` and `count` must be digest-aligned (multiples of
    32), which `_SAMPLE_BATCH` guarantees.
    """
    from ..utils.native_hash import hash_short_batch
    per = 16 if electra else 32
    h0, h1 = i0 // per, (i0 + count) // per
    msgs = np.empty((h1 - h0, 40), np.uint8)
    msgs[:, :32] = np.frombuffer(seed, np.uint8)
    msgs[:, 32:] = np.arange(h0, h1, dtype="<u8").view(np.uint8) \
        .reshape(h1 - h0, 8)
    raw = hash_short_batch(msgs.tobytes(), 40)
    if raw is None:
        raw = b"".join(
            hashlib.sha256(seed + h.to_bytes(8, "little")).digest()
            for h in range(h0, h1))
    if electra:
        return np.frombuffer(raw, dtype="<u2").astype(np.int64)
    return np.frombuffer(raw, dtype=np.uint8).astype(np.int64)


def compute_proposer_index(state: BeaconState, indices: np.ndarray,
                           seed: bytes) -> int:
    """First shuffled candidate accepted by effective-balance rejection
    sampling — the scalar spec loop evaluated a batch at a time (the
    acceptance order is preserved, so the result is bit-identical)."""
    if len(indices) == 0:
        raise StateError("no active validators")
    p = state.T.preset
    n = len(indices)
    # the seed folds in the slot, so this shuffle is queried once and
    # thrown away: above a few batches' worth of indices, evaluating
    # sigma only at the sampled positions beats shuffling the whole set
    sigma = (None if n > 8 * _SAMPLE_BATCH
             else compute_shuffled_indices(n, seed, p.shuffle_round_count))
    eb = state.validators.effective_balance
    electra = state.fork_name >= ForkName.ELECTRA
    max_eb = (p.max_effective_balance_electra if electra
              else p.max_effective_balance)
    scale = 65535 if electra else 255
    offsets = np.arange(_SAMPLE_BATCH)
    i0 = 0
    while True:
        pos = (i0 + offsets) % n
        src = (compute_shuffled_index_batch(pos, n, seed,
                                            p.shuffle_round_count)
               if sigma is None else sigma[pos])
        candidates = indices[src]
        r = _candidate_randomness(seed, i0, _SAMPLE_BATCH, electra)
        ok = np.flatnonzero(
            eb[candidates].astype(np.int64) * scale >= max_eb * r)
        if ok.size:
            return int(candidates[ok[0]])
        i0 += _SAMPLE_BATCH


def get_beacon_proposer_index(state: BeaconState, slot: int | None = None
                              ) -> int:
    """Cached per slot (beacon-proposer-cache analog,
    beacon_chain/src/beacon_proposer_cache.rs): the active set and effective
    balances that determine the proposer are fixed within a slot."""
    slot = state.slot if slot is None else slot
    cache = getattr(state, "_proposer_cache", None)
    if cache is None:
        cache = {}
        state._proposer_cache = cache
    hit = cache.get(slot)
    if hit is not None:
        return hit
    epoch = compute_epoch_at_slot(slot, state.slots_per_epoch)
    seed = hashlib.sha256(
        get_seed(state, epoch, DOMAIN_BEACON_PROPOSER)
        + slot.to_bytes(8, "little")).digest()
    indices = get_active_validator_indices(state, epoch)
    out = compute_proposer_index(state, indices, seed)
    cache.clear()
    cache[slot] = out
    return out


# -- attestations ------------------------------------------------------------

def attesting_indices_from_committees(committee_at, attestation,
                                      electra: bool) -> np.ndarray:
    """Sorted unique attesting indices, parameterized over the committee
    source (`committee_at(slot, index) -> np.ndarray`) so the chain-level
    ShufflingCache can serve lookups without a state replay."""
    data = attestation.data
    if electra and hasattr(attestation, "committee_bits"):
        out = []
        offset = 0
        bits = attestation.aggregation_bits
        for committee_index, present in enumerate(attestation.committee_bits):
            if not present:
                continue
            committee = committee_at(data.slot, committee_index)
            sel = [committee[i] for i in range(len(committee))
                   if offset + i < len(bits) and bits[offset + i]]
            out.extend(int(x) for x in sel)
            offset += len(committee)
        return np.asarray(sorted(set(out)), dtype=np.int64)
    committee = committee_at(data.slot, data.index)
    bits = attestation.aggregation_bits
    if len(bits) != len(committee):
        raise StateError("aggregation bits length != committee size")
    mask = np.asarray(bits, dtype=bool)
    return np.sort(committee[mask])


def get_attesting_indices(state: BeaconState, attestation) -> np.ndarray:
    """Sorted unique indices that attested (fork-aware: electra committee_bits)."""
    return attesting_indices_from_committees(
        lambda s, i: get_beacon_committee(state, s, i), attestation,
        state.fork_name >= ForkName.ELECTRA)


def get_indexed_attestation(state: BeaconState, attestation):
    T = state.T
    indices = [int(i) for i in get_attesting_indices(state, attestation)]
    cls = (T.IndexedAttestationElectra
           if state.fork_name >= ForkName.ELECTRA else T.IndexedAttestation)
    return cls(attesting_indices=indices, data=attestation.data,
               signature=attestation.signature)


def indexed_attestation_is_structurally_valid(indexed) -> bool:
    idx = indexed.attesting_indices
    if not idx:
        return False
    return all(idx[i] < idx[i + 1] for i in range(len(idx) - 1))


def is_slashable_attestation_data(d1, d2) -> bool:
    from ..ssz import htr
    double = (htr(d1) != htr(d2)) and d1.target.epoch == d2.target.epoch
    surround = (d1.source.epoch < d2.source.epoch
                and d2.target.epoch < d1.target.epoch)
    return double or surround


# -- domains -----------------------------------------------------------------

def get_domain(state: BeaconState, domain_type: int,
               epoch: int | None = None) -> bytes:
    epoch = state.current_epoch() if epoch is None else epoch
    fork = state.fork
    version = (fork.previous_version if epoch < fork.epoch
               else fork.current_version)
    return compute_domain(domain_type, version, state.genesis_validators_root)


# -- churn / exits -----------------------------------------------------------

def get_validator_churn_limit(state: BeaconState) -> int:
    active = len(get_active_validator_indices(state, state.current_epoch()))
    return state.spec.churn_limit(active)


def get_validator_activation_churn_limit(state: BeaconState) -> int:
    active = len(get_active_validator_indices(state, state.current_epoch()))
    if state.fork_name >= ForkName.DENEB:
        return state.spec.activation_churn_limit(active)
    return state.spec.churn_limit(active)


def initiate_validator_exit(state: BeaconState, index: int) -> None:
    v = state.validators
    if int(v.exit_epoch[index]) != FAR_FUTURE_EPOCH:
        return
    spec = state.spec
    p = state.T.preset
    if state.fork_name >= ForkName.ELECTRA:
        exit_epoch = compute_exit_epoch_and_update_churn(
            state, int(v.effective_balance[index]))
    else:
        exit_epochs = v.exit_epoch[v.exit_epoch != np.uint64(FAR_FUTURE_EPOCH)]
        candidate = compute_activation_exit_epoch(
            state.current_epoch(), p.max_seed_lookahead)
        exit_queue_epoch = max(
            int(exit_epochs.max()) if len(exit_epochs) else 0, candidate)
        churn = int((exit_epochs == np.uint64(exit_queue_epoch)).sum())
        if churn >= get_validator_churn_limit(state):
            exit_queue_epoch += 1
        exit_epoch = exit_queue_epoch
    v.set_field(index, "exit_epoch", exit_epoch)
    v.set_field(index, "withdrawable_epoch",
                exit_epoch + spec.min_validator_withdrawability_delay)


# -- electra churn -----------------------------------------------------------

def get_balance_churn_limit(state: BeaconState) -> int:
    return state.spec.balance_churn_limit(get_total_active_balance(state))


def get_activation_exit_churn_limit(state: BeaconState) -> int:
    return min(state.spec.max_per_epoch_activation_exit_churn_limit,
               get_balance_churn_limit(state))


def get_consolidation_churn_limit(state: BeaconState) -> int:
    return get_balance_churn_limit(state) - \
        get_activation_exit_churn_limit(state)


def compute_exit_epoch_and_update_churn(state: BeaconState,
                                        exit_balance: int) -> int:
    p = state.T.preset
    earliest = max(state.earliest_exit_epoch,
                   compute_activation_exit_epoch(state.current_epoch(),
                                                 p.max_seed_lookahead))
    per_epoch_churn = get_activation_exit_churn_limit(state)
    if state.earliest_exit_epoch < earliest:
        balance_to_consume = per_epoch_churn
    else:
        balance_to_consume = state.exit_balance_to_consume
    if exit_balance > balance_to_consume:
        balance_to_process = exit_balance - balance_to_consume
        additional_epochs = (balance_to_process - 1) // per_epoch_churn + 1
        earliest += additional_epochs
        balance_to_consume += additional_epochs * per_epoch_churn
    state.exit_balance_to_consume = balance_to_consume - exit_balance
    state.earliest_exit_epoch = earliest
    return earliest


def compute_consolidation_epoch_and_update_churn(
        state: BeaconState, consolidation_balance: int) -> int:
    p = state.T.preset
    earliest = max(state.earliest_consolidation_epoch,
                   compute_activation_exit_epoch(state.current_epoch(),
                                                 p.max_seed_lookahead))
    per_epoch = get_consolidation_churn_limit(state)
    if state.earliest_consolidation_epoch < earliest:
        balance_to_consume = per_epoch
    else:
        balance_to_consume = state.consolidation_balance_to_consume
    if consolidation_balance > balance_to_consume:
        to_process = consolidation_balance - balance_to_consume
        additional_epochs = (to_process - 1) // per_epoch + 1
        earliest += additional_epochs
        balance_to_consume += additional_epochs * per_epoch
    state.consolidation_balance_to_consume = \
        balance_to_consume - consolidation_balance
    state.earliest_consolidation_epoch = earliest
    return earliest


# -- slashing ----------------------------------------------------------------

def slash_validator(state: BeaconState, slashed_index: int,
                    whistleblower_index: int | None = None) -> None:
    p = state.T.preset
    F = ForkName
    epoch = state.current_epoch()
    initiate_validator_exit(state, slashed_index)
    v = state.validators
    v.set_field(slashed_index, "slashed", True)
    v.set_field(slashed_index, "withdrawable_epoch",
                max(int(v.withdrawable_epoch[slashed_index]),
                    epoch + p.epochs_per_slashings_vector))
    eff = int(v.effective_balance[slashed_index])
    state.slashings[epoch % p.epochs_per_slashings_vector] = \
        int(state.slashings[epoch % p.epochs_per_slashings_vector]) + eff
    if state.fork_name >= F.ELECTRA:
        quotient = p.min_slashing_penalty_quotient_electra
    elif state.fork_name >= F.BELLATRIX:
        quotient = p.min_slashing_penalty_quotient_bellatrix
    elif state.fork_name >= F.ALTAIR:
        quotient = p.min_slashing_penalty_quotient_altair
    else:
        quotient = p.min_slashing_penalty_quotient
    decrease_balance(state, slashed_index, eff // quotient)

    proposer_index = get_beacon_proposer_index(state)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    wb_quotient = (p.whistleblower_reward_quotient_electra
                   if state.fork_name >= F.ELECTRA
                   else p.whistleblower_reward_quotient)
    whistleblower_reward = eff // wb_quotient
    if state.fork_name >= F.ALTAIR:
        proposer_reward = whistleblower_reward * PROPOSER_WEIGHT \
            // WEIGHT_DENOMINATOR
    else:
        proposer_reward = whistleblower_reward // p.proposer_reward_quotient
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index,
                     whistleblower_reward - proposer_reward)


# -- rewards -----------------------------------------------------------------

def get_base_reward_per_increment(state: BeaconState,
                                  total_active_balance: int) -> int:
    p = state.T.preset
    return (p.effective_balance_increment * p.base_reward_factor
            // integer_squareroot(total_active_balance))


def get_base_reward_altair(state: BeaconState, index: int,
                           total_active_balance: int) -> int:
    p = state.T.preset
    increments = int(state.validators.effective_balance[index]) \
        // p.effective_balance_increment
    return increments * get_base_reward_per_increment(state,
                                                      total_active_balance)


def get_base_reward_phase0(state: BeaconState, index: int,
                           total_active_balance: int) -> int:
    p = state.T.preset
    eff = int(state.validators.effective_balance[index])
    return (eff * p.base_reward_factor
            // integer_squareroot(total_active_balance)
            // BASE_REWARDS_PER_EPOCH)


# -- participation flags (altair) --------------------------------------------

def has_flag(flags: int, flag_index: int) -> bool:
    return bool(flags & (1 << flag_index))


def add_flag(flags: int, flag_index: int) -> int:
    return flags | (1 << flag_index)


# -- withdrawal credentials --------------------------------------------------

def has_eth1_withdrawal_credential(wc: bytes) -> bool:
    return wc[0] == ETH1_ADDRESS_WITHDRAWAL_PREFIX


def has_compounding_withdrawal_credential(wc: bytes) -> bool:
    return wc[0] == COMPOUNDING_WITHDRAWAL_PREFIX


def has_execution_withdrawal_credential(wc: bytes) -> bool:
    return has_eth1_withdrawal_credential(wc) or \
        has_compounding_withdrawal_credential(wc)


def get_max_effective_balance(state: BeaconState, wc: bytes) -> int:
    p = state.T.preset
    if state.fork_name >= ForkName.ELECTRA:
        if has_compounding_withdrawal_credential(wc):
            return p.max_effective_balance_electra
        return p.min_activation_balance
    return p.max_effective_balance


def get_pending_balance_to_withdraw(state: BeaconState, index: int) -> int:
    return sum(w.amount for w in state.pending_partial_withdrawals
               if w.validator_index == index)


# -- sync committees (altair) ------------------------------------------------

def get_next_sync_committee_indices(state: BeaconState) -> list[int]:
    from ..specs.constants import DOMAIN_SYNC_COMMITTEE
    p = state.T.preset
    epoch = state.current_epoch() + 1
    indices = get_active_validator_indices(state, epoch)
    n = len(indices)
    seed = get_seed(state, epoch, DOMAIN_SYNC_COMMITTEE)
    sigma = compute_shuffled_indices(n, seed, p.shuffle_round_count)
    eb = state.validators.effective_balance
    electra = state.fork_name >= ForkName.ELECTRA
    max_eb = (p.max_effective_balance_electra if electra
              else p.max_effective_balance)
    scale = 65535 if electra else 255
    offsets = np.arange(_SAMPLE_BATCH)
    out: list[int] = []
    i0 = 0
    while len(out) < p.sync_committee_size:
        candidates = indices[sigma[(i0 + offsets) % n]]
        r = _candidate_randomness(seed, i0, _SAMPLE_BATCH, electra)
        ok = eb[candidates].astype(np.int64) * scale >= max_eb * r
        out.extend(int(c) for c in candidates[ok])
        i0 += _SAMPLE_BATCH
    return out[:p.sync_committee_size]


def get_next_sync_committee(state: BeaconState):
    from ..crypto.bls import aggregate_public_keys
    T = state.T
    indices = get_next_sync_committee_indices(state)
    pubkeys = [state.validators.pubkeys[i].tobytes() for i in indices]
    agg = aggregate_public_keys(pubkeys)
    return T.SyncCommittee(pubkeys=pubkeys, aggregate_pubkey=agg)
