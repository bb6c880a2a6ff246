"""Hot-slot caches: what makes the reference fast at slot boundaries.

Reference analogs:

- ShufflingCache        beacon_node/beacon_chain/src/shuffling_cache.rs:1-40
- BeaconProposerCache   beacon_node/beacon_chain/src/beacon_proposer_cache.rs
- EarlyAttesterCache    beacon_node/beacon_chain/src/early_attester_cache.rs:1-30
- AttesterCache         beacon_node/beacon_chain/src/attester_cache.rs:1-60
- Eth1FinalizationCache beacon_node/beacon_chain/src/eth1_finalization_cache.rs
- PreFinalizationCache  beacon_node/beacon_chain/src/pre_finalization_cache.rs
- StateAdvanceTimer     beacon_node/beacon_chain/src/state_advance_timer.rs:1-15
                        (the per-slot hook lives in BeaconChain.per_slot_task)

Keying note: the reference keys shufflings/proposers by the *shuffling
decision root* (the block root at the last slot of the prior epoch), which
dedupes across forks that share that ancestor.  We key by the attestation's
target checkpoint / the block root the state was derived from — an alias
that uniquely DETERMINES the decision root (the chain below a block is
fixed), so correctness is identical; forks briefly duplicate entries, which
a 16-entry LRU absorbs.  The benefit: no ancestry walk at lookup time.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from ..state_transition import process_slots
from ..state_transition.helpers import (
    CommitteeCache, StateError, committee_cache, compute_epoch_at_slot,
    compute_start_slot_at_epoch, get_beacon_proposer_index,
    get_committee_count_per_slot,
)


class ShufflingCache:
    """(target_root, target_epoch) -> CommitteeCache.

    Gossip attestation verification is the highest-rate consumer of
    committees; with this cache the per-attestation cost is a dict hit
    instead of a state copy + slot replay (shuffling_cache.rs promise).
    """

    SIZE = 16

    def __init__(self):
        self._cache: OrderedDict[tuple, CommitteeCache] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, target_root: bytes, epoch: int) -> CommitteeCache | None:
        with self._lock:
            cc = self._cache.get((target_root, epoch))
            if cc is not None:
                self._cache.move_to_end((target_root, epoch))
                self.hits += 1
            else:
                self.misses += 1
            return cc

    def insert(self, target_root: bytes, epoch: int,
               cc: CommitteeCache) -> None:
        with self._lock:
            self._cache[(target_root, epoch)] = cc
            self._cache.move_to_end((target_root, epoch))
            while len(self._cache) > self.SIZE:
                self._cache.popitem(last=False)

    def get_or_build(self, chain, data) -> CommitteeCache:
        """Committees for an attestation's target, via cache or one state
        replay (the miss path primes the cache for every later attestation
        sharing the shuffling decision root — all targets of the epoch on
        the same chain, across forks that share the pre-epoch ancestor)."""
        epoch = data.target.epoch
        spe = chain.spec.preset.slots_per_epoch
        decision_slot = compute_start_slot_at_epoch(epoch, spe) - 1
        dec = chain.fork_choice.proto_array.ancestor_at_or_below_slot(
            data.target.root, decision_slot)
        key_root = dec if dec is not None else data.target.root
        cc = self.get(key_root, epoch)
        if cc is None:
            state = chain.state_for_attestation(data)
            cc = committee_cache(state, epoch)
            self.insert(key_root, epoch, cc)
        return cc


class ProposerCache:
    """(block_root, epoch) -> {slot: proposer_index} for a whole epoch.

    Gossip block verification needs only the expected proposer — replaying
    the parent state per block is the cost this kills
    (beacon_proposer_cache.rs).  Keyed by the block root the epoch's
    shuffling was derived from (any block in or before the epoch on the
    same chain yields identical proposers; callers use the parent root).
    """

    SIZE = 16

    def __init__(self):
        self._cache: OrderedDict[tuple, dict[int, int]] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, root: bytes, epoch: int) -> dict[int, int] | None:
        with self._lock:
            d = self._cache.get((root, epoch))
            if d is not None:
                self._cache.move_to_end((root, epoch))
                self.hits += 1
            else:
                self.misses += 1
            return d

    def insert(self, root: bytes, epoch: int, proposers: dict) -> None:
        with self._lock:
            self._cache[(root, epoch)] = proposers
            self._cache.move_to_end((root, epoch))
            while len(self._cache) > self.SIZE:
                self._cache.popitem(last=False)

    def proposer_at(self, chain, parent_root: bytes, slot: int) -> int:
        """Expected proposer of `slot` on the chain of `parent_root`.  A
        miss advances the parent state once and primes the WHOLE epoch
        (proposer selection depends only on the epoch's seed + active set
        + effective balances, all fixed at the epoch boundary).  Keyed by
        the decision root so consecutive blocks in an epoch all hit."""
        spe = chain.spec.preset.slots_per_epoch
        epoch = compute_epoch_at_slot(slot, spe)
        decision_slot = compute_start_slot_at_epoch(epoch, spe) - 1
        dec = chain.fork_choice.proto_array.ancestor_at_or_below_slot(
            parent_root, decision_slot)
        key_root = dec if dec is not None else parent_root
        hit = self.get(key_root, epoch)
        if hit is not None and slot in hit:
            return hit[slot]
        state = chain.state_for_block_production(parent_root, slot)
        start = compute_start_slot_at_epoch(epoch, spe)
        proposers = {s: get_beacon_proposer_index(state, s)
                     for s in range(start, start + spe)}
        self.insert(key_root, epoch, proposers)
        return proposers[slot]


class EarlyAttesterCacheEntry:
    __slots__ = ("block_root", "slot", "epoch", "source", "target",
                 "committees_per_slot")

    def __init__(self, block_root, slot, epoch, source, target,
                 committees_per_slot):
        self.block_root = block_root
        self.slot = slot
        self.epoch = epoch
        self.source = source
        self.target = target
        self.committees_per_slot = committees_per_slot


class EarlyAttesterCache:
    """Serve attestation data for the latest imported block without
    touching any state (early_attester_cache.rs:1-30: the reference fills
    it between consensus verification and full import so validators can
    attest to a block the instant it is known-good; our import is
    synchronous, so we fill it at import time and every later
    `produce_attestation_data` in the epoch is state-free)."""

    def __init__(self):
        self._entry: EarlyAttesterCacheEntry | None = None
        self._lock = threading.Lock()

    def add(self, chain, block_root: bytes, block, state) -> None:
        spe = state.slots_per_epoch
        epoch = compute_epoch_at_slot(block.slot, spe)
        epoch_start = compute_start_slot_at_epoch(epoch, spe)
        if block.slot <= epoch_start:
            target_root = block_root
        else:
            target_root = state.get_block_root_at_slot(epoch_start)
        with self._lock:
            self._entry = EarlyAttesterCacheEntry(
                block_root, block.slot, epoch,
                (int(state.current_justified_checkpoint.epoch),
                 bytes(state.current_justified_checkpoint.root)),
                (epoch, target_root),
                get_committee_count_per_slot(state, epoch))

    def try_attest(self, chain, slot: int, committee_index: int):
        """AttestationData if the current head is the cached block and the
        request is in its epoch; None -> caller falls back to state."""
        with self._lock:
            e = self._entry
        if e is None:
            return None
        spe = chain.spec.preset.slots_per_epoch
        if compute_epoch_at_slot(slot, spe) != e.epoch or slot < e.slot:
            return None
        head_root = chain.head().head_block_root
        if head_root != e.block_root:
            return None
        if committee_index >= e.committees_per_slot:
            raise StateError(
                f"committee index {committee_index} out of range "
                f"(epoch {e.epoch} has {e.committees_per_slot} "
                "committees per slot)")
        T = chain.T
        return T.AttestationData(
            slot=slot, index=committee_index,
            beacon_block_root=e.block_root,
            source=T.Checkpoint(epoch=e.source[0], root=e.source[1]),
            target=T.Checkpoint(epoch=e.target[0], root=e.target[1]))


class AttesterCache:
    """Serve attestation data for a slot whose epoch is already decided on
    the head chain WITHOUT any state read or replay
    (beacon_chain/src/attester_cache.rs:1-60).

    The only state-derived fields of AttestationData are the source
    (justified) checkpoint and the committee bound, both fixed per
    (epoch, decision_root) where decision_root is the head-chain block
    root at the last slot of the previous epoch; beacon_block_root and
    the target root come from fork choice (proto-array ancestor walk).
    Primed at block import and by the state-advance timer; the state
    fallback path also primes it so a given (epoch, chain) replays at
    most once.  A committee_index outside the epoch's committees-per-slot
    raises StateError instead of silently serving data no committee can
    sign (attester_cache.rs CommitteeLengths::get_committee_length).
    """

    SIZE = 16

    def __init__(self):
        # (epoch, droot) -> (src_epoch, src_root, committees_per_slot)
        self._map: OrderedDict[tuple[int, bytes],
                               tuple[int, bytes, int]] = OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def _decision_slot(epoch: int, spe: int) -> int:
        return max(compute_start_slot_at_epoch(epoch, spe) - 1, 0)

    def cache_state(self, chain, state) -> None:
        """Record the justified checkpoint a state carries for its own
        epoch (call with any state advanced into the epoch)."""
        spe = state.slots_per_epoch
        epoch = state.current_epoch()
        dslot = self._decision_slot(epoch, spe)
        try:
            droot = state.get_block_root_at_slot(dslot)
        except Exception:
            return                      # state too young for the lookup
        value = (int(state.current_justified_checkpoint.epoch),
                 bytes(state.current_justified_checkpoint.root),
                 get_committee_count_per_slot(state, epoch))
        with self._lock:
            self._map[(epoch, droot)] = value
            self._map.move_to_end((epoch, droot))
            while len(self._map) > self.SIZE:
                self._map.popitem(last=False)

    def attestation_data(self, chain, slot: int, committee_index: int):
        """AttestationData from caches + fork choice only; None -> the
        caller must fall back to a state (and should prime us)."""
        spe = chain.spec.preset.slots_per_epoch
        epoch = compute_epoch_at_slot(slot, spe)
        head = chain.head()
        # same staleness bound as the state fallback (which 400s): the
        # answer must not depend on LRU residency
        if epoch < head.head_state.current_epoch() - 1:
            return None
        head_root = head.head_block_root
        pa = chain.fork_choice.proto_array
        droot = pa.ancestor_at_or_below_slot(
            head_root, self._decision_slot(epoch, spe))
        if droot is None:
            return None
        with self._lock:
            value = self._map.get((epoch, droot))
        if value is None:
            return None
        if committee_index >= value[2]:
            raise StateError(
                f"committee index {committee_index} out of range "
                f"(epoch {epoch} has {value[2]} committees per slot)")
        # the LMD vote for slot S is the head-chain block AT/BELOW S —
        # voting the head itself for a past slot is rejected by fork
        # choice ("attestation for block newer than slot")
        block_root = pa.ancestor_at_or_below_slot(head_root, slot)
        target_root = pa.ancestor_at_or_below_slot(
            head_root, compute_start_slot_at_epoch(epoch, spe))
        if block_root is None or target_root is None:
            return None
        T = chain.T
        return T.AttestationData(
            slot=slot, index=committee_index,
            beacon_block_root=block_root,
            source=T.Checkpoint(epoch=value[0], root=value[1]),
            target=T.Checkpoint(epoch=epoch, root=target_root))


class Eth1FinalizationCache:
    """Eth1Data snapshots at epoch-boundary states, keyed by checkpoint
    (beacon_chain/src/eth1_finalization_cache.rs): when a checkpoint
    finalizes, the snapshot tells the eth1 deposit tracker how far its
    block/deposit caches can prune without waiting for a state read."""

    SIZE = 64

    def __init__(self):
        # (epoch, checkpoint_root) -> (deposit_root, count, deposit_index)
        self._map: OrderedDict[tuple[int, bytes], tuple] = OrderedDict()
        self._lock = threading.Lock()

    def insert(self, state, block_root: bytes) -> None:
        """Record the snapshot ONLY from a block sitting at its epoch's
        start slot: that block IS the checkpoint root for the epoch, so
        its post-state deposit counters are exactly what finalizing the
        checkpoint finalizes.  A later block's state would include
        deposits that can still reorg after the checkpoint finalizes,
        and would be keyed by a root that never equals the checkpoint
        root (the fork check would permanently miss)."""
        epoch = state.current_epoch()
        spe = state.slots_per_epoch
        if int(state.latest_block_header.slot) != \
                compute_start_slot_at_epoch(epoch, spe):
            return
        self._put((epoch, block_root), state)

    def insert_boundary(self, state) -> None:
        """Prime from a state ADVANCED through an empty epoch boundary
        (state_advance): the checkpoint root for the new epoch is then
        the last block before the boundary, whose post-state deposit
        counters this state still carries (deposits only change in
        blocks).  If a block later lands ON the boundary slot, the
        import-path insert records the real checkpoint under its own
        key and this entry is simply never looked up."""
        epoch = state.current_epoch()
        spe = state.slots_per_epoch
        start = compute_start_slot_at_epoch(epoch, spe)
        if int(state.slot) != start or \
                int(state.latest_block_header.slot) >= start:
            return
        self._put((epoch, state.get_block_root_at_slot(start - 1)), state)

    def _put(self, key, state) -> None:
        snap = (bytes(state.eth1_data.deposit_root),
                int(state.eth1_data.deposit_count),
                int(state.eth1_deposit_index))
        with self._lock:
            self._map[key] = snap
            self._map.move_to_end(key)
            while len(self._map) > self.SIZE:
                self._map.popitem(last=False)

    def finalize(self, epoch: int, block_root: bytes):
        """Snapshot for the finalized checkpoint (or None) — drops all
        entries at/below its epoch either way."""
        with self._lock:
            snap = self._map.get((epoch, block_root))
            for k in [k for k in self._map if k[0] <= epoch]:
                del self._map[k]
        if snap is None:
            return None
        return {"deposit_root": snap[0], "deposit_count": snap[1],
                "deposit_index": snap[2]}


class PreFinalizationCache:
    """Bounded set of block roots proven to be pre-finalization garbage
    (pre_finalization_cache.rs): gossip referencing them is rejected
    immediately instead of triggering a lookup every time."""

    SIZE = 256

    def __init__(self):
        self._roots: OrderedDict[bytes, None] = OrderedDict()
        self._lock = threading.Lock()

    def insert(self, root: bytes) -> None:
        with self._lock:
            self._roots[root] = None
            self._roots.move_to_end(root)
            while len(self._roots) > self.SIZE:
                self._roots.popitem(last=False)

    def contains(self, root: bytes) -> bool:
        with self._lock:
            return root in self._roots


def state_advance(chain, current_slot: int) -> bool:
    """StateAdvanceTimer body (state_advance_timer.rs:1-15): during the
    LAST slot of an epoch, pre-advance a copy of the head state through
    the epoch transition into the next epoch and prime the proposer and
    shuffling caches, so the first block/attestations of the new epoch
    hit caches instead of paying epoch processing inline.  Returns True
    when an advance happened."""
    spe = chain.spec.preset.slots_per_epoch
    if (current_slot + 1) % spe != 0:
        return False
    next_slot = current_slot + 1
    head = chain.head()
    head_root = head.head_block_root
    adv = chain._advanced
    if adv is not None and adv[0] == head_root and adv[1].slot >= next_slot:
        return False                      # already advanced for this head
    state = head.head_state.copy()
    if state.slot < next_slot:
        process_slots(state, next_slot)
    chain._advanced = (head_root, state)
    next_epoch = compute_epoch_at_slot(next_slot, spe)
    # prime proposers for the new epoch on this chain
    start = compute_start_slot_at_epoch(next_epoch, spe)
    proposers = {s: get_beacon_proposer_index(state, s)
                 for s in range(start, start + spe)}
    chain.proposer_cache.insert(head_root, next_epoch, proposers)
    # prime the attester shuffling for targets rooted at the current head
    # (the next epoch's target root is the head block until a new block
    # lands at/after the boundary)
    chain.shuffling_cache.insert(head_root, next_epoch,
                                 committee_cache(state, next_epoch))
    # the advanced state carries next epoch's justified checkpoint: prime
    # the attester cache so boundary attestation requests skip the state
    chain.attester_cache.cache_state(chain, state)
    # and the eth1 snapshot for an empty-boundary checkpoint
    chain.eth1_finalization_cache.insert_boundary(state)
    return True
