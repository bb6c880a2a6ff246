"""Anti-equivocation observation caches.

Equivalent of the reference's beacon_node/beacon_chain/src/observed_*.rs:
bounded sets recording what each validator has already produced per slot/epoch
so duplicates and equivocations are rejected at the gossip edge.
"""
from __future__ import annotations

from collections import defaultdict


class ObservedBlockProducers:
    """(slot, proposer) pairs + block roots seen (observed_block_producers.rs).

    Distinguishes duplicate (same root) from slashable equivocation
    (different root, same slot+proposer).
    """

    def __init__(self):
        self._seen: dict[tuple[int, int], set[bytes]] = defaultdict(set)
        self.finalized_slot = 0

    def observe(self, slot: int, proposer: int, block_root: bytes) -> str:
        """Returns 'new' | 'duplicate' | 'slashable'."""
        roots = self._seen[(slot, proposer)]
        if block_root in roots:
            return "duplicate"
        if roots:
            roots.add(block_root)
            return "slashable"
        roots.add(block_root)
        return "new"

    def proposer_has_been_observed(self, slot: int, proposer: int,
                                   block_root: bytes) -> str:
        roots = self._seen.get((slot, proposer), set())
        if block_root in roots:
            return "duplicate"
        if roots:
            return "slashable"
        return "new"

    def prune(self, finalized_slot: int) -> None:
        self.finalized_slot = finalized_slot
        for key in [k for k in self._seen if k[0] <= finalized_slot]:
            del self._seen[key]


class ObservedAttesters:
    """Per-epoch validator participation bitfields (observed_attesters.rs):
    one structure reused for unaggregated attesters (per target epoch),
    aggregators (per slot), and sync contributors."""

    def __init__(self):
        self._seen: dict[int, set[int]] = defaultdict(set)

    def observe(self, period: int, validator_index: int) -> bool:
        """Returns True if already observed (i.e. duplicate)."""
        s = self._seen[period]
        if validator_index in s:
            return True
        s.add(validator_index)
        return False

    def has_been_observed(self, period: int, validator_index: int) -> bool:
        return validator_index in self._seen.get(period, set())

    def prune(self, lowest_period: int) -> None:
        for k in [k for k in self._seen if k < lowest_period]:
            del self._seen[k]


class ObservedAggregates:
    """Seen aggregate attestation/sync-contribution roots per slot
    (observed_aggregates.rs) — rejects exact duplicates and subsets."""

    def __init__(self):
        self._seen: dict[int, list[tuple[bytes, tuple]] ] = defaultdict(list)

    def observe(self, slot: int, item_root: bytes, bits: tuple) -> str:
        """'new' | 'duplicate' | 'subset'."""
        entries = self._seen[slot]
        for root, seen_bits in entries:
            if root == item_root:
                if all((not b) or s for b, s in zip(bits, seen_bits)):
                    return "subset" if bits != seen_bits else "duplicate"
        entries.append((item_root, tuple(bits)))
        return "new"

    def is_known_subset(self, slot: int, item_root: bytes,
                        bits: tuple) -> bool:
        for root, seen_bits in self._seen.get(slot, []):
            if root == item_root and \
                    all((not b) or s for b, s in zip(bits, seen_bits)):
                return True
        return False

    def prune(self, lowest_slot: int) -> None:
        for k in [k for k in self._seen if k < lowest_slot]:
            del self._seen[k]


class ObservedBlobSidecars:
    """(block_root?, slot, proposer, index) dedup (observed_blob_sidecars.rs)."""

    def __init__(self):
        self._seen: set[tuple[int, int, int]] = set()

    def observe(self, slot: int, proposer: int, index: int) -> bool:
        key = (slot, proposer, index)
        if key in self._seen:
            return True
        self._seen.add(key)
        return False

    def has_been_observed(self, slot: int, proposer: int,
                          index: int) -> bool:
        return (slot, proposer, index) in self._seen

    def prune(self, finalized_slot: int) -> None:
        self._seen = {k for k in self._seen if k[0] > finalized_slot}


class ObservedOperations:
    """Dedup for exits/slashings/bls-changes by affected validator indices
    (observed_operations.rs). Entries are permanent per validator while the
    validator can still be affected; prune drops validators already exited
    before finalization (bounded by the validator set size either way)."""

    def __init__(self):
        self._seen: set[tuple[str, int]] = set()

    def observe(self, kind: str, indices) -> bool:
        """True if ALL indices were already covered (duplicate)."""
        keys = [(kind, int(i)) for i in indices]
        if all(k in self._seen for k in keys):
            return True
        self._seen.update(keys)
        return False

    def prune(self, exited_validators: set[int]) -> None:
        self._seen = {k for k in self._seen if k[1] not in exited_validators}


class ObservedSlashable:
    """Roots signed per (slot, proposer) for slashing detection feeds
    (observed_slashable.rs)."""

    def __init__(self):
        self._seen: dict[tuple[int, int], set[bytes]] = defaultdict(set)

    def observe(self, slot: int, proposer: int, root: bytes) -> None:
        self._seen[(slot, proposer)].add(root)

    def is_slashable(self, slot: int, proposer: int, root: bytes) -> bool:
        roots = self._seen.get((slot, proposer), set())
        return bool(roots) and root not in roots

    def prune(self, finalized_slot: int) -> None:
        for key in [k for k in self._seen if k[0] <= finalized_slot]:
            del self._seen[key]
