"""Light-client server: bootstraps + finality/optimistic updates.

Equivalent of the reference's beacon_node/beacon_chain/src/
light_client_server_cache.rs (:23) + consensus/types light_client_*.rs.
Because the SoA BeaconState preserves the spec field order, the spec
generalized indices hold exactly: altair..deneb
finalized_root=105, current_sync_committee=54, next_sync_committee=55;
electra (6-deep field tree) 169/86/87. Branches are extracted from the
per-field roots the state already computes for its own hash tree.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..containers.state import BeaconState, active_field_specs
from ..specs.chain_spec import ForkName
from ..ssz import htr, merkleize_chunks, next_pow_of_two
from ..ssz.merkle_proof import merkle_root_from_branch
from ..utils.hash import ZERO_HASHES, hash_concat


def _field_roots(state: BeaconState) -> list[bytes]:
    specs = active_field_specs(state.T, state.fork_name)
    return [state._field_root(f) for f in specs]


def _field_index(state: BeaconState, name: str) -> int:
    for i, f in enumerate(active_field_specs(state.T, state.fork_name)):
        if f.name == name:
            return i
    raise KeyError(name)


def state_field_branch(state: BeaconState, field_name: str
                       ) -> tuple[bytes, list[bytes], int]:
    """(leaf, bottom-up branch, gindex) proving a top-level state field."""
    roots = _field_roots(state)
    n = next_pow_of_two(len(roots))
    depth = (n - 1).bit_length()
    nodes = roots + [ZERO_HASHES[0]] * (n - len(roots))
    index = _field_index(state, field_name)
    leaf = nodes[index]
    branch = []
    idx = index
    level = nodes
    for d in range(depth):
        branch.append(level[idx ^ 1])
        level = [hash_concat(level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
        # zero-pad levels stay consistent because n is a power of two
        idx //= 2
    return leaf, branch, n + index


def finalized_root_branch(state: BeaconState
                          ) -> tuple[bytes, list[bytes], int]:
    """Proof of state.finalized_checkpoint.root (gindex 105 / 169)."""
    leaf = state.finalized_checkpoint.root
    epoch_leaf = state.finalized_checkpoint.epoch.to_bytes(32, "little")
    _ck_root, field_branch, field_gindex = state_field_branch(
        state, "finalized_checkpoint")
    return leaf, [epoch_leaf] + field_branch, field_gindex * 2 + 1


@dataclass
class LightClientHeader:
    beacon: object                  # BeaconBlockHeader


@dataclass
class LightClientBootstrap:
    header: LightClientHeader
    current_sync_committee: object
    current_sync_committee_branch: list[bytes]


@dataclass
class LightClientUpdate:
    attested_header: LightClientHeader
    next_sync_committee: object
    next_sync_committee_branch: list[bytes]
    finalized_header: LightClientHeader | None
    finality_branch: list[bytes]
    sync_aggregate: object
    signature_slot: int


@dataclass
class LightClientFinalityUpdate:
    attested_header: LightClientHeader
    finalized_header: LightClientHeader
    finality_branch: list[bytes]
    sync_aggregate: object
    signature_slot: int


@dataclass
class LightClientOptimisticUpdate:
    attested_header: LightClientHeader
    sync_aggregate: object
    signature_slot: int


def _header_for(state: BeaconState) -> LightClientHeader:
    from ..state_transition.helpers import latest_block_header_root
    hdr = state.latest_block_header
    if hdr.state_root == b"\x00" * 32:
        hdr = state.T.BeaconBlockHeader(
            slot=hdr.slot, proposer_index=hdr.proposer_index,
            parent_root=hdr.parent_root, state_root=state.hash_tree_root(),
            body_root=hdr.body_root)
    return LightClientHeader(beacon=hdr)


class LightClientServerCache:
    """Tracks the best updates as blocks are imported (altair+ only)."""

    MAX_STORED_PERIODS = 128    # light_client_server update-range cap

    def __init__(self, chain):
        self.chain = chain
        self.latest_finality_update: LightClientFinalityUpdate | None = None
        self.latest_optimistic_update: LightClientOptimisticUpdate | None = None
        # best update per sync-committee period (update-range serving)
        self.best_updates: dict[int, LightClientUpdate] = {}
        self._best_participation: dict[int, int] = {}

    def produce_bootstrap(self, block_root: bytes
                          ) -> LightClientBootstrap | None:
        state = self.chain._state_for(block_root)
        if state is None or state.fork_name < ForkName.ALTAIR:
            return None
        _leaf, branch, _g = state_field_branch(state,
                                               "current_sync_committee")
        return LightClientBootstrap(
            header=_header_for(state),
            current_sync_committee=state.current_sync_committee,
            current_sync_committee_branch=branch)

    def on_head_update(self, signed_block, post_state: BeaconState) -> None:
        if post_state.fork_name < ForkName.ALTAIR:
            return
        body = signed_block.message.body
        if not hasattr(body, "sync_aggregate"):
            return
        agg = body.sync_aggregate
        participants = sum(1 for b in agg.sync_committee_bits if b)
        if participants == 0:
            return
        # the aggregate in block N signs block N's PARENT — the attested
        # header/state are the parent's (spec: signature_slot > attested.slot)
        attested_state = self.chain._state_for(
            signed_block.message.parent_root)
        if attested_state is None:
            return
        attested = _header_for(attested_state)
        self.latest_optimistic_update = LightClientOptimisticUpdate(
            attested_header=attested, sync_aggregate=agg,
            signature_slot=signed_block.message.slot)
        fin_root = attested_state.finalized_checkpoint.root
        fin_block = self.chain.store.get_block(fin_root)
        if fin_block is not None:
            leaf, branch, _g = finalized_root_branch(attested_state)
            fin_hdr = self.chain.T.BeaconBlockHeader(
                slot=fin_block.message.slot,
                proposer_index=fin_block.message.proposer_index,
                parent_root=fin_block.message.parent_root,
                state_root=fin_block.message.state_root,
                body_root=htr(fin_block.message.body))
            self.latest_finality_update = LightClientFinalityUpdate(
                attested_header=attested,
                finalized_header=LightClientHeader(beacon=fin_hdr),
                finality_branch=branch, sync_aggregate=agg,
                signature_slot=signed_block.message.slot)
        # keep the BEST (most-participating) update per sync period
        # (light_client_server best_update tracking)
        p = self.chain.spec.preset
        period = attested_state.slot // (
            p.slots_per_epoch * p.epochs_per_sync_committee_period)
        if participants > self._best_participation.get(period, 0):
            update = self.produce_update(signed_block.message.parent_root)
            if update is not None:
                self.best_updates[period] = update
                self._best_participation[period] = participants
                while len(self.best_updates) > self.MAX_STORED_PERIODS:
                    oldest = min(self.best_updates)
                    self.best_updates.pop(oldest, None)
                    self._best_participation.pop(oldest, None)

    def updates_by_range(self, start_period: int,
                         count: int) -> list[LightClientUpdate]:
        """GET /eth/v1/beacon/light_client/updates serving."""
        out = []
        for period in range(start_period, start_period + min(count, 128)):
            u = self.best_updates.get(period)
            if u is not None:
                out.append(u)
        return out

    def produce_update(self, block_root: bytes) -> LightClientUpdate | None:
        """Sync-committee-period update for the given attested block."""
        state = self.chain._state_for(block_root)
        if state is None or state.fork_name < ForkName.ALTAIR:
            return None
        _leaf, branch, _g = state_field_branch(state, "next_sync_committee")
        fin = self.latest_finality_update
        return LightClientUpdate(
            attested_header=_header_for(state),
            next_sync_committee=state.next_sync_committee,
            next_sync_committee_branch=branch,
            finalized_header=fin.finalized_header if fin else None,
            finality_branch=fin.finality_branch if fin else [],
            sync_aggregate=fin.sync_aggregate if fin else None,
            signature_slot=fin.signature_slot if fin else 0)


# ---------------------------------------------------------------------------
# SSZ wire forms (req/resp + HTTP SSZ serving: the cache's updates as
# they go over the wire)
# ---------------------------------------------------------------------------

def _hdr_ssz(T, header: LightClientHeader | None):
    if header is None:
        return T.LightClientHeader(beacon=T.BeaconBlockHeader())
    return T.LightClientHeader(beacon=header.beacon)


def _pad_branch(branch, depth: int) -> list[bytes]:
    """Zero-pad a short branch (no-finality updates); REFUSE to truncate
    a longer one — electra's deeper state tree (gindex 169/86/87) does
    not fit the altair wire containers, and a silently-truncated branch
    would fail verification on every conforming client."""
    out = list(branch or [])
    if len(out) > depth:
        raise ValueError(
            f"branch depth {len(out)} exceeds wire depth {depth} "
            "(electra light-client containers not yet defined)")
    return out + [b"\x00" * 32] * (depth - len(out))


def bootstrap_ssz(T, b: LightClientBootstrap):
    return T.LightClientBootstrap(
        header=_hdr_ssz(T, b.header),
        current_sync_committee=b.current_sync_committee,
        current_sync_committee_branch=_pad_branch(
            b.current_sync_committee_branch, 5))


def update_ssz(T, u: LightClientUpdate):
    agg = u.sync_aggregate
    if agg is None:
        from ..containers.core import get_types  # zeroed aggregate
        agg = T.SyncAggregate()
    return T.LightClientUpdate(
        attested_header=_hdr_ssz(T, u.attested_header),
        next_sync_committee=u.next_sync_committee,
        next_sync_committee_branch=_pad_branch(
            u.next_sync_committee_branch, 5),
        finalized_header=_hdr_ssz(T, u.finalized_header),
        finality_branch=_pad_branch(u.finality_branch, 6),
        sync_aggregate=agg,
        signature_slot=int(u.signature_slot))


def finality_update_ssz(T, u: LightClientFinalityUpdate):
    return T.LightClientFinalityUpdate(
        attested_header=_hdr_ssz(T, u.attested_header),
        finalized_header=_hdr_ssz(T, u.finalized_header),
        finality_branch=_pad_branch(u.finality_branch, 6),
        sync_aggregate=u.sync_aggregate,
        signature_slot=int(u.signature_slot))


def optimistic_update_ssz(T, u: LightClientOptimisticUpdate):
    return T.LightClientOptimisticUpdate(
        attested_header=_hdr_ssz(T, u.attested_header),
        sync_aggregate=u.sync_aggregate,
        signature_slot=int(u.signature_slot))
