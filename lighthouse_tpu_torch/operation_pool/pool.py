"""The pools themselves (operation_pool/src/{lib,attestation,persistence}.rs)."""
from __future__ import annotations

import threading
from collections import defaultdict

import numpy as np

from ..containers.state import BeaconState
from ..crypto import bls
from ..specs.chain_spec import ForkName
from ..specs.constants import FAR_FUTURE_EPOCH
from ..ssz import htr
from ..state_transition.helpers import (
    get_attesting_indices, get_base_reward_altair, get_total_active_balance,
    has_flag, is_slashable_attestation_data, is_slashable_validator,
)
from .max_cover import MaxCoverItem, maximum_cover


class OperationPool:
    """Thread-safe pools keyed for O(1) dedup; packing happens per proposal."""

    def __init__(self, T):
        self.T = T
        self._lock = threading.RLock()
        # (data_root, committee_index) -> {aggregation bits tuple -> attestation}
        self._attestations: dict[bytes, list] = defaultdict(list)
        self._att_data: dict[bytes, object] = {}
        self._proposer_slashings: dict[int, object] = {}
        self._attester_slashings: list = []
        self._voluntary_exits: dict[int, object] = {}
        self._bls_changes: dict[int, object] = {}

    # -- attestations --------------------------------------------------------

    def insert_attestation(self, attestation) -> None:
        data_root = htr(attestation.data)
        cb = getattr(attestation, "committee_bits", None)
        key = data_root + (bytes(int(b) for b in cb) if cb is not None
                           else bytes([attestation.data.index & 0xFF]))
        try:
            with self._lock:
                self._att_data[data_root] = attestation.data
                bucket = self._attestations[key]
                new_bits = tuple(attestation.aggregation_bits)
                for i, existing in enumerate(bucket):
                    ex_bits = tuple(existing.aggregation_bits)
                    if all(not b or e for b, e in zip(new_bits, ex_bits)):
                        return  # subset of existing
                    if all(not e or b for b, e in zip(new_bits, ex_bits)):
                        bucket[i] = attestation  # superset replaces
                        return
                    if not any(b and e for b, e in zip(new_bits, ex_bits)):
                        # disjoint: aggregate signatures
                        merged_bits = [b or e
                                       for b, e in zip(new_bits, ex_bits)]
                        agg = bls.aggregate_signatures(
                            [existing.signature, attestation.signature])
                        merged = type(attestation)(
                            aggregation_bits=merged_bits,
                            data=attestation.data, signature=agg,
                            **({"committee_bits": attestation.committee_bits}
                               if hasattr(attestation, "committee_bits")
                               else {}))
                        bucket[i] = merged
                        return
                bucket.append(attestation)
        finally:
            self._feed_gauges()

    def _feed_gauges(self) -> None:
        """Feed the op_pool_* gauges after any mutation."""
        with self._lock:
            atts = sum(len(v) for v in self._attestations.values())
            slashings = (len(self._proposer_slashings)
                         + len(self._attester_slashings))
            exits = len(self._voluntary_exits)
        import sys
        md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
        if md is not None:
            md.gauge("op_pool_attestations", atts)
            md.gauge("op_pool_slashings", slashings)
            md.gauge("op_pool_exits", exits)

    def num_attestations(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._attestations.values())

    def get_attestations_for_block(self, state: BeaconState) -> list:
        """Max-cover packing of unexpired attestations (AttMaxCover)."""
        p = state.T.preset
        electra = state.fork_name >= ForkName.ELECTRA
        limit = (p.max_attestations_electra if electra
                 else p.max_attestations)
        prev, cur = state.previous_epoch(), state.current_epoch()
        items = []
        with self._lock:
            candidates = [a for bucket in self._attestations.values()
                          for a in bucket]
        for att in candidates:
            # fork-shape filter: electra bodies take committee_bits
            # attestations only (and vice versa) — pre-fork pool entries
            # are unpackable across the boundary
            if electra != hasattr(att, "committee_bits"):
                continue
            d = att.data
            if d.target.epoch not in (prev, cur):
                continue
            if d.slot + p.min_attestation_inclusion_delay > state.slot:
                continue
            if state.fork_name < ForkName.DENEB and \
                    state.slot > d.slot + p.slots_per_epoch:
                continue
            # source must match or the attestation is invalid in-block
            justified = (state.current_justified_checkpoint
                         if d.target.epoch == cur
                         else state.previous_justified_checkpoint)
            if d.source != justified:
                continue
            try:
                fresh = self._fresh_weight(state, att)
            except Exception:
                continue
            if fresh:
                items.append(MaxCoverItem(att, fresh))
        chosen = maximum_cover(items, limit)
        return [c.item for c in chosen]

    def _fresh_weight(self, state: BeaconState, att) -> dict:
        """Validators this attestation would newly credit, weighted.

        Keys are (target_epoch, validator): the greedy cover then only
        discounts overlap between attestations crediting the *same epoch*
        (the reference discounts same-slot/index only, attestation.rs:159 —
        per-epoch keying is the participation-flag-exact equivalent).
        """
        epoch_key = att.data.target.epoch
        if state.fork_name == ForkName.PHASE0:
            seen: set[int] = set()
            for pa in (state.previous_epoch_attestations or []) + \
                    (state.current_epoch_attestations or []):
                if htr(pa.data) == htr(att.data):
                    idx = get_attesting_indices(state, pa)
                    seen.update(int(i) for i in idx)
            out = {}
            for i in get_attesting_indices(state, att):
                if int(i) not in seen:
                    out[(epoch_key, int(i))] = int(
                        state.validators.effective_balance[int(i)])
            return out
        participation = (state.current_epoch_participation
                         if att.data.target.epoch == state.current_epoch()
                         else state.previous_epoch_participation)
        out = {}
        for i in get_attesting_indices(state, att):
            i = int(i)
            # weight by unset target flag (dominant reward component)
            if not has_flag(int(participation[i]), 1):
                out[(epoch_key, i)] = int(
                    state.validators.effective_balance[i])
        return out

    # -- slashings / exits / changes ----------------------------------------

    def insert_proposer_slashing(self, slashing) -> None:
        with self._lock:
            self._proposer_slashings[
                slashing.signed_header_1.message.proposer_index] = slashing
        self._feed_gauges()

    def insert_attester_slashing(self, slashing) -> None:
        with self._lock:
            self._attester_slashings.append(slashing)
        self._feed_gauges()

    def insert_voluntary_exit(self, exit_) -> None:
        with self._lock:
            self._voluntary_exits[exit_.message.validator_index] = exit_
        self._feed_gauges()

    def insert_bls_to_execution_change(self, change) -> None:
        with self._lock:
            self._bls_changes[change.message.validator_index] = change

    def get_slashings_and_exits(self, state: BeaconState):
        p = state.T.preset
        epoch = state.current_epoch()
        with self._lock:
            proposer = [
                s for s in self._proposer_slashings.values()
                if is_slashable_validator(
                    state, s.signed_header_1.message.proposer_index, epoch)
            ][:p.max_proposer_slashings]
            attester = []
            limit = (p.max_attester_slashings_electra
                     if state.fork_name >= ForkName.ELECTRA
                     else p.max_attester_slashings)
            for s in self._attester_slashings:
                common = set(s.attestation_1.attesting_indices) & \
                    set(s.attestation_2.attesting_indices)
                if any(is_slashable_validator(state, int(i), epoch)
                       for i in common):
                    attester.append(s)
                if len(attester) == limit:
                    break
            exits = []
            for e in self._voluntary_exits.values():
                i = e.message.validator_index
                if i < len(state.validators):
                    v = state.validators.view(i)
                    if v.exit_epoch == FAR_FUTURE_EPOCH and \
                            e.message.epoch <= epoch:
                        exits.append(e)
                if len(exits) == p.max_voluntary_exits:
                    break
            changes = []
            for c in self._bls_changes.values():
                i = c.message.validator_index
                if i < len(state.validators) and \
                        state.validators.withdrawal_credentials[i][0] == 0:
                    changes.append(c)
                if len(changes) == p.max_bls_to_execution_changes:
                    break
        return proposer, attester, exits, changes

    def prune(self, state: BeaconState) -> None:
        """Drop expired ops (prune_all equivalent)."""
        prev = state.previous_epoch()
        epoch = state.current_epoch()
        with self._lock:
            for key in list(self._attestations):
                bucket = [a for a in self._attestations[key]
                          if a.data.target.epoch >= prev]
                if bucket:
                    self._attestations[key] = bucket
                else:
                    del self._attestations[key]
            self._voluntary_exits = {
                i: e for i, e in self._voluntary_exits.items()
                if i < len(state.validators)
                and state.validators.view(i).exit_epoch == FAR_FUTURE_EPOCH}
            self._proposer_slashings = {
                i: s for i, s in self._proposer_slashings.items()
                if is_slashable_validator(state, i, epoch)}
            self._attester_slashings = [
                s for s in self._attester_slashings
                if any(is_slashable_validator(state, int(i), epoch)
                       for i in set(s.attestation_1.attesting_indices)
                       & set(s.attestation_2.attesting_indices))]
        self._feed_gauges()
