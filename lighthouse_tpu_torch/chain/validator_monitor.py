"""Per-validator monitoring.

Equivalent of the reference's beacon_node/beacon_chain/src/validator_monitor.rs
(2.2k LoC): registered validators get per-epoch hit/miss tracking for
attestations (incl. inclusion distance), block proposals, and sync duty,
surfaced as logs + Prometheus gauges and a summary API.
"""
from __future__ import annotations

import logging
from collections import defaultdict
from dataclasses import dataclass, field

log = logging.getLogger("lighthouse_tpu_torch.validator_monitor")


@dataclass
class EpochSummary:
    attestation_hits: int = 0
    attestation_misses: int = 0
    inclusion_distance_sum: int = 0
    blocks_proposed: int = 0
    sync_signatures: int = 0
    #: summed delay-from-slot-start of this validator's observed proposals
    #: (slot-anchored lateness, fed from the block-times cache)
    block_delay_sum: float = 0.0


class ValidatorMonitor:
    def __init__(self, chain, auto_register: bool = False):
        self.chain = chain
        self.auto = auto_register
        self.registered: set[int] = set()
        # epoch -> validator -> summary
        self.summaries: dict[int, dict[int, EpochSummary]] = \
            defaultdict(lambda: defaultdict(EpochSummary))

    def register_validator(self, index: int) -> None:
        self.registered.add(index)

    def _tracked(self, index: int) -> bool:
        return self.auto or index in self.registered

    # -- feeds (called from import paths) ------------------------------------

    def on_block_imported(self, block, indexed_attestations,
                          block_root: bytes | None = None) -> None:
        epoch = block.slot // self.chain.spec.preset.slots_per_epoch
        if self._tracked(block.proposer_index):
            s = self.summaries[epoch][block.proposer_index]
            s.blocks_proposed += 1
            # slot-anchored proposal lateness from the block-times cache:
            # a monitored proposer landing past the attestation deadline
            # (seconds_per_slot / 3) is the re-org-bait signal
            delay = None
            if block_root is not None:
                bt = self.chain.block_times_cache.get(block_root)
                if bt is not None:
                    delay = bt.observed_delay
            if delay is not None:
                s.block_delay_sum += delay
                deadline = self.chain.spec.seconds_per_slot / 3
                lvl = log.warning if delay > deadline else log.info
                lvl("validator %d proposed block at slot %d "
                    "(%.3fs into the slot)",
                    block.proposer_index, block.slot, delay)
            else:
                log.info("validator %d proposed block at slot %d",
                         block.proposer_index, block.slot)
        for indexed in indexed_attestations:
            distance = block.slot - indexed.data.slot
            att_epoch = indexed.data.slot // \
                self.chain.spec.preset.slots_per_epoch
            for v in indexed.attesting_indices:
                if self._tracked(int(v)):
                    s = self.summaries[att_epoch][int(v)]
                    s.attestation_hits += 1
                    s.inclusion_distance_sum += distance

    _pending: tuple | None = None    # (epoch, participation snapshot)

    def on_epoch_transition(self, epoch: int, state) -> None:
        """Called when the chain enters epoch+1. Scoring for `epoch` is
        DEFERRED until the next transition: late attestations for `epoch`
        can still land throughout epoch+1, so we score the previous pending
        snapshot now and stash this epoch's final flags for later."""
        from ..specs.chain_spec import ForkName
        if state.fork_name < ForkName.ALTAIR:
            return
        if self._pending is not None:
            done_epoch, part = self._pending
            for v in (self.registered if not self.auto
                      else range(len(part))):
                if v >= len(part):
                    continue
                if not (int(part[v]) & 0b010):  # timely target unset
                    self.summaries[done_epoch][v].attestation_misses += 1
                    log.warning("validator %d missed target attestation in "
                                "epoch %d", v, done_epoch)
        # previous_epoch_participation currently holds `epoch`'s flags and
        # keeps absorbing its late attestations during epoch+1; note_state
        # refreshes the snapshot on every import until the next transition
        self._pending = (epoch, state.previous_epoch_participation)

    def note_state(self, state) -> None:
        """Refresh the pending epoch's flag snapshot (late inclusions)."""
        from ..specs.chain_spec import ForkName
        if self._pending is None or state.fork_name < ForkName.ALTAIR:
            return
        ep, _ = self._pending
        if state.current_epoch() == ep + 1:
            self._pending = (ep, state.previous_epoch_participation)

    # -- queries -------------------------------------------------------------

    def summary(self, epoch: int, validator: int) -> EpochSummary:
        return self.summaries.get(epoch, {}).get(validator, EpochSummary())

    def prune(self, min_epoch: int) -> None:
        for e in [e for e in self.summaries if e < min_epoch]:
            del self.summaries[e]
