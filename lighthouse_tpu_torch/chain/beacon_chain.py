"""The BeaconChain service.

Equivalent of the reference's beacon_node/beacon_chain/src/beacon_chain.rs
(6855 LoC god-object): process_block (:3089), import_block (:3449),
produce_block_on_state (:4810), batch attestation entry points (:1961,:2007),
recompute_head (canonical_head.rs).

Lock discipline (canonical_head.rs:1-32 contract, adapted): a single RLock
guards {fork_choice, canonical head snapshot}; it is only taken inside this
module's public methods and NEVER held across calls back into user code or
the execution layer's blocking I/O — guards are never exposed.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from ..containers import get_types
from ..containers.state import BeaconState
from ..crypto import bls
from ..obs import causal, tracing
from ..fork_choice import ForkChoice
from ..operation_pool import OperationPool
from ..specs.chain_spec import ChainSpec, ForkName
from ..ssz import htr
from ..state_transition import (
    VerifySignatures, per_block_processing, process_slots,
)
from ..state_transition.block import (
    BlockProcessingError, compute_timestamp_at_slot, get_expected_withdrawals,
)
from ..state_transition.helpers import (
    compute_epoch_at_slot, compute_start_slot_at_epoch,
    get_beacon_proposer_index, get_indexed_attestation,
    latest_block_header_root,
)
from ..store import HotColdDB, StoreOp
from ..utils.crashpoints import crashpoint
from ..utils.slot_clock import SlotClock
from . import attestation_verification as att_verify
from . import block_verification as blk_verify
from .errors import INVALID_BLOCK, PARENT_UNKNOWN, BlockError
from .events import EventHandler
from .execution import ExecutionLayerInterface
from .observed import (
    ObservedAggregates, ObservedAttesters, ObservedBlobSidecars,
    ObservedBlockProducers, ObservedOperations, ObservedSlashable,
)


@dataclass
class ChainConfig:
    snapshot_cache_size: int = 8
    reorg_threshold_pct: int = 20
    enable_light_client_server: bool = True


@dataclass
class CanonicalHead:
    head_block_root: bytes
    head_block: object
    head_state: BeaconState


class BeaconChain:
    def __init__(self, spec: ChainSpec, store: HotColdDB,
                 slot_clock: SlotClock,
                 execution_layer: ExecutionLayerInterface,
                 genesis_state: BeaconState, genesis_block,
                 config: ChainConfig | None = None):
        self.spec = spec
        self.T = get_types(spec.preset)
        self.store = store
        self.slot_clock = slot_clock
        # trace roots are slot-anchored against this clock (obs/)
        tracing.set_slot_clock(slot_clock)
        # graftwatch samples the metric catalog + evaluates SLOs per slot
        from ..obs import graftwatch
        graftwatch.register_chain(self)
        self.execution_layer = execution_layer
        self.config = config or ChainConfig()

        self.genesis_state = genesis_state
        self.genesis_block_root = latest_block_header_root(genesis_state)
        self.genesis_validators_root = genesis_state.genesis_validators_root

        if genesis_block is None and genesis_state.slot == 0:
            # Synthesize the slot-0 SignedBeaconBlock (empty body, zero
            # signature) so the store can serve it over blocks_by_range —
            # backfill completion requires actually receiving the genesis
            # block, not trusting an empty response.  The state may have
            # been upgraded past its genesis fork, so pick the fork whose
            # empty body matches the header's body_root.
            hdr_body_root = genesis_state.latest_block_header.body_root
            for fork in ForkName:
                if fork > genesis_state.fork_name:
                    break
                body = self.T.BeaconBlockBody[fork]()
                if htr(body) != hdr_body_root:
                    continue
                msg = self.T.BeaconBlock[fork](
                    slot=0, proposer_index=0, parent_root=b"\x00" * 32,
                    state_root=genesis_state.hash_tree_root(), body=body)
                genesis_block = self.T.SignedBeaconBlock[fork](
                    message=msg, signature=b"\x00" * 96)
                assert htr(msg) == self.genesis_block_root
                break

        self._lock = threading.RLock()
        self.fork_choice = ForkChoice(spec, self.genesis_block_root,
                                      genesis_state)
        self.fork_choice.balances_provider = self._justified_balances
        self.canonical_head = CanonicalHead(
            self.genesis_block_root, genesis_block, genesis_state)

        # caches (the reference's ~15 specialized caches)
        self._snapshots: OrderedDict[bytes, BeaconState] = OrderedDict()
        self._snapshots[self.genesis_block_root] = genesis_state
        from .hot_caches import (
            AttesterCache, EarlyAttesterCache, Eth1FinalizationCache,
            PreFinalizationCache, ProposerCache, ShufflingCache,
        )
        self.shuffling_cache = ShufflingCache()
        self.proposer_cache = ProposerCache()
        self.early_attester_cache = EarlyAttesterCache()
        self.attester_cache = AttesterCache()
        self.eth1_finalization_cache = Eth1FinalizationCache()
        self.pre_finalization_cache = PreFinalizationCache()
        self._advanced: tuple[bytes, BeaconState] | None = None
        # set by the network service when a BeaconProcessor is attached;
        # drives the park-and-replay queue (work_reprocessing_queue.rs)
        self.processor = None
        # optional Slasher: gossip verification feeds it authenticated
        # block headers and indexed attestations when set (the client
        # builder wires it behind slasher_enabled; scenarios attach one
        # directly)
        self.slasher = None

        self.observed_block_producers = ObservedBlockProducers()
        self.observed_attesters = ObservedAttesters()
        self.observed_aggregators = ObservedAttesters()
        self.observed_aggregates = ObservedAggregates()
        self.observed_sync_contributors = ObservedAttesters()
        self.observed_blob_sidecars = ObservedBlobSidecars()
        self.observed_data_columns = ObservedBlobSidecars()
        self.data_columns: OrderedDict[bytes, dict] = OrderedDict()
        self._verified_sidecar_headers: OrderedDict[bytes, bool] = \
            OrderedDict()
        self.observed_operations = ObservedOperations()
        self.observed_slashable = ObservedSlashable()

        self.op_pool = OperationPool(self.T)
        self.events = EventHandler()
        from .light_client import LightClientServerCache
        self.light_client_cache = LightClientServerCache(self)
        from .sync_committee import SyncCommitteePool
        self.sync_committee_pool = SyncCommitteePool(self)
        from .data_availability import DataAvailabilityChecker
        self.data_availability_checker = DataAvailabilityChecker(self.T)
        self.block_times: dict[bytes, dict] = {}
        self._block_times_cache = None     # lazy (block_times_cache prop)
        # proposer preparation + MEV builder (execution_layer/src/lib.rs:807
        # get_payload builder path; validator registrations forwarded to the
        # builder, fee recipients applied to local payloads)
        self.prepared_proposers: dict[int, bytes] = {}   # idx -> recipient
        self.validator_registrations: dict[bytes, dict] = {}
        self.builder = None                    # BuilderHttpClient | None
        self.builder_boost_factor = 100        # percent
        self.default_fee_recipient = b"\x00" * 20
        self.default_graffiti = b"\x00" * 32   # --graffiti flag
        self.block_production_log: list[dict] = []   # payload source audit
        from .validator_monitor import ValidatorMonitor
        self.validator_monitor = ValidatorMonitor(self)
        # --validator-monitor-pubkeys not yet in the registry: re-resolved
        # each slot so a later deposit still gets monitored
        self.monitor_pubkeys_pending: list[bytes] = []
        self._monitored_epoch = 0
        self.eth1_service = None       # optional Eth1Service
        self._replay_engine = None     # lazy graftflow pipeline (replay/)

        store.store_genesis(self.genesis_block_root, genesis_state,
                            genesis_block)
        if genesis_block is not None and genesis_state.slot > 0:
            # checkpoint-sync anchor: history before this block is
            # backfilled by SyncManager.backfill
            store.set_backfill_anchor(
                genesis_block.message.slot,
                genesis_block.message.parent_root)

    # -- time / status -------------------------------------------------------

    def slot(self) -> int:
        s = self.slot_clock.now()
        return s if s is not None else 0

    def epoch(self) -> int:
        return self.slot() // self.spec.preset.slots_per_epoch

    def finalized_checkpoint(self) -> tuple[int, bytes]:
        return self.fork_choice.finalized_checkpoint

    def justified_checkpoint(self) -> tuple[int, bytes]:
        return self.fork_choice.justified_checkpoint

    def head(self) -> CanonicalHead:
        with self._lock:
            return self.canonical_head

    def head_state_copy(self) -> BeaconState:
        with self._lock:
            return self.canonical_head.head_state.copy()

    # -- state resolution ----------------------------------------------------

    def _justified_balances(self, checkpoint: tuple[int, bytes]
                            ) -> np.ndarray | None:
        """Active effective balances of the justified-checkpoint state
        (beacon_fork_choice_store.rs JustifiedBalances) — the block state
        advanced to the checkpoint epoch start when slots were skipped."""
        from ..fork_choice.fork_choice import _active_effective_balances
        epoch, root = checkpoint
        st = self._state_for(root)
        if st is None:
            return None
        target_slot = compute_start_slot_at_epoch(
            epoch, self.spec.preset.slots_per_epoch)
        if st.slot < target_slot:
            st = st.copy()
            process_slots(st, target_slot)
        return _active_effective_balances(st)

    def _state_for(self, block_root: bytes) -> BeaconState | None:
        st = self._snapshots.get(block_root)
        if st is not None:
            return st
        blk = self.store.get_block(block_root)
        if blk is None:
            return None
        return self.store.get_hot_state(blk.message.state_root)

    def _cache_snapshot(self, block_root: bytes, state: BeaconState) -> None:
        self._snapshots[block_root] = state
        self._snapshots.move_to_end(block_root)
        while len(self._snapshots) > self.config.snapshot_cache_size:
            old_root, _ = self._snapshots.popitem(last=False)
            if old_root == self.canonical_head.head_block_root:
                self._snapshots[old_root] = \
                    self.canonical_head.head_state
                if len(self._snapshots) <= self.config.snapshot_cache_size:
                    break

    def state_for_block_production(self, parent_root: bytes,
                                   slot: int) -> BeaconState:
        """Parent state advanced to `slot` (cheap_state_advance analog —
        committees/proposers only need the slot advance).  Prefers the
        state-advance timer's pre-computed epoch crossing
        (state_advance_timer.rs:1-15) so the first block of an epoch
        doesn't pay epoch processing inline."""
        st = None
        adv = self._advanced
        if adv is not None and adv[0] == parent_root and adv[1].slot <= slot:
            st = adv[1]
        if st is None:
            st = self._state_for(parent_root)
        if st is None:
            raise BlockError(PARENT_UNKNOWN, parent_root.hex())
        st = st.copy()
        if st.slot < slot:
            process_slots(st, slot)
        return st

    def state_for_block_import(self, parent_root: bytes,
                               slot: int) -> BeaconState:
        return self.state_for_block_production(parent_root, slot)

    def state_for_attestation(self, data) -> BeaconState:
        """A state that can compute committees for data's target epoch."""
        st = self._state_for(data.beacon_block_root)
        if st is None:
            raise BlockError(PARENT_UNKNOWN, data.beacon_block_root.hex())
        target_start = compute_start_slot_at_epoch(
            data.target.epoch, self.spec.preset.slots_per_epoch)
        # always hand back an isolated fork: a CoW copy is O(chunks)
        # pointer work now, and callers shuffling committees must never
        # alias the snapshot-cache state
        st = st.copy()
        if st.slot < target_start:
            process_slots(st, target_start)
        return st

    # -- block processing ----------------------------------------------------

    def verify_block_for_gossip(self, signed_block):
        return blk_verify.verify_block_for_gossip(self, signed_block)

    def process_block(self, signed_block,
                      proposal_already_verified: bool = False) -> bytes:
        """Full import pipeline (beacon_chain.rs:3089): signatures (batched)
        -> state transition -> payload -> fork choice -> store -> head.
        Every stage is a graftscope span (obs/), so the call is one trace
        AND feeds the stage histograms of the metrics catalog."""
        block = signed_block.message
        block_root = htr(block)
        if self.fork_choice.contains_block(block_root):
            return block_root
        if not self.fork_choice.contains_block(block.parent_root):
            raise BlockError(PARENT_UNKNOWN, block.parent_root.hex())
        self.block_times_cache.on_observed(block_root, block.slot)
        with tracing.span("block_import", slot=int(block.slot),
                          block_root=block_root.hex()):
            with tracing.span("batch_signature"):
                sv = blk_verify.into_signature_verified(
                    self, signed_block, block_root,
                    proposal_already_verified)
            # state_transition + state_root spans live inside
            ep = blk_verify.into_execution_pending(self, sv)
            imported = self._finish_process_block(block, block_root, ep)
        # propagation clock: a lookup hit means another node published
        # this root (the proposer imports before publishing — a miss)
        causal.tracker().on_block_imported(block_root)
        return imported

    def process_gossip_block(self, signed_block) -> bytes:
        """Canonical gossip entry: gossip verification + full import as
        ONE trace (the network service's inline path and the tracing
        tier-1 gate both use this), rooted at a slot-anchored
        block_pipeline span."""
        with tracing.span("block_pipeline",
                          slot=int(signed_block.message.slot)):
            self.verify_block_for_gossip(signed_block)
            return self.process_block(signed_block,
                                      proposal_already_verified=True)

    def _finish_process_block(self, block, block_root: bytes, ep) -> bytes:
        # deneb+: blob availability gate (data_availability_checker.rs)
        commitments = getattr(block.body, "blob_kzg_commitments", None)
        if commitments:
            ready = self.data_availability_checker.put_pending_block(
                block_root, ep, len(commitments))
            if ready is None:
                from .errors import AVAILABILITY_PENDING
                raise BlockError(AVAILABILITY_PENDING, block_root.hex())
            ep = ready
        return self.import_block(ep)

    @property
    def block_times_cache(self):
        if self._block_times_cache is None:
            with self._lock:                # double-checked lazy init
                if self._block_times_cache is None:
                    from .block_times_cache import BlockTimesCache
                    self._block_times_cache = BlockTimesCache(
                        int(self.genesis_state.genesis_time),
                        self.spec.seconds_per_slot)
        return self._block_times_cache

    def process_blob_sidecar(self, sidecar) -> bytes | None:
        """Gossip blob intake; imports the parent block when it completes.
        Returns the imported block root, or None while still pending."""
        hdr = sidecar.signed_block_header.message
        block_root = htr(hdr)
        # check-before / observe-after verification: a forged sidecar must
        # not block the real one (same discipline as attestations)
        if self.observed_blob_sidecars.has_been_observed(
                hdr.slot, hdr.proposer_index, sidecar.index):
            return None
        # The header's proposer signature must be valid BEFORE the sidecar
        # can be observed or occupy availability-cache space — otherwise a
        # forged sidecar with a valid KZG proof would both block the real
        # proposer's sidecar (observed-cache poisoning) and evict pending
        # blocks from the LRU (blob_verification.rs:542-586 order).
        self._verify_sidecar_header(sidecar, block_root)
        ready = self.data_availability_checker.put_sidecar(block_root,
                                                           sidecar)
        if ready is None and not \
                self.data_availability_checker.contains_sidecar(
                    block_root, sidecar.index):
            return None  # failed verification: leave unobserved
        self.observed_blob_sidecars.observe(hdr.slot, hdr.proposer_index,
                                            sidecar.index)
        if ready is not None:
            return self.import_block(ready)
        return None

    def process_data_column_sidecar(self, sidecar) -> None:
        """PeerDAS gossip intake (data_column_verification.rs): structure
        + inclusion proof + header signature BEFORE observing, same
        discipline as blob sidecars."""
        from .data_columns import (
            verify_data_column_sidecar, verify_data_column_sidecar_kzg,
        )
        hdr = sidecar.signed_block_header.message
        block_root = htr(hdr)
        if self.observed_data_columns.has_been_observed(
                hdr.slot, hdr.proposer_index, sidecar.index):
            return
        if not verify_data_column_sidecar(self.T, sidecar):
            raise BlockError(INVALID_BLOCK, "bad data column sidecar")
        self._verify_sidecar_header(sidecar, block_root)
        # KZG cell proofs last: cheap structural + signature checks first
        # (DoS ordering, data_column_verification.rs)
        if not verify_data_column_sidecar_kzg(
                self.T, sidecar, self.data_availability_checker.kzg):
            raise BlockError(INVALID_BLOCK, "bad data column cell proofs")
        self.observed_data_columns.observe(hdr.slot, hdr.proposer_index,
                                           sidecar.index)
        cols = self.data_columns.setdefault(block_root, {})
        cols[int(sidecar.index)] = sidecar
        self.data_columns.move_to_end(block_root)
        while len(self.data_columns) > 16:
            self.data_columns.popitem(last=False)

    def _verify_sidecar_header(self, sidecar, block_root: bytes) -> None:
        """Proposer-index + header-signature gossip checks for a blob
        sidecar (blob_verification.rs verify_blob_sidecar_for_gossip).
        Raises BlockError on an invalid header; caches per block root so
        the up-to-6 sidecars of one block verify the header once."""
        from .errors import (
            FINALIZED_SLOT, FUTURE_SLOT, INCORRECT_PROPOSER,
            INVALID_SIGNATURE,
        )
        if block_root in self._verified_sidecar_headers:
            return
        hdr = sidecar.signed_block_header.message
        # slot sanity BEFORE any state advance: an attacker-chosen huge slot
        # would otherwise drive process_slots for billions of iterations
        if hdr.slot > self.slot():
            raise BlockError(FUTURE_SLOT, f"sidecar slot {hdr.slot}")
        finalized_slot = self.finalized_checkpoint()[0] * \
            self.spec.preset.slots_per_epoch
        if hdr.slot <= finalized_slot:
            raise BlockError(FINALIZED_SLOT, f"sidecar slot {hdr.slot}")
        if not self.fork_choice.contains_block(hdr.parent_root):
            raise BlockError(PARENT_UNKNOWN, hdr.parent_root.hex())
        state = self.state_for_block_production(hdr.parent_root, hdr.slot)
        expected = get_beacon_proposer_index(state, hdr.slot)
        if hdr.proposer_index != expected:
            raise BlockError(
                INCORRECT_PROPOSER,
                f"sidecar got {hdr.proposer_index}, expected {expected}")
        from ..state_transition.signature_sets import (
            block_proposal_signature_set,
        )
        s = block_proposal_signature_set(
            state, sidecar.signed_block_header, block_root)
        if not bls.verify_signature_sets([s]):
            raise BlockError(INVALID_SIGNATURE, "blob sidecar header")
        self._verified_sidecar_headers[block_root] = True
        while len(self._verified_sidecar_headers) > 64:
            self._verified_sidecar_headers.popitem(last=False)

    def import_block(self, ep) -> bytes:
        """beacon_chain.rs:3449 import_block: fork choice + store + head."""
        block = ep.signed_block.message
        block_root = ep.block_root
        state = ep.post_state
        from ..fork_choice.proto_array import ExecutionStatus
        status = {"valid": ExecutionStatus.VALID,
                  "optimistic": ExecutionStatus.OPTIMISTIC,
                  "irrelevant": ExecutionStatus.IRRELEVANT}[ep.payload_status]
        from ..api import metrics_defs as M
        current_slot = max(self.slot(), block.slot)
        delay = None
        if self.slot_clock.now() == block.slot:
            delay = self.slot_clock.seconds_into_slot()
        self.block_times[block_root] = {
            "slot": block.slot, "delay": delay,
            "observed_slot": self.slot()}
        self.block_times_cache.on_imported(block_root, block.slot)
        M.count("beacon_block_imported_total")
        with self._lock:
            with tracing.span("fork_choice"):
                self.fork_choice.on_block(current_slot, block, block_root,
                                          state, block_delay_seconds=delay,
                                          execution_status=status)
                # on-block attestations feed LMD votes (is_from_block)
                indexed_atts = []
                for att in block.body.attestations:
                    try:
                        indexed = get_indexed_attestation(state, att)
                        indexed_atts.append(indexed)
                        self.fork_choice.on_attestation(
                            current_slot, indexed, is_from_block=True)
                    except Exception as e:  # best-effort
                        import logging

                        from ..fork_choice import ForkChoiceError
                        # ForkChoiceError here is routine during fork-branch
                        # imports (the block's attestations can reference
                        # ancestors the store hasn't seen yet); anything
                        # else is worth a warning.
                        lvl = (logging.DEBUG if isinstance(e, ForkChoiceError)
                               else logging.WARNING)
                        logging.getLogger("lighthouse_tpu_torch.chain").log(
                            lvl, "on-block attestation skipped in fork "
                            "choice: %r", e)
                for slashing in block.body.attester_slashings:
                    self.fork_choice.on_attester_slashing(
                        slashing.attestation_1)
            self.validator_monitor.on_block_imported(block, indexed_atts,
                                                     block_root=block_root)
            if state.current_epoch() > self._monitored_epoch:
                self._monitored_epoch = state.current_epoch()
                self.validator_monitor.on_epoch_transition(
                    self._monitored_epoch - 1, state)
            self.validator_monitor.note_state(state)
            with tracing.span("db_write"):
                # block + state land as ONE log record: a crash at either
                # side of the batch leaves the store before-or-after, never
                # a block whose post-state is missing
                crashpoint("block_import:before_batch")
                self.store.do_atomically(
                    [StoreOp.put_block(block_root, ep.signed_block),
                     StoreOp.put_state(block.state_root, state)],
                    fsync=False)
                crashpoint("block_import:after_state_write")
                self._cache_snapshot(block_root, state)
            try:
                # serve attestations for this block state-free from now on
                # (early_attester_cache.rs:1-30, attester_cache.rs:1-60)
                self.early_attester_cache.add(self, block_root, block, state)
                self.attester_cache.cache_state(self, state)
                self.eth1_finalization_cache.insert(state, block_root)
            except Exception:               # pragma: no cover - advisory
                pass
        self.events.emit("block", {"slot": block.slot,
                                   "block_root": block_root})
        if self.processor is not None:
            # wake attestations parked on this root
            self.processor.reprocess.on_block_imported(block_root)
        if self.config.enable_light_client_server:
            try:
                self.light_client_cache.on_head_update(ep.signed_block, state)
            except Exception:
                import logging
                logging.getLogger("lighthouse_tpu_torch.chain").exception(
                    "light client cache update failed")
        self.recompute_head()
        return block_root

    def replay_engine(self):
        """graftflow: the epoch-pipelined replay engine for range-sync
        and backfill segments (chain/replay/).  Lazy so
        store-less rigs never pay for the pipeline; the sequential
        :meth:`process_chain_segment` below stays as its bit-exact
        oracle."""
        if self._replay_engine is None:
            # double-checked: the ctor registers with graftwatch, so a
            # losing duplicate would leak a dead registration
            with self._lock:
                if self._replay_engine is None:
                    from .replay import ReplayEngine
                    self._replay_engine = ReplayEngine(self)
        return self._replay_engine

    def process_chain_segment(self, blocks: list) -> int:
        """Range-sync import. Per epoch-aligned chunk: signatures are batched
        and verified FIRST against a cheap slot-advanced state (committees
        and proposers don't depend on the chunk's own blocks), then the full
        state transitions run — so garbage signatures are rejected before any
        expensive per-block processing (block_verification.rs:591 order).
        Returns the number of imported blocks."""
        if not blocks:
            return 0
        blocks = [b for b in blocks
                  if not self.fork_choice.contains_block(htr(b.message))]
        if not blocks:
            return 0
        first = blocks[0].message
        if not self.fork_choice.contains_block(first.parent_root):
            raise BlockError(PARENT_UNKNOWN, first.parent_root.hex())
        from ..state_transition.signature_sets import BlockSignatureVerifier
        spe = self.spec.preset.slots_per_epoch
        chunks: list[list] = []
        for sb in blocks:
            if chunks and chunks[-1][-1].message.slot // spe == \
                    sb.message.slot // spe:
                chunks[-1].append(sb)
            else:
                chunks.append([sb])
        state = self.state_for_block_import(first.parent_root, first.slot)
        staged = []
        prev_root = first.parent_root
        for chunk in chunks:
            # phase 1: batched signature verification on a scratch advance
            # (zeroed state roots — committees/domains don't need them; block
            # roots are patched in from the segment so sync-aggregate signing
            # roots are exact)
            scratch = state.copy()
            p = self.spec.preset
            sets = []
            last_root = prev_root
            for sb in chunk:
                block = sb.message
                while scratch.slot < block.slot:
                    from ..state_transition.slot import per_slot_processing
                    slot_now = scratch.slot
                    per_slot_processing(scratch, state_root=b"\x00" * 32)
                    import numpy as _np
                    scratch.block_roots[
                        slot_now % p.slots_per_historical_root] = \
                        _np.frombuffer(last_root, _np.uint8)
                v = BlockSignatureVerifier(scratch)
                v.include_entire_block(sb, htr(block))
                sets.extend(v.sets)
                last_root = htr(block)
            if sets and not bls.verify_signature_sets(sets):
                raise BlockError("invalid_signature", "chain segment batch")
            # phase 2: real transitions
            for sb in chunk:
                block = sb.message
                root = htr(block)
                if state.slot < block.slot:
                    process_slots(state, block.slot)
                try:
                    with tracing.span("stf_block", slot=int(block.slot)):
                        per_block_processing(state, sb,
                                             VerifySignatures.FALSE,
                                             block_root=root)
                except BlockProcessingError as e:
                    raise BlockError(INVALID_BLOCK, str(e)) from e
                if block.state_root != state.hash_tree_root():
                    raise BlockError(INVALID_BLOCK,
                                     "segment state root mismatch")
                staged.append((sb, root, state.copy()))
            prev_root = staged[-1][1]
        imported = 0
        for sb, root, post in staged:
            payload_status = "irrelevant"
            if post.fork_name >= ForkName.BELLATRIX and \
                    hasattr(sb.message.body, "execution_payload"):
                payload_status = self.execution_layer.notify_new_payload(
                    sb.message.body.execution_payload)
                if payload_status == "invalid":
                    raise BlockError("execution_invalid", root.hex())
            self.import_block(blk_verify.ExecutionPendingBlock(
                sb, root, post, payload_status))
            imported += 1
        return imported

    # -- head ----------------------------------------------------------------

    def recompute_head(self) -> bytes:
        """canonical_head.rs recompute_head_at_current_slot.

        The lock covers only the fork-choice run + head swap; execution-layer
        I/O and store migration happen strictly after release (the
        canonical_head.rs:9-32 'never hold across EL calls' contract).
        """
        with self._lock:
            old = self.canonical_head
            head_root = self.fork_choice.get_head(self.slot())
            if head_root != old.head_block_root:
                head_block = self.store.get_block(head_root)
                head_state = self._state_for(head_root)
                if head_state is None:
                    raise BlockError("missing_state", head_root.hex())
                new_head = CanonicalHead(head_root, head_block, head_state)
                reorg = old.head_block_root != (
                    head_block.message.parent_root if head_block else None)
                self.canonical_head = new_head
                from ..api import metrics_defs as M
                if head_block is not None:
                    self.block_times_cache.on_became_head(
                        head_root, head_block.message.slot)
                M.gauge("beacon_head_slot", int(head_state.slot))
                M.gauge("beacon_finalized_epoch",
                        int(self.fork_choice.finalized_checkpoint[0]))
                M.gauge("beacon_justified_epoch",
                        int(self.fork_choice.justified_checkpoint[0]))
                M.gauge("beacon_head_state_validators_total",
                        len(head_state.validators))
                if reorg:
                    M.count("beacon_reorgs_total")
                self.events.emit("head", {
                    "slot": head_state.slot, "block": head_root,
                    "previous": old.head_block_root})
                if reorg and head_block is not None and \
                        old.head_block is not None and \
                        old.head_block_root != self.genesis_block_root:
                    self.events.emit("chain_reorg", {
                        "old_head": old.head_block_root,
                        "new_head": head_root})
            head_state = self.canonical_head.head_state
            fin_root = self.fork_choice.finalized_checkpoint[1]
        # ---- lock released: blocking work below ----
        self._after_finalization_check()
        if head_state.fork_name >= ForkName.BELLATRIX and \
                head_state.latest_execution_payload_header is not None:
            fin_block = self.store.get_block(fin_root)
            fin_hash = b"\x00" * 32
            if fin_block is not None and \
                    hasattr(fin_block.message.body, "execution_payload"):
                fin_hash = \
                    fin_block.message.body.execution_payload.block_hash
            with tracing.span("el_forkchoice"):
                self.execution_layer.notify_forkchoice_updated(
                    head_state.latest_execution_payload_header.block_hash,
                    fin_hash, fin_hash)
        return head_root

    _last_pruned_finalized = 0

    def _after_finalization_check(self) -> None:
        fin_epoch, fin_root = self.fork_choice.finalized_checkpoint
        if fin_epoch <= self._last_pruned_finalized or fin_epoch == 0:
            return
        self._last_pruned_finalized = fin_epoch
        p = self.spec.preset
        fin_slot = fin_epoch * p.slots_per_epoch
        self.observed_block_producers.prune(fin_slot)
        self.observed_blob_sidecars.prune(fin_slot)
        self.observed_data_columns.prune(fin_slot)
        self.observed_slashable.prune(fin_slot)
        self.observed_attesters.prune(fin_epoch - 1)
        self.observed_aggregators.prune(fin_slot)
        self.observed_aggregates.prune(fin_slot)
        self.observed_sync_contributors.prune(fin_slot)
        self.sync_committee_pool.prune(fin_slot)
        self.data_availability_checker.prune(fin_slot)
        self.validator_monitor.prune(max(0, fin_epoch - 4))
        self.block_times = {r: t for r, t in self.block_times.items()
                            if t.get("slot", 0) > fin_slot}
        self.fork_choice.prune()
        # eth1 deposit-tracker pruning from the cached boundary snapshot
        # (eth1_finalization_cache.rs): no state read at finalization time
        eth1_snap = self.eth1_finalization_cache.finalize(fin_epoch,
                                                          fin_root)
        if eth1_snap is not None and self.eth1_service is not None:
            try:
                self.eth1_service.finalize(eth1_snap)
            except Exception:               # pragma: no cover - advisory
                pass
        self.events.emit("finalized_checkpoint",
                         {"epoch": fin_epoch, "root": fin_root})
        # migrate finalized data to the freezer
        fin_block = self.store.get_block(fin_root)
        if fin_block is not None:
            canonical: dict[int, bytes] = {}
            last_root = None
            for root, slot in self.store.iter_block_roots_back(fin_root):
                canonical[slot] = root
                if slot <= self.store.split.slot:
                    break
            # fill skipped slots with the most recent root at-or-before
            filled: dict[int, bytes] = {}
            cur = None
            for s in range(self.store.split.slot, fin_slot + 1):
                if s in canonical:
                    cur = canonical[s]
                if cur is not None:
                    filled[s] = cur
            self.store.migrate_database(
                fin_slot, fin_block.message.state_root, fin_root, filled)
        self.op_pool.prune(self.canonical_head.head_state)
        self.persist()

    def persist(self) -> None:
        """Write fork choice + head + op pool for restart resume
        (persisted_fork_choice.rs / persist_head, beacon_chain.rs:612)."""
        from .persistence import persist_chain
        persist_chain(self)

    def resume(self) -> bool:
        """FromStore boot: restore fork choice/head/op pool."""
        from .persistence import resume_chain
        return resume_chain(self)

    # -- per-slot tasks ------------------------------------------------------

    def watch_validator_pubkey(self, pk: bytes) -> None:
        """Queue a --validator-monitor pubkey that is not in the registry
        yet; per_slot_task re-resolves the list each slot. Locked: the
        slot timer drains the list concurrently with callers."""
        with self._lock:
            self.monitor_pubkeys_pending.append(pk)

    def per_slot_task(self) -> None:
        """timer/src/lib.rs tick + state_advance_timer: advance fork choice
        time and pre-advance the head state across the epoch boundary."""
        slot = self.slot()
        with self._lock:
            self.fork_choice.update_time(slot)
        # graftwatch slot tick: sample the catalog, evaluate SLOs (the
        # first node of an in-process network to reach this slot does
        # the work; the facade dedupes the rest)
        from ..obs import graftwatch
        graftwatch.on_slot(slot)
        with self._lock:
            pending = self.monitor_pubkeys_pending
            self.monitor_pubkeys_pending = []
        if pending:
            registry = self.head().head_state.validators
            still = []
            for pk in pending:
                idx = registry.index_of(pk)
                if idx is not None:
                    self.validator_monitor.register_validator(idx)
                else:
                    still.append(pk)
            if still:
                with self._lock:
                    # keep anything watch_validator_pubkey added while
                    # we were resolving against the registry
                    self.monitor_pubkeys_pending = \
                        still + self.monitor_pubkeys_pending
        from .hot_caches import state_advance
        try:
            state_advance(self, slot)
        except Exception:                   # pragma: no cover - advisory
            import logging
            logging.getLogger("lighthouse_tpu_torch.chain").exception(
                "state-advance timer failed")
        if self.processor is not None:
            # replay gossip parked for this slot (early blocks /
            # future-slot attestations, work_reprocessing_queue.rs)
            self.processor.reprocess.on_slot(slot)

    # -- attestation entry points -------------------------------------------

    def verify_unaggregated_attestation_for_gossip(self, attestation,
                                                   subnet_id=None):
        return att_verify.verify_unaggregated_for_gossip(self, attestation,
                                                         subnet_id)

    def batch_verify_unaggregated_attestations_for_gossip(self, pairs):
        return att_verify.batch_verify_unaggregated_for_gossip(self, pairs)

    def verify_aggregated_attestation_for_gossip(self, signed_aggregate):
        return att_verify.verify_aggregated_for_gossip(self, signed_aggregate)

    def batch_verify_aggregated_attestations_for_gossip(self, aggs):
        return att_verify.batch_verify_aggregated_for_gossip(self, aggs)

    def apply_attestation_to_fork_choice(self, verified) -> None:
        with self._lock:
            self.fork_choice.on_attestation(self.slot(), verified.indexed,
                                            is_from_block=False)
        from ..api import metrics_defs as M
        M.count("beacon_attestations_imported_total")

    def add_to_op_pool(self, verified_attestation) -> None:
        att = getattr(verified_attestation, "attestation", None)
        if att is None:
            att = verified_attestation.signed_aggregate.message.aggregate
        self.op_pool.insert_attestation(att)

    # -- late-block re-orgs --------------------------------------------------

    def get_proposer_head(self, slot: int) -> bytes:
        """Block root to build on at `slot`: the head, or its parent when the
        head arrived late and is weakly attested (the late-block re-org,
        beacon_chain/src/{proposer_prep,fork_revert} + book/late-block-re-orgs:
        cutoff spec fields reorg_*)."""
        with self._lock:
            # refresh weights (queued votes -> deltas) before reading them
            self.fork_choice.get_head(slot)
            head = self.canonical_head
            head_root = head.head_block_root
            node = self.fork_choice.proto_array.get(head_root)
        if node is None or node.parent is None:
            return head_root
        spec = self.spec
        p = spec.preset
        # single-slot, non-epoch-boundary re-orgs only
        if node.slot != slot - 1 or slot % p.slots_per_epoch == 0:
            return head_root
        # recent finalization
        fin_epoch, _ = self.fork_choice.finalized_checkpoint
        if slot // p.slots_per_epoch - fin_epoch > \
                spec.reorg_max_epochs_since_finalization:
            return head_root
        # the head must have arrived after the attestation deadline
        times = self.block_times.get(head_root, {})
        delay = times.get("delay")
        arrived_late = (delay is None and times.get("observed_slot", node.slot)
                        > node.slot) or \
            (delay is not None and delay > spec.seconds_per_slot / 3)
        if not arrived_late:
            return head_root
        # weak head, strong parent (thresholds are % of one committee weight)
        from ..state_transition.helpers import get_total_active_balance
        committee_weight = get_total_active_balance(head.head_state) \
            // p.slots_per_epoch
        parent = self.fork_choice.proto_array.nodes[node.parent]
        if node.weight * 100 >= \
                committee_weight * spec.reorg_head_weight_threshold:
            return head_root
        if parent.weight * 100 < \
                committee_weight * spec.reorg_parent_weight_threshold:
            return head_root
        return parent.root

    # -- block production ----------------------------------------------------

    def produce_block(self, randao_reveal: bytes, slot: int,
                      graffiti: bytes | None = None,
                      skip_randao_verification: bool = False,
                      sync_aggregate=None):
        """3-phase production (beacon_chain.rs:4810): (1) state advance +
        op-pool packing, (2) payload retrieval, (3) completion + state root.
        Returns (block, post_state)."""
        from ..api import metrics_defs as M
        with tracing.span("block_production", slot=int(slot)):
            out = self._produce_block_inner(
                randao_reveal, slot, graffiti, skip_randao_verification,
                sync_aggregate)
        M.count("beacon_block_production_total")
        return out

    def _produce_block_inner(self, randao_reveal: bytes, slot: int,
                             graffiti: bytes | None,
                             skip_randao_verification: bool,
                             sync_aggregate):
        if graffiti is None:
            graffiti = self.default_graffiti
        parent_root = self.get_proposer_head(slot)
        with self._lock:
            head = self.canonical_head
            if parent_root == head.head_block_root:
                state = head.head_state.copy()
            else:
                state = None
        if state is None:  # re-orging out the weak head
            state = self.state_for_block_production(parent_root, slot)
        if state.slot < slot:
            process_slots(state, slot)
        fork = state.fork_name
        T = self.T
        proposer_index = get_beacon_proposer_index(state, slot)

        attestations = self.op_pool.get_attestations_for_block(state)
        proposer_sl, attester_sl, exits, changes = \
            self.op_pool.get_slashings_and_exits(state)

        # eth1 voting + mandatory deposits (eth1/src/service.rs)
        eth1_data = state.eth1_data
        deposits = []
        if self.eth1_service is not None:
            eth1_data = self.eth1_service.eth1_data_for_block(state)
            from ..state_transition.block import process_eth1_data
            scratch = state.copy()
            process_eth1_data(scratch, eth1_data)
            deposits = self.eth1_service.deposits_for_block(scratch)

        body_cls = T.BeaconBlockBody[fork]
        body = body_cls(
            randao_reveal=randao_reveal,
            eth1_data=eth1_data, graffiti=graffiti,
            proposer_slashings=proposer_sl,
            attester_slashings=attester_sl,
            attestations=attestations, deposits=deposits,
            voluntary_exits=exits)
        if fork >= ForkName.CAPELLA:
            body.bls_to_execution_changes = changes
        if fork >= ForkName.ALTAIR:
            if sync_aggregate is None:
                # pull pooled sync messages signed over the parent at slot-1
                sync_aggregate = self.sync_committee_pool.\
                    produce_sync_aggregate(max(slot, 1) - 1, parent_root)
            body.sync_aggregate = sync_aggregate
        if fork >= ForkName.BELLATRIX:
            body.execution_payload = self._payload_for_block(
                state, fork, proposer_index)

        block = T.BeaconBlock[fork](
            slot=slot, proposer_index=proposer_index,
            parent_root=parent_root, state_root=b"\x00" * 32, body=body)
        signed_cls = T.SignedBeaconBlock[fork]
        unsigned = signed_cls(message=block,
                              signature=bls.INFINITY_SIGNATURE)
        post = state.copy()
        per_block_processing(post, unsigned, VerifySignatures.FALSE)
        block.state_root = post.hash_tree_root()
        return block, post

    def _empty_sync_aggregate(self):
        return self.T.SyncAggregate(
            sync_committee_bits=[False] * self.spec.preset.sync_committee_size,
            sync_committee_signature=bls.INFINITY_SIGNATURE)

    # -- proposer preparation + builder/MEV ----------------------------------

    LOCAL_PAYLOAD_VALUE_WEI = 10**9   # mock-EL local block value

    def register_proposer_preparation(self, entries) -> None:
        """prepare_beacon_proposer VC->BN plumbing
        (validator_client/src/preparation_service.rs)."""
        for e in entries:
            idx = int(e["validator_index"])
            fee = e["fee_recipient"]
            if isinstance(fee, str):
                fee = bytes.fromhex(fee[2:] if fee.startswith("0x") else fee)
            self.prepared_proposers[idx] = fee

    def register_validators(self, registrations: list[dict]) -> None:
        """SignedValidatorRegistration intake; forwarded to the builder."""
        for r in registrations:
            msg = r.get("message", r)
            self.validator_registrations[msg["pubkey"]] = r
        if self.builder is not None:
            self.builder.register_validators(registrations)

    def fee_recipient_for(self, proposer_index: int) -> bytes:
        return self.prepared_proposers.get(int(proposer_index),
                                           self.default_fee_recipient)

    def prepare_payload_attributes(self, next_slot: int) -> None:
        """Per-slot payload-attribute preparation: tell the EL who
        proposes next so payload building starts early
        (execution_layer payload-attributes flow)."""
        if self.head().head_state.fork_name < ForkName.BELLATRIX:
            return
        st = self.head().head_state
        scratch = st.copy()
        if scratch.slot < next_slot:
            process_slots(scratch, next_slot)
        proposer = get_beacon_proposer_index(scratch, next_slot)
        if proposer not in self.prepared_proposers:
            return
        head_hash = st.latest_execution_payload_header.block_hash
        # engine-API PayloadAttributes shape (camelCase, 0x-hex) so the
        # REAL EngineApiClient can serialize it, not just the mock
        attrs = {
            "timestamp": hex(compute_timestamp_at_slot(scratch, next_slot)),
            "prevRandao": "0x" + scratch.get_randao_mix(
                scratch.current_epoch()).hex(),
            "suggestedFeeRecipient": "0x"
            + self.fee_recipient_for(proposer).hex(),
        }
        if scratch.fork_name >= ForkName.CAPELLA:
            withdrawals, _ = get_expected_withdrawals(scratch)
            attrs["withdrawals"] = [{
                "index": hex(w.index),
                "validatorIndex": hex(w.validator_index),
                "address": "0x" + w.address.hex(),
                "amount": hex(w.amount)} for w in withdrawals]
        self.execution_layer.notify_forkchoice_updated(
            head_hash, head_hash, head_hash, payload_attributes=attrs)

    def build_payload_on_parent(self, slot: int, parent_hash: bytes,
                                fee_recipient: bytes,
                                extra_entropy: bytes = b""):
        """Deterministic payload construction on an execution parent (the
        mock builder and the local path share this)."""
        st = self.head().head_state
        if st.latest_execution_payload_header.block_hash != parent_hash:
            raise BlockError(INVALID_BLOCK,
                             "unknown execution parent for payload")
        scratch = st.copy()
        if scratch.slot < slot:
            process_slots(scratch, slot)
        return self._produce_payload(scratch, scratch.fork_name,
                                     fee_recipient, extra_entropy)

    def _payload_for_block(self, state: BeaconState, fork: ForkName,
                           proposer_index: int):
        """Local payload vs builder bid (execution_layer/src/lib.rs:807):
        take the builder's when its boosted value beats the local one."""
        fee = self.fee_recipient_for(proposer_index)
        local = self._produce_payload(state, fork, fee)
        source = "local"
        payload = local
        pubkey = state.validators.pubkey(proposer_index)
        registered = "0x" + pubkey.hex() in self.validator_registrations
        if self.builder is not None and registered:
            # ANY builder fault degrades to the local payload — a proposer
            # must never miss its slot because of the builder
            try:
                parent_hash = \
                    state.latest_execution_payload_header.block_hash
                bid = self.builder.get_header(state.slot, parent_hash,
                                              pubkey)
                if bid is not None and \
                        bid["value"] * self.builder_boost_factor // 100 > \
                        self.LOCAL_PAYLOAD_VALUE_WEI:
                    block_hash = bytes.fromhex(
                        bid["header"]["blockHash"][2:])
                    pj = self.builder.submit_blinded_block(block_hash)
                    if pj is not None:
                        from ..execution_layer.execution_layer import (
                            payload_from_json,
                        )
                        payload = payload_from_json(self.T, fork, pj)
                        source = "builder"
            except Exception:
                import logging
                logging.getLogger("lighthouse_tpu_torch.chain").warning(
                    "builder flow failed; using local payload",
                    exc_info=True)
                payload, source = local, "local"
        self.block_production_log.append(
            {"slot": state.slot, "source": source,
             "fee_recipient": payload.fee_recipient})
        return payload

    def _produce_payload(self, state: BeaconState, fork: ForkName,
                         fee_recipient: bytes = b"\x00" * 20,
                         extra_entropy: bytes = b""):
        """Local mock-EL payload (the real EL round-trip lives in
        lighthouse_tpu_torch.execution_layer)."""
        import hashlib
        cls = self.T.ExecutionPayload[fork]
        parent_hash = state.latest_execution_payload_header.block_hash
        block_hash = hashlib.sha256(
            b"payload" + state.slot.to_bytes(8, "little") + parent_hash
            + fee_recipient + extra_entropy).digest()
        kw = dict(
            parent_hash=parent_hash,
            fee_recipient=fee_recipient,
            prev_randao=state.get_randao_mix(state.current_epoch()),
            block_number=state.latest_execution_payload_header.block_number
            + 1,
            timestamp=compute_timestamp_at_slot(state, state.slot),
            block_hash=block_hash,
            base_fee_per_gas=7)
        if fork >= ForkName.CAPELLA:
            withdrawals, _ = get_expected_withdrawals(state)
            kw["withdrawals"] = withdrawals
        return cls(**kw)

    # -- processing status ---------------------------------------------------

    def is_optimistic_head(self) -> bool:
        with self._lock:
            return self.fork_choice.is_optimistic(
                self.canonical_head.head_block_root)

    def block_root_at_slot(self, slot: int) -> bytes | None:
        """Canonical block root at slot, from the head state's history."""
        with self._lock:
            st = self.canonical_head.head_state
            p = self.spec.preset
            if slot == st.slot:
                return self.canonical_head.head_block_root
            if slot < st.slot <= slot + p.slots_per_historical_root:
                return st.get_block_root_at_slot(slot)
        root = self.store.freezer_block_root_at_slot(slot)
        return root
