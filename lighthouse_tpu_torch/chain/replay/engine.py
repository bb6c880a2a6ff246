"""The graftflow replay pipeline.

Replays a linkage-validated block segment (range sync, parent-chain
lookups, checkpoint backfill) through explicit stages with bounded
hand-off queues, batching every per-block cost that is really a
per-epoch cost:

1. **admission** (caller thread) — known-block filter, parent check,
   epoch chunking.  Segments arrive already linkage/continuity-proved
   by download-time validation (network/sync/validation.py), so no
   structural re-checks run here.
2. **signature** (worker thread) — one ``verify_signature_sets`` call
   over a whole epoch of blocks, against a cheap slot-advanced scratch
   state exactly like the sequential path's phase 1.  Proposal sets of
   blocks whose exact root already passed the gossip-edge proposer
   check (``observed_block_producers`` records a root only *after* a
   successful signature verify) are dropped and counted as
   ``replay_sigs_deduped_total`` — the redundant re-verification the
   sequential path performs on every lookup segment.
3. **state transition** (caller thread) — per-block processing on the
   copy-on-write state with **deferred merkleization**: slots that carry a
   block complete with the block's *claimed* ``state_root`` patched in
   (``per_slot_processing(state, state_root=...)``) instead of a fresh
   ``hash_tree_root``; only empty slots force a partial flush of the
   incremental hashers.
4. **merkle flush** (caller thread) — ONE ``hash_tree_root`` per epoch.
   The claimed roots were hashed into ``state_roots`` and the block-root
   chain, so the flushed root matching the last block's claimed root
   validates the epoch; any corrupted intermediate root diverges the
   final state and the whole epoch is rejected.  Validation granularity
   is therefore the epoch, not the block: a mismatch rejects the epoch
   atomically (the sequential oracle rejects at the first bad block —
   both import nothing from the failing epoch and penalize the segment's
   peers identically).
5. **commit** (worker thread) — one atomic ``StoreOp`` batch per
   epoch as the single durability point, fork-choice/head updates
   applied at commit, ONE ``recompute_head`` per epoch.
   ``crashpoint("replay:before_epoch_commit")`` /
   ``"replay:after_epoch_commit"`` bracket the batch so the recovery
   suite can kill mid-epoch and prove the store's recovery ladder reopens to an
   fsck-clean store at the last committed epoch boundary.

Every stage opens a graftscope span (``replay_*`` kinds), so
``obs/critpath.py`` measures the overlap actually won and graftwatch's
occupancy history shows which stage saturates.  The sequential import
path (``BeaconChain.process_chain_segment``) stays untouched as the
bit-exact oracle: for a valid segment both produce identical head
roots, state roots and store content (the per-epoch batch flattens to
the same per-block ``put_block``/``put_state`` KV ops).
"""
from __future__ import annotations

import queue
import threading
import time
import weakref

import numpy as np

from ...api import metrics_defs as M
from ...crypto import bls
from ...obs import tracing
from ...specs.chain_spec import ForkName
from ...ssz import htr
from ...state_transition import VerifySignatures, per_block_processing
from ...state_transition.block import BlockProcessingError
from ...state_transition.signature_sets import BlockSignatureVerifier
from ...state_transition.slot import per_slot_processing
from ...store import StoreOp
from ...utils.crashpoints import crashpoint
from ..errors import INVALID_BLOCK, PARENT_UNKNOWN, BlockError

#: pipeline stage labels, in hand-off order
STAGES = ("admission", "signature", "stf", "merkle", "commit")

#: default bound of each hand-off queue — deep enough to overlap, small
#: enough that a stalled commit back-pressures the state transition
#: instead of buffering unbounded CoW states
QUEUE_DEPTH = 2


def replay_segment_sequential(chain, blocks: list) -> int:
    """The block-at-a-time oracle graftflow must match bit-for-bit."""
    return chain.process_chain_segment(blocks)


class _AbortLatch:
    """First-error-wins failure latch shared by all three threads."""

    def __init__(self):
        self.event = threading.Event()
        self._lock = threading.Lock()
        self.err: BaseException | None = None

    def fail(self, err: BaseException) -> None:
        with self._lock:
            if self.err is None:
                self.err = err
        self.event.set()

    @property
    def tripped(self) -> bool:
        return self.event.is_set()


class ReplayEngine:
    """One per chain (``BeaconChain.replay_engine()``); serializes
    segments through an internal lock — range sync, lookups and
    backfill all funnel through the same pipeline."""

    def __init__(self, chain, queue_depth: int = QUEUE_DEPTH):
        self._chain = weakref.ref(chain)
        self.queue_depth = queue_depth
        self._segment_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._busy = {st: 0.0 for st in STAGES}
        self._queue_high_water = {"signature": 0, "commit": 0}
        self._live_queues: dict[str, queue.Queue] = {}
        self._active = False
        self.commit_seq = 0             # epochs committed, ever
        self.blocks_committed = 0
        self.segments_replayed = 0
        self.sigs_deduped = 0
        self.backfill_batches = 0
        self.last_segment: dict | None = None
        from ...obs import graftwatch
        graftwatch.register_replay(self)

    # -- bookkeeping ------------------------------------------------------

    def _charge(self, stage: str, seconds: float) -> None:
        with self._state_lock:
            self._busy[stage] += max(0.0, seconds)

    def _put(self, q: queue.Queue, name: str, item) -> None:
        q.put(item)
        depth = q.qsize()
        with self._state_lock:
            if depth > self._queue_high_water[name]:
                self._queue_high_water[name] = depth
        M.gauge(f"replay_queue_depth_{name}", depth)

    # -- stage 1: admission ----------------------------------------------

    def _admit(self, chain, blocks: list) -> list[list]:
        """Known-block filter + parent check + epoch chunking (the same
        preamble as the sequential path)."""
        blocks = [b for b in blocks
                  if not chain.fork_choice.contains_block(htr(b.message))]
        if not blocks:
            return []
        first = blocks[0].message
        if not chain.fork_choice.contains_block(first.parent_root):
            raise BlockError(PARENT_UNKNOWN, first.parent_root.hex())
        spe = chain.spec.preset.slots_per_epoch
        chunks: list[list] = []
        for sb in blocks:
            if chunks and chunks[-1][-1].message.slot // spe == \
                    sb.message.slot // spe:
                chunks[-1].append(sb)
            else:
                chunks.append([sb])
        return chunks

    # -- stage 2: epoch-amortized signature verification -------------------

    def _verify_epoch_signatures(self, chain, scratch, chunk,
                                 prev_root: bytes) -> None:
        """Sequential phase 1 logic (zeroed state roots, block roots
        patched from the segment) + the gossip-dedup fix: proposal sets
        whose exact root the gossip edge already verified are dropped."""
        p = chain.spec.preset
        sets = []
        deduped = 0
        last_root = prev_root
        for sb in chunk:
            block = sb.message
            while scratch.slot < block.slot:
                slot_now = scratch.slot
                per_slot_processing(scratch, state_root=b"\x00" * 32)
                scratch.block_roots[
                    slot_now % p.slots_per_historical_root] = \
                    np.frombuffer(last_root, np.uint8)
            root = htr(block)
            v = BlockSignatureVerifier(scratch)
            v.include_entire_block(sb, root)
            if chain.observed_block_producers.proposer_has_been_observed(
                    int(block.slot), int(block.proposer_index),
                    root) == "duplicate":
                # observe() runs only after the gossip proposer-signature
                # check passed, so this exact proposal set is proved —
                # the set is always first (into_signature_verified's
                # proposal_already_verified contract)
                v.sets = v.sets[1:]
                deduped += 1
            sets.extend(v.sets)
            last_root = root
        if deduped:
            M.count("replay_sigs_deduped_total", deduped)
            with self._state_lock:
                self.sigs_deduped += deduped
        if sets and not bls.verify_signature_sets(sets):
            raise BlockError("invalid_signature", "replay epoch batch")

    def _signature_worker(self, chain, sig_q: queue.Queue,
                          abort: _AbortLatch) -> None:
        """Drains until the sentinel even when aborted, so the producer's
        bounded put can never deadlock."""
        while True:
            job = sig_q.get()
            M.gauge("replay_queue_depth_signature", sig_q.qsize())
            if job is None:
                return
            epoch_idx, chunk, scratch, prev_root, holder = job
            if abort.tripped:
                holder["err"] = abort.err
                holder["event"].set()
                continue
            t0 = time.perf_counter()
            try:
                with tracing.span("replay_signature",
                                  slot=int(chunk[-1].message.slot),
                                  block_root=htr(chunk[-1].message),
                                  epoch_idx=epoch_idx):
                    self._verify_epoch_signatures(chain, scratch, chunk,
                                                  prev_root)
                holder["err"] = None
            except BaseException as e:
                holder["err"] = e
                abort.fail(e)
            finally:
                holder["event"].set()
                self._charge("signature", time.perf_counter() - t0)

    # -- stage 3+4: state transition with deferred merkleization -----------

    def _stf_epoch(self, chain, state, chunk,
                   pending_claimed: bytes | None):
        """Run one epoch chunk; returns (staged, last claimed root).
        ``pending_claimed`` is the claimed post-state root of the block
        sitting at ``state.slot`` (None at the segment head, where the
        pre-state advance already computed real roots)."""
        staged = []
        for sb in chunk:
            block = sb.message
            root = htr(block)
            while state.slot < block.slot:
                # the slot holding a block completes with the block's
                # claimed state root; empty slots force a real (partial,
                # incremental) flush
                per_slot_processing(state, state_root=pending_claimed)
                pending_claimed = None
            try:
                with tracing.span("replay_stf", slot=int(block.slot),
                                  block_root=root):
                    per_block_processing(state, sb, VerifySignatures.FALSE,
                                         block_root=root)
            except BlockProcessingError as e:
                raise BlockError(INVALID_BLOCK, str(e)) from e
            pending_claimed = block.state_root
            staged.append((sb, root, state.copy()))
        return staged, pending_claimed

    def _flush_epoch(self, state, staged) -> None:
        """ONE incremental-hasher flush per epoch; the claimed roots are
        chained through ``state_roots``/``latest_block_header``, so the
        final computed root matching the last claimed root validates the
        epoch's whole claimed-root chain."""
        last_sb, last_root, _ = staged[-1]
        t0 = time.perf_counter()
        with tracing.span("replay_merkle", slot=int(last_sb.message.slot),
                          block_root=last_root, n_blocks=len(staged)):
            real = state.hash_tree_root()
        self._charge("merkle", time.perf_counter() - t0)
        if real != last_sb.message.state_root:
            raise BlockError(INVALID_BLOCK,
                             "replay epoch state root mismatch")

    # -- stage 5: one atomic commit per epoch ------------------------------

    def _commit_epoch(self, chain, staged) -> None:
        """import_block's side effects, batched per epoch: EL payloads,
        fork choice + on-block attestations, ONE atomic store batch as
        the durability point, caches, ONE head recompute."""
        from ...fork_choice.proto_array import ExecutionStatus
        status_map = {"valid": ExecutionStatus.VALID,
                      "optimistic": ExecutionStatus.OPTIMISTIC,
                      "irrelevant": ExecutionStatus.IRRELEVANT}
        entries = []
        ops = []
        for sb, root, post in staged:
            payload_status = "irrelevant"
            if post.fork_name >= ForkName.BELLATRIX and \
                    hasattr(sb.message.body, "execution_payload"):
                payload_status = chain.execution_layer.notify_new_payload(
                    sb.message.body.execution_payload)
                if payload_status == "invalid":
                    raise BlockError("execution_invalid", root.hex())
            delay = None
            if chain.slot_clock.now() == sb.message.slot:
                delay = chain.slot_clock.seconds_into_slot()
            chain.block_times[root] = {"slot": sb.message.slot,
                                       "delay": delay,
                                       "observed_slot": chain.slot()}
            chain.block_times_cache.on_imported(root, sb.message.slot)
            M.count("beacon_block_imported_total")
            ops.append(StoreOp.put_block(root, sb))
            # `post` is block `root`'s post-state: its latest_block_header
            # (state_root filled with the claimed root the epoch flush
            # validates) hashes to `root` itself — passing it spares the
            # store a full-state hash flush per staged copy
            ops.append(StoreOp.put_state(sb.message.state_root, post,
                                         latest_block_root=root))
            entries.append((sb, root, post, payload_status, delay))
        last_block = entries[-1][0].message
        current_slot = max(chain.slot(), int(last_block.slot))
        from ...state_transition.helpers import get_indexed_attestation
        with chain._lock:
            with tracing.span("fork_choice",
                              block_root=entries[-1][1]):
                for sb, root, post, ps, delay in entries:
                    chain.fork_choice.on_block(
                        current_slot, sb.message, root, post,
                        block_delay_seconds=delay,
                        execution_status=status_map[ps])
                    indexed_atts = []
                    for att in sb.message.body.attestations:
                        try:
                            indexed = get_indexed_attestation(post, att)
                            indexed_atts.append(indexed)
                            chain.fork_choice.on_attestation(
                                current_slot, indexed, is_from_block=True)
                        except Exception as e:  # best-effort, as import_block
                            import logging

                            from ...fork_choice import ForkChoiceError
                            lvl = (logging.DEBUG
                                   if isinstance(e, ForkChoiceError)
                                   else logging.WARNING)
                            logging.getLogger("lighthouse_tpu_torch.chain").log(
                                lvl, "replay on-block attestation skipped "
                                "in fork choice: %r", e)
                    for slashing in sb.message.body.attester_slashings:
                        chain.fork_choice.on_attester_slashing(
                            slashing.attestation_1)
                    chain.validator_monitor.on_block_imported(
                        sb.message, indexed_atts, block_root=root)
                    if post.current_epoch() > chain._monitored_epoch:
                        chain._monitored_epoch = post.current_epoch()
                        chain.validator_monitor.on_epoch_transition(
                            chain._monitored_epoch - 1, post)
                    chain.validator_monitor.note_state(post)
            with tracing.span("db_write", n_ops=len(ops)):
                # the whole epoch lands as ONE log record: a crash at
                # either side leaves the store at an epoch boundary
                crashpoint("replay:before_epoch_commit")
                chain.store.do_atomically(ops, fsync=False)
                crashpoint("replay:after_epoch_commit")
                for sb, root, post, _ps, _d in entries:
                    chain._cache_snapshot(root, post)
            try:
                for sb, root, post, _ps, _d in entries:
                    chain.early_attester_cache.add(chain, root,
                                                   sb.message, post)
                    chain.attester_cache.cache_state(chain, post)
                    chain.eth1_finalization_cache.insert(post, root)
            except Exception:               # pragma: no cover - advisory
                pass
        for sb, root, post, _ps, _d in entries:
            chain.events.emit("block", {"slot": sb.message.slot,
                                        "block_root": root})
            if chain.processor is not None:
                chain.processor.reprocess.on_block_imported(root)
        if chain.config.enable_light_client_server:
            # the head moves ONCE per epoch commit, so only the last
            # block is a head update.  Per-block calls here would also
            # re-derive each parent's post-state through the store's
            # summary-replay path (the snapshot cache holds only the
            # freshest states) — per-epoch, the parent sits in the
            # cache that the db_write above just filled.
            try:
                sb, _root, post, _ps, _d = entries[-1]
                chain.light_client_cache.on_head_update(sb, post)
            except Exception:
                import logging
                logging.getLogger("lighthouse_tpu_torch.chain").exception(
                    "light client cache update failed")
        chain.recompute_head()

    def _commit_worker(self, chain, commit_q: queue.Queue,
                       abort: _AbortLatch, committed: dict) -> None:
        dead = False            # stop at the FIRST failing epoch, in order
        while True:
            job = commit_q.get()
            M.gauge("replay_queue_depth_commit", commit_q.qsize())
            if job is None:
                return
            epoch_idx, staged, holder = job
            # the epoch's OWN signature verdict gates its commit — the
            # global latch alone must not: a later epoch's failure may
            # trip it while earlier valid epochs still sit in this
            # queue, and the committed prefix has to be deterministic
            # (exactly the epochs before the first failing one)
            holder["event"].wait()
            if holder["err"] is not None:
                abort.fail(holder["err"])
                dead = True
            if dead:
                continue
            t0 = time.perf_counter()
            try:
                with tracing.span("replay_commit",
                                  slot=int(staged[-1][0].message.slot),
                                  block_root=staged[-1][1],
                                  n_blocks=len(staged),
                                  epoch_idx=epoch_idx):
                    self._commit_epoch(chain, staged)
                with self._state_lock:
                    self.commit_seq += 1
                    self.blocks_committed += len(staged)
                committed["blocks"] += len(staged)
                committed["epochs"] += 1
                M.count("replay_blocks_committed_total", len(staged))
                M.count("replay_epochs_committed_total")
            except BaseException as e:
                abort.fail(e)
                dead = True
            finally:
                self._charge("commit", time.perf_counter() - t0)

    # -- the pipeline -----------------------------------------------------

    def replay_segment(self, blocks: list) -> int:
        """Replay a linkage-proved segment; returns blocks imported.

        Raises :class:`BlockError` exactly like the sequential path.  On
        a mid-segment failure, epochs committed before the failing one
        stay imported (each commit is atomic); the sync layer re-filters
        known blocks on retry, so partial progress is never re-done.
        """
        chain = self._chain()
        if chain is None:
            raise RuntimeError("replay engine outlived its chain")
        with self._segment_lock:
            return self._replay_segment_locked(chain, blocks)

    def _replay_segment_locked(self, chain, blocks: list) -> int:
        t_seg = time.perf_counter()
        t0 = t_seg
        with tracing.span("replay_admission", n_blocks=len(blocks)):
            chunks = self._admit(chain, blocks)
        self._charge("admission", time.perf_counter() - t0)
        if not chunks:
            return 0
        first = chunks[0][0].message
        state = chain.state_for_block_import(first.parent_root, first.slot)

        abort = _AbortLatch()
        sig_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        commit_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        committed = {"blocks": 0, "epochs": 0}
        with self._state_lock:
            self._busy = {st: 0.0 for st in STAGES}
            self._queue_high_water = {"signature": 0, "commit": 0}
            self._live_queues = {"signature": sig_q, "commit": commit_q}
            self._active = True
        M.gauge("replay_active", 1)
        sig_t = threading.Thread(
            target=self._signature_worker, args=(chain, sig_q, abort),
            name="graftflow-sig", daemon=True)
        commit_t = threading.Thread(
            target=self._commit_worker,
            args=(chain, commit_q, abort, committed),
            name="graftflow-commit", daemon=True)
        sig_t.start()
        commit_t.start()
        try:
            prev_root = first.parent_root
            pending_claimed: bytes | None = None
            for epoch_idx, chunk in enumerate(chunks):
                if abort.tripped:
                    break
                holder = {"event": threading.Event(), "err": None}
                # scratch copy taken BEFORE the stf mutates in place:
                # sig-verify of epoch k overlaps the stf of epoch k
                self._put(sig_q, "signature",
                          (epoch_idx, chunk, state.copy(), prev_root,
                           holder))
                t0 = time.perf_counter()
                staged, pending_claimed = self._stf_epoch(
                    chain, state, chunk, pending_claimed)
                self._charge("stf", time.perf_counter() - t0)
                self._flush_epoch(state, staged)
                self._put(commit_q, "commit", (epoch_idx, staged, holder))
                prev_root = staged[-1][1]
        except BaseException as e:
            abort.fail(e)
        finally:
            sig_q.put(None)
            commit_q.put(None)
            sig_t.join()
            commit_t.join()
            elapsed = time.perf_counter() - t_seg
            with self._state_lock:
                self._active = False
                self._live_queues = {}
                self.segments_replayed += 1
                busy = dict(self._busy)
                self.last_segment = {
                    "blocks": committed["blocks"],
                    "epochs": committed["epochs"],
                    "seconds": elapsed,
                    "epochs_per_sec": (committed["epochs"] / elapsed
                                       if elapsed > 0 else 0.0),
                    "occupancy": {st: (min(1.0, busy[st] / elapsed)
                                       if elapsed > 0 else 0.0)
                                  for st in STAGES},
                    "queue_high_water": dict(self._queue_high_water),
                }
            M.gauge("replay_active", 0)
            M.gauge("replay_queue_depth_signature", 0)
            M.gauge("replay_queue_depth_commit", 0)
        if abort.err is not None:
            raise abort.err
        return committed["blocks"]

    # -- checkpoint backfill ----------------------------------------------

    def backfill_batch(self, pairs: list) -> int:
        """Store one validated backfill batch as ONE atomic hot batch
        (root, signed_block) pairs, newest first as backfill walks), then
        the freezer roots.  Hot-first ordering is preserved at batch
        granularity: a crash between the two leaves a re-downloadable
        gap, never a freezer root pointing at a missing block."""
        chain = self._chain()
        if chain is None or not pairs:
            return 0
        t0 = time.perf_counter()
        with tracing.span("replay_commit", n_blocks=len(pairs),
                          block_root=pairs[0][0], backfill=True):
            chain.store.do_atomically(
                [StoreOp.put_block(root, sb) for root, sb in pairs],
                fsync=False)
            for root, sb in pairs:
                chain.store.freezer_put_block_root(
                    int(sb.message.slot), root)
        self._charge("commit", time.perf_counter() - t0)
        with self._state_lock:
            self.backfill_batches += 1
        return len(pairs)

    # -- observability ----------------------------------------------------

    def snapshot(self) -> dict:
        """doc["replay"] section: stage queue depths, epoch commit seq,
        occupancy of the last segment (flight recorder)."""
        with self._state_lock:
            queues = {name: q.qsize()
                      for name, q in self._live_queues.items()}
            return {
                "active": self._active,
                "commit_seq": self.commit_seq,
                "segments_replayed": self.segments_replayed,
                "blocks_committed": self.blocks_committed,
                "sigs_deduped": self.sigs_deduped,
                "backfill_batches": self.backfill_batches,
                "queue_depths": queues,
                "queue_high_water": dict(self._queue_high_water),
                "busy_seconds": dict(self._busy),
                "last_segment": (dict(self.last_segment)
                                 if self.last_segment else None),
            }
