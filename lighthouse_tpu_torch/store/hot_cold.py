"""Hot/cold split database.

Equivalent of the reference's beacon_node/store/src/hot_cold_store.rs:50:
- hot DB: all unfinalized blocks; full states at epoch boundaries; per-slot
  `HotStateSummary`s pointing at their epoch-boundary state; states rebuilt
  by block replay (BlockReplayer, reconstruct.rs).
- freezer ("cold") DB: finalized block roots by slot + sparse restore-point
  states every `slots_per_restore_point`.
- `Split` marks the hot/cold boundary (hot_cold_store.rs:2715); `migrate`
  moves finalized data across it and prunes abandoned forks.
"""
from __future__ import annotations

import os
import struct
import sys
from dataclasses import dataclass

from ..containers import get_types
from ..containers.state import BeaconState
from ..obs import tracing
from ..specs.chain_spec import ChainSpec, ForkName
from ..ssz import deserialize, htr, serialize
from .kv import KeyValueStore, StoreError

# column prefixes
BLOCK = b"b:"
HOT_STATE_FULL = b"S:"
HOT_STATE_SUMMARY = b"s:"
FREEZER_BLOCK_ROOT = b"fbr:"   # v1 layout: slot (be64) -> block root
FREEZER_BLOCK_CHUNK = b"cbr:"  # v2 layout: chunked root vector
FREEZER_STATE_CHUNK = b"csr:"  # v2: chunked state-root vector
FREEZER_STATE = b"fst:"        # slot (be64) -> full state
BLOBS = b"o:"
METADATA = b"m:"
ITEM = b"i:"                   # generic persisted items (fork choice, op pool)

SCHEMA_VERSION = 2             # v2: chunked freezer root vectors


def _count(name: str, amount: float = 1) -> None:
    """Catalog counter, sys.modules-gated so standalone store use stays
    metrics-free (same discipline as obs.tracing)."""
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    if md is not None:
        md.count(name, amount)


@dataclass
class Split:
    slot: int = 0
    state_root: bytes = b"\x00" * 32


@dataclass
class StoreOp:
    """One logical mutation in an atomic hot-DB commit batch
    (store/src/lib.rs StoreOp): build a list, hand it to
    `HotColdDB.do_atomically`, and either every op lands or none does —
    the crash-consistency unit for block import, head persistence and
    migration."""

    kind: str
    key: bytes = b""
    obj: object = None
    latest_block_root: bytes | None = None

    @classmethod
    def put_block(cls, block_root: bytes, signed_block) -> "StoreOp":
        return cls("put_block", block_root, signed_block)

    @classmethod
    def put_state(cls, state_root: bytes, state,
                  latest_block_root: bytes | None = None) -> "StoreOp":
        """`latest_block_root` lets callers that already know the root of
        ``state.latest_block_header`` (with its state_root filled) skip the
        hash_tree_root the summary would otherwise force — block import
        knows it: it IS the block's root when ``state`` is a post-block
        state at the block's own slot."""
        return cls("put_state", state_root, state, latest_block_root)

    @classmethod
    def put_blobs(cls, block_root: bytes, blobs: list) -> "StoreOp":
        return cls("put_blobs", block_root, blobs)

    @classmethod
    def delete_block(cls, block_root: bytes) -> "StoreOp":
        return cls("delete_block", block_root)

    @classmethod
    def delete_state(cls, state_root: bytes) -> "StoreOp":
        return cls("delete_state", state_root)

    @classmethod
    def put_item(cls, key: bytes, value: bytes) -> "StoreOp":
        return cls("put_item", key, value)

    @classmethod
    def put_meta(cls, key: bytes, value: bytes) -> "StoreOp":
        return cls("put_meta", key, value)


@dataclass
class StoreConfig:
    slots_per_restore_point: int = 2048
    compact_on_prune: bool = True
    state_cache_size: int = 8      # replayed/cold states kept hot in RAM


class _StateCache:
    """Bounded LRU of fully-materialized states (store/src/state_cache.rs
    role): cold-state loads replay O(slots_per_restore_point) blocks, so
    repeated historical reads must not re-pay that."""

    def __init__(self, capacity: int):
        from collections import OrderedDict
        self.capacity = capacity
        self._od = OrderedDict()

    def get(self, key):
        st = self._od.get(key)
        if st is not None:
            self._od.move_to_end(key)
        return st

    def put(self, key, state) -> None:
        self._od[key] = state
        self._od.move_to_end(key)
        while len(self._od) > self.capacity:
            self._od.popitem(last=False)

    def clear(self) -> None:
        self._od.clear()


class HotColdDB:
    def __init__(self, hot: KeyValueStore, cold: KeyValueStore,
                 spec: ChainSpec, config: StoreConfig | None = None):
        from .chunked_vector import ChunkedRootVector
        self.hot = hot
        self.cold = cold
        self.spec = spec
        self.T = get_types(spec.preset)
        self.config = config or StoreConfig()
        self.split = self._load_split()
        self.block_roots = ChunkedRootVector(cold, FREEZER_BLOCK_CHUNK)
        self.state_roots = ChunkedRootVector(cold, FREEZER_STATE_CHUNK)
        self.state_cache = _StateCache(self.config.state_cache_size)
        from .schema_change import migrate_schema
        migrate_schema(self)
        self._put_meta(b"schema", struct.pack("<I", SCHEMA_VERSION))
        if os.environ.get("LHTPU_FSCK_ON_OPEN"):
            from .fsck import run_fsck
            report = run_fsck(self)
            if report.errors:
                import logging
                logging.getLogger("lighthouse_tpu_torch.store").warning(
                    "fsck at open found %d error(s): %s",
                    len(report.errors), "; ".join(report.errors[:5]))

    # -- metadata ------------------------------------------------------------

    def _put_meta(self, key: bytes, value: bytes) -> None:
        self.hot.put(METADATA + key, value)

    def _get_meta(self, key: bytes) -> bytes | None:
        return self.hot.get(METADATA + key)

    def _load_split(self) -> Split:
        raw = self._get_meta(b"split")
        if raw is None:
            return Split()
        slot, root = struct.unpack("<Q", raw[:8])[0], raw[8:40]
        return Split(slot, root)

    def schema_version(self) -> int:
        raw = self._get_meta(b"schema")
        return struct.unpack("<I", raw)[0] if raw else 0

    def put_item(self, key: bytes, value: bytes) -> None:
        self.hot.put(ITEM + key, value)

    def get_item(self, key: bytes) -> bytes | None:
        return self.hot.get(ITEM + key)

    # -- atomic commit batches ----------------------------------------------

    def _block_kv_ops(self, block_root: bytes, signed_block) -> list:
        fork = signed_block.fork_name
        data = bytes([fork.value]) + serialize(
            type(signed_block).ssz_type, signed_block)
        return [("put", BLOCK + block_root, data)]

    def _state_kv_ops(self, state_root: bytes, state: BeaconState,
                      latest_block_root: bytes | None = None) -> list:
        p = self.T.preset
        ops = []
        if state.slot % p.slots_per_epoch == 0:
            data = bytes([state.fork_name.value]) + state.serialize()
            ops.append(("put", HOT_STATE_FULL + state_root, data))
        if latest_block_root is None:
            latest_block_root = self._latest_block_root(state)
        boundary_slot = (state.slot // p.slots_per_epoch) * p.slots_per_epoch
        boundary_root = (state_root if state.slot == boundary_slot
                         else state.state_roots[
                             boundary_slot % p.slots_per_historical_root
                         ].tobytes())
        summary = struct.pack("<Q", state.slot) + latest_block_root \
            + boundary_root
        ops.append(("put", HOT_STATE_SUMMARY + state_root, summary))
        return ops

    def _blobs_kv_ops(self, block_root: bytes, blobs: list) -> list:
        from ..ssz import List as SSZList
        t = SSZList(self.T.BlobSidecar.ssz_type,
                    self.T.preset.max_blob_commitments_per_block)
        return [("put", BLOBS + block_root, serialize(t, blobs))]

    def _kv_ops_for(self, op: StoreOp) -> list:
        if op.kind == "put_block":
            return self._block_kv_ops(op.key, op.obj)
        if op.kind == "put_state":
            return self._state_kv_ops(op.key, op.obj, op.latest_block_root)
        if op.kind == "put_blobs":
            return self._blobs_kv_ops(op.key, op.obj)
        if op.kind == "delete_block":
            return [("delete", BLOCK + op.key, None)]
        if op.kind == "delete_state":
            return [("delete", HOT_STATE_FULL + op.key, None),
                    ("delete", HOT_STATE_SUMMARY + op.key, None)]
        if op.kind == "put_item":
            return [("put", ITEM + op.key, op.obj)]
        if op.kind == "put_meta":
            return [("put", METADATA + op.key, op.obj)]
        raise StoreError(f"unknown StoreOp kind {op.kind!r}")

    def do_atomically(self, ops: list[StoreOp], fsync: bool = True) -> None:
        """Commit a list of StoreOps as ONE atomic hot-DB batch: after a
        crash either every op is visible or none is (native backends frame
        the batch as a single CRC'd log record).  This is the only
        sanctioned write path for block import / head persistence /
        migration — graftlint's store-atomicity rule flags direct puts
        there."""
        kv_ops: list = []
        for op in ops:
            kv_ops.extend(self._kv_ops_for(op))
        self.hot.do_atomically(kv_ops, fsync=fsync)
        _count("store_batch_commit_total")
        _count("store_hot_db_ops_total", len(kv_ops))

    # -- blocks --------------------------------------------------------------

    def put_block(self, block_root: bytes, signed_block) -> None:
        for _op, key, value in self._block_kv_ops(block_root, signed_block):
            self.hot.put(key, value)
        _count("store_hot_db_ops_total")

    def get_block(self, block_root: bytes):
        raw = self.hot.get(BLOCK + block_root)
        if raw is None:
            return None
        fork = ForkName(raw[0])
        cls = self.T.SignedBeaconBlock[fork]
        return deserialize(cls.ssz_type, raw[1:])

    def block_exists(self, block_root: bytes) -> bool:
        return self.hot.exists(BLOCK + block_root)

    def iter_hot_blocks(self):
        """(root, signed_block) over every hot block, ascending by slot —
        the raw material fork-choice rebuild and fsck walk after a crash
        ate the persisted snapshot.  Undecodable blocks are skipped."""
        found = []
        for key, _ in self.hot.iter_prefix(BLOCK):
            root = key[len(BLOCK):]
            try:
                blk = self.get_block(root)
            except Exception:
                continue
            if blk is not None:
                found.append((blk.message.slot, root, blk))
        found.sort(key=lambda t: t[0])
        for _slot, root, blk in found:
            yield root, blk

    def delete_block(self, block_root: bytes) -> None:
        self.hot.delete(BLOCK + block_root)

    # -- blobs ---------------------------------------------------------------

    def put_blobs(self, block_root: bytes, blobs: list) -> None:
        for _op, key, value in self._blobs_kv_ops(block_root, blobs):
            self.hot.put(key, value)

    def get_blobs(self, block_root: bytes) -> list | None:
        from ..ssz import List as SSZList
        raw = self.hot.get(BLOBS + block_root)
        if raw is None:
            return None
        t = SSZList(self.T.BlobSidecar.ssz_type,
                    self.T.preset.max_blob_commitments_per_block)
        return deserialize(t, raw)

    # -- hot states ----------------------------------------------------------

    def put_state(self, state_root: bytes, state: BeaconState) -> None:
        for _op, key, value in self._state_kv_ops(state_root, state):
            self.hot.put(key, value)
        _count("store_hot_db_ops_total")

    def hot_state_summary(self, state_root: bytes
                          ) -> tuple[int, bytes, bytes] | None:
        """(slot, latest_block_root, epoch_boundary_root) for a hot state,
        or None when no (well-formed) summary exists."""
        raw = self.hot.get(HOT_STATE_SUMMARY + state_root)
        if raw is None or len(raw) != 72:
            return None
        return struct.unpack("<Q", raw[:8])[0], raw[8:40], raw[40:72]

    @staticmethod
    def _latest_block_root(state: BeaconState) -> bytes:
        from ..state_transition.helpers import latest_block_header_root
        return latest_block_header_root(state)

    def get_hot_state(self, state_root: bytes) -> BeaconState | None:
        raw = self.hot.get(HOT_STATE_FULL + state_root)
        if raw is not None:
            fork = ForkName(raw[0])
            return BeaconState.from_ssz_bytes(raw[1:], self.T, self.spec,
                                              fork)
        summary = self.hot.get(HOT_STATE_SUMMARY + state_root)
        if summary is None:
            return None
        slot = struct.unpack("<Q", summary[:8])[0]
        latest_block_root = summary[8:40]
        boundary_root = summary[40:72]
        boundary_raw = self.hot.get(HOT_STATE_FULL + boundary_root)
        if boundary_raw is None:
            raise StoreError("missing epoch boundary state")
        state = BeaconState.from_ssz_bytes(
            boundary_raw[1:], self.T, self.spec, ForkName(boundary_raw[0]))
        # collect blocks (boundary, slot] by walking back from the summary's
        # latest block
        blocks = []
        root = latest_block_root
        while True:
            blk = self.get_block(root)
            if blk is None or blk.message.slot <= state.slot:
                break
            blocks.append(blk)
            root = blk.message.parent_root
        blocks.reverse()
        from ..state_transition import BlockReplayer
        return BlockReplayer(state).apply_blocks(blocks, target_slot=slot)

    def get_state(self, state_root: bytes,
                  slot: int | None = None) -> BeaconState | None:
        st = self.get_hot_state(state_root)
        if st is not None:
            return st
        if slot is not None:
            return self.load_cold_state_by_slot(slot)
        return None

    def delete_state(self, state_root: bytes) -> None:
        self.hot.delete(HOT_STATE_FULL + state_root)
        self.hot.delete(HOT_STATE_SUMMARY + state_root)

    def store_genesis(self, genesis_block_root: bytes,
                      genesis_state: BeaconState,
                      genesis_block=None) -> None:
        """Anchor the DB: genesis state goes to both hot and freezer (the
        slot-0 restore point every cold reconstruction bottoms out on).

        Commit order is the crash contract: freezer first, then ONE hot
        batch whose `anchor_slot` meta is the commit point — a crash
        between the two leaves a store with no anchor, which boots as
        fresh and simply re-runs genesis."""
        from ..utils.crashpoints import crashpoint
        root = genesis_state.hash_tree_root()
        slot = genesis_state.slot
        cold_ops = [("put", FREEZER_STATE + struct.pack(">Q", slot),
                     bytes([genesis_state.fork_name.value])
                     + genesis_state.serialize())]
        cold_ops.extend(self.block_roots.stage_puts(
            {slot: genesis_block_root}))
        self.cold.do_atomically(cold_ops)
        _count("store_cold_db_ops_total", len(cold_ops))
        crashpoint("genesis:mid_store")
        ops = [StoreOp.put_state(root, genesis_state),
               StoreOp.put_meta(b"genesis_block_root", genesis_block_root),
               StoreOp.put_meta(b"anchor_slot", struct.pack("<Q", slot))]
        if genesis_block is not None:
            ops.insert(0, StoreOp.put_block(genesis_block_root,
                                            genesis_block))
        self.do_atomically(ops)

    def anchor_state(self) -> BeaconState | None:
        """The state this DB was anchored on (FromStore resume boots here)."""
        raw = self._get_meta(b"anchor_slot")
        if raw is None:
            return None
        slot = struct.unpack("<Q", raw)[0]
        data = self.cold.get(FREEZER_STATE + struct.pack(">Q", slot))
        if data is None:
            return None
        return BeaconState.from_ssz_bytes(data[1:], self.T, self.spec,
                                          ForkName(data[0]))

    def genesis_block_root(self) -> bytes | None:
        return self._get_meta(b"genesis_block_root")

    # -- backfill anchor (checkpoint sync: oldest known block) ---------------

    def set_backfill_anchor(self, slot: int, parent_root: bytes) -> None:
        self._put_meta(b"backfill", struct.pack("<Q", slot) + parent_root)

    def backfill_anchor(self) -> tuple[int, bytes] | None:
        raw = self._get_meta(b"backfill")
        if raw is None:
            return None
        return struct.unpack("<Q", raw[:8])[0], raw[8:40]

    # -- freezer -------------------------------------------------------------

    def freezer_put_block_root(self, slot: int, block_root: bytes) -> None:
        self.block_roots.put(slot, block_root)
        _count("store_cold_db_ops_total")

    def freezer_block_root_at_slot(self, slot: int) -> bytes | None:
        return self.block_roots.get(slot)

    def freezer_put_state_root(self, slot: int, state_root: bytes) -> None:
        self.state_roots.put(slot, state_root)

    def freezer_state_root_at_slot(self, slot: int) -> bytes | None:
        return self.state_roots.get(slot)

    def freezer_put_state(self, slot: int, state: BeaconState) -> None:
        data = bytes([state.fork_name.value]) + state.serialize()
        self.cold.put(FREEZER_STATE + struct.pack(">Q", slot), data)
        _count("store_cold_db_ops_total")

    def load_cold_state_by_slot(self, slot: int) -> BeaconState | None:
        """Nearest restore point at/below `slot` + block replay, behind
        the bounded state cache (state_cache.rs role)."""
        cached = self.state_cache.get(("cold", slot))
        if cached is not None:
            _count("store_state_cache_hits_total")
            return cached.copy()
        _count("store_state_cache_misses_total")
        srp = self.config.slots_per_restore_point
        rp_slot = (slot // srp) * srp
        raw = None
        while rp_slot >= 0:
            raw = self.cold.get(FREEZER_STATE + struct.pack(">Q", rp_slot))
            if raw is not None:
                break
            if rp_slot == 0:
                break
            rp_slot -= srp
        if raw is None:
            return None
        state = BeaconState.from_ssz_bytes(raw[1:], self.T, self.spec,
                                           ForkName(raw[0]))
        if state.slot != slot:
            with tracing.span("cold_state_replay", target_slot=int(slot),
                              from_slot=int(state.slot)):
                blocks = []
                seen = None
                for s, root in self.block_roots.range(state.slot + 1,
                                                      slot + 1):
                    if root is None or root == seen:
                        continue  # skipped slot (same root repeated)
                    seen = root
                    blk = self.get_block(root)
                    if blk is not None and blk.message.slot > state.slot:
                        blocks.append(blk)
                from ..state_transition import BlockReplayer
                state = BlockReplayer(state).apply_blocks(blocks,
                                                          target_slot=slot)
        self.state_cache.put(("cold", slot), state)
        return state.copy()

    def prune_blobs(self, before_slot: int) -> int:
        """Drop blob sidecars for blocks older than `before_slot` (the
        data-availability window boundary; store/src/hot_cold_store.rs
        try_prune_blobs)."""
        removed = 0
        for key, _ in list(self.hot.iter_prefix(BLOBS)):
            root = key[len(BLOBS):]
            blk = self.get_block(root)
            if blk is None or blk.message.slot < before_slot:
                self.hot.delete(key)
                removed += 1
        return removed

    # -- migration (freezing) ------------------------------------------------

    def migrate_database(self, finalized_slot: int,
                         finalized_state_root: bytes,
                         finalized_block_root: bytes,
                         canonical_roots: dict[int, bytes],
                         abandoned_block_roots: list[bytes] = (),
                         abandoned_state_roots: list[bytes] = ()) -> None:
        """Advance the split: record canonical block roots in the freezer,
        store restore points, prune abandoned forks and hot states below the
        split (store/src/migrate.rs + hot_cold_store.rs migration)."""
        if finalized_slot <= self.split.slot:
            return
        with tracing.span("store_migration",
                          finalized_slot=int(finalized_slot)):
            self._migrate_database(finalized_slot, finalized_state_root,
                                   finalized_block_root, canonical_roots,
                                   abandoned_block_roots,
                                   abandoned_state_roots)

    def _migrate_database(self, finalized_slot: int,
                          finalized_state_root: bytes,
                          finalized_block_root: bytes,
                          canonical_roots: dict[int, bytes],
                          abandoned_block_roots: list[bytes] = (),
                          abandoned_state_roots: list[bytes] = ()) -> None:
        """Two commit points: (1) ONE cold batch lands every freezer write;
        (2) ONE hot batch lands prunes + the advanced split.  A crash
        between them leaves the old split in place, so the next migration
        replays the (idempotent) freezer writes from the old boundary."""
        from ..utils.crashpoints import crashpoint
        srp = self.config.slots_per_restore_point
        block_root_puts: dict[int, bytes] = {}
        state_root_puts: dict[int, bytes] = {}
        cold_ops: list = []
        for slot in range(self.split.slot, finalized_slot + 1):
            root = canonical_roots.get(slot)
            if root is None:
                continue
            block_root_puts[slot] = root
            blk = self.get_block(root)
            if blk is not None:
                state_root_puts[slot] = blk.message.state_root
            if slot % srp == 0:
                st = None
                if blk is not None:
                    st = self.get_hot_state(blk.message.state_root)
                if st is not None:
                    cold_ops.append(
                        ("put", FREEZER_STATE + struct.pack(">Q", slot),
                         bytes([st.fork_name.value]) + st.serialize()))
        cold_ops.extend(self.block_roots.stage_puts(block_root_puts))
        cold_ops.extend(self.state_roots.stage_puts(state_root_puts))
        self.cold.do_atomically(cold_ops, fsync=True)
        _count("store_batch_commit_total")
        _count("store_cold_db_ops_total", len(cold_ops))
        crashpoint("migrate:mid_freeze")
        # hot batch: prune abandoned forks + stale states, advance the split
        hot_ops = [StoreOp.delete_block(root)
                   for root in abandoned_block_roots]
        hot_ops += [StoreOp.delete_state(root)
                    for root in abandoned_state_roots]
        # drop hot states strictly below the new split (keep the finalized
        # one)
        for key, summary in list(self.hot.iter_prefix(HOT_STATE_SUMMARY)):
            slot = struct.unpack("<Q", summary[:8])[0]
            state_root = key[len(HOT_STATE_SUMMARY):]
            if slot < finalized_slot and state_root != finalized_state_root:
                hot_ops.append(StoreOp.delete_state(state_root))
        hot_ops.append(StoreOp.put_meta(
            b"split", struct.pack("<Q", finalized_slot)
            + finalized_state_root))
        crashpoint("migrate:before_split_write")
        self.do_atomically(hot_ops, fsync=True)
        self.split = Split(finalized_slot, finalized_state_root)

    # -- iteration -----------------------------------------------------------

    def iter_block_roots_back(self, head_root: bytes):
        """Walk (root, slot) back through parent links, crossing into the
        freezer's chunked vector below the split (iter.rs equivalent)."""
        root = head_root
        while True:
            blk = self.get_block(root)
            if blk is None:
                # below the split: continue from the chunked freezer roots
                yield from self._iter_freezer_back(self.split.slot)
                return
            yield root, blk.message.slot
            if blk.message.slot == 0:
                return
            if blk.message.slot <= self.split.slot:
                yield from self._iter_freezer_back(blk.message.slot - 1)
                return
            root = blk.message.parent_root

    def _iter_freezer_back(self, from_slot: int):
        seen = None
        for slot in range(from_slot, -1, -1):
            root = self.block_roots.get(slot)
            if root is None or root == seen:
                continue
            seen = root
            yield root, slot

    def forwards_block_roots_iterator(self, start_slot: int,
                                      end_slot: int,
                                      head_root: bytes | None = None):
        """(slot, root) ascending: freezer chunks below the split, then
        the hot chain walked from `head_root`
        (store/src/forwards_iter.rs)."""
        boundary = min(end_slot, self.split.slot)
        last = None
        for slot, root in self.block_roots.range(start_slot, boundary + 1):
            if root is not None:
                last = root
            if last is not None:
                yield slot, last
        if end_slot <= self.split.slot or head_root is None:
            return
        # hot side: walk parents back to the split, then emit ascending
        # with skipped slots carrying the prior root (spec block_roots
        # fill-forward semantics)
        chain = []                       # (slot, root), descending
        root = head_root
        while True:
            blk = self.get_block(root)
            if blk is None:
                break
            chain.append((blk.message.slot, root))
            if blk.message.slot <= self.split.slot + 1 or \
                    blk.message.slot == 0:
                break
            root = blk.message.parent_root
        chain.reverse()
        idx = 0
        current = None
        for want in range(max(start_slot, self.split.slot + 1),
                          end_slot + 1):
            while idx < len(chain) and chain[idx][0] <= want:
                current = chain[idx][1]
                idx += 1
            if current is not None:
                yield want, current
