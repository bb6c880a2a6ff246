"""Store tests: native KV engine, hot/cold DB, replay reconstruction.

Mirrors beacon_node/store tests (store_tests.rs style) at small scale.

The same cases as the JAX package's tests/test_store.py, run on the port
(imports switched to lighthouse_tpu_torch).
"""
import os

import pytest

from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.ssz import htr
from lighthouse_tpu_torch.store import (
    HotColdDB, MemoryStore, NativeKvStore, StoreConfig,
)
from lighthouse_tpu_torch.testing import StateHarness


@pytest.fixture(autouse=True)
def _restore_bls():
    """The port on the CPU; its BLS backend, which the tests switch,
    put back after each."""
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


def test_native_kv_roundtrip(tmp_path):
    kv = NativeKvStore(tmp_path / "db.log")
    kv.put(b"a\x00b", b"\x01\x02\x00\x03")
    kv.put(b"a\x00c", b"x" * 100000)
    kv.put(b"zz", b"")
    assert kv.get(b"a\x00b") == b"\x01\x02\x00\x03"
    assert len(kv.get(b"a\x00c")) == 100000
    assert kv.get(b"zz") == b""
    assert kv.get(b"missing") is None
    kv.delete(b"a\x00b")
    assert kv.get(b"a\x00b") is None
    assert len(kv) == 2
    kv.close()


def test_native_kv_persistence_and_iteration(tmp_path):
    path = tmp_path / "db.log"
    kv = NativeKvStore(path)
    for i in range(20):
        kv.put(b"blk:" + bytes([i]), bytes([i]) * 10)
    kv.put(b"oth:x", b"y")
    kv.sync()
    kv.close()
    kv = NativeKvStore(path)
    items = list(kv.iter_prefix(b"blk:"))
    assert len(items) == 20
    assert items[0][0] == b"blk:\x00"
    assert items[5][1] == bytes([5]) * 10
    # overwrite then compact keeps latest
    kv.put(b"blk:\x00", b"new")
    kv.compact()
    assert kv.get(b"blk:\x00") == b"new"
    assert kv.get(b"oth:x") == b"y"
    kv.close()


def test_native_kv_torn_tail_recovery(tmp_path):
    path = tmp_path / "db.log"
    kv = NativeKvStore(path)
    kv.put(b"k1", b"v1")
    kv.put(b"k2", b"v2")
    kv.sync()
    kv.close()
    with open(path, "ab") as f:
        f.write(b"\x05\x00\x00\x00garbage-partial-record")
    kv = NativeKvStore(path)
    assert kv.get(b"k1") == b"v1"
    assert kv.get(b"k2") == b"v2"
    kv.put(b"k3", b"v3")
    kv.close()
    kv = NativeKvStore(path)
    assert kv.get(b"k3") == b"v3"
    kv.close()


@pytest.fixture
def harness_chain():
    bls.set_backend("fake")
    spec = minimal_spec()
    h = StateHarness(spec, 64)
    states = [h.genesis_state.copy()]
    blocks = h.extend_chain(2 * spec.preset.slots_per_epoch)
    return spec, h, blocks


def _store_chain(db, h, blocks):
    """Apply blocks through a replayer storing every block + state."""
    from lighthouse_tpu_torch.state_transition import BlockReplayer

    from lighthouse_tpu_torch.state_transition.helpers import (
        latest_block_header_root,
    )
    state = h.genesis_state.copy()
    db.store_genesis(latest_block_header_root(state), state)
    roots = {}
    for sb in blocks:
        root = htr(sb.message)
        db.put_block(root, sb)
        st = BlockReplayer(state.copy()).apply_blocks([sb])
        db.put_state(sb.message.state_root, st)
        roots[sb.message.slot] = root
        state = st
    return state, roots


def test_hot_cold_block_state_roundtrip(harness_chain, tmp_path):
    spec, h, blocks = harness_chain
    db = HotColdDB(NativeKvStore(tmp_path / "hot.db"),
                   NativeKvStore(tmp_path / "cold.db"), spec)
    final_state, roots = _store_chain(db, h, blocks)
    # block roundtrip
    root = htr(blocks[3].message)
    assert htr(db.get_block(root).message) == root
    # epoch-boundary state: direct load
    boundary = blocks[spec.preset.slots_per_epoch - 1]
    st = db.get_hot_state(boundary.message.state_root)
    assert st is not None and st.hash_tree_root() == boundary.message.state_root
    # mid-epoch state: summary + replay reconstruction
    mid = blocks[spec.preset.slots_per_epoch + 2]
    st = db.get_hot_state(mid.message.state_root)
    assert st is not None
    assert st.hash_tree_root() == mid.message.state_root


def test_hot_cold_migration_and_cold_load(harness_chain, tmp_path):
    spec, h, blocks = harness_chain
    db = HotColdDB(MemoryStore(), MemoryStore(), spec,
                   StoreConfig(slots_per_restore_point=8))
    final_state, roots = _store_chain(db, h, blocks)
    fin_slot = spec.preset.slots_per_epoch  # finalize end of epoch 1
    fin_block = blocks[fin_slot - 1]
    db.migrate_database(fin_slot, fin_block.message.state_root,
                        htr(fin_block.message), roots)
    assert db.split.slot == fin_slot
    # hot states below split are pruned
    early = blocks[2]
    assert db.get_hot_state(early.message.state_root) is None
    # but reconstructable from the freezer
    st = db.load_cold_state_by_slot(early.message.slot)
    assert st is not None
    assert st.hash_tree_root() == early.message.state_root
    # freezer block roots recorded
    assert db.freezer_block_root_at_slot(3) == roots[3]


def test_chunked_root_vector():
    """chunked_vector.rs equivalent: puts/gets across chunk boundaries,
    range reads touch whole chunks, pruning drops whole chunks."""
    from lighthouse_tpu_torch.store.chunked_vector import (
        CHUNK_SIZE, ChunkedRootVector,
    )
    from lighthouse_tpu_torch.store.kv import MemoryStore as MemoryKV
    kv = MemoryKV()
    v = ChunkedRootVector(kv, b"t:")
    roots = {s: bytes([s % 251 + 1]) * 32
             for s in range(0, 3 * CHUNK_SIZE, 3)}
    for s, r in roots.items():
        v.put(s, r)
    # point reads across chunk boundaries
    assert v.get(0) == roots[0]
    assert v.get(CHUNK_SIZE * 2 - 3 + 0) == roots.get(CHUNK_SIZE * 2 - 3)
    assert v.get(1) is None                      # never written
    # range read returns both written and None slots
    got = dict(v.range(CHUNK_SIZE - 5, CHUNK_SIZE + 5))
    assert len(got) == 10
    for s in range(CHUNK_SIZE - 5, CHUNK_SIZE + 5):
        assert got[s] == roots.get(s)
    # the whole 3-chunk span used only 3 KV entries
    assert sum(1 for _ in kv.iter_prefix(b"t:")) == 3
    assert v.prune_before(2 * CHUNK_SIZE) == 2
    assert v.get(0) is None and v.get(2 * CHUNK_SIZE + 1) is None
    assert v.get(2 * CHUNK_SIZE + 2 - (2 * CHUNK_SIZE + 2) % 3) is not None


def test_schema_migration_v1_to_v2():
    """A v1-layout store (per-slot freezer roots) opens cleanly and
    reads the same roots through the chunked v2 layout."""
    import struct

    from lighthouse_tpu_torch.store.hot_cold import (
        FREEZER_BLOCK_ROOT, HotColdDB, StoreConfig,
    )
    from lighthouse_tpu_torch.store.kv import MemoryStore as MemoryKV
    from lighthouse_tpu_torch.specs import minimal_spec
    hot, cold = MemoryKV(), MemoryKV()
    # fabricate a v1 database: schema=1 + per-slot entries
    hot.put(b"m:schema", struct.pack("<I", 1))
    roots = {s: bytes([s + 1]) * 32 for s in range(0, 20, 2)}
    for s, r in roots.items():
        cold.put(FREEZER_BLOCK_ROOT + struct.pack(">Q", s), r)
    db = HotColdDB(hot, cold, minimal_spec(), StoreConfig())
    assert db.schema_version() == 2
    for s, r in roots.items():
        assert db.freezer_block_root_at_slot(s) == r
    assert db.freezer_block_root_at_slot(1) is None
    # old keys are gone
    assert not list(cold.iter_prefix(FREEZER_BLOCK_ROOT))


def test_forwards_iterator_spans_freezer_and_hot():
    from lighthouse_tpu_torch.chain import BeaconChainHarness
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.specs import minimal_spec
    bls.set_backend("fake")
    spec = minimal_spec()
    h = BeaconChainHarness(spec, 32)
    h.extend_chain(3 * spec.preset.slots_per_epoch)
    chain = h.chain
    store = chain.store
    head = chain.head()
    start, end = 1, int(head.head_state.slot)
    got = dict(store.forwards_block_roots_iterator(
        start, end, head.head_block_root))
    # every produced slot maps to the canonical root at that slot
    for s in range(start, end + 1):
        want = chain.block_root_at_slot(s)
        if want is not None and s in got:
            assert got[s] == want, s
    # must cover the full hot range up to the head
    assert got[end] == head.head_block_root


def test_cold_state_cache_bounds_replay(tmp_path):
    """Repeated historical loads hit the LRU instead of re-replaying."""
    from lighthouse_tpu_torch.chain import BeaconChainHarness
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.specs import minimal_spec
    bls.set_backend("fake")
    spec = minimal_spec()
    h = BeaconChainHarness(spec, 32)
    h.extend_chain(2 * spec.preset.slots_per_epoch)
    store = h.chain.store
    # freeze everything below the head epoch
    head = h.chain.head()
    fin_slot = spec.preset.slots_per_epoch
    canonical = {s: h.chain.block_root_at_slot(s)
                 for s in range(0, fin_slot + 1)}
    store.migrate_database(
        fin_slot, head.head_state.state_roots[
            fin_slot % spec.preset.slots_per_historical_root].tobytes(),
        canonical[fin_slot], canonical)
    st1 = store.load_cold_state_by_slot(3)
    assert st1 is not None and st1.slot == 3
    # cached: second load returns an equal state without re-replay
    assert store.state_cache.get(("cold", 3)) is not None
    st2 = store.load_cold_state_by_slot(3)
    assert st2.hash_tree_root() == st1.hash_tree_root()
    # mutating the returned copy must not poison the cache
    st2.slot = 999
    assert store.load_cold_state_by_slot(3).slot == 3


def test_blob_pruning():
    from lighthouse_tpu_torch.chain import BeaconChainHarness
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.specs import minimal_spec
    bls.set_backend("fake")
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                        capella_fork_epoch=0, deneb_fork_epoch=0)
    h = BeaconChainHarness(spec, 32)
    roots = h.extend_chain(4)
    store = h.chain.store
    # attach a blob to each block
    for r in roots:
        blk = store.get_block(r)
        store.put_blobs(r, [])
    slot3 = store.get_block(roots[2]).message.slot
    removed = store.prune_blobs(slot3)
    assert removed >= 2
