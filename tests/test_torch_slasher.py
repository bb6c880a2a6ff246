"""Slasher detection matrix tests (slasher/src tests style).

The same cases as the JAX package's tests/test_slasher.py, run on the port
(imports switched to lighthouse_tpu_torch).
"""
import pytest

from lighthouse_tpu_torch.containers import get_types
from lighthouse_tpu_torch.slasher import Slasher, SlasherConfig
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.store import MemoryStore
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device

T = get_types(minimal_spec().preset)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU; its BLS backend put back after each test."""
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


def att(indices, source, target, root=b"\x11" * 32):
    return T.IndexedAttestation(
        attesting_indices=indices,
        data=T.AttestationData(
            slot=target * 8, index=0, beacon_block_root=root,
            source=T.Checkpoint(epoch=source, root=b"\x01" * 32),
            target=T.Checkpoint(epoch=target, root=b"\x02" * 32)),
        signature=b"\x00" * 96)


def make():
    return Slasher(SlasherConfig(history_length=64))


def test_double_vote_detected():
    s = make()
    s.accept_attestation(att([1, 2], 1, 3, root=b"\xaa" * 32))
    s.process_queued(10)
    assert s.slashings == []
    s.accept_attestation(att([2, 5], 1, 3, root=b"\xbb" * 32))
    found = s.process_queued(10)
    assert len(found) == 1
    assert found[0].kind == "double" and found[0].validator_index == 2


def test_surround_detected():
    s = make()
    s.accept_attestation(att([7], 3, 4))
    s.process_queued(10)
    # new attestation (2, 6) surrounds (3, 4)
    found = []
    s.accept_attestation(att([7], 2, 6, root=b"\xcc" * 32))
    found = s.process_queued(10)
    assert any(r.kind == "surrounds" and r.validator_index == 7
               for r in found)


def test_surrounded_detected():
    s = make()
    s.accept_attestation(att([3], 1, 8))
    s.process_queued(10)
    # new attestation (2, 5) is surrounded by (1, 8)
    s.accept_attestation(att([3], 2, 5, root=b"\xdd" * 32))
    found = s.process_queued(10)
    assert any(r.kind == "surrounded" and r.validator_index == 3
               for r in found)


def test_benign_votes_not_flagged():
    s = make()
    for e in range(1, 8):
        s.accept_attestation(att([0, 1, 2], e, e + 1, root=bytes([e]) * 32))
    found = s.process_queued(10)
    assert found == []


def test_proposer_equivocation():
    s = make()
    h1 = T.SignedBeaconBlockHeader(message=T.BeaconBlockHeader(
        slot=9, proposer_index=4, parent_root=b"\x01" * 32,
        state_root=b"\x02" * 32, body_root=b"\x03" * 32),
        signature=b"\x00" * 96)
    h2 = T.SignedBeaconBlockHeader(message=T.BeaconBlockHeader(
        slot=9, proposer_index=4, parent_root=b"\x01" * 32,
        state_root=b"\xff" * 32, body_root=b"\x03" * 32),
        signature=b"\x00" * 96)
    s.accept_block_header(h1)
    s.accept_block_header(h2)
    found = s.process_queued(2)
    assert len(found) == 1 and found[0].kind == "double"


def test_persistence_roundtrip():
    store = MemoryStore()
    s = Slasher(SlasherConfig(history_length=64), store=store)
    s.accept_attestation(att([1], 3, 4))
    s.process_queued(10)
    s.persist()
    s2 = Slasher(SlasherConfig(history_length=64), store=store)
    s2.restore()
    # chunks load lazily from the store: a surround by a prior vote that
    # only the OLD instance ingested must still be detected by the new one
    import numpy as np
    idxs = np.array([1], dtype=np.int64)
    assert (s2.min_target.read_column(idxs, 3)
            == s.min_target.read_column(idxs, 3)).all()
    s2.accept_attestation(att([1], 2, 6))   # surrounds the stored (3,4)
    found = s2.process_queued(10)
    assert any(r.kind == "surrounds" for r in found)


def test_disk_scale_bounded_memory():
    """Detection at >=100k validators with memory
    bounded by the chunk cache, not O(validators * history)."""
    import numpy as np
    store = MemoryStore()
    cfg = SlasherConfig(history_length=4096, cache_chunks=64)
    s = Slasher(cfg, store=store)
    n = 100_000
    # a committee-sized slice of a 100k-validator set attests per epoch;
    # indices spread across the whole registry
    rng = np.random.default_rng(5)
    for epoch in range(6, 16):
        idxs = rng.choice(n, size=512, replace=False)
        s.accept_attestation(att(list(map(int, idxs)),
                                 epoch - 1, epoch))
        s.process_queued(epoch)
    # memory: bounded by the LRU (64 chunks x 256x16 u16 x 2 arrays)
    cap = 2 * cfg.cache_chunks * cfg.validator_chunk_size \
        * cfg.chunk_size * 2
    assert s.memory_bytes() <= cap, s.memory_bytes()
    # a surround by validator 42 against its earlier (5,6)-style votes:
    v = int(rng.choice(n))
    s.accept_attestation(att([v], 14, 15))
    s.process_queued(16)
    s.accept_attestation(att([v], 13, 17))   # surrounds (14,15)
    found = s.process_queued(17)
    assert any(r.kind == "surrounds" and r.validator_index == v
               for r in found)
    # and a surrounded detection
    s.accept_attestation(att([v], 12, 18))
    s.accept_attestation(att([v], 13, 16))
    found = s.process_queued(18)
    assert any(r.kind == "surrounded" for r in found)


def test_huge_epoch_no_overflow():
    """A mainnet-scale epoch (> uint16 range) must not crash the batch
    (review r2: np.uint16(t - e) OverflowError DoS)."""
    s = Slasher(SlasherConfig(history_length=64))
    s.accept_attestation(att([1], 0, 400_000))
    s.process_queued(400_000)     # must not raise
    s.accept_attestation(att([1], 399_990, 399_995))
    s.process_queued(400_000)


def test_storeless_eviction_keeps_dirty_state():
    """Without a KV store, LRU pressure must never discard dirty chunks
    (that would silently disable surround detection)."""
    import numpy as np
    cfg = SlasherConfig(history_length=4096, cache_chunks=4)
    s = Slasher(cfg)
    s.accept_attestation(att([0], 3, 4))
    s.process_queued(10)
    # touch many distinct validator chunks to pressure the cache
    for i in range(1, 40):
        s.accept_attestation(att([i * cfg.validator_chunk_size], 5, 6))
        s.process_queued(10)
    s.accept_attestation(att([0], 2, 6))    # surrounds the original (3,4)
    found = s.process_queued(10)
    assert any(r.kind == "surrounds" and r.validator_index == 0
               for r in found)
