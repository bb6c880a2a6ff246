"""The port's C++ host hasher (utils/native_hash.py over
native/sha256_host.cpp): the cases of tests/test_native_hash.py and
tests/test_host_tree_hash.py, held to hashlib and to the JAX package's
module (byte-equal digests and roots, tolerance zero). The library builds
into the port's _build/, never into native/, and a failed build raises."""
import ctypes
import hashlib
import pathlib

import numpy as np
import pytest

from lighthouse_tpu.utils import native_hash as jnh
from lighthouse_tpu_torch.containers.state import ValidatorRegistry
from lighthouse_tpu_torch.containers.cow import CowColumn
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.ssz import merkleize_chunks, mix_in_length
from lighthouse_tpu_torch.utils import gxx
from lighthouse_tpu_torch.utils import native_hash as nh
from lighthouse_tpu_torch.utils.hash import hash_concat

LIMIT = 2**40
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cpu_device():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _digests(data: bytes, size: int) -> bytes:
    return b"".join(hashlib.sha256(data[i:i + size]).digest()
                    for i in range(0, len(data), size))


def test_library_lands_in_the_ports_build_dir():
    native_before = sorted(p.name for p in (REPO / "native").iterdir())
    nh._lib = None
    lib = nh.get_lib()
    path = pathlib.Path(lib._name)
    assert path.parent == REPO / "lighthouse_tpu_torch" / "_build"
    assert path.name.startswith("libsha256host-")
    assert sorted(p.name for p in (REPO / "native").iterdir()) \
        == native_before


def test_failed_build_raises(tmp_path):
    """``gxx.build``, which compiles the port's host libraries (this one
    and the C++ BLS backend's), raises when g++ fails and leaves no
    library behind."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        gxx.build(bad, "bad", tmp_path / "_build")
    assert not list((tmp_path / "_build").glob("*.so"))


def test_hash64_batch_matches_hashlib_and_jax():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 64 * 33, dtype=np.uint8).tobytes()
    out = nh.hash64_batch(data)
    assert out == _digests(data, 64)
    assert out == jnh.hash64_batch(data)


@pytest.mark.parametrize("msg_len", [37, 40, 55])
def test_hash_short_batch_matches_hashlib_and_jax(msg_len):
    rng = np.random.default_rng(msg_len)
    data = rng.integers(0, 256, msg_len * 700, dtype=np.uint8).tobytes()
    out = nh.hash_short_batch(data, msg_len)
    assert out == _digests(data, msg_len)
    assert out == jnh.hash_short_batch(data, msg_len)


def test_hash_short_batch_declines_two_block_messages():
    assert nh.hash_short_batch(b"\x00" * 56 * 3, 56) is None


def test_merkle_root_pow2():
    rng = np.random.default_rng(6)
    leaves = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
              for _ in range(64)]
    got = nh.merkle_root_pow2(b"".join(leaves))
    nodes = leaves
    while len(nodes) > 1:
        nodes = [hash_concat(nodes[i], nodes[i + 1])
                 for i in range(0, len(nodes), 2)]
    assert got == nodes[0]
    assert got == jnh.merkle_root_pow2(b"".join(leaves))


@pytest.mark.parametrize("n,limit", [(32, 64), (33, 64), (100, 256),
                                     (64, 1 << 12), (65, 128)])
def test_host_tree_matches_merkleize_chunks(n, limit):
    """The dense host tree with its zero caps against the hashlib
    merkleization, at sizes around a power of two."""
    rng = np.random.default_rng(n)
    chunks = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    want = merkleize_chunks([bytes(c) for c in chunks], limit)
    assert nh.HostTree(chunks, limit).root() == want
    assert jnh.HostTree(chunks, limit).root() == want


def test_oneshot():
    lib = nh.get_lib()
    for n in (0, 1, 55, 56, 64, 100, 1000):
        data = (bytes(range(256)) * 4)[:n]
        buf = ctypes.create_string_buffer(32)
        lib.sha256_oneshot(data, n, buf)
        assert buf.raw == hashlib.sha256(data).digest()


def _registry(n, rng) -> ValidatorRegistry:
    vr = ValidatorRegistry()
    vr.pubkeys = rng.integers(0, 256, size=(n, 48), dtype=np.uint8)
    vr.withdrawal_credentials = rng.integers(0, 256, size=(n, 32),
                                             dtype=np.uint8)
    vr.effective_balance = rng.integers(0, 2**40, size=n, dtype=np.uint64)
    vr.slashed = rng.integers(0, 2, size=n).astype(bool)
    for name in ("activation_eligibility_epoch", "activation_epoch",
                 "exit_epoch", "withdrawable_epoch"):
        setattr(vr, name, rng.integers(0, 2**30, size=n, dtype=np.uint64))
    vr.mark_dirty()
    return vr


def _validator_roots(vr: ValidatorRegistry, rows=None) -> np.ndarray:
    """u8[R, 32]: each validator's root by the host hasher (the pubkey's
    block, then three levels over the eight field chunks)."""
    chunks, pk_words = vr.validator_leaf_words(rows)
    leaves = chunks.astype(">u4").tobytes()
    n = pk_words.shape[0]
    pk_roots = nh.hash64_batch(pk_words.astype(">u4").tobytes())
    buf = np.frombuffer(leaves, np.uint8).reshape(n, 8, 32).copy()
    buf[:, 0] = np.frombuffer(pk_roots, np.uint8).reshape(n, 32)
    out = buf.tobytes()
    for _ in range(3):
        out = nh.hash64_batch(out)
    return np.frombuffer(out, np.uint8).reshape(n, 32)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 300])
def test_host_tree_matches_the_registry_root(n):
    """A host tree over the validators' roots gives the registry root that
    the port's tree kernels give (their plain versions here)."""
    vr = _registry(n, np.random.default_rng(n))
    tree = nh.HostTree(_validator_roots(vr), LIMIT)
    assert mix_in_length(tree.root(), n) == vr.hash_tree_root(LIMIT)


def test_incremental_update_equals_rebuild():
    rng = np.random.default_rng(3)
    vr = _registry(300, rng)
    tree = nh.HostTree(_validator_roots(vr), LIMIT)
    rows = np.array([0, 150, 299])
    for i in rows:
        vr.set_field(int(i), "exit_epoch", 42)
    tree.update(rows, _validator_roots(vr, rows))
    rebuilt = nh.HostTree(_validator_roots(vr), LIMIT)
    assert tree.root() == rebuilt.root()
    assert mix_in_length(tree.root(), 300) == vr.hash_tree_root(LIMIT)


def test_copy_and_overlay_leave_the_shared_tree_alone():
    """``copy`` isolates a clone; ``overlay_root`` gives the root with the
    rows replaced without writing the tree, as the JAX module does."""
    rng = np.random.default_rng(4)
    chunks = rng.integers(0, 256, size=(50, 32), dtype=np.uint8)
    tree = nh.HostTree(chunks, LIMIT)
    parent = tree.root()
    idx = np.array([0, 17, 49])
    new = rng.integers(0, 256, size=(3, 32), dtype=np.uint8)
    clone = tree.copy()
    clone.update(idx, new)
    assert tree.root() == parent
    over = nh.overlay_root(tree, idx, new)
    assert over == clone.root() != parent
    assert tree.root() == parent
    assert over == jnh.overlay_root(jnh.HostTree(chunks, LIMIT), idx, new)


def test_balances_host_tree_matches_the_column_root():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 2**40, size=997, dtype=np.uint64)
    col = CowColumn(vals.copy(), dtype=np.uint64, hashed=True)
    limit_chunks = LIMIT * 8 // 32
    packed = np.zeros(1000, np.uint64)
    packed[:997] = vals
    chunks = np.frombuffer(packed.astype("<u8").tobytes(),
                           np.uint8).reshape(-1, 32)
    tree = nh.HostTree(chunks, limit_chunks)
    assert mix_in_length(tree.root(), 997) == col.hash_tree_root(LIMIT)
    col[13] = 999
    packed[13] = 999
    tree.update(np.array([3]), np.frombuffer(
        packed[12:16].astype("<u8").tobytes(), np.uint8).reshape(1, 32))
    assert mix_in_length(tree.root(), 997) == col.hash_tree_root(LIMIT)


def test_threaded_root_matches_single_pass():
    rng = np.random.default_rng(6)
    leaves = rng.integers(0, 256, size=(1 << 15) * 32, dtype=np.uint8)
    one = nh.merkle_root_pow2(bytes(leaves), threads=1)
    assert nh.merkle_root_pow2(bytes(leaves), threads=4) == one
    assert jnh.merkle_root_pow2(bytes(leaves), threads=1) == one
