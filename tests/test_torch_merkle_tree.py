"""The port's DeviceTree (plain kernel versions on the CPU) against the
JAX package's ``ops/merkle_tree.DeviceTree``: build, update, share and a
tree carried across, with byte-equal levels and roots (tolerance zero).
Shapes follow tests/test_merkle_tree.py so the JAX programs are shared."""
import numpy as np
import pytest

from lighthouse_tpu.ops.merkle_tree import DeviceTree as JaxTree
from lighthouse_tpu_torch.convert import device_tree_from_levels
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.ops.merkle_tree import DeviceTree
from lighthouse_tpu_torch.ops.sha256 import chunks_to_words, tensor_to_words
from lighthouse_tpu_torch.ssz import merkleize_chunks


@pytest.fixture(autouse=True)
def cpu_device():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _words(rng, rows, width=8):
    return rng.integers(0, 2**32, size=(rows, width),
                        dtype=np.uint64).astype(np.uint32)


def _assert_same(port: DeviceTree, jax_tree: JaxTree) -> None:
    assert port.root() == jax_tree.root()
    assert len(port.levels) == len(jax_tree.levels)
    for mine, theirs in zip(port.levels, jax_tree.levels):
        np.testing.assert_array_equal(tensor_to_words(mine),
                                      np.asarray(theirs))


def _pair(n, limit, pre_levels=0, with_pk=False):
    return (DeviceTree(n, limit, pre_levels, with_pk),
            JaxTree(n, limit, pre_levels, with_pk))


@pytest.mark.parametrize("n,limit", [(1, 16), (5, 16), (100, 2**16)])
def test_build_matches_jax_and_oracle(n, limit):
    rng = np.random.default_rng(n)
    chunks = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    words = chunks_to_words(chunks.tobytes())
    port, ref = _pair(n, limit)
    port.build(words)
    ref.build(words)
    _assert_same(port, ref)
    assert port.root() == merkleize_chunks([bytes(c) for c in chunks], limit)


def test_registry_build_zeroes_padding_units():
    """pre_levels=3 with pubkeys at n = 300: units 300..511 of the dense
    512-wide tree are zero chunks after the fold, not zero-subtree roots."""
    rng = np.random.default_rng(11)
    n, limit = 300, 2**40
    chunks, pk = _words(rng, n * 8), _words(rng, n, 16)
    port, ref = _pair(n, limit, pre_levels=3, with_pk=True)
    port.build(chunks, pk)
    ref.build(chunks, pk)
    _assert_same(port, ref)
    assert not tensor_to_words(port.levels[0])[n:].any()


@pytest.mark.parametrize("rows", [[1, 2, 2], [1, 2, 3], [99]])
def test_update_with_duplicate_and_padded_rows(rows):
    """R = 3 rows (the JAX tree pads to 4 by repeating row 0) and a
    duplicated row carrying identical words."""
    rng = np.random.default_rng(42)
    n, limit = 100, 2**16
    words = _words(rng, n)
    port, ref = _pair(n, limit)
    port.build(words)
    ref.build(words)
    for r in sorted(set(rows)):
        words[r] = _words(rng, 1)[0]
    rows = np.asarray(rows)
    port.update(rows, words[rows])
    ref.update(rows, words[rows])
    _assert_same(port, ref)
    fresh = DeviceTree(n, limit)
    fresh.build(words)
    assert port.root() == fresh.root()


def test_registry_update_matches_jax():
    rng = np.random.default_rng(13)
    n, limit = 300, 2**40
    chunks, pk = _words(rng, n * 8), _words(rng, n, 16)
    port, ref = _pair(n, limit, pre_levels=3, with_pk=True)
    port.build(chunks, pk)
    ref.build(chunks, pk)
    rows = np.array([0, 150, 150])
    new_chunks = _words(rng, 3 * 8)
    new_chunks[16:24] = new_chunks[8:16]
    new_pk = _words(rng, 3, 16)
    new_pk[2] = new_pk[1]
    port.update(rows, new_chunks, new_pk)
    ref.update(rows, new_chunks, new_pk)
    _assert_same(port, ref)


def test_update_after_share_keeps_other_root():
    rng = np.random.default_rng(7)
    n, limit = 64, 2**10
    words = _words(rng, n)
    tree = DeviceTree(n, limit)
    tree.build(words)
    root0 = tree.root()
    level0 = tensor_to_words(tree.levels[0]).copy()
    other = tree.share()
    words[3] = 0
    tree.update(np.asarray([3]), words[3:4])
    assert tree.root() != root0
    assert other.root() == root0
    np.testing.assert_array_equal(tensor_to_words(other.levels[0]), level0)
    ref = JaxTree(n, limit)
    ref.build(words)
    _assert_same(tree, ref)
    # the other owner updates on its own copy too
    other.update(np.asarray([3]), words[3:4])
    assert other.root() == tree.root()


def test_tree_carried_across_then_updated_on_both_sides():
    rng = np.random.default_rng(5)
    n, limit = 100, 2**16
    words = _words(rng, n)
    ref = JaxTree(n, limit)
    ref.build(words)
    port = device_tree_from_levels([np.asarray(lv) for lv in ref.levels],
                                   n, limit)
    _assert_same(port, ref)
    rows = np.array([1, 2, 3])
    new = _words(rng, 3)
    port.update(rows, new)
    ref.update(rows, new)
    _assert_same(port, ref)


def _walk_rows(case, n, rng):
    """The dirty rows of one walk case at n leaves."""
    if case == "random":
        return rng.choice(n, size=12, replace=False)
    if case == "duplicates":
        return np.array([9, 40, 9, 3, 40, 40])
    if case == "one row":
        return np.array([77])
    if case == "every leaf":
        return rng.permutation(n)
    if case == "one parent":
        return np.array([51, 50])
    return np.array([90, 4, 63, 5, 31, 0, 99, 64])      # unsorted


@pytest.mark.parametrize("case", ["random", "duplicates", "one row",
                                  "every leaf", "one parent", "unsorted"])
def test_update_walk_matches_jax_on_every_level(case):
    """DeviceTree.update (fold_pre, then the one-launch walk's plain
    version on the sorted distinct rows) against the JAX DeviceTree at
    depth 7: every level tensor equal (tolerance zero), not only the
    root. Duplicate rows carry identical words."""
    rng = np.random.default_rng(len(case))
    n, limit = 100, 2**16
    words = _words(rng, n)
    port, ref = _pair(n, limit)
    port.build(words)
    ref.build(words)
    rows = _walk_rows(case, n, rng)
    for r in np.unique(rows):
        words[r] = _words(rng, 1)[0]
    port.update(rows, words[rows])
    ref.update(rows, words[rows])
    _assert_same(port, ref)


def test_walk_plain_hashes_each_dirty_parent():
    """The walk's plain version on unsorted rows with repeats: every
    level equal to a rebuild from the new leaves (the kernel takes the
    rows sorted and distinct; the plain version takes any)."""
    import torch

    from lighthouse_tpu_torch.ops import merkle_tree as mt
    from lighthouse_tpu_torch.ops import sha256 as sh
    rng = np.random.default_rng(8)
    depth = 8
    levels = [sh.words_to_tensor(_words(rng, 1 << depth), "cpu")]
    for _ in range(depth):
        levels.append(sh.hash64(levels[-1].reshape(-1, 16)))
    rows = np.array([200, 3, 3, 255, 0, 128, 200])
    levels[0][rows] = sh.words_to_tensor(_words(rng, len(rows)), "cpu")
    root = mt._path_walk(levels, torch.from_numpy(rows.astype(np.int32)),
                         depth)
    assert torch.equal(root, levels[-1][0])
    want = [levels[0]]
    for _ in range(depth):
        want.append(sh.hash64(want[-1].reshape(-1, 16)))
    for got, w in zip(levels, want):
        assert torch.equal(got, w)


def test_walk_refuses_a_tree_past_the_kernels_depth():
    import torch

    from lighthouse_tpu_torch.ops import merkle_tree as mt
    levels = [torch.zeros((1, 8), dtype=torch.int32)] * (
        mt.PATH_MAX_DEPTH + 2)
    with pytest.raises(ValueError, match="depth"):
        mt._path_walk(levels, torch.zeros(1, dtype=torch.int32),
                      mt.PATH_MAX_DEPTH + 1)


def test_update_rejects_rows_out_of_range():
    tree = DeviceTree(10, 16)
    tree.build(np.zeros((10, 8), np.uint32))
    with pytest.raises(IndexError):
        tree.update(np.array([10]), np.zeros((1, 8), np.uint32))
