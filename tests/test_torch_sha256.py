"""The port's SHA-256 kernels (plain versions on the CPU) against the JAX
package's ``ops/sha256`` and hashlib: same seeded inputs, byte-equal words
and roots (tolerance zero)."""
import hashlib

import numpy as np
import pytest
import torch

from lighthouse_tpu.ops import sha256 as jk
from lighthouse_tpu.ssz import merkleize_chunks, mix_in_length
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.ops import sha256 as tk


@pytest.fixture(autouse=True)
def cpu_device():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _blocks(rng, n):
    raw = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    raw[0] = 0xFF                       # every word 0xFFFFFFFF
    raw[1, ::4] = 0x80                  # top bit of every word set
    return raw


def test_hash64_matches_jax_and_hashlib():
    rng = np.random.default_rng(0)
    raw = _blocks(rng, 32)
    words = tk.chunks_to_words(raw.tobytes()).reshape(32, 16)
    got = tk.tensor_to_words(tk.hash64(tk.words_to_tensor(words)))
    want = np.asarray(jk.hash64(words))
    np.testing.assert_array_equal(got, want)
    for i in range(32):
        assert tk.words_to_chunks(got[i]) == \
            hashlib.sha256(raw[i].tobytes()).digest()


@pytest.mark.parametrize("n", [1, tk._INT_ROWS, tk._INT_ROWS + 1])
def test_hash64_integer_and_tensor_rounds_agree(n):
    """On the CPU the plain rounds run on Python integers up to _INT_ROWS
    blocks and on int64 tensors past it: both give hashlib's digests."""
    raw = _blocks(np.random.default_rng(n), max(n, 2))[:n]
    blocks = tk.words_to_tensor(
        tk.chunks_to_words(raw.tobytes()).reshape(n, 16))
    want = [hashlib.sha256(r.tobytes()).digest() for r in raw]
    by_int = tk._hash64_rows_int(blocks)
    got = tk._hash64_plain(blocks)
    assert torch.equal(by_int, got)
    assert [tk.words_to_chunks(w) for w in tk.tensor_to_words(got)] == want


def test_int32_words_keep_top_bit_patterns():
    """u32 words with the top bit set are negative int32 on the device and
    come back as the same u32 words."""
    words = np.array([[0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0] * 4],
                     dtype=np.uint32)
    t = tk.words_to_tensor(words)
    assert t.dtype == torch.int32
    assert t[0, 0].item() == -1 and t[0, 1].item() == -2**31
    np.testing.assert_array_equal(tk.tensor_to_words(t), words)
    got = tk.tensor_to_words(tk.hash64(t))
    assert tk.words_to_chunks(got[0]) == hashlib.sha256(
        tk.words_to_chunks(words)).digest()


def test_hash_pairs_matches_jax():
    rng = np.random.default_rng(1)
    nodes = rng.integers(0, 2**32, size=(64, 8), dtype=np.uint64).astype(
        np.uint32)
    got = tk.tensor_to_words(tk.hash_pairs(tk.words_to_tensor(nodes)))
    np.testing.assert_array_equal(got, np.asarray(jk.hash_pairs(nodes)))


@pytest.mark.parametrize("n,limit", [(0, 8), (1, 16), (5, 16),
                                     (100, 2**16), (1000, 2**38)])
def test_merkleize_words_matches_jax_and_oracle(n, limit):
    rng = np.random.default_rng(n)
    chunks = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    leaves = (tk.chunks_to_words(chunks.tobytes()) if n
              else np.zeros((0, 8), np.uint32))
    got = tk.root_bytes(tk.merkleize_words(leaves, limit))
    want_jax = jk.words_to_chunks(np.asarray(jk.merkleize_words(leaves,
                                                                limit)))
    assert got == want_jax
    assert got == merkleize_chunks([bytes(c) for c in chunks], limit)


def test_mix_in_length_words_matches_jax():
    rng = np.random.default_rng(3)
    root = rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
    got = tk.root_bytes(tk.mix_in_length_words(tk.words_to_tensor(root),
                                               1_000_000))
    want = jk.words_to_chunks(np.asarray(jk.mix_in_length_words(root,
                                                                1_000_000)))
    assert got == want == mix_in_length(tk.words_to_chunks(root), 1_000_000)


def test_cap_fold_matches_jax():
    rng = np.random.default_rng(4)
    root = rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
    zeros = tk.ZERO_HASH_WORDS[20:40]
    got = tk.tensor_to_words(tk.cap_fold(tk.words_to_tensor(root),
                                         tk.words_to_tensor(zeros)))
    want = np.asarray(jk._fold_zero_caps(root, zeros))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tk.ZERO_HASH_WORDS, jk.ZERO_HASH_WORDS)


def test_zero_hash_table_is_rendered_from_the_words():
    """csrc/zero_hashes.cuh is render_zero_hashes()'s output, and its
    constant table, read back from the file, is _zero_hash_words() (the
    zero-subtree roots of utils/hash.py) row for row, and the JAX
    package's table."""
    import re

    from lighthouse_tpu_torch.kernels import CSRC
    text = (CSRC / "zero_hashes.cuh").read_text()
    assert text == tk.render_zero_hashes()
    body = text[text.index("LHSHA_ZERO_HASHES["):text.index("};")]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]
    table = np.array(words, dtype=np.uint32).reshape(-1, 8)
    np.testing.assert_array_equal(table, tk._zero_hash_words())
    np.testing.assert_array_equal(table, jk.ZERO_HASH_WORDS)


@pytest.mark.parametrize("dense,limit", [(0, 0), (20, 21), (20, 40),
                                         (0, 44)])
def test_cap_root_copies_no_caps(monkeypatch, dense, limit):
    """cap_root folds from the table in place: no
    words_to_tensor of the caps (the per-root copy the card's path made),
    and the JAX package's fold of the same caps."""
    rng = np.random.default_rng(dense + limit)
    root = rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jk._fold_zero_caps(root,
                                         jk.ZERO_HASH_WORDS[dense:limit]))
    t = tk.words_to_tensor(root)

    def refuse(*args, **kwargs):
        raise AssertionError("a cap copied with words_to_tensor")

    monkeypatch.setattr(tk, "words_to_tensor", refuse)
    np.testing.assert_array_equal(
        tk.tensor_to_words(tk.cap_root(t, dense, limit)), want)
    with pytest.raises(ValueError):
        tk.cap_root(t, limit + 1, limit)


def test_wrappers_reject_what_the_kernels_do_not_take():
    blocks = torch.zeros((4, 16), dtype=torch.int64)
    with pytest.raises(TypeError):
        tk.hash64(blocks)
    with pytest.raises(ValueError):
        tk.hash64(torch.zeros((4, 15), dtype=torch.int32))
    with pytest.raises(ValueError):
        tk.hash64(torch.zeros((4, 16), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        tk.cap_fold(torch.zeros(8, dtype=torch.int32),
                    torch.zeros(8, dtype=torch.int32))


@pytest.mark.parametrize("length", [0, 1, 55, 56, 64, 100, 200])
def test_sha256_messages_matches_jax_and_hashlib(length):
    """pad_messages and sha256_messages (plain version) at the lengths and
    shapes of tests/test_sha256_kernel.py (4 messages): the same padded
    words and digests as the JAX package's, and hashlib's digests."""
    rng = np.random.default_rng(2)
    msgs = rng.integers(0, 256, size=(4, length), dtype=np.uint8)
    padded = tk.pad_messages(msgs)
    np.testing.assert_array_equal(padded, jk.pad_messages(msgs))
    got = tk.tensor_to_words(tk.sha256_messages(tk.words_to_tensor(padded)))
    np.testing.assert_array_equal(got, np.asarray(jk.sha256_messages(padded)))
    for i in range(4):
        assert tk.words_to_chunks(got[i]) == \
            hashlib.sha256(msgs[i].tobytes()).digest()


def test_sha256_messages_refuses_other_shapes():
    with pytest.raises(ValueError):
        tk.sha256_messages(torch.zeros((4, 16), dtype=torch.int32))
    with pytest.raises(TypeError):
        tk.sha256_messages(torch.zeros((4, 1, 16), dtype=torch.int64))
