"""The port's CUDA kernels against their plain versions, on the card, at
the edges of what the kernels take (odd sizes, every ``pre_levels``, rows
with duplicates, empty cap folds), and the DeviceTree on the card against
the DeviceTree on the CPU. Bit-exact: tolerance zero.

Needs an NVIDIA card; each test skips without one (the ``cuda_device``
fixture decides at run time). On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import kernels
from lighthouse_tpu_torch.ops import merkle_tree as mt
from lighthouse_tpu_torch.ops import sha256 as sh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    kernels.build_all()
    return torch.device("cuda")


def _words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("n", [1, 255, 257, 4097])
def test_hash64_odd_sizes(cuda_device, n):
    rng = np.random.default_rng(n)
    blocks = sh.words_to_tensor(_words(rng, n, 16), "cpu")
    before = kernels.HASH64.launches
    got = sh.hash64(blocks.to(cuda_device))
    assert kernels.HASH64.launches == before + 1
    assert torch.equal(got.cpu(), sh.hash64(blocks))


@pytest.mark.parametrize("pre_levels", [0, 3])
@pytest.mark.parametrize("with_pk", [False, True])
def test_fold_pre_build_and_scatter(cuda_device, pre_levels, with_pk):
    rng = np.random.default_rng(pre_levels + 10 * with_pk)
    n_live, width, unit = 37, 64, 1 << pre_levels
    chunks = sh.words_to_tensor(_words(rng, n_live * unit, 8), "cpu")
    pk = (sh.words_to_tensor(_words(rng, n_live, 16), "cpu")
          if with_pk else None)
    out_c = torch.full((width, 8), 7, dtype=torch.int32)
    out_g = out_c.to(cuda_device)
    mt.fold_pre(chunks, pk, pre_levels, n_live, out_c)
    mt.fold_pre(chunks.to(cuda_device),
                None if pk is None else pk.to(cuda_device),
                pre_levels, n_live, out_g)
    assert torch.equal(out_g.cpu(), out_c)
    rows = torch.tensor([5, 0, 5, 36], dtype=torch.int32)
    new = _words(rng, 4 * unit, 8)
    new[2 * unit:3 * unit] = new[0:unit]          # duplicate row 5
    new_c = sh.words_to_tensor(new, "cpu")
    new_pk = None
    if with_pk:
        pkw = _words(rng, 4, 16)
        pkw[2] = pkw[0]
        new_pk = sh.words_to_tensor(pkw, "cpu")
    mt.fold_pre(new_c, new_pk, pre_levels, n_live, out_c, rows=rows)
    mt.fold_pre(new_c.to(cuda_device),
                None if new_pk is None else new_pk.to(cuda_device),
                pre_levels, n_live, out_g, rows=rows.to(cuda_device))
    assert torch.equal(out_g.cpu(), out_c)


def test_path_update_with_duplicate_rows(cuda_device):
    rng = np.random.default_rng(3)
    depth = 6
    lv = [sh.words_to_tensor(_words(rng, 1 << depth, 8), "cpu")]
    for _ in range(depth):
        lv.append(sh.hash64(lv[-1].reshape(-1, 16)))
    rows = torch.tensor([0, 1, 1, 63, 62, 17], dtype=torch.int32)
    lv[0][rows.long()] = sh.words_to_tensor(_words(rng, 6, 8), "cpu")
    lv[0][2] = lv[0][1]
    gpu = [x.to(cuda_device) for x in lv]
    for lvl in range(depth):
        mt.path_update(lv[lvl], lv[lvl + 1], rows, lvl)
        mt.path_update(gpu[lvl], gpu[lvl + 1], rows.to(cuda_device), lvl)
    for a, b in zip(gpu, lv):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k", [0, 1, 40])
def test_cap_root_depths(cuda_device, k):
    rng = np.random.default_rng(k)
    root = sh.words_to_tensor(_words(rng, 8), "cpu")
    want = sh.cap_root(root, 10, 10 + k)
    assert torch.equal(sh.cap_root(root.to(cuda_device), 10, 10 + k).cpu(),
                       want)


@pytest.mark.parametrize("n,limit,pre_levels,with_pk",
                         [(1, 16, 0, False), (100, 2**16, 0, False),
                          (300, 2**40, 3, True)])
def test_device_tree_card_equals_cpu(cuda_device, n, limit, pre_levels,
                                     with_pk):
    rng = np.random.default_rng(n)
    unit = 1 << pre_levels
    words = _words(rng, n * unit, 8)
    pk = _words(rng, n, 16) if with_pk else None
    cpu = mt.DeviceTree(n, limit, pre_levels, with_pk, device="cpu")
    gpu = mt.DeviceTree(n, limit, pre_levels, with_pk, device=cuda_device)
    cpu.build(words, pk)
    gpu.build(words, pk)
    assert gpu.root() == cpu.root()
    other = gpu.share()
    rows = np.unique([0, n - 1, n // 2])
    new = _words(rng, len(rows) * unit, 8)
    new_pk = _words(rng, len(rows), 16) if with_pk else None
    root0 = gpu.root()
    cpu.update(rows, new, new_pk)
    gpu.update(rows, new, new_pk)
    assert gpu.root() == cpu.root()
    assert other.root() == root0


def test_merkleize_words_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(9)
    leaves = _words(rng, 1000, 8)
    assert sh.root_bytes(sh.merkleize_words(leaves, 2**38, cuda_device)) \
        == sh.root_bytes(sh.merkleize_words(leaves, 2**38, "cpu"))
