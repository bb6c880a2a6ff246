"""Device-resident incremental merkle tree on the card.

The port of the JAX package's ``lighthouse_tpu/ops/merkle_tree.py``
``DeviceTree``: every dense level of the tree lives on the device as an
int32 ``u32[2^l, 8]`` tensor, so a root after a few point writes costs
O(dirty rows x depth) hashes instead of a rebuild.

- ``build``: one ``fold_pre`` launch turns the leaf units into level 0
  (pubkey hash into chunk 0, ``pre_levels`` pair folds, zero chunks past
  ``n_live``), then one ``hash64`` launch a level, then ``cap_fold``.
- ``update``: one ``fold_pre`` launch folds the R dirty units and scatters
  them into level 0, then one ``path_update`` launch walks the distinct
  dirty paths up through every level (a grid barrier between levels keeps
  level l whole before level l+1 reads it) and folds the root's zero
  caps from its table (``csrc/zero_hashes.cuh``).

Level tensors are updated in place (the analogue of the JAX package's
donating program) unless the tree is shared (``share()``): the first write
after a share copies the levels, so the other owner's root never moves.

Kernels here, each with its plain PyTorch version beside it: ``fold_pre``
(csrc/fold_pre.cu) and ``path_update`` (csrc/path_update.cu, through
``DeviceTree.update``'s ``_path_walk``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..device import resolve
from ..obs import device as device_ledger
from ..obs.roofline import tracked
from .sha256 import (
    HASH64_INT_OPS, ZERO_HASH_WORDS, _check_words, _hash64_plain, cap_root,
    hash64, root_bytes, words_to_tensor,
)

#: ``pre_levels`` the fold_pre kernel is built for (template instances):
#: 0 for packed-uint columns, 3 for the validator registry.
PRE_LEVELS = (0, 3)


def _check_rows(rows: torch.Tensor, device, name: str) -> None:
    if rows.dtype != torch.int32 or rows.ndim != 1:
        raise TypeError(f"{name}: rows must be a 1-D int32 tensor")
    if rows.device != device:
        raise ValueError(f"{name}: rows on {rows.device}, data on {device}")
    if device.type == "cuda" and not rows.is_contiguous():
        raise ValueError(f"{name}: CUDA rows must be contiguous")


# -- fold_pre -------------------------------------------------------------------

def _fold_units_plain(chunks: torch.Tensor, pk: torch.Tensor | None,
                      pre_levels: int) -> torch.Tensor:
    unit = 1 << pre_levels
    nodes = chunks.reshape(-1, unit, 8)
    if pk is not None:
        nodes = nodes.clone()
        nodes[:, 0] = _hash64_plain(pk)
    nodes = nodes.reshape(-1, 8)
    for _ in range(pre_levels):
        nodes = _hash64_plain(nodes.reshape(nodes.shape[0] // 2, 16))
    return nodes


def _fold_pre_plain(chunks, pk, rows, n_threads, n_live, pre_levels, out):
    """Plain version of the fold_pre kernel (same modes, writes ``out``)."""
    if rows is None:
        live = min(n_threads, n_live)
        out[:n_threads] = 0
        if live:
            unit = 1 << pre_levels
            out[:live] = _fold_units_plain(
                chunks[:live * unit], None if pk is None else pk[:live],
                pre_levels)
        return
    leaves = _fold_units_plain(chunks, pk, pre_levels)
    dst = rows.to(torch.int64)
    leaves = torch.where((dst < n_live)[:, None], leaves,
                         torch.zeros_like(leaves))
    out[dst] = leaves


def _fold_pre_cost(ret, chunks, pk, pre_levels, n_live, out, rows=None):
    """Each folded unit's chunks (and pubkey block) read, each slot of
    ``out`` written (a build: every slot; an update: its rows, with the
    row index read); a hash a chunk pair of the unit's subtree and one a
    pubkey."""
    unit, has_pk = 1 << pre_levels, pk is not None
    if rows is None:
        slots = int(out.shape[0])
        units = min(slots, int(n_live))
        n_bytes = units * (unit * 32 + 64 * has_pk) + slots * 32
    else:
        units = int(rows.shape[0])
        n_bytes = units * (unit * 32 + 64 * has_pk + 4 + 32)
    return n_bytes, units * (unit - 1 + has_pk) * HASH64_INT_OPS


@tracked("fold_pre", _fold_pre_cost)
def fold_pre(chunks: torch.Tensor, pk: torch.Tensor | None,
             pre_levels: int, n_live: int, out: torch.Tensor,
             rows: torch.Tensor | None = None) -> torch.Tensor:
    """Fold leaf units of ``2**pre_levels`` chunks into level-0 leaves.

    chunks: u32[U * 2**pre_levels, 8]; pk: u32[U, 16] pubkey blocks hashed
    into chunk 0 of each unit, or None; out: u32[M, 8] level 0, written in
    place. Without ``rows`` (a build) every slot t < M is written: the fold
    of unit t where t < n_live, else a zero chunk (so chunks need hold only
    min(M, n_live) units). With ``rows`` (i32[U], an update) unit t is
    folded and written to slot rows[t]; rows must lie in [0, M) (the
    kernel does not check them: DeviceTree.update does). Returns ``out``."""
    _check_words(chunks, 8, "fold_pre")
    _check_words(out, 8, "fold_pre")
    if out.ndim != 2 or chunks.ndim != 2:
        raise ValueError("fold_pre: chunks and out are [*, 8]")
    if pk is not None:
        _check_words(pk, 16, "fold_pre")
    if pre_levels not in PRE_LEVELS:
        raise ValueError(f"fold_pre: pre_levels {pre_levels} not in "
                         f"{PRE_LEVELS}")
    unit = 1 << pre_levels
    dev = out.device
    if chunks.device != dev or (pk is not None and pk.device != dev):
        raise ValueError("fold_pre: inputs on different devices")
    if rows is None:
        n_threads = int(out.shape[0])
        n_units = min(n_threads, int(n_live))
    else:
        _check_rows(rows, dev, "fold_pre")
        n_threads = n_units = int(rows.shape[0])
    if chunks.shape[0] < n_units * unit or (
            pk is not None and pk.shape[0] < n_units):
        raise ValueError("fold_pre: fewer input units than slots to fold")
    if dev.type == "cpu":
        _fold_pre_plain(chunks, pk, rows, n_threads, int(n_live),
                        pre_levels, out)
        return out
    if n_threads:
        kernels.FOLD_PRE.launch(
            chunks.data_ptr(), None if pk is None else pk.data_ptr(),
            None if rows is None else rows.data_ptr(), n_threads,
            int(n_live), pre_levels, out.data_ptr(), kernels.stream_ptr(dev))
    return out


# -- path_update ------------------------------------------------------------------

#: the deepest tree one walk takes (csrc/path_update.cu LH_PATH_MAX_DEPTH:
#: the level pointers travel by value in a fixed-size struct)
PATH_MAX_DEPTH = 48


def _path_walk_plain(levels, rows):
    """Plain version of the walk: level by level, for each dirty leaf row
    r, levels[l + 1][p] = hash64(levels[l][2p] || levels[l][2p + 1]) with
    p = r >> (l + 1), in place."""
    rows = rows.to(torch.int64)
    for lvl in range(len(levels) - 1):
        parent = rows >> (lvl + 1)
        levels[lvl + 1][parent] = _hash64_plain(
            levels[lvl].reshape(-1, 16)[parent])


def _path_walk_cost(root, levels, rows, limit_depth):
    """The work this update needs: one hash a distinct dirty parent a
    level, then a hash a cap; each hashed pair read and its parent
    written, the rows read, the root written."""
    depth = len(levels) - 1
    r = rows.cpu().numpy().astype(np.int64)
    parents = sum(len(np.unique(r >> (lvl + 1))) for lvl in range(depth))
    parents += limit_depth - depth
    return parents * (64 + 32) + 4 * len(r) + 32, parents * HASH64_INT_OPS


@tracked("path_update", _path_walk_cost)
def _path_walk(levels: list[torch.Tensor], rows: torch.Tensor,
               limit_depth: int) -> torch.Tensor:
    """The dirty-path walk of an update, in place, and the root capped to
    ``limit_depth``, in one launch on the card: levels[0] is u32[2^D, 8]
    (its dirty leaves already written), levels[l] u32[2^(D - l), 8],
    1 <= D <= PATH_MAX_DEPTH; rows: the dirty leaf rows, int32,
    sorted and distinct. The kernel hashes a parent where a row's parent
    differs from the row before's, so it needs that order; the one caller,
    DeviceTree.update, passes np.unique of its rows (the plain version
    takes rows in any order). The same launch folds the zero caps D ..
    limit_depth - 1 into the top node; returns that root (u32[8]; the top
    node itself when limit_depth == D)."""
    depth = len(levels) - 1
    if not 1 <= depth <= PATH_MAX_DEPTH:
        raise ValueError(f"_path_walk: depth {depth} outside the kernel's "
                         f"1..{PATH_MAX_DEPTH}")
    if not depth <= limit_depth <= ZERO_HASH_WORDS.shape[0]:
        raise ValueError(f"_path_walk: limit depth {limit_depth} outside "
                         f"{depth}..{ZERO_HASH_WORDS.shape[0]}")
    dev = levels[0].device
    _check_rows(rows, dev, "_path_walk")
    ptrs = (ctypes.c_void_p * (depth + 1))()
    for lvl, lv in enumerate(levels):
        if (lv.dtype != torch.int32 or lv.device != dev
                or lv.shape != (1 << (depth - lvl), 8)):
            raise ValueError(f"_path_walk: level {lvl} is {lv.dtype} "
                             f"{tuple(lv.shape)} on {lv.device}, expected "
                             f"int32 ({1 << (depth - lvl)}, 8) on {dev}")
        if dev.type == "cuda":
            if not lv.is_contiguous() or lv.data_ptr() % 16:
                raise ValueError(f"_path_walk: level {lvl} must be "
                                 f"contiguous and 16-byte aligned")
            ptrs[lvl] = lv.data_ptr()
    if dev.type == "cpu":
        _path_walk_plain(levels, rows)
    if dev.type == "cpu" or rows.shape[0] == 0:     # the kernel takes R >= 1
        return cap_root(levels[-1][0], depth, limit_depth)
    root = torch.empty(8, dtype=torch.int32, device=dev)
    kernels.PATH_UPDATE.launch(ptrs, depth, rows.data_ptr(),
                               int(rows.shape[0]), limit_depth,
                               root.data_ptr(), kernels.stream_ptr(dev))
    return root


# -- the tree ---------------------------------------------------------------------

class DeviceTree:
    """Incremental merkle tree over ``n_leaves`` chunk leaves, padded to
    a dense power-of-two subtree and zero-capped to ``limit`` leaves.

    With ``pre_levels=p`` the public leaf unit is a 2^p-chunk subtree:
    ``build``/``update`` take ``2^p`` chunk words per leaf and fold them
    on device. ``device``: where the levels live (None: the port's
    default device).
    """

    def __init__(self, n_leaves: int, limit: int, pre_levels: int = 0,
                 with_pk: bool = False, device=None):
        self.n = int(n_leaves)
        self.limit_depth = max(0, (int(limit) - 1).bit_length())
        dense = 1 if self.n <= 1 else 1 << (self.n - 1).bit_length()
        self.dense_depth = (dense - 1).bit_length()
        self.dense = dense
        self.pre_levels = int(pre_levels)
        self.with_pk = bool(with_pk)
        self.device = resolve(device)
        self.levels: list[torch.Tensor] | None = None
        self.root_words: torch.Tensor | None = None
        self._shared = False

    def share(self) -> "DeviceTree":
        """A second owner of the same level tensors. Both owners are
        flagged, so whichever writes next copies the levels first."""
        other = DeviceTree.__new__(DeviceTree)
        other.__dict__.update(self.__dict__)
        if self.levels is not None:
            other.levels = list(self.levels)
        self._shared = True
        other._shared = True
        return other

    def _units(self, words, count: int, width: int) -> torch.Tensor:
        t = words_to_tensor(words, self.device)
        if t.ndim != 2 or t.shape != (count, width):
            raise ValueError(f"expected [{count}, {width}] words, "
                             f"got {tuple(t.shape)}")
        return t

    def _pk(self, pk_blocks, count: int) -> torch.Tensor | None:
        if not self.with_pk:
            return None
        if pk_blocks is None:
            raise ValueError("tree built with_pk needs pk_blocks")
        return self._units(pk_blocks, count, 16)

    def build(self, pre_leaf_words, pk_blocks=None) -> None:
        """pre_leaf_words: u32[n * 2**pre_levels, 8] (numpy or an int32
        tensor); with ``with_pk``, pk_blocks u32[n, 16] hashes into chunk 0
        of each leaf's chunk group on device."""
        unit = 1 << self.pre_levels
        chunks = self._units(pre_leaf_words, self.n * unit, 8)
        pk = self._pk(pk_blocks, self.n)
        level = torch.empty((self.dense, 8), dtype=torch.int32,
                            device=self.device)
        fold_pre(chunks, pk, self.pre_levels, self.n, level)
        levels = [level]
        for _ in range(self.dense_depth):
            levels.append(hash64(levels[-1].reshape(-1, 16)))
        self.levels = levels
        self.root_words = cap_root(levels[-1][0], self.dense_depth,
                                   self.limit_depth)
        self._shared = False
        device_ledger.attribute("ops.merkle_tree", "levels", *levels)

    def update(self, rows, pre_leaf_words, pk_blocks=None) -> None:
        """rows: leaf indices; pre_leaf_words: u32[R * 2**pre_levels, 8].

        Duplicate rows are allowed only when they carry identical leaf
        words (fold_pre writes each row's words; two writes of one slot
        race, and identical words make the race harmless). The walk takes
        the distinct rows sorted, uploaded beside the rows in one copy:
        each dirty parent is hashed once. An empty ``rows`` is a no-op."""
        rows = np.asarray(rows, dtype=np.int64)
        r = len(rows)
        if r == 0:
            return
        if rows.min() < 0 or rows.max() >= self.n:
            raise IndexError(f"rows out of range for a {self.n}-leaf tree")
        unit = 1 << self.pre_levels
        chunks = self._units(pre_leaf_words, r * unit, 8)
        pk = self._pk(pk_blocks, r)
        if self._shared:
            self.levels = [lv.clone() for lv in self.levels]
            self._shared = False
            device_ledger.attribute("ops.merkle_tree", "levels",
                                    *self.levels)
        both = torch.from_numpy(
            np.concatenate([rows, np.unique(rows)]).astype(np.int32)
        ).to(self.device)
        fold_pre(chunks, pk, self.pre_levels, self.n, self.levels[0],
                 rows=both[:r])
        if self.dense_depth:
            # the walk folds the root's caps in the same launch
            self.root_words = _path_walk(self.levels, both[r:],
                                         self.limit_depth)
        else:
            self.root_words = cap_root(self.levels[-1][0], 0,
                                       self.limit_depth)

    def root(self) -> bytes:
        return root_bytes(self.root_words)
