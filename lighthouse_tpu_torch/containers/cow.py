"""Chunk-granular copy-on-write state columns.

The reference client keeps BeaconState in `milhouse` persistent trees so
cloning is O(mutations) structural sharing; plain SoA columns would pay
O(bytes) memcpy per copy instead.  ``CowColumn`` closes that gap for dense numpy
columns: the data lives in fixed-size row chunks (``CHUNK_ROWS`` rows)
shared by reference across forks, with a per-chunk refcount cell so a
write materializes only its own chunk and ``fork()`` is O(chunks)
pointer work.

One dirty-bookkeeping layer feeds both copy and hash: every write path
funnels through ``__setitem__``/``_scatter``, which privatize the CoW
chunk *and* record the touched 32-byte merkle leaves for the incremental
device tree (ops/merkle_tree.DeviceTree).  Forked columns share that tree
copy-on-write: whichever fork updates it next copies its levels first.

Writes MUST go through the column API (``col[rows] = v``, ``set_field``,
``mark_dirty*``); grabbing the backing array and writing it in place
bypasses both the refcounts and the dirty set — graftlint's
``cow-discipline`` rule flags that pattern.
"""
from __future__ import annotations

import sys

import numpy as np

from ..utils.hash import ZERO_HASHES

#: rows per CoW chunk.  4096 rows keeps fork() at ~245 cells per 1M-row
#: u64 column (32 KB/chunk) and divides every merkle-leaf width in use
#: (4 u64 rows or 32 u8 rows per 32-byte leaf), so a leaf never spans
#: two CoW chunks and dirty-leaf reads stay chunk-direct.
CHUNK_ROWS = 4096

#: process-wide CoW accounting, mirrored into graftscope counters when
#: the metrics module is loaded.
STATS = {"chunks_materialized": 0, "chunks_shared": 0, "rebases": 0,
         "bytes_materialized": 0, "bytes_shared": 0}


def _count_metric(name: str, amount: int) -> None:
    m = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    if m is not None:
        m.count(name, amount)


def _mix_in_length(root: bytes, length: int) -> bytes:
    from ..ssz import mix_in_length
    return mix_in_length(root, length)


class CowColumn(np.lib.mixins.NDArrayOperatorsMixin):
    """A dense numpy column with chunk-granular copy-on-write forks.

    Reads behave like the wrapped ndarray (ufuncs, fancy indexing,
    ``astype``/``tobytes``/``sum``/iteration); ``np.asarray(col)``
    yields a read-only view so the only write path is the column API.
    ``hashed=True`` adds the incremental packed-uint merkle tree
    (u64/u8 1-D columns only), fed by the same writes.
    """

    def __init__(self, values, dtype=None, hashed: bool = False):
        arr = np.ascontiguousarray(values, dtype=dtype)
        if not arr.flags.writeable or arr.base is not None:
            arr = arr.copy()
        self.dtype = arr.dtype
        self._n = int(arr.shape[0])
        self._row_shape = arr.shape[1:]
        self._base = arr
        nb = (self._n + CHUNK_ROWS - 1) // CHUNK_ROWS
        self._chunks = [arr[c * CHUNK_ROWS:(c + 1) * CHUNK_ROWS]
                        for c in range(nb)]
        self._rc = [[1] for _ in range(nb)]
        self._contig = True    # every chunk is a view of _base
        self._owned = True     # sole owner of every chunk AND _base
        self._hashed = bool(hashed)
        if hashed:
            assert arr.ndim == 1 and 32 % self.dtype.itemsize == 0, \
                "hashed columns are packed 1-D uint columns"
            self._per_leaf = 32 // self.dtype.itemsize
        else:
            self._per_leaf = 0
        # merkle state (hashed mode): dirty set at 32-byte-leaf
        # granularity, None = full rebuild
        self._dirty_leaves: set[int] | None = None
        self._root_cache: bytes | None = None
        self._device_tree = None

    def __del__(self):
        try:
            for cell in self._rc:
                cell[0] -= 1
        except Exception:
            pass

    # -- fork / ownership ----------------------------------------------------

    def fork(self) -> "CowColumn":
        """O(chunks) second owner: chunks shared by reference, refcount
        cells shared by identity, merkle trees shared copy-on-write."""
        out = object.__new__(type(self))
        out.dtype = self.dtype
        out._n = self._n
        out._row_shape = self._row_shape
        out._base = self._base
        out._chunks = list(self._chunks)
        out._rc = list(self._rc)
        for cell in self._rc:
            cell[0] += 1
        out._contig = self._contig
        self._owned = False
        out._owned = False
        out._hashed = self._hashed
        out._per_leaf = self._per_leaf
        out._dirty_leaves = (set(self._dirty_leaves)
                             if self._dirty_leaves is not None else None)
        out._root_cache = self._root_cache
        out._device_tree = (self._device_tree.share()
                            if self._device_tree is not None else None)
        STATS["chunks_shared"] += len(self._chunks)
        STATS["bytes_shared"] += sum(c.nbytes for c in self._chunks)
        _count_metric("state_cow_chunks_shared", len(self._chunks))
        return out

    def _writable_chunk(self, c: int) -> np.ndarray:
        """Chunk ``c`` safe to write in place: privatizes (copies) it
        first when another fork still references the cell."""
        cell = self._rc[c]
        if cell[0] > 1:
            cell[0] -= 1
            self._chunks[c] = self._chunks[c].copy()
            self._rc[c] = [1]
            self._contig = False
            STATS["chunks_materialized"] += 1
            STATS["bytes_materialized"] += self._chunks[c].nbytes
            _count_metric("state_cow_chunks_materialized", 1)
        return self._chunks[c]

    def _rebase(self) -> None:
        """Compact into a fresh exclusively-owned dense base (whole-array
        reads and generic writes land here)."""
        if self._contig:
            base = self._base.copy()
        else:
            base = np.empty((self._n,) + self._row_shape, self.dtype)
            for c, ch in enumerate(self._chunks):
                o = c * CHUNK_ROWS
                base[o:o + ch.shape[0]] = ch
        for cell in self._rc:
            cell[0] -= 1
        nb = len(self._chunks)
        self._base = base
        self._chunks = [base[c * CHUNK_ROWS:(c + 1) * CHUNK_ROWS]
                        for c in range(nb)]
        self._rc = [[1] for _ in range(nb)]
        self._contig = True
        self._owned = True
        STATS["rebases"] += 1

    def _own_all(self) -> None:
        if not self._owned:
            self._rebase()

    def _array(self) -> np.ndarray:
        """Dense backing for whole-array READS (may still be shared —
        callers must not write it; writers go through _own_all)."""
        if not self._contig:
            self._rebase()
        return self._base

    # -- ndarray duck surface ------------------------------------------------

    @property
    def shape(self):
        return (self._n,) + self._row_shape

    @property
    def ndim(self) -> int:
        return 1 + len(self._row_shape)

    @property
    def size(self) -> int:
        n = self._n
        for d in self._row_shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(np.asarray(self))

    def __repr__(self):
        return (f"CowColumn(n={self._n}, dtype={self.dtype}, "
                f"chunks={len(self._chunks)}, contig={self._contig}, "
                f"owned={self._owned}, hashed={self._hashed})")

    def __array__(self, dtype=None, copy=None):
        a = self._array()
        if dtype is not None and np.dtype(dtype) != a.dtype:
            return a.astype(dtype)
        if copy:
            return a.copy()
        v = a.view()
        v.flags.writeable = False
        return v

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if kwargs.get("out") is not None:
            return NotImplemented
        conv = [x._array() if isinstance(x, CowColumn) else x
                for x in inputs]
        return getattr(ufunc, method)(*conv, **kwargs)

    def astype(self, dtype, *args, **kwargs):
        return self._array().astype(dtype, *args, **kwargs)

    def copy(self) -> np.ndarray:
        """A plain private ndarray snapshot (fork() is the CoW copy)."""
        return self._array().copy()

    def tobytes(self) -> bytes:
        return self._array().tobytes()

    def sum(self, *args, **kwargs):
        return self._array().sum(*args, **kwargs)

    def any(self, *args, **kwargs):
        return self._array().any(*args, **kwargs)

    def all(self, *args, **kwargs):
        return self._array().all(*args, **kwargs)

    def min(self, *args, **kwargs):
        return self._array().min(*args, **kwargs)

    def max(self, *args, **kwargs):
        return self._array().max(*args, **kwargs)

    # -- reads ---------------------------------------------------------------

    def _gather(self, rows) -> np.ndarray:
        rows = np.asarray(rows)
        if self._contig:
            return self._base[rows]
        if rows.ndim != 1:
            return self._array()[rows]
        if rows.size == 0:
            return np.empty((0,) + self._row_shape, self.dtype)
        if rows.min() < 0:
            return self._array()[rows]
        cs = rows // CHUNK_ROWS
        uniq = np.unique(cs)
        if len(uniq) > 32:
            # scattered over most of the column: densify once
            return self._array()[rows]
        out = np.empty((len(rows),) + self._row_shape, self.dtype)
        for c in uniq:
            m = cs == c
            out[m] = self._chunks[c][rows[m] - c * CHUNK_ROWS]
        return out

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            i = int(key)
            if i < 0:
                i += self._n
            c, o = divmod(i, CHUNK_ROWS)
            row = self._chunks[c][o]
            if isinstance(row, np.ndarray):
                row = row.view()
                row.flags.writeable = False
            return row
        if isinstance(key, list):
            key = np.asarray(key)
        if isinstance(key, np.ndarray) and key.dtype != np.bool_ \
                and np.issubdtype(key.dtype, np.integer):
            return self._gather(key)
        if isinstance(key, tuple) and len(key) == 2 \
                and isinstance(key[1], (int, np.integer)) \
                and isinstance(key[0], (list, np.ndarray)):
            rows = np.asarray(key[0])
            if rows.dtype != np.bool_ and np.issubdtype(rows.dtype,
                                                        np.integer):
                return self._gather(rows)[:, key[1]].copy()
        out = self._array()[key]
        if isinstance(out, np.ndarray) and out.base is not None:
            out = out.copy()
        return out

    # -- writes (the one dirty-bookkeeping layer) ----------------------------

    def _touch_row(self, i: int) -> None:
        self._root_cache = None
        if self._hashed and self._dirty_leaves is not None:
            self._dirty_leaves.add(i // self._per_leaf)

    def _touch_rows(self, rows: np.ndarray) -> None:
        self._root_cache = None
        if self._hashed and self._dirty_leaves is not None:
            leaves = np.unique(rows // self._per_leaf)
            self._dirty_leaves.update(leaves.tolist())
            if 2 * len(self._dirty_leaves) > self._leaf_count():
                self._dirty_leaves = None     # full rebuild is cheaper

    def _touch_all(self) -> None:
        self._root_cache = None
        self._dirty_leaves = None

    def mark_dirty(self, i: int | None = None) -> None:
        """Compatibility hook for callers that already wrote through the
        column API (idempotent) — or who replaced everything (i=None)."""
        if i is None:
            self._touch_all()
        else:
            self._touch_row(int(i))

    def mark_dirty_many(self, rows) -> None:
        self._touch_rows(np.asarray(rows, np.int64))

    def _scatter(self, rows: np.ndarray, value) -> None:
        if rows.size == 0:
            return
        rows = rows.astype(np.int64, copy=False)
        if self._owned and self._contig:
            self._base[rows] = value
        else:
            value = np.asarray(value)
            per_row = value.ndim >= 1 and value.shape[0] == rows.shape[0]
            cs = rows // CHUNK_ROWS
            for c in np.unique(cs):
                m = cs == c
                ch = self._writable_chunk(int(c))
                ch[rows[m] - int(c) * CHUNK_ROWS] = \
                    value[m] if per_row else value
        self._touch_rows(rows)

    def __setitem__(self, key, value) -> None:
        if isinstance(key, (int, np.integer)):
            i = int(key)
            if i < 0:
                i += self._n
            c, o = divmod(i, CHUNK_ROWS)
            self._writable_chunk(c)[o] = value
            self._touch_row(i)
            return
        if isinstance(key, list):
            key = np.asarray(key)
        if isinstance(key, np.ndarray) and key.dtype != np.bool_ \
                and np.issubdtype(key.dtype, np.integer):
            self._scatter(key, value)
            return
        self._own_all()
        self._base[key] = value
        self._touch_all()

    # -- incremental merkleization (hashed mode) -----------------------------

    def _leaf_count(self) -> int:
        return (self._n + self._per_leaf - 1) // self._per_leaf

    def _leaf_bytes(self, leaves=None) -> np.ndarray:
        """u8[L, 32] packed leaf bytes for the whole column or a leaf
        subset — chunk-direct reads (a leaf never spans CoW chunks)."""
        pl = self._per_leaf
        le = self.dtype.newbyteorder("<")
        if leaves is None:
            padded = np.zeros(self._leaf_count() * pl, dtype=self.dtype)
            padded[:self._n] = self._array()
        else:
            padded = np.zeros((len(leaves), pl), dtype=self.dtype)
            for j, lf in enumerate(np.asarray(leaves, np.int64).tolist()):
                s = lf * pl
                e = min(self._n, s + pl)
                c, o = divmod(s, CHUNK_ROWS)
                padded[j, :e - s] = self._chunks[c][o:o + (e - s)]
        return np.frombuffer(padded.astype(le).tobytes(),
                             np.uint8).reshape(-1, 32)

    def _leaf_words(self, leaves=None) -> np.ndarray:
        from ..ops import sha256 as k
        return k.chunks_to_words(self._leaf_bytes(leaves).tobytes())

    def _device_root_words(self, limit_chunks: int):
        from ..ops.merkle_tree import DeviceTree
        L = self._leaf_count()
        tree = self._device_tree
        if tree is None or self._dirty_leaves is None or tree.n != L:
            tree = DeviceTree(L, limit_chunks)
            tree.build(self._leaf_words())
            self._device_tree = tree
        elif self._dirty_leaves:
            idx = np.fromiter(self._dirty_leaves, dtype=np.int64)
            idx.sort()
            tree.update(idx, self._leaf_words(idx))
        self._dirty_leaves = set()
        return tree.root_words

    def hash_tree_root(self, registry_limit: int) -> bytes:
        if not self._hashed:
            raise TypeError("non-hashed CowColumn has no incremental root")
        if self._root_cache is not None:
            return self._root_cache
        from ..ops import sha256 as k
        n = self._n
        limit_chunks = (registry_limit * self.dtype.itemsize + 31) // 32
        if n == 0:
            depth = (limit_chunks - 1).bit_length()
            root = _mix_in_length(ZERO_HASHES[depth], 0)
        else:
            root = _mix_in_length(
                k.root_bytes(self._device_root_words(limit_chunks)), n)
        self._root_cache = root
        return root
