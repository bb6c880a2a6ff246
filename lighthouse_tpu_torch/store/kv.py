"""Key-value backends.

`KeyValueStore` mirrors the column-oriented trait at
the reference's beacon_node/store/src/lib.rs:53; `NativeKvStore` binds the
C++ log-structured engine (native/kvstore.cpp — the LevelDB-equivalent),
built by g++ into the package's _build/ at first use (never into native/;
a failed build or load raises, and nothing falls back to `MemoryStore`);
`MemoryStore` is the test backend (src/memory_store.rs).
"""
from __future__ import annotations

import ctypes
import os
import threading

from ..utils.gxx import NATIVE, build


class StoreError(Exception):
    pass


class KeyValueStore:
    """Byte-oriented KV with ordered prefix iteration."""

    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def exists(self, key: bytes) -> bool:
        return self.get(key) is not None

    def iter_prefix(self, prefix: bytes):
        """Yield (key, value) in key order for keys starting with prefix."""
        raise NotImplementedError

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass

    def do_atomically(self, ops: list[tuple[str, bytes, bytes | None]],
                      fsync: bool = False) -> None:
        """ops: ("put", key, value) | ("delete", key, None).

        The batch is all-or-nothing: a failing op rolls the already-applied
        prefix back before re-raising, so a half-applied batch is never
        observable.  Backends with a native batch primitive (NativeKvStore)
        override this with a genuinely atomic commit; `fsync` asks for a
        durability barrier where the backend supports one.
        """
        undo: list[tuple[str, bytes, bytes | None]] = []
        try:
            for op, key, value in ops:
                if op not in ("put", "delete"):
                    raise StoreError(f"unknown batch op {op!r}")
                undo.append((op, key, self.get(key)))
                if op == "put":
                    self.put(key, value)
                else:
                    self.delete(key)
        except BaseException:
            for _op, key, old in reversed(undo):
                try:
                    if old is None:
                        self.delete(key)
                    else:
                        self.put(key, old)
                except Exception:       # rollback is best-effort
                    pass
            raise
        self.sync()


class MemoryStore(KeyValueStore):
    def __init__(self):
        self._data: dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._data.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(value)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._data.pop(key, None)

    def do_atomically(self, ops: list[tuple[str, bytes, bytes | None]],
                      fsync: bool = False) -> None:
        """Genuinely atomic: the lock is held across the whole batch (no
        reader interleaves with a half-applied batch) and a failing op
        restores every prior write before re-raising."""
        with self._lock:
            undo: list[tuple[bytes, bytes | None]] = []
            try:
                for op, key, value in ops:
                    undo.append((key, self._data.get(key)))
                    if op == "put":
                        self._data[key] = bytes(value)
                    elif op == "delete":
                        self._data.pop(key, None)
                    else:
                        raise StoreError(f"unknown batch op {op!r}")
            except BaseException:
                for key, old in reversed(undo):
                    if old is None:
                        self._data.pop(key, None)
                    else:
                        self._data[key] = old
                raise

    def iter_prefix(self, prefix: bytes):
        with self._lock:
            keys = sorted(k for k in self._data if k.startswith(prefix))
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v


_LIB_CACHE: dict[str, ctypes.CDLL] = {}


def _load_native() -> ctypes.CDLL:
    so = build(NATIVE / "kvstore.cpp", "kvstore")
    key = str(so)
    if key in _LIB_CACHE:
        return _LIB_CACHE[key]
    lib = ctypes.CDLL(key)
    lib.kv_open.restype = ctypes.c_void_p
    lib.kv_open.argtypes = [ctypes.c_char_p]
    lib.kv_close.argtypes = [ctypes.c_void_p]
    lib.kv_put.restype = ctypes.c_int
    lib.kv_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                           ctypes.c_char_p, ctypes.c_size_t]
    lib.kv_delete.restype = ctypes.c_int
    lib.kv_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_size_t]
    lib.kv_write_batch.restype = ctypes.c_int
    lib.kv_write_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_size_t, ctypes.c_int]
    lib.kv_get_len.restype = ctypes.c_int64
    lib.kv_get_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_size_t]
    lib.kv_get_copy.restype = ctypes.c_int64
    lib.kv_get_copy.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t, ctypes.c_char_p,
                                ctypes.c_size_t]
    lib.kv_count.restype = ctypes.c_uint64
    lib.kv_count.argtypes = [ctypes.c_void_p]
    lib.kv_sync.restype = ctypes.c_int
    lib.kv_sync.argtypes = [ctypes.c_void_p]
    lib.kv_compact.restype = ctypes.c_int
    lib.kv_compact.argtypes = [ctypes.c_void_p]
    lib.kv_iter_prefix.restype = ctypes.c_void_p
    lib.kv_iter_prefix.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_size_t]
    lib.kv_iter_next.restype = ctypes.c_int
    lib.kv_iter_next.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.POINTER(ctypes.c_size_t),
                                 ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.POINTER(ctypes.c_size_t)]
    lib.kv_iter_destroy.argtypes = [ctypes.c_void_p]
    _LIB_CACHE[key] = lib
    return lib


class NativeKvStore(KeyValueStore):
    """ctypes binding to native/kvstore.cpp (built into _build/)."""

    def __init__(self, path: str | os.PathLike):
        self._lib = _load_native()
        os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
        self._h = self._lib.kv_open(os.fspath(path).encode())
        if not self._h:
            raise StoreError(f"cannot open kv store at {path}")

    def get(self, key: bytes) -> bytes | None:
        n = self._lib.kv_get_len(self._h, key, len(key))
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.kv_get_copy(self._h, key, len(key), buf, int(n))
        if got < 0:
            raise StoreError("kv read error")
        return buf.raw[:got]

    def put(self, key: bytes, value: bytes) -> None:
        if self._lib.kv_put(self._h, key, len(key), value, len(value)) != 0:
            raise StoreError("kv write error")

    def delete(self, key: bytes) -> None:
        if self._lib.kv_delete(self._h, key, len(key)) != 0:
            raise StoreError("kv delete error")

    def iter_prefix(self, prefix: bytes):
        it = self._lib.kv_iter_prefix(self._h, prefix, len(prefix))
        try:
            k = ctypes.c_char_p()
            kl = ctypes.c_size_t()
            v = ctypes.c_char_p()
            vl = ctypes.c_size_t()
            while self._lib.kv_iter_next(it, ctypes.byref(k),
                                         ctypes.byref(kl), ctypes.byref(v),
                                         ctypes.byref(vl)):
                key = ctypes.string_at(k, kl.value)
                val = ctypes.string_at(v, vl.value)
                yield key, val
        finally:
            self._lib.kv_iter_destroy(it)

    def do_atomically(self, ops: list[tuple[str, bytes, bytes | None]],
                      fsync: bool = False) -> None:
        """One CRC'd batch record in the native log: replay applies it
        all-or-nothing, so partial-batch bytes are never visible after a
        crash.  `fsync=True` adds an fsync barrier at the commit point."""
        import struct
        parts = [struct.pack("<I", len(ops))]
        for op, key, value in ops:
            if op == "put":
                parts.append(struct.pack("<II", len(key), len(value)))
                parts.append(bytes(key))
                parts.append(bytes(value))
            elif op == "delete":
                parts.append(struct.pack("<II", len(key), 0xFFFFFFFF))
                parts.append(bytes(key))
            else:
                raise StoreError(f"unknown batch op {op!r}")
        payload = b"".join(parts)
        rc = self._lib.kv_write_batch(self._h, payload, len(payload),
                                      1 if fsync else 0)
        if rc != 0:
            raise StoreError(f"kv batch write error (rc={rc})")

    def sync(self) -> None:
        self._lib.kv_sync(self._h)

    def compact(self) -> None:
        if self._lib.kv_compact(self._h) != 0:
            raise StoreError("kv compact failed")

    def __len__(self) -> int:
        return int(self._lib.kv_count(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None
