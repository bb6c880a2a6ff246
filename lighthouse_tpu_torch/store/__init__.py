"""Storage layer (L5): hot/cold split database.

Equivalent of the reference's beacon_node/store: `KeyValueStore` trait
(src/lib.rs:53), `HotColdDB` (src/hot_cold_store.rs:50), `MemoryStore`,
LevelDB backend (here: the C++ kvstore of native/kvstore.cpp, built by g++
into the package's _build/ and bound via ctypes), state
reconstruction by block replay (src/reconstruct.rs).
"""
from .kv import KeyValueStore, MemoryStore, NativeKvStore, StoreError
from .hot_cold import HotColdDB, Split, StoreConfig, StoreOp
from .fsck import FsckReport, run_fsck
