"""Sync layer: range sync, backfill, block lookups (network/src/sync/).

The reference-shaped state machines: per-chain peer pools and batch
lifecycles (range_sync.py), a backfill
batch machine (backfill.py), and depth-limited concurrent parent lookups
(lookups.py), all driven by synthetic-event tests in
tests/test_sync_machines.py.
"""
from .batches import Batch, BatchState
from .backfill import BackfillSync
from .lookups import BlockLookups, Lookup
from .manager import SyncManager, digest_to_fork, encode_block
from .range_sync import EPOCHS_PER_BATCH, RangeSync, SyncingChain

__all__ = [
    "Batch", "BatchState", "BackfillSync", "BlockLookups", "Lookup",
    "SyncManager", "digest_to_fork", "encode_block", "EPOCHS_PER_BATCH",
    "RangeSync", "SyncingChain",
]
