"""On-disk schema migrations.

Equivalent of the reference's beacon_node/beacon_chain/src/
schema_change.rs + store/src/metadata.rs CURRENT_SCHEMA_VERSION: on
open, the store upgrades older layouts in place.

v1 -> v2: per-slot freezer block-root entries (`fbr:` + be64 slot) are
re-packed into the chunked root vector (`cbr:`, chunked_vector.py) and
the old keys dropped.
"""
from __future__ import annotations

import struct


def migrate_schema(db) -> None:
    from .hot_cold import FREEZER_BLOCK_ROOT, METADATA, SCHEMA_VERSION
    current = db.schema_version()
    if current >= SCHEMA_VERSION:
        return
    if current <= 1:
        _migrate_v1_to_v2(db)
    db.hot.put(METADATA + b"schema", struct.pack("<I", SCHEMA_VERSION))
    db.hot.sync()
    db.cold.sync()


def _migrate_v1_to_v2(db) -> None:
    from .hot_cold import FREEZER_BLOCK_ROOT
    moved = 0
    for key, root in list(db.cold.iter_prefix(FREEZER_BLOCK_ROOT)):
        (slot,) = struct.unpack(">Q", key[len(FREEZER_BLOCK_ROOT):])
        db.block_roots.put(slot, root)
        db.cold.delete(key)
        moved += 1
    if moved:
        import logging
        logging.getLogger("lighthouse_tpu_torch.store").info(
            "schema v1->v2: repacked %d freezer block roots into chunks",
            moved)
