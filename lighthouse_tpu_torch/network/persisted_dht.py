"""Persist/reload the discv5 routing table across restarts.

Equivalent of beacon_node/network/src/persisted_dht.rs: on shutdown the
known ENRs are written to the hot database under one item key; on startup
they are loaded back into the K-buckets so the node re-enters the network
WITHOUT bootnodes.  Records are stored as their signed RLP encodings, so
a corrupted or tampered entry fails signature verification at decode
time and is dropped rather than poisoning the table.
"""
from __future__ import annotations

from .enr import Enr, EnrError

DHT_DB_KEY = b"dht_enrs"
MAX_PERSISTED = 256


def persist_dht(store, enrs: list) -> int:
    """Write the ENR list (newest-first truncated) as one item."""
    blobs = []
    for e in enrs[:MAX_PERSISTED]:
        rec = getattr(e, "record", e)     # discv5 table holds enr.Enr
        blobs.append(rec.to_rlp())
    out = b"".join(len(b).to_bytes(4, "little") + b for b in blobs)
    store.put_item(DHT_DB_KEY, out)
    return len(blobs)


def load_dht(store) -> list[Enr]:
    """Read persisted ENRs; invalid/tampered records are skipped."""
    raw = store.get_item(DHT_DB_KEY)
    if not raw:
        return []
    out: list[Enr] = []
    view = memoryview(raw)
    off = 0
    while off + 4 <= len(view):
        n = int.from_bytes(view[off:off + 4], "little")
        off += 4
        if n <= 0 or off + n > len(view):
            break
        try:
            out.append(Enr.from_rlp(bytes(view[off:off + n])))
        except (EnrError, ValueError):
            pass                          # signature/shape check failed
        off += n
    return out


def clear_dht(store) -> None:
    store.put_item(DHT_DB_KEY, b"")
