"""Store consistency checker (fsck).

The durability counterpart of graftwatch's runtime SLOs: after a crash,
a restore, or a suspicious restart, ``run_fsck`` walks the hot/cold
split database and reports every structural invariant violation it can
find without replaying states:

- split/anchor agreement: the anchor restore point exists, the split
  meta parses, and the split state is still materialized in hot;
- block connectivity: every hot block's parent is either another hot
  block, recorded in the freezer root vector, or an explicit anchor
  (genesis / checkpoint-sync backfill boundary);
- state reachability: every hot state summary points at an epoch
  boundary whose full state exists (the replay path would otherwise
  raise mid-read), and no full state is orphaned without its summary;
- persisted-chain items: the fork-choice snapshot parses, its nodes'
  blocks exist, and the head item's sequence number matches the
  snapshot's (a mismatch is the signature of a crash between the two
  commit points — `resume_chain` repairs it, after which fsck is clean).

Errors are real corruption or torn commits; warnings are conditions a
node tolerates (e.g. blobs for an unknown block).  Runnable at open
(``LHTPU_FSCK_ON_OPEN=1``) and offline via :func:`run_fsck`.
"""
from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field

from .hot_cold import (
    BLOBS, BLOCK, FREEZER_STATE, HOT_STATE_FULL, HOT_STATE_SUMMARY,
    HotColdDB,
)

_FC_KEY = b"fork_choice"
_HEAD_KEY = b"head"
_OP_POOL_KEY = b"op_pool"


@dataclass
class FsckReport:
    errors: list[str] = field(default_factory=list)
    warnings: list[str] = field(default_factory=list)
    checked: dict[str, int] = field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.errors

    def to_dict(self) -> dict:
        return {"clean": self.clean, "errors": list(self.errors),
                "warnings": list(self.warnings),
                "checked": dict(self.checked)}

    def render(self) -> str:
        lines = [f"store fsck: {'clean' if self.clean else 'CORRUPT'} "
                 + " ".join(f"{k}={v}" for k, v in sorted(
                     self.checked.items()))]
        lines += [f"  error: {e}" for e in self.errors]
        lines += [f"  warn:  {w}" for w in self.warnings]
        return "\n".join(lines)


def _count_metric(n: int) -> None:
    import sys
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    if md is not None and n:
        md.count("store_fsck_errors_total", n)


def run_fsck(db: HotColdDB) -> FsckReport:
    r = FsckReport()
    _check_anchor_and_split(db, r)
    blocks = _check_blocks(db, r)
    _check_states(db, r)
    _check_blobs(db, r, blocks)
    _check_persisted_items(db, r, blocks)
    _count_metric(len(r.errors))
    return r


def _check_anchor_and_split(db: HotColdDB, r: FsckReport) -> None:
    anchor_raw = db._get_meta(b"anchor_slot")
    if anchor_raw is None:
        r.errors.append("no anchor_slot meta (store was never anchored)")
        return
    if len(anchor_raw) != 8:
        r.errors.append("anchor_slot meta has wrong length")
        return
    (anchor_slot,) = struct.unpack("<Q", anchor_raw)
    if db.cold.get(FREEZER_STATE + struct.pack(">Q", anchor_slot)) is None:
        r.errors.append(
            f"anchor restore point missing in freezer (slot {anchor_slot})")
    split_raw = db._get_meta(b"split")
    if split_raw is not None:
        if len(split_raw) < 40:
            r.errors.append("split meta has wrong length")
        else:
            (split_slot,) = struct.unpack("<Q", split_raw[:8])
            split_root = split_raw[8:40]
            if split_slot > 0 and \
                    db.hot.get(HOT_STATE_FULL + split_root) is None:
                r.errors.append(
                    f"split state {split_root.hex()[:12]} (slot "
                    f"{split_slot}) not materialized in hot DB")
    r.checked["anchors"] = 1


def _check_blocks(db: HotColdDB, r: FsckReport) -> dict[bytes, tuple]:
    """Returns root -> (slot, parent_root) for every hot block."""
    blocks: dict[bytes, tuple] = {}
    genesis_root = db.genesis_block_root()
    backfill = db.backfill_anchor()
    for key, _ in db.hot.iter_prefix(BLOCK):
        root = key[len(BLOCK):]
        try:
            blk = db.get_block(root)
        except Exception as exc:
            r.errors.append(f"block {root.hex()[:12]} undecodable: {exc!r}")
            continue
        blocks[root] = (blk.message.slot, blk.message.parent_root)
    for root, (slot, parent) in blocks.items():
        if slot == 0 or root == genesis_root:
            continue
        if parent in blocks:
            continue
        if backfill is not None and slot <= backfill[0]:
            continue  # history below the checkpoint-sync anchor
        # canonical history: the parent may live only as a freezer root
        if slot - 1 <= db.split.slot and \
                db.freezer_block_root_at_slot(slot - 1) == parent:
            continue
        r.errors.append(
            f"block {root.hex()[:12]} (slot {slot}) missing parent "
            f"{parent.hex()[:12]}")
    r.checked["blocks"] = len(blocks)
    return blocks


def _check_states(db: HotColdDB, r: FsckReport) -> None:
    summaries: dict[bytes, tuple] = {}
    fulls: set[bytes] = set()
    for key, _ in db.hot.iter_prefix(HOT_STATE_FULL):
        fulls.add(key[len(HOT_STATE_FULL):])
    for key, raw in db.hot.iter_prefix(HOT_STATE_SUMMARY):
        root = key[len(HOT_STATE_SUMMARY):]
        if len(raw) != 72:
            r.errors.append(f"state summary {root.hex()[:12]} malformed")
            continue
        slot = struct.unpack("<Q", raw[:8])[0]
        summaries[root] = (slot, raw[8:40], raw[40:72])
    for root, (slot, _latest, boundary) in summaries.items():
        if boundary not in fulls:
            r.errors.append(
                f"state {root.hex()[:12]} (slot {slot}) points at epoch "
                f"boundary {boundary.hex()[:12]} with no full state "
                f"(replay from it would fail)")
    for root in fulls:
        if root not in summaries:
            r.errors.append(
                f"orphan full state {root.hex()[:12]} has no summary")
    r.checked["state_summaries"] = len(summaries)
    r.checked["full_states"] = len(fulls)


def _check_blobs(db: HotColdDB, r: FsckReport,
                 blocks: dict[bytes, tuple]) -> None:
    n = 0
    for key, _ in db.hot.iter_prefix(BLOBS):
        n += 1
        root = key[len(BLOBS):]
        if root not in blocks:
            r.warnings.append(
                f"blobs for unknown block {root.hex()[:12]}")
    r.checked["blob_entries"] = n


def _check_persisted_items(db: HotColdDB, r: FsckReport,
                           blocks: dict[bytes, tuple]) -> None:
    raw_fc = db.get_item(_FC_KEY)
    raw_head = db.get_item(_HEAD_KEY)
    raw_pool = db.get_item(_OP_POOL_KEY)
    fc_seq = None
    if raw_fc is not None:
        try:
            doc = json.loads(raw_fc)
            fc_seq = doc.get("seq")
            for nd in doc["nodes"]:
                root = bytes.fromhex(nd["root"])
                slot = nd["slot"]
                if root not in blocks and slot > db.split.slot and slot > 0:
                    r.errors.append(
                        f"fork-choice node {root.hex()[:12]} (slot "
                        f"{slot}) has no stored block")
        except Exception as exc:
            r.errors.append(f"fork-choice snapshot unreadable: {exc!r}")
    if raw_head is None and fc_seq is not None:
        r.errors.append(
            f"torn persist: fork-choice snapshot at seq {fc_seq} but no "
            f"head item (crash between commit points; resume repairs "
            f"this)")
    if raw_head is not None:
        if len(raw_head) == 32:
            head_seq, head_root = None, raw_head          # legacy layout
        elif len(raw_head) == 40:
            head_seq = struct.unpack("<Q", raw_head[:8])[0]
            head_root = raw_head[8:]
        else:
            r.errors.append("head item has wrong length")
            head_seq = head_root = None
        if head_root is not None and head_root not in blocks:
            r.errors.append(
                f"persisted head {head_root.hex()[:12]} has no stored "
                f"block")
        if head_seq is not None and fc_seq is not None and \
                head_seq != fc_seq:
            r.errors.append(
                f"torn persist: head seq {head_seq} != fork-choice seq "
                f"{fc_seq} (crash between commit points; resume repairs "
                f"this)")
    if raw_pool is not None:
        try:
            json.loads(raw_pool)
        except Exception as exc:
            r.errors.append(f"op-pool snapshot unreadable: {exc!r}")
    r.checked["persisted_items"] = sum(
        x is not None for x in (raw_fc, raw_head, raw_pool))
