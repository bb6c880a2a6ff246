"""Unit tests for download-time batch validation.

Pure-function tests over validate_range_batch: every reject reason, the
first-failure-wins ordering, and the legitimate shapes (skipped slots,
empty batches) that must keep passing.

The same cases as the JAX package's tests/test_sync_validation.py, run on the port
(imports switched to lighthouse_tpu_torch).
"""
from __future__ import annotations

from dataclasses import dataclass

from lighthouse_tpu_torch.network.sync.validation import (
    ValidationResult, validate_range_batch,
)


@dataclass
class Msg:
    slot: int
    parent_root: bytes


@dataclass
class Blk:
    root: bytes
    message: Msg


def root_of(b):
    return b.root


def linked(slots, prefix=b"r", parent=b"genesis".ljust(32, b"\0")):
    """Hash-linked fake blocks at the given (possibly sparse) slots."""
    out = []
    for s in slots:
        root = (prefix + str(s).encode()).ljust(32, b"\0")
        out.append(Blk(root, Msg(s, parent)))
        parent = root
    return out


def test_empty_batch_is_always_valid():
    res = validate_range_batch([], 1, 16, block_root=root_of,
                               prev_tail_root=b"x" * 32)
    assert res.ok and bool(res)


def test_full_linked_batch_passes():
    blocks = linked(range(1, 17))
    assert validate_range_batch(blocks, 1, 16, block_root=root_of).ok


def test_skipped_slots_are_fine():
    blocks = linked([1, 4, 5, 11, 16])
    assert validate_range_batch(blocks, 1, 16, block_root=root_of).ok


def test_count_cap():
    blocks = linked(range(1, 18))               # 17 blocks, 16-slot request
    res = validate_range_batch(blocks, 1, 16, block_root=root_of)
    assert not res and res.reason == "count_cap"


def test_out_of_range_above_and_below():
    for slots in ([17], [0]):                   # end-exclusive / below start
        res = validate_range_batch(linked(slots), 1, 16, block_root=root_of)
        assert not res and res.reason == "out_of_range"


def test_not_ascending_catches_duplicates_and_reorders():
    dup = linked([3, 3])
    res = validate_range_batch(dup, 1, 16, block_root=root_of)
    assert res.reason == "not_ascending"
    desc = linked([5, 4])
    res = validate_range_batch(desc, 1, 16, block_root=root_of)
    assert res.reason == "not_ascending"


def test_parent_link_break_inside_response():
    blocks = linked(range(1, 9))
    blocks[4].message.parent_root = b"fork".ljust(32, b"\0")
    res = validate_range_batch(blocks, 1, 16, block_root=root_of)
    assert not res and res.reason == "parent_link"


def test_continuity_against_previous_tail():
    blocks = linked(range(17, 25), parent=b"tail".ljust(32, b"\0"))
    ok = validate_range_batch(blocks, 17, 16, block_root=root_of,
                              prev_tail_root=b"tail".ljust(32, b"\0"))
    assert ok
    bad = validate_range_batch(blocks, 17, 16, block_root=root_of,
                               prev_tail_root=b"other".ljust(32, b"\0"))
    assert not bad and bad.reason == "continuity"
    # unknown previous tail -> the check is skipped, not failed
    skip = validate_range_batch(blocks, 17, 16, block_root=root_of,
                                prev_tail_root=None)
    assert skip.ok


def test_first_failure_wins_ordering():
    # both over the cap AND out of range: count_cap is reported
    blocks = linked(range(100, 118))
    res = validate_range_batch(blocks, 1, 16, block_root=root_of)
    assert res.reason == "count_cap"
    # out of range AND not ascending: out_of_range is hit first
    res = validate_range_batch(linked([50, 40]), 1, 16, block_root=root_of)
    assert res.reason == "out_of_range"
    # in-range reorder AND broken parent link: not_ascending wins
    blocks = linked([5, 4])
    blocks[1].message.parent_root = b"x" * 32
    res = validate_range_batch(blocks, 1, 16, block_root=root_of)
    assert res.reason == "not_ascending"


def test_result_detail_is_populated_on_failure():
    res = validate_range_batch(linked([99]), 1, 16, block_root=root_of)
    assert isinstance(res, ValidationResult)
    assert "99" in res.detail
