"""Download-time batch validation.

Structural checks a by_range response must pass BEFORE its batch is ever
marked downloaded: they cost O(batch) in pure Python, versus the
O(state-transition) price of letting junk reach `process_segment`.  A
junk server, a wrong-range server, or a count-overflowing server is
caught here and charged `bad_segment` immediately, and the
PARENT_UNKNOWN previous-batch rollback in range_sync keeps precise blame
because a batch that *passed* these checks can only break the chain at
its edges.

Checks, in order (first failure wins):

``count_cap``      at most `count` blocks (the request's own cap);
``out_of_range``   every slot inside the requested [start, start+count);
``not_ascending``  slots strictly ascending (no duplicates, no reorder);
``parent_link``    consecutive blocks hash-link: block[i+1].parent_root
                   == root(block[i]) — skipped slots between them are
                   fine, a fork inside one response is not;
``continuity``     first block's parent_root matches the previous
                   batch's tail root, when the caller knows it.

The module is dependency-free and pure: callers supply `block_root` (the
ctx hook) so the fake-block test harness works unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ValidationResult:
    ok: bool
    reason: str = ""
    detail: str = ""

    def __bool__(self) -> bool:  # pragma: no cover - convenience
        return self.ok


_OK = ValidationResult(True)


def validate_range_batch(blocks: list, start: int, count: int, *,
                         block_root, prev_tail_root: bytes | None = None,
                         ) -> ValidationResult:
    """Structurally validate a by_range response against its request.

    `blocks` is the decoded response (possibly empty — empty is always
    valid: runs of skipped slots are legitimate).  `prev_tail_root` is
    the root of the last block of the batch immediately below, when the
    caller has it; None skips the continuity check.
    """
    if len(blocks) > count:
        return ValidationResult(
            False, "count_cap",
            f"{len(blocks)} blocks for a {count}-slot request")
    end = start + count
    prev_slot = None
    prev_root = None
    for i, sb in enumerate(blocks):
        slot = int(sb.message.slot)
        if not start <= slot < end:
            return ValidationResult(
                False, "out_of_range",
                f"block {i} at slot {slot} outside [{start}, {end})")
        if prev_slot is not None and slot <= prev_slot:
            return ValidationResult(
                False, "not_ascending",
                f"slot {slot} after slot {prev_slot}")
        if prev_root is not None and sb.message.parent_root != prev_root:
            return ValidationResult(
                False, "parent_link",
                f"block at slot {slot} does not link to the response's "
                f"previous block")
        prev_slot = slot
        prev_root = block_root(sb)
    if (blocks and prev_tail_root is not None
            and blocks[0].message.parent_root != prev_tail_root):
        return ValidationResult(
            False, "continuity",
            f"first block (slot {int(blocks[0].message.slot)}) does not "
            f"link to the previous batch's tail")
    return _OK
