"""Greedy weighted maximum-coverage (max_cover.rs:53 equivalent).

Each item covers a set of keys with per-key weights; repeatedly take the item
with the highest residual weight, then discount every other item's overlap.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class MaxCoverItem:
    item: Any
    covering: dict[Any, int]  # key -> weight


def maximum_cover(items: list[MaxCoverItem], limit: int) -> list[MaxCoverItem]:
    remaining = [MaxCoverItem(i.item, dict(i.covering)) for i in items]
    out: list[MaxCoverItem] = []
    while remaining and len(out) < limit:
        best = max(remaining, key=lambda it: sum(it.covering.values()))
        if sum(best.covering.values()) == 0:
            break
        out.append(best)
        covered = set(best.covering)
        remaining.remove(best)
        for it in remaining:
            for k in covered:
                it.covering.pop(k, None)
    return out
