"""Slot clocks.

Equivalent of the reference's common/slot_clock: SystemTimeSlotClock for
production, ManualSlotClock for deterministic tests
(src/{system_time_slot_clock,manual_slot_clock}.rs).
"""
from __future__ import annotations

import time


class SlotClock:
    def __init__(self, genesis_time: int, seconds_per_slot: int):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot

    def now(self) -> int | None:
        """Current slot, or None before genesis."""
        raise NotImplementedError

    def seconds_into_slot(self) -> float:
        raise NotImplementedError

    def start_of(self, slot: int) -> int:
        return self.genesis_time + slot * self.seconds_per_slot

    def duration_to_next_slot(self) -> float:
        s = self.now()
        if s is None:
            return max(0.0, self.genesis_time - self._unix_now())
        return max(0.0, self.start_of(s + 1) - self._unix_now())

    def _unix_now(self) -> float:
        raise NotImplementedError


class SystemTimeSlotClock(SlotClock):
    def _unix_now(self) -> float:
        return time.time()

    def now(self) -> int | None:
        t = time.time()
        if t < self.genesis_time:
            return None
        return int(t - self.genesis_time) // self.seconds_per_slot

    def seconds_into_slot(self) -> float:
        t = time.time()
        return (t - self.genesis_time) % self.seconds_per_slot


class ManualSlotClock(SlotClock):
    """Test clock advanced explicitly (TestingSlotClock)."""

    def __init__(self, genesis_time: int, seconds_per_slot: int,
                 current_slot: int = 0):
        super().__init__(genesis_time, seconds_per_slot)
        self._slot = current_slot
        self._subslot = 0.0

    def set_slot(self, slot: int) -> None:
        self._slot = slot

    def advance_slot(self) -> None:
        self._slot += 1

    def set_seconds_into_slot(self, s: float) -> None:
        self._subslot = s

    def _unix_now(self) -> float:
        return self.start_of(self._slot) + self._subslot

    def now(self) -> int | None:
        return self._slot

    def seconds_into_slot(self) -> float:
        return self._subslot
