"""Replay blocks onto a state (DB state reconstruction).

Equivalent of the reference's consensus/state_processing/src/block_replayer.rs:
used by the store to rebuild intermediate states from a restore point plus a
span of blocks, with signature verification off and optional per-slot/root
hooks.
"""
from __future__ import annotations

from ..containers.state import BeaconState
from .block import VerifySignatures, per_block_processing
from .slot import per_slot_processing


class BlockReplayer:
    def __init__(self, state: BeaconState,
                 state_root_iter=None,
                 pre_block_hook=None,
                 pre_slot_hook=None):
        self.state = state
        self._roots = dict(state_root_iter or {})  # slot -> state_root
        self.pre_block_hook = pre_block_hook
        self.pre_slot_hook = pre_slot_hook

    def apply_blocks(self, blocks: list, target_slot: int | None = None
                     ) -> BeaconState:
        for signed_block in blocks:
            block = signed_block.message
            while self.state.slot < block.slot:
                if self.pre_slot_hook:
                    self.pre_slot_hook(self.state)
                per_slot_processing(self.state,
                                    self._roots.get(self.state.slot))
            if self.pre_block_hook:
                self.pre_block_hook(self.state, signed_block)
            per_block_processing(self.state, signed_block,
                                 VerifySignatures.FALSE)
        if target_slot is not None:
            while self.state.slot < target_slot:
                if self.pre_slot_hook:
                    self.pre_slot_hook(self.state)
                per_slot_processing(self.state,
                                    self._roots.get(self.state.slot))
        return self.state
