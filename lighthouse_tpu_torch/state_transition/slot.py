"""Per-slot processing + state advance.

Equivalent of the reference's consensus/state_processing/src/per_slot_processing.rs
(:28, in-place fork upgrades :50-60) and state_advance.rs (complete_state_advance).
"""
from __future__ import annotations

import numpy as np

from ..containers.state import BeaconState, _np_bytes32_root
from ..specs.chain_spec import ForkName
from .epoch import per_epoch_processing
from .helpers import StateError


def roots_vector_htr(arr: np.ndarray) -> bytes:
    return _np_bytes32_root(arr, arr.shape[0])


def process_slot(state: BeaconState,
                 state_root: bytes | None = None) -> None:
    """Cache state/block roots for the slot being completed."""
    p = state.T.preset
    from ..ssz import htr
    if state_root is None:
        state_root = state.hash_tree_root()
    state.state_roots[state.slot % p.slots_per_historical_root] = \
        np.frombuffer(state_root, np.uint8)
    if state.latest_block_header.state_root == b"\x00" * 32:
        state.latest_block_header.state_root = state_root
    block_root = htr(state.latest_block_header)
    state.block_roots[state.slot % p.slots_per_historical_root] = \
        np.frombuffer(block_root, np.uint8)


def per_slot_processing(state: BeaconState,
                        state_root: bytes | None = None) -> None:
    """Advance exactly one slot (epoch processing + fork upgrade at
    boundaries)."""
    process_slot(state, state_root)
    if (state.slot + 1) % state.slots_per_epoch == 0:
        from ..obs import tracing
        with tracing.span("stf_epoch", epoch=int(state.current_epoch()),
                          n_validators=len(state.validators)):
            per_epoch_processing(state)
    state.slot += 1
    _maybe_upgrade_fork(state)


def _maybe_upgrade_fork(state: BeaconState) -> None:
    from . import upgrades
    spec = state.spec
    epoch = state.current_epoch()
    if state.slot % state.slots_per_epoch != 0:
        return
    fork_epochs = [
        (spec.altair_fork_epoch, ForkName.ALTAIR, upgrades.upgrade_to_altair),
        (spec.bellatrix_fork_epoch, ForkName.BELLATRIX,
         upgrades.upgrade_to_bellatrix),
        (spec.capella_fork_epoch, ForkName.CAPELLA,
         upgrades.upgrade_to_capella),
        (spec.deneb_fork_epoch, ForkName.DENEB, upgrades.upgrade_to_deneb),
        (spec.electra_fork_epoch, ForkName.ELECTRA,
         upgrades.upgrade_to_electra),
    ]
    for fork_epoch, fork, fn in fork_epochs:
        if epoch == fork_epoch and state.fork_name == fork.previous:
            fn(state)


def process_slots(state: BeaconState, slot: int) -> None:
    if slot < state.slot:
        raise StateError("cannot rewind state")
    while state.slot < slot:
        per_slot_processing(state)


def state_root_at_slot(state: BeaconState, slot: int) -> bytes:
    """Advance a copy to `slot` and return its root (produce-block helper)."""
    st = state.copy()
    process_slots(st, slot)
    return st.hash_tree_root()
