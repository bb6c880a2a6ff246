"""BeaconState.hash_tree_root: the port (plain kernel versions on the CPU)
against the JAX package on the same seeded state, carried across as SSZ
bytes, before and after writes (byte-equal roots, tolerance zero); and the
1M-validator roots that chip_smoke.py holds the card to, pinned to the JAX
package's."""
import numpy as np
import pytest

import chip_smoke
from lighthouse_tpu.containers import state as jst
from lighthouse_tpu.specs import chain_spec as jspec
from lighthouse_tpu_torch.containers import state as tst
from lighthouse_tpu_torch.convert import state_from_ssz
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.seeded_state import (
    apply_bench_rep, bench_reps, fill_state, seeded_columns,
)
from lighthouse_tpu_torch.specs import chain_spec as tspec

N_SMALL = 300


@pytest.fixture(autouse=True)
def cpu_device():
    prev = set_device("cpu")
    yield
    set_device(prev)


@pytest.fixture
def jax_device_path():
    """Route the JAX package's big columns through its XLA DeviceTree (the
    programs the port's kernels replace), as tests/test_merkle_tree.py
    does, instead of its C++ host hasher."""
    old = jst._USE_HOST_HASH
    jst._USE_HOST_HASH = False
    yield
    jst._USE_HOST_HASH = old


def _jax_state(preset: str, fork_name: str, n: int, seed: int):
    spec = getattr(jspec, f"{preset}_spec")()
    state = jst.new_state(spec, jspec.ForkName[fork_name])
    fill_state(state, jst.ValidatorRegistry(), seeded_columns(n, seed))
    rng = np.random.default_rng(seed + 1)
    state.slot = 12345
    state.block_roots = rng.integers(0, 256, state.block_roots.shape,
                                     dtype=np.uint8)
    state.randao_mixes = rng.integers(0, 256, state.randao_mixes.shape,
                                      dtype=np.uint8)
    state.slashings = rng.integers(0, 2**40, len(state.slashings),
                                   dtype=np.uint64)
    state.historical_roots = [bytes(rng.integers(0, 256, 32,
                                                 dtype=np.uint8))
                              for _ in range(3)]
    return state


def _write(state, rng) -> None:
    """A few writes through each column API the state root reads."""
    n = len(state.validators)
    for i in rng.integers(0, n, size=4):
        state.validators.set_field(int(i), "exit_epoch", 77)
    state.validators.set_field(int(n - 1), "slashed", True)
    rows = rng.integers(0, n, size=5)
    state.balances[rows] = rng.integers(0, 2**40, size=5, dtype=np.uint64)
    if state.current_epoch_participation is not None:
        prow = rng.integers(0, n, size=6)
        state.current_epoch_participation[prow] = np.uint8(7)
        state.inactivity_scores[rng.integers(0, n, size=2)] = np.uint64(3)
    state.randao_mixes[5] = np.full(32, 9, np.uint8)


@pytest.mark.parametrize("preset", ["minimal", "mainnet"])
@pytest.mark.parametrize("fork_name", ["PHASE0", "DENEB"])
def test_state_root_matches_jax_before_and_after_writes(preset, fork_name,
                                                       jax_device_path):
    ref = _jax_state(preset, fork_name, N_SMALL, seed=3)
    spec = getattr(tspec, f"{preset}_spec")()
    port = state_from_ssz(ref.serialize(), spec, tspec.ForkName[fork_name])
    assert port.hash_tree_root() == ref.hash_tree_root()
    assert ref.validators._device_tree is not None
    for state in (ref, port):
        _write(state, np.random.default_rng(5))
    assert port.hash_tree_root() == ref.hash_tree_root()
    assert port.validators._device_tree is not None
    assert port.serialize() == ref.serialize()


def test_port_state_copy_keeps_parent_root():
    spec = tspec.minimal_spec()
    state = tst.new_state(spec, tspec.ForkName.PHASE0)
    fill_state(state, tst.ValidatorRegistry(), seeded_columns(40, 9))
    root = state.hash_tree_root()
    child = state.copy()
    child.validators.set_field(0, "effective_balance", 1)
    child.balances[3] = np.uint64(5)
    assert child.hash_tree_root() != root
    assert state.hash_tree_root() == root
    state.validators.set_field(2, "exit_epoch", 9)
    assert state.hash_tree_root() != root


def test_seeded_1m_state_roots_pin_chip_smoke():
    """The JAX package's root of the 1M-validator Deneb mainnet state that
    chip_smoke.py builds on the card, before and after the bench reps."""
    n = chip_smoke.N_VALIDATORS
    state = jst.new_state(jspec.mainnet_spec(), jspec.ForkName.DENEB)
    fill_state(state, jst.ValidatorRegistry(),
               seeded_columns(n, chip_smoke.STATE_SEED))
    assert state.hash_tree_root().hex() == chip_smoke.EXPECTED_STATE_ROOT_1M
    for rows, brows in bench_reps(n, chip_smoke.REPS):
        apply_bench_rep(state, rows, brows)
        root = state.hash_tree_root()
    assert root.hex() == chip_smoke.EXPECTED_STATE_ROOT_1M_AFTER_REPS
