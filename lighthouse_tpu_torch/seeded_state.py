"""Seeded columns of a BeaconState at any registry size (numpy only).

``seeded_columns(n, seed)`` draws the validator and balance columns that
the JAX package's ``bench.py`` ``build_state_columns`` draws (same
generator, same order), plus the zeroed participation and inactivity
columns of an Altair+ state, so both packages can build the identical
state. ``bench_reps`` and ``apply_bench_rep`` replay the mutations of
``bench.py`` ``bench_tree_hash`` against either package's state.
"""
from __future__ import annotations

import numpy as np

from .specs.constants import FAR_FUTURE_EPOCH

#: the state the card runs (chip_smoke.py, profile_state_root.py): the
#: registry size of ``bench.py``, its column seed, and its reps
N_VALIDATORS = 1_000_000
STATE_SEED = 7
REPS = 5

#: values the bench_tree_hash workload writes (Gwei)
BENCH_EFFECTIVE_BALANCE = 31 * 10**9
BENCH_BALANCE = 32 * 10**9
BENCH_ROWS_PER_REP = 1024


def seeded_columns(n: int, seed: int = STATE_SEED) -> dict[str, np.ndarray]:
    """Column name -> array for an ``n``-validator state."""
    rng = np.random.default_rng(seed)
    far = np.full(n, FAR_FUTURE_EPOCH, dtype=np.uint64)
    return {
        "pubkeys": rng.integers(0, 256, size=(n, 48), dtype=np.uint8),
        "withdrawal_credentials": rng.integers(0, 256, size=(n, 32),
                                               dtype=np.uint8),
        "effective_balance": np.full(n, 32 * 10**9, dtype=np.uint64),
        "slashed": np.zeros(n, dtype=bool),
        "activation_eligibility_epoch": np.zeros(n, dtype=np.uint64),
        "activation_epoch": np.zeros(n, dtype=np.uint64),
        "exit_epoch": far,
        "withdrawable_epoch": far.copy(),
        "balances": rng.integers(31 * 10**9, 33 * 10**9, size=n,
                                 dtype=np.uint64),
        "previous_epoch_participation": np.zeros(n, dtype=np.uint8),
        "current_epoch_participation": np.zeros(n, dtype=np.uint8),
        "inactivity_scores": np.zeros(n, dtype=np.uint64),
    }


STATE_COLUMNS = ("balances", "previous_epoch_participation",
                 "current_epoch_participation", "inactivity_scores")


def fill_state(state, registry, columns: dict[str, np.ndarray]) -> None:
    """Bind ``columns`` into ``state`` (either package's BeaconState):
    ``registry`` is an empty ValidatorRegistry of the same package."""
    for name in registry.COLUMNS:
        setattr(registry, name, columns[name])
    registry.mark_dirty()
    state.validators = registry
    for name in STATE_COLUMNS:
        # phase0 states have no participation or inactivity columns
        if name == "balances" or getattr(state, name) is not None:
            setattr(state, name, columns[name])


def bench_reps(n: int, reps: int, seed: int = 11):
    """(rows, brows) per rep, drawn as bench_tree_hash draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(reps):
        rows = rng.integers(0, n, size=BENCH_ROWS_PER_REP)
        brows = rng.integers(0, n, size=BENCH_ROWS_PER_REP)
        out.append((rows, brows))
    return out


def apply_bench_rep(state, rows: np.ndarray, brows: np.ndarray) -> None:
    """One rep's writes: effective_balance of ``rows`` through
    ``set_field``, the balances of ``brows`` through the column API."""
    for i in rows:
        state.validators.set_field(int(i), "effective_balance",
                                   BENCH_EFFECTIVE_BALANCE)
    state.balances[brows] = np.full(len(brows), BENCH_BALANCE,
                                    dtype=np.uint64)
