"""Consensus containers for every fork (phase0 → electra).

Equivalent of the reference's consensus/types (22.6k LoC): SSZ containers,
multi-fork variants (superstruct → per-fork classes in a preset-keyed
registry), and the array-backed SoA BeaconState.

Because container shapes depend on the compile-time preset (the reference's
`EthSpec` typenum trait, consensus/types/src/eth_spec.rs:53-161), all types
are built by ``get_types(preset)`` — a cached factory returning a namespace of
container classes and per-fork registries.
"""
from .core import get_types, Types
from .state import BeaconState, ValidatorRegistry, ValidatorView
