"""Carry state across from the JAX package.

``state_from_ssz`` builds the port's BeaconState from the SSZ bytes of a
state the JAX package serialized, ``signed_block_from_ssz`` the port's
SignedBeaconBlock from a block's; ``device_tree_from_levels`` builds a port
DeviceTree from the dense levels of a JAX ``DeviceTree`` taken as numpy
arrays; ``limbs_from_numpy``/``limbs_to_numpy`` carry the JAX package's
int32 limb arrays (field elements, points, Fp12 values) to the port's
tensors and back; ``signature_sets_from`` copies signature sets into the
port's ``SignatureSet``. None imports the JAX package: all take plain
bytes, arrays and attributes.
"""
from __future__ import annotations

import numpy as np
import torch

from .containers.core import get_types
from .containers.state import BeaconState
from .crypto.bls import SignatureSet
from .device import resolve
from .ops.merkle_tree import DeviceTree
from .ops.sha256 import cap_root, words_to_tensor
from .specs.chain_spec import ChainSpec, ForkName
from .ssz import deserialize


def state_from_ssz(data: bytes, spec: ChainSpec,
                   fork: ForkName) -> BeaconState:
    """The port's BeaconState of ``fork`` from SSZ bytes."""
    return BeaconState.from_ssz_bytes(bytes(data), get_types(spec.preset),
                                      spec, fork)


def device_tree_from_levels(levels, n: int, limit: int, pre_levels: int = 0,
                            with_pk: bool = False, device=None) -> DeviceTree:
    """A port DeviceTree over ``n`` leaves holding ``levels`` (u32[2^l, 8]
    numpy arrays, leaf level first, as a JAX DeviceTree keeps them)."""
    tree = DeviceTree(n, limit, pre_levels, with_pk, device=device)
    levels = [np.asarray(lv, dtype=np.uint32) for lv in levels]
    if len(levels) != tree.dense_depth + 1:
        raise ValueError(f"expected {tree.dense_depth + 1} levels, "
                         f"got {len(levels)}")
    for lvl, lv in enumerate(levels):
        if lv.shape != (tree.dense >> lvl, 8):
            raise ValueError(f"level {lvl}: shape {lv.shape}")
    tree.levels = [words_to_tensor(lv, tree.device) for lv in levels]
    tree.root_words = cap_root(tree.levels[-1][0], tree.dense_depth,
                               tree.limit_depth)
    return tree


def limbs_from_numpy(arr, device=None) -> torch.Tensor:
    """The JAX package's limb array (int32 [..., 32], any leading shape) as
    a contiguous int32 tensor on ``device`` (None: the port's default)."""
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.int32))
    return torch.from_numpy(arr.copy()).to(resolve(device))


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A port limb tensor as a numpy int32 array (on the host)."""
    return t.detach().to("cpu").numpy().astype(np.int32)


def signature_sets_from(sets) -> list[SignatureSet]:
    """Copies of signature sets (objects with ``signature``, ``pubkeys``
    and ``message``) as the port's ``SignatureSet``."""
    return [SignatureSet(bytes(s.signature), [bytes(p) for p in s.pubkeys],
                         bytes(s.message)) for s in sets]


def signed_block_from_ssz(data: bytes, spec: ChainSpec, fork: ForkName):
    """The port's SignedBeaconBlock of ``fork`` from SSZ bytes (either
    package's encoding: the two are the same)."""
    typ = get_types(spec.preset).SignedBeaconBlock[fork].ssz_type
    return deserialize(typ, bytes(data))
