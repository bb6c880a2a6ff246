"""Sharded merkleization (the port of ``lighthouse_tpu/parallel/merkle.py``).

Each rank merkleizes its contiguous leaf block, a complete subtree since
blocks are powers of two, with the port's ``merkleize_dense`` (one
``hash64`` launch a level); the ``size`` subtree roots are all-gathered
(``size`` x 32 bytes, one collective a tree) and every rank hashes the small
top tree itself.
"""
from __future__ import annotations

import torch

from ..ops.sha256 import hash_pairs, merkleize_dense
from .mesh import Mesh, program

SUBTREE_THEN_TOP = program(
    "parallel.merkle.subtree_then_top",
    "lighthouse_tpu_torch/parallel/merkle.py",
    "lighthouse_tpu/parallel/merkle.py:27")


def _subtree_then_top(mesh: Mesh, local_leaves: torch.Tensor,
                      subtree_depth: int, top_depth: int) -> torch.Tensor:
    """Local subtree root -> all_gather -> top tree; the root u32[8]."""
    SUBTREE_THEN_TOP.ran()
    root = merkleize_dense(local_leaves, subtree_depth)         # [8]
    top = mesh.all_gather(root, "merkle.subtree_roots")         # [n, 8]
    for _ in range(top_depth):
        top = hash_pairs(top)
    return top[0]


def _depths(n: int, size: int) -> tuple[int, int]:
    """(subtree_depth, top_depth) of ``n`` leaves over ``size`` ranks;
    raises unless n and n / size are powers of two."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"leaf count {n} is not a power of two")
    if n % size:
        raise ValueError(f"{n} leaves do not split over {size} ranks")
    local = n // size
    if local & (local - 1):
        raise ValueError("leaf shard must be a power of two")
    return (local - 1).bit_length(), (size - 1).bit_length()


def sharded_merkleize(mesh: Mesh, local_leaves: torch.Tensor) -> torch.Tensor:
    """Merkleize u32[N, 8] leaves row-sharded over the mesh (this rank's
    block u32[N / size, 8]; N and N / size powers of two). Returns the
    root u32[8] on every rank."""
    local = int(local_leaves.shape[0])
    subtree_depth, top_depth = _depths(local * mesh.size, mesh.size)
    return _subtree_then_top(mesh, local_leaves.reshape(local, 8),
                             subtree_depth, top_depth)


def sharded_state_root_step(mesh: Mesh, validator_leaves: torch.Tensor,
                            balance_leaves: torch.Tensor):
    """The sharded full step over the two dominant BeaconState columns:
    validators (8 chunks each, pre-flattened) and balances, each
    merkleized across the mesh; returns (validators_root, balances_root)."""
    v_root = sharded_merkleize(mesh, validator_leaves)
    b_root = sharded_merkleize(mesh, balance_leaves)
    return v_root, b_root
