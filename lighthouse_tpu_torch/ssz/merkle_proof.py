"""Generalized-index merkle proofs + incremental deposit tree.

Equivalent of the reference's consensus/merkle_proof/src/lib.rs: a sparse
`MerkleTree` supporting push_leaf/generate_proof, and `verify_merkle_proof`
for fixed-depth branches (deposit contract tree, state proofs, light client).
"""
from __future__ import annotations

from ..utils.hash import ZERO_HASHES, hash_concat

MAX_TREE_DEPTH = 32


class MerkleTreeError(Exception):
    pass


class MerkleTree:
    """Right-zero-padded sparse binary merkle tree with incremental append."""

    __slots__ = ("depth", "_leaves", "_hash_cache")

    def __init__(self, depth: int, leaves: list[bytes] | None = None):
        if depth > MAX_TREE_DEPTH:
            raise MerkleTreeError("depth too large")
        self.depth = depth
        self._leaves: list[bytes] = list(leaves or [])
        if len(self._leaves) > (1 << depth):
            raise MerkleTreeError("too many leaves")
        self._hash_cache: bytes | None = None

    def push_leaf(self, leaf: bytes) -> None:
        if len(self._leaves) >= (1 << self.depth):
            raise MerkleTreeError("tree is full")
        self._leaves.append(leaf)
        self._hash_cache = None

    def __len__(self) -> int:
        return len(self._leaves)

    def hash(self) -> bytes:
        if self._hash_cache is None:
            nodes = list(self._leaves)
            for d in range(self.depth):
                if len(nodes) % 2:
                    nodes.append(ZERO_HASHES[d])
                nodes = [hash_concat(nodes[i], nodes[i + 1])
                         for i in range(0, len(nodes), 2)]
            self._hash_cache = nodes[0] if nodes else ZERO_HASHES[self.depth]
        return self._hash_cache

    def generate_proof(self, index: int) -> list[bytes]:
        """Sibling path (bottom-up) for leaf `index`."""
        if index >= (1 << self.depth):
            raise MerkleTreeError("index out of range")
        proof = []
        nodes = list(self._leaves)
        idx = index
        for d in range(self.depth):
            if len(nodes) % 2:
                nodes.append(ZERO_HASHES[d])
            sib = idx ^ 1
            proof.append(nodes[sib] if sib < len(nodes) else ZERO_HASHES[d])
            nodes = [hash_concat(nodes[i], nodes[i + 1])
                     for i in range(0, len(nodes), 2)]
            idx //= 2
        return proof


def merkle_root_from_branch(leaf: bytes, branch: list[bytes],
                            index: int) -> bytes:
    """Fold a bottom-up sibling branch into a root."""
    node = leaf
    for i, sib in enumerate(branch):
        if (index >> i) & 1:
            node = hash_concat(sib, node)
        else:
            node = hash_concat(node, sib)
    return node


def verify_merkle_proof(leaf: bytes, branch: list[bytes], depth: int,
                        index: int, root: bytes) -> bool:
    if len(branch) != depth:
        return False
    return merkle_root_from_branch(leaf, branch, index) == root


# -- generalized indices (spec ssz/merkle-proofs.md) -------------------------

def generalized_index_depth(gindex: int) -> int:
    return gindex.bit_length() - 1


def verify_merkle_proof_gindex(leaf: bytes, branch: list[bytes],
                               gindex: int, root: bytes) -> bool:
    depth = generalized_index_depth(gindex)
    index = gindex - (1 << depth)
    return verify_merkle_proof(leaf, branch, depth, index, root)
