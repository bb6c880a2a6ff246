"""EIP-4881 deposit tree snapshots.

Equivalent of the reference's `DepositTreeSnapshot` support
(common/deposit_contract + beacon_node http_api `get_deposit_snapshot`):
the deposit contract tree can FINALIZE its left prefix — replacing fully-
deposited subtrees with single hashes — so a node only stores O(log n)
finalized roots plus the unfinalized tail, and a fresh node can resume
the tree from a served snapshot instead of replaying every historical
deposit log.

The tree follows the EIP-4881 reference structure: a fixed-depth (32)
sparse merkle tree over deposit-data roots whose nodes are one of
Finalized(hash) / Leaf(hash) / Branch(left, right) / Zero(depth), with
`mix_in_length(root, count)` as the contract's public root.
"""
from __future__ import annotations

from dataclasses import dataclass

# ONE definition of the hashing primitives: the 4881 twin's contract
# root must stay byte-identical to the legacy MerkleTree's
from ..specs.constants import DEPOSIT_CONTRACT_TREE_DEPTH as \
    DEPOSIT_CONTRACT_DEPTH
from ..ssz import mix_in_length
from ..utils.hash import ZERO_HASHES as _ZERO, hash_concat as _h


# -- node variants -----------------------------------------------------------

@dataclass
class _Finalized:
    hash: bytes
    count: int                        # deposits under this node

    def root(self, _d):
        return self.hash


@dataclass
class _Leaf:
    hash: bytes

    def root(self, _d):
        return self.hash


@dataclass
class _Zero:
    def root(self, depth):
        return _ZERO[depth]


@dataclass
class _Branch:
    left: object
    right: object

    def root(self, depth):
        return _h(self.left.root(depth - 1), self.right.root(depth - 1))


def _push(node, depth: int, leaf: bytes, index: int):
    """Insert leaf at position `index` within this subtree."""
    if depth == 0:
        return _Leaf(leaf)
    if isinstance(node, _Zero):
        node = _Branch(_Zero(), _Zero())
    half = 1 << (depth - 1)
    if index < half:
        node.left = _push(node.left, depth - 1, leaf, index)
    else:
        node.right = _push(node.right, depth - 1, leaf, index - half)
    return node


def _finalize(node, depth: int, remaining: int):
    """Finalize the leftmost `remaining` deposits under this node;
    returns (new_node, finalized_hashes_appended_left_to_right)."""
    size = 1 << depth
    if remaining >= size and not isinstance(node, _Zero):
        # fully covered: collapse to one hash
        h = node.root(depth)
        return _Finalized(h, size), [h]
    if depth == 0 or isinstance(node, (_Zero, _Finalized)):
        return node, []
    half = 1 << (depth - 1)
    hashes = []
    node.left, hs = _finalize(node.left, depth - 1, min(remaining, half))
    hashes += hs
    if remaining > half:
        node.right, hs = _finalize(node.right, depth - 1, remaining - half)
        hashes += hs
    return node, hashes


def _collect_finalized(node, depth: int, out: list):
    if isinstance(node, _Finalized):
        out.append(node.hash)
        return
    if isinstance(node, _Branch):
        _collect_finalized(node.left, depth - 1, out)
        _collect_finalized(node.right, depth - 1, out)


def _from_snapshot_node(finalized: list[bytes], count: int, depth: int):
    """Rebuild the node skeleton from the left-to-right finalized hashes
    (inverse of _collect_finalized for a left-packed tree)."""
    size = 1 << depth
    if count == 0:
        return _Zero()
    if count == size:
        return _Finalized(finalized.pop(0), size)
    half = 1 << (depth - 1)
    left = _from_snapshot_node(finalized, min(count, half), depth - 1)
    right = _from_snapshot_node(finalized, max(0, count - half), depth - 1)
    return _Branch(left, right)


@dataclass
class DepositTreeSnapshot:
    finalized: list[bytes]            # left-to-right finalized node hashes
    deposit_root: bytes
    deposit_count: int
    execution_block_hash: bytes
    execution_block_height: int

    def to_json(self) -> dict:
        return {
            "finalized": ["0x" + h.hex() for h in self.finalized],
            "deposit_root": "0x" + self.deposit_root.hex(),
            "deposit_count": str(self.deposit_count),
            "execution_block_hash":
                "0x" + self.execution_block_hash.hex(),
            "execution_block_height": str(self.execution_block_height),
        }


class DepositTree:
    """EIP-4881 deposit tree: push leaves, finalize a prefix, snapshot,
    resume from snapshot."""

    def __init__(self):
        self._root_node = _Zero()
        self.count = 0
        self.finalized_count = 0
        self._finalized_block = (b"\x00" * 32, 0)

    # -- contract operations -------------------------------------------------

    def push_leaf(self, leaf: bytes) -> None:
        if self.count >= (1 << DEPOSIT_CONTRACT_DEPTH):
            raise ValueError("deposit tree full")
        self._root_node = _push(self._root_node, DEPOSIT_CONTRACT_DEPTH,
                                leaf, self.count)
        self.count += 1

    def root(self) -> bytes:
        return mix_in_length(self._root_node.root(DEPOSIT_CONTRACT_DEPTH),
                             self.count)

    def finalize(self, deposit_count: int, execution_block_hash: bytes,
                 execution_block_height: int) -> None:
        """Finalize the first `deposit_count` deposits (they can never
        reorg): their subtrees collapse to single hashes."""
        if deposit_count > self.count:
            raise ValueError("cannot finalize beyond the tree")
        if deposit_count <= self.finalized_count:
            return
        self._root_node, _ = _finalize(self._root_node,
                                       DEPOSIT_CONTRACT_DEPTH,
                                       deposit_count)
        self.finalized_count = deposit_count
        self._finalized_block = (execution_block_hash,
                                 execution_block_height)

    # -- snapshots -----------------------------------------------------------

    def get_snapshot(self) -> DepositTreeSnapshot:
        """Snapshot of the FINALIZED prefix only (the resumable part)."""
        hashes: list[bytes] = []
        _collect_finalized(self._root_node, DEPOSIT_CONTRACT_DEPTH, hashes)
        prefix = _from_snapshot_node(list(hashes), self.finalized_count,
                                     DEPOSIT_CONTRACT_DEPTH)
        return DepositTreeSnapshot(
            finalized=hashes,
            deposit_root=mix_in_length(
                prefix.root(DEPOSIT_CONTRACT_DEPTH), self.finalized_count),
            deposit_count=self.finalized_count,
            execution_block_hash=self._finalized_block[0],
            execution_block_height=self._finalized_block[1])

    @classmethod
    def from_snapshot(cls, snap: DepositTreeSnapshot) -> "DepositTree":
        # a left-packed prefix of N deposits collapses to exactly
        # popcount(N) finalized subtree hashes — anything else is a
        # malformed snapshot and must reject cleanly, not IndexError
        if len(snap.finalized) != bin(snap.deposit_count).count("1"):
            raise ValueError("snapshot finalized-hash count mismatch")
        tree = cls()
        tree._root_node = _from_snapshot_node(
            list(snap.finalized), snap.deposit_count,
            DEPOSIT_CONTRACT_DEPTH)
        tree.count = snap.deposit_count
        tree.finalized_count = snap.deposit_count
        tree._finalized_block = (snap.execution_block_hash,
                                 snap.execution_block_height)
        if tree.root() != snap.deposit_root:
            raise ValueError("snapshot root mismatch")
        return tree
