"""The tracker itself (eth1/src/{service,block_cache,deposit_cache}.rs)."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..specs.chain_spec import ChainSpec
from ..specs.constants import DEPOSIT_CONTRACT_TREE_DEPTH
from ..ssz import htr, mix_in_length
from ..ssz.merkle_proof import MerkleTree


@dataclass
class Eth1Block:
    number: int
    hash: bytes
    parent_hash: bytes
    timestamp: int
    deposit_count: int
    deposit_root: bytes


@dataclass
class DepositLog:
    index: int
    deposit_data: object        # T.DepositData


class MockEth1Endpoint:
    """In-process eth1 chain for tests/devnets (the reference's
    eth1 test doubles)."""

    def __init__(self, spec: ChainSpec, T):
        self.spec = spec
        self.T = T
        self.blocks: list[Eth1Block] = []
        self.logs: list[DepositLog] = []
        self._tree = MerkleTree(DEPOSIT_CONTRACT_TREE_DEPTH)
        genesis = Eth1Block(0, b"\xe1" + b"\x00" * 31, b"\x00" * 32,
                            0, 0, mix_in_length(self._tree.hash(), 0))
        self.blocks.append(genesis)

    def add_block(self, timestamp: int | None = None,
                  deposits: list | None = None) -> Eth1Block:
        for dd in deposits or []:
            self.logs.append(DepositLog(len(self.logs), dd))
            self._tree.push_leaf(htr(dd))
        prev = self.blocks[-1]
        blk = Eth1Block(
            number=prev.number + 1,
            hash=bytes([0xE1, prev.number + 1 & 0xFF]) + b"\x11" * 30,
            parent_hash=prev.hash,
            timestamp=(timestamp if timestamp is not None
                       else prev.timestamp + self.spec.seconds_per_eth1_block),
            deposit_count=len(self.logs),
            deposit_root=mix_in_length(self._tree.hash(), len(self.logs)))
        self.blocks.append(blk)
        return blk

    # endpoint API the service polls
    def latest_block_number(self) -> int:
        return self.blocks[-1].number

    def block_by_number(self, n: int) -> Eth1Block | None:
        return self.blocks[n] if 0 <= n < len(self.blocks) else None

    def deposit_logs_in_range(self, start: int, end: int) -> list[DepositLog]:
        return [l for l in self.logs if start <= l.index < end]


class Eth1Service:
    def __init__(self, spec: ChainSpec, T, endpoint):
        self.spec = spec
        self.T = T
        self.endpoint = endpoint
        self.block_cache: list[Eth1Block] = []
        self.deposit_tree = MerkleTree(DEPOSIT_CONTRACT_TREE_DEPTH)
        self.deposit_logs: list[DepositLog] = []
        self._proof_trees: dict[int, MerkleTree] = {}  # deposit_count -> tree
        self.finalized_deposit_count = 0
        # EIP-4881 snapshot twin: finalizable prefix + resumable snapshot
        from .deposit_snapshot import DepositTree
        self.deposit_tree_4881 = DepositTree()
        self._pending_4881_finalize: tuple | None = None
        # RLock: update()/finalize() call helper methods that take the
        # lock themselves, so every _pending_4881_finalize access is
        # visibly guarded (graftlint: lock-discipline)
        self._lock = threading.RLock()

    # -- finalization pruning (eth1_finalization_cache.rs consumer) ----------

    def finalize(self, snap: dict) -> None:
        """Prune tracker caches below a finalized checkpoint's eth1
        snapshot: deposits at indices below the finalized deposit_index
        can never be requested again (every future state's
        eth1_deposit_index is >= it), so their cached proof trees and the
        eth1 blocks at/below the finalized deposit_count go."""
        with self._lock:
            count = int(snap["deposit_index"])
            if count <= self.finalized_deposit_count:
                return
            self.finalized_deposit_count = count
            for k in [k for k in self._proof_trees if k < count]:
                del self._proof_trees[k]
            keep_from = 0
            # the snapshot's execution block must match the TREE's
            # finalization point (deposit_index), not the vote count —
            # a resuming node scans logs from this block onward
            fin_block = (b"\x00" * 32, 0)
            for i, b in enumerate(self.block_cache):
                if b.deposit_count <= int(snap["deposit_count"]):
                    keep_from = i
                if b.deposit_count <= count:
                    fin_block = (b.hash, b.number)
            # keep the newest pre-finalization block (votes may reference
            # it) and everything after
            self.block_cache = self.block_cache[keep_from:]
            # EIP-4881: collapse the finalized prefix to snapshot hashes;
            # if the poller hasn't imported that many logs yet, remember
            # the target and retry once update() catches up
            if count <= self.deposit_tree_4881.count:
                self.deposit_tree_4881.finalize(count, fin_block[0],
                                                fin_block[1])
                self._pending_4881_finalize = None
            else:
                # keep the block captured from the PRE-pruned cache as a
                # fallback: the retry scans the pruned cache and may not
                # find any block at/below the finalization point
                self._pending_4881_finalize = (count, fin_block)

    def _retry_pending_finalize(self) -> None:
        """Called (under the lock) after log import: apply a snapshot
        finalization that arrived before its logs did.  The execution
        block is recomputed NOW — the one cached at finalize() time
        predated the logs and would make resuming nodes re-scan deposits
        already inside the finalized prefix."""
        with self._lock:
            pending = self._pending_4881_finalize
            if pending is None or pending[0] > self.deposit_tree_4881.count:
                return
            count, fin_block = pending
            for b in self.block_cache:
                if b.deposit_count <= count:
                    fin_block = (b.hash, b.number)
            self.deposit_tree_4881.finalize(count, fin_block[0],
                                            fin_block[1])
            self._pending_4881_finalize = None

    def get_deposit_snapshot(self):
        """The resumable EIP-4881 snapshot (http_api get_deposit_snapshot)."""
        with self._lock:
            return self.deposit_tree_4881.get_snapshot()

    # -- polling (service.rs update loop) ------------------------------------

    def update(self) -> None:
        with self._lock:
            head = self.endpoint.latest_block_number()
            follow = self.spec.eth1_follow_distance
            target = max(0, head - follow)
            known = self.block_cache[-1].number if self.block_cache else -1
            for n in range(known + 1, target + 1):
                blk = self.endpoint.block_by_number(n)
                if blk is None:
                    break
                self.block_cache.append(blk)
            # import new deposit logs up to the followed deposit count
            if self.block_cache:
                count = self.block_cache[-1].deposit_count
                have = len(self.deposit_logs)
                for log in self.endpoint.deposit_logs_in_range(have, count):
                    self.deposit_logs.append(log)
                    leaf = htr(log.deposit_data)
                    self.deposit_tree.push_leaf(leaf)
                    self.deposit_tree_4881.push_leaf(leaf)
                self._retry_pending_finalize()

    # -- eth1 data votes (get_eth1_vote) -------------------------------------

    def eth1_data_for_block(self, state) -> object:
        """Majority vote within the voting period, else the latest followed
        block's eth1 data; falls back to the state's current value."""
        with self._lock:
            if not self.block_cache:
                return state.eth1_data
            period_start = self._voting_period_start_timestamp(state)
            candidates = [b for b in self.block_cache
                          if b.timestamp <= period_start]
            best = candidates[-1] if candidates else self.block_cache[-1]
            new_data = self.T.Eth1Data(
                deposit_root=best.deposit_root,
                deposit_count=best.deposit_count,
                block_hash=best.hash)
            # never vote to decrease the deposit count
            if new_data.deposit_count < state.eth1_data.deposit_count:
                return state.eth1_data
            # majority of existing votes wins
            tally: dict = {}
            for v in state.eth1_data_votes:
                key = htr(v)
                tally[key] = tally.get(key, 0) + 1
            if tally:
                top_root = max(tally, key=tally.get)
                for v in state.eth1_data_votes:
                    if htr(v) == top_root and \
                            v.deposit_count >= state.eth1_data.deposit_count:
                        if tally[top_root] * 2 > len(state.eth1_data_votes):
                            return v
            return new_data

    def _voting_period_start_timestamp(self, state) -> int:
        p = self.spec.preset
        slots = p.epochs_per_eth1_voting_period * p.slots_per_epoch
        period_start_slot = state.slot - state.slot % slots
        return state.genesis_time + period_start_slot * \
            self.spec.seconds_per_slot - \
            self.spec.eth1_follow_distance * self.spec.seconds_per_eth1_block

    # -- deposits for inclusion ----------------------------------------------

    def deposits_for_block(self, state) -> list:
        """Deposits the next block MUST include (with proofs against the
        state's eth1_data.deposit_root)."""
        p = self.spec.preset
        start = state.eth1_deposit_index
        count = min(p.max_deposits,
                    state.eth1_data.deposit_count - start)
        if count <= 0:
            return []
        with self._lock:
            if len(self.deposit_logs) < start + count:
                return []
            # proof tree snapshot at the voted deposit_count (cached —
            # rebuilding per proposal was O(total deposits) of hashing)
            want = state.eth1_data.deposit_count
            tree = self._proof_trees.get(want)
            if tree is None:
                tree = MerkleTree(DEPOSIT_CONTRACT_TREE_DEPTH)
                for log in self.deposit_logs[:want]:
                    tree.push_leaf(htr(log.deposit_data))
                self._proof_trees = {want: tree}  # keep one snapshot
            out = []
            for i in range(start, start + count):
                proof = tree.generate_proof(i) + [
                    state.eth1_data.deposit_count.to_bytes(32, "little")]
                out.append(self.T.Deposit(
                    proof=proof, data=self.deposit_logs[i].deposit_data))
        return out
