"""Proto-array: flat-array LMD-GHOST.

Equivalent of the reference's consensus/proto_array/src/proto_array.rs
(ProtoArray :129, apply_score_changes :155, find_head :632, maybe_prune :697)
and proto_array_fork_choice.rs (vote tracking :25, deltas). Nodes are stored
in insertion order so every parent precedes its children — one backward sweep
propagates weight deltas, one forward sweep repairs best-child/best-descendant.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class ProtoArrayError(Exception):
    pass


class ExecutionStatus(enum.Enum):
    IRRELEVANT = "irrelevant"   # pre-merge / no payload
    OPTIMISTIC = "optimistic"   # payload not yet verified by the EL
    VALID = "valid"
    INVALID = "invalid"


@dataclass
class ProtoNode:
    slot: int
    root: bytes
    parent: int | None
    state_root: bytes
    target_root: bytes
    justified_checkpoint: tuple[int, bytes]
    finalized_checkpoint: tuple[int, bytes]
    unrealized_justified_checkpoint: tuple[int, bytes] | None = None
    unrealized_finalized_checkpoint: tuple[int, bytes] | None = None
    weight: int = 0
    best_child: int | None = None
    best_descendant: int | None = None
    execution_status: ExecutionStatus = ExecutionStatus.IRRELEVANT
    execution_block_hash: bytes | None = None


@dataclass
class VoteTracker:
    current_root: bytes = b"\x00" * 32
    next_root: bytes = b"\x00" * 32
    next_epoch: int = 0


def compute_deltas(indices: dict[bytes, int], votes: list[VoteTracker],
                   old_balances, new_balances,
                   equivocating: set[int]) -> dict[int, int]:
    """Weight deltas per node index from vote transitions
    (proto_array_fork_choice.rs compute_deltas)."""
    deltas: dict[int, int] = {}
    for v_index, vote in enumerate(votes):
        if vote.current_root == vote.next_root and \
                v_index not in equivocating:
            continue
        old_bal = int(old_balances[v_index]) \
            if v_index < len(old_balances) else 0
        new_bal = int(new_balances[v_index]) \
            if v_index < len(new_balances) else 0
        if v_index in equivocating:
            i = indices.get(vote.current_root)
            if i is not None:
                deltas[i] = deltas.get(i, 0) - old_bal
            vote.current_root = b"\x00" * 32
            vote.next_root = b"\x00" * 32
            continue
        i = indices.get(vote.current_root)
        if i is not None:
            deltas[i] = deltas.get(i, 0) - old_bal
        j = indices.get(vote.next_root)
        if j is not None:
            deltas[j] = deltas.get(j, 0) + new_bal
        vote.current_root = vote.next_root
    return deltas


class ProtoArray:
    def __init__(self, justified_checkpoint: tuple[int, bytes],
                 finalized_checkpoint: tuple[int, bytes]):
        self.nodes: list[ProtoNode] = []
        self.indices: dict[bytes, int] = {}
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint
        self.prune_threshold = 256
        self.previous_proposer_boost: tuple[bytes, int] = (b"\x00" * 32, 0)

    def __contains__(self, root: bytes) -> bool:
        return root in self.indices

    def get(self, root: bytes) -> ProtoNode | None:
        i = self.indices.get(root)
        return self.nodes[i] if i is not None else None

    def on_block(self, node: ProtoNode) -> None:
        if node.root in self.indices:
            return
        node_index = len(self.nodes)
        self.indices[node.root] = node_index
        self.nodes.append(node)
        if node.parent is not None:
            self._maybe_update_best_child_and_descendant(node.parent,
                                                         node_index)
            # invalid parents poison children immediately
            parent = self.nodes[node.parent]
            if parent.execution_status == ExecutionStatus.INVALID:
                node.execution_status = ExecutionStatus.INVALID

    # -- weights -------------------------------------------------------------

    def apply_score_changes(self, deltas: dict[int, int],
                            justified_checkpoint: tuple[int, bytes],
                            finalized_checkpoint: tuple[int, bytes],
                            new_proposer_boost: tuple[bytes, int]) -> None:
        """Backward delta propagation + forward best-child repair
        (proto_array.rs:155)."""
        self.justified_checkpoint = justified_checkpoint
        self.finalized_checkpoint = finalized_checkpoint

        # proposer boost: remove previous, add current
        d = dict(deltas)
        prev_root, prev_amount = self.previous_proposer_boost
        if prev_amount:
            i = self.indices.get(prev_root)
            if i is not None:
                d[i] = d.get(i, 0) - prev_amount
        boost_root, boost_amount = new_proposer_boost
        if boost_amount:
            i = self.indices.get(boost_root)
            if i is not None:
                d[i] = d.get(i, 0) + boost_amount
        self.previous_proposer_boost = new_proposer_boost

        for node_index in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[node_index]
            delta = d.get(node_index, 0)
            if delta:
                node.weight += delta
                if node.weight < 0:
                    raise ProtoArrayError("negative node weight")
                if node.parent is not None:
                    d[node.parent] = d.get(node.parent, 0) + delta
        for node_index in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[node_index]
            if node.parent is not None:
                self._maybe_update_best_child_and_descendant(node.parent,
                                                             node_index)

    # -- head ----------------------------------------------------------------

    def find_head(self, justified_root: bytes) -> bytes:
        i = self.indices.get(justified_root)
        if i is None:
            raise ProtoArrayError("justified root not in proto array")
        node = self.nodes[i]
        best = node.best_descendant
        head = self.nodes[best] if best is not None else node
        if not self._node_is_viable_for_head(head):
            raise ProtoArrayError(
                "find_head returned a non-viable head (justified "
                f"{self.justified_checkpoint[0]}, head jc "
                f"{head.justified_checkpoint[0]})")
        return head.root

    def _node_is_viable_for_head(self, node: ProtoNode) -> bool:
        if node.execution_status == ExecutionStatus.INVALID:
            return False
        cj_epoch, _cj_root = self.justified_checkpoint
        fin_epoch, fin_root = self.finalized_checkpoint
        # current or unrealized checkpoints may satisfy viability
        # (fork_choice.rs unrealized-justification handling)
        jc_ok = (node.justified_checkpoint == self.justified_checkpoint
                 or cj_epoch == 0)
        if not jc_ok and node.unrealized_justified_checkpoint is not None:
            jc_ok = node.unrealized_justified_checkpoint == \
                self.justified_checkpoint
        fin_ok = fin_epoch == 0 or self._is_descendant_of_finalized(node)
        return jc_ok and fin_ok

    def _is_descendant_of_finalized(self, node: ProtoNode) -> bool:
        fin_epoch, fin_root = self.finalized_checkpoint
        fin_i = self.indices.get(fin_root)
        if fin_i is None:
            return True
        fin_slot = self.nodes[fin_i].slot
        i = self.indices.get(node.root)
        while i is not None and self.nodes[i].slot > fin_slot:
            i = self.nodes[i].parent
        return i == fin_i

    def ancestor_at_or_below_slot(self, root: bytes,
                                  slot: int) -> bytes | None:
        """Root of the ancestor of `root` with the highest slot <= `slot`
        (the *shuffling decision root* walk, shuffling_cache.rs keying).
        When the chain below is pruned, the oldest retained ancestor (the
        finalized root) is returned — everything beneath it is shared, so
        it still uniquely keys the shuffling.  None for unknown `root`."""
        i = self.indices.get(root)
        if i is None:
            return None
        while self.nodes[i].slot > slot:
            parent = self.nodes[i].parent
            if parent is None:
                break
            i = parent
        return self.nodes[i].root

    def is_descendant(self, ancestor_root: bytes,
                      descendant_root: bytes) -> bool:
        a = self.indices.get(ancestor_root)
        i = self.indices.get(descendant_root)
        if a is None or i is None:
            return False
        a_slot = self.nodes[a].slot
        while i is not None and self.nodes[i].slot > a_slot:
            i = self.nodes[i].parent
        return i == a

    def _maybe_update_best_child_and_descendant(self, parent_index: int,
                                                child_index: int) -> None:
        child = self.nodes[child_index]
        parent = self.nodes[parent_index]
        child_leads_to_viable = self._leads_to_viable_head(child)

        child_best_descendant = (child.best_descendant
                                 if child.best_descendant is not None
                                 else child_index)

        if parent.best_child == child_index:
            if not child_leads_to_viable:
                parent.best_child = None
                parent.best_descendant = None
            else:
                parent.best_descendant = child_best_descendant
        elif child_leads_to_viable:
            if parent.best_child is None:
                parent.best_child = child_index
                parent.best_descendant = child_best_descendant
            else:
                best = self.nodes[parent.best_child]
                best_viable = self._leads_to_viable_head(best)
                if not best_viable or child.weight > best.weight or (
                        child.weight == best.weight
                        and child.root >= best.root):
                    parent.best_child = child_index
                    parent.best_descendant = child_best_descendant

    def _leads_to_viable_head(self, node: ProtoNode) -> bool:
        if node.best_descendant is not None:
            return self._node_is_viable_for_head(
                self.nodes[node.best_descendant])
        return self._node_is_viable_for_head(node)

    # -- pruning -------------------------------------------------------------

    def maybe_prune(self, finalized_root: bytes) -> None:
        fin_index = self.indices.get(finalized_root)
        if fin_index is None:
            raise ProtoArrayError("prune: unknown finalized root")
        if fin_index < self.prune_threshold:
            return
        for node in self.nodes[:fin_index]:
            self.indices.pop(node.root, None)
        self.nodes = self.nodes[fin_index:]
        for root in list(self.indices):
            self.indices[root] -= fin_index
        for node in self.nodes:
            if node.parent is not None:
                node.parent = (node.parent - fin_index
                               if node.parent >= fin_index else None)
            if node.best_child is not None:
                node.best_child -= fin_index
            if node.best_descendant is not None:
                node.best_descendant -= fin_index

    # -- execution status (optimistic sync) ----------------------------------

    def process_execution_payload_validation(self, root: bytes) -> None:
        """Mark `root` and all ancestors VALID (proto_array.rs:383)."""
        i = self.indices.get(root)
        while i is not None:
            node = self.nodes[i]
            if node.execution_status == ExecutionStatus.INVALID:
                raise ProtoArrayError("cannot validate an invalid block")
            if node.execution_status in (ExecutionStatus.VALID,
                                         ExecutionStatus.IRRELEVANT):
                break
            node.execution_status = ExecutionStatus.VALID
            i = node.parent

    def process_execution_payload_invalidation(
            self, head_block_root: bytes,
            latest_valid_ancestor_hash: bytes | None) -> None:
        """Mark the chain from head back to (exclusive) the latest valid
        ancestor INVALID, and all descendants of head INVALID
        (proto_array.rs:442)."""
        i = self.indices.get(head_block_root)
        if i is None:
            raise ProtoArrayError("invalidate: unknown block")
        first_invalid = i
        # walk back until the latest valid ancestor
        while i is not None:
            node = self.nodes[i]
            if latest_valid_ancestor_hash is not None and \
                    node.execution_block_hash == latest_valid_ancestor_hash:
                self.process_execution_payload_validation(node.root)
                break
            if node.execution_status == ExecutionStatus.VALID:
                break
            if node.execution_status != ExecutionStatus.IRRELEVANT:
                node.execution_status = ExecutionStatus.INVALID
                node.best_child = None
                node.best_descendant = None
                first_invalid = i
            i = node.parent
        # invalidate all descendants of any invalid node
        for j in range(first_invalid, len(self.nodes)):
            node = self.nodes[j]
            if node.parent is not None and \
                    self.nodes[node.parent].execution_status == \
                    ExecutionStatus.INVALID and \
                    node.execution_status != ExecutionStatus.IRRELEVANT:
                node.execution_status = ExecutionStatus.INVALID
                node.best_child = None
                node.best_descendant = None
        # repair best-child/descendant links
        for j in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[j]
            if node.parent is not None:
                self._maybe_update_best_child_and_descendant(node.parent, j)
