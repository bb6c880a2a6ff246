"""Blob data-availability checking (deneb+).

Equivalent of the reference's beacon_node/beacon_chain/src/
{data_availability_checker.rs:27-45, blob_verification.rs}: blocks with blob
commitments wait in an overflow cache until every sidecar has arrived and
verified (commitment inclusion proof against the block body at
KZG_COMMITMENT_INCLUSION_PROOF_DEPTH, plus the KZG blob proof), then import
proceeds.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..ssz import htr, merkleize_chunks, mix_in_length, next_pow_of_two
from ..utils.hash import ZERO_HASHES, hash_concat


class FakeKzgVerifier:
    """Always-valid KZG (fake_crypto-style) for chain tests."""

    def verify_blob_kzg_proof_batch(self, blobs, commitments, proofs):
        return True

    def compute_blob_kzg_proof(self, blob, commitment):
        return b"\xfa" * 48

    def blob_to_kzg_commitment(self, blob):
        import hashlib
        return bytes([0x80]) + hashlib.sha256(blob).digest() + b"\x00" * 15

    # PeerDAS cells surface: a systematic "extension" (blob then zeros)
    # with fake proofs, mirroring the real layout where the first half of
    # the cells is the blob itself.  No erasure recovery (fake crypto).
    def compute_cells_and_kzg_proofs(self, blob):
        from ..specs.constants import NUMBER_OF_COLUMNS
        ext = bytes(blob) + b"\x00" * len(blob)
        cs = len(ext) // NUMBER_OF_COLUMNS
        cells = [ext[j * cs:(j + 1) * cs] for j in range(NUMBER_OF_COLUMNS)]
        return cells, [b"\xfa" * 48] * NUMBER_OF_COLUMNS

    def verify_cell_kzg_proof_batch(self, commitments, cell_indices, cells,
                                    proofs):
        return True


# ---------------------------------------------------------------------------
# commitment inclusion proofs (BlobSidecar.kzg_commitment_inclusion_proof)
# ---------------------------------------------------------------------------

def _body_field_layers(T, body):
    fields = list(type(body).__ssz_fields__.items())
    from ..ssz import hash_tree_root
    roots = [hash_tree_root(t, getattr(body, n)) for n, t in fields]
    return fields, roots


def commitment_inclusion_proof(T, body, index: int) -> list[bytes]:
    """Branch proving body.blob_kzg_commitments[index] within the body root.

    Path: commitment leaf -> commitments list tree (depth log2(limit)) ->
    length mixin -> body field tree. Total = preset
    kzg_commitment_inclusion_proof_depth.
    """
    p = T.preset
    limit = p.max_blob_commitments_per_block
    list_depth = (limit - 1).bit_length()
    commitments = list(body.blob_kzg_commitments)
    leaves = [htr_commitment(c) for c in commitments]

    # siblings inside the (virtually limit-sized) list tree
    branch = []
    idx = index
    nodes = leaves
    for d in range(list_depth):
        if len(nodes) % 2:
            nodes = nodes + [ZERO_HASHES[d]]
        sib = idx ^ 1
        branch.append(nodes[sib] if sib < len(nodes) else ZERO_HASHES[d])
        nodes = [hash_concat(nodes[i], nodes[i + 1])
                 for i in range(0, len(nodes), 2)]
        idx //= 2
    # length mixin sibling
    n = len(commitments)
    branch.append(n.to_bytes(32, "little"))
    # body field tree siblings
    fields, roots = _body_field_layers(T, body)
    field_index = [i for i, (name, _t) in enumerate(fields)
                   if name == "blob_kzg_commitments"][0]
    fcount = next_pow_of_two(len(roots))
    fnodes = roots + [ZERO_HASHES[0]] * (fcount - len(roots))
    fidx = field_index
    for d in range((fcount - 1).bit_length()):
        branch.append(fnodes[fidx ^ 1])
        fnodes = [hash_concat(fnodes[i], fnodes[i + 1])
                  for i in range(0, len(fnodes), 2)]
        fidx //= 2
    return branch


def htr_commitment(c: bytes) -> bytes:
    return hash_concat(c[:32].ljust(32, b"\x00"),
                       c[32:].ljust(32, b"\x00"))


def verify_commitment_inclusion(T, sidecar, body_root: bytes) -> bool:
    """Fold the sidecar's branch: commitment leaf -> list tree -> length
    mixin -> body field tree == body_root."""
    p = T.preset
    list_depth = (p.max_blob_commitments_per_block - 1).bit_length()
    branch = list(sidecar.kzg_commitment_inclusion_proof)
    if len(branch) != p.kzg_commitment_inclusion_proof_depth:
        return False
    node = htr_commitment(sidecar.kzg_commitment)
    for i in range(list_depth):
        sib = branch[i]
        if (sidecar.index >> i) & 1:
            node = hash_concat(sib, node)
        else:
            node = hash_concat(node, sib)
    node = hash_concat(node, branch[list_depth])  # mix_in_length
    return _fold_field(branch[list_depth + 1:], node,
                       _commitments_field_index(T)) == body_root


def _commitments_field_index(T) -> int:
    # deneb and electra bodies both declare blob_kzg_commitments
    from ..specs.chain_spec import ForkName
    body = T.BeaconBlockBody[ForkName.DENEB]
    for i, (name, _t) in enumerate(body.__ssz_fields__.items()):
        if name == "blob_kzg_commitments":
            return i
    raise KeyError("blob_kzg_commitments")


def _fold_field(branch: list[bytes], node: bytes, field_index: int) -> bytes:
    for i, sib in enumerate(branch):
        if (field_index >> i) & 1:
            node = hash_concat(sib, node)
        else:
            node = hash_concat(node, sib)
    return node


# ---------------------------------------------------------------------------
# sidecar production + the checker
# ---------------------------------------------------------------------------

def produce_sidecars(T, signed_block, blobs: list[bytes], kzg) -> list:
    """Build verified BlobSidecars for a block (beacon chain side of
    blob publication)."""
    body = signed_block.message.body
    header = T.SignedBeaconBlockHeader(
        message=T.BeaconBlockHeader(
            slot=signed_block.message.slot,
            proposer_index=signed_block.message.proposer_index,
            parent_root=signed_block.message.parent_root,
            state_root=signed_block.message.state_root,
            body_root=htr(body)),
        signature=signed_block.signature)
    out = []
    for i, blob in enumerate(blobs):
        commitment = body.blob_kzg_commitments[i]
        proof = kzg.compute_blob_kzg_proof(blob, commitment)
        out.append(T.BlobSidecar(
            index=i, blob=blob, kzg_commitment=commitment,
            kzg_proof=proof, signed_block_header=header,
            kzg_commitment_inclusion_proof=commitment_inclusion_proof(
                T, body, i)))
    return out


@dataclass
class _PendingBlock:
    execution_pending: object
    needed: int
    sidecars: dict = field(default_factory=dict)
    slot: int = 0


class DataAvailabilityChecker:
    """Overflow-LRU of blocks awaiting blobs (data_availability_checker.rs)."""

    MAX_PENDING = 64

    def __init__(self, T, kzg=None):
        self.T = T
        self.kzg = kzg or FakeKzgVerifier()
        self._pending: dict[bytes, _PendingBlock] = {}
        self._lock = threading.Lock()

    def verify_sidecar(self, sidecar) -> bool:
        # index must be in range — the list-tree fold only consumes the low
        # bits, so unbounded indices would alias and bypass the gate
        if not 0 <= sidecar.index < \
                self.T.preset.max_blob_commitments_per_block:
            return False
        body_root = sidecar.signed_block_header.message.body_root
        if not verify_commitment_inclusion(self.T, sidecar, body_root):
            return False
        from ..obs import tracing
        with tracing.span("kzg_verify", index=int(sidecar.index)):
            return self.kzg.verify_blob_kzg_proof_batch(
                [bytes(sidecar.blob)], [sidecar.kzg_commitment],
                [sidecar.kzg_proof])

    def contains_sidecar(self, block_root: bytes, index: int) -> bool:
        with self._lock:
            entry = self._pending.get(block_root)
            return entry is not None and index in entry.sidecars

    def put_pending_block(self, block_root: bytes, execution_pending,
                          needed: int):
        """Returns the block if already complete, else parks it."""
        with self._lock:
            entry = self._pending.get(block_root)
            if entry is None:
                entry = _PendingBlock(execution_pending, needed)
                self._pending[block_root] = entry
                while len(self._pending) > self.MAX_PENDING:
                    self._pending.pop(next(iter(self._pending)))
            else:
                entry.execution_pending = execution_pending
                entry.needed = needed
            return self._take_if_complete(block_root)

    def put_sidecar(self, block_root: bytes, sidecar):
        """Returns a completed pending block when this sidecar finishes it."""
        if not self.verify_sidecar(sidecar):
            return None
        with self._lock:
            entry = self._pending.get(block_root)
            if entry is None:
                entry = _PendingBlock(None, 1 << 30)
                entry.slot = sidecar.signed_block_header.message.slot
                self._pending[block_root] = entry
                while len(self._pending) > self.MAX_PENDING:
                    self._pending.pop(next(iter(self._pending)))
            entry.sidecars[sidecar.index] = sidecar
            return self._take_if_complete(block_root)

    def _take_if_complete(self, block_root: bytes):
        entry = self._pending.get(block_root)
        if entry is None or entry.execution_pending is None:
            return None
        if len(entry.sidecars) >= entry.needed:
            self._pending.pop(block_root)
            return entry.execution_pending
        return None

    def prune(self, finalized_slot: int) -> None:
        with self._lock:
            for root in [r for r, e in self._pending.items()
                         if (e.execution_pending.signed_block.message.slot
                             if e.execution_pending is not None
                             else e.slot) <= finalized_slot]:
                self._pending.pop(root)
