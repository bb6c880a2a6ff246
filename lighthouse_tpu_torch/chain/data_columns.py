"""PeerDAS data-column sidecars (fulu machinery).

Equivalent of consensus/types/src/data_column_sidecar.rs,
data_column_subnet_id.rs, and beacon_chain/src/data_column_verification.rs:
column construction from the Reed-Solomon-extended blobs (crypto/kzg.py
`compute_cells_and_kzg_proofs`), per-cell KZG proofs, the commitments-list
inclusion proof, subnet mapping, spec custody assignment, gossip
verification (header signature via the chain's sidecar path + cell-proof
batch + shape checks), and blob reconstruction from any 50% of columns
(`recover_cells_and_kzg_proofs`).

The first NUMBER_OF_COLUMNS/2 cells of the extension are the blob itself
(systematic RS code), so reconstruction needs either the full systematic
half or, with a real KZG, any half of the columns.
"""
from __future__ import annotations

import hashlib

from ..specs.constants import (
    CUSTODY_REQUIREMENT, DATA_COLUMN_SIDECAR_SUBNET_COUNT,
    KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH, NUMBER_OF_COLUMNS,
)
from ..ssz import hash_tree_root, htr
from ..utils.hash import ZERO_HASHES, hash_concat
from .data_availability import (
    _body_field_layers, _commitments_field_index, _fold_field,
)


def cell_size(T) -> int:
    """Bytes per cell of the 2x-extended blob (spec BYTES_PER_CELL)."""
    return 64 * T.preset.field_elements_per_blob // NUMBER_OF_COLUMNS


def blobs_to_columns(
        T, blobs: list[bytes], kzg
) -> tuple[list[list[bytes]], list[list[bytes]]]:
    """Column j = [cell_j(extended blob_i) for each blob i] (row-major
    blobs -> column-major cells).  Returns (columns, proof_columns)."""
    cells_rows, proof_rows = [], []
    for blob in blobs:
        cells, proofs = kzg.compute_cells_and_kzg_proofs(bytes(blob))
        if len(cells) != NUMBER_OF_COLUMNS:
            raise ValueError(
                f"KZG setup produces {len(cells)} cells per extended "
                f"blob; the sidecar machinery needs {NUMBER_OF_COLUMNS}")
        cells_rows.append(cells)
        proof_rows.append(proofs)
    cols = [[cells_rows[b][j] for b in range(len(blobs))]
            for j in range(NUMBER_OF_COLUMNS)]
    proof_cols = [[proof_rows[b][j] for b in range(len(blobs))]
                  for j in range(NUMBER_OF_COLUMNS)]
    return cols, proof_cols


def commitments_list_proof(T, body) -> list[bytes]:
    """Branch proving the WHOLE blob_kzg_commitments list root within the
    body root (depth KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH)."""
    fields, roots = _body_field_layers(T, body)
    field_index = _commitments_field_index(T)
    branch = []
    nodes = list(roots)
    idx = field_index
    n_leaves = 1 << KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH
    nodes += [ZERO_HASHES[0]] * (n_leaves - len(nodes))
    for d in range(KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH):
        branch.append(nodes[idx ^ 1])
        nodes = [hash_concat(nodes[i], nodes[i + 1])
                 for i in range(0, len(nodes), 2)]
        idx //= 2
    return branch


def verify_commitments_inclusion(T, sidecar, body_root: bytes) -> bool:
    from ..ssz import List as SSZList, Bytes48
    limit = T.preset.max_blob_commitments_per_block
    node = hash_tree_root(SSZList(Bytes48, limit),
                          list(sidecar.kzg_commitments))
    branch = [bytes(s) for s in sidecar.kzg_commitments_inclusion_proof]
    return _fold_field(branch, node, _commitments_field_index(T)) == \
        body_root


def produce_data_column_sidecars(T, signed_block, blobs: list[bytes],
                                 kzg) -> list:
    """All NUMBER_OF_COLUMNS sidecars for a block's blobs."""
    body = signed_block.message.body
    header = T.SignedBeaconBlockHeader(
        message=T.BeaconBlockHeader(
            slot=signed_block.message.slot,
            proposer_index=signed_block.message.proposer_index,
            parent_root=signed_block.message.parent_root,
            state_root=signed_block.message.state_root,
            body_root=htr(body)),
        signature=signed_block.signature)
    commitments = list(body.blob_kzg_commitments)
    proof = commitments_list_proof(T, body)
    columns, proof_cols = blobs_to_columns(T, blobs, kzg)
    return [T.DataColumnSidecar(
        index=j, column=columns[j], kzg_commitments=commitments,
        kzg_proofs=proof_cols[j], signed_block_header=header,
        kzg_commitments_inclusion_proof=proof)
        for j in range(NUMBER_OF_COLUMNS)]


def verify_data_column_sidecar(T, sidecar) -> bool:
    """Structural gossip checks (data_column_verification.rs): index
    range, equal lengths, non-empty, inclusion proof against the header's
    body root.  The header SIGNATURE check lives in the chain (shared
    with blob sidecars)."""
    if sidecar.index >= NUMBER_OF_COLUMNS:
        return False
    if not (len(sidecar.column) == len(sidecar.kzg_commitments)
            == len(sidecar.kzg_proofs)) or not len(sidecar.column):
        return False
    body_root = sidecar.signed_block_header.message.body_root
    return verify_commitments_inclusion(T, sidecar, body_root)


def compute_subnet_for_column(index: int) -> int:
    return index % DATA_COLUMN_SIDECAR_SUBNET_COUNT


def get_custody_columns(node_id: bytes,
                        custody_subnet_count: int = CUSTODY_REQUIREMENT
                        ) -> list[int]:
    """Spec get_custody_columns: walk hashes of (node_id + i) until
    custody_subnet_count distinct subnets are drawn, then take every
    column mapping to those subnets."""
    assert custody_subnet_count <= DATA_COLUMN_SIDECAR_SUBNET_COUNT
    subnets: set[int] = set()
    i = 0
    nid = int.from_bytes(node_id[:32].rjust(32, b"\x00"), "big")
    while len(subnets) < custody_subnet_count:
        h = hashlib.sha256(
            ((nid + i) % 2**256).to_bytes(32, "little")).digest()
        subnets.add(int.from_bytes(h[:8], "little")
                    % DATA_COLUMN_SIDECAR_SUBNET_COUNT)
        i += 1
    return sorted(c for c in range(NUMBER_OF_COLUMNS)
                  if compute_subnet_for_column(c) in subnets)


def verify_data_column_sidecar_kzg(T, sidecar, kzg) -> bool:
    """Batch cell-proof check for every row of the column
    (data_column_verification.rs verify_kzg_for_data_column)."""
    n = len(sidecar.column)
    try:
        return kzg.verify_cell_kzg_proof_batch(
            [bytes(c) for c in sidecar.kzg_commitments],
            [int(sidecar.index)] * n,
            [bytes(c) for c in sidecar.column],
            [bytes(p) for p in sidecar.kzg_proofs])
    except Exception:
        return False   # e.g. a setup without cell support: fail closed


def reconstruct_blobs(T, sidecars: list, kzg=None) -> list[bytes]:
    """Rebuild the blobs from columns.

    The code is systematic: the first half of the columns IS the blob
    data, so with all of columns [0, N/2) present no erasure decoding is
    needed.  With a real KZG any >= 50% of columns recovers the rest
    (spec recover_cells_and_kzg_proofs); without one (fake crypto), the
    full systematic half is required.
    """
    by_index = {int(s.index): s for s in sidecars}
    if not by_index:
        raise ValueError("no columns")
    half = NUMBER_OF_COLUMNS // 2
    n_blobs = len(next(iter(by_index.values())).column)
    if all(j in by_index for j in range(half)):
        return [b"".join(bytes(by_index[j].column[i]) for j in range(half))
                for i in range(n_blobs)]
    if kzg is None or not hasattr(kzg, "recover_cells_and_kzg_proofs"):
        missing = [j for j in range(half) if j not in by_index]
        raise ValueError(
            f"systematic columns missing ({missing[:8]}...) and no "
            f"erasure-capable KZG provided")
    if len(by_index) < half:
        raise ValueError(
            f"need >= {half} columns to erasure-recover; have "
            f"{len(by_index)}")
    idxs = sorted(by_index)
    blobs = []
    for i in range(n_blobs):
        cells = [bytes(by_index[j].column[i]) for j in idxs]
        blobs.append(kzg.recover_blob(idxs, cells))
    return blobs
