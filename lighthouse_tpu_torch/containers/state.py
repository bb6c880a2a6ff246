"""Array-backed (SoA) BeaconState with device merkleization.

The reference keeps the BeaconState in `milhouse` persistent trees with lazy
tree-hash caches (consensus/types/src/beacon_state.rs:219-223,339-525 and
`update_tree_hash_cache` :2031-2046). This design instead keeps the big
per-validator columns as dense numpy arrays (structure of arrays), so that:

- epoch processing is vectorized array arithmetic,
- merkleization batches onto the CUDA hash-tree kernels (ops/sha256.py,
  ops/merkle_tree.py), whose incremental trees stay on the card,
- copies are O(bytes) memcpy of flat arrays, not object graphs.

Small scalar fields stay Python objects. A per-field root cache with explicit
dirty tracking plays the role of milhouse's lazily-flushed tree caches.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field as dfield
from typing import Any

import numpy as np

from ..specs.chain_spec import ChainSpec, ForkName
from ..specs.constants import JUSTIFICATION_BITS_LENGTH
from ..ssz import (
    Bitvector, List as SSZList, Root, Vector, hash_tree_root, htr,
    merkleize_chunks, mix_in_length, pack_bytes, serialize, uint8, uint64,
)
from ..ssz.codec import BYTES_PER_LENGTH_OFFSET, DeserializeError, deserialize
from ..utils.hash import ZERO_HASHES, hash_concat
from .core import Types, get_types
from .cow import CowColumn


def _np_bytes32_root(arr: np.ndarray, limit: int | None,
                     length: int | None = None) -> bytes:
    """Root of an (N, 32) uint8 array as Vector/List[Bytes32]."""
    from ..ops import sha256 as k
    n = arr.shape[0]
    leaves = (k.chunks_to_words(arr.tobytes()) if n
              else np.zeros((0, 8), np.uint32))
    root = k.root_bytes(
        k.merkleize_words(leaves, limit if limit else max(1, n)))
    if length is not None:
        root = mix_in_length(root, length)
    return root


def _np_uint_root(arr: np.ndarray, limit_chunks: int,
                  length: int | None = None) -> bytes:
    """Root of a packed little-endian uint array (uint64/uint8 columns)."""
    from ..ops import sha256 as k
    data = arr.tobytes()
    pad = (-len(data)) % 32
    if pad:
        data += b"\x00" * pad
    leaves = (k.chunks_to_words(data) if data
              else np.zeros((0, 8), np.uint32))
    root = k.root_bytes(k.merkleize_words(leaves, limit_chunks))
    if length is not None:
        root = mix_in_length(root, length)
    return root


@dataclass
class ValidatorView:
    """Scalar view of one validator (mirrors types::Validator)."""
    pubkey: bytes
    withdrawal_credentials: bytes
    effective_balance: int
    slashed: bool
    activation_eligibility_epoch: int
    activation_epoch: int
    exit_epoch: int
    withdrawable_epoch: int


class ValidatorRegistry:
    """SoA validator registry: one numpy column per field.

    Mutations go through setters that mark the root cache dirty — the
    array-oriented analog of milhouse's dirty-leaf tracking.
    """

    COLUMNS = ("pubkeys", "withdrawal_credentials", "effective_balance",
               "slashed", "activation_eligibility_epoch", "activation_epoch",
               "exit_epoch", "withdrawable_epoch")

    def __setattr__(self, name, value):
        # column rebinds (appends, epoch sweeps, test fixtures) land as
        # CoW columns so copy() is chunk-pointer work, not 128 MB memcpy
        if name in ValidatorRegistry.COLUMNS and \
                not isinstance(value, CowColumn):
            value = CowColumn(value)
        object.__setattr__(self, name, value)

    def __init__(self, n: int = 0):
        self.pubkeys = np.zeros((n, 48), dtype=np.uint8)
        self.withdrawal_credentials = np.zeros((n, 32), dtype=np.uint8)
        self.effective_balance = np.zeros(n, dtype=np.uint64)
        self.slashed = np.zeros(n, dtype=bool)
        self.activation_eligibility_epoch = np.zeros(n, dtype=np.uint64)
        self.activation_epoch = np.zeros(n, dtype=np.uint64)
        self.exit_epoch = np.zeros(n, dtype=np.uint64)
        self.withdrawable_epoch = np.zeros(n, dtype=np.uint64)
        self._dirty = True
        self._root_cache: bytes | None = None
        # device-resident incremental merkle tree (ops/merkle_tree): None =
        # rebuild everything; _dirty_rows tracks which validator rows need
        # re-encoding + a dirty-path rehash (milhouse-style O(diff) root)
        self._device_tree = None
        self._dirty_rows: set[int] | None = None

    def __len__(self) -> int:
        return self.pubkeys.shape[0]

    def mark_dirty(self, row: int | None = None) -> None:
        self._dirty = True
        if row is None:
            self._dirty_rows = None        # full rebuild
        elif self._dirty_rows is not None:
            self._dirty_rows.add(row)

    def mark_dirty_many(self, rows) -> None:
        """Vector form of mark_dirty for chunk-scatter column writes
        (effective-balance hysteresis sweep and friends)."""
        self._dirty = True
        if self._dirty_rows is not None:
            self._dirty_rows.update(
                np.unique(np.asarray(rows, np.int64)).tolist())

    def index_of(self, pubkey: bytes) -> int | None:
        """Pubkey -> validator index (the ValidatorPubkeyCache analog,
        beacon_chain/src/validator_pubkey_cache.rs:20)."""
        cache = getattr(self, "_pk_index", None)
        if cache is None or len(cache) != len(self):
            cache = {self.pubkeys[i].tobytes(): i for i in range(len(self))}
            self._pk_index = cache
        return cache.get(pubkey)

    def pubkey(self, i: int) -> bytes:
        return self.pubkeys[i].tobytes()

    def view(self, i: int) -> ValidatorView:
        return ValidatorView(
            pubkey=self.pubkeys[i].tobytes(),
            withdrawal_credentials=self.withdrawal_credentials[i].tobytes(),
            effective_balance=int(self.effective_balance[i]),
            slashed=bool(self.slashed[i]),
            activation_eligibility_epoch=int(
                self.activation_eligibility_epoch[i]),
            activation_epoch=int(self.activation_epoch[i]),
            exit_epoch=int(self.exit_epoch[i]),
            withdrawable_epoch=int(self.withdrawable_epoch[i]),
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self.view(i)

    def append(self, pubkey: bytes, withdrawal_credentials: bytes,
               effective_balance: int, slashed: bool,
               activation_eligibility_epoch: int, activation_epoch: int,
               exit_epoch: int, withdrawable_epoch: int) -> None:
        self.pubkeys = np.concatenate(
            [self.pubkeys, np.frombuffer(pubkey, np.uint8)[None]])
        self.withdrawal_credentials = np.concatenate(
            [self.withdrawal_credentials,
             np.frombuffer(withdrawal_credentials, np.uint8)[None]])
        for name, v in (("effective_balance", effective_balance),
                        ("activation_eligibility_epoch",
                         activation_eligibility_epoch),
                        ("activation_epoch", activation_epoch),
                        ("exit_epoch", exit_epoch),
                        ("withdrawable_epoch", withdrawable_epoch)):
            col = getattr(self, name)
            setattr(self, name, np.append(col, np.uint64(v)))
        self.slashed = np.append(self.slashed, bool(slashed))
        self.mark_dirty()

    def set_field(self, i: int, name: str, value) -> None:
        col = getattr(self, name)
        if name in ("pubkeys", "withdrawal_credentials"):
            col[i] = np.frombuffer(value, np.uint8)
        else:
            col[i] = value
        self.mark_dirty(int(i))

    def copy(self) -> "ValidatorRegistry":
        out = ValidatorRegistry.__new__(ValidatorRegistry)
        for c in self.COLUMNS:
            object.__setattr__(out, c, getattr(self, c).fork())
        out._dirty = self._dirty
        out._root_cache = self._root_cache
        # share the device tree, flagged so whichever copy updates next
        # copies the levels first (an in-place update would move the other
        # copy's root); dirty-row sets must not be shared
        out._device_tree = (self._device_tree.share()
                            if self._device_tree is not None else None)
        out._dirty_rows = (set(self._dirty_rows)
                           if self._dirty_rows is not None else None)
        # pubkeys are append-only and immutable per row, so the
        # pubkey->index dict stays valid for both sides (and is seconds
        # of rebuild at 1M validators) — share it
        pk = getattr(self, "_pk_index", None)
        if pk is not None:
            object.__setattr__(out, "_pk_index", pk)
        return out

    # -- merkleization -------------------------------------------------------

    def _u64_words(self, arr: np.ndarray) -> np.ndarray:
        n = len(self)
        return np.frombuffer(arr.astype("<u8").tobytes(),
                             dtype=">u4").reshape(n, 2).astype(np.uint32)

    def validator_leaf_words(self, rows: np.ndarray | None = None
                             ) -> tuple[np.ndarray, np.ndarray]:
        """(chunks u32[R*8, 8], pk_blocks u32[R, 16]): the 8 field chunks
        per validator with chunk 0 left zero, plus the 64-byte pubkey
        block whose hash fills it — hashed on DEVICE by the fold_pre
        kernel (ops/merkle_tree, with_pk=True), so no host<->device
        round trip per update."""
        def col(a):
            return a if rows is None else a[rows]

        n = len(self) if rows is None else len(rows)
        # pubkey root preimage: pubkey(48) || zeros(16) as one 64B block
        pk_blocks = np.zeros((n, 64), dtype=np.uint8)
        pk_blocks[:, :48] = col(self.pubkeys)
        pk_words = np.frombuffer(pk_blocks.tobytes(), dtype=">u4").reshape(
            n, 16).astype(np.uint32)
        chunks = np.zeros((n, 8, 8), dtype=np.uint32)
        chunks[:, 1] = np.frombuffer(
            np.ascontiguousarray(col(self.withdrawal_credentials)).tobytes(),
            dtype=">u4").reshape(n, 8).astype(np.uint32)

        def u64w(a):
            return np.frombuffer(
                np.ascontiguousarray(col(a)).astype("<u8").tobytes(),
                dtype=">u4").reshape(n, 2).astype(np.uint32)

        chunks[:, 2, :2] = u64w(self.effective_balance)
        chunks[:, 3, 0] = (col(self.slashed).astype(np.uint32) << 24)
        chunks[:, 4, :2] = u64w(self.activation_eligibility_epoch)
        chunks[:, 5, :2] = u64w(self.activation_epoch)
        chunks[:, 6, :2] = u64w(self.exit_epoch)
        chunks[:, 7, :2] = u64w(self.withdrawable_epoch)
        return chunks.reshape(n * 8, 8), pk_words

    def _device_root_words(self, registry_limit: int):
        """Incremental device tree root: full build when the tree is stale
        (size change / wholesale mutation), else a dirty-path update
        (ops/merkle_tree.DeviceTree: fold + scatter, O(dirty * depth)
        rehash, zero caps)."""
        from ..ops.merkle_tree import DeviceTree
        n = len(self)
        tree = self._device_tree
        if tree is None or self._dirty_rows is None or tree.n != n:
            tree = DeviceTree(n, registry_limit, pre_levels=3, with_pk=True)
            chunks, pk = self.validator_leaf_words()
            tree.build(chunks, pk)
            self._device_tree = tree
        elif self._dirty_rows:
            rows = np.fromiter(self._dirty_rows, dtype=np.int64)
            rows.sort()
            chunks, pk = self.validator_leaf_words(rows)
            tree.update(rows, chunks, pk)
        self._dirty_rows = set()
        return tree.root_words

    def hash_tree_root(self, registry_limit: int) -> bytes:
        if not self._dirty and self._root_cache is not None:
            return self._root_cache
        t0 = time.perf_counter()
        from ..ops import sha256 as k
        n = len(self)
        if n == 0:
            depth = (registry_limit - 1).bit_length()
            root = mix_in_length(ZERO_HASHES[depth], 0)
        else:
            root_words = self._device_root_words(registry_limit)
            root = mix_in_length(k.root_bytes(root_words), n)
        self._root_cache = root
        self._dirty = False
        m = sys.modules.get("lighthouse_tpu_torch.api.metrics")
        if m is not None:
            m.observe("validator_registry_tree_hash_seconds",
                      time.perf_counter() - t0)
        return root

    def serialize(self) -> bytes:
        """SSZ List[Validator] body: 121 bytes per validator, fixed size."""
        n = len(self)
        out = np.zeros((n, 121), dtype=np.uint8)
        out[:, 0:48] = self.pubkeys
        out[:, 48:80] = self.withdrawal_credentials
        out[:, 80:88] = np.frombuffer(
            self.effective_balance.astype("<u8").tobytes(),
            np.uint8).reshape(n, 8)
        out[:, 88] = self.slashed.astype(np.uint8)
        for off, name in ((89, "activation_eligibility_epoch"),
                          (97, "activation_epoch"), (105, "exit_epoch"),
                          (113, "withdrawable_epoch")):
            out[:, off:off + 8] = np.frombuffer(
                getattr(self, name).astype("<u8").tobytes(),
                np.uint8).reshape(n, 8)
        return out.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "ValidatorRegistry":
        if len(data) % 121:
            raise DeserializeError("validator registry size not multiple of 121")
        n = len(data) // 121
        arr = np.frombuffer(data, np.uint8).reshape(n, 121)
        out = cls(n)
        out.pubkeys = arr[:, 0:48].copy()
        out.withdrawal_credentials = arr[:, 48:80].copy()
        out.effective_balance = np.frombuffer(
            arr[:, 80:88].tobytes(), "<u8").copy()
        out.slashed = arr[:, 88].astype(bool)
        for off, name in ((89, "activation_eligibility_epoch"),
                          (97, "activation_epoch"), (105, "exit_epoch"),
                          (113, "withdrawable_epoch")):
            setattr(out, name, np.frombuffer(
                arr[:, off:off + 8].tobytes(), "<u8").copy())
        return out

    @classmethod
    def from_views(cls, views) -> "ValidatorRegistry":
        out = cls(0)
        for v in views:
            out.append(v.pubkey, v.withdrawal_credentials,
                       v.effective_balance, v.slashed,
                       v.activation_eligibility_epoch, v.activation_epoch,
                       v.exit_epoch, v.withdrawable_epoch)
        return out


# ---------------------------------------------------------------------------
# Field schema
# ---------------------------------------------------------------------------
# kind: 'ssz'      — generic SSZ value, type in `typ`
#       'ssz_list' — python list of containers, elem type in `typ`, limit
#       'roots_vec'— (N,32) uint8 numpy Vector[Root]
#       'roots_list'—(N,32) uint8 numpy List[Root] (limit)
#       'u64_vec'  — numpy uint64 Vector
#       'u64_list' — numpy uint64 List (limit)
#       'u8_list'  — numpy uint8 List (limit)  [participation flags]
#       'validators' — ValidatorRegistry

@dataclass
class FieldSpec:
    name: str
    kind: str
    typ: Any = None
    limit: int | None = None
    since: ForkName = ForkName.PHASE0
    until: ForkName | None = None  # exclusive


def state_field_specs(T: Types) -> list[FieldSpec]:
    p = T.preset
    F = ForkName
    vrl = p.validator_registry_limit
    return [
        FieldSpec("genesis_time", "ssz", uint64),
        FieldSpec("genesis_validators_root", "ssz", Root),
        FieldSpec("slot", "ssz", uint64),
        FieldSpec("fork", "ssz", T.Fork.ssz_type),
        FieldSpec("latest_block_header", "ssz", T.BeaconBlockHeader.ssz_type),
        FieldSpec("block_roots", "roots_vec", limit=p.slots_per_historical_root),
        FieldSpec("state_roots", "roots_vec", limit=p.slots_per_historical_root),
        FieldSpec("historical_roots", "roots_list",
                  limit=p.historical_roots_limit),
        FieldSpec("eth1_data", "ssz", T.Eth1Data.ssz_type),
        FieldSpec("eth1_data_votes", "ssz_list", T.Eth1Data.ssz_type,
                  limit=T.eth1_votes_limit),
        FieldSpec("eth1_deposit_index", "ssz", uint64),
        FieldSpec("validators", "validators", limit=vrl),
        FieldSpec("balances", "u64_list", limit=vrl),
        FieldSpec("randao_mixes", "roots_vec",
                  limit=p.epochs_per_historical_vector),
        FieldSpec("slashings", "u64_vec", limit=p.epochs_per_slashings_vector),
        FieldSpec("previous_epoch_attestations", "ssz_list",
                  T.PendingAttestation.ssz_type, limit=T.pending_att_limit,
                  until=F.ALTAIR),
        FieldSpec("current_epoch_attestations", "ssz_list",
                  T.PendingAttestation.ssz_type, limit=T.pending_att_limit,
                  until=F.ALTAIR),
        FieldSpec("previous_epoch_participation", "u8_list", limit=vrl,
                  since=F.ALTAIR),
        FieldSpec("current_epoch_participation", "u8_list", limit=vrl,
                  since=F.ALTAIR),
        FieldSpec("justification_bits", "ssz",
                  Bitvector(JUSTIFICATION_BITS_LENGTH)),
        FieldSpec("previous_justified_checkpoint", "ssz",
                  T.Checkpoint.ssz_type),
        FieldSpec("current_justified_checkpoint", "ssz",
                  T.Checkpoint.ssz_type),
        FieldSpec("finalized_checkpoint", "ssz", T.Checkpoint.ssz_type),
        FieldSpec("inactivity_scores", "u64_list", limit=vrl, since=F.ALTAIR),
        FieldSpec("current_sync_committee", "ssz", T.SyncCommittee.ssz_type,
                  since=F.ALTAIR),
        FieldSpec("next_sync_committee", "ssz", T.SyncCommittee.ssz_type,
                  since=F.ALTAIR),
        FieldSpec("latest_execution_payload_header", "payload_header",
                  since=F.BELLATRIX),
        FieldSpec("next_withdrawal_index", "ssz", uint64, since=F.CAPELLA),
        FieldSpec("next_withdrawal_validator_index", "ssz", uint64,
                  since=F.CAPELLA),
        FieldSpec("historical_summaries", "ssz_list",
                  T.HistoricalSummary.ssz_type,
                  limit=p.historical_roots_limit, since=F.CAPELLA),
        FieldSpec("deposit_requests_start_index", "ssz", uint64,
                  since=F.ELECTRA),
        FieldSpec("deposit_balance_to_consume", "ssz", uint64,
                  since=F.ELECTRA),
        FieldSpec("exit_balance_to_consume", "ssz", uint64, since=F.ELECTRA),
        FieldSpec("earliest_exit_epoch", "ssz", uint64, since=F.ELECTRA),
        FieldSpec("consolidation_balance_to_consume", "ssz", uint64,
                  since=F.ELECTRA),
        FieldSpec("earliest_consolidation_epoch", "ssz", uint64,
                  since=F.ELECTRA),
        FieldSpec("pending_deposits", "ssz_list", T.PendingDeposit.ssz_type,
                  limit=p.pending_deposits_limit, since=F.ELECTRA),
        FieldSpec("pending_partial_withdrawals", "ssz_list",
                  T.PendingPartialWithdrawal.ssz_type,
                  limit=p.pending_partial_withdrawals_limit, since=F.ELECTRA),
        FieldSpec("pending_consolidations", "ssz_list",
                  T.PendingConsolidation.ssz_type,
                  limit=p.pending_consolidations_limit, since=F.ELECTRA),
    ]


def active_field_specs(T: Types, fork: ForkName) -> list[FieldSpec]:
    return [f for f in state_field_specs(T)
            if f.since <= fork and (f.until is None or fork < f.until)]


# n-sized packed columns with incremental trees: field -> element dtype,
# bound as hashed CowColumns by __setattr__
_HASHED_COLUMNS = {
    "balances": np.uint64,
    "inactivity_scores": np.uint64,
    "previous_epoch_participation": np.uint8,
    "current_epoch_participation": np.uint8,
}

# fixed-length vector columns, CoW-wrapped (non-hashed) so copy() stays
# O(chunks) — randao_mixes alone is 2 MB/copy at mainnet shape; their
# roots remain full recomputes (_np_*_root) like before
_VEC_COLUMNS = {
    "block_roots": np.uint8,
    "state_roots": np.uint8,
    "randao_mixes": np.uint8,
    "slashings": np.uint64,
}


class BeaconState:
    """One class for all forks; fields outside the active fork are None.

    The balances column carries an incremental tree-hash cache (the
    update_tree_hash_cache discipline, reference consensus/types/src/
    beacon_state.rs:2031-2046): point mutations MUST go through
    ``increase_balance``/``decrease_balance`` (state_transition/helpers)
    or call ``mark_balances_dirty``; wholesale rebinds
    (``state.balances = arr``) are caught by ``__setattr__`` and trigger
    a full rebuild."""

    def __setattr__(self, name, value):
        if name in _HASHED_COLUMNS:
            # n-sized columns live as hashed CoW columns: writes through
            # the column API feed one dirty set for both copy and hash
            if value is not None and not isinstance(value, CowColumn):
                value = CowColumn(value, dtype=_HASHED_COLUMNS[name],
                                  hashed=True)
        elif name in _VEC_COLUMNS and value is not None and \
                not isinstance(value, CowColumn):
            value = CowColumn(value, dtype=_VEC_COLUMNS[name])
        object.__setattr__(self, name, value)

    def mark_balances_dirty(self, index: int) -> None:
        """Compatibility hook — writes through the column API already
        record themselves; keeps the discipline explicit at call sites."""
        col = self.balances
        if isinstance(col, CowColumn):
            col.mark_dirty(int(index))

    def mark_participation_dirty(self, indices, current: bool) -> None:
        """In-place participation-flag mutations (process_attestation)
        report the touched rows here, mirroring the balances
        discipline (idempotent over the column's own write tracking)."""
        col = (self.current_epoch_participation if current
               else self.previous_epoch_participation)
        if isinstance(col, CowColumn):
            col.mark_dirty_many(indices)

    def rotate_participation(self) -> None:
        """Epoch rotation: previous <- current (the CowColumn carries
        its primed incremental tree across, O(1)), current <- zeros."""
        self.previous_epoch_participation = self.current_epoch_participation
        self.current_epoch_participation = np.zeros(
            len(self.validators), np.uint8)

    def __init__(self, T: Types, spec: ChainSpec, fork_name: ForkName):
        self.T = T
        self.spec = spec
        self.fork_name = fork_name
        p = T.preset
        self.genesis_time = 0
        self.genesis_validators_root = b"\x00" * 32
        self.slot = 0
        self.fork = T.Fork()
        self.latest_block_header = T.BeaconBlockHeader()
        self.block_roots = np.zeros((p.slots_per_historical_root, 32),
                                    np.uint8)
        self.state_roots = np.zeros((p.slots_per_historical_root, 32),
                                    np.uint8)
        self.historical_roots: list[bytes] = []
        self.eth1_data = T.Eth1Data()
        self.eth1_data_votes: list = []
        self.eth1_deposit_index = 0
        self.validators = ValidatorRegistry()
        self.balances = np.zeros(0, np.uint64)
        self.randao_mixes = np.zeros((p.epochs_per_historical_vector, 32),
                                     np.uint8)
        self.slashings = np.zeros(p.epochs_per_slashings_vector, np.uint64)
        self.justification_bits = [False] * JUSTIFICATION_BITS_LENGTH
        self.previous_justified_checkpoint = T.Checkpoint()
        self.current_justified_checkpoint = T.Checkpoint()
        self.finalized_checkpoint = T.Checkpoint()
        # phase0
        self.previous_epoch_attestations: list | None = None
        self.current_epoch_attestations: list | None = None
        # altair+
        self.previous_epoch_participation: np.ndarray | None = None
        self.current_epoch_participation: np.ndarray | None = None
        self.inactivity_scores: np.ndarray | None = None
        self.current_sync_committee = None
        self.next_sync_committee = None
        # bellatrix+
        self.latest_execution_payload_header = None
        # capella+
        self.next_withdrawal_index = None
        self.next_withdrawal_validator_index = None
        self.historical_summaries: list | None = None
        # electra+
        self.deposit_requests_start_index = None
        self.deposit_balance_to_consume = None
        self.exit_balance_to_consume = None
        self.earliest_exit_epoch = None
        self.consolidation_balance_to_consume = None
        self.earliest_consolidation_epoch = None
        self.pending_deposits: list | None = None
        self.pending_partial_withdrawals: list | None = None
        self.pending_consolidations: list | None = None

        self._init_fork_fields(fork_name)

    def _init_fork_fields(self, fork: ForkName) -> None:
        F = ForkName
        T = self.T
        n = len(self.validators)
        if fork == F.PHASE0:
            self.previous_epoch_attestations = []
            self.current_epoch_attestations = []
        if fork >= F.ALTAIR:
            self.previous_epoch_attestations = None
            self.current_epoch_attestations = None
            if self.previous_epoch_participation is None:
                self.previous_epoch_participation = np.zeros(n, np.uint8)
                self.current_epoch_participation = np.zeros(n, np.uint8)
                self.inactivity_scores = np.zeros(n, np.uint64)
            if self.current_sync_committee is None:
                self.current_sync_committee = T.SyncCommittee()
                self.next_sync_committee = T.SyncCommittee()
        if fork >= F.BELLATRIX and self.latest_execution_payload_header is None:
            self.latest_execution_payload_header = \
                T.ExecutionPayloadHeader[max(fork, F.BELLATRIX)]()
        if fork >= F.CAPELLA and self.next_withdrawal_index is None:
            self.next_withdrawal_index = 0
            self.next_withdrawal_validator_index = 0
            self.historical_summaries = []
        if fork >= F.ELECTRA and self.deposit_requests_start_index is None:
            from ..specs.constants import UNSET_DEPOSIT_REQUESTS_START_INDEX
            self.deposit_requests_start_index = \
                UNSET_DEPOSIT_REQUESTS_START_INDEX
            self.deposit_balance_to_consume = 0
            self.exit_balance_to_consume = 0
            self.earliest_exit_epoch = 0
            self.consolidation_balance_to_consume = 0
            self.earliest_consolidation_epoch = 0
            self.pending_deposits = []
            self.pending_partial_withdrawals = []
            self.pending_consolidations = []

    # -- epoch helpers -------------------------------------------------------
    @property
    def slots_per_epoch(self) -> int:
        return self.T.preset.slots_per_epoch

    def current_epoch(self) -> int:
        return self.slot // self.slots_per_epoch

    def previous_epoch(self) -> int:
        cur = self.current_epoch()
        return cur - 1 if cur > 0 else 0

    def get_randao_mix(self, epoch: int) -> bytes:
        p = self.T.preset
        return self.randao_mixes[epoch % p.epochs_per_historical_vector].tobytes()

    def set_randao_mix(self, epoch: int, value: bytes) -> None:
        p = self.T.preset
        self.randao_mixes[epoch % p.epochs_per_historical_vector] = \
            np.frombuffer(value, np.uint8)

    def get_block_root_at_slot(self, slot: int) -> bytes:
        p = self.T.preset
        assert slot < self.slot <= slot + p.slots_per_historical_root
        return self.block_roots[slot % p.slots_per_historical_root].tobytes()

    def get_block_root(self, epoch: int) -> bytes:
        return self.get_block_root_at_slot(epoch * self.slots_per_epoch)

    # -- copy ----------------------------------------------------------------
    def copy(self) -> "BeaconState":
        t0 = time.perf_counter()
        out = BeaconState.__new__(BeaconState)
        out.T, out.spec, out.fork_name = self.T, self.spec, self.fork_name
        for f in active_field_specs(self.T, self.fork_name):
            v = getattr(self, f.name)
            if isinstance(v, CowColumn):
                v = v.fork()
            elif isinstance(v, np.ndarray):
                v = v.copy()
            elif isinstance(v, ValidatorRegistry):
                v = v.copy()
            elif isinstance(v, list):
                # ssz_list entries are frozen (the STF rebinds, never
                # mutates elements in place): share them, copy the spine
                v = list(v)
            elif hasattr(v, "copy") and not isinstance(v, (bytes, int)):
                v = v.copy()
            setattr(out, f.name, v)
        # fields not in the active fork
        for f in state_field_specs(self.T):
            if not hasattr(out, f.name):
                setattr(out, f.name, None)
        m = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
        if m is not None:
            m.observe("state_copy_seconds", time.perf_counter() - t0)
        return out

    # -- merkleization -------------------------------------------------------
    def _field_root(self, f: FieldSpec) -> bytes:
        v = getattr(self, f.name)
        if f.kind == "ssz":
            return hash_tree_root(f.typ, v)
        if f.kind == "payload_header":
            return htr(v)
        if f.kind == "ssz_list":
            roots = [hash_tree_root(f.typ, e) for e in v]
            return mix_in_length(merkleize_chunks(roots, f.limit), len(v))
        if f.kind == "roots_vec":
            return _np_bytes32_root(v, f.limit)
        if f.kind == "roots_list":
            arr = (np.frombuffer(b"".join(v), np.uint8).reshape(-1, 32)
                   if v else np.zeros((0, 32), np.uint8))
            return _np_bytes32_root(arr, f.limit, length=len(v))
        if f.kind == "u64_vec":
            return _np_uint_root(v, (f.limit * 8 + 31) // 32)
        if f.kind == "u64_list":
            if isinstance(v, CowColumn):
                # incremental root off the column's own dirty-leaf set —
                # the same bookkeeping its writes feed (no identity-keyed
                # cache invalidation anymore)
                return v.hash_tree_root(f.limit)
            return _np_uint_root(v, (f.limit * 8 + 31) // 32, length=len(v))
        if f.kind == "u8_list":
            if isinstance(v, CowColumn):
                return v.hash_tree_root(f.limit)
            return _np_uint_root(v, (f.limit + 31) // 32, length=len(v))
        if f.kind == "validators":
            return v.hash_tree_root(f.limit)
        raise TypeError(f.kind)

    def hash_tree_root(self) -> bytes:
        # graftscope: the state root is a north-star hot spot — every
        # computation lands in tree_hash_root_seconds and the active trace
        from ..obs import tracing
        with tracing.span("tree_hash", slot=int(self.slot)):
            specs = active_field_specs(self.T, self.fork_name)
            roots = [self._field_root(f) for f in specs]
            return merkleize_chunks(roots,
                                    1 << (len(roots) - 1).bit_length())

    # -- serialization -------------------------------------------------------
    def _field_serialize(self, f: FieldSpec) -> tuple[bytes, bool]:
        """Returns (payload, is_fixed)."""
        from ..ssz.codec import is_fixed_size
        v = getattr(self, f.name)
        if f.kind == "ssz":
            return serialize(f.typ, v), is_fixed_size(f.typ)
        if f.kind == "payload_header":
            t = type(v).ssz_type
            return serialize(t, v), is_fixed_size(t)
        if f.kind == "ssz_list":
            return serialize(SSZList(f.typ, f.limit), v), False
        if f.kind == "roots_vec":
            return v.tobytes(), True
        if f.kind == "roots_list":
            return b"".join(v), False
        if f.kind in ("u64_vec",):
            return v.astype("<u8").tobytes(), True
        if f.kind == "u64_list":
            return v.astype("<u8").tobytes(), False
        if f.kind == "u8_list":
            return v.astype(np.uint8).tobytes(), False
        if f.kind == "validators":
            return v.serialize(), False
        raise TypeError(f.kind)

    def serialize(self) -> bytes:
        parts = [self._field_serialize(f)
                 for f in active_field_specs(self.T, self.fork_name)]
        fixed_len = sum(len(p) if fixed else BYTES_PER_LENGTH_OFFSET
                        for p, fixed in parts)
        out = bytearray()
        offset = fixed_len
        for payload, fixed in parts:
            if fixed:
                out += payload
            else:
                out += offset.to_bytes(4, "little")
                offset += len(payload)
        for payload, fixed in parts:
            if not fixed:
                out += payload
        return bytes(out)

    @classmethod
    def from_ssz_bytes(cls, data: bytes, T: Types, spec: ChainSpec,
                       fork_name: ForkName) -> "BeaconState":
        from ..ssz.codec import is_fixed_size, fixed_size
        state = cls(T, spec, fork_name)
        specs = active_field_specs(T, fork_name)
        pos = 0
        fixed_items: list[tuple[FieldSpec, bytes | int]] = []
        offsets: list[int] = []
        for f in specs:
            if f.kind == "ssz":
                fixed = is_fixed_size(f.typ)
                size = fixed_size(f.typ) if fixed else None
            elif f.kind == "payload_header":
                t = type(getattr(state, f.name)).ssz_type
                fixed = is_fixed_size(t)
                size = fixed_size(t) if fixed else None
            elif f.kind in ("roots_vec",):
                fixed, size = True, f.limit * 32
            elif f.kind == "u64_vec":
                fixed, size = True, f.limit * 8
            else:
                fixed, size = False, None
            if fixed:
                fixed_items.append((f, data[pos:pos + size]))
                pos += size
            else:
                off = int.from_bytes(data[pos:pos + 4], "little")
                fixed_items.append((f, off))
                offsets.append(off)
                pos += 4
        offsets.append(len(data))
        oi = 0
        for f, raw in fixed_items:
            if isinstance(raw, int):
                chunk = data[offsets[oi]:offsets[oi + 1]]
                oi += 1
            else:
                chunk = raw
            cls._field_deserialize(state, f, chunk)
        return state

    @staticmethod
    def _field_deserialize(state: "BeaconState", f: FieldSpec,
                           data: bytes) -> None:
        if f.kind == "ssz":
            setattr(state, f.name, deserialize(f.typ, data))
        elif f.kind == "payload_header":
            t = type(getattr(state, f.name)).ssz_type
            setattr(state, f.name, deserialize(t, data))
        elif f.kind == "ssz_list":
            setattr(state, f.name,
                    deserialize(SSZList(f.typ, f.limit), data))
        elif f.kind == "roots_vec":
            setattr(state, f.name,
                    np.frombuffer(data, np.uint8).reshape(-1, 32).copy())
        elif f.kind == "roots_list":
            setattr(state, f.name,
                    [data[i:i + 32] for i in range(0, len(data), 32)])
        elif f.kind == "u64_vec":
            setattr(state, f.name, np.frombuffer(data, "<u8").copy())
        elif f.kind == "u64_list":
            setattr(state, f.name, np.frombuffer(data, "<u8").copy())
        elif f.kind == "u8_list":
            setattr(state, f.name, np.frombuffer(data, np.uint8).copy())
        elif f.kind == "validators":
            setattr(state, f.name, ValidatorRegistry.from_bytes(data))
        else:
            raise TypeError(f.kind)


def new_state(spec: ChainSpec, fork_name: ForkName = ForkName.PHASE0
              ) -> BeaconState:
    return BeaconState(get_types(spec.preset), spec, fork_name)
