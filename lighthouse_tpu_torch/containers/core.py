"""Container class factory, parameterized by preset.

Field orders are root-determining; they follow the consensus specs exactly
(reference: consensus/types/src/*.rs per-fork superstruct variants).

NOTE: no `from __future__ import annotations` here — the @container decorator
reads SSZ type *instances* out of __annotations__, so they must not be
stringified.
"""
import functools
from types import SimpleNamespace

from ..specs.chain_spec import ForkName
from ..specs.constants import (
    BYTES_PER_FIELD_ELEMENT, DEPOSIT_CONTRACT_TREE_DEPTH,
    JUSTIFICATION_BITS_LENGTH, SYNC_COMMITTEE_SUBNET_COUNT,
)
from ..specs.presets import Preset
from ..ssz import (
    Bitlist, Bitvector, ByteList, ByteVector, Bytes4, Bytes20, Bytes32,
    Bytes48, Bytes96, List, Root, Vector, boolean, container, uint8, uint64,
    uint256,
)

Types = SimpleNamespace


def get_types(preset: Preset) -> Types:
    return _build_types_cached(preset.name, preset)


@functools.lru_cache(maxsize=8)
def _build_types_cached(name: str, preset: Preset) -> Types:
    return _build_types(preset)


def _build_types(p: Preset) -> Types:
    T = SimpleNamespace(preset=p)

    # -- misc dependent sizes ------------------------------------------------
    max_validators_per_slot = (p.max_validators_per_committee
                               * p.max_committees_per_slot)
    eth1_votes_limit = p.epochs_per_eth1_voting_period * p.slots_per_epoch
    pending_att_limit = p.max_attestations * p.slots_per_epoch

    # -- fork-independent ----------------------------------------------------
    @container
    class Fork:
        previous_version: Bytes4
        current_version: Bytes4
        epoch: uint64

    @container
    class ForkData:
        current_version: Bytes4
        genesis_validators_root: Root

    @container
    class Checkpoint:
        epoch: uint64
        root: Root

    @container
    class Validator:
        pubkey: Bytes48
        withdrawal_credentials: Bytes32
        effective_balance: uint64
        slashed: boolean
        activation_eligibility_epoch: uint64
        activation_epoch: uint64
        exit_epoch: uint64
        withdrawable_epoch: uint64

    @container
    class AttestationData:
        slot: uint64
        index: uint64
        beacon_block_root: Root
        source: Checkpoint.ssz_type
        target: Checkpoint.ssz_type

    @container
    class IndexedAttestation:
        attesting_indices: List(uint64, p.max_validators_per_committee)
        data: AttestationData.ssz_type
        signature: Bytes96

    @container
    class IndexedAttestationElectra:
        attesting_indices: List(uint64, max_validators_per_slot)
        data: AttestationData.ssz_type
        signature: Bytes96

    @container
    class PendingAttestation:
        aggregation_bits: Bitlist(p.max_validators_per_committee)
        data: AttestationData.ssz_type
        inclusion_delay: uint64
        proposer_index: uint64

    @container
    class Eth1Data:
        deposit_root: Root
        deposit_count: uint64
        block_hash: Bytes32

    @container
    class HistoricalBatch:
        block_roots: Vector(Root, p.slots_per_historical_root)
        state_roots: Vector(Root, p.slots_per_historical_root)

    @container
    class HistoricalSummary:
        block_summary_root: Root
        state_summary_root: Root

    @container
    class DepositMessage:
        pubkey: Bytes48
        withdrawal_credentials: Bytes32
        amount: uint64

    @container
    class DepositData:
        pubkey: Bytes48
        withdrawal_credentials: Bytes32
        amount: uint64
        signature: Bytes96

    @container
    class Deposit:
        proof: Vector(Bytes32, DEPOSIT_CONTRACT_TREE_DEPTH + 1)
        data: DepositData.ssz_type

    @container
    class BeaconBlockHeader:
        slot: uint64
        proposer_index: uint64
        parent_root: Root
        state_root: Root
        body_root: Root

    @container
    class SignedBeaconBlockHeader:
        message: BeaconBlockHeader.ssz_type
        signature: Bytes96

    @container
    class ProposerSlashing:
        signed_header_1: SignedBeaconBlockHeader.ssz_type
        signed_header_2: SignedBeaconBlockHeader.ssz_type

    @container
    class AttesterSlashing:
        attestation_1: IndexedAttestation.ssz_type
        attestation_2: IndexedAttestation.ssz_type

    @container
    class AttesterSlashingElectra:
        attestation_1: IndexedAttestationElectra.ssz_type
        attestation_2: IndexedAttestationElectra.ssz_type

    @container
    class Attestation:
        aggregation_bits: Bitlist(p.max_validators_per_committee)
        data: AttestationData.ssz_type
        signature: Bytes96

    @container
    class AttestationElectra:
        aggregation_bits: Bitlist(max_validators_per_slot)
        data: AttestationData.ssz_type
        signature: Bytes96
        committee_bits: Bitvector(p.max_committees_per_slot)

    @container
    class VoluntaryExit:
        epoch: uint64
        validator_index: uint64

    @container
    class SignedVoluntaryExit:
        message: VoluntaryExit.ssz_type
        signature: Bytes96

    @container
    class SigningData:
        object_root: Root
        domain: Bytes32

    @container
    class SyncAggregate:
        sync_committee_bits: Bitvector(p.sync_committee_size)
        sync_committee_signature: Bytes96

    @container
    class SyncCommittee:
        pubkeys: Vector(Bytes48, p.sync_committee_size)
        aggregate_pubkey: Bytes48

    @container
    class SyncCommitteeMessage:
        slot: uint64
        beacon_block_root: Root
        validator_index: uint64
        signature: Bytes96

    @container
    class SyncCommitteeContribution:
        slot: uint64
        beacon_block_root: Root
        subcommittee_index: uint64
        aggregation_bits: Bitvector(p.sync_committee_size
                                    // SYNC_COMMITTEE_SUBNET_COUNT)
        signature: Bytes96

    @container
    class ContributionAndProof:
        aggregator_index: uint64
        contribution: SyncCommitteeContribution.ssz_type
        selection_proof: Bytes96

    @container
    class SignedContributionAndProof:
        message: ContributionAndProof.ssz_type
        signature: Bytes96

    @container
    class SyncAggregatorSelectionData:
        slot: uint64
        subcommittee_index: uint64

    @container
    class Withdrawal:
        index: uint64
        validator_index: uint64
        address: Bytes20
        amount: uint64

    @container
    class BLSToExecutionChange:
        validator_index: uint64
        from_bls_pubkey: Bytes48
        to_execution_address: Bytes20

    @container
    class SignedBLSToExecutionChange:
        message: BLSToExecutionChange.ssz_type
        signature: Bytes96

    # -- electra operations --------------------------------------------------
    @container
    class DepositRequest:
        pubkey: Bytes48
        withdrawal_credentials: Bytes32
        amount: uint64
        signature: Bytes96
        index: uint64

    @container
    class WithdrawalRequest:
        source_address: Bytes20
        validator_pubkey: Bytes48
        amount: uint64

    @container
    class ConsolidationRequest:
        source_address: Bytes20
        source_pubkey: Bytes48
        target_pubkey: Bytes48

    @container
    class ExecutionRequests:
        deposits: List(DepositRequest.ssz_type,
                       p.max_deposit_requests_per_payload)
        withdrawals: List(WithdrawalRequest.ssz_type,
                          p.max_withdrawal_requests_per_payload)
        consolidations: List(ConsolidationRequest.ssz_type,
                             p.max_consolidation_requests_per_payload)

    @container
    class PendingDeposit:
        pubkey: Bytes48
        withdrawal_credentials: Bytes32
        amount: uint64
        signature: Bytes96
        slot: uint64

    @container
    class PendingPartialWithdrawal:
        validator_index: uint64
        amount: uint64
        withdrawable_epoch: uint64

    @container
    class PendingConsolidation:
        source_index: uint64
        target_index: uint64

    # -- execution payloads (per fork) ---------------------------------------
    Transactions = List(ByteList(p.max_bytes_per_transaction),
                        p.max_transactions_per_payload)

    payload_base = dict(
        parent_hash=Bytes32, fee_recipient=Bytes20, state_root=Bytes32,
        receipts_root=Bytes32, logs_bloom=ByteVector(p.bytes_per_logs_bloom),
        prev_randao=Bytes32, block_number=uint64, gas_limit=uint64,
        gas_used=uint64, timestamp=uint64,
        extra_data=ByteList(p.max_extra_data_bytes),
        base_fee_per_gas=uint256, block_hash=Bytes32,
    )

    def payload_cls(cls_name: str, extra: dict):
        ns = dict(payload_base); ns.update(extra)
        cls = type(cls_name, (), {"__annotations__": ns})
        return container(cls)

    ExecutionPayloadBellatrix = payload_cls(
        "ExecutionPayloadBellatrix", dict(transactions=Transactions))
    ExecutionPayloadCapella = payload_cls(
        "ExecutionPayloadCapella",
        dict(transactions=Transactions,
             withdrawals=List(Withdrawal.ssz_type,
                              p.max_withdrawals_per_payload)))
    ExecutionPayloadDeneb = payload_cls(
        "ExecutionPayloadDeneb",
        dict(transactions=Transactions,
             withdrawals=List(Withdrawal.ssz_type,
                              p.max_withdrawals_per_payload),
             blob_gas_used=uint64, excess_blob_gas=uint64))

    header_extra = dict(transactions_root=Root)
    ExecutionPayloadHeaderBellatrix = payload_cls(
        "ExecutionPayloadHeaderBellatrix", dict(transactions_root=Root))
    ExecutionPayloadHeaderCapella = payload_cls(
        "ExecutionPayloadHeaderCapella",
        dict(transactions_root=Root, withdrawals_root=Root))
    ExecutionPayloadHeaderDeneb = payload_cls(
        "ExecutionPayloadHeaderDeneb",
        dict(transactions_root=Root, withdrawals_root=Root,
             blob_gas_used=uint64, excess_blob_gas=uint64))

    ExecutionPayload = {
        ForkName.BELLATRIX: ExecutionPayloadBellatrix,
        ForkName.CAPELLA: ExecutionPayloadCapella,
        ForkName.DENEB: ExecutionPayloadDeneb,
        ForkName.ELECTRA: ExecutionPayloadDeneb,
    }
    ExecutionPayloadHeader = {
        ForkName.BELLATRIX: ExecutionPayloadHeaderBellatrix,
        ForkName.CAPELLA: ExecutionPayloadHeaderCapella,
        ForkName.DENEB: ExecutionPayloadHeaderDeneb,
        ForkName.ELECTRA: ExecutionPayloadHeaderDeneb,
    }

    # -- block bodies / blocks per fork --------------------------------------
    body_phase0 = dict(
        randao_reveal=Bytes96, eth1_data=Eth1Data.ssz_type,
        graffiti=Bytes32,
        proposer_slashings=List(ProposerSlashing.ssz_type,
                                p.max_proposer_slashings),
        attester_slashings=List(AttesterSlashing.ssz_type,
                                p.max_attester_slashings),
        attestations=List(Attestation.ssz_type, p.max_attestations),
        deposits=List(Deposit.ssz_type, p.max_deposits),
        voluntary_exits=List(SignedVoluntaryExit.ssz_type,
                             p.max_voluntary_exits),
    )

    def body_cls(cls_name, extra):
        ns = dict(body_phase0); ns.update(extra)
        return container(type(cls_name, (), {"__annotations__": ns}))

    BeaconBlockBodyPhase0 = body_cls("BeaconBlockBodyPhase0", {})
    BeaconBlockBodyAltair = body_cls(
        "BeaconBlockBodyAltair",
        dict(sync_aggregate=SyncAggregate.ssz_type))
    BeaconBlockBodyBellatrix = body_cls(
        "BeaconBlockBodyBellatrix",
        dict(sync_aggregate=SyncAggregate.ssz_type,
             execution_payload=ExecutionPayloadBellatrix.ssz_type))
    BeaconBlockBodyCapella = body_cls(
        "BeaconBlockBodyCapella",
        dict(sync_aggregate=SyncAggregate.ssz_type,
             execution_payload=ExecutionPayloadCapella.ssz_type,
             bls_to_execution_changes=List(
                 SignedBLSToExecutionChange.ssz_type,
                 p.max_bls_to_execution_changes)))
    BeaconBlockBodyDeneb = body_cls(
        "BeaconBlockBodyDeneb",
        dict(sync_aggregate=SyncAggregate.ssz_type,
             execution_payload=ExecutionPayloadDeneb.ssz_type,
             bls_to_execution_changes=List(
                 SignedBLSToExecutionChange.ssz_type,
                 p.max_bls_to_execution_changes),
             blob_kzg_commitments=List(Bytes48,
                                       p.max_blob_commitments_per_block)))
    electra_ns = dict(body_phase0)
    electra_ns.update(
        attester_slashings=List(AttesterSlashingElectra.ssz_type,
                                p.max_attester_slashings_electra),
        attestations=List(AttestationElectra.ssz_type,
                          p.max_attestations_electra),
        sync_aggregate=SyncAggregate.ssz_type,
        execution_payload=ExecutionPayloadDeneb.ssz_type,
        bls_to_execution_changes=List(SignedBLSToExecutionChange.ssz_type,
                                      p.max_bls_to_execution_changes),
        blob_kzg_commitments=List(Bytes48, p.max_blob_commitments_per_block),
        execution_requests=ExecutionRequests.ssz_type,
    )
    BeaconBlockBodyElectra = container(
        type("BeaconBlockBodyElectra", (), {"__annotations__": electra_ns}))

    BeaconBlockBody = {
        ForkName.PHASE0: BeaconBlockBodyPhase0,
        ForkName.ALTAIR: BeaconBlockBodyAltair,
        ForkName.BELLATRIX: BeaconBlockBodyBellatrix,
        ForkName.CAPELLA: BeaconBlockBodyCapella,
        ForkName.DENEB: BeaconBlockBodyDeneb,
        ForkName.ELECTRA: BeaconBlockBodyElectra,
    }

    BeaconBlock = {}
    SignedBeaconBlock = {}
    for fork, body in BeaconBlockBody.items():
        blk = container(type(f"BeaconBlock{fork.name.title()}", (), {
            "__annotations__": dict(
                slot=uint64, proposer_index=uint64, parent_root=Root,
                state_root=Root, body=body.ssz_type)}))
        sblk = container(type(f"SignedBeaconBlock{fork.name.title()}", (), {
            "__annotations__": dict(message=blk.ssz_type,
                                    signature=Bytes96)}))
        blk.fork_name = fork
        sblk.fork_name = fork
        BeaconBlock[fork] = blk
        SignedBeaconBlock[fork] = sblk

    # -- blinded blocks (builder/MEV flow) -----------------------------------
    # Same bodies with execution_payload swapped IN PLACE for its header
    # (field order preserved => identical merkleization up to that leaf),
    # matching the reference's BlindedPayload variants
    # (consensus/types/src/payload.rs; execution_layer/src/lib.rs:807).
    BlindedBeaconBlockBody = {}
    BlindedBeaconBlock = {}
    SignedBlindedBeaconBlock = {}
    for fork, body in BeaconBlockBody.items():
        if fork < ForkName.BELLATRIX:
            continue
        ns = {}
        for fname, ftyp in body.__ssz_fields__.items():
            if fname == "execution_payload":
                ns["execution_payload_header"] = \
                    ExecutionPayloadHeader[fork].ssz_type
            else:
                ns[fname] = ftyp
        bbody = container(type(
            f"BlindedBeaconBlockBody{fork.name.title()}", (),
            {"__annotations__": ns}))
        bblk = container(type(f"BlindedBeaconBlock{fork.name.title()}", (), {
            "__annotations__": dict(
                slot=uint64, proposer_index=uint64, parent_root=Root,
                state_root=Root, body=bbody.ssz_type)}))
        sbblk = container(type(
            f"SignedBlindedBeaconBlock{fork.name.title()}", (), {
                "__annotations__": dict(message=bblk.ssz_type,
                                        signature=Bytes96)}))
        bbody.fork_name = bblk.fork_name = sbblk.fork_name = fork
        BlindedBeaconBlockBody[fork] = bbody
        BlindedBeaconBlock[fork] = bblk
        SignedBlindedBeaconBlock[fork] = sbblk

    # -- aggregation wrappers ------------------------------------------------
    @container
    class AggregateAndProof:
        aggregator_index: uint64
        aggregate: Attestation.ssz_type
        selection_proof: Bytes96

    @container
    class SignedAggregateAndProof:
        message: AggregateAndProof.ssz_type
        signature: Bytes96

    @container
    class AggregateAndProofElectra:
        aggregator_index: uint64
        aggregate: AttestationElectra.ssz_type
        selection_proof: Bytes96

    @container
    class SignedAggregateAndProofElectra:
        message: AggregateAndProofElectra.ssz_type
        signature: Bytes96

    # -- deneb blobs ---------------------------------------------------------
    Blob = ByteVector(BYTES_PER_FIELD_ELEMENT * p.field_elements_per_blob)

    @container
    class BlobSidecar:
        index: uint64
        blob: Blob
        kzg_commitment: Bytes48
        kzg_proof: Bytes48
        signed_block_header: SignedBeaconBlockHeader.ssz_type
        kzg_commitment_inclusion_proof: Vector(
            Bytes32, p.kzg_commitment_inclusion_proof_depth)

    @container
    class BlobIdentifier:
        block_root: Root
        index: uint64

    # -- PeerDAS data columns (fulu; types/src/data_column_sidecar.rs) -------
    # A cell is one column-slice of a blob: field_elements_per_blob /
    # NUMBER_OF_COLUMNS field elements (no RS extension in this miniature —
    # documented in chain/data_columns.py).
    from ..specs.constants import (
        KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH, NUMBER_OF_COLUMNS,
    )
    # cell of the 2x RS-extended blob (spec BYTES_PER_CELL)
    Cell = ByteVector(64 * p.field_elements_per_blob
                      // NUMBER_OF_COLUMNS)

    @container
    class DataColumnSidecar:
        index: uint64
        column: List(Cell, p.max_blob_commitments_per_block)
        kzg_commitments: List(Bytes48, p.max_blob_commitments_per_block)
        kzg_proofs: List(Bytes48, p.max_blob_commitments_per_block)
        signed_block_header: SignedBeaconBlockHeader.ssz_type
        kzg_commitments_inclusion_proof: Vector(
            Bytes32, KZG_COMMITMENTS_INCLUSION_PROOF_DEPTH)

    @container
    class DataColumnIdentifier:
        block_root: Root
        index: uint64

    # -- light client (altair wire forms; branches at the altair..deneb
    # generalized-index depths — current_sync_committee gindex 54 (depth
    # 5), finalized_root gindex 105 (depth 6); types/src/light_client_*.rs)
    @container
    class LightClientHeader:
        beacon: BeaconBlockHeader.ssz_type

    @container
    class SyncCommitteeUpdate:
        next_sync_committee: SyncCommittee.ssz_type
        next_sync_committee_branch: Vector(Bytes32, 5)

    @container
    class LightClientBootstrap:
        header: LightClientHeader.ssz_type
        current_sync_committee: SyncCommittee.ssz_type
        current_sync_committee_branch: Vector(Bytes32, 5)

    @container
    class LightClientUpdate:
        attested_header: LightClientHeader.ssz_type
        next_sync_committee: SyncCommittee.ssz_type
        next_sync_committee_branch: Vector(Bytes32, 5)
        finalized_header: LightClientHeader.ssz_type
        finality_branch: Vector(Bytes32, 6)
        sync_aggregate: SyncAggregate.ssz_type
        signature_slot: uint64

    @container
    class LightClientFinalityUpdate:
        attested_header: LightClientHeader.ssz_type
        finalized_header: LightClientHeader.ssz_type
        finality_branch: Vector(Bytes32, 6)
        sync_aggregate: SyncAggregate.ssz_type
        signature_slot: uint64

    @container
    class LightClientOptimisticUpdate:
        attested_header: LightClientHeader.ssz_type
        sync_aggregate: SyncAggregate.ssz_type
        signature_slot: uint64

    # -- export everything ---------------------------------------------------
    ns = dict(locals())
    for k, v in ns.items():
        if k not in ("T", "p", "ns", "payload_cls", "body_cls",
                     "payload_base", "body_phase0", "electra_ns",
                     "header_extra", "fork", "body", "blk", "sblk", "k", "v",
                     "fname", "ftyp", "bbody", "bblk", "sbblk"):
            setattr(T, k, v)
    T.max_validators_per_slot = max_validators_per_slot
    T.eth1_votes_limit = eth1_votes_limit
    T.pending_att_limit = pending_att_limit
    T.justification_bits_type = Bitvector(JUSTIFICATION_BITS_LENGTH)
    return T
