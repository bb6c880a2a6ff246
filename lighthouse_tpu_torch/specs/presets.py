"""Compile-time presets (Mainnet / Minimal).

Equivalent of the reference's `EthSpec` typenum trait
(consensus/types/src/eth_spec.rs:53-161): sizes that fix SSZ type shapes.
Here they are frozen dataclasses threaded through type construction — the
array-first analog, since these sizes also fix device-array shapes.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Preset:
    name: str

    # Misc / committees
    slots_per_epoch: int
    max_committees_per_slot: int
    target_committee_size: int
    max_validators_per_committee: int
    shuffle_round_count: int

    # Hysteresis
    hysteresis_quotient: int = 4
    hysteresis_downward_multiplier: int = 1
    hysteresis_upward_multiplier: int = 5

    # Gwei values
    min_deposit_amount: int = 10**9
    max_effective_balance: int = 32 * 10**9
    effective_balance_increment: int = 10**9

    # State list lengths / vectors
    slots_per_historical_root: int = 8192
    epochs_per_historical_vector: int = 65536
    epochs_per_slashings_vector: int = 8192
    historical_roots_limit: int = 2**24
    validator_registry_limit: int = 2**40
    epochs_per_eth1_voting_period: int = 64
    min_attestation_inclusion_delay: int = 1
    min_seed_lookahead: int = 1
    max_seed_lookahead: int = 4

    # Rewards & penalties (phase0)
    base_reward_factor: int = 64
    whistleblower_reward_quotient: int = 512
    proposer_reward_quotient: int = 8
    inactivity_penalty_quotient: int = 2**26
    min_slashing_penalty_quotient: int = 128
    proportional_slashing_multiplier: int = 1

    # Max operations per block
    max_proposer_slashings: int = 16
    max_attester_slashings: int = 2
    max_attestations: int = 128
    max_deposits: int = 16
    max_voluntary_exits: int = 16

    # Altair
    sync_committee_size: int = 512
    epochs_per_sync_committee_period: int = 256
    inactivity_penalty_quotient_altair: int = 3 * 2**24
    min_slashing_penalty_quotient_altair: int = 64
    proportional_slashing_multiplier_altair: int = 2
    min_sync_committee_participants: int = 1
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16

    # Bellatrix
    inactivity_penalty_quotient_bellatrix: int = 2**24
    min_slashing_penalty_quotient_bellatrix: int = 32
    proportional_slashing_multiplier_bellatrix: int = 3
    max_bytes_per_transaction: int = 2**30
    max_transactions_per_payload: int = 2**20
    bytes_per_logs_bloom: int = 256
    max_extra_data_bytes: int = 32

    # Capella
    max_withdrawals_per_payload: int = 16
    max_validators_per_withdrawals_sweep: int = 16384
    max_bls_to_execution_changes: int = 16

    # Deneb
    field_elements_per_blob: int = 4096
    max_blob_commitments_per_block: int = 4096
    max_blobs_per_block: int = 6
    kzg_commitment_inclusion_proof_depth: int = 17

    # Electra
    max_effective_balance_electra: int = 2048 * 10**9
    min_activation_balance: int = 32 * 10**9
    min_slashing_penalty_quotient_electra: int = 4096
    whistleblower_reward_quotient_electra: int = 4096
    pending_deposits_limit: int = 2**27
    pending_partial_withdrawals_limit: int = 2**27
    pending_consolidations_limit: int = 2**18
    max_attester_slashings_electra: int = 1
    max_attestations_electra: int = 8
    max_deposit_requests_per_payload: int = 8192
    max_withdrawal_requests_per_payload: int = 16
    max_consolidation_requests_per_payload: int = 1
    max_pending_partials_per_withdrawals_sweep: int = 8
    max_pending_deposits_per_epoch: int = 16

    @property
    def epochs_per_eth1_voting_period_slots(self) -> int:
        return self.epochs_per_eth1_voting_period * self.slots_per_epoch


MAINNET_PRESET = Preset(
    name="mainnet",
    slots_per_epoch=32,
    max_committees_per_slot=64,
    target_committee_size=128,
    max_validators_per_committee=2048,
    shuffle_round_count=90,
)

MINIMAL_PRESET = Preset(
    name="minimal",
    slots_per_epoch=8,
    max_committees_per_slot=4,
    target_committee_size=4,
    max_validators_per_committee=2048,
    shuffle_round_count=10,
    epochs_per_eth1_voting_period=4,
    slots_per_historical_root=64,
    epochs_per_historical_vector=64,
    epochs_per_slashings_vector=64,
    historical_roots_limit=2**24,
    sync_committee_size=32,
    epochs_per_sync_committee_period=8,
    max_withdrawals_per_payload=4,
    max_validators_per_withdrawals_sweep=16,
    field_elements_per_blob=4096,
    max_blob_commitments_per_block=32,
    kzg_commitment_inclusion_proof_depth=10,
    pending_deposits_limit=2**27,
    pending_partial_withdrawals_limit=64,
    pending_consolidations_limit=64,
    max_deposit_requests_per_payload=4,
    max_withdrawal_requests_per_payload=2,
    max_pending_partials_per_withdrawals_sweep=2,
)

# Gnosis (consensus/types/src/eth_spec.rs:520-580 GnosisEthSpec):
# mainnet shapes except 16-slot epochs, 512-epoch sync periods, 8
# withdrawals per payload, and the faster reward curve in ChainSpec
GNOSIS_PRESET = Preset(
    name="gnosis",
    slots_per_epoch=16,
    max_committees_per_slot=64,
    target_committee_size=128,
    max_validators_per_committee=2048,
    shuffle_round_count=90,
    base_reward_factor=25,
    epochs_per_sync_committee_period=512,
    max_withdrawals_per_payload=8,
    max_validators_per_withdrawals_sweep=8192,
)

PRESETS = {"mainnet": MAINNET_PRESET, "minimal": MINIMAL_PRESET,
           "gnosis": GNOSIS_PRESET}
