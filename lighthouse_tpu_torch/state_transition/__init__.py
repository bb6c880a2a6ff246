"""The spec state transition function (L2).

Equivalent of the reference's consensus/state_processing (11.1k LoC):
per-slot/per-epoch/per-block processing, genesis, signature-set collection.
Epoch processing follows the reference's single-pass design
(per_epoch_processing/single_pass.rs) but as vectorized array arithmetic
over the SoA BeaconState — one fused sweep over validator columns.
"""
from .slot import per_slot_processing, process_slots, state_root_at_slot
from .block import (
    per_block_processing, process_block_header, VerifySignatures,
    BlockProcessingError,
)
from .epoch import per_epoch_processing
from .genesis import (
    interop_genesis_state, initialize_beacon_state_from_eth1,
    is_valid_genesis_state, genesis_deposits,
)
from .helpers import (
    get_active_validator_indices, get_total_active_balance,
    get_beacon_proposer_index, get_beacon_committee, get_domain,
    compute_epoch_at_slot, compute_start_slot_at_epoch,
    get_attesting_indices, get_indexed_attestation,
)
from .signature_sets import BlockSignatureVerifier
from .block_replayer import BlockReplayer
