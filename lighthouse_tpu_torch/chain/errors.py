"""Chain error taxonomy (block_verification.rs BlockError,
attestation_verification.rs Error equivalents — collapsed to the variants the
router/sync layers actually dispatch on)."""
from __future__ import annotations


class ChainError(Exception):
    pass


class BlockError(ChainError):
    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        self.detail = detail
        super().__init__(f"{kind}: {detail}" if detail else kind)


class AttestationError(ChainError):
    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        self.detail = detail
        super().__init__(f"{kind}: {detail}" if detail else kind)


# block error kinds (block_verification.rs:BlockError)
PARENT_UNKNOWN = "parent_unknown"
FUTURE_SLOT = "future_slot"
ALREADY_KNOWN = "already_known"
REPEAT_PROPOSAL = "repeat_proposal"
INVALID_SIGNATURE = "invalid_signature"
INVALID_BLOCK = "invalid_block"
FINALIZED_SLOT = "would_revert_finalized"
INCORRECT_PROPOSER = "incorrect_proposer"
AVAILABILITY_PENDING = "availability_pending"
EXECUTION_INVALID = "execution_invalid"

# attestation error kinds
UNKNOWN_HEAD_BLOCK = "unknown_head_block"
PAST_SLOT = "past_slot"
PRIOR_SEEN = "prior_attestation_known"
BAD_SIGNATURE = "bad_signature"
BAD_TARGET = "bad_target"
NOT_AGGREGATOR = "invalid_selection_proof"
EMPTY_AGGREGATION_BITS = "empty_aggregation_bits"
