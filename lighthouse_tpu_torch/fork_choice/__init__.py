"""LMD-GHOST fork choice (L3).

Equivalent of the reference's consensus/fork_choice (spec wrapper: queued
attestations, unrealized justification, proposer boost, invalid-payload
handling) + consensus/proto_array (flat node array, weight deltas, find_head,
pruning).
"""
from .proto_array import (
    ProtoArray, ProtoNode, ExecutionStatus, ProtoArrayError, VoteTracker,
    compute_deltas,
)
from .fork_choice import ForkChoice, ForkChoiceError, QueuedAttestation
