"""Operation pool: attestations/slashings/exits/BLS-changes for block packing.

Equivalent of the reference's beacon_node/operation_pool (src/lib.rs:1-45):
greedy weighted max-cover attestation packing (max_cover.rs:53,
attestation.rs AttMaxCover), dedup/aggregation by attestation data, pool
persistence.
"""
from .max_cover import maximum_cover, MaxCoverItem
from .pool import OperationPool
