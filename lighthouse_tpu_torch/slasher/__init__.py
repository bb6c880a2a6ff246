"""Slasher: surround/double-vote detection over a 2D chunked matrix.

Equivalent of the reference's slasher (4.9k LoC): min/max-target chunk
arrays per validator×epoch (array.rs:16-28), batched attestation queues,
a KV backend (the native C++ store). The matrix update is embarrassingly
array-parallel — implemented as vectorized numpy sweeps on the host.
"""
from .slasher import (
    Slasher, SlasherConfig, SlashingRecord, record_to_operation,
)
