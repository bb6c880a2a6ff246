"""Execution layer interface + in-process mock.

The real engine-API HTTP client (JWT, newPayload/forkchoiceUpdated/getPayload)
lives in lighthouse_tpu_torch.execution_layer; this module defines the
interface the chain consumes and the MockExecutionLayer used by the harness — equivalent of
the reference's beacon_node/execution_layer/src/test_utils/
{mock_execution_layer.rs:12, execution_block_generator.rs}.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field


class ExecutionLayerInterface:
    def notify_new_payload(self, payload) -> str:
        """'valid' | 'invalid' | 'optimistic' (SYNCING/ACCEPTED)."""
        raise NotImplementedError

    def notify_forkchoice_updated(self, head_hash: bytes, safe_hash: bytes,
                                  finalized_hash: bytes,
                                  payload_attributes=None):
        raise NotImplementedError

    def get_payload(self, payload_id) -> object:
        raise NotImplementedError


@dataclass
class MockExecutionBlock:
    block_hash: bytes
    parent_hash: bytes
    block_number: int


class MockExecutionLayer(ExecutionLayerInterface):
    """Accepts every payload whose parent it knows; tests can mark hashes
    invalid or answer 'optimistic' to exercise optimistic sync
    (payload_invalidation.rs test style)."""

    def __init__(self):
        self.blocks: dict[bytes, MockExecutionBlock] = {}
        self.invalid_hashes: set[bytes] = set()
        self.syncing = False
        self.forkchoice_calls: list = []
        zero = b"\x00" * 32
        self.blocks[zero] = MockExecutionBlock(zero, zero, 0)

    def notify_new_payload(self, payload) -> str:
        if payload.block_hash in self.invalid_hashes:
            return "invalid"
        if self.syncing:
            return "optimistic"
        self.blocks[payload.block_hash] = MockExecutionBlock(
            payload.block_hash, payload.parent_hash, payload.block_number)
        return "valid"

    def notify_forkchoice_updated(self, head_hash, safe_hash, finalized_hash,
                                  payload_attributes=None):
        self.forkchoice_calls.append((head_hash, finalized_hash))
        if head_hash in self.invalid_hashes:
            return ("invalid", None)
        payload_id = None
        if payload_attributes is not None:
            payload_id = hashlib.sha256(
                head_hash + repr(payload_attributes).encode()).digest()[:8]
            self._prep = (payload_id, head_hash, payload_attributes)
        return ("optimistic" if self.syncing else "valid", payload_id)

    def get_payload(self, payload_id):
        return getattr(self, "_prep", None)
