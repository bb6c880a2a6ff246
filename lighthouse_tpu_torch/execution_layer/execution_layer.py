"""ExecutionLayer: the chain-facing facade over the engine API.

Equivalent of execution_layer/src/lib.rs (`notify_new_payload` :1346,
`notify_forkchoice_updated` :1452, `get_payload` :807), implementing the
chain's ExecutionLayerInterface so it is a drop-in replacement for the mock
(chain/execution.py).
"""
from __future__ import annotations

from ..chain.execution import ExecutionLayerInterface
from .engine_api import EngineApiClient, EngineError
from .engines import Engines, EngineState


def _payload_to_json(payload) -> dict:
    out = {
        "parentHash": "0x" + payload.parent_hash.hex(),
        "feeRecipient": "0x" + payload.fee_recipient.hex(),
        "stateRoot": "0x" + payload.state_root.hex(),
        "receiptsRoot": "0x" + payload.receipts_root.hex(),
        "logsBloom": "0x" + payload.logs_bloom.hex(),
        "prevRandao": "0x" + payload.prev_randao.hex(),
        "blockNumber": hex(payload.block_number),
        "gasLimit": hex(payload.gas_limit),
        "gasUsed": hex(payload.gas_used),
        "timestamp": hex(payload.timestamp),
        "extraData": "0x" + bytes(payload.extra_data).hex(),
        "baseFeePerGas": hex(payload.base_fee_per_gas),
        "blockHash": "0x" + payload.block_hash.hex(),
        "transactions": ["0x" + bytes(t).hex()
                         for t in payload.transactions],
    }
    if hasattr(payload, "withdrawals"):
        out["withdrawals"] = [{
            "index": hex(w.index), "validatorIndex": hex(w.validator_index),
            "address": "0x" + w.address.hex(), "amount": hex(w.amount)}
            for w in payload.withdrawals]
    if hasattr(payload, "blob_gas_used"):
        out["blobGasUsed"] = hex(payload.blob_gas_used)
        out["excessBlobGas"] = hex(payload.excess_blob_gas)
    return out


def payload_from_json(T, fork, j: dict):
    """Inverse of _payload_to_json (engine-API / builder JSON -> SSZ)."""
    def hx(s):
        return bytes.fromhex(s[2:] if s.startswith("0x") else s)

    kw = dict(
        parent_hash=hx(j["parentHash"]),
        fee_recipient=hx(j["feeRecipient"]),
        state_root=hx(j["stateRoot"]),
        receipts_root=hx(j["receiptsRoot"]),
        logs_bloom=hx(j["logsBloom"]),
        prev_randao=hx(j["prevRandao"]),
        block_number=int(j["blockNumber"], 16),
        gas_limit=int(j["gasLimit"], 16),
        gas_used=int(j["gasUsed"], 16),
        timestamp=int(j["timestamp"], 16),
        extra_data=hx(j["extraData"]),
        base_fee_per_gas=int(j["baseFeePerGas"], 16),
        block_hash=hx(j["blockHash"]),
        transactions=[hx(t) for t in j["transactions"]],
    )
    if "withdrawals" in j:
        kw["withdrawals"] = [T.Withdrawal(
            index=int(w["index"], 16),
            validator_index=int(w["validatorIndex"], 16),
            address=hx(w["address"]), amount=int(w["amount"], 16))
            for w in j["withdrawals"]]
    if "blobGasUsed" in j:
        kw["blob_gas_used"] = int(j["blobGasUsed"], 16)
        kw["excess_blob_gas"] = int(j["excessBlobGas"], 16)
    return T.ExecutionPayload[fork](**kw)


class ExecutionLayer(ExecutionLayerInterface):
    def __init__(self, client: EngineApiClient):
        self.client = client
        self.engines = Engines(client)
        self.payload_cache: dict[bytes, object] = {}

    def notify_new_payload(self, payload) -> str:
        if self.engines.upcheck() == EngineState.OFFLINE:
            return "optimistic"
        try:
            result = self.client.new_payload(_payload_to_json(payload))
        except EngineError:
            self.engines.on_error()
            return "optimistic"
        status = (result or {}).get("status", "SYNCING")
        self.engines.on_success(syncing=status in ("SYNCING", "ACCEPTED"))
        return {"VALID": "valid", "INVALID": "invalid",
                "INVALID_BLOCK_HASH": "invalid"}.get(status, "optimistic")

    def notify_forkchoice_updated(self, head_hash, safe_hash, finalized_hash,
                                  payload_attributes=None):
        if self.engines.upcheck() == EngineState.OFFLINE:
            return ("optimistic", None)
        attrs = None
        if payload_attributes is not None:
            attrs = payload_attributes
        try:
            result = self.client.forkchoice_updated(head_hash, safe_hash,
                                                    finalized_hash, attrs)
        except EngineError:
            self.engines.on_error()
            return ("optimistic", None)
        status = ((result or {}).get("payloadStatus") or {}).get(
            "status", "SYNCING")
        payload_id = (result or {}).get("payloadId")
        self.engines.on_success(syncing=status in ("SYNCING", "ACCEPTED"))
        return ({"VALID": "valid", "INVALID": "invalid"}.get(
            status, "optimistic"), payload_id)

    def get_payload(self, payload_id) -> dict | None:
        try:
            return self.client.get_payload(payload_id)
        except EngineError:
            self.engines.on_error()
            return None
