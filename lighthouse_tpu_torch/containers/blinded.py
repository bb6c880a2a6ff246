"""Blinded-block helpers: payload <-> header, blind / unblind.

The builder (MEV) flow round-trips through real SSZ containers: the VC signs a `SignedBlindedBeaconBlock`
whose body carries the `ExecutionPayloadHeader`, and unblinding splices
the full payload back in after checking the header commitment — the
shape of the reference's `BlindedPayload` machinery
(consensus/types/src/payload.rs; execution_layer/src/lib.rs:807
get_payload; beacon_node/execution_layer/src/lib.rs block proposal
unblinding).
"""
from __future__ import annotations

from ..specs.chain_spec import ForkName
from ..ssz import htr
from ..ssz.merkle import hash_tree_root


def payload_to_header(T, fork: ForkName, payload):
    """ExecutionPayload -> ExecutionPayloadHeader (roots for the
    variable-size fields)."""
    H = T.ExecutionPayloadHeader[fork]
    P = type(payload)
    kw = {}
    for name, _typ in H.__ssz_fields__.items():
        if name == "transactions_root":
            kw[name] = hash_tree_root(P.__ssz_fields__["transactions"],
                                      payload.transactions)
        elif name == "withdrawals_root":
            kw[name] = hash_tree_root(P.__ssz_fields__["withdrawals"],
                                      payload.withdrawals)
        else:
            kw[name] = getattr(payload, name)
    return H(**kw)


def blind_block(T, block):
    """BeaconBlock -> BlindedBeaconBlock (same root by construction)."""
    fork = block.fork_name if hasattr(block, "fork_name") else \
        type(block).fork_name
    body = block.body
    BB = T.BlindedBeaconBlockBody[fork]
    kw = {}
    for name in BB.__ssz_fields__:
        if name == "execution_payload_header":
            kw[name] = payload_to_header(T, fork, body.execution_payload)
        else:
            kw[name] = getattr(body, name)
    blinded_body = BB(**kw)
    return T.BlindedBeaconBlock[fork](
        slot=block.slot, proposer_index=block.proposer_index,
        parent_root=block.parent_root, state_root=block.state_root,
        body=blinded_body)


def blind_signed_block(T, signed):
    fork = type(signed).fork_name
    return T.SignedBlindedBeaconBlock[fork](
        message=blind_block(T, signed.message),
        signature=signed.signature)


class UnblindError(Exception):
    pass


def unblind_signed_block(T, signed_blinded, payload):
    """SignedBlindedBeaconBlock + full payload -> SignedBeaconBlock.

    Refuses to splice a payload whose header does not match the one the
    proposer signed (the builder-equivocation check)."""
    fork = type(signed_blinded).fork_name
    msg = signed_blinded.message
    want = msg.body.execution_payload_header
    got = payload_to_header(T, fork, payload)
    if htr(got) != htr(want):
        raise UnblindError("payload does not match the signed header")
    FB = T.BeaconBlockBody[fork]
    kw = {}
    for name in FB.__ssz_fields__:
        if name == "execution_payload":
            kw[name] = payload
        else:
            kw[name] = getattr(msg.body, name)
    block = T.BeaconBlock[fork](
        slot=msg.slot, proposer_index=msg.proposer_index,
        parent_root=msg.parent_root, state_root=msg.state_root,
        body=FB(**kw))
    return T.SignedBeaconBlock[fork](message=block,
                                     signature=signed_blinded.signature)
