"""Byzantine validator-client wrapper for adversarial scenarios.

Wraps a ValidatorClient and misbehaves on command.  The honest client's
ValidatorStore refuses slashable signatures (slashing_protection.py), so
the equivocating paths here sign RAW — the exact bypass a compromised or
buggy remote signer represents.  Everything published still goes through
the beacon node's normal publish API: the second (equivocating) message
is REJECTED from gossip there, which is precisely the choke point where
gossip verification authenticates it and hands it to the slasher.

Modes
-----
``honest``
    Pure delegation.
``silent``
    Withhold attestations/aggregates/sync messages but keep proposing:
    an offline-voter stake mass (the long non-finality scenario).
``double_propose``
    Produce and publish TWO blocks per proposal duty (second with
    different graffiti, hence a different body root).
``double_vote``
    Publish TWO attestations per attester duty with the same target but
    different head roots.
"""
from __future__ import annotations

from ..crypto import bls
from ..specs.chain_spec import compute_signing_root
from ..specs.constants import DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER
from ..ssz import htr
from .client import ValidatorClient

EVIL_GRAFFITI = b"equivocation!".ljust(32, b"\x00")


def raw_sign_block(store, pubkey: bytes, block) -> bytes:
    """Proposer signature WITHOUT the slashing-protection gate."""
    domain = store._domain(DOMAIN_BEACON_PROPOSER)
    return store._sign(pubkey, compute_signing_root(htr(block), domain))


def raw_sign_attestation(store, pubkey: bytes, data) -> bytes:
    """Attester signature WITHOUT the slashing-protection gate."""
    domain = store._domain(DOMAIN_BEACON_ATTESTER)
    return store._sign(pubkey, compute_signing_root(htr(data), domain))


class ByzantineValidatorClient:
    """Delegating wrapper; only the mode-relevant duties are overridden,
    so duty scheduling, fallback routing and counters stay the inner
    client's."""

    def __init__(self, inner: ValidatorClient, mode: str = "honest"):
        if mode not in ("honest", "silent", "double_propose",
                        "double_vote"):
            raise ValueError(f"unknown byzantine mode {mode!r}")
        self._inner = inner
        self.mode = mode
        self.equivocations = 0      # second messages actually published

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- silent: withhold votes, keep proposing ------------------------------

    def attest(self, slot: int) -> None:
        if self.mode == "silent":
            return
        if self.mode == "double_vote":
            self._double_vote(slot)
            return
        self._inner.attest(slot)

    def aggregate(self, slot: int) -> None:
        if self.mode == "silent":
            return
        self._inner.aggregate(slot)

    def sync_committee_duty(self, slot: int) -> None:
        if self.mode == "silent":
            return
        self._inner.sync_committee_duty(slot)

    def propose_if_due(self, slot: int) -> None:
        if self.mode == "double_propose":
            self._double_propose(slot)
            return
        self._inner.propose_if_due(slot)

    # -- equivocation --------------------------------------------------------

    def _double_propose(self, slot: int) -> None:
        vc = self._inner
        spe = vc.spec.preset.slots_per_epoch
        for duty_slot, validator_index in vc._proposers.get(slot // spe,
                                                            []):
            if duty_slot != slot:
                continue
            pk = vc._pubkey_for(validator_index)
            if pk is None:
                continue
            reveal = vc.store.randao_reveal(pk, slot // spe)
            try:
                # produce BOTH candidates before publishing either, so
                # the second build is not a child of the first
                block_a = vc.nodes.first_success("produce_block", slot,
                                                 reveal, None)
                block_b = vc.nodes.first_success("produce_block", slot,
                                                 reveal, EVIL_GRAFFITI)
            except Exception:
                continue
            signed_a = vc._signed_block(block_a,
                                        raw_sign_block(vc.store, pk,
                                                       block_a))
            signed_b = vc._signed_block(block_b,
                                        raw_sign_block(vc.store, pk,
                                                       block_b))
            vc.nodes.broadcast("publish_block", signed_a)
            vc.published_blocks += 1
            if htr(block_b) != htr(block_a):
                # the BN rejects this from gossip (repeat proposal) and
                # feeds the slasher; broadcast() swallows the 400
                vc.nodes.broadcast("publish_block", signed_b)
                self.equivocations += 1

    def _double_vote(self, slot: int) -> None:
        from ..containers import get_types
        vc = self._inner
        T = get_types(vc.spec.preset)
        spe = vc.spec.preset.slots_per_epoch
        for duty in vc._duties.get(slot // spe, []):
            duty_slot, committee_index, validator_index, committee_len, \
                position = duty
            if duty_slot != slot:
                continue
            pk = vc._pubkey_for(validator_index)
            if pk is None:
                continue
            data = vc.nodes.first_success("attestation_data", slot,
                                          committee_index)
            bits = [i == position for i in range(committee_len)]
            att_a = T.Attestation(
                aggregation_bits=bits, data=data,
                signature=raw_sign_attestation(vc.store, pk, data))
            vc.nodes.broadcast("publish_attestation", att_a)
            vc.published_attestations += 1
            # same (source, target) but a different vote: point the head
            # vote at the target block instead of the true head — still a
            # known block, so only the double-vote check can catch it
            if data.beacon_block_root == data.target.root:
                continue
            data_b = T.AttestationData(
                slot=data.slot, index=data.index,
                beacon_block_root=data.target.root,
                source=data.source, target=data.target)
            att_b = T.Attestation(
                aggregation_bits=bits, data=data_b,
                signature=raw_sign_attestation(vc.store, pk, data_b))
            vc.nodes.broadcast("publish_attestation", att_b)
            self.equivocations += 1
