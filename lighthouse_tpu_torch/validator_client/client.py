"""The validator client service loop.

Equivalent of the reference's validator_client/src/lib.rs:552-645 service
spawn: duties service (poll proposer/attester duties), block service
(propose at slot start, proposers-first ordering block_service.rs:144-178),
attestation service (attest at slot/3, aggregate at 2*slot/3), preparation
and doppelganger services. Synchronous tick-driven design: `on_slot(slot)`
performs the full slot's duties (the async scheduling shell lives in the
runtime layer); works against any BeaconNodeInterface (in-process chain or
HTTP client) through BeaconNodeFallback.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import bls
from ..specs.chain_spec import ChainSpec
from ..ssz import htr
from .fallback import BeaconNodeFallback
from .slashing_protection import SlashingError
from .validator_store import ValidatorStore


class BeaconNodeInterface:
    """What the VC needs from a BN (common/eth2 client equivalent)."""

    def is_healthy(self) -> bool: ...

    def get_proposer_duties(self, epoch: int) -> list[tuple[int, int]]:
        """[(slot, validator_index)]"""

    def get_attester_duties(self, epoch: int, indices: list[int]) -> list:
        """[(slot, committee_index, validator_index, committee_len,
            position)]"""

    def get_validator_index(self, pubkey: bytes) -> int | None: ...

    def produce_block(self, slot: int, randao_reveal: bytes): ...

    def publish_block(self, signed_block) -> None: ...

    def attestation_data(self, slot: int, committee_index: int): ...

    def publish_attestation(self, attestation) -> None: ...

    def publish_aggregate(self, signed_aggregate) -> None: ...

    def head_fork_version(self) -> bytes: ...

    def seen_liveness(self, indices: list[int], epoch: int) -> list[bool]:
        """Doppelganger liveness data."""


@dataclass
class DoppelgangerState:
    """Refuse to sign for 2 epochs while watching for our keys being live
    elsewhere (doppelganger_service.rs:1-40)."""
    enabled: bool = False
    start_epoch: int = 0
    safe: bool = True

    def update(self, epoch: int, any_live: bool) -> None:
        if not self.enabled:
            return
        if any_live:
            self.safe = False
        elif epoch >= self.start_epoch + 2:
            self.safe = True

    def allows_signing(self, epoch: int) -> bool:
        if not self.enabled:
            return True
        return self.safe and epoch >= self.start_epoch + 2


class ValidatorClient:
    def __init__(self, spec: ChainSpec, store: ValidatorStore,
                 beacon_nodes: BeaconNodeFallback,
                 doppelganger_protection: bool = False):
        self.spec = spec
        self.store = store
        self.nodes = beacon_nodes
        self.doppelganger = DoppelgangerState(enabled=doppelganger_protection)
        self._duties: dict[int, list] = {}          # epoch -> attester duties
        self._proposers: dict[int, list] = {}       # epoch -> proposer duties
        self._indices: dict[bytes, int] = {}
        self.published_blocks = 0
        self.published_attestations = 0
        self.published_aggregates = 0
        self.published_sync_messages = 0
        # preparation service (validator_client/src/preparation_service.rs)
        self.fee_recipients: dict[bytes, bytes] = {}   # pubkey -> 20B
        self.default_fee_recipient: bytes | None = None
        self.builder_proposals = False
        self.gas_limit = 30_000_000
        self.graffiti: dict[bytes, str] = {}   # keymanager per-key graffiti
        self._prepared_epoch = -1

    # -- duties --------------------------------------------------------------

    def update_duties(self, epoch: int) -> None:
        for pk in self.store.voting_pubkeys():
            if pk not in self._indices:
                idx = self.nodes.first_success("get_validator_index", pk)
                if idx is not None:
                    self._indices[pk] = idx
        indices = list(self._indices.values())
        for e in (epoch, epoch + 1):
            self._duties[e] = self.nodes.first_success(
                "get_attester_duties", e, indices)
            self._proposers[e] = self.nodes.first_success(
                "get_proposer_duties", e)
        try:
            self.store.set_fork_version(
                self.nodes.first_success("head_fork_version"))
        except Exception:
            pass

    def _pubkey_for(self, validator_index: int) -> bytes | None:
        for pk, i in self._indices.items():
            if i == validator_index:
                return pk
        return None

    # -- slot work -----------------------------------------------------------

    def on_slot(self, slot: int) -> None:
        spe = self.spec.preset.slots_per_epoch
        epoch = slot // spe
        if epoch not in self._duties or epoch + 1 not in self._duties:
            self.update_duties(epoch)
        if self.doppelganger.enabled:
            live = self.nodes.first_success(
                "seen_liveness", list(self._indices.values()), epoch)
            self.doppelganger.update(epoch, any(live))
            if not self.doppelganger.allows_signing(epoch):
                return
        if epoch > self._prepared_epoch:
            self.prepare_proposers(epoch)
        self.propose_if_due(slot)
        self.attest(slot)
        self.aggregate(slot)
        self.sync_committee_duty(slot)

    def sign_voluntary_exit(self, pubkey: bytes, validator_index: int,
                            epoch: int) -> dict:
        """Keymanager POST /eth/v1/validator/{pubkey}/voluntary_exit."""
        from ..containers import get_types
        T = get_types(self.spec.preset)
        msg = T.VoluntaryExit(epoch=epoch, validator_index=validator_index)
        sig = self.store.sign_voluntary_exit(pubkey, msg)
        return {"message": {"epoch": str(epoch),
                            "validator_index": str(validator_index)},
                "signature": "0x" + sig.hex()}

    def _fee_recipient(self, pubkey: bytes) -> bytes | None:
        return self.fee_recipients.get(pubkey, self.default_fee_recipient)

    def prepare_proposers(self, epoch: int) -> None:
        """Preparation service: push fee recipients (and, when builder
        proposals are enabled, signed validator registrations) to the BN
        once per epoch (preparation_service.rs)."""
        entries = []
        for pk, idx in self._indices.items():
            fee = self._fee_recipient(pk)
            if fee is not None:
                entries.append({"validator_index": idx,
                                "fee_recipient": "0x" + fee.hex()})
        if entries:
            try:
                self.nodes.first_success("prepare_beacon_proposer", entries)
            except Exception:
                return              # retry next slot, not next epoch
        if self.builder_proposals:
            regs = []
            import time as _time
            for pk in self.store.voting_pubkeys():
                fee = self._fee_recipient(pk) or b"\x00" * 20
                msg = {"fee_recipient": "0x" + fee.hex(),
                       "gas_limit": self.gas_limit,
                       "timestamp": int(_time.time()),
                       "pubkey": "0x" + pk.hex()}
                regs.append({
                    "message": msg,
                    "signature": "0x" + self.store.sign_validator_registration(
                        pk, msg).hex()})
            if regs:
                try:
                    self.nodes.first_success("register_validator", regs)
                except Exception:
                    return
        self._prepared_epoch = epoch

    def sync_committee_duty(self, slot: int) -> None:
        """Sign the head root with every of our validators in the current
        sync committee (sync_committee_service.rs)."""
        from ..containers import get_types
        T = get_types(self.spec.preset)
        try:
            members = self.nodes.first_success(
                "get_sync_duties", slot // self.spec.preset.slots_per_epoch,
                list(self._indices.values()))
            if not members:
                return
            head_root = self.nodes.first_success("head_root")
        except Exception as e:
            import logging
            logging.getLogger("lighthouse_tpu_torch.vc").warning(
                "sync committee duty skipped: %r", e)
            return
        for vi in members:
            pk = self._pubkey_for(vi)
            if pk is None:
                continue
            sig = self.store.sign_sync_committee_message(pk, head_root)
            msg = T.SyncCommitteeMessage(
                slot=slot, beacon_block_root=head_root,
                validator_index=vi, signature=sig)
            self.nodes.broadcast("publish_sync_committee_message", msg)
            self.published_sync_messages += 1

    def propose_if_due(self, slot: int) -> None:
        spe = self.spec.preset.slots_per_epoch
        for duty_slot, validator_index in self._proposers.get(
                slot // spe, []):
            if duty_slot != slot:
                continue
            pk = self._pubkey_for(validator_index)
            if pk is None:
                continue
            reveal = self.store.randao_reveal(pk, slot // spe)
            graffiti = None
            if self.graffiti.get(pk):
                graffiti = self.graffiti[pk].encode()[:32].ljust(32, b"\0")
            try:
                block = self.nodes.first_success("produce_block", slot,
                                                 reveal, graffiti)
                sig = self.store.sign_block(pk, block)
            except SlashingError:
                continue
            except Exception:
                continue  # BN production failure must not kill the VC
            signed = self._signed_block(block, sig)
            self.nodes.broadcast("publish_block", signed)
            self.published_blocks += 1

    def _signed_block(self, block, sig: bytes):
        from ..containers import get_types
        T = get_types(self.spec.preset)
        fork = self.spec.fork_name_at_slot(block.slot)
        return T.SignedBeaconBlock[fork](message=block, signature=sig)

    def attest(self, slot: int) -> None:
        spe = self.spec.preset.slots_per_epoch
        from ..containers import get_types
        T = get_types(self.spec.preset)
        for duty in self._duties.get(slot // spe, []):
            duty_slot, committee_index, validator_index, committee_len, \
                position = duty
            if duty_slot != slot:
                continue
            pk = self._pubkey_for(validator_index)
            if pk is None:
                continue
            data = self.nodes.first_success("attestation_data", slot,
                                            committee_index)
            try:
                sig = self.store.sign_attestation(pk, data)
            except SlashingError:
                continue
            bits = [i == position for i in range(committee_len)]
            att = T.Attestation(aggregation_bits=bits, data=data,
                                signature=sig)
            self.nodes.broadcast("publish_attestation", att)
            self.published_attestations += 1

    def aggregate(self, slot: int) -> None:
        """Aggregation duty at 2/3 slot (attestation_service.rs): selection
        proof decides aggregators; aggregate from the BN's pool."""
        from ..chain.attestation_verification import is_aggregator
        from ..containers import get_types
        T = get_types(self.spec.preset)
        spe = self.spec.preset.slots_per_epoch
        for duty in self._duties.get(slot // spe, []):
            duty_slot, committee_index, validator_index, committee_len, \
                _position = duty
            if duty_slot != slot:
                continue
            pk = self._pubkey_for(validator_index)
            if pk is None:
                continue
            proof = self.store.selection_proof(pk, slot)
            if not is_aggregator(committee_len, proof):
                continue
            try:
                aggregate = self.nodes.first_success(
                    "get_aggregate", slot, committee_index)
            except Exception:
                continue
            if aggregate is None:
                continue
            msg = T.AggregateAndProof(aggregator_index=validator_index,
                                      aggregate=aggregate,
                                      selection_proof=proof)
            sig = self.store.sign_aggregate_and_proof(pk, msg)
            signed = T.SignedAggregateAndProof(message=msg, signature=sig)
            self.nodes.broadcast("publish_aggregate", signed)
            self.published_aggregates += 1
