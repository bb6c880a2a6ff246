"""Beacon-API semantics over a BeaconChain.

The single implementation behind both the HTTP router and the in-process
BeaconNodeInterface used by the validator client and simulator (the
reference's http_api handlers + common/eth2 typed client collapsed onto one
seam).
"""
from __future__ import annotations

import numpy as np

from ..chain.beacon_chain import BeaconChain
from ..specs.chain_spec import ForkName
from ..ssz import htr
from ..state_transition import process_slots
from ..state_transition.helpers import (
    committee_cache, compute_epoch_at_slot, compute_start_slot_at_epoch,
    get_beacon_proposer_index,
)
from .serving.coalesce import Coalescer


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        self.status = status
        super().__init__(message)


class ApiBackend:
    def __init__(self, chain: BeaconChain):
        self.chain = chain
        #: payloads withheld from blinded production until the signed
        #: blinded block returns (execution_layer/src/lib.rs get_payload
        #: + unblinding flow); block_hash -> ExecutionPayload
        self._blinded_payloads: dict[bytes, object] = {}
        #: single-flight gate for attester-cache priming: N concurrent
        #: attestation_data misses for the same (epoch, head) replay
        #: once, not N times (thundering-herd fix)
        self._attester_primer = Coalescer()

    # -- node ----------------------------------------------------------------

    def is_healthy(self) -> bool:
        return True

    def syncing(self) -> dict:
        head = self.chain.head().head_state.slot
        current = self.chain.slot()
        return {"head_slot": str(head),
                "sync_distance": str(max(0, current - head)),
                "is_syncing": current > head + 1,
                "is_optimistic": self.chain.is_optimistic_head(),
                "el_offline": False}

    def version(self) -> dict:
        from .. import __version__
        return {"version": f"lighthouse-tpu/{__version__}"}

    # -- beacon --------------------------------------------------------------

    def genesis(self) -> dict:
        st = self.chain.genesis_state
        return {"genesis_time": str(st.genesis_time),
                "genesis_validators_root":
                    "0x" + st.genesis_validators_root.hex(),
                "genesis_fork_version":
                    "0x" + self.chain.spec.genesis_fork_version.hex()}

    def _resolve_state(self, state_id: str):
        chain = self.chain
        if state_id == "head":
            return chain.head().head_state
        if state_id == "genesis":
            return chain.genesis_state
        if state_id in ("finalized", "justified"):
            epoch, root = (chain.finalized_checkpoint()
                           if state_id == "finalized"
                           else chain.justified_checkpoint())
            blk = chain.store.get_block(root)
            if blk is None:
                return chain.head().head_state
            st = chain.store.get_hot_state(blk.message.state_root)
            if st is None:
                raise ApiError(404, "state not available")
            return st
        if state_id.startswith("0x"):
            st = chain.store.get_hot_state(bytes.fromhex(state_id[2:]))
            if st is None:
                raise ApiError(404, "state not found")
            return st
        try:
            slot = int(state_id)
        except ValueError:
            raise ApiError(400, f"bad state id {state_id}")
        head = chain.head().head_state
        if slot > head.slot:
            raise ApiError(404, "future state")
        root = chain.block_root_at_slot(slot)
        if root is None:
            raise ApiError(404, "unknown slot")
        blk = chain.store.get_block(root)
        st = chain.store.get_hot_state(blk.message.state_root) if blk else None
        if st is None:
            raise ApiError(404, "state pruned")
        if st.slot < slot:
            st = st.copy()
            process_slots(st, slot)
        return st

    def state_root(self, state_id: str) -> bytes:
        return self._resolve_state(state_id).hash_tree_root()

    def state_fork(self, state_id: str) -> dict:
        f = self._resolve_state(state_id).fork
        return {"previous_version": "0x" + f.previous_version.hex(),
                "current_version": "0x" + f.current_version.hex(),
                "epoch": str(f.epoch)}

    def finality_checkpoints(self, state_id: str) -> dict:
        st = self._resolve_state(state_id)
        def ck(c):
            return {"epoch": str(c.epoch), "root": "0x" + c.root.hex()}
        return {"previous_justified": ck(st.previous_justified_checkpoint),
                "current_justified": ck(st.current_justified_checkpoint),
                "finalized": ck(st.finalized_checkpoint)}

    def validators(self, state_id: str,
                   indices: list[int] | None = None) -> list[dict]:
        st = self._resolve_state(state_id)
        out = []
        epoch = st.current_epoch()
        n = len(st.validators)
        for i in (indices if indices is not None else range(n)):
            if i >= n:
                continue
            v = st.validators.view(i)
            if v.activation_epoch > epoch:
                status = ("pending_queued"
                          if v.activation_eligibility_epoch <= epoch
                          else "pending_initialized")
            elif epoch < v.exit_epoch:
                status = "active_slashed" if v.slashed else "active_ongoing"
            elif epoch < v.withdrawable_epoch:
                status = "exited_slashed" if v.slashed else "exited_unslashed"
            else:
                status = "withdrawal_possible"
            out.append({
                "index": str(i), "balance": str(int(st.balances[i])),
                "status": status,
                "validator": {
                    "pubkey": "0x" + v.pubkey.hex(),
                    "withdrawal_credentials":
                        "0x" + v.withdrawal_credentials.hex(),
                    "effective_balance": str(v.effective_balance),
                    "slashed": v.slashed,
                    "activation_eligibility_epoch":
                        str(v.activation_eligibility_epoch),
                    "activation_epoch": str(v.activation_epoch),
                    "exit_epoch": str(v.exit_epoch),
                    "withdrawable_epoch": str(v.withdrawable_epoch),
                }})
        return out

    def block_header(self, block_id: str) -> dict:
        root, blk = self._resolve_block(block_id)
        h = blk.message
        return {"root": "0x" + root.hex(),
                "canonical": self.chain.block_root_at_slot(h.slot) == root,
                "header": {"message": {
                    "slot": str(h.slot),
                    "proposer_index": str(h.proposer_index),
                    "parent_root": "0x" + h.parent_root.hex(),
                    "state_root": "0x" + h.state_root.hex(),
                    "body_root": "0x" + htr(h.body).hex()},
                    "signature": "0x" + blk.signature.hex()}}

    def _resolve_block(self, block_id: str):
        chain = self.chain
        if block_id == "head":
            head = chain.head()
            return head.head_block_root, head.head_block
        if block_id == "genesis":
            root = chain.genesis_block_root
        elif block_id == "finalized":
            root = chain.finalized_checkpoint()[1]
        elif block_id.startswith("0x"):
            root = bytes.fromhex(block_id[2:])
        else:
            try:
                root = chain.block_root_at_slot(int(block_id))
            except ValueError:
                raise ApiError(400, f"bad block id {block_id}")
        if root is None:
            raise ApiError(404, "unknown block")
        blk = chain.store.get_block(root)
        if blk is None:
            raise ApiError(404, "block not found")
        return root, blk

    def block_ssz(self, block_id: str) -> bytes:
        from ..ssz import serialize
        _root, blk = self._resolve_block(block_id)
        return serialize(type(blk).ssz_type, blk)

    def _block_meta(self, blk, root: bytes | None = None
                    ) -> tuple[str, bool]:
        """(consensus version string, finalized?) for response envelopes
        (the fork-versioned headers/fields of the v2 endpoints).
        Finalized = at/below the finalized slot AND canonical — a stored
        fork block below finality is NOT finalized."""
        version = type(blk).fork_name.name.lower()
        fin_epoch = int(self.chain.finalized_checkpoint()[0])
        spe = self.chain.spec.preset.slots_per_epoch
        slot = blk.message.slot
        finalized = slot <= fin_epoch * spe and (
            root is None or self.chain.block_root_at_slot(slot) == root)
        return version, finalized

    def block_envelope(self, block_id: str) -> tuple[dict, str]:
        """GET /eth/v2/beacon/blocks/{id} JSON body + consensus version."""
        from .json_repr import container_json
        root, blk = self._resolve_block(block_id)
        version, finalized = self._block_meta(blk, root)
        return ({"version": version, "execution_optimistic": False,
                 "finalized": finalized, "data": container_json(blk)},
                version)

    def block_version(self, block_id: str) -> str:
        """Consensus version only (cheap: no JSON rendering) for SSZ
        responses' Eth-Consensus-Version header."""
        _root, blk = self._resolve_block(block_id)
        return type(blk).fork_name.name.lower()

    def blinded_block_envelope(self, block_id: str) -> tuple[dict, str]:
        from ..containers.blinded import blind_signed_block
        from .json_repr import container_json
        root, blk = self._resolve_block(block_id)
        version, finalized = self._block_meta(blk, root)
        if type(blk).fork_name >= ForkName.BELLATRIX:
            blk = blind_signed_block(self.chain.T, blk)
        return ({"version": version, "execution_optimistic": False,
                 "finalized": finalized, "data": container_json(blk)},
                version)

    def block_attestations_v2(self, block_id: str) -> tuple[dict, str]:
        """GET /eth/v2/beacon/blocks/{id}/attestations (fork-versioned)."""
        from .json_repr import container_json
        root, blk = self._resolve_block(block_id)
        version, finalized = self._block_meta(blk, root)
        atts = [container_json(a) for a in blk.message.body.attestations]
        return ({"version": version, "execution_optimistic": False,
                 "finalized": finalized, "data": atts}, version)

    def state_version(self, state_id: str) -> str:
        """Consensus version of a state (fork-versioned response headers
        on the debug state endpoints)."""
        return self._resolve_state(state_id).fork_name.name.lower()

    def produce_block_envelope(self, slot: int, randao_reveal: bytes,
                               graffiti: bytes | None = None
                               ) -> tuple[dict, str]:
        """GET /eth/v2/validator/blocks/{slot} JSON (+version header)."""
        from .json_repr import container_json
        block = self.produce_block(slot, randao_reveal, graffiti)
        version = self.chain.spec.fork_name_at_slot(slot).name.lower()
        return ({"version": version, "data": container_json(block)},
                version)

    def publish_block(self, signed_block,
                      validation: str = "gossip") -> int:
        """POST beacon/blocks with broadcast-validation semantics
        (http_api/src/publish_blocks.rs:1-60):

        - ``gossip`` (default): broadcast as soon as gossip checks pass;
          a later full-import failure returns 202 (broadcast happened).
        - ``consensus``: full state-transition import BEFORE broadcast;
          any failure is 400 and nothing is broadcast.
        - ``consensus_and_equivocation``: consensus + equivocation check
          (our gossip verification already rejects repeat proposals, so
          this is consensus with the equivocation error surfaced as 400).

        Returns the HTTP status to send (200 or 202).  Broadcasting uses
        the network hook (`self.publish_fn`, wired by the client
        builder); absent a network the validation ordering still holds.
        """
        from ..chain.errors import BlockError
        if validation not in ("gossip", "consensus",
                              "consensus_and_equivocation"):
            raise ApiError(400, f"unknown broadcast_validation "
                                f"{validation!r}")
        chain = self.chain
        broadcast = getattr(self, "publish_fn", None)
        if validation == "gossip":
            try:
                chain.verify_block_for_gossip(signed_block)
            except BlockError as e:
                if e.kind == "already_known":
                    root = htr(signed_block.message)
                    if chain.fork_choice.contains_block(root):
                        return 200
                    # seen (a prior 202 broadcast) but never imported:
                    # fall through and retry the import
                else:
                    raise ApiError(400, f"block rejected: {e}")
            if broadcast is not None:
                broadcast(signed_block)
            try:
                chain.process_block(signed_block,
                                    proposal_already_verified=True)
            except BlockError:
                return 202            # broadcast, but not importable yet
            return 200
        # consensus / consensus_and_equivocation: import fully first
        try:
            chain.process_block(signed_block)
        except BlockError as e:
            raise ApiError(400, f"block rejected: {e}")
        if broadcast is not None:
            broadcast(signed_block)
        return 200

    # -- validator duties ----------------------------------------------------

    def _duties_state(self, epoch: int):
        st = self.chain.head().head_state
        target = compute_start_slot_at_epoch(
            epoch, self.chain.spec.preset.slots_per_epoch)
        if st.slot < target:
            st = st.copy()
            process_slots(st, target)
        return st

    def get_proposer_duties(self, epoch: int) -> list[tuple[int, int]]:
        st = self._duties_state(epoch)
        spe = self.chain.spec.preset.slots_per_epoch
        start = compute_start_slot_at_epoch(epoch, spe)
        out = []
        for slot in range(start, start + spe):
            if slot == 0:
                continue
            out.append((slot, get_beacon_proposer_index(st, slot)))
        return out

    def get_attester_duties(self, epoch: int, indices: list[int]) -> list:
        st = self._duties_state(epoch)
        cache = committee_cache(st, epoch)
        wanted = set(indices)
        out = []
        spe = self.chain.spec.preset.slots_per_epoch
        start = compute_start_slot_at_epoch(epoch, spe)
        for slot in range(start, start + spe):
            for ci in range(cache.committees_per_slot):
                committee = cache.committee(slot, ci)
                for pos, v in enumerate(committee):
                    if int(v) in wanted:
                        out.append((slot, ci, int(v), len(committee), pos))
        return out

    def get_validator_index(self, pubkey: bytes) -> int | None:
        return self.chain.head().head_state.validators.index_of(pubkey)

    def produce_block(self, slot: int, randao_reveal: bytes,
                      graffiti: bytes | None = None):
        block, _post = self.chain.produce_block(
            randao_reveal, slot, graffiti=graffiti)
        return block

    def attestation_data(self, slot: int, committee_index: int):
        from ..state_transition.helpers import (
            StateError, get_committee_count_per_slot,
        )
        chain = self.chain
        try:
            # fast path 1: the early-attester cache serves the current
            # head state-free (early_attester_cache.rs:1-30)
            early = chain.early_attester_cache.try_attest(chain, slot,
                                                          committee_index)
            if early is not None:
                return early
            # fast path 2: non-head slots whose epoch is decided — source
            # checkpoint from the attester cache, roots from fork choice;
            # no state read or replay (attester_cache.rs:1-60)
            cached = chain.attester_cache.attestation_data(chain, slot,
                                                           committee_index)
            if cached is not None:
                return cached
        except StateError as e:
            raise ApiError(400, str(e))
        head = chain.head()
        st = head.head_state
        T = chain.T
        spe = chain.spec.preset.slots_per_epoch
        epoch = compute_epoch_at_slot(slot, spe)
        if st.slot < slot:
            # prime the attester cache once per (epoch, head): the
            # single-flight gate makes concurrent misses share ONE
            # replay instead of each paying process_slots + cache_state
            def _prime():
                pst = head.head_state.copy()
                process_slots(pst, slot)
                chain.attester_cache.cache_state(chain, pst)
                return pst
            st, _led = self._attester_primer.do(
                ("attester_prime", epoch, head.head_block_root), _prime)
            if st.slot < slot:
                # a concurrent leader primed to an earlier slot of this
                # epoch; finish the (short) replay privately
                st = st.copy()
                process_slots(st, slot)
        head_epoch = st.current_epoch()
        # the source an epoch-E attestation needs is the checkpoint that
        # was *current during E*; from a later head state that is only
        # derivable one epoch back
        if epoch == head_epoch:
            source = st.current_justified_checkpoint
        elif epoch == head_epoch - 1:
            source = st.previous_justified_checkpoint
        else:
            raise ApiError(400, "attestation slot too old to produce")
        cps = get_committee_count_per_slot(st, epoch)
        if committee_index >= cps:
            raise ApiError(400, f"committee index {committee_index} out "
                                f"of range (epoch {epoch} has {cps} "
                                "committees per slot)")
        epoch_start = compute_start_slot_at_epoch(epoch, spe)
        if head.head_state.slot <= epoch_start:
            target_root = head.head_block_root
        else:
            target_root = st.get_block_root_at_slot(epoch_start)
        # vote the head-chain block AT/BELOW the request slot: the head
        # itself is "newer than slot" for past slots and fork choice
        # rejects such votes
        if head.head_state.slot <= slot:
            block_root = head.head_block_root
        else:
            block_root = st.get_block_root_at_slot(slot)
        return T.AttestationData(
            slot=slot, index=committee_index,
            beacon_block_root=block_root,
            source=source,
            target=T.Checkpoint(epoch=epoch, root=target_root))

    def publish_attestation(self, attestation) -> None:
        from ..chain.errors import AttestationError
        try:
            v = self.chain.verify_unaggregated_attestation_for_gossip(
                attestation)
            self.chain.apply_attestation_to_fork_choice(v)
            self.chain.add_to_op_pool(v)
        except AttestationError as e:
            if e.kind != "prior_attestation_known":
                raise ApiError(400, f"attestation rejected: {e}")

    def get_aggregate(self, slot: int, committee_index: int):
        """Best pool aggregate for (slot, committee)."""
        with self.chain.op_pool._lock:
            best, best_count = None, -1
            for bucket in self.chain.op_pool._attestations.values():
                for a in bucket:
                    if a.data.slot == slot and a.data.index == \
                            committee_index:
                        c = sum(1 for b in a.aggregation_bits if b)
                        if c > best_count:
                            best, best_count = a, c
        return best

    def publish_aggregate(self, signed_aggregate) -> None:
        from ..chain.errors import AttestationError
        try:
            v = self.chain.verify_aggregated_attestation_for_gossip(
                signed_aggregate)
            self.chain.apply_attestation_to_fork_choice(v)
            self.chain.add_to_op_pool(v)
        except AttestationError as e:
            if e.kind not in ("prior_attestation_known",):
                raise ApiError(400, f"aggregate rejected: {e}")

    def get_sync_duties(self, epoch: int, indices: list[int]) -> list[int]:
        """Validator indices (of the requested set) in the sync committee
        serving `epoch` — period-aware: current committee for the head's
        period, next_sync_committee for the following period."""
        st = self.chain.head().head_state
        if st.current_sync_committee is None:
            return []
        period_len = self.chain.spec.preset.epochs_per_sync_committee_period
        head_period = st.current_epoch() // period_len
        want_period = epoch // period_len
        if want_period == head_period:
            committee = st.current_sync_committee
        elif want_period == head_period + 1:
            committee = st.next_sync_committee
        else:
            raise ApiError(400, f"epoch {epoch} outside known sync periods")
        members = set()
        for pk in committee.pubkeys:
            i = st.validators.index_of(pk)
            if i is not None:
                members.add(i)
        return [i for i in indices if i in members]

    def publish_sync_committee_message(self, msg) -> None:
        from ..chain.errors import AttestationError
        try:
            self.chain.sync_committee_pool.verify_and_add_message(msg)
        except AttestationError as e:
            if e.kind != "prior_attestation_known":
                raise ApiError(400, f"sync message rejected: {e}")

    def head_root(self) -> bytes:
        return self.chain.head().head_block_root

    def head_fork_version(self) -> bytes:
        return self.chain.head().head_state.fork.current_version

    def prepare_beacon_proposer(self, entries: list[dict]) -> None:
        """POST /eth/v1/validator/prepare_beacon_proposer."""
        self.chain.register_proposer_preparation(entries)

    def register_validator(self, registrations: list[dict]) -> None:
        """POST /eth/v1/validator/register_validator (builder flow)."""
        self.chain.register_validators(registrations)

    def seen_liveness(self, indices: list[int], epoch: int) -> list[bool]:
        return [self.chain.observed_attesters.has_been_observed(epoch, i)
                for i in indices]

    # -- beacon: pools, committees, balances, blobs --------------------------
    # (http_api/src/lib.rs:3925-4521 route groups)

    def pool_attestations(self) -> list[dict]:
        from ..ssz import serialize
        pool = self.chain.op_pool
        with pool._lock:
            atts = [a for bucket in pool._attestations.values()
                    for a in bucket]
        return [{"ssz": serialize(type(a).ssz_type, a).hex()}
                for a in atts]

    def pool_ops(self, kind: str) -> list[dict]:
        from ..ssz import serialize
        pool = self.chain.op_pool
        with pool._lock:
            items = {"attester_slashings": pool._attester_slashings,
                     "proposer_slashings": pool._proposer_slashings,
                     "voluntary_exits": pool._voluntary_exits,
                     "bls_to_execution_changes": pool._bls_changes}[kind]
        vals = list(items.values()) if isinstance(items, dict) else \
            list(items)
        return [{"ssz": serialize(type(v).ssz_type, v).hex()}
                for v in vals]

    def submit_pool_op(self, kind: str, obj) -> None:
        # gossip-style verification BEFORE pooling: an op with a bad
        # signature must never be packable into a produced block
        from ..state_transition import block as blk
        from ..state_transition.block import VerifySignatures
        scratch = self.chain.head().head_state.copy()
        verify = {
            "attester_slashings": blk.process_attester_slashing,
            "proposer_slashings": blk.process_proposer_slashing,
            "voluntary_exits": blk.process_voluntary_exit,
            "bls_to_execution_changes": blk.process_bls_to_execution_change,
        }[kind]
        try:
            verify(scratch, obj, VerifySignatures.TRUE)
        except Exception as e:
            raise ApiError(400, f"invalid {kind}: {e}")
        pool = self.chain.op_pool
        {"attester_slashings": pool.insert_attester_slashing,
         "proposer_slashings": pool.insert_proposer_slashing,
         "voluntary_exits": pool.insert_voluntary_exit,
         "bls_to_execution_changes":
             pool.insert_bls_to_execution_change}[kind](obj)

    def validator_balances(self, state_id: str,
                           ids: list[int] | None) -> list[dict]:
        st = self._resolve_state(state_id)
        idx = ids if ids is not None else range(len(st.balances))
        return [{"index": str(i), "balance": str(int(st.balances[i]))}
                for i in idx if i < len(st.balances)]

    def state_committees(self, state_id: str, epoch: int | None,
                         slot: int | None = None) -> list[dict]:
        from ..state_transition.helpers import get_beacon_committee
        st = self._resolve_state(state_id)
        p = self.chain.spec.preset
        epoch = epoch if epoch is not None else st.current_epoch()
        out = []
        from ..state_transition.helpers import get_committee_count_per_slot
        for s in range(epoch * p.slots_per_epoch,
                       (epoch + 1) * p.slots_per_epoch):
            if slot is not None and s != slot:
                continue
            n = get_committee_count_per_slot(st, epoch)
            for ci in range(n):
                members = get_beacon_committee(st, s, ci)
                out.append({"index": str(ci), "slot": str(s),
                            "validators": [str(int(v)) for v in members]})
        return out

    def state_sync_committees(self, state_id: str) -> dict:
        st = self._resolve_state(state_id)
        if st.current_sync_committee is None:
            raise ApiError(400, "pre-altair state has no sync committee")
        idx = []
        for pk in st.current_sync_committee.pubkeys:
            i = st.validators.index_of(bytes(pk))
            if i is None:
                raise ApiError(500, "sync committee pubkey not in state")
            idx.append(str(i))
        return {"validators": idx}

    def state_randao(self, state_id: str, epoch: int | None) -> dict:
        st = self._resolve_state(state_id)
        e = epoch if epoch is not None else st.current_epoch()
        return {"randao": "0x" + st.get_randao_mix(e).hex()}

    def block_root(self, block_id: str) -> bytes:
        _root, blk = self._resolve_block(block_id)
        return _root

    def block_attestations(self, block_id: str) -> list[dict]:
        from ..ssz import serialize
        _root, blk = self._resolve_block(block_id)
        return [{"ssz": serialize(type(a).ssz_type, a).hex()}
                for a in blk.message.body.attestations]

    def blob_sidecars(self, block_id: str) -> list[dict]:
        from ..ssz import serialize
        root, _blk = self._resolve_block(block_id)
        dac = self.chain.data_availability_checker
        out = []
        with dac._lock:
            pending = dac._pending.get(root)
            sidecars = list(pending.sidecars.values()) if pending else []
        for sc in sidecars:
            out.append({"index": str(sc.index),
                        "kzg_commitment": "0x"
                        + bytes(sc.kzg_commitment).hex()})
        return out

    def headers(self, slot: int | None, parent_root: bytes | None
                ) -> list[dict]:
        if slot is None:
            slot = self.chain.head().head_state.slot
        root = self.chain.block_root_at_slot(slot)
        if root is None:
            return []
        blk = self.chain.store.get_block(root)
        if blk is None or blk.message.slot != slot:
            return []                      # skipped slot: empty, not the
        hdr = self.block_header("0x" + root.hex())  # prior block's header
        if parent_root is not None and \
                hdr["header"]["message"]["parent_root"] != \
                "0x" + parent_root.hex():
            return []
        return [hdr]

    # -- rewards (http_api rewards routes) -----------------------------------

    def block_rewards(self, block_id: str) -> dict:
        _root, blk = self._resolve_block(block_id)
        body = blk.message.body
        n_atts = len(body.attestations)
        sync_bits = 0
        if hasattr(body, "sync_aggregate"):
            sync_bits = sum(1 for b in
                            body.sync_aggregate.sync_committee_bits if b)
        return {"proposer_index": str(blk.message.proposer_index),
                "total": str(n_atts + sync_bits),
                "attestations": str(n_atts),
                "sync_aggregate": str(sync_bits),
                "proposer_slashings": str(len(body.proposer_slashings)),
                "attester_slashings": str(len(body.attester_slashings))}

    def attestation_rewards(self, epoch: int,
                            ids: list[int] | None) -> dict:
        """Per-validator ideal/actual attestation rewards for an epoch
        (flag-weight accounting on the epoch-end state)."""
        from ..specs.constants import (
            PARTICIPATION_FLAG_WEIGHTS, WEIGHT_DENOMINATOR,
        )
        p = self.chain.spec.preset
        st = self._resolve_state(str((epoch + 1) * p.slots_per_epoch))
        if st.previous_epoch_participation is None:
            raise ApiError(400, "phase0 rewards unsupported")
        import numpy as np
        part = st.previous_epoch_participation
        eb = st.validators.effective_balance
        inc = p.effective_balance_increment
        total = [] 
        idx = ids if ids is not None else range(len(part))
        out = []
        for i in idx:
            if i >= len(part):
                continue
            flags = int(part[i])
            reward = 0
            for fi, w in enumerate(PARTICIPATION_FLAG_WEIGHTS):
                if flags >> fi & 1:
                    reward += int(eb[i]) // inc * w // WEIGHT_DENOMINATOR
            out.append({"validator_index": str(i), "head": str(reward),
                        "target": str(reward), "source": str(reward)})
        return {"ideal_rewards": [], "total_rewards": out}

    def sync_committee_rewards(self, block_id: str,
                               ids: list[int] | None) -> list[dict]:
        _root, blk = self._resolve_block(block_id)
        body = blk.message.body
        if not hasattr(body, "sync_aggregate"):
            raise ApiError(400, "pre-altair block")
        bits = body.sync_aggregate.sync_committee_bits
        st = self.chain.head().head_state
        out = []
        if st.current_sync_committee is None:
            return out
        for pos, bit in enumerate(bits):
            if pos >= len(st.current_sync_committee.pubkeys):
                break
            pk = bytes(st.current_sync_committee.pubkeys[pos])
            vi = st.validators.index_of(pk)
            if vi is None or (ids is not None and vi not in ids):
                continue
            out.append({"validator_index": str(vi),
                        "reward": "1" if bit else "-1"})
        return out

    # -- light client --------------------------------------------------------

    def light_client_bootstrap(self, block_root_hex: str) -> dict:
        root = bytes.fromhex(block_root_hex[2:])
        bs = self.chain.light_client_cache.produce_bootstrap(root)
        if bs is None:
            raise ApiError(404, "no bootstrap for root")
        return {"header_slot": str(bs.header.beacon.slot),
                "current_sync_committee_branch":
                    ["0x" + b.hex() for b in bs.current_sync_committee_branch]}

    def light_client_finality_update(self) -> dict:
        u = self.chain.light_client_cache.latest_finality_update
        if u is None:
            raise ApiError(404, "no finality update")
        return {"attested_slot": str(u.attested_header.beacon.slot),
                "finalized_slot": str(u.finalized_header.beacon.slot)}

    def light_client_optimistic_update(self) -> dict:
        u = self.chain.light_client_cache.latest_optimistic_update
        if u is None:
            raise ApiError(404, "no optimistic update")
        return {"attested_slot": str(u.attested_header.beacon.slot)}

    def light_client_updates(self, start_period: int, count: int) -> list:
        ups = self.chain.light_client_cache.updates_by_range(start_period,
                                                            count)
        return [{"attested_slot": str(u.attested_header.beacon.slot),
                 "signature_slot": str(u.signature_slot)} for u in ups]

    # -- config --------------------------------------------------------------

    def config_spec(self) -> dict:
        spec = self.chain.spec
        p = spec.preset
        return {"PRESET_BASE": p.name,
                "SECONDS_PER_SLOT": str(spec.seconds_per_slot),
                "SLOTS_PER_EPOCH": str(p.slots_per_epoch),
                "MAX_COMMITTEES_PER_SLOT": str(p.max_committees_per_slot),
                "TARGET_COMMITTEE_SIZE": str(p.target_committee_size),
                "SHARD_COMMITTEE_PERIOD": str(spec.shard_committee_period),
                "GENESIS_FORK_VERSION": "0x"
                + spec.genesis_fork_version.hex(),
                "EFFECTIVE_BALANCE_INCREMENT":
                    str(p.effective_balance_increment),
                "MAX_EFFECTIVE_BALANCE": str(p.max_effective_balance),
                "VALIDATOR_REGISTRY_LIMIT":
                    str(p.validator_registry_limit)}

    def fork_schedule(self) -> list[dict]:
        spec = self.chain.spec
        out = []
        prev = spec.genesis_fork_version
        from ..specs.constants import FAR_FUTURE_EPOCH
        for fork in ForkName:
            epoch = spec.fork_epoch(fork)
            if epoch >= FAR_FUTURE_EPOCH:
                continue
            version = spec.fork_version(fork)
            out.append({"previous_version": "0x" + prev.hex(),
                        "current_version": "0x" + version.hex(),
                        "epoch": str(epoch)})
            prev = version
        return out

    def deposit_contract(self) -> dict:
        return {"chain_id": "1", "address": "0x" + "00" * 20}

    # -- node / debug --------------------------------------------------------

    def node_identity(self) -> dict:
        """Real identity: the transport peer id, the signed discovery ENR
        in its EIP-778 text form when discovery is attached, multiaddr
        listen addresses, and the attnets the node actually serves."""
        net = getattr(self.chain, "network_service", None)
        disc = getattr(self.chain, "discovery", None)
        if net is None:
            return {"peer_id": "0" * 16, "enr": "",
                    "p2p_addresses": [], "discovery_addresses": [],
                    "metadata": {"seq_number": "0",
                                 "attnets": "0x" + "00" * 8,
                                 "syncnets": "0x00"}}
        attnets = 0
        for subnet in getattr(net, "attnet_subnets", []):
            attnets |= 1 << subnet
        # syncnets mirrors attnets: a 1-byte LE bitfield of the
        # sync-committee subnets this node serves (metadata v2)
        syncnets = 0
        for subnet in getattr(net, "syncnet_subnets", []):
            syncnets |= 1 << subnet
        enr_text, disc_addrs, seq = "", [], 1
        if disc is not None:
            enr_text = disc.enr.to_text()
            seq = int(disc.enr.seq)
            disc_addrs = [f"/ip4/{disc.disc.ip}/udp/{disc.disc.port}"]
        return {
            "peer_id": net.transport.node_id,
            "enr": enr_text,
            "p2p_addresses":
                [f"/ip4/{net.transport.host}/tcp/{net.transport.port}"],
            "discovery_addresses": disc_addrs,
            "metadata": {"seq_number": str(seq),
                         "attnets": "0x" + attnets.to_bytes(
                             8, "little").hex(),
                         "syncnets": "0x" + syncnets.to_bytes(
                             1, "little").hex()}}

    def node_peers(self, states: list | None = None,
                   directions: list | None = None) -> list[dict]:
        """Spec-shaped peer rows with real direction + last-seen
        multiaddr from the transport; the query filters are REPEATABLE
        with OR semantics like the reference (?state=a&state=b)."""
        net = getattr(self.chain, "network_service", None)
        if net is None:
            return []
        out = []
        for info in net.peers.connected():
            peer = net.transport.peers.get(info.node_id)
            if peer is None:
                # mid-disconnect race: the transport already dropped it;
                # reporting it as connected/inbound would be wrong both
                # ways
                continue
            host, port = peer.addr[0], peer.addr[1]
            out.append({"peer_id": info.node_id, "state": "connected",
                        "direction": ("outbound" if peer.outbound
                                      else "inbound"),
                        "last_seen_p2p_address":
                            f"/ip4/{host}/tcp/{port}",
                        "score": str(info.score)})
        if states:
            out = [p for p in out if p["state"] in states]
        if directions:
            out = [p for p in out if p["direction"] in directions]
        return out

    def node_peer(self, peer_id: str) -> dict:
        for p in self.node_peers():
            if p["peer_id"] == peer_id:
                return p
        raise ApiError(404, "peer not found")

    def node_peer_count(self) -> dict:
        n = len(self.node_peers())
        return {"connected": str(n), "connecting": "0",
                "disconnected": "0", "disconnecting": "0"}

    def debug_heads(self) -> list[dict]:
        fc = self.chain.fork_choice
        heads = []
        for node in fc.proto_array.nodes:
            if node is None:
                continue
            if not any(n is not None and n.parent is not None
                       and fc.proto_array.nodes[n.parent] is node
                       for n in fc.proto_array.nodes):
                heads.append({"root": "0x" + node.root.hex(),
                              "slot": str(node.slot)})
        return heads

    def debug_fork_choice(self) -> dict:
        fc = self.chain.fork_choice
        nodes = []
        for node in fc.proto_array.nodes:
            if node is None:
                continue
            nodes.append({"slot": str(node.slot),
                          "block_root": "0x" + node.root.hex(),
                          "weight": str(node.weight),
                          "execution_status":
                              node.execution_status.name.lower()})
        return {"justified_checkpoint": {
                    "epoch": str(fc.justified_checkpoint[0]),
                    "root": "0x" + fc.justified_checkpoint[1].hex()},
                "finalized_checkpoint": {
                    "epoch": str(fc.finalized_checkpoint[0]),
                    "root": "0x" + fc.finalized_checkpoint[1].hex()},
                "fork_choice_nodes": nodes}

    def debug_state_ssz(self, state_id: str) -> bytes:
        return self._resolve_state(state_id).serialize()

    def expected_withdrawals(self, state_id: str) -> list[dict]:
        """GET /eth/v1/builder/states/{id}/expected_withdrawals."""
        from ..state_transition.block import get_expected_withdrawals
        state = self._resolve_state(state_id)
        if not hasattr(state, "next_withdrawal_index"):
            raise ApiError(400, "pre-capella state has no withdrawals")
        expected, _partials = get_expected_withdrawals(state)
        return [{
            "index": str(w.index),
            "validator_index": str(w.validator_index),
            "address": "0x" + bytes(w.address).hex(),
            "amount": str(w.amount),
        } for w in expected]

    def validator_identities(self, state_id: str,
                             ids: list[int] | None) -> list[dict]:
        """GET /eth/v1/beacon/states/{id}/validator_identities."""
        state = self._resolve_state(state_id)
        n = len(state.validators)
        idxs = range(n) if not ids else [i for i in ids if 0 <= i < n]
        return [{
            "index": str(i),
            "pubkey": "0x" + state.validators.pubkey(i).hex(),
            "activation_epoch": str(
                int(state.validators.activation_epoch[i])),
        } for i in idxs]

    def publish_contribution_and_proofs(self, signed_list) -> None:
        """POST /eth/v1/validator/contribution_and_proofs."""
        from ..chain.errors import AttestationError
        for signed in signed_list:
            try:
                self.chain.sync_committee_pool.verify_and_add_contribution(
                    signed)
            except AttestationError as e:
                raise ApiError(400, f"contribution rejected: {e}")

    # -- validator extras ----------------------------------------------------

    def produce_block_ssz(self, slot: int, randao_reveal: bytes,
                          graffiti: bytes | None = None) -> bytes:
        from ..ssz import serialize
        block, _post = self.chain.produce_block(
            randao_reveal, slot, graffiti=graffiti)
        return serialize(type(block).ssz_type, block)

    def produce_blinded_block_ssz(self, slot: int, randao_reveal: bytes,
                                  graffiti: bytes | None = None) -> bytes:
        """BlindedBeaconBlock SSZ; the payload is withheld until the
        signed blinded block comes back through publish_blinded_block."""
        from ..containers.blinded import blind_block
        from ..specs.chain_spec import ForkName
        from ..ssz import serialize
        block, _post = self.chain.produce_block(
            randao_reveal, slot, graffiti=graffiti)
        if type(block).fork_name < ForkName.BELLATRIX:
            return serialize(type(block).ssz_type, block)   # no payloads yet
        blinded = blind_block(self.chain.T, block)
        payload = block.body.execution_payload
        self._blinded_payloads[payload.block_hash] = payload
        if len(self._blinded_payloads) > 64:
            self._blinded_payloads.pop(next(iter(self._blinded_payloads)))
        return serialize(type(blinded).ssz_type, blinded)

    def publish_blinded_block(self, body: bytes) -> None:
        """Accepts SignedBlindedBeaconBlock SSZ: unblind (payload cache,
        else the builder's blinded_blocks endpoint) and import."""
        from ..containers.blinded import unblind_signed_block
        from ..specs.chain_spec import ForkName
        from ..ssz import deserialize
        chain = self.chain
        fork = chain.spec.fork_name_at_slot(chain.slot())
        if fork < ForkName.BELLATRIX:
            # no blinded form pre-bellatrix: let the caller's full-block
            # fallback handle the body
            raise ValueError("blinded blocks need an execution fork")
        signed_blinded = deserialize(
            chain.T.SignedBlindedBeaconBlock[fork].ssz_type, body)
        header = signed_blinded.message.body.execution_payload_header
        # .get, not .pop: if the import below fails, the withheld payload
        # must survive for the VC's retry of the same signed block
        payload = self._blinded_payloads.get(header.block_hash)
        if payload is None and chain.builder is not None:
            pj = chain.builder.submit_blinded_block(header.block_hash)
            if pj is not None:
                from ..execution_layer.execution_layer import (
                    payload_from_json,
                )
                payload = payload_from_json(chain.T, fork, pj)
        if payload is None:
            raise ApiError(400, "unknown payload for blinded block")
        full = unblind_signed_block(chain.T, signed_blinded, payload)
        # consensus mode: import fully BEFORE broadcasting — an import
        # failure raises, so the withheld payload survives for the VC's
        # retry (gossip mode's 202 would silently drop it)
        self.publish_block(full, validation="consensus")
        self._blinded_payloads.pop(header.block_hash, None)

    def sync_committee_contribution(self, slot: int, subcommittee: int,
                                    beacon_block_root: bytes):
        contrib = self.chain.sync_committee_pool.produce_contribution(
            slot, beacon_block_root, subcommittee)
        if contrib is None:
            raise ApiError(404, "no contribution available")
        return contrib

    def subscribe_beacon_committee(self, subs: list[dict]) -> None:
        # subnet subscription bookkeeping (attestation_service.rs) — the
        # in-process gossip engine subscribes to every subnet already, so
        # record only
        self._committee_subscriptions = getattr(
            self, "_committee_subscriptions", [])
        self._committee_subscriptions += subs

    def subscribe_sync_committee(self, subs: list[dict]) -> None:
        self._sync_subscriptions = getattr(self, "_sync_subscriptions", [])
        self._sync_subscriptions += subs

    # -- lighthouse extensions ----------------------------------------------

    def validator_inclusion_global(self, epoch: int) -> dict:
        p = self.chain.spec.preset
        st = self._resolve_state("head")
        if st.previous_epoch_participation is None:
            raise ApiError(400, "phase0 unsupported")
        import numpy as np
        part = st.previous_epoch_participation
        eb = st.validators.effective_balance
        active = ((st.validators.activation_epoch <= epoch)
                  & (epoch < st.validators.exit_epoch))
        target = (part & 0b010) != 0
        return {
            "current_epoch_active_gwei": str(int(eb[active].sum())),
            "previous_epoch_target_attesting_gwei":
                str(int(eb[active & target].sum())),
        }

    def proto_array_nodes(self) -> list[dict]:
        return self.debug_fork_choice()["fork_choice_nodes"]

    # -- electra pending queues / deposits -----------------------------------

    def pending_queue(self, state_id: str, kind: str) -> list[dict]:
        st = self._resolve_state(state_id)
        items = getattr(st, kind, None)
        if items is None:
            return []
        out = []
        for it in items:
            d = {}
            for f in ("amount", "withdrawable_epoch", "index",
                      "source_index", "target_index", "slot"):
                if hasattr(it, f):
                    d[f] = str(getattr(it, f))
            out.append(d)
        return out

    def deposit_snapshot(self) -> dict:
        """The REAL EIP-4881 snapshot (finalized node hashes included) —
        a fresh node resumes the deposit tree from this instead of
        replaying historical logs (http_api get_deposit_snapshot)."""
        svc = self.chain.eth1_service
        if svc is None:
            # no eth1 tracker attached: the empty snapshot (deliberate
            # divergence from the reference's 404 — an offline/interop
            # node still answers with a resumable-from-genesis snapshot);
            # fresh dict per request, callers may post-process in place
            from ..eth1.deposit_snapshot import DepositTree
            return DepositTree().get_snapshot().to_json()
        return svc.get_deposit_snapshot().to_json()

    def deposit_cache(self) -> list[dict]:
        svc = self.chain.eth1_service
        if svc is None:
            return []
        return [{"index": str(i)} for i in range(len(
            getattr(svc, "deposits", [])))]

    def database_info(self) -> dict:
        """database_manager-grade info over HTTP (lighthouse/database/info):
        real schema version, hot/cold split point, and anchor."""
        store = self.chain.store
        anchor = store.backfill_anchor()
        split = store.split
        return {"schema_version": store.schema_version(),
                "split": {"slot": str(split.slot),
                          "state_root": "0x" + split.state_root.hex()},
                "anchor": ({"anchor_slot": str(anchor[0])}
                           if anchor else None)}

    def nat_open(self) -> bool:
        """/lighthouse/nat: a bare bool like the reference
        (system_health observe_nat) — True unless a UPnP attempt ran
        and failed to establish any mapping."""
        out = getattr(self.chain, "nat_outcome", None)
        return True if out is None else out.ok

    def nat_status(self) -> dict:
        """/lighthouse/nat/status (ours, beyond the reference): the
        UPnP attempt's full outcome; a single stable shape whether or
        not --upnp ran."""
        out = getattr(self.chain, "nat_outcome", None)
        if out is None:
            return {"attempted": False, "gateway": None, "mapped": [],
                    "error": None}
        return {"attempted": out.attempted,
                "gateway": out.gateway_location,
                "mapped": [list(m) for m in out.mapped],
                "error": out.error}

    def analysis_block_rewards(self, start_slot: int,
                               end_slot: int) -> list[dict]:
        out = []
        for s in range(start_slot, min(end_slot,
                                       self.chain.head().head_state.slot)
                       + 1):
            root = self.chain.block_root_at_slot(s)
            if root is None:
                continue
            try:
                out.append(self.block_rewards("0x" + root.hex()))
            except ApiError:
                continue
        return out

    # -- lighthouse analysis / ops extensions (ref
    # beacon_node/http_api/src/lib.rs:3925-4521 + watch/src/block_packing)

    def graffiti(self) -> dict:
        g = getattr(self.chain, "graffiti", b"\x00" * 32)
        return {"graffiti": "0x" + (g if isinstance(g, bytes)
                                    else bytes(32)).hex()}

    def merge_readiness(self) -> dict:
        st = self._resolve_state("head")
        merged = getattr(st, "latest_execution_payload_header", None) \
            is not None and \
            st.latest_execution_payload_header.block_hash != b"\x00" * 32
        return {"type": "ready" if merged else "not_synced",
                "current_difficulty": "0",
                "terminal_total_difficulty":
                    str(self.chain.spec.terminal_total_difficulty)}

    def eth1_syncing(self) -> dict:
        svc = self.chain.eth1_service
        return {"eth1_node_sync_status_percentage": 100.0,
                "lighthouse_is_cached_and_ready":
                    bool(svc is not None)}

    def eth1_block_cache(self) -> list[dict]:
        svc = self.chain.eth1_service
        blocks = getattr(svc, "block_cache", None) if svc else None
        if not blocks:
            return []
        return [{"number": str(getattr(b, "number", i))}
                for i, b in enumerate(blocks)]

    def analysis_block_packing(self, start_epoch: int,
                               end_epoch: int) -> list[dict]:
        """Per-block attestation packing efficiency: included attester
        seats vs the seats attesting in the slots the block could pack
        (watch/src/block_packing)."""
        p = self.chain.spec.preset
        head = self.chain.head().head_state
        head_slot = int(head.slot)
        epoch_now = head.current_epoch()
        active = int(((head.validators.activation_epoch <= epoch_now)
                      & (epoch_now < head.validators.exit_epoch)).sum())
        seats_per_slot = max(1, active // p.slots_per_epoch)
        out = []
        for epoch in range(start_epoch, end_epoch + 1):
            for s in range(epoch * p.slots_per_epoch,
                           (epoch + 1) * p.slots_per_epoch):
                if s > head_slot:
                    break
                root = self.chain.block_root_at_slot(s)
                if root is None:
                    continue
                blk = self.chain.store.get_block(root)
                if blk is None or blk.message.slot != s:
                    continue
                # dedupe seats per (slot, committee): overlapping
                # aggregates must not double-count attesters
                union: dict[tuple, int] = {}
                for a in blk.message.body.attestations:
                    bits = 0
                    for bi, b in enumerate(a.aggregation_bits):
                        if b:
                            bits |= 1 << bi
                    key = (int(a.data.slot), int(a.data.index))
                    union[key] = union.get(key, 0) | bits
                included = sum(bin(v).count("1") for v in union.values())
                # attestable window: the prior epoch of slots (phase0
                # inclusion window), truncated at genesis
                window = min(s, p.slots_per_epoch)
                available = max(1, seats_per_slot * window)
                out.append({
                    "slot": str(s),
                    "block_root": "0x" + root.hex(),
                    "proposer_index": int(blk.message.proposer_index),
                    "attestations_included": included,
                    "attestations_available": available,
                    "packing_efficiency": min(1.0, included / available)})
        return out

    def analysis_attestation_performance(self, index: str,
                                         start_epoch: int,
                                         end_epoch: int) -> list[dict]:
        """Per-validator (or global) attestation performance from the
        participation flags (watch/src/suboptimal_attestations).  Only
        the head state's previous epoch is reconstructible from live
        data; the requested range is clamped to it (each record carries
        the epoch it describes)."""
        st = self._resolve_state("head")
        if st.previous_epoch_participation is None:
            raise ApiError(400, "phase0 unsupported")
        part = st.previous_epoch_participation
        n = len(part)
        if index == "global":
            ids = range(n)
        elif index.startswith("0x"):
            idx = self.get_validator_index(bytes.fromhex(index[2:]))
            if idx is None:
                raise ApiError(404, "unknown validator")
            ids = [idx]
        else:
            ids = [int(index)]
        prev_epoch = max(0, st.current_epoch() - 1)
        if not (start_epoch <= prev_epoch <= end_epoch):
            return []
        out = []
        for i in ids:
            if i >= n:
                raise ApiError(404, "unknown validator")
            flags = int(part[i])
            out.append({
                "index": i,
                "epoch": int(prev_epoch),
                "is_active": bool(
                    st.validators.activation_epoch[i]
                    <= st.current_epoch() < st.validators.exit_epoch[i]),
                "received_source": bool(flags & 0b001),
                "received_target": bool(flags & 0b010),
                "received_head": bool(flags & 0b100)})
        return out

    def validator_inclusion_validator(self, epoch: int,
                                      validator_id: str) -> dict:
        st = self._resolve_state("head")
        if st.previous_epoch_participation is None:
            raise ApiError(400, "phase0 unsupported")
        if validator_id.startswith("0x"):
            idx = self.get_validator_index(
                bytes.fromhex(validator_id[2:]))
            if idx is None:
                raise ApiError(404, "unknown validator")
        else:
            idx = int(validator_id)
        if idx >= len(st.previous_epoch_participation):
            raise ApiError(404, "unknown validator")
        flags = int(st.previous_epoch_participation[idx])
        active = bool(st.validators.activation_epoch[idx] <= epoch
                      < st.validators.exit_epoch[idx])
        return {
            "is_slashed": bool(st.validators.slashed[idx]),
            "is_withdrawable_in_current_epoch": bool(
                epoch >= st.validators.withdrawable_epoch[idx]),
            "is_active_unslashed_in_current_epoch": active
            and not bool(st.validators.slashed[idx]),
            "current_epoch_effective_balance_gwei":
                str(int(st.validators.effective_balance[idx])),
            "is_active_unslashed_in_previous_epoch": active
            and not bool(st.validators.slashed[idx]),
            "is_previous_epoch_target_attester": bool(flags & 0b010),
            "is_previous_epoch_head_attester": bool(flags & 0b100),
        }

    def fork_choice_heads_weights(self) -> list[dict]:
        return [{"root": n["block_root"], "weight": n["weight"]}
                for n in self.debug_fork_choice()["fork_choice_nodes"]]

    def sync_committee_duties_at(self, epoch: int) -> dict:
        st = self._duties_state(epoch * self.chain.spec.preset
                                .slots_per_epoch)
        return {"validator_count": len(st.validators)}

    def weak_subjectivity_checkpoint(self) -> dict:
        epoch, root = self.chain.finalized_checkpoint()
        return {"ws_checkpoint": "0x" + root.hex() + ":" + str(epoch),
                "is_safe": True,
                "current_epoch": str(self.chain.slot()
                                     // self.chain.spec.preset
                                     .slots_per_epoch)}

    def blinded_block_ssz(self, block_id: str) -> bytes:
        """Stored block in its blinded form (GET blinded_blocks/{id})."""
        from ..containers.blinded import blind_signed_block
        from ..ssz import serialize
        _root, blk = self._resolve_block(block_id)
        if type(blk).fork_name < ForkName.BELLATRIX:
            return serialize(type(blk).ssz_type, blk)
        blinded = blind_signed_block(self.chain.T, blk)
        return serialize(type(blinded).ssz_type, blinded)

    def ui_validator_metrics(self, indices: list[int]) -> dict:
        st = self._resolve_state("head")
        out = {}
        for i in indices:
            if i >= len(st.validators):
                continue
            flags = int(st.previous_epoch_participation[i]) \
                if st.previous_epoch_participation is not None else 0
            out[str(i)] = {
                "attestation_hits": bin(flags).count("1"),
                "attestation_misses": 3 - bin(flags).count("1"),
                "latest_attestation_inclusion_distance": 1}
        return {"validators": out}

    def ui_validator_info(self, indices: list[int]) -> dict:
        return {"validators": {
            str(v["index"]): {"info": v["validator"],
                              "balance": v["balance"],
                              "status": v["status"]}
            for v in self.validators("head", indices)}}

    def peers_connected(self) -> list[dict]:
        return [p for p in self.node_peers()
                if p.get("state") == "connected"]
