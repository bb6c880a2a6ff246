"""Sync-committee message verification + naive aggregation.

Equivalent of the reference's sync-committee gossip pipelines
(beacon_chain/src/sync_committee_verification.rs) and the naive aggregation
pool feeding block production's SyncAggregate.
"""
from __future__ import annotations

import threading
from collections import defaultdict

from ..crypto import bls
from ..specs.chain_spec import compute_signing_root
from ..specs.constants import DOMAIN_SYNC_COMMITTEE
from ..state_transition.helpers import get_domain
from .errors import AttestationError, BAD_SIGNATURE, PRIOR_SEEN


class SyncCommitteePool:
    """(slot, beacon_block_root) -> participation bits + aggregated sig."""

    def __init__(self, chain):
        self.chain = chain
        self._lock = threading.Lock()
        # (slot, root) -> {committee position -> signature}
        self._messages: dict[tuple, dict[int, bytes]] = defaultdict(dict)
        # (slot, root, subcommittee) -> best verified contribution
        self._contributions: dict[tuple, object] = {}

    def verify_and_add_message(self, msg) -> int:
        """Gossip path: verify a SyncCommitteeMessage and pool it. Returns
        the number of committee positions credited."""
        chain = self.chain
        state = chain.head().head_state
        committee = state.current_sync_committee
        vpk = state.validators.pubkey(msg.validator_index)
        positions = [i for i, pk in enumerate(committee.pubkeys)
                     if pk == vpk]
        if not positions:
            raise AttestationError("not_in_sync_committee",
                                   str(msg.validator_index))
        # check-before / observe-after signature verification, so a forged
        # message cannot block the validator's real one (same discipline as
        # attestation_verification)
        if chain.observed_sync_contributors.has_been_observed(
                msg.slot, msg.validator_index):
            raise AttestationError(PRIOR_SEEN, "sync contributor")
        domain = get_domain(state, DOMAIN_SYNC_COMMITTEE,
                            msg.slot // state.slots_per_epoch)
        signing_root = compute_signing_root(msg.beacon_block_root, domain)
        if not bls.verify(vpk, signing_root, msg.signature):
            raise AttestationError(BAD_SIGNATURE, "sync message")
        if chain.observed_sync_contributors.observe(msg.slot,
                                                    msg.validator_index):
            raise AttestationError(PRIOR_SEEN, "sync contributor")
        with self._lock:
            bucket = self._messages[(msg.slot, msg.beacon_block_root)]
            for p in positions:
                bucket[p] = msg.signature
        return len(positions)

    def verify_and_add_contribution(self, signed) -> int:
        """Gossip aggregate path (sync_committee_verification.rs
        SignedContributionAndProof): selection proof, aggregator
        signature, and the contribution's aggregate signature against the
        subcommittee pubkeys, then pool the contribution for block
        production.  Returns the number of set bits."""
        from ..specs.constants import (
            DOMAIN_CONTRIBUTION_AND_PROOF,
            DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
            SYNC_COMMITTEE_SUBNET_COUNT,
            TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE,
        )
        from ..ssz import htr
        from ..utils.hash import sha256
        chain = self.chain
        T = chain.T
        msg = signed.message
        contrib = msg.contribution
        state = chain.head().head_state
        epoch = contrib.slot // state.slots_per_epoch
        if contrib.subcommittee_index >= SYNC_COMMITTEE_SUBNET_COUNT:
            raise AttestationError("bad_subcommittee",
                                   str(contrib.subcommittee_index))
        committee = state.current_sync_committee
        size = chain.spec.preset.sync_committee_size
        sub_size = size // SYNC_COMMITTEE_SUBNET_COUNT
        if msg.aggregator_index >= len(state.validators):
            raise AttestationError("unknown_validator",
                                   str(msg.aggregator_index))
        agg_pk = state.validators.pubkey(msg.aggregator_index)
        # 1. the aggregator is selected: selection proof valid + modulo
        sel_data = T.SyncAggregatorSelectionData(
            slot=contrib.slot,
            subcommittee_index=contrib.subcommittee_index)
        sel_domain = get_domain(state,
                                DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
                                epoch)
        sel_root = compute_signing_root(htr(sel_data), sel_domain)
        if not bls.verify(agg_pk, sel_root, msg.selection_proof):
            raise AttestationError(BAD_SIGNATURE, "selection proof")
        modulo = max(1, sub_size // TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE)
        if int.from_bytes(sha256(bytes(msg.selection_proof))[:8],
                          "little") % modulo != 0:
            raise AttestationError("not_aggregator",
                                   str(msg.aggregator_index))
        # 2. aggregator signature over ContributionAndProof
        cp_domain = get_domain(state, DOMAIN_CONTRIBUTION_AND_PROOF, epoch)
        cp_root = compute_signing_root(htr(msg), cp_domain)
        if not bls.verify(agg_pk, cp_root, signed.signature):
            raise AttestationError(BAD_SIGNATURE, "aggregator sig")
        # 3. contribution aggregate signature by the set subcommittee keys
        start = contrib.subcommittee_index * sub_size
        pks = [bytes(committee.pubkeys[start + i])
               for i, b in enumerate(contrib.aggregation_bits) if b]
        if not pks:
            raise AttestationError("empty_contribution", "no bits")
        sc_domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch)
        sc_root = compute_signing_root(contrib.beacon_block_root, sc_domain)
        if not bls.fast_aggregate_verify(pks, sc_root, contrib.signature):
            raise AttestationError(BAD_SIGNATURE, "contribution sig")
        key = (int(contrib.slot), bytes(contrib.beacon_block_root),
               int(contrib.subcommittee_index))
        n_bits = sum(map(bool, contrib.aggregation_bits))
        with self._lock:
            cur = self._contributions.get(key)
            if cur is None or sum(map(bool, cur.aggregation_bits)) < n_bits:
                self._contributions[key] = contrib
        return n_bits

    def produce_sync_aggregate(self, slot: int, beacon_block_root: bytes):
        """Best SyncAggregate for a block at slot+1 (signed over `slot`):
        per subcommittee, the better of the pooled contribution and the
        individually-pooled messages."""
        from ..specs.constants import SYNC_COMMITTEE_SUBNET_COUNT
        T = self.chain.T
        size = self.chain.spec.preset.sync_committee_size
        sub_size = size // SYNC_COMMITTEE_SUBNET_COUNT
        with self._lock:
            bucket = dict(self._messages.get((slot, beacon_block_root), {}))
            contribs = {
                sc: self._contributions.get((slot, beacon_block_root, sc))
                for sc in range(SYNC_COMMITTEE_SUBNET_COUNT)}
        bits: list[bool] = []
        sigs: list[bytes] = []
        for sc in range(SYNC_COMMITTEE_SUBNET_COUNT):
            start = sc * sub_size
            msg_positions = [i for i in range(start, start + sub_size)
                             if i in bucket]
            contrib = contribs[sc]
            c_bits = (sum(map(bool, contrib.aggregation_bits))
                      if contrib is not None else 0)
            if contrib is not None and c_bits >= len(msg_positions):
                bits.extend(bool(b) for b in contrib.aggregation_bits)
                sigs.append(bytes(contrib.signature))
            else:
                bits.extend(i in bucket
                            for i in range(start, start + sub_size))
                sigs.extend(bucket[i] for i in msg_positions)
        agg = (bls.aggregate_signatures(sigs) if sigs
               else bls.INFINITY_SIGNATURE)
        return T.SyncAggregate(sync_committee_bits=bits,
                               sync_committee_signature=agg)

    def produce_contribution(self, slot: int, beacon_block_root: bytes,
                             subcommittee_index: int):
        """SyncCommitteeContribution for one subnet (VC aggregation duty)."""
        T = self.chain.T
        size = self.chain.spec.preset.sync_committee_size
        sub_size = size // 4
        start = subcommittee_index * sub_size
        with self._lock:
            bucket = dict(self._messages.get((slot, beacon_block_root), {}))
        bits = []
        sigs = []
        for i in range(start, start + sub_size):
            if i in bucket:
                bits.append(True)
                sigs.append(bucket[i])
            else:
                bits.append(False)
        if not sigs:
            return None
        return T.SyncCommitteeContribution(
            slot=slot, beacon_block_root=beacon_block_root,
            subcommittee_index=subcommittee_index,
            aggregation_bits=bits,
            signature=bls.aggregate_signatures(sigs))

    def prune(self, min_slot: int) -> None:
        with self._lock:
            for k in [k for k in self._messages if k[0] < min_slot]:
                del self._messages[k]
            for k in [k for k in self._contributions if k[0] < min_slot]:
                del self._contributions[k]
