"""Gossip attestation verification, single + batched.

Equivalent of the reference's beacon_node/beacon_chain/src/
attestation_verification.rs (:707-1062) and attestation_verification/batch.rs
(:28 aggregates, :133 unaggregated): the batch path builds one SignatureSet
per attestation from the pubkey cache and runs ONE `verify_signature_sets`
call — the card's batch workload — retrying individually on batch failure
so batching costs no fidelity (batch.rs:1-11).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..crypto import bls
from ..obs import tracing
from ..specs.chain_spec import ForkName, compute_domain, compute_signing_root
from ..specs.constants import (
    DOMAIN_AGGREGATE_AND_PROOF, DOMAIN_BEACON_ATTESTER,
    DOMAIN_SELECTION_PROOF, TARGET_AGGREGATORS_PER_COMMITTEE,
)
from ..ssz import htr, uint64, hash_tree_root
from ..state_transition.helpers import (
    attesting_indices_from_committees, compute_epoch_at_slot,
    get_beacon_committee, get_domain,
)
from ..state_transition.signature_sets import SignatureSetError, _pubkey
from .errors import (
    BAD_SIGNATURE, BAD_TARGET, EMPTY_AGGREGATION_BITS, NOT_AGGREGATOR,
    PAST_SLOT, PRIOR_SEEN, UNKNOWN_HEAD_BLOCK, AttestationError,
)

FUTURE_SLOT_ATT = "future_slot"


@dataclass
class VerifiedUnaggregatedAttestation:
    attestation: object
    indexed: object
    subnet_id: int


@dataclass
class VerifiedAggregatedAttestation:
    signed_aggregate: object
    indexed: object


def _common_checks(chain, attestation) -> None:
    data = attestation.data
    current_slot = chain.slot()
    spec = chain.spec
    # propagation slot range (attestation_verification.rs:707)
    if data.slot + spec.attestation_propagation_slot_range < current_slot:
        raise AttestationError(PAST_SLOT, f"slot {data.slot}")
    if data.slot > current_slot:
        # distinct kind so the processor can park-and-replay it
        raise AttestationError(FUTURE_SLOT_ATT, f"future slot {data.slot}")
    if data.target.epoch != compute_epoch_at_slot(
            data.slot, spec.preset.slots_per_epoch):
        raise AttestationError(BAD_TARGET, "target epoch != slot epoch")
    if not chain.fork_choice.contains_block(data.beacon_block_root):
        raise AttestationError(UNKNOWN_HEAD_BLOCK,
                               data.beacon_block_root.hex())
    if not chain.fork_choice.contains_block(data.target.root):
        raise AttestationError(BAD_TARGET, "unknown target root")
    if not chain.fork_choice.proto_array.is_descendant(
            data.target.root, data.beacon_block_root):
        raise AttestationError(BAD_TARGET, "head not descendant of target")


def _attestation_state(chain, attestation):
    """A state able to compute committees for the attestation's target."""
    return chain.state_for_attestation(attestation.data)


def _attestation_context(chain, attestation):
    """(committee_at, base_state) for verification WITHOUT a state replay:
    committees come from the chain-level ShufflingCache (shuffling_cache.rs
    promise — one replay per shuffling decision root, then dict hits) and
    pubkeys from the head state's registry (append-only; domains are
    spec-schedule-derived, so any base state works).  Falls back to the
    replay path only if a registry index is out of range (a fork with
    deposits our head hasn't processed)."""
    cc = chain.shuffling_cache.get_or_build(chain, attestation.data)

    def committee_at(slot, index):
        if index >= cc.committees_per_slot:
            raise AttestationError(BAD_TARGET,
                                   f"committee index {index} out of range")
        return cc.committee(slot, index)

    return committee_at, chain.head().head_state


def _indexed_via_cache(chain, committee_at, base_state, attestation):
    data = attestation.data
    electra = chain.spec.fork_name_at_slot(data.slot) >= ForkName.ELECTRA
    indices = [int(i) for i in attesting_indices_from_committees(
        committee_at, attestation, electra)]
    T = base_state.T
    cls = T.IndexedAttestationElectra if electra else T.IndexedAttestation
    return cls(attesting_indices=indices, data=data,
               signature=attestation.signature)


def _domain_at_epoch(chain, base_state, domain_type: int,
                     epoch: int) -> bytes:
    version = chain.spec.fork_version(chain.spec.fork_name_at_epoch(epoch))
    return compute_domain(domain_type, version,
                          base_state.genesis_validators_root)


def _verification_providers(chain, attestation):
    """Yield (committee_at, pubkey_fn, domain_fn) provider triples: first
    the cache-backed fast set (no state replay), then — only if the fast
    set raises IndexError/SignatureSetError, i.e. the head registry lags
    the attestation's chain — the state-replay set.  One shared checks
    body runs against whichever set works, so the fast path and the
    fallback can never diverge."""
    committee_at, base = _attestation_context(chain, attestation)
    yield (committee_at,
           lambda i: _pubkey(base, i),
           lambda dt, ep: _domain_at_epoch(chain, base, dt, ep),
           base)
    state = _attestation_state(chain, attestation)
    yield (lambda s, i: get_beacon_committee(state, s, i),
           lambda i: _pubkey(state, i),
           lambda dt, ep: get_domain(state, dt, ep),
           state)


def _indexed_and_set(chain, attestation, committee_at, pubkey_fn,
                     domain_fn, base_state):
    indexed = _indexed_via_cache(chain, committee_at, base_state,
                                 attestation)
    if not indexed.attesting_indices:
        raise AttestationError(EMPTY_AGGREGATION_BITS, "no attester")
    domain = domain_fn(DOMAIN_BEACON_ATTESTER, indexed.data.target.epoch)
    signing_root = compute_signing_root(htr(indexed.data), domain)
    pks = [pubkey_fn(i) for i in indexed.attesting_indices]
    return indexed, bls.SignatureSet(indexed.signature, pks, signing_root)


def verify_unaggregated_checks(chain, attestation,
                               subnet_id: int | None = None):
    """All checks except the signature; returns (indexed, state, set)."""
    _common_checks(chain, attestation)
    if sum(1 for b in attestation.aggregation_bits if b) != 1:
        raise AttestationError(EMPTY_AGGREGATION_BITS,
                               "unaggregated must have exactly one bit")
    providers = _verification_providers(chain, attestation)
    try:
        committee_at, pubkey_fn, domain_fn, base = next(providers)
        indexed, s = _indexed_and_set(chain, attestation, committee_at,
                                      pubkey_fn, domain_fn, base)
    except (IndexError, SignatureSetError):
        committee_at, pubkey_fn, domain_fn, base = next(providers)
        indexed, s = _indexed_and_set(chain, attestation, committee_at,
                                      pubkey_fn, domain_fn, base)
    validator = indexed.attesting_indices[0]
    if chain.observed_attesters.has_been_observed(
            attestation.data.target.epoch, validator):
        # the gossip pipeline dedups per (epoch, validator) BEFORE the
        # signature check, but a second distinct vote from the same
        # validator is exactly what the slasher exists to see — verify
        # its signature here (so the slasher only ever ingests
        # authenticated messages) and feed it before rejecting
        sl = getattr(chain, "slasher", None)
        if sl is not None and bls.verify_signature_sets([s]):
            sl.accept_attestation(indexed)
        raise AttestationError(PRIOR_SEEN, f"validator {validator}")
    return indexed, base, s


def finalize_unaggregated(chain, attestation, indexed,
                          subnet_id) -> VerifiedUnaggregatedAttestation:
    # every path into finalize has a verified signature (single, batch,
    # or per-item fallback) — the slasher feed point for gossip
    # attestations (slasher feed discipline: authenticated input only)
    sl = getattr(chain, "slasher", None)
    if sl is not None:
        sl.accept_attestation(indexed)
    # re-check after signature verification so duplicates *within* one batch
    # are caught (attestation_verification.rs:968-971)
    already = chain.observed_attesters.observe(
        attestation.data.target.epoch, indexed.attesting_indices[0])
    if already:
        raise AttestationError(PRIOR_SEEN,
                               f"validator {indexed.attesting_indices[0]}")
    return VerifiedUnaggregatedAttestation(attestation, indexed,
                                           subnet_id or 0)


def verify_unaggregated_for_gossip(chain, attestation,
                                   subnet_id: int | None = None
                                   ) -> VerifiedUnaggregatedAttestation:
    with tracing.span("attestation_verify"):
        indexed, state, s = verify_unaggregated_checks(chain, attestation,
                                                       subnet_id)
        if not bls.verify_signature_sets([s]):
            raise AttestationError(BAD_SIGNATURE, "attestation signature")
        return finalize_unaggregated(chain, attestation, indexed, subnet_id)


def batch_verify_unaggregated_for_gossip(chain, attestations: list
                                         ) -> list:
    """Batch path (batch.rs:133): one multi-set verification; on failure,
    falls back to per-attestation verification. Returns a list of
    VerifiedUnaggregatedAttestation | AttestationError."""
    with tracing.span("attestation_verify", batch=len(attestations)):
        return _batch_verify_unaggregated(chain, attestations)


def _batch_verify_unaggregated(chain, attestations: list) -> list:
    prepared = []
    results: list = [None] * len(attestations)
    for i, (att, subnet) in enumerate(attestations):
        try:
            prepared.append((i, att, subnet,
                             *verify_unaggregated_checks(chain, att, subnet)))
        except AttestationError as e:
            results[i] = e
    sets = [p[5] for p in prepared]
    if sets and bls.verify_signature_sets(sets):
        for i, att, subnet, indexed, _state, _s in prepared:
            try:
                results[i] = finalize_unaggregated(chain, att, indexed,
                                                   subnet)
            except AttestationError as e:
                results[i] = e
    else:
        # fallback splitting: the fused multi-set verification failed, so
        # at least one signature is invalid — retry per item so the good
        # attestations in the batch still land (batch.rs:133 behavior)
        if sets:
            from ..api import metrics_defs as M
            M.count("beacon_batch_verify_fallback_total")
        for i, att, subnet, indexed, _state, s in prepared:
            try:
                if bls.verify_signature_sets([s]):
                    results[i] = finalize_unaggregated(chain, att, indexed,
                                                       subnet)
                else:
                    results[i] = AttestationError(BAD_SIGNATURE,
                                                  "batch retry")
            except AttestationError as e:
                results[i] = e
    return results


# -- aggregates --------------------------------------------------------------

def is_aggregator(committee_len: int, selection_proof: bytes) -> bool:
    modulo = max(1, committee_len // TARGET_AGGREGATORS_PER_COMMITTEE)
    h = hashlib.sha256(selection_proof).digest()
    return int.from_bytes(h[:8], "little") % modulo == 0


def verify_aggregated_checks(chain, signed_aggregate):
    msg = signed_aggregate.message
    aggregate = msg.aggregate
    _common_checks(chain, aggregate)
    data = aggregate.data
    if chain.observed_aggregators.has_been_observed(
            data.slot, msg.aggregator_index):
        raise AttestationError(PRIOR_SEEN,
                               f"aggregator {msg.aggregator_index}")
    if chain.observed_aggregates.is_known_subset(
            data.slot, htr(data), tuple(aggregate.aggregation_bits)):
        raise AttestationError(PRIOR_SEEN, "aggregate subset known")

    def body(committee_at, pubkey_fn, domain_fn, base):
        committee = committee_at(data.slot, data.index)
        if not is_aggregator(len(committee), msg.selection_proof):
            raise AttestationError(NOT_AGGREGATOR, "")
        if msg.aggregator_index not in [int(i) for i in committee]:
            raise AttestationError(NOT_AGGREGATOR, "not in committee")
        indexed, set_attestation = _indexed_and_set(
            chain, aggregate, committee_at, pubkey_fn, domain_fn, base)
        # three signature sets per aggregate (batch.rs:60-103)
        epoch = compute_epoch_at_slot(data.slot,
                                      chain.spec.preset.slots_per_epoch)
        agg_pk = pubkey_fn(msg.aggregator_index)
        sel_root = compute_signing_root(
            hash_tree_root(uint64, data.slot),
            domain_fn(DOMAIN_SELECTION_PROOF, epoch))
        set_selection = bls.SignatureSet(msg.selection_proof, [agg_pk],
                                         sel_root)
        agg_root = compute_signing_root(
            htr(msg), domain_fn(DOMAIN_AGGREGATE_AND_PROOF, epoch))
        set_aggregator = bls.SignatureSet(signed_aggregate.signature,
                                          [agg_pk], agg_root)
        return indexed, [set_selection, set_aggregator, set_attestation]

    providers = _verification_providers(chain, aggregate)
    try:
        return body(*next(providers))
    except (IndexError, SignatureSetError):
        return body(*next(providers))


def finalize_aggregated(chain, signed_aggregate,
                        indexed) -> VerifiedAggregatedAttestation:
    msg = signed_aggregate.message
    data = msg.aggregate.data
    sl = getattr(chain, "slasher", None)
    if sl is not None:
        sl.accept_attestation(indexed)
    already = chain.observed_aggregators.observe(data.slot,
                                                 msg.aggregator_index)
    if already:
        raise AttestationError(PRIOR_SEEN,
                               f"aggregator {msg.aggregator_index}")
    chain.observed_aggregates.observe(
        data.slot, htr(data), tuple(msg.aggregate.aggregation_bits))
    return VerifiedAggregatedAttestation(signed_aggregate, indexed)


def verify_aggregated_for_gossip(chain, signed_aggregate
                                 ) -> VerifiedAggregatedAttestation:
    with tracing.span("aggregate_verify"):
        indexed, sets = verify_aggregated_checks(chain, signed_aggregate)
        if not bls.verify_signature_sets(sets):
            raise AttestationError(BAD_SIGNATURE, "aggregate signatures")
        return finalize_aggregated(chain, signed_aggregate, indexed)


def batch_verify_aggregated_for_gossip(chain, aggregates: list) -> list:
    """Batch aggregates: 3 sets each, one verification (batch.rs:28)."""
    with tracing.span("aggregate_verify", batch=len(aggregates)):
        return _batch_verify_aggregated(chain, aggregates)


def _batch_verify_aggregated(chain, aggregates: list) -> list:
    prepared = []
    results: list = [None] * len(aggregates)
    for i, agg in enumerate(aggregates):
        try:
            indexed, sets = verify_aggregated_checks(chain, agg)
            prepared.append((i, agg, indexed, sets))
        except AttestationError as e:
            results[i] = e
    all_sets = [s for p in prepared for s in p[3]]
    if all_sets and bls.verify_signature_sets(all_sets):
        for i, agg, indexed, _sets in prepared:
            try:
                results[i] = finalize_aggregated(chain, agg, indexed)
            except AttestationError as e:
                results[i] = e
    else:
        if all_sets:
            from ..api import metrics_defs as M
            M.count("beacon_batch_verify_fallback_total")
        for i, agg, indexed, sets in prepared:
            try:
                if bls.verify_signature_sets(sets):
                    results[i] = finalize_aggregated(chain, agg, indexed)
                else:
                    results[i] = AttestationError(BAD_SIGNATURE,
                                                  "batch retry")
            except AttestationError as e:
                results[i] = e
    return results
