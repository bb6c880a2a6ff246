"""The block workload of the card: a mainnet-preset Altair BeaconState and a
block that fully covers the prior slot, its signatures real.

The state and the block follow the JAX package's ``bench.py``
``build_beacon_state`` and ``_build_import_block`` step by step (the same
generators, in the same order; 1,000,000 validators at slot
``100_000 * 32 + 2``). Two things differ:

- the signers' registry rows hold interop pubkeys
  (``sk_to_pk(keygen_interop(row))``): the block's proposer, every member
  of the prior slot's committees, and rows 0 to 511, which make the sync
  committee. Pubkeys decide none of these choices, so the rows are chosen
  first and the keys written after, before any root is taken, and the
  sync committee is built from rows 0 to 511 once they hold their keys;
- the signatures are real. Each aggregate is signed once with the sum of
  its members' secret keys mod r: BLS is linear, so this is the aggregate
  of the members' own signatures. The proposal and the randao reveal are
  the proposer's.

``build_workload(..., signed=False)`` puts ``bench.py``'s placeholder
signature everywhere instead. ``write_signers`` works on either
package's state, so a test can rewrite the same rows of a state that
``bench.py`` built. Host only (numpy and the BLS host backends).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from .containers import get_types
from .containers.state import BeaconState, ValidatorRegistry
from .crypto.bls import keygen_interop
from .crypto.bls12_381.fields import R as CURVE_ORDER
from .seeded_state import STATE_SEED, seeded_columns
from .specs.chain_spec import ForkName, compute_signing_root, mainnet_spec
from .specs.constants import (
    DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER, DOMAIN_RANDAO,
    DOMAIN_SYNC_COMMITTEE,
)
from .ssz import deserialize, hash_tree_root, htr, serialize, uint64
from .state_transition.helpers import (
    committee_cache, get_beacon_proposer_index, get_domain,
)

#: the workload of ``bench.py`` ``bench_state_transition``: its registry
#: size and its mid-epoch slot, far from a sync-committee period boundary
N_VALIDATORS = 1_000_000
SLOT = 100_000 * 32 + 2
#: the slot ``bench.py`` sets before its epoch run: the last of SLOT's
#: epoch (mainnet's 32 slots an epoch)
EPOCH_SLOT = SLOT // 32 * 32 + 31
#: ``bench.py``'s signature on every signed field of its block
PLACEHOLDER_SIGNATURE = b"\x80" + b"\x00" * 95


def build_state(n: int = N_VALIDATORS, slot: int = SLOT) -> BeaconState:
    """``bench.py`` ``build_beacon_state(n, slot)``, with its random
    pubkeys (``write_signers`` rewrites the signers' rows)."""
    spec = mainnet_spec()
    T = get_types(spec.preset)
    state = BeaconState(T, spec, ForkName.ALTAIR)
    rng = np.random.default_rng(STATE_SEED)
    columns = seeded_columns(n, STATE_SEED)
    # ETH1-credential prefix, as bench.py writes it
    columns["withdrawal_credentials"][:, 0] = 0x01
    registry = ValidatorRegistry()
    for name in registry.COLUMNS:
        setattr(registry, name, columns[name])
    registry.mark_dirty()
    state.validators = registry
    state.balances = columns["balances"]
    state.slot = slot
    epoch = slot // T.preset.slots_per_epoch
    state.fork = T.Fork(previous_version=spec.altair_fork_version,
                        current_version=spec.altair_fork_version, epoch=0)
    state.latest_block_header = T.BeaconBlockHeader(
        slot=slot - 1, proposer_index=0, parent_root=b"\x11" * 32,
        state_root=b"\x22" * 32, body_root=b"\x33" * 32)
    state.block_roots = rng.integers(
        0, 256, size=state.block_roots.shape, dtype=np.uint8)
    state.state_roots = rng.integers(
        0, 256, size=state.state_roots.shape, dtype=np.uint8)
    state.randao_mixes = rng.integers(
        0, 256, size=state.randao_mixes.shape, dtype=np.uint8)
    state.previous_epoch_participation = np.full(n, 0b0111, np.uint8)
    cur = np.zeros(n, np.uint8)
    elapsed = slot % T.preset.slots_per_epoch
    attested = rng.random(n) < elapsed / T.preset.slots_per_epoch
    cur[attested] = 0b0111
    state.current_epoch_participation = cur
    state.inactivity_scores = np.zeros(n, np.uint64)
    state.previous_justified_checkpoint = T.Checkpoint(
        epoch=epoch - 2, root=b"\x44" * 32)
    state.current_justified_checkpoint = T.Checkpoint(
        epoch=epoch - 1, root=b"\x55" * 32)
    state.finalized_checkpoint = T.Checkpoint(
        epoch=epoch - 2, root=b"\x44" * 32)
    state.justification_bits = [True, True, True, True]
    _set_sync_committees(state)
    return state


def _set_sync_committees(state) -> None:
    """Current and next sync committee from rows 0 to sync_committee_size
    - 1, as ``bench.py`` builds them."""
    T = state.T
    pubkeys = [bytes(state.validators.pubkeys[i])
               for i in range(T.preset.sync_committee_size)]
    state.current_sync_committee = T.SyncCommittee(
        pubkeys=pubkeys, aggregate_pubkey=pubkeys[0])
    state.next_sync_committee = T.SyncCommittee(
        pubkeys=pubkeys, aggregate_pubkey=pubkeys[0])


def prior_slot_committees(state) -> list[np.ndarray]:
    """The committees of the slot before ``state.slot``, by index."""
    cache = committee_cache(state, state.current_epoch())
    return [np.asarray(cache.committee(state.slot - 1, i), np.int64)
            for i in range(cache.committees_per_slot)]


def signer_rows(state) -> np.ndarray:
    """Sorted distinct rows that sign the block: the proposer, every member
    of the prior slot's committees, rows 0 to sync_committee_size - 1."""
    parts = [np.array([get_beacon_proposer_index(state)], np.int64),
             np.arange(state.T.preset.sync_committee_size, dtype=np.int64),
             *prior_slot_committees(state)]
    return np.unique(np.concatenate(parts))


def signer_pubkeys(rows: np.ndarray, backend,
                   threads: int = 8) -> np.ndarray:
    """u8[len(rows), 48]: ``backend.sk_to_pk(keygen_interop(row))`` for each
    row, on a thread pool (the C++ backend's calls release the lock)."""
    def one(row):
        return backend.sk_to_pk(keygen_interop(int(row)))

    with ThreadPoolExecutor(max_workers=threads) as pool:
        pks = list(pool.map(one, rows.tolist()))
    return np.frombuffer(b"".join(pks), np.uint8).reshape(len(rows), 48)


def write_signers(state, rows: np.ndarray, pubkeys: np.ndarray) -> None:
    """Write ``pubkeys`` into ``rows`` of ``state``'s registry (either
    package's state), then rebuild the sync committees from rows 0 to
    sync_committee_size - 1. For a state no root was taken of yet: the
    registry rebuilds its tree whole."""
    registry = state.validators
    column = np.array(registry.pubkeys)
    column[rows] = pubkeys
    registry.pubkeys = column
    registry.mark_dirty()
    registry.__dict__.pop("_pk_index", None)
    _set_sync_committees(state)


def _sum_keys(rows) -> int:
    """The sum of the rows' interop secret keys mod r: the key whose
    signature is the aggregate of theirs."""
    return sum(keygen_interop(int(v)) for v in rows) % CURVE_ORDER


def build_block(state, backend=None):
    """``bench.py`` ``_build_import_block(state)``: a block at
    ``state.slot`` with one attestation of every prior-slot committee (all
    bits set) and a full sync aggregate. ``backend`` signs (each aggregate
    once, with the sum of its members' keys); None puts
    ``PLACEHOLDER_SIGNATURE`` everywhere."""
    T = state.T
    slot = state.slot
    epoch = state.current_epoch()
    att_slot = slot - 1
    target_root = state.get_block_root(epoch)
    head_root = state.get_block_root_at_slot(att_slot)
    data_tpl = dict(
        slot=att_slot, beacon_block_root=head_root,
        source=state.current_justified_checkpoint,
        target=T.Checkpoint(epoch=epoch, root=target_root))

    def sign(sk_rows, root, domain_type, domain_epoch):
        if backend is None:
            return PLACEHOLDER_SIGNATURE
        domain = get_domain(state, domain_type, domain_epoch)
        return backend.sign(_sum_keys(sk_rows),
                            compute_signing_root(root, domain))

    attestations = []
    for index, committee in enumerate(prior_slot_committees(state)):
        data = T.AttestationData(index=index, **data_tpl)
        attestations.append(T.Attestation(
            aggregation_bits=[True] * len(committee), data=data,
            signature=sign(committee, htr(data), DOMAIN_BEACON_ATTESTER,
                           epoch)))
    sync_size = T.preset.sync_committee_size
    sync_aggregate = T.SyncAggregate(
        sync_committee_bits=[True] * sync_size,
        sync_committee_signature=sign(
            range(sync_size), head_root, DOMAIN_SYNC_COMMITTEE,
            att_slot // T.preset.slots_per_epoch))
    proposer = get_beacon_proposer_index(state)
    body = T.BeaconBlockBody[ForkName.ALTAIR](
        randao_reveal=sign([proposer], hash_tree_root(uint64, epoch),
                           DOMAIN_RANDAO, epoch),
        eth1_data=state.eth1_data, graffiti=b"\x00" * 32,
        attestations=attestations)
    body.sync_aggregate = sync_aggregate
    block = T.BeaconBlock[ForkName.ALTAIR](
        slot=slot, proposer_index=proposer,
        parent_root=htr(state.latest_block_header),
        state_root=b"\x00" * 32, body=body)
    return T.SignedBeaconBlock[ForkName.ALTAIR](
        message=block,
        signature=sign([proposer], htr(block), DOMAIN_BEACON_PROPOSER,
                       epoch))


def copy_block(state, signed_block):
    """A deep copy of an Altair ``SignedBeaconBlock`` (through SSZ)."""
    typ = state.T.SignedBeaconBlock[ForkName.ALTAIR].ssz_type
    return deserialize(typ, serialize(typ, signed_block))


def negative_blocks(state, signed_block, backend) -> dict:
    """The block spoiled two ways, by label: attestation 0 carrying
    attestation 1's signature, and the proposal signed over another root
    (the parent's)."""
    swapped = copy_block(state, signed_block)
    atts = swapped.message.body.attestations
    atts[0].signature = atts[1].signature
    other = copy_block(state, signed_block)
    block = other.message
    domain = get_domain(state, DOMAIN_BEACON_PROPOSER,
                        state.current_epoch())
    other.signature = backend.sign(
        keygen_interop(int(block.proposer_index)),
        compute_signing_root(bytes(block.parent_root), domain))
    return {"attestation 0 with attestation 1's signature": swapped,
            "proposal signed over another root": other}


@dataclass
class Workload:
    state: BeaconState      # the pre-state, no root taken yet
    block: object           # the SignedBeaconBlock at state.slot
    rows: np.ndarray        # the signer rows, sorted
    pubkeys: np.ndarray     # u8[len(rows), 48], their interop pubkeys


def build_workload(backend, n: int = N_VALIDATORS, slot: int = SLOT,
                   signed: bool = True, threads: int = 8) -> Workload:
    """The state with the signers' interop pubkeys (derived by
    ``backend``, ``threads`` at a time) and the block (signed by
    ``backend``, or with the placeholder where ``signed`` is false)."""
    state = build_state(n, slot)
    rows = signer_rows(state)
    pubkeys = signer_pubkeys(rows, backend, threads)
    write_signers(state, rows, pubkeys)
    block = build_block(state, backend if signed else None)
    return Workload(state, block, rows, pubkeys)
