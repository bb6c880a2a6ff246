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
``bench.py`` built.

``build_chain_workload`` is the beacon node's gossip workload on the same
state: ``bench.py`` ``bench_import_critpath``'s anchor block, whose header
becomes the state's ``latest_block_header``, the block built and signed
after it, its ``state_root`` filled by a pass with signatures off. Two
things differ, both so that fork choice, anchored on the state, takes
what the chain feeds it:

- the state's current justified checkpoint is the anchor's
  (``justify_anchor``, on either package's state), the checkpoint fork
  choice's store starts from; with ``bench.py``'s (epoch - 1,
  ``0x55...``) the viability filter keeps the head on the anchor;
- the state sits at the anchor block's slot, and the block is built on
  it advanced one slot: fork choice places the anchor at the state's
  slot, and refuses a vote at the anchor's slot for a block it places
  later (so the block's own attestations name the anchor as head, from
  the advanced state's ``block_roots``).

``gossip_attestations`` gives the unaggregated single-bit attestations of
BASELINE.md config 3's batch by the anchor slot's committee members (the
prior slot's of ``build_workload``: their keys are interop keys). Host
only (numpy and the BLS host backends), but for the roots the advance
and the ``state_root`` pass take.
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
    ATTESTATION_SUBNET_COUNT, DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER, DOMAIN_RANDAO,
    DOMAIN_SYNC_COMMITTEE,
)
from .ssz import deserialize, hash_tree_root, htr, serialize, uint64
from .state_transition import (
    VerifySignatures, per_block_processing, process_slots,
)
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


def slot_committees(state, slot: int) -> list[np.ndarray]:
    """The committees of ``slot`` (in ``state``'s epoch), by index."""
    cache = committee_cache(state, state.current_epoch())
    return [np.asarray(cache.committee(slot, i), np.int64)
            for i in range(cache.committees_per_slot)]


def prior_slot_committees(state) -> list[np.ndarray]:
    """The committees of the slot before ``state.slot``, by index."""
    return slot_committees(state, state.slot - 1)


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


# -- the beacon node's gossip workload ----------------------------------------

def anchor_block(state):
    """``bench.py`` ``bench_import_critpath``'s anchor: an Altair block at
    ``state.slot - 1`` (the placeholder randao reveal, the state's
    ``eth1_data``, zero graffiti) whose header becomes ``state``'s
    ``latest_block_header``. Returns the signed anchor (the placeholder
    signature)."""
    T = state.T
    slot = state.slot
    body = T.BeaconBlockBody[ForkName.ALTAIR](
        randao_reveal=PLACEHOLDER_SIGNATURE, eth1_data=state.eth1_data,
        graffiti=b"\x00" * 32)
    anchor = T.BeaconBlock[ForkName.ALTAIR](
        slot=slot - 1, proposer_index=0, parent_root=b"\x11" * 32,
        state_root=b"\x22" * 32, body=body)
    state.latest_block_header = T.BeaconBlockHeader(
        slot=slot - 1, proposer_index=0, parent_root=b"\x11" * 32,
        state_root=b"\x22" * 32, body_root=htr(body))
    return T.SignedBeaconBlock[ForkName.ALTAIR](
        message=anchor, signature=PLACEHOLDER_SIGNATURE)


def justify_anchor(state, anchor_root: bytes) -> None:
    """Set ``state``'s (either package's) current justified checkpoint to
    ``(state's epoch, anchor_root)``: fork choice anchored on the state
    starts from that checkpoint, and a block whose state names another is
    not viable for head."""
    state.current_justified_checkpoint = state.T.Checkpoint(
        epoch=state.current_epoch(), root=anchor_root)


def sign_proposal(state, signed_block, backend) -> None:
    """Sign ``signed_block``'s message as its proposer (interop key) with
    ``backend``, in place."""
    block = signed_block.message
    domain = get_domain(state, DOMAIN_BEACON_PROPOSER, state.current_epoch())
    signed_block.signature = backend.sign(
        keygen_interop(int(block.proposer_index)),
        compute_signing_root(htr(block), domain))


def swapped_block(state, signed_block, backend):
    """A copy of ``signed_block`` with attestation 0 carrying attestation
    1's signature, the proposal signed again over it: only the attestation
    signature is wrong."""
    bad = copy_block(state, signed_block)
    atts = bad.message.body.attestations
    atts[0].signature = atts[1].signature
    sign_proposal(state, bad, backend)
    return bad


@dataclass
class ChainWorkload:
    state: BeaconState      # the anchor state, at the anchor's slot
    anchor: object          # the SignedBeaconBlock the state's header is
    block: object           # the SignedBeaconBlock one slot later
    post_root: bytes        # the state's root after the block


def build_chain_workload(w: Workload, backend,
                         signed: bool = True) -> ChainWorkload:
    """On a copy of ``w``'s state (its signer rows and their pubkeys
    reused): the anchor block at ``w``'s slot - 1, the anchor justified,
    the state put at the anchor's slot; the block built on a copy
    advanced to ``w``'s slot (signed by ``backend``, or the placeholder
    where ``signed`` is false) and its ``state_root`` filled by
    ``per_block_processing`` with signatures off on that copy."""
    state = w.state.copy()
    anchor = anchor_block(state)
    justify_anchor(state, htr(anchor.message))
    state.slot = anchor.message.slot
    post = state.copy()
    process_slots(post, state.slot + 1)
    block = build_block(post, backend if signed else None)
    per_block_processing(post, block, VerifySignatures.FALSE)
    post_root = post.hash_tree_root()
    block.message.state_root = post_root
    if signed:
        sign_proposal(state, block, backend)
    return ChainWorkload(state, anchor, block, post_root)


def gossip_attestations(state, head_root: bytes, count: int, backend,
                        threads: int = 8) -> list:
    """``count`` unaggregated attestations, ``(attestation, subnet)``
    pairs, at ``state.slot``: one bit each, the members of the slot's
    committees taken position by position across the committees (so
    every committee's data repeats), each signed with its member's
    interop key by ``backend``, ``threads`` at a time. Their data names
    ``head_root`` as head and target and the state's current justified
    checkpoint as source."""
    T = state.T
    att_slot = int(state.slot)
    epoch = state.current_epoch()
    committees = slot_committees(state, att_slot)
    members = [(int(c[pos]), index, pos, len(c))
               for pos in range(max(len(c) for c in committees))
               for index, c in enumerate(committees) if pos < len(c)]
    if count > len(members):
        raise ValueError(f"{count} attestations asked, slot {att_slot} has "
                         f"{len(members)} committee members")
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, epoch)
    datas = [T.AttestationData(
        slot=att_slot, index=index, beacon_block_root=head_root,
        source=state.current_justified_checkpoint,
        target=T.Checkpoint(epoch=epoch, root=head_root))
        for index in range(len(committees))]
    roots = [compute_signing_root(htr(d), domain) for d in datas]
    # the subnet: the committee's count since the epoch's start
    first = (att_slot % T.preset.slots_per_epoch) * len(committees)

    def one(m):
        row, index, pos, size = m
        sig = backend.sign(keygen_interop(row), roots[index])
        bits = [False] * size
        bits[pos] = True
        att = T.Attestation(aggregation_bits=bits, data=datas[index],
                            signature=sig)
        return att, (first + index) % ATTESTATION_SUBNET_COUNT

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(one, members[:count]))
