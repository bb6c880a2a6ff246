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

The post-merge workload is the same built at ``fork=ForkName.DENEB`` and
``DENEB_SLOT`` (mainnet is past Deneb there): ``postmerge`` takes the
Altair state through the package's fork upgrades to Deneb and writes an
execution payload header of the slot before (mainnet's genesis time, a
block number counted from the merge, a nonzero block hash); the block
carries an execution payload on that header (the spec's ``prev_randao``
and timestamp, ``get_expected_withdrawals`` of the state, the
transactions and ``BLOBS`` blobs made from a seed with numpy) with its
blobs' KZG commitments. The next slot's proposer also gets an interop
key. ``build_postmerge_workload`` adds the blobs' sidecars
(``chain.data_availability.produce_sidecars``), a second block by the
same proposer at the same slot (another graffiti: an equivocation);
``double_vote`` re-votes one of ``gossip_attestations``' singles with
another head (a double vote). The post-merge gossip singles are by the
first ``GOSSIP_SINGLES`` members of the block's own slot's committees
(``gossip_members``), who also get interop keys: none of them is in the
block's aggregates, so only the planted double vote is slashable.
"""
from __future__ import annotations

import hashlib
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
#: the post-merge workload's slot, in the shape of SLOT: epoch 320,000 is
#: past mainnet's Deneb epoch (269,568)
DENEB_SLOT = 320_000 * 32 + 2
#: mainnet's genesis time, and the merge's slot and execution block: an
#: execution block a slot from there on
MAINNET_GENESIS_TIME = 1_606_824_023
MERGE_SLOT, MERGE_BLOCK = 4_700_013, 15_537_394
#: blobs a Deneb block carries (MAX_BLOBS_PER_BLOCK), the blob gas of one
#: (GAS_PER_BLOB), the seed the blobs and transactions are made from
BLOBS = 6
GAS_PER_BLOB = 1 << 17
BLOB_SEED = 14
#: the block's transactions: their count and byte lengths (a mainnet
#: block's order of magnitude)
TRANSACTIONS, TRANSACTION_BYTES = 150, (100, 1_000)
#: the post-merge workload's gossip singles: members of the block's own
#: slot's committees (none of them in the block's aggregates)
GOSSIP_SINGLES = 1_024


def build_state(n: int = N_VALIDATORS, slot: int = SLOT,
                fork: ForkName = ForkName.ALTAIR) -> BeaconState:
    """``bench.py`` ``build_beacon_state(n, slot)``, with its random
    pubkeys (``write_signers`` rewrites the signers' rows); at
    ``ForkName.DENEB`` taken on by ``postmerge``."""
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
    if fork == ForkName.DENEB:
        from .state_transition import upgrades
        postmerge(state, upgrades)
    elif fork != ForkName.ALTAIR:
        raise ValueError(f"no workload at fork {fork.name}")
    return state


def el_block(slot: int) -> dict:
    """The execution block of ``slot`` as payload fields (either package's
    ``ExecutionPayload`` takes them): its number counted from the merge,
    mainnet's timestamp of the slot, the other fields hashes of the slot."""
    def h(tag: bytes) -> bytes:
        return hashlib.sha256(tag + slot.to_bytes(8, "little")).digest()

    return dict(
        parent_hash=h(b"parent"), fee_recipient=h(b"fee")[:20],
        state_root=h(b"state"), receipts_root=h(b"receipts"),
        prev_randao=h(b"randao"),
        block_number=MERGE_BLOCK + slot - MERGE_SLOT,
        gas_limit=30_000_000, gas_used=15_000_000,
        timestamp=MAINNET_GENESIS_TIME + 12 * slot,
        base_fee_per_gas=7_000_000_000, block_hash=h(b"block"))


def _empty_list_root(T, field: str) -> bytes:
    """The root of an empty ``transactions`` or ``withdrawals`` list."""
    from .ssz import ByteList, List
    p = T.preset
    typ = (List(ByteList(p.max_bytes_per_transaction),
                p.max_transactions_per_payload) if field == "transactions"
           else List(T.Withdrawal.ssz_type, p.max_withdrawals_per_payload))
    return hash_tree_root(typ, [])


def postmerge(state, upgrades) -> None:
    """Take ``state`` (either package's Altair state, ``upgrades`` its
    package's ``state_transition.upgrades``) through Bellatrix and Capella
    to Deneb after the merge: the fork is mainnet's Deneb fork, the
    genesis time mainnet's, and the execution payload header that of
    ``el_block(state.slot - 1)`` with no transactions or withdrawals (the
    payload ``anchor_block`` carries)."""
    upgrades.upgrade_to_bellatrix(state)
    upgrades.upgrade_to_capella(state)
    upgrades.upgrade_to_deneb(state)
    T, spec = state.T, state.spec
    state.fork = T.Fork(previous_version=spec.capella_fork_version,
                        current_version=spec.deneb_fork_version,
                        epoch=spec.deneb_fork_epoch)
    state.genesis_time = MAINNET_GENESIS_TIME
    header = type(state.latest_execution_payload_header)
    state.latest_execution_payload_header = header(
        **el_block(int(state.slot) - 1),
        transactions_root=_empty_list_root(T, "transactions"),
        withdrawals_root=_empty_list_root(T, "withdrawals"),
        blob_gas_used=0, excess_blob_gas=0)


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
    of the prior slot's committees, rows 0 to sync_committee_size - 1;
    after the merge also the next slot's proposer (who produces there) and
    the ``GOSSIP_SINGLES`` gossip signers of the state's slot
    (``gossip_members``; all of the slot's members where it has fewer)."""
    rows = [get_beacon_proposer_index(state)]
    if state.fork_name >= ForkName.BELLATRIX:
        slot = int(state.slot)
        rows.append(get_beacon_proposer_index(state, slot + 1))
        members = sum(len(c) for c in slot_committees(state, slot))
        rows += [m[0] for m in gossip_members(
            state, slot, min(GOSSIP_SINGLES, members))]
    parts = [np.array(rows, np.int64),
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


def make_blobs(seed: int = BLOB_SEED, count: int = BLOBS,
               elements: int = 4096) -> list[bytes]:
    """``count`` blobs of ``elements`` field elements from numpy's
    generator at ``seed``: 32 random bytes an element, its top byte
    cleared (every element below the scalar field's modulus)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        b = rng.integers(0, 256, size=(elements, 32), dtype=np.uint8)
        b[:, 0] = 0
        out.append(b.tobytes())
    return out


def transactions(slot: int, seed: int = BLOB_SEED) -> list[bytes]:
    """The block's opaque transactions, made from ``seed`` and ``slot``."""
    rng = np.random.default_rng([seed, slot])
    lo, hi = TRANSACTION_BYTES
    return [rng.integers(0, 256, size=int(rng.integers(lo, hi)),
                         dtype=np.uint8).tobytes()
            for _ in range(TRANSACTIONS)]


def execution_payload(state, commitments: list, seed: int = BLOB_SEED):
    """A payload for a block at ``state.slot`` on the state's header: the
    spec's ``prev_randao`` and timestamp, the state's expected withdrawals,
    ``transactions(slot, seed)``, the blob gas of ``commitments``' blobs,
    the other fields ``el_block(slot)``'s."""
    from .state_transition.block import (
        compute_timestamp_at_slot, get_expected_withdrawals,
    )
    slot = int(state.slot)
    parent = state.latest_execution_payload_header
    kw = el_block(slot)
    kw.update(parent_hash=bytes(parent.block_hash),
              block_number=int(parent.block_number) + 1,
              prev_randao=state.get_randao_mix(state.current_epoch()),
              timestamp=compute_timestamp_at_slot(state, slot))
    withdrawals, _ = get_expected_withdrawals(state)
    return state.T.ExecutionPayload[state.fork_name](
        **kw, transactions=transactions(slot, seed),
        withdrawals=withdrawals,
        blob_gas_used=GAS_PER_BLOB * len(commitments), excess_blob_gas=0)


def build_block(state, backend=None, commitments: list | None = None):
    """``bench.py`` ``_build_import_block(state)``: a block at
    ``state.slot`` with one attestation of every prior-slot committee (all
    bits set) and a full sync aggregate. ``backend`` signs (each aggregate
    once, with the sum of its members' keys); None puts
    ``PLACEHOLDER_SIGNATURE`` everywhere. After the merge the block also
    carries ``execution_payload(state, commitments)`` and the blobs' KZG
    ``commitments``."""
    T = state.T
    fork = state.fork_name
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
    body = T.BeaconBlockBody[fork](
        randao_reveal=sign([proposer], hash_tree_root(uint64, epoch),
                           DOMAIN_RANDAO, epoch),
        eth1_data=state.eth1_data, graffiti=b"\x00" * 32,
        attestations=attestations)
    body.sync_aggregate = sync_aggregate
    if fork >= ForkName.BELLATRIX:
        body.execution_payload = execution_payload(state, commitments or [])
        body.bls_to_execution_changes = []
        body.blob_kzg_commitments = list(commitments or [])
    block = T.BeaconBlock[fork](
        slot=slot, proposer_index=proposer,
        parent_root=htr(state.latest_block_header),
        state_root=b"\x00" * 32, body=body)
    return T.SignedBeaconBlock[fork](
        message=block,
        signature=sign([proposer], htr(block), DOMAIN_BEACON_PROPOSER,
                       epoch))


def copy_block(state, signed_block):
    """A deep copy of a ``SignedBeaconBlock`` of the state's fork (through
    SSZ)."""
    typ = state.T.SignedBeaconBlock[state.fork_name].ssz_type
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
                   signed: bool = True, threads: int = 8,
                   fork: ForkName = ForkName.ALTAIR) -> Workload:
    """The state with the signers' interop pubkeys (derived by
    ``backend``, ``threads`` at a time) and the block (signed by
    ``backend``, or with the placeholder where ``signed`` is false; after
    the merge without blobs)."""
    state = build_state(n, slot, fork)
    rows = signer_rows(state)
    pubkeys = signer_pubkeys(rows, backend, threads)
    write_signers(state, rows, pubkeys)
    block = build_block(state, backend if signed else None)
    return Workload(state, block, rows, pubkeys)


# -- the beacon node's gossip workload ----------------------------------------

def anchor_block(state):
    """``bench.py`` ``bench_import_critpath``'s anchor: a block of the
    state's fork at ``state.slot - 1`` (the placeholder randao reveal, the
    state's ``eth1_data``, zero graffiti; after the merge the payload of
    the state's execution header, ``el_block(state.slot - 1)``) whose
    header becomes ``state``'s ``latest_block_header``. Returns the
    signed anchor (the placeholder signature)."""
    T = state.T
    slot = state.slot
    fork = state.fork_name
    body = T.BeaconBlockBody[fork](
        randao_reveal=PLACEHOLDER_SIGNATURE, eth1_data=state.eth1_data,
        graffiti=b"\x00" * 32)
    if fork >= ForkName.BELLATRIX:
        body.execution_payload = T.ExecutionPayload[fork](
            **el_block(int(slot) - 1))
    anchor = T.BeaconBlock[fork](
        slot=slot - 1, proposer_index=0, parent_root=b"\x11" * 32,
        state_root=b"\x22" * 32, body=body)
    state.latest_block_header = T.BeaconBlockHeader(
        slot=slot - 1, proposer_index=0, parent_root=b"\x11" * 32,
        state_root=b"\x22" * 32, body_root=htr(body))
    return T.SignedBeaconBlock[fork](
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


def build_chain_workload(w: Workload, backend, signed: bool = True,
                         commitments: list | None = None) -> ChainWorkload:
    """On a copy of ``w``'s state (its signer rows and their pubkeys
    reused): the anchor block at ``w``'s slot - 1, the anchor justified,
    the state put at the anchor's slot; the block built on a copy
    advanced to ``w``'s slot (signed by ``backend``, or the placeholder
    where ``signed`` is false; after the merge carrying the blobs'
    ``commitments``) and its ``state_root`` filled by
    ``per_block_processing`` with signatures off on that copy."""
    state = w.state.copy()
    anchor = anchor_block(state)
    justify_anchor(state, htr(anchor.message))
    state.slot = anchor.message.slot
    post = state.copy()
    process_slots(post, state.slot + 1)
    block = build_block(post, backend if signed else None, commitments)
    per_block_processing(post, block, VerifySignatures.FALSE)
    post_root = post.hash_tree_root()
    block.message.state_root = post_root
    if signed:
        sign_proposal(state, block, backend)
    return ChainWorkload(state, anchor, block, post_root)


def gossip_members(state, slot: int, count: int) -> list[tuple]:
    """The first ``count`` members of ``slot``'s committees, taken position
    by position across the committees: ``(row, committee index, position,
    committee size)`` each."""
    committees = slot_committees(state, slot)
    members = [(int(c[pos]), index, pos, len(c))
               for pos in range(max(len(c) for c in committees))
               for index, c in enumerate(committees) if pos < len(c)]
    if count > len(members):
        raise ValueError(f"{count} attestations asked, slot {slot} has "
                         f"{len(members)} committee members")
    return members[:count]


def gossip_attestations(state, head_root: bytes, count: int, backend,
                        threads: int = 8,
                        target_root: bytes | None = None) -> list:
    """``count`` unaggregated attestations, ``(attestation, subnet)``
    pairs, at ``state.slot``: one bit each, by ``gossip_members`` (so
    every committee's data repeats), each signed with its member's
    interop key by ``backend``, ``threads`` at a time. Their data names
    ``head_root`` as head, ``target_root`` (``head_root`` where None) as
    target and the state's current justified checkpoint as source."""
    T = state.T
    att_slot = int(state.slot)
    epoch = state.current_epoch()
    members = gossip_members(state, att_slot, count)
    n_committees = len(slot_committees(state, att_slot))
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, epoch)
    target = T.Checkpoint(epoch=epoch, root=head_root if target_root is None
                          else target_root)
    datas = [T.AttestationData(
        slot=att_slot, index=index, beacon_block_root=head_root,
        source=state.current_justified_checkpoint, target=target)
        for index in range(n_committees)]
    roots = [compute_signing_root(htr(d), domain) for d in datas]
    # the subnet: the committee's count since the epoch's start
    first = (att_slot % T.preset.slots_per_epoch) * n_committees

    def one(m):
        row, index, pos, size = m
        sig = backend.sign(keygen_interop(row), roots[index])
        bits = [False] * size
        bits[pos] = True
        att = T.Attestation(aggregation_bits=bits, data=datas[index],
                            signature=sig)
        return att, (first + index) % ATTESTATION_SUBNET_COUNT

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(one, members))


# -- the post-merge workload --------------------------------------------------

@dataclass
class PostMergeWorkload:
    chain: ChainWorkload    # the anchor state, the anchor, the Deneb block
    blobs: list             # the block's blobs
    sidecars: list          # their BlobSidecars, proofs and inclusion proofs
    equivocation: object    # the same proposer's second block at the slot
    kzg_s: float            # seconds the commitments and proofs took


class _ProofsOf:
    """A KZG verifier's ``compute_blob_kzg_proof`` answered from proofs
    computed beforehand (in parallel), for ``produce_sidecars``."""

    def __init__(self, proofs: dict):
        self.proofs = proofs

    def compute_blob_kzg_proof(self, blob, commitment) -> bytes:
        return self.proofs[(bytes(blob), bytes(commitment))]


def build_postmerge_workload(w: Workload, backend, kzg,
                             seed: int = BLOB_SEED, signed: bool = True,
                             threads: int = 8) -> PostMergeWorkload:
    """``build_chain_workload`` on a Deneb workload ``w`` with
    ``make_blobs(seed)``: their commitments and proofs by ``kzg`` (a blob
    a thread, the library's calls release the lock), the block's
    sidecars by ``chain.data_availability.produce_sidecars``, and the
    equivocating block (graffiti ``0x01..``, signed by ``backend``)."""
    import time

    from .chain.data_availability import produce_sidecars
    blobs = make_blobs(seed)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        commitments = list(pool.map(kzg.blob_to_kzg_commitment, blobs))
        proofs = list(pool.map(kzg.compute_blob_kzg_proof, blobs,
                               commitments))
    kzg_s = time.perf_counter() - t0
    cw = build_chain_workload(w, backend, signed, commitments)
    T = cw.state.T
    sidecars = produce_sidecars(
        T, cw.block, blobs,
        _ProofsOf({(b, c): p for b, c, p in zip(blobs, commitments,
                                                 proofs)}))
    other = copy_block(cw.state, cw.block)
    other.message.body.graffiti = b"\x01" * 32
    if signed:
        sign_proposal(cw.state, other, backend)
    return PostMergeWorkload(cw, blobs, sidecars, other, kzg_s)


def double_vote(state, attestation, head_root: bytes, backend):
    """``attestation`` (a single of ``gossip_attestations`` on ``state``)
    voted again with ``head_root`` as its head, the rest of its data as
    it was, signed by its member's interop key: a double vote."""
    T = state.T
    d = attestation.data
    data = T.AttestationData(slot=d.slot, index=d.index,
                             beacon_block_root=head_root, source=d.source,
                             target=d.target)
    committee = slot_committees(state, int(d.slot))[int(d.index)]
    pos = [i for i, b in enumerate(attestation.aggregation_bits) if b]
    row = int(committee[pos[0]])
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, int(d.target.epoch))
    return T.Attestation(
        aggregation_bits=list(attestation.aggregation_bits), data=data,
        signature=backend.sign(keygen_interop(row),
                               compute_signing_root(htr(data), domain)))
