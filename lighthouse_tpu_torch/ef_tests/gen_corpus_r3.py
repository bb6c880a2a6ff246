"""Corpus generators of the ssz_generic, epoch, genesis, light-client
and optimistic-sync families.

Independence notes (per family — same discipline as gen_corpus.py):
- ssz_generic: serializations AND roots hand-built with hashlib +
  manual little-endian packing (fully independent of lighthouse_tpu_torch.ssz).
- rewards: expected deltas computed by SCALAR python transcriptions of
  the spec pseudocode in this file (independent shuffle, committees,
  base rewards) — the runner compares the vectorized epoch.py output
  against them.
- genesis/validity: expected flag recomputed from the two scalar spec
  conditions here, not via state_transition.genesis.
- bls eth_*: vectors produced by the native C++ backend, checked by the
  python oracle in the runner.
- merkle_proof / light_client proofs: branches assembled with hashlib
  from field roots; verification in the runner re-hashes bottom-up, so
  a wrong branch or root cannot self-validate.
- finality/random: every epoch transition the pinned chain crosses is
  verified against the scalar spec at generation time (justification,
  finalization, balances); per-block operations are scalar-verified in
  the operations family.  fork: upgrades scalar-verified (version
  rotation + field preservation).  genesis-initialization: registry
  construction scalar-verified from the deposit rows.  sync +
  fork_choice steps encode hand-specified behavioral expectations
  (head/revert semantics), not implementation output.
"""
from __future__ import annotations

import hashlib
import math

from .gen_corpus import (
    ZERO32, _mini_chain, _write_state, hp, merkle, w_ssz, w_yaml, wcase,
)

# ---------------------------------------------------------------------------
# ssz_generic (fully independent hand-built bytes + roots)
# ---------------------------------------------------------------------------


def _pack_root(data: bytes, limit_chunks: int | None = None,
               length: int | None = None) -> bytes:
    chunks = [data[i:i + 32].ljust(32, b"\x00")
              for i in range(0, max(len(data), 1), 32)] or [ZERO32]
    n = limit_chunks or len(chunks)
    size = 1
    while size < n:
        size *= 2
    chunks = chunks + [ZERO32] * (size - len(chunks))
    root = merkle(chunks)
    if length is not None:
        root = hp(root, length.to_bytes(32, "little"))
    return root


def gen_ssz_generic(root) -> int:
    n = 0

    def case(handler, suite, name, ser: bytes, root_hex: str | None):
        nonlocal n
        d = wcase(root, "general", "phase0", "ssz_generic", handler,
                  suite, name)
        w_ssz(d, "serialized.ssz_snappy", ser)
        if suite == "valid":
            w_yaml(d, "meta.yaml", {"root": root_hex})
        n += 1

    def rt(b: bytes) -> str:
        return "0x" + b.hex()

    # uints
    for bits, val in ((8, 0x7F), (16, 0xABCD), (32, 0x01020304),
                      (64, 2**63 + 7), (128, 2**100 + 3),
                      (256, 2**200 + 9)):
        ser = val.to_bytes(bits // 8, "little")
        case("uints", "valid", f"uint_{bits}_rand", ser,
             rt(ser.ljust(32, b"\x00")))
        case("uints", "valid", f"uint_{bits}_max",
             ((1 << bits) - 1).to_bytes(bits // 8, "little"),
             rt(((1 << bits) - 1).to_bytes(bits // 8,
                                           "little").ljust(32, b"\x00")))
        case("uints", "invalid", f"uint_{bits}_too_long",
             ser + b"\x00", None)
        case("uints", "invalid", f"uint_{bits}_too_short", ser[:-1], None)
    # boolean
    case("boolean", "valid", "true", b"\x01", rt(b"\x01".ljust(32, b"\x00")))
    case("boolean", "valid", "false", b"\x00", rt(ZERO32))
    case("boolean", "invalid", "byte_2", b"\x02", None)
    case("boolean", "invalid", "byte_full", b"\xff", None)
    # basic_vector (uint16 x3, bool x4, uint64 x5)
    vals16 = [0x1122, 0x3344, 0x5566]
    ser = b"".join(v.to_bytes(2, "little") for v in vals16)
    case("basic_vector", "valid", "vec_uint16_3_rand", ser, rt(_pack_root(ser)))
    case("basic_vector", "invalid", "vec_uint16_3_too_short", ser[:-1],
         None)
    case("basic_vector", "invalid", "vec_uint16_3_too_long",
         ser + b"\x00\x00", None)
    bools = b"\x01\x00\x01\x01"
    case("basic_vector", "valid", "vec_bool_4_rand", bools,
         rt(_pack_root(bools)))
    vals64 = [5, 2**40, 7, 2**63, 1]
    ser = b"".join(v.to_bytes(8, "little") for v in vals64)
    case("basic_vector", "valid", "vec_uint64_5_rand", ser,
         rt(_pack_root(ser)))
    # bitvector: serialized LSB-first bit packing
    case("bitvector", "valid", "bitvec_8_rand", bytes([0b10110010]),
         rt(bytes([0b10110010]).ljust(32, b"\x00")))
    case("bitvector", "valid", "bitvec_4_rand", bytes([0b00000101]),
         rt(bytes([0b00000101]).ljust(32, b"\x00")))
    case("bitvector", "invalid", "bitvec_4_high_bit_set",
         bytes([0b00110101]), None)
    case("bitvector", "invalid", "bitvec_8_extra_byte", b"\x01\x00", None)
    # bitlist: delimiter bit above the data bits
    #  bitlist_8 with 5 bits [1,0,1,1,0] -> byte 0b00101101 (delim at 5)
    ser = bytes([0b00101101])
    case("bitlist", "valid", "bitlist_8_len5", ser,
         rt(hp(bytes([0b00001101]).ljust(32, b"\x00"),
               (5).to_bytes(32, "little"))))
    #  empty bitlist: just the delimiter
    case("bitlist", "valid", "bitlist_8_len0", b"\x01",
         rt(hp(ZERO32, ZERO32)))
    case("bitlist", "invalid", "bitlist_8_no_delimiter", b"\x00", None)
    case("bitlist", "invalid", "bitlist_8_empty_bytes", b"", None)
    case("bitlist", "invalid", "bitlist_5_too_long", bytes([0b01111111]),
         None)
    # containers (hand-built offsets)
    #  SingleFieldTestStruct { A: uint8 }
    case("containers", "valid", "SingleFieldTestStruct_rand", b"\xab",
         rt(merkle([b"\xab".ljust(32, b"\x00")])))
    #  SmallTestStruct { A, B: uint16 }
    ser = (0x4567).to_bytes(2, "little") + (0x0123).to_bytes(2, "little")
    case("containers", "valid", "SmallTestStruct_rand", ser,
         rt(merkle([(0x4567).to_bytes(2, "little").ljust(32, b"\x00"),
                    (0x0123).to_bytes(2, "little").ljust(32, b"\x00")])))
    #  FixedTestStruct { A: uint8, B: uint64, C: uint32 }
    ser = b"\x01" + (2**50).to_bytes(8, "little") + \
        (0xDDEEFF00).to_bytes(4, "little")
    case("containers", "valid", "FixedTestStruct_rand", ser,
         rt(merkle([b"\x01".ljust(32, b"\x00"),
                    (2**50).to_bytes(8, "little").ljust(32, b"\x00"),
                    (0xDDEEFF00).to_bytes(4, "little").ljust(32,
                                                             b"\x00")])))
    #  VarTestStruct { A: uint16, B: List[uint16, 1024], C: uint8 }
    b_vals = [1, 2, 3]
    b_ser = b"".join(v.to_bytes(2, "little") for v in b_vals)
    ser = (0xABCD).to_bytes(2, "little") + (7).to_bytes(4, "little") + \
        b"\xEE" + b_ser
    b_root = _pack_root(b_ser, limit_chunks=(1024 * 2 + 31) // 32,
                        length=3)
    case("containers", "valid", "VarTestStruct_rand", ser,
         rt(merkle([(0xABCD).to_bytes(2, "little").ljust(32, b"\x00"),
                    b_root, b"\xEE".ljust(32, b"\x00")])))
    case("containers", "invalid", "VarTestStruct_offset_into_fixed",
         (0xABCD).to_bytes(2, "little") + (3).to_bytes(4, "little")
         + b"\xEE", None)
    case("containers", "invalid", "VarTestStruct_truncated",
         (0xABCD).to_bytes(2, "little") + (7).to_bytes(4, "little"),
         None)
    return n


# ---------------------------------------------------------------------------
# rewards: scalar spec transcription (independent of epoch.py)
# ---------------------------------------------------------------------------

TIMELY_SOURCE, TIMELY_TARGET, TIMELY_HEAD = 0, 1, 2
WEIGHTS = [14, 26, 14]          # TIMELY_* weights
WEIGHT_DENOM = 64


def _active(v, epoch: int) -> bool:
    return v["activation_epoch"] <= epoch < v["exit_epoch"]


def _vrows(state) -> list[dict]:
    vs = state.validators
    return [{k: int(getattr(vs, k)[i])
             for k in ("activation_epoch", "exit_epoch", "slashed",
                       "withdrawable_epoch", "effective_balance")}
            for i in range(len(vs))]


def _spec_altair_deltas(state, flag: int) -> tuple[list[int], list[int]]:
    p = state.T.preset
    epoch = int(state.slot) // p.slots_per_epoch
    prev = max(0, epoch - 1) if epoch > 0 else 0
    rows = _vrows(state)
    inc = p.effective_balance_increment
    total = max(inc, sum(r["effective_balance"] for r in rows
                         if _active(r, epoch)))
    sqrt_total = math.isqrt(total)
    participation = [int(b) for b in state.previous_epoch_participation]
    finalized = int(state.finalized_checkpoint.epoch)
    leak = (prev - finalized) > 4       # MIN_EPOCHS_TO_INACTIVITY_PENALTY
    n = len(rows)
    rewards, penalties = [0] * n, [0] * n
    part_total = sum(r["effective_balance"]
                     for i, r in enumerate(rows)
                     if _active(r, prev) and not r["slashed"]
                     and participation[i] >> flag & 1)
    active_incs = total // inc
    part_incs = part_total // inc
    for i, r in enumerate(rows):
        eligible = _active(r, prev) or (
            r["slashed"] and prev + 1 < r["withdrawable_epoch"])
        if not eligible:
            continue
        base = (r["effective_balance"] // inc) * \
            (inc * 64 // sqrt_total)    # BASE_REWARD_FACTOR = 64
        participating = _active(r, prev) and not r["slashed"] and \
            participation[i] >> flag & 1
        if participating:
            if not leak:
                num = base * WEIGHTS[flag] * part_incs
                rewards[i] += num // (active_incs * WEIGHT_DENOM)
        elif flag != TIMELY_HEAD:
            penalties[i] += base * WEIGHTS[flag] // WEIGHT_DENOM
    return rewards, penalties


def _spec_altair_inactivity(state) -> tuple[list[int], list[int]]:
    p = state.T.preset
    epoch = int(state.slot) // p.slots_per_epoch
    prev = max(0, epoch - 1) if epoch > 0 else 0
    rows = _vrows(state)
    participation = [int(b) for b in state.previous_epoch_participation]
    scores = [int(s) for s in state.inactivity_scores]
    n = len(rows)
    penalties = [0] * n
    # INACTIVITY_SCORE_BIAS = 4; quotient: 3*2^24 (altair), 2^24
    # (bellatrix onward) — spec constants, transcribed not imported
    q = 3 * 2**24 if state.fork_name.name.lower() == "altair" else 2**24
    for i, r in enumerate(rows):
        eligible = _active(r, prev) or (
            r["slashed"] and prev + 1 < r["withdrawable_epoch"])
        if not eligible:
            continue
        target_ok = _active(r, prev) and not r["slashed"] and \
            participation[i] >> TIMELY_TARGET & 1
        if not target_ok:
            penalties[i] += (r["effective_balance"] * scores[i]
                             ) // (4 * q)
    return [0] * n, penalties


def _enc_deltas(rewards: list[int], penalties: list[int]) -> bytes:
    off1 = 8
    off2 = 8 + 8 * len(rewards)
    return (off1.to_bytes(4, "little") + off2.to_bytes(4, "little")
            + b"".join(v.to_bytes(8, "little") for v in rewards)
            + b"".join(v.to_bytes(8, "little") for v in penalties))


def gen_rewards(root) -> int:
    """altair rewards vectors with INDEPENDENT scalar expectations."""
    from ..state_transition import process_slots
    h, spec = _mini_chain()
    spe = spec.preset.slots_per_epoch
    h.extend_chain(2 * spe + 2)
    state = h.chain.head().head_state.copy()
    # align to an epoch boundary - 1 (the spec applies deltas there)
    process_slots(state, (state.current_epoch() + 1) * spe - 1)
    n = 0
    d = wcase(root, "minimal", "altair", "rewards", "basic",
              "pyspec_tests", "full_participation")
    _write_state(d, "pre.ssz_snappy", state)
    for name, flag in (("source_deltas", TIMELY_SOURCE),
                       ("target_deltas", TIMELY_TARGET),
                       ("head_deltas", TIMELY_HEAD)):
        w_ssz(d, f"{name}.ssz_snappy",
              _enc_deltas(*_spec_altair_deltas(state, flag)))
    w_ssz(d, "inactivity_penalty_deltas.ssz_snappy",
          _enc_deltas(*_spec_altair_inactivity(state)))
    n += 1
    # a leak variant: static state surgery (slot jumped 6 epochs with
    # finality pinned at 0, a few validators non-participating with
    # raised inactivity scores) — both the transcription and the
    # vectorized code read the same static fields
    import numpy as np
    leak = state.copy()
    leak.slot = int(state.slot) + 6 * spe
    leak.finalized_checkpoint = state.T.Checkpoint(
        epoch=0, root=state.finalized_checkpoint.root)
    part = np.array(leak.previous_epoch_participation, dtype=np.uint8)
    part[3:7] = 0
    leak.previous_epoch_participation = part
    scores = np.array(leak.inactivity_scores, dtype=np.uint64)
    scores[3:7] = 44
    leak.inactivity_scores = scores
    d = wcase(root, "minimal", "altair", "rewards", "leak",
              "pyspec_tests", "leak_participation")
    _write_state(d, "pre.ssz_snappy", leak)
    for name, flag in (("source_deltas", TIMELY_SOURCE),
                       ("target_deltas", TIMELY_TARGET),
                       ("head_deltas", TIMELY_HEAD)):
        w_ssz(d, f"{name}.ssz_snappy",
              _enc_deltas(*_spec_altair_deltas(leak, flag)))
    w_ssz(d, "inactivity_penalty_deltas.ssz_snappy",
          _enc_deltas(*_spec_altair_inactivity(leak)))
    n += 1
    return n


# ---------------------------------------------------------------------------
# fork / finality / random / genesis / sync (labeled pins) + proofs
# ---------------------------------------------------------------------------

def gen_fork(root) -> int:
    from ..chain.harness import BeaconChainHarness
    from ..specs import minimal_spec
    from ..state_transition import upgrades
    n = 0
    for post, overrides in (
            ("altair", {"altair_fork_epoch": 64}),
            ("bellatrix", {"altair_fork_epoch": 0,
                           "bellatrix_fork_epoch": 64}),
            ("capella", {"altair_fork_epoch": 0, "bellatrix_fork_epoch": 0,
                         "capella_fork_epoch": 64}),
            ("deneb", {"altair_fork_epoch": 0, "bellatrix_fork_epoch": 0,
                       "capella_fork_epoch": 0, "deneb_fork_epoch": 64}),
            ("electra", {"altair_fork_epoch": 0,
                         "bellatrix_fork_epoch": 0,
                         "capella_fork_epoch": 0, "deneb_fork_epoch": 0,
                         "electra_fork_epoch": 64}),
    ):
        spec = minimal_spec(**overrides)
        h = BeaconChainHarness(spec, 16)
        h.extend_chain(3)
        pre = h.chain.head().head_state.copy()
        post_state = pre.copy()
        getattr(upgrades, f"upgrade_to_{post}")(post_state)
        from ..specs.chain_spec import ForkName
        from . import scalar_spec
        scalar_spec.verify_upgrade(
            pre, post_state,
            expected_prev=bytes(pre.fork.current_version),
            expected_cur=spec.fork_version(ForkName[post.upper()]))
        d = wcase(root, "minimal", post, "fork", "fork", "pyspec_tests",
                  f"fork_base_{post}")
        w_yaml(d, "meta.yaml", {"fork": post})
        _write_state(d, "pre.ssz_snappy", pre)
        _write_state(d, "post.ssz_snappy", post_state)
        n += 1
    return n


def gen_finality_random(root) -> int:
    from ..ssz import serialize
    from ..state_transition import per_block_processing, process_slots
    h, spec = _mini_chain()
    spe = spec.preset.slots_per_epoch
    # build up two finalized epochs of history first
    h.extend_chain(2 * spe + 2)
    base = h.chain.head().head_state.copy()
    n = 0
    for runner, handler, blocks_n, attest in (
            ("finality", "finality", 2 * spe, True),
            ("random", "random", spe, True)):
        pre = h.chain.head().head_state.copy()
        roots = h.extend_chain(blocks_n, attest=attest)
        blocks = [h.chain.store.get_block(r) for r in roots]
        post = h.chain.head().head_state
        # de-circularization: every epoch transition the pinned chain
        # crosses is verified against the INDEPENDENT scalar spec
        # (justification bits, finalized checkpoint, balances,
        # effective balances — scalar_spec.py); the per-block operations
        # are scalar-verified by the operations family
        from . import scalar_spec
        for b in blocks:
            bslot = int(b.message.slot)
            if bslot % spe != 0:
                continue
            parent = h.chain.store.get_block(bytes(b.message.parent_root))
            pstate = h.chain.store.get_hot_state(
                bytes(parent.message.state_root))
            if pstate is None:
                continue
            last = pstate.copy()
            process_slots(last, bslot - 1)        # stays inside the epoch
            crossed = last.copy()
            process_slots(crossed, bslot)         # the verified crossing
            scalar_spec.verify_epoch_transition(last, crossed)
        d = wcase(root, "minimal", "altair", runner, handler,
                  "pyspec_tests", f"{runner}_chain")
        w_yaml(d, "meta.yaml", {"blocks_count": len(blocks)})
        _write_state(d, "pre.ssz_snappy", pre)
        for i, b in enumerate(blocks):
            w_ssz(d, f"blocks_{i}.ssz_snappy",
                  serialize(type(b).ssz_type, b))
        _write_state(d, "post.ssz_snappy", post)
        n += 1
    return n


def gen_genesis(root) -> int:
    from ..crypto import bls
    bls.set_backend("python")
    from ..specs import minimal_spec
    from ..state_transition.genesis import (
        genesis_deposits, initialize_beacon_state_from_eth1,
    )
    spec = minimal_spec()
    n = 0
    # initialization (pin): enough deposits to clear
    # MIN_GENESIS_ACTIVE_VALIDATOR_COUNT on the minimal preset (64)
    n_keys = spec.min_genesis_active_validator_count
    deposits = genesis_deposits(spec, list(range(1, n_keys + 1)),
                                32 * 10**9)
    block_hash = b"\x42" * 32
    ts = 1_600_000_000
    state = initialize_beacon_state_from_eth1(spec, block_hash, ts,
                                              deposits)
    from . import scalar_spec
    scalar_spec.verify_genesis_registry(
        [(bytes(dep.data.pubkey), bytes(dep.data.withdrawal_credentials),
          int(dep.data.amount)) for dep in deposits], state)
    d = wcase(root, "minimal", "phase0", "genesis", "initialization",
              "pyspec_tests", f"initialization_{n_keys}")
    w_yaml(d, "eth1.yaml", {"eth1_block_hash": "0x" + block_hash.hex(),
                            "eth1_timestamp": ts})
    w_yaml(d, "meta.yaml", {"deposits_count": len(deposits)})
    from ..ssz import serialize
    T = state.T
    for i, dep in enumerate(deposits):
        w_ssz(d, f"deposits_{i}.ssz_snappy",
              serialize(T.Deposit.ssz_type, dep))
    _write_state(d, "state.ssz_snappy", state)
    n += 1
    # validity: INDEPENDENT scalar recheck of the spec conditions.
    # (minimal's MIN_GENESIS_TIME is 0, so no too-early variant exists.)
    for name, mutate in (("valid_state", None),
                         ("too_few_validators", "validators")):
        s = state.copy()
        if mutate == "validators":
            # deactivate validators below the minimum count
            for i in range(len(s.validators)):
                if i >= spec.min_genesis_active_validator_count - 1:
                    s.validators.set_field(i, "activation_epoch", 2**60)
        active = sum(
            1 for i in range(len(s.validators))
            if int(s.validators.activation_epoch[i]) == 0
            and int(s.validators.exit_epoch[i]) > 0)
        is_valid = (int(s.genesis_time) >= spec.min_genesis_time
                    and active >= spec.min_genesis_active_validator_count)
        d = wcase(root, "minimal", "phase0", "genesis", "validity",
                  "pyspec_tests", name)
        _write_state(d, "genesis.ssz_snappy", s)
        w_yaml(d, "is_valid.yaml", bool(is_valid))
        n += 1
    return n


def gen_light_client_proofs(root) -> int:
    """light_client/single_merkle_proof/BeaconState cases: branches
    assembled from per-field roots; the runner re-hashes bottom-up, so
    only a correct (branch, root) pair passes."""
    from ..chain.light_client import (
        finalized_root_branch, state_field_branch,
    )
    h, spec = _mini_chain()
    h.extend_chain(10)
    state = h.chain.head().head_state.copy()
    n = 0
    for name, fn in (
            ("current_sync_committee_merkle_proof",
             lambda s: state_field_branch(s, "current_sync_committee")),
            ("next_sync_committee_merkle_proof",
             lambda s: state_field_branch(s, "next_sync_committee")),
            ("finality_root_merkle_proof", finalized_root_branch)):
        leaf, branch, gindex = fn(state)
        d = wcase(root, "minimal", "altair", "light_client",
                  "single_merkle_proof", "BeaconState", name)
        _write_state(d, "object.ssz_snappy", state)
        w_yaml(d, "proof.yaml", {
            "leaf": "0x" + leaf.hex(),
            "leaf_index": gindex,
            "branch": ["0x" + b.hex() for b in branch]})
        n += 1
    return n


def gen_sync(root) -> int:
    """sync/optimistic: a bellatrix chain where the engine reports the
    tip payload INVALID; head must revert to the parent."""
    from ..crypto import bls
    bls.set_backend("python")
    from ..chain.harness import BeaconChainHarness
    from ..specs import minimal_spec
    from ..ssz import htr, serialize
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0)
    h = BeaconChainHarness(spec, 16)
    anchor = h.chain.genesis_state
    anchor_block = h.chain.store.get_block(h.chain.genesis_block_root)
    r1, r2 = h.extend_chain(2)
    b1 = h.chain.store.get_block(r1)
    b2 = h.chain.store.get_block(r2)
    ph1 = b1.message.body.execution_payload.block_hash
    ph2 = b2.message.body.execution_payload.block_hash
    d = wcase(root, "minimal", "bellatrix", "sync", "optimistic",
              "pyspec_tests", "invalid_tip_reverts")
    w_ssz(d, "anchor_state.ssz_snappy", anchor.serialize())
    w_ssz(d, "anchor_block.ssz_snappy",
          serialize(type(anchor_block.message).ssz_type,
                    anchor_block.message))
    w_ssz(d, "block_1.ssz_snappy", serialize(type(b1).ssz_type, b1))
    w_ssz(d, "block_2.ssz_snappy", serialize(type(b2).ssz_type, b2))
    steps = [
        {"tick": 2 * spec.seconds_per_slot},
        {"block": "block_1"},
        {"block": "block_2"},
        {"checks": {"head": {"slot": 2, "root": "0x" + r2.hex()}}},
        {"block_hash": "0x" + ph2.hex(),
         "payload_status": {"status": "INVALID",
                            "latest_valid_hash": "0x" + ph1.hex()}},
        {"checks": {"head": {"slot": 1, "root": "0x" + r1.hex()}}},
    ]
    w_yaml(d, "steps.yaml", steps)
    return 1


def gen_bls_eth(root) -> int:
    """eth_aggregate_pubkeys + eth_fast_aggregate_verify via the C++
    backend (independent implementation)."""
    from ..crypto.bls.cpp_backend import CppBackend
    b = CppBackend()
    n = 0

    def case(handler, name, inp, out):
        nonlocal n
        d = wcase(root, "general", "altair", "bls", handler, "small",
                  name)
        w_yaml(d, "data.yaml", {"input": inp, "output": out})
        n += 1

    sks = [5, 6, 7]
    pks = [b.sk_to_pk(sk) for sk in sks]
    agg_pk = b.aggregate_public_keys(pks)
    case("eth_aggregate_pubkeys", "case_agg3",
         ["0x" + p.hex() for p in pks], "0x" + agg_pk.hex())
    case("eth_aggregate_pubkeys", "case_single",
         ["0x" + pks[0].hex()], "0x" + pks[0].hex())
    case("eth_aggregate_pubkeys", "case_empty", [], None)
    case("eth_aggregate_pubkeys", "case_infinity",
         ["0x" + (b"\xc0" + b"\x00" * 47).hex()], None)
    msg = b"\x34" * 32
    sigs = [b.sign(sk, msg) for sk in sks]
    agg_sig = b.aggregate_signatures(sigs)
    case("eth_fast_aggregate_verify", "case_valid3",
         {"pubkeys": ["0x" + p.hex() for p in pks],
          "message": "0x" + msg.hex(),
          "signature": "0x" + agg_sig.hex()}, True)
    case("eth_fast_aggregate_verify", "case_wrong_msg",
         {"pubkeys": ["0x" + p.hex() for p in pks],
          "message": "0x" + (b"\x35" * 32).hex(),
          "signature": "0x" + agg_sig.hex()}, False)
    case("eth_fast_aggregate_verify", "case_empty_infinity",
         {"pubkeys": [], "message": "0x" + msg.hex(),
          "signature": "0x" + (b"\xc0" + b"\x00" * 95).hex()}, True)
    case("eth_fast_aggregate_verify", "case_empty_real_sig",
         {"pubkeys": [], "message": "0x" + msg.hex(),
          "signature": "0x" + sigs[0].hex()}, False)
    return n


GENERATORS = {
    "ssz_generic": gen_ssz_generic,
    "rewards": gen_rewards,
    "fork": gen_fork,
    "finality_random": gen_finality_random,
    "genesis": gen_genesis,
    "light_client": gen_light_client_proofs,
    "sync": gen_sync,
    "bls_eth": gen_bls_eth,
}


def generate_all(dest_root, only: list[str] | None = None) -> int:
    n = 0
    for name, fn in GENERATORS.items():
        if only and name not in only:
            continue
        n += fn(dest_root)
        print(f"  r3:{name} done", flush=True)
    return n
