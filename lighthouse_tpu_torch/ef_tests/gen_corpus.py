"""Generate the committed offline mini-corpus under tests/ef_vectors/.

Independence notes (what keeps these vectors from being pure self-echo):
- ssz_static serializations AND roots are built by HAND here (hashlib
  sha256 + manual little-endian packing), not via lighthouse_tpu_torch.ssz.
- bls vectors are produced by the native C++ backend (an independent
  implementation, itself pinned to RFC 9380 constants), and consumed by
  the python oracle in the runner.
- operations/epoch/sanity/finality post-states are verified at
  GENERATION time against the independent scalar spec transcriptions
  (scalar_spec.py for altair, scalar_spec_electra.py for capella/electra
  — gen_corpus_r3.py / gen_corpus_r5.py), so a vectorized-STF bug fails
  generation instead of being enshrined; fork_choice steps encode
  hand-specified behavioral expectations.  The real EF tarballs would
  still widen case coverage when network access allows.

Run: python -m lighthouse_tpu_torch.ef_tests.gen_corpus [dest_root]
"""
from __future__ import annotations

import hashlib
import shutil
import sys
from pathlib import Path

import yaml

from ..network.snappy import compress_block

ZERO32 = b"\x00" * 32


def hp(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def u64c(v: int) -> bytes:
    return v.to_bytes(8, "little") + b"\x00" * 24


def pad4(c: bytes) -> bytes:
    return c + b"\x00" * (32 - len(c))


def merkle(leaves: list[bytes]) -> bytes:
    n = 1
    while n < len(leaves):
        n *= 2
    nodes = leaves + [ZERO32] * (n - len(leaves))
    while len(nodes) > 1:
        nodes = [hp(nodes[i], nodes[i + 1]) for i in range(0, len(nodes), 2)]
    return nodes[0]


def sig_root(sig96: bytes) -> bytes:
    return merkle([sig96[0:32], sig96[32:64], sig96[64:96] + b""])


# -- hand-built containers ----------------------------------------------------

def checkpoint(epoch: int, root: bytes):
    ser = epoch.to_bytes(8, "little") + root
    return ser, merkle([u64c(epoch), root])


def fork(prev: bytes, cur: bytes, epoch: int):
    ser = prev + cur + epoch.to_bytes(8, "little")
    return ser, merkle([pad4(prev), pad4(cur), u64c(epoch)])


def eth1_data(dep_root: bytes, count: int, block_hash: bytes):
    ser = dep_root + count.to_bytes(8, "little") + block_hash
    return ser, merkle([dep_root, u64c(count), block_hash])


def att_data(slot: int, index: int, bbr: bytes, src, tgt):
    s_ser, s_root = checkpoint(*src)
    t_ser, t_root = checkpoint(*tgt)
    ser = (slot.to_bytes(8, "little") + index.to_bytes(8, "little")
           + bbr + s_ser + t_ser)
    return ser, merkle([u64c(slot), u64c(index), bbr, s_root, t_root])


def block_header(slot, proposer, parent, state, body):
    ser = (slot.to_bytes(8, "little") + proposer.to_bytes(8, "little")
           + parent + state + body)
    return ser, merkle([u64c(slot), u64c(proposer), parent, state, body])


def signed_voluntary_exit(epoch, vindex, sig96):
    msg_ser = epoch.to_bytes(8, "little") + vindex.to_bytes(8, "little")
    msg_root = merkle([u64c(epoch), u64c(vindex)])
    ser = msg_ser + sig96
    return ser, merkle([msg_root, sig_root(sig96)])


# -- writers ------------------------------------------------------------------

def wcase(root: Path, *parts: str) -> Path:
    d = root.joinpath(*parts)
    d.mkdir(parents=True, exist_ok=True)
    return d


def w_ssz(d: Path, name: str, raw: bytes) -> None:
    (d / name).write_bytes(compress_block(raw))


def w_yaml(d: Path, name: str, obj) -> None:
    (d / name).write_text(yaml.safe_dump(obj))


def gen_ssz_static(root: Path) -> int:
    import random
    rng = random.Random(42)

    def r32():
        return bytes(rng.randrange(256) for _ in range(32))

    n = 0
    cases = []
    for i in range(6):
        cases.append(("Checkpoint", *checkpoint(rng.randrange(2**40), r32())))
    cases.append(("Checkpoint", *checkpoint(0, ZERO32)))
    cases.append(("Checkpoint", *checkpoint(2**64 - 1, b"\xff" * 32)))
    for i in range(2):
        cases.append(("Fork", *fork(bytes(rng.randrange(256)
                                          for _ in range(4)),
                                    bytes(rng.randrange(256)
                                          for _ in range(4)),
                                    rng.randrange(2**30))))
    for i in range(2):
        cases.append(("Eth1Data", *eth1_data(r32(), rng.randrange(2**32),
                                             r32())))
    for i in range(2):
        cases.append(("AttestationData", *att_data(
            rng.randrange(2**32), rng.randrange(64), r32(),
            (rng.randrange(2**32), r32()), (rng.randrange(2**32), r32()))))
    for i in range(2):
        cases.append(("BeaconBlockHeader", *block_header(
            rng.randrange(2**32), rng.randrange(2**20), r32(), r32(),
            r32())))
    for i in range(2):
        sig = bytes(rng.randrange(256) for _ in range(96))
        cases.append(("SignedVoluntaryExit", *signed_voluntary_exit(
            rng.randrange(2**32), rng.randrange(2**20), sig)))
    counters: dict[str, int] = {}
    for tname, ser, rt in cases:
        idx = counters.get(tname, 0)
        counters[tname] = idx + 1
        d = wcase(root, "minimal", "altair", "ssz_static", tname,
                  "ssz_random", f"case_{idx}")
        w_ssz(d, "serialized.ssz_snappy", ser)
        w_yaml(d, "roots.yaml", {"root": "0x" + rt.hex()})
        n += 1
    return n


def gen_bls(root: Path) -> int:
    from ..crypto.bls.cpp_backend import CppBackend
    b = CppBackend()
    n = 0

    def case(handler, idx, inp, out):
        nonlocal n
        d = wcase(root, "general", "phase0", "bls", handler, "small",
                  f"case_{idx}")
        w_yaml(d, "data.yaml", {"input": inp, "output": out})
        n += 1

    msgs = [b"\x11" * 32, b"\xab" * 32, b"\x00" * 32, b"\x5a" * 32]
    sks = [1, 42, 2**200 + 7, 12345678901234567890]
    for i, (sk, m) in enumerate(zip(sks, msgs)):
        sig = b.sign(sk, m)
        case("sign", i, {"privkey": f"0x{sk:064x}",
                         "message": "0x" + m.hex()}, "0x" + sig.hex())
    for i in range(4):
        sk, m = sks[i], msgs[i]
        pk, sig = b.sk_to_pk(sk), b.sign(sk, m)
        case("verify", i, {"pubkey": "0x" + pk.hex(),
                           "message": "0x" + m.hex(),
                           "signature": "0x" + sig.hex()}, True)
    # negative verifies: wrong message / wrong key
    pk0, sig0 = b.sk_to_pk(sks[0]), b.sign(sks[0], msgs[0])
    case("verify", 4, {"pubkey": "0x" + pk0.hex(),
                       "message": "0x" + msgs[1].hex(),
                       "signature": "0x" + sig0.hex()}, False)
    case("verify", 5, {"pubkey": "0x" + b.sk_to_pk(sks[1]).hex(),
                       "message": "0x" + msgs[0].hex(),
                       "signature": "0x" + sig0.hex()}, False)
    for i in range(2):
        sigs = [b.sign(sk, msgs[i]) for sk in sks[:3]]
        agg = b.aggregate_signatures(sigs)
        case("aggregate", i, ["0x" + s.hex() for s in sigs],
             "0x" + agg.hex())
    for i in range(3):
        group = sks[:i + 2]
        sigs = [b.sign(sk, msgs[0]) for sk in group]
        agg = b.aggregate_signatures(sigs)
        case("fast_aggregate_verify", i,
             {"pubkeys": ["0x" + b.sk_to_pk(sk).hex() for sk in group],
              "message": "0x" + msgs[0].hex(),
              "signature": "0x" + agg.hex()}, True)
    sigs = [b.sign(sk, m) for sk, m in zip(sks[:3], msgs[:3])]
    agg = b.aggregate_signatures(sigs)
    case("aggregate_verify", 0,
         {"pubkeys": ["0x" + b.sk_to_pk(sk).hex() for sk in sks[:3]],
          "messages": ["0x" + m.hex() for m in msgs[:3]],
          "signature": "0x" + agg.hex()}, True)
    case("aggregate_verify", 1,
         {"pubkeys": ["0x" + b.sk_to_pk(sk).hex() for sk in sks[:3]],
          "messages": ["0x" + m.hex() for m in reversed(msgs[:3])],
          "signature": "0x" + agg.hex()}, False)
    return n


def _mini_chain():
    from ..crypto import bls
    bls.set_backend("python")
    from ..chain.harness import BeaconChainHarness
    from ..specs import minimal_spec
    spec = minimal_spec(altair_fork_epoch=0)
    h = BeaconChainHarness(spec, 16)
    return h, spec


def _write_state(d: Path, name: str, state) -> None:
    w_ssz(d, name, state.serialize())


def gen_state_cases(root: Path) -> int:
    """operations + epoch_processing + sanity + fork_choice vectors."""
    from ..ssz import htr, serialize
    from ..state_transition import per_block_processing, process_slots
    from ..state_transition import block as blk
    from ..state_transition import epoch as ep
    from ..state_transition.block import VerifySignatures
    from ..state_transition.helpers import (
        get_beacon_committee, get_beacon_proposer_index,
        get_total_active_balance,
    )
    from . import scalar_spec
    h, spec = _mini_chain()
    T = h.T
    n = 0
    h.extend_chain(2 * spec.preset.slots_per_epoch + 2)
    base = h.chain.head().head_state

    # ---- operations/block_header: valid + invalid (bad proposer) ----
    h.advance_slot()
    slot = h.chain.slot()
    st = base.copy()
    process_slots(st, slot)
    proposer = get_beacon_proposer_index(st, slot)
    reveal = h.randao_reveal(st, slot, proposer)
    block, _post = h.chain.produce_block(reveal, slot)
    d = wcase(root, "minimal", "altair", "operations", "block_header",
              "pyspec_tests", "valid_header")
    _write_state(d, "pre.ssz_snappy", st)
    w_ssz(d, "block.ssz_snappy", serialize(type(block).ssz_type, block))
    good = st.copy()
    blk.process_block_header(good, block)
    scalar_spec.verify_block_header_op(st, block, good)
    _write_state(d, "post.ssz_snappy", good)
    n += 1
    d = wcase(root, "minimal", "altair", "operations", "block_header",
              "pyspec_tests", "invalid_proposer")
    _write_state(d, "pre.ssz_snappy", st)
    bad = T.BeaconBlock[st.fork_name](
        slot=block.slot, proposer_index=(block.proposer_index + 1) % 16,
        parent_root=block.parent_root, state_root=block.state_root,
        body=block.body)
    w_ssz(d, "block.ssz_snappy", serialize(type(bad).ssz_type, bad))
    n += 1

    # ---- operations/attestation: valid + invalid target ----
    h.attest_to_head()
    st2 = base.copy()
    process_slots(st2, h.chain.slot() + 1)
    att = h.chain.op_pool.get_attestations_for_block(st2)[0]
    d = wcase(root, "minimal", "altair", "operations", "attestation",
              "pyspec_tests", "valid_attestation")
    _write_state(d, "pre.ssz_snappy", st2)
    w_ssz(d, "attestation.ssz_snappy", serialize(T.Attestation.ssz_type,
                                                 att))
    good = st2.copy()
    blk.process_attestation(good, att, VerifySignatures.TRUE)
    scalar_spec.verify_attestation_op(st2, att, good)
    _write_state(d, "post.ssz_snappy", good)
    n += 1
    d = wcase(root, "minimal", "altair", "operations", "attestation",
              "pyspec_tests", "invalid_target")
    _write_state(d, "pre.ssz_snappy", st2)
    bad_att = T.Attestation(
        aggregation_bits=att.aggregation_bits,
        data=T.AttestationData(
            slot=att.data.slot, index=att.data.index,
            beacon_block_root=att.data.beacon_block_root,
            source=att.data.source,
            target=T.Checkpoint(epoch=att.data.target.epoch + 7,
                                root=att.data.target.root)),
        signature=att.signature)
    w_ssz(d, "attestation.ssz_snappy",
          serialize(T.Attestation.ssz_type, bad_att))
    n += 1

    # ---- operations/voluntary_exit: valid + invalid (young validator) ----
    from ..specs.constants import DOMAIN_VOLUNTARY_EXIT
    st3 = base.copy()
    # age the chain far enough for exits
    target_epoch = spec.shard_committee_period + 3
    process_slots(st3, target_epoch * spec.preset.slots_per_epoch)
    exit_msg = T.VoluntaryExit(epoch=st3.current_epoch(), validator_index=3)
    from ..state_transition.helpers import get_domain
    from ..specs.chain_spec import compute_signing_root
    domain = get_domain(st3, DOMAIN_VOLUNTARY_EXIT, st3.current_epoch())
    sroot = compute_signing_root(htr(exit_msg), domain)
    from ..crypto import bls as _bls
    sig = _bls.sign(h.sh.secret_keys[3], sroot)
    sve = T.SignedVoluntaryExit(message=exit_msg, signature=sig)
    d = wcase(root, "minimal", "altair", "operations", "voluntary_exit",
              "pyspec_tests", "valid_exit")
    _write_state(d, "pre.ssz_snappy", st3)
    w_ssz(d, "voluntary_exit.ssz_snappy",
          serialize(T.SignedVoluntaryExit.ssz_type, sve))
    good = st3.copy()
    blk.process_voluntary_exit(good, sve, VerifySignatures.TRUE)
    scalar_spec.verify_voluntary_exit_op(st3, sve, good)
    _write_state(d, "post.ssz_snappy", good)
    n += 1
    d = wcase(root, "minimal", "altair", "operations", "voluntary_exit",
              "pyspec_tests", "invalid_bad_signature")
    _write_state(d, "pre.ssz_snappy", st3)
    bad_sve = T.SignedVoluntaryExit(
        message=T.VoluntaryExit(epoch=st3.current_epoch(),
                                validator_index=4), signature=sig)
    w_ssz(d, "voluntary_exit.ssz_snappy",
          serialize(T.SignedVoluntaryExit.ssz_type, bad_sve))
    n += 1

    # ---- operations/proposer_slashing: valid + invalid (same header) ----
    st4 = base.copy()
    process_slots(st4, st4.slot + 1)
    pidx = 5
    from ..specs.constants import DOMAIN_BEACON_PROPOSER
    h1 = T.BeaconBlockHeader(slot=st4.slot, proposer_index=pidx,
                             parent_root=b"\x01" * 32,
                             state_root=b"\x02" * 32,
                             body_root=b"\x03" * 32)
    h2 = T.BeaconBlockHeader(slot=st4.slot, proposer_index=pidx,
                             parent_root=b"\x01" * 32,
                             state_root=b"\x04" * 32,
                             body_root=b"\x03" * 32)
    dom = get_domain(st4, DOMAIN_BEACON_PROPOSER,
                     st4.slot // spec.preset.slots_per_epoch)
    sh1 = T.SignedBeaconBlockHeader(
        message=h1, signature=_bls.sign(
            h.sh.secret_keys[pidx], compute_signing_root(htr(h1), dom)))
    sh2 = T.SignedBeaconBlockHeader(
        message=h2, signature=_bls.sign(
            h.sh.secret_keys[pidx], compute_signing_root(htr(h2), dom)))
    ps = T.ProposerSlashing(signed_header_1=sh1, signed_header_2=sh2)
    d = wcase(root, "minimal", "altair", "operations", "proposer_slashing",
              "pyspec_tests", "valid_slashing")
    _write_state(d, "pre.ssz_snappy", st4)
    w_ssz(d, "proposer_slashing.ssz_snappy",
          serialize(T.ProposerSlashing.ssz_type, ps))
    good = st4.copy()
    blk.process_proposer_slashing(good, ps, VerifySignatures.TRUE)
    scalar_spec.verify_slashing_op(
        st4, pidx, get_beacon_proposer_index(st4), good)
    _write_state(d, "post.ssz_snappy", good)
    n += 1
    d = wcase(root, "minimal", "altair", "operations", "proposer_slashing",
              "pyspec_tests", "invalid_same_header")
    _write_state(d, "pre.ssz_snappy", st4)
    same = T.ProposerSlashing(signed_header_1=sh1, signed_header_2=sh1)
    w_ssz(d, "proposer_slashing.ssz_snappy",
          serialize(T.ProposerSlashing.ssz_type, same))
    n += 1

    # ---- epoch_processing ----
    ep_state = base.copy()
    process_slots(ep_state,
                  (ep_state.current_epoch() + 1)
                  * spec.preset.slots_per_epoch - 1)
    for sub, fn in [
        ("justification_and_finalization",
         lambda s: ep.process_justification_and_finalization(s)),
        ("inactivity_updates",
         lambda s: ep._process_inactivity_updates(s)),
        ("rewards_and_penalties",
         lambda s: ep._process_rewards_and_penalties_altair(
             s, s.fork_name, ep.get_total_active_balance(s))),
        ("slashings",
         lambda s: ep._process_slashings(
             s, s.fork_name, ep.get_total_active_balance(s))),
        ("effective_balance_updates",
         lambda s: ep._process_effective_balance_updates(s)),
        ("slashings_reset", lambda s: ep._process_slashings_reset(s)),
        ("randao_mixes_reset", lambda s: ep._process_randao_mixes_reset(s)),
        ("eth1_data_reset", lambda s: ep._process_eth1_data_reset(s)),
        ("registry_updates",
         lambda s: ep._process_registry_updates(s, s.fork_name)),
        ("sync_committee_updates",
         lambda s: ep._process_sync_committee_updates(s)),
    ]:
        d = wcase(root, "minimal", "altair", "epoch_processing", sub,
                  "pyspec_tests", f"{sub}_basic")
        _write_state(d, "pre.ssz_snappy", ep_state)
        post = ep_state.copy()
        fn(post)
        # the expected post is only written once the INDEPENDENT scalar
        # transcription agrees with the vectorized transition
        # (de-circularization, scalar_spec.py)
        scalar_spec.verify_epoch_subtransition(sub, ep_state, post)
        _write_state(d, "post.ssz_snappy", post)
        n += 1

    # ---- sanity/slots + sanity/blocks ----
    for i, k in enumerate((1, spec.preset.slots_per_epoch)):
        d = wcase(root, "minimal", "altair", "sanity", "slots",
                  "pyspec_tests", f"slots_{k}")
        s = base.copy()
        _write_state(d, "pre.ssz_snappy", s)
        w_yaml(d, "slots.yaml", k)
        post = s.copy()
        process_slots(post, post.slot + k)
        if (s.slot + k) // spec.preset.slots_per_epoch > \
                s.slot // spec.preset.slots_per_epoch:
            # epoch crossed: scalar-verify the composed transition from
            # the state at the boundary's last slot
            boundary_pre = s.copy()
            last = ((s.slot // spec.preset.slots_per_epoch + 1)
                    * spec.preset.slots_per_epoch - 1)
            process_slots(boundary_pre, last)
            scalar_spec.verify_epoch_transition(boundary_pre, post)
        _write_state(d, "post.ssz_snappy", post)
        n += 1
    signed, _post = h.produce_signed_block()
    d = wcase(root, "minimal", "altair", "sanity", "blocks",
              "pyspec_tests", "valid_block")
    _write_state(d, "pre.ssz_snappy", base)
    w_yaml(d, "meta.yaml", {"blocks_count": 1})
    w_ssz(d, "blocks_0.ssz_snappy",
          serialize(type(signed).ssz_type, signed))
    post = base.copy()
    process_slots(post, signed.message.slot)
    per_block_processing(post, signed)
    _write_state(d, "post.ssz_snappy", post)
    n += 1
    d = wcase(root, "minimal", "altair", "sanity", "blocks",
              "pyspec_tests", "invalid_state_root")
    _write_state(d, "pre.ssz_snappy", base)
    w_yaml(d, "meta.yaml", {"blocks_count": 1})
    tampered = T.SignedBeaconBlock[base.fork_name](
        message=T.BeaconBlock[base.fork_name](
            slot=signed.message.slot,
            proposer_index=signed.message.proposer_index,
            parent_root=signed.message.parent_root,
            state_root=b"\x66" * 32, body=signed.message.body),
        signature=signed.signature)
    w_ssz(d, "blocks_0.ssz_snappy",
          serialize(type(tampered).ssz_type, tampered))
    n += 1

    # ---- fork_choice/get_head ----
    from ..fork_choice.proto_array import ExecutionStatus
    anchor = h.chain.genesis_state
    anchor_block = h.chain.store.get_block(h.chain.genesis_block_root)
    d = wcase(root, "minimal", "altair", "fork_choice", "get_head",
              "pyspec_tests", "chain_head")
    w_ssz(d, "anchor_state.ssz_snappy", anchor.serialize())
    w_ssz(d, "anchor_block.ssz_snappy",
          serialize(type(anchor_block.message).ssz_type,
                    anchor_block.message))
    # two blocks on top of genesis (from the real chain history)
    b1_root = h.chain.block_root_at_slot(1)
    b2_root = h.chain.block_root_at_slot(2)
    b1 = h.chain.store.get_block(b1_root)
    b2 = h.chain.store.get_block(b2_root)
    w_ssz(d, "block_1.ssz_snappy", serialize(type(b1).ssz_type, b1))
    w_ssz(d, "block_2.ssz_snappy", serialize(type(b2).ssz_type, b2))
    steps = [
        {"tick": 2 * spec.seconds_per_slot},
        {"block": "block_1"},
        {"block": "block_2"},
        {"checks": {"head": {"slot": 2, "root": "0x" + b2_root.hex()}}},
    ]
    w_yaml(d, "steps.yaml", steps)
    n += 1
    return n


def _spec_shuffled_index(index: int, count: int, seed: bytes,
                         rounds: int) -> int:
    """INDEPENDENT scalar transcription of the spec's
    compute_shuffled_index (phase0 spec pseudocode), deliberately not
    importing state_transition.shuffle — the vectorized implementation is
    what the runner checks against these vectors."""
    for r in range(rounds):
        pivot = int.from_bytes(hashlib.sha256(
            seed + bytes([r])).digest()[:8], "little") % count
        flip = (pivot + count - index) % count
        position = max(index, flip)
        source = hashlib.sha256(
            seed + bytes([r]) + (position // 256).to_bytes(4,
                                                           "little")).digest()
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) % 2:
            index = flip
    return index


def gen_shuffling(root: Path) -> int:
    """tests/minimal/phase0/shuffling/core/shuffle/* — mapping[i] =
    compute_shuffled_index(i, count, seed) at the minimal preset's 10
    rounds (consensus/swap_or_not_shuffle test layout)."""
    n = 0
    rng_seeds = [bytes([i]) * 32 for i in (0, 7, 42)]
    for count in (1, 2, 3, 8, 33, 100):
        for seed in rng_seeds:
            mapping = [_spec_shuffled_index(i, count, seed, 10)
                       for i in range(count)]
            d = wcase(root, "minimal", "phase0", "shuffling", "core",
                      "shuffle", f"shuffle_0x{seed[:4].hex()}_{count}")
            w_yaml(d, "mapping.yaml", {
                "seed": "0x" + seed.hex(), "count": count,
                "mapping": mapping})
            n += 1
    return n


def gen_kzg(root: Path) -> int:
    """tests/general/deneb/kzg/* + fulu cells cases over the devnet
    trusted setup (size 16, 8 cells).  Generated with the native
    C++ MSM/pairing DISABLED (pure-python group arithmetic); the runner
    verifies with whatever backend is live — on this image the native
    library, making generation and verification independent
    implementations of the group math."""
    from ..crypto import kzg as kzgmod
    old_native = kzgmod._NATIVE
    kzgmod._NATIVE = False        # force pure-python generation
    try:
        k = kzgmod.Kzg(devnet_size=16, cells_per_ext_blob=8)
        blobs = [
            b"".join(((j * 17 + s) % kzgmod.R).to_bytes(32, "big")
                     for j in range(16))
            for s in (1, 5)]
        n = 0
        comms = [k.blob_to_kzg_commitment(b) for b in blobs]
        proofs = [k.compute_blob_kzg_proof(b, c)
                  for b, c in zip(blobs, comms)]
        for i, (b, c, p) in enumerate(zip(blobs, comms, proofs)):
            d = wcase(root, "general", "deneb", "kzg",
                      "blob_to_kzg_commitment", "kzg-devnet", f"case_{i}")
            w_yaml(d, "data.yaml", {
                "input": {"blob": "0x" + b.hex()},
                "output": "0x" + c.hex()})
            n += 1
            d = wcase(root, "general", "deneb", "kzg",
                      "verify_blob_kzg_proof", "kzg-devnet", f"case_{i}")
            w_yaml(d, "data.yaml", {
                "input": {"blob": "0x" + b.hex(),
                          "commitment": "0x" + c.hex(),
                          "proof": "0x" + p.hex()},
                "output": True})
            n += 1
        # an invalid proof case (proof from the other blob)
        d = wcase(root, "general", "deneb", "kzg",
                  "verify_blob_kzg_proof", "kzg-devnet", "case_invalid")
        w_yaml(d, "data.yaml", {
            "input": {"blob": "0x" + blobs[0].hex(),
                      "commitment": "0x" + comms[0].hex(),
                      "proof": "0x" + proofs[1].hex()},
            "output": False})
        n += 1
        d = wcase(root, "general", "deneb", "kzg",
                  "verify_blob_kzg_proof_batch", "kzg-devnet", "case_0")
        w_yaml(d, "data.yaml", {
            "input": {"blobs": ["0x" + b.hex() for b in blobs],
                      "commitments": ["0x" + c.hex() for c in comms],
                      "proofs": ["0x" + p.hex() for p in proofs]},
            "output": True})
        n += 1
        # fulu cells: compute + verify + recover
        cells, cproofs = k.compute_cells_and_kzg_proofs(blobs[0])
        d = wcase(root, "general", "fulu", "kzg",
                  "compute_cells_and_kzg_proofs", "kzg-devnet", "case_0")
        w_yaml(d, "data.yaml", {
            "input": {"blob": "0x" + blobs[0].hex()},
            "output": [["0x" + c.hex() for c in cells],
                       ["0x" + p.hex() for p in cproofs]]})
        n += 1
        d = wcase(root, "general", "fulu", "kzg",
                  "verify_cell_kzg_proof_batch", "kzg-devnet", "case_0")
        w_yaml(d, "data.yaml", {
            "input": {"commitments": ["0x" + comms[0].hex()] * 3,
                      "cell_indices": [0, 3, 7],
                      "cells": ["0x" + cells[i].hex() for i in (0, 3, 7)],
                      "proofs": ["0x" + cproofs[i].hex()
                                 for i in (0, 3, 7)]},
            "output": True})
        n += 1
        keep = [1, 3, 4, 6]
        d = wcase(root, "general", "fulu", "kzg",
                  "recover_cells_and_kzg_proofs", "kzg-devnet", "case_0")
        w_yaml(d, "data.yaml", {
            "input": {"cell_indices": keep,
                      "cells": ["0x" + cells[i].hex() for i in keep]},
            "output": [["0x" + c.hex() for c in cells],
                       ["0x" + p.hex() for p in cproofs]]})
        n += 1
        return n
    finally:
        kzgmod._NATIVE = old_native


def gen_transition(root: Path) -> int:
    """tests/minimal/<post_fork>/transition/core/pyspec_tests/*: a chain
    crossing the fork boundary — pre-fork pre-state, blocks on both
    sides, post-fork post-state (EF transition layout)."""
    from ..crypto import bls
    bls.set_backend("python")
    from ..chain.harness import BeaconChainHarness
    from ..specs import minimal_spec
    from ..ssz import serialize

    n = 0
    for post_fork, overrides in (
            ("altair", {"altair_fork_epoch": 1}),
            ("bellatrix", {"altair_fork_epoch": 0,
                           "bellatrix_fork_epoch": 1}),
    ):
        spec = minimal_spec(**overrides)
        h = BeaconChainHarness(spec, 16)
        spe = spec.preset.slots_per_epoch
        # blocks from 2 slots before the boundary to 2 after
        pre_slot = spe - 3
        h.extend_chain(pre_slot)
        pre = h.chain.head().head_state.copy()
        blocks = []
        for _ in range(4):
            block_root = h.extend_chain(1)[0]
            blocks.append(h.chain.store.get_block(block_root))
        post = h.chain.head().head_state
        d = wcase(root, "minimal", post_fork, "transition", "core",
                  "pyspec_tests", f"normal_transition_{post_fork}")
        w_yaml(d, "meta.yaml", {
            "post_fork": post_fork, "fork_epoch": 1,
            "blocks_count": len(blocks),
            "fork_block": 1,   # index of the last pre-fork block
        })
        _write_state(d, "pre.ssz_snappy", pre)
        for i, b in enumerate(blocks):
            w_ssz(d, f"blocks_{i}.ssz_snappy",
                  serialize(type(b).ssz_type, b))
        _write_state(d, "post.ssz_snappy", post)
        n += 1
    return n


def main(dest: str | None = None, only: list[str] | None = None) -> None:
    """`only`: resume/partial mode — run just the named gen_corpus_r3
    generators without wiping the tree (generators overwrite their own
    case dirs)."""
    dest_root = Path(dest or Path(__file__).resolve().parents[2]
                     / "tests" / "ef_vectors" / "tests")
    from .gen_corpus_r3 import generate_all
    from .gen_corpus_r5 import generate_all as generate_r5
    if only:
        n = generate_all(dest_root, only)
        n += generate_r5(dest_root, only)
        print(f"wrote {n} cases (partial: {only}) under {dest_root}")
        return
    if dest_root.exists():
        shutil.rmtree(dest_root)
    n = 0
    n += gen_ssz_static(dest_root)
    n += gen_bls(dest_root)
    n += gen_state_cases(dest_root)
    n += gen_shuffling(dest_root)
    n += gen_kzg(dest_root)
    n += gen_transition(dest_root)
    n += generate_all(dest_root)
    n += generate_r5(dest_root)
    print(f"wrote {n} cases under {dest_root}")


if __name__ == "__main__":
    args = sys.argv[1:]
    only = None
    if args and args[0] == "--only":
        only = args[1].split(",")
        args = args[2:]
    main(args[0] if args else None, only=only)
