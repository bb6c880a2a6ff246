"""The port's post-merge modules against the JAX package's, on the same
seed-made inputs, tolerance zero: KZG commitments, proofs and cells
byte-equal with equal verdicts (and the devnet setup's points); the
engine-API payload JSON and its SSZ round trip; the slasher's records, in
order, on a seeded stream at 100k validators; the EIP-4881 deposit tree's
roots and snapshots. Also: the port's KZG group arithmetic on the C++
library against its pure-Python plain versions, and a library that cannot
be loaded raising rather than falling back."""
import hashlib

import numpy as np
import pytest

from lighthouse_tpu.containers import get_types as j_get_types
from lighthouse_tpu.crypto import kzg as jkzg
from lighthouse_tpu.crypto.bls12_381 import g1_compress as j_g1_compress
from lighthouse_tpu.eth1.deposit_snapshot import DepositTree as JDepositTree
from lighthouse_tpu.execution_layer import execution_layer as jel
from lighthouse_tpu.slasher import Slasher as JSlasher
from lighthouse_tpu.slasher import SlasherConfig as JSlasherConfig
from lighthouse_tpu.specs import ForkName as JForkName
from lighthouse_tpu.specs import minimal_spec as j_minimal_spec
from lighthouse_tpu.ssz import htr as jhtr
from lighthouse_tpu.ssz import serialize as jserialize
from lighthouse_tpu.store import MemoryStore as JMemoryStore
from lighthouse_tpu_torch.containers import get_types
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto import kzg
from lighthouse_tpu_torch.crypto.bls12_381 import (
    G1_GENERATOR, G2_GENERATOR, g1_compress, g2_compress,
)
from lighthouse_tpu_torch.crypto.bls12_381.fields import R
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.eth1.deposit_snapshot import DepositTree
from lighthouse_tpu_torch.execution_layer import execution_layer as el
from lighthouse_tpu_torch.slasher import Slasher, SlasherConfig
from lighthouse_tpu_torch.specs import ForkName, minimal_spec
from lighthouse_tpu_torch.ssz import htr, serialize
from lighthouse_tpu_torch.store import MemoryStore


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU; its BLS backend put back after each test."""
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


def _blob(rng, size):
    """A blob of `size` canonical field elements made from the seed."""
    vals = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(size)]
    return b"".join(v.to_bytes(32, "big") for v in vals)


@pytest.fixture(scope="module")
def kzg_pair():
    # the devnet setups of tests/test_kzg_cells.py: 16 points, 8 cells
    return (kzg.Kzg(devnet_size=16, cells_per_ext_blob=8),
            jkzg.Kzg(devnet_size=16, cells_per_ext_blob=8))


def test_devnet_setup_points_equal_the_jax_packages(kzg_pair):
    port, jax = kzg_pair
    assert port.g1_comp == [j_g1_compress(p) for p in jax.g1]
    assert port.g1_comp == [g1_compress(p)
                            for p in kzg.devnet_setup_plain(16)]
    assert g2_compress(port.tau_g2) == \
        g2_compress(G2_GENERATOR.mul(kzg._DEVNET_TAU))
    assert [g1_compress(p) for p in port.g1] == port.g1_comp


def test_kzg_commitments_proofs_and_verdicts_equal(kzg_pair):
    port, jax = kzg_pair
    rng = np.random.default_rng(14)
    blobs = [_blob(rng, 16) for _ in range(3)]
    comms = [port.blob_to_kzg_commitment(b) for b in blobs]
    assert comms == [jax.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [port.compute_blob_kzg_proof(b, c)
              for b, c in zip(blobs, comms)]
    assert proofs == [jax.compute_blob_kzg_proof(b, c)
                      for b, c in zip(blobs, comms)]
    z = int.from_bytes(rng.bytes(32), "big") % R
    assert port.compute_kzg_proof(blobs[0], z) == \
        jax.compute_kzg_proof(blobs[0], z)
    tampered = bytearray(blobs[1])
    tampered[40] ^= 1
    cases = [
        (blobs, comms, proofs),
        ([blobs[0]], [comms[0]], [proofs[0]]),
        ([blobs[0], bytes(tampered)], comms[:2], proofs[:2]),
        ([blobs[2]], [comms[2]], [proofs[1]]),
    ]
    verdicts = [port.verify_blob_kzg_proof_batch(*c) for c in cases]
    assert verdicts == [jax.verify_blob_kzg_proof_batch(*c) for c in cases]
    assert verdicts == [True, True, False, False]
    assert port.verify_blob_kzg_proof(blobs[0], comms[0], proofs[0]) is \
        jax.verify_blob_kzg_proof(blobs[0], comms[0], proofs[0]) is True


def test_kzg_cells_equal(kzg_pair):
    port, jax = kzg_pair
    blob = _blob(np.random.default_rng(15), 16)
    cells, proofs = port.compute_cells_and_kzg_proofs(blob)
    jcells, jproofs = jax.compute_cells_and_kzg_proofs(blob)
    assert (cells, proofs) == (jcells, jproofs)
    comm = port.blob_to_kzg_commitment(blob)
    idx = [0, 3, 5]
    args = ([comm] * 3, idx, [cells[i] for i in idx],
            [proofs[i] for i in idx])
    bad = (args[0], idx, [cells[0], cells[4], cells[5]], args[3])
    assert [port.verify_cell_kzg_proof_batch(*a) for a in (args, bad)] == \
        [jax.verify_cell_kzg_proof_batch(*a) for a in (args, bad)] == \
        [True, False]
    half = [1, 2, 6, 7]
    rec = port.recover_cells_and_kzg_proofs(half, [cells[i] for i in half])
    assert rec == jax.recover_cells_and_kzg_proofs(
        half, [cells[i] for i in half])
    assert rec == (cells, proofs)


def test_kzg_native_group_arithmetic_equals_the_plain_versions():
    rng = np.random.default_rng(16)
    pts = [g1_compress(G1_GENERATOR.mul(int(rng.integers(1, 1 << 60))))
           for _ in range(4)] + [b"\xc0" + b"\x00" * 47]
    scalars = [int.from_bytes(rng.bytes(32), "big") for _ in range(5)]
    scalars[2] = 0
    assert g1_compress(kzg._msm(scalars, pts)) == \
        g1_compress(kzg._msm_plain(scalars, pts))
    a = G1_GENERATOR.mul(7)
    one = [(a, G2_GENERATOR), (a.neg(), G2_GENERATOR)]
    not_one = [(a, G2_GENERATOR), (G1_GENERATOR, G2_GENERATOR)]
    for pairs in (one, not_one):
        assert kzg._pairing_is_one(pairs) == kzg._pairing_is_one_plain(pairs)
    assert kzg._pairing_is_one(one) and not kzg._pairing_is_one(not_one)
    off_curve = bytes([0x80]) + b"\x00" * 46 + b"\x05"
    with pytest.raises(kzg.KzgError):
        kzg._msm([1], [off_curve])
    with pytest.raises(kzg.KzgError):
        kzg._msm_plain([1], [off_curve])


def test_kzg_native_raises_rather_than_falls_back(monkeypatch):
    from lighthouse_tpu_torch.crypto.bls import cpp_backend

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(kzg, "_NATIVE", None)
    monkeypatch.setattr(cpp_backend, "get_lib", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        kzg.Kzg(devnet_size=8)

    class Stale:                       # a library without the KZG exports
        def bls_selftest(self):
            return 0

    monkeypatch.setattr(cpp_backend, "get_lib", Stale)
    with pytest.raises(RuntimeError, match="kzg_g1_msm"):
        kzg._msm([1], [g1_compress(G1_GENERATOR)])
    assert kzg._NATIVE is None


def _payload_kwargs(rng, fork, n_tx=3, n_wd=4):
    kw = dict(
        parent_hash=rng.bytes(32), fee_recipient=rng.bytes(20),
        state_root=rng.bytes(32), receipts_root=rng.bytes(32),
        logs_bloom=rng.bytes(256), prev_randao=rng.bytes(32),
        block_number=int(rng.integers(1, 1 << 40)),
        gas_limit=30_000_000, gas_used=int(rng.integers(0, 30_000_000)),
        timestamp=int(rng.integers(1 << 30, 1 << 32)),
        extra_data=rng.bytes(int(rng.integers(0, 32))),
        base_fee_per_gas=int(rng.integers(1, 1 << 62)) << 100,
        block_hash=rng.bytes(32),
        transactions=[rng.bytes(int(rng.integers(1, 200)))
                      for _ in range(n_tx)])
    wds = None
    if fork in ("capella", "deneb"):
        wds = [dict(index=int(rng.integers(0, 1 << 40)),
                    validator_index=int(rng.integers(0, 1 << 20)),
                    address=rng.bytes(20),
                    amount=int(rng.integers(0, 1 << 40)))
               for _ in range(n_wd)]
    if fork == "deneb":
        kw["blob_gas_used"] = 6 * 131_072
        kw["excess_blob_gas"] = int(rng.integers(0, 1 << 30))
    return kw, wds


@pytest.mark.parametrize("fork", ["bellatrix", "capella", "deneb"])
def test_payload_json_round_trip_equal(fork):
    T = get_types(minimal_spec().preset)
    JT = j_get_types(j_minimal_spec().preset)
    kw, wds = _payload_kwargs(np.random.default_rng(17), fork)
    f, jf = ForkName[fork.upper()], JForkName[fork.upper()]
    p = T.ExecutionPayload[f](**kw, **({"withdrawals": [
        T.Withdrawal(**w) for w in wds]} if wds else {}))
    jp = JT.ExecutionPayload[jf](**kw, **({"withdrawals": [
        JT.Withdrawal(**w) for w in wds]} if wds else {}))
    js = el._payload_to_json(p)
    assert js == jel._payload_to_json(jp)
    back = el.payload_from_json(T, f, js)
    jback = jel.payload_from_json(JT, jf, js)
    raw = serialize(type(p).ssz_type, p)
    assert serialize(type(back).ssz_type, back) == raw == \
        jserialize(type(jback).ssz_type, jback)
    assert el._payload_to_json(back) == js
    assert htr(back) == jhtr(jback)


def _stream(n, rng):
    """A seeded attestation stream over n validators: committee-sized
    votes each epoch, then planted double votes, surrounds and surrounded
    votes, with block headers of which one pair equivocates."""
    def att(indices, s, t, root):
        return dict(attesting_indices=indices, slot=t * 8, root=root,
                    source=s, target=t)
    out = []
    for epoch in range(6, 16):
        idxs = rng.choice(n, size=512, replace=False)
        out.append(("att", epoch, att(list(map(int, idxs)), epoch - 1,
                                      epoch, b"\x11" * 32)))
    vs = [int(v) for v in rng.choice(n, size=6, replace=False)]
    out.append(("att", 16, att(vs[:2], 15, 16, b"\x22" * 32)))
    out.append(("att", 16, att(vs[:3], 15, 16, b"\x33" * 32)))   # double
    out.append(("att", 17, att([vs[3]], 14, 15, b"\x11" * 32)))
    out.append(("att", 17, att([vs[3]], 13, 17, b"\x11" * 32)))  # surrounds
    out.append(("att", 18, att([vs[4]], 12, 18, b"\x11" * 32)))
    out.append(("att", 18, att([vs[4]], 13, 16, b"\x11" * 32)))  # surrounded
    for graffiti in (b"\x01", b"\x02", b"\x02"):
        out.append(("hdr", 18, dict(slot=150, proposer_index=vs[5],
                                    body_root=graffiti * 32)))
    return out


def _run_slasher(pkg_T, slasher, stream):
    def build(kind, d):
        if kind == "att":
            return pkg_T.IndexedAttestation(
                attesting_indices=d["attesting_indices"],
                data=pkg_T.AttestationData(
                    slot=d["slot"], index=0, beacon_block_root=d["root"],
                    source=pkg_T.Checkpoint(epoch=d["source"],
                                            root=b"\x01" * 32),
                    target=pkg_T.Checkpoint(epoch=d["target"],
                                            root=b"\x02" * 32)),
                signature=b"\x00" * 96)
        return pkg_T.SignedBeaconBlockHeader(
            message=pkg_T.BeaconBlockHeader(
                slot=d["slot"], proposer_index=d["proposer_index"],
                parent_root=b"\x03" * 32, state_root=b"\x04" * 32,
                body_root=d["body_root"]),
            signature=b"\x00" * 96)
    records = []
    for i, (kind, epoch, d) in enumerate(stream):
        msg = build(kind, d)
        (slasher.accept_attestation if kind == "att"
         else slasher.accept_block_header)(msg)
        if i + 1 == len(stream) or stream[i + 1][1] != epoch:
            records += slasher.process_queued(epoch)
    return records, slasher.memory_bytes()


def test_slasher_records_equal_at_100k_validators():
    stream = _stream(100_000, np.random.default_rng(18))
    T = get_types(minimal_spec().preset)
    JT = j_get_types(j_minimal_spec().preset)
    cfg = dict(history_length=4096, cache_chunks=64)
    recs, mem = _run_slasher(T, Slasher(SlasherConfig(**cfg),
                                        store=MemoryStore()), stream)
    jrecs, jmem = _run_slasher(JT, JSlasher(JSlasherConfig(**cfg),
                                            store=JMemoryStore()), stream)

    def key(r, root):
        return (r.kind, r.validator_index,
                None if r.attestation_1 is None else root(r.attestation_1),
                root(r.attestation_2))
    assert [key(r, htr) for r in recs] == [key(r, jhtr) for r in jrecs]
    assert mem == jmem
    kinds = sorted({r.kind for r in recs})
    assert kinds == ["double", "surrounded", "surrounds"]
    # two votes; the second and third headers each against the first
    assert sum(r.kind == "double" for r in recs) == 4


def test_deposit_tree_roots_and_snapshots_equal():
    leaves = [hashlib.sha256(b"deposit" + bytes([i])).digest()
              for i in range(37)]
    port, jax = DepositTree(), JDepositTree()
    for i, leaf in enumerate(leaves):
        port.push_leaf(leaf)
        jax.push_leaf(leaf)
        assert port.root() == jax.root()
        if i in (8, 20, 33):
            port.finalize(i - 3, bytes([i]) * 32, 1000 + i)
            jax.finalize(i - 3, bytes([i]) * 32, 1000 + i)
            snap, jsnap = port.get_snapshot(), jax.get_snapshot()
            assert snap.to_json() == jsnap.to_json()
            assert DepositTree.from_snapshot(snap).root() == \
                JDepositTree.from_snapshot(jsnap).root()
    assert port.root() == jax.root()
