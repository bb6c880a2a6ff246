"""The beacon node's gossip workload of chip_smoke.py phase 8
(``stf_workload.build_chain_workload``, ``gossip_attestations``) against
the JAX package's ``bench.py`` ``bench_import_critpath``, tolerance zero,
at 8,192 validators with placeholder signatures.

The anchor (the state's ``latest_block_header`` and the signed anchor
block) is byte for byte what ``bench_import_critpath`` hands the JAX chain
builder. The anchored state and the block are ``bench.py``'s
(``build_beacon_state``, ``_build_import_block``, the JAX state
transition filling the block's state root) with the same rewrites in both
packages: the signer rows' interop pubkeys, the anchor justified, the
state at the anchor's slot and the block built on it advanced one slot.
The gossip attestations each verify alone on the C++ host backend."""
import pytest

import bench
from lighthouse_tpu.chain import builder as jbuilder
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.ssz import deserialize as jdeserialize
from lighthouse_tpu.ssz import htr as jhtr
from lighthouse_tpu.ssz import serialize as jserialize
from lighthouse_tpu.state_transition import (
    VerifySignatures as JVerify, per_block_processing as j_per_block,
    process_slots as j_process_slots,
)
from lighthouse_tpu_torch import stf_workload as sw
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import FakeBackend
from lighthouse_tpu_torch.crypto.bls.cpp_backend import CppBackend
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs.chain_spec import compute_signing_root
from lighthouse_tpu_torch.specs.constants import DOMAIN_BEACON_ATTESTER
from lighthouse_tpu_torch.ssz import htr, serialize
from lighthouse_tpu_torch.state_transition.helpers import get_domain

N_SMALL = 8192


@pytest.fixture(autouse=True)
def cpu_and_backends():
    prev = set_device("cpu")
    saved = bls._current, jbls._current
    yield
    bls._current, jbls._current = saved
    set_device(prev)


def _ssz(obj) -> bytes:
    return serialize(type(obj).ssz_type, obj)


def _jssz(obj) -> bytes:
    return jserialize(type(obj).ssz_type, obj)


def test_chain_workload_is_bench_import_critpath(monkeypatch):
    w = sw.build_workload(FakeBackend(), n=N_SMALL, signed=False)
    cw = sw.build_chain_workload(w, FakeBackend(), signed=False)

    captured = {}
    anchor_fn = jbuilder.BeaconChainBuilder.weak_subjectivity_anchor

    def capture(self, state, signed_block):
        captured["header"] = _jssz(state.latest_block_header)
        captured["anchor"] = _jssz(signed_block)
        return anchor_fn(self, state, signed_block)

    monkeypatch.setattr(jbuilder.BeaconChainBuilder,
                        "weak_subjectivity_anchor", capture)
    monkeypatch.setenv("LHTPU_BENCH_STF_N", str(N_SMALL))
    bench.bench_import_critpath()
    assert _ssz(cw.state.latest_block_header) == captured["header"]
    assert _ssz(cw.anchor) == captured["anchor"]
    anchor_root = htr(cw.anchor.message)
    assert bytes(cw.block.message.parent_root) == anchor_root

    js = bench.build_beacon_state(N_SMALL, sw.SLOT)
    sw.write_signers(js, w.rows, w.pubkeys)
    js.latest_block_header = jdeserialize(
        type(js.latest_block_header).ssz_type, captured["header"])
    assert jhtr(js.latest_block_header) == anchor_root
    sw.justify_anchor(js, anchor_root)
    js.slot = sw.SLOT - 1
    assert cw.state.serialize() == js.serialize()
    post = js.copy()
    j_process_slots(post, sw.SLOT)
    jb = bench._build_import_block(post)
    j_per_block(post, jb, JVerify.FALSE)
    jb.message.state_root = post.hash_tree_root()
    assert _ssz(cw.block) == _jssz(jb)
    assert cw.post_root == bytes(jb.message.state_root)
    # the block's attestations name the anchor as head, as a node's would
    assert {bytes(a.data.beacon_block_root)
            for a in cw.block.message.body.attestations} == {anchor_root}


def test_gossip_attestations_are_single_and_signed():
    cpp = CppBackend()
    w = sw.build_workload(cpp, n=N_SMALL)
    cw = sw.build_chain_workload(w, cpp)
    anchor_root = htr(cw.anchor.message)
    pairs = sw.gossip_attestations(cw.state, anchor_root, 40, cpp, threads=4)
    state = cw.state
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, state.current_epoch())
    seen = set()
    for att, subnet in pairs:
        d = att.data
        assert int(d.slot) == int(state.slot) and 0 <= subnet < 64
        assert bytes(d.beacon_block_root) == bytes(d.target.root) == \
            anchor_root
        assert d.source == state.current_justified_checkpoint
        bits = [i for i, b in enumerate(att.aggregation_bits) if b]
        assert len(bits) == 1
        committee = sw.prior_slot_committees(w.state)[int(d.index)]
        row = int(committee[bits[0]])
        assert row not in seen and row in set(w.rows.tolist())
        seen.add(row)
        pk = bytes(state.validators.pubkeys[row])
        assert cpp.verify_signature_sets([bls.SignatureSet(
            att.signature, [pk], compute_signing_root(htr(d), domain))])
    # position by position across the committees: both committees repeat
    assert {int(a.data.index) for a, _ in pairs} == {0, 1}


def test_anchor_as_boundary_gives_a_target_fork_choice_holds():
    """With the anchor's root at its epoch's start slot (phase 10's
    rewrite), the block's attestations and the API's attestation data
    for a later slot of the epoch take the anchor as their target, and a
    chain anchored on the state holds it (bench.py's random row there
    gave a target no fork choice holds)."""
    from lighthouse_tpu_torch.api import ApiBackend
    from lighthouse_tpu_torch.chain import BeaconChainBuilder
    from lighthouse_tpu_torch.chain.execution import MockExecutionLayer
    from lighthouse_tpu_torch.specs.chain_spec import mainnet_spec
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    bls.set_backend("fake")
    w = sw.build_workload(FakeBackend(), n=N_SMALL, signed=False)
    epoch = w.state.current_epoch()
    assert w.state.get_block_root(epoch) != htr(
        sw.anchor_block(w.state.copy()).message)
    root = sw.anchor_as_boundary(w.state)
    cw = sw.build_chain_workload(w, FakeBackend(), signed=False)
    assert root == htr(cw.anchor.message) == \
        cw.state.get_block_root(epoch)
    assert {bytes(a.data.target.root)
            for a in cw.block.message.body.attestations} == {root}
    spec = mainnet_spec()
    chain = (BeaconChainBuilder(spec)
             .weak_subjectivity_anchor(cw.state.copy(), cw.anchor)
             .slot_clock(ManualSlotClock(0, spec.seconds_per_slot,
                                         current_slot=sw.SLOT + 1))
             .execution_layer(MockExecutionLayer())
             .build())
    assert chain.recompute_head() == root
    data = ApiBackend(chain).attestation_data(sw.SLOT + 1, 0)
    assert bytes(data.target.root) == root
    assert chain.fork_choice.contains_block(bytes(data.target.root))
