"""The post-merge workload of chip_smoke.py phase 9 (``stf_workload`` at
``ForkName.DENEB``) against the JAX package, tolerance zero, at 8,192
validators: the Deneb state is ``bench.py``'s ``build_beacon_state`` taken
through each package's own fork upgrades by ``stf_workload.postmerge``,
with the same signer rows; the block's post-state roots of
``per_block_processing`` (signatures off, its payload and withdrawals
processed) are equal in both packages, as tests/test_torch_chain_workload.py
holds the Altair one. The chain workload's block, its sidecars, the
equivocation and the double vote are held to what a node checks of them:
the payload on the state's header, the withdrawals the state expects, the
sidecars' inclusion proofs, signatures on the C++ host backend. The KZG
commitments there are the fake verifier's (the real ones are held to the
JAX package in tests/test_torch_postmerge_parity.py)."""
import pytest

import bench
from lighthouse_tpu.containers import get_types as j_get_types
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.specs.chain_spec import mainnet_spec as j_mainnet_spec
from lighthouse_tpu.ssz import deserialize as jdeserialize
from lighthouse_tpu.state_transition import (
    VerifySignatures as JVerify, per_block_processing as j_per_block,
)
from lighthouse_tpu.state_transition import upgrades as jupgrades
from lighthouse_tpu_torch import stf_workload as sw
from lighthouse_tpu_torch.chain.data_availability import (
    FakeKzgVerifier, verify_commitment_inclusion,
)
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import FakeBackend
from lighthouse_tpu_torch.crypto.bls.cpp_backend import CppBackend
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import ForkName
from lighthouse_tpu_torch.specs.chain_spec import compute_signing_root
from lighthouse_tpu_torch.specs.constants import (
    DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER,
)
from lighthouse_tpu_torch.ssz import htr, serialize
from lighthouse_tpu_torch.state_transition import (
    VerifySignatures, per_block_processing, process_slots,
)
from lighthouse_tpu_torch.state_transition.block import (
    get_expected_withdrawals,
)
from lighthouse_tpu_torch.state_transition.helpers import (
    get_beacon_proposer_index, get_domain,
)

N_SMALL = 8192


@pytest.fixture(autouse=True)
def cpu_and_backends():
    prev = set_device("cpu")
    saved = bls._current, jbls._current
    bls.set_backend("fake")
    jbls.set_backend("fake")
    yield
    bls._current, jbls._current = saved
    set_device(prev)


def test_deneb_block_post_state_equals_the_jax_packages():
    w = sw.build_workload(FakeBackend(), n=N_SMALL, slot=sw.DENEB_SLOT,
                          signed=False, fork=ForkName.DENEB)
    state, block = w.state, w.block
    assert state.fork_name == ForkName.DENEB
    header = state.latest_execution_payload_header
    assert header.block_hash != b"\x00" * 32 and header.block_number > 0
    assert header.timestamp == sw.MAINNET_GENESIS_TIME + 12 * (
        sw.DENEB_SLOT - 1)
    payload = block.message.body.execution_payload
    assert bytes(payload.parent_hash) == bytes(header.block_hash)
    assert list(payload.withdrawals) == get_expected_withdrawals(state)[0]
    assert len(payload.withdrawals) > 0

    js = bench.build_beacon_state(N_SMALL, sw.DENEB_SLOT)
    sw.write_signers(js, w.rows, w.pubkeys)
    sw.postmerge(js, jupgrades)
    assert js.serialize() == state.serialize()

    post = state.copy()
    per_block_processing(post, block, VerifySignatures.FALSE)
    JT = j_get_types(j_mainnet_spec().preset)
    jtyp = JT.SignedBeaconBlock[js.fork_name].ssz_type
    jb = jdeserialize(jtyp, serialize(type(block).ssz_type, block))
    jpost = js.copy()
    j_per_block(jpost, jb, JVerify.FALSE)
    assert post.hash_tree_root() == jpost.hash_tree_root()
    assert post.serialize() == jpost.serialize()
    assert int(post.next_withdrawal_index) == len(payload.withdrawals)


def test_postmerge_chain_workload_is_what_a_node_checks():
    cpp = CppBackend()
    w = sw.build_workload(cpp, n=N_SMALL, slot=sw.DENEB_SLOT,
                          fork=ForkName.DENEB)
    pw = sw.build_postmerge_workload(w, cpp, FakeKzgVerifier(), threads=4)
    cw = pw.chain
    state, block = cw.state, cw.block
    T = state.T
    slot = int(block.message.slot)
    assert bytes(block.message.parent_root) == htr(cw.anchor.message)
    assert bytes(cw.anchor.message.body.execution_payload.block_hash) == \
        bytes(state.latest_execution_payload_header.block_hash)
    # the blobs, their commitments and sidecars
    body = block.message.body
    assert len(pw.blobs) == sw.BLOBS and all(
        len(b) == 131_072 for b in pw.blobs)
    assert body.execution_payload.blob_gas_used == sw.BLOBS * 131_072
    assert list(body.blob_kzg_commitments) == [
        FakeKzgVerifier().blob_to_kzg_commitment(b) for b in pw.blobs]
    assert [int(s.index) for s in pw.sidecars] == list(range(sw.BLOBS))
    for s in pw.sidecars:
        assert verify_commitment_inclusion(T, s, htr(body))
        assert htr(s.signed_block_header.message) == htr(block.message)
    # the block's state root, the signatures on it and on the equivocation
    post = state.copy()
    process_slots(post, slot)
    per_block_processing(post, block, VerifySignatures.FALSE)
    assert post.hash_tree_root() == cw.post_root == bytes(
        block.message.state_root)
    other = pw.equivocation.message
    assert other.slot == block.message.slot and \
        other.proposer_index == block.message.proposer_index
    assert htr(other) != htr(block.message)
    domain = get_domain(post, DOMAIN_BEACON_PROPOSER, post.current_epoch())
    pk = bytes(state.validators.pubkeys[int(other.proposer_index)])
    for signed in (block, pw.equivocation):
        assert cpp.verify(pk, compute_signing_root(htr(signed.message),
                                                   domain),
                          signed.signature)
    # the next slot's proposer holds an interop key (it produces there)
    nxt = get_beacon_proposer_index(post, slot + 1)
    assert nxt in set(w.rows.tolist())
    # the gossip singles at the block's slot (the block's head, the anchor
    # as target): signers with interop keys, none in the block's
    # aggregates; the double vote: the same target and signer, the anchor
    # as head
    anchor_root = htr(cw.anchor.message)
    singles = sw.gossip_attestations(post, htr(block.message), 3, cpp,
                                     threads=1, target_root=anchor_root)
    aggregated = set(int(v) for c in sw.prior_slot_committees(w.state)
                     for v in c)
    adomain = get_domain(post, DOMAIN_BEACON_ATTESTER, post.current_epoch())

    def signer(att) -> bytes:
        committee = sw.slot_committees(post, slot)[int(att.data.index)]
        row = int(committee[list(att.aggregation_bits).index(True)])
        assert row in set(w.rows.tolist()) and row not in aggregated
        return bytes(post.validators.pubkeys[row])

    for att, _subnet in singles:
        assert int(att.data.slot) == slot
        assert bytes(att.data.target.root) == anchor_root
        assert cpp.verify(signer(att),
                          compute_signing_root(htr(att.data), adomain),
                          att.signature)
    att = singles[0][0]
    twin = sw.double_vote(post, att, anchor_root, cpp)
    assert twin.data.target == att.data.target
    assert bytes(twin.data.beacon_block_root) == anchor_root != bytes(
        att.data.beacon_block_root)
    assert list(twin.aggregation_bits) == list(att.aggregation_bits)
    assert cpp.verify(signer(att),
                      compute_signing_root(htr(twin.data), adomain),
                      twin.signature)
    assert T.preset.max_blobs_per_block == sw.BLOBS
