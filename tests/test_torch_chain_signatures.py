"""The chain with real signatures: the port's BeaconChain verifying on its
``gpu`` backend (the kernels' plain versions on the CPU, 8 lanes) against
the JAX package's on its ``cpp`` backend, the same blocks and
attestations carried across as SSZ bytes (minimal preset, Altair from
genesis, 64 validators, every signature made by the C++ host backend).
``process_gossip_block`` accepts the block in both packages; the block
with attestation 0 carrying attestation 1's signature (the proposal
signed again) raises BlockError through the import in both, the head
unchanged; a gossip batch of two single-bit attestations, the second
carrying the first's signature, gives the same verdicts in both, the
second ``bad_signature``. A gpu-backend verification on the CPU takes
~20 s, so each test makes at most three."""
import pytest

from lighthouse_tpu.chain import BeaconChainHarness as JHarness
from lighthouse_tpu.chain.errors import AttestationError as JAttestationError
from lighthouse_tpu.chain.errors import BlockError as JBlockError
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.specs import minimal_spec as j_minimal_spec
from lighthouse_tpu.ssz import deserialize as jdeserialize
from lighthouse_tpu.ssz import serialize as jserialize
from lighthouse_tpu_torch.chain import BeaconChainHarness, BlockError
from lighthouse_tpu_torch.chain.errors import BAD_SIGNATURE, AttestationError
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.specs.chain_spec import compute_signing_root
from lighthouse_tpu_torch.specs.constants import DOMAIN_BEACON_ATTESTER
from lighthouse_tpu_torch.ssz import htr, serialize
from lighthouse_tpu_torch.state_transition.helpers import (
    committee_cache, get_domain,
)

VALIDATORS = 64
FORKS = dict(altair_fork_epoch=0)


@pytest.fixture(autouse=True)
def cpu_and_backends(monkeypatch):
    monkeypatch.setenv("LHTPU_BLS_LANES", "8")
    prev = set_device("cpu")
    saved = bls._current, jbls._current
    bls.set_backend("cpp")
    jbls.set_backend("cpp")
    yield
    bls._current, jbls._current = saved
    set_device(prev)


def _ssz(obj) -> bytes:
    return serialize(type(obj).ssz_type, obj)


def _jssz(obj) -> bytes:
    return jserialize(type(obj).ssz_type, obj)


def _to_jax(obj, jtemplate):
    """``obj`` (a port SSZ object) as the JAX package's, by its bytes."""
    return jdeserialize(type(jtemplate).ssz_type, _ssz(obj))


def _chains():
    """Both packages' chains one block in, the clock a slot on, and the
    next block (equal bytes in both)."""
    ht = BeaconChainHarness(minimal_spec(**FORKS), VALIDATORS)
    hj = JHarness(j_minimal_spec(**FORKS), VALIDATORS)
    assert ht.extend_chain(1) == hj.extend_chain(1)
    ht.advance_slot()
    hj.advance_slot()
    block, _ = ht.produce_signed_block()
    jblock, _ = hj.produce_signed_block()
    assert _ssz(block) == _jssz(jblock)
    assert len(block.message.body.attestations) == 2
    return ht, hj, block, jblock


def test_gossip_block_accepted_on_the_gpu_backend():
    ht, hj, block, jblock = _chains()
    bls.set_backend("gpu")
    root = ht.chain.process_gossip_block(block)
    assert root == hj.chain.process_gossip_block(jblock) == \
        htr(block.message)
    assert ht.chain.head().head_block_root == root
    assert hj.chain.head().head_block_root == root
    assert ht.chain.head().head_state.serialize() == \
        hj.chain.head().head_state.serialize()


def test_block_with_a_swapped_signature_raises_in_both():
    ht, hj, block, jblock = _chains()
    atts = block.message.body.attestations
    atts[0].signature = atts[1].signature
    bad = ht.sign_block(block.message, ht.chain.head().head_state)
    jbad = _to_jax(bad, jblock)
    heads = ht.chain.head().head_block_root, hj.chain.head().head_block_root
    bls.set_backend("gpu")
    with pytest.raises(BlockError):
        ht.chain.process_block(bad)
    with pytest.raises(JBlockError):
        hj.chain.process_block(jbad)
    assert (ht.chain.head().head_block_root,
            hj.chain.head().head_block_root) == heads
    assert ht.chain.store.get_block(htr(bad.message)) is None


def test_gossip_batch_with_a_bad_signature_same_verdicts():
    ht, hj, _block, jblock = _chains()
    head = ht.chain.head()
    state, slot = head.head_state, int(head.head_state.slot)
    committee = committee_cache(state, state.current_epoch()).committee(
        slot, 0)
    data = ht.sh.attestation_data(state, slot, 0, head.head_block_root)
    root = compute_signing_root(
        htr(data), get_domain(state, DOMAIN_BEACON_ATTESTER,
                              state.current_epoch()))
    sig = bls.sign(ht.secret_keys[int(committee[0])], root)
    singles = []
    for pos in (0, 1):
        bits = [False] * len(committee)
        bits[pos] = True
        singles.append(ht.T.Attestation(aggregation_bits=bits, data=data,
                                        signature=sig))
    jatt_t = jblock.message.body.attestations[0]
    jsingles = [(_to_jax(a, jatt_t), 0) for a in singles]
    bls.set_backend("gpu")
    got = ht.chain.batch_verify_unaggregated_attestations_for_gossip(
        [(a, 0) for a in singles])
    want = hj.chain.batch_verify_unaggregated_attestations_for_gossip(
        jsingles)
    kinds = [r.kind if isinstance(r, AttestationError) else "ok"
             for r in got]
    jkinds = [r.kind if isinstance(r, JAttestationError) else "ok"
              for r in want]
    assert kinds == jkinds == ["ok", BAD_SIGNATURE]
