"""The card's block workload (lighthouse_tpu_torch/stf_workload.py)
against the JAX package's ``bench.py`` recipe, and the two roots of
chip_smoke.py phase 7 pinned to the JAX package's (tolerance zero).

At 8,192 validators (two committees a slot) the port's state and block are byte for byte those of
``bench.py``'s ``build_beacon_state`` and ``_build_import_block`` with the
same signer rows rewritten in both, and the signer rows are the ones the
JAX helpers give; the really signed block passes per_block_processing on
the C++ host backend and both negative blocks raise. At 1,000,000
validators the JAX package alone runs the block and the epoch on the CPU;
the block's SSZ bytes and the signer rows come from stf_workload."""
import pytest

import bench
import chip_smoke
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.specs.chain_spec import ForkName as JFork
from lighthouse_tpu.ssz import deserialize as jdeserialize
from lighthouse_tpu.ssz import serialize as jserialize
from lighthouse_tpu.state_transition import (
    VerifySignatures as JVerify, per_block_processing as j_per_block,
    per_epoch_processing as j_per_epoch,
)
from lighthouse_tpu.state_transition import helpers as jh
from lighthouse_tpu_torch import stf_workload as sw
from lighthouse_tpu_torch.convert import signed_block_from_ssz
from lighthouse_tpu_torch.crypto import bls as tbls
from lighthouse_tpu_torch.crypto.bls import FakeBackend
from lighthouse_tpu_torch.crypto.bls.cpp_backend import CppBackend
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs.chain_spec import ForkName
from lighthouse_tpu_torch.ssz import serialize as tserialize
from lighthouse_tpu_torch.state_transition import (
    BlockProcessingError, VerifySignatures, per_block_processing,
)

N_SMALL = 8192


@pytest.fixture(autouse=True)
def cpu_and_backends():
    prev = set_device("cpu")
    saved = tbls._current, jbls._current
    yield
    tbls._current, jbls._current = saved
    set_device(prev)


def _block_bytes(state, block) -> bytes:
    return tserialize(state.T.SignedBeaconBlock[ForkName.ALTAIR].ssz_type,
                      block)


def _jax_state(n: int, w: sw.Workload):
    """``bench.py``'s state with ``w``'s signer rows rewritten."""
    js = bench.build_beacon_state(n, sw.SLOT)
    sw.write_signers(js, w.rows, w.pubkeys)
    return js


def test_small_workload_is_bench_with_the_signers_rewritten():
    jbls.set_backend("fake")
    w = sw.build_workload(FakeBackend(), n=N_SMALL, signed=False)
    js = _jax_state(N_SMALL, w)
    assert w.state.serialize() == js.serialize()
    jb = bench._build_import_block(js)
    jtyp = js.T.SignedBeaconBlock[JFork.ALTAIR].ssz_type
    assert _block_bytes(w.state, w.block) == jserialize(jtyp, jb)
    # the signers: the proposer, the prior slot's committees, the sync
    # committee's rows, by the JAX helpers
    cache = jh.committee_cache(js, js.current_epoch())
    want = {jh.get_beacon_proposer_index(js)} | set(range(512))
    for i in range(cache.committees_per_slot):
        want |= set(int(v) for v in cache.committee(js.slot - 1, i))
    assert w.rows.tolist() == sorted(want)
    assert len(w.block.message.body.attestations) == \
        cache.committees_per_slot


def test_small_signed_workload_verifies_and_negatives_raise():
    """The really signed block passes with signatures on (the port's C++
    host backend: every aggregate signed once with the sum of its members'
    keys), and both negative blocks of the card's run raise."""
    cpp = CppBackend()
    tbls.set_backend("cpp")
    w = sw.build_workload(cpp, n=N_SMALL)
    decoded = signed_block_from_ssz(_block_bytes(w.state, w.block),
                                    w.state.spec, ForkName.ALTAIR)
    assert _block_bytes(w.state, decoded) == _block_bytes(w.state, w.block)
    pre = w.state
    per_block_processing(pre.copy(), decoded, VerifySignatures.TRUE)
    negatives = sw.negative_blocks(pre, w.block, cpp)
    assert len(negatives) == 2
    for label, bad in negatives.items():
        with pytest.raises(BlockProcessingError):
            per_block_processing(pre.copy(), bad, VerifySignatures.TRUE)
        per_block_processing(pre.copy(), bad, VerifySignatures.FALSE)


def test_1m_block_and_epoch_roots_pin_chip_smoke():
    """The JAX package's post-block and post-epoch roots of the 1M
    workload, which chip_smoke.py phase 7 holds the card to."""
    w = sw.build_workload(CppBackend())
    assert len(w.block.message.body.attestations) == 64
    jbls.set_backend("fake")
    js = _jax_state(sw.N_VALIDATORS, w)
    jb = jdeserialize(js.T.SignedBeaconBlock[JFork.ALTAIR].ssz_type,
                      _block_bytes(w.state, w.block))
    j_per_block(js, jb, JVerify.FALSE)
    assert js.hash_tree_root().hex() == chip_smoke.EXPECTED_BLOCK_ROOT_1M
    ep = js.copy()
    ep.slot = sw.EPOCH_SLOT
    j_per_epoch(ep)
    assert ep.hash_tree_root().hex() == chip_smoke.EXPECTED_EPOCH_ROOT_1M
