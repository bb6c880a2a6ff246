"""The port's state transition (lighthouse_tpu_torch/state_transition/)
against the JAX package's, tolerance zero: byte-equal roots and SSZ, equal
verdicts. The shuffle and the committee, proposer and sync-committee
helpers on seeded states; StateHarness chains of two epochs on the
minimal preset under fake crypto for phase0, Altair, Capella and Electra
(every signed block, whose state_root is the post-block root, and the
final state); the block replayer; a wrong proposer; and a block with real
signatures through per_block_processing on the port's gpu backend (its
plain kernel versions on the CPU), valid and with a swapped attestation
signature, each verdict the JAX package's on its cpp backend."""
import numpy as np
import pytest

from lighthouse_tpu.containers import state as jst
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.specs import chain_spec as jspec
from lighthouse_tpu.ssz import deserialize as jdeserialize
from lighthouse_tpu.ssz import serialize as jserialize
from lighthouse_tpu.state_transition import (
    BlockProcessingError as JBlockProcessingError,
    VerifySignatures as JVerify, per_block_processing as j_per_block,
    process_slots as j_process_slots,
)
from lighthouse_tpu.state_transition import helpers as jh
from lighthouse_tpu.state_transition import shuffle as jshuffle
from lighthouse_tpu.testing import StateHarness as JHarness
from lighthouse_tpu_torch.containers import state as tst
from lighthouse_tpu_torch.crypto import bls as tbls
from lighthouse_tpu_torch.crypto.bls.cpp_backend import CppBackend
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.seeded_state import fill_state, seeded_columns
from lighthouse_tpu_torch.specs import chain_spec as tspec
from lighthouse_tpu_torch.ssz import serialize as tserialize
from lighthouse_tpu_torch.state_transition import (
    BlockProcessingError, BlockReplayer, VerifySignatures,
    per_block_processing, process_slots,
)
from lighthouse_tpu_torch.state_transition import helpers as th
from lighthouse_tpu_torch.state_transition import shuffle as tshuffle
from lighthouse_tpu_torch.stf_workload import _sum_keys
from lighthouse_tpu_torch.testing import StateHarness

VALIDATORS = 64

#: the forks of tests/test_stf_vectorized.py, and phase0
SPECS = {
    "phase0": {},
    "altair": dict(altair_fork_epoch=0),
    "capella": dict(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                    capella_fork_epoch=0),
    "electra": dict(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                    capella_fork_epoch=0, deneb_fork_epoch=0,
                    electra_fork_epoch=0),
}


@pytest.fixture(autouse=True)
def cpu_and_backends():
    """The port on the CPU; each package's BLS backend put back after the
    test (a test sets both explicitly)."""
    prev = set_device("cpu")
    saved = tbls._current, jbls._current
    yield
    tbls._current, jbls._current = saved
    set_device(prev)


def _fake():
    tbls.set_backend("fake")
    jbls.set_backend("fake")


def _ssz(T, fork, block, serialize) -> bytes:
    return serialize(T.SignedBeaconBlock[fork].ssz_type, block)


# -- the shuffle and the helpers ----------------------------------------------

@pytest.mark.parametrize("n,rounds", [(1, 90), (100, 10), (5000, 10),
                                      (40_000, 90)])
def test_shuffle_matches_jax(n, rounds):
    seed = bytes(np.random.default_rng(n).integers(0, 256, 32,
                                                   dtype=np.uint8))
    want = jshuffle.compute_shuffled_indices(n, seed, rounds)
    assert np.array_equal(tshuffle.compute_shuffled_indices(n, seed, rounds),
                          want)
    pos = np.random.default_rng(n + 1).integers(0, n, 40)
    assert np.array_equal(
        tshuffle.compute_shuffled_index_batch(pos, n, seed, rounds),
        want[pos])
    assert tshuffle.compute_shuffled_index(int(pos[0]), n, seed, rounds) \
        == jshuffle.compute_shuffled_index(int(pos[0]), n, seed, rounds)


def test_shuffle_index_batch_at_1m_matches_jax():
    seed = b"\x5a" * 32
    pos = np.random.default_rng(3).integers(0, 1_000_000, 64)
    assert np.array_equal(
        tshuffle.compute_shuffled_index_batch(pos, 1_000_000, seed, 90),
        jshuffle.compute_shuffled_index_batch(pos, 1_000_000, seed, 90))


def _seeded_pair(fork: str, n: int, seed: int):
    """The same mainnet-preset state in both packages, at a mid-epoch
    slot, with random randao mixes."""
    out = []
    for st, spec_mod in ((jst, jspec), (tst, tspec)):
        state = st.new_state(spec_mod.mainnet_spec(),
                             spec_mod.ForkName[fork])
        fill_state(state, st.ValidatorRegistry(), seeded_columns(n, seed))
        rng = np.random.default_rng(seed + 1)
        state.slot = 32 * 1000 + 5
        state.randao_mixes = rng.integers(0, 256, state.randao_mixes.shape,
                                          dtype=np.uint8)
        out.append(state)
    return out


@pytest.mark.parametrize("fork,n", [("ALTAIR", 20_000), ("ELECTRA", 3_000)])
def test_committee_proposer_and_sync_helpers_match_jax(fork, n):
    _fake()
    js, ts = _seeded_pair(fork, n, seed=n)
    for epoch in (js.current_epoch(), js.current_epoch() + 1):
        jc, tc = jh.committee_cache(js, epoch), th.committee_cache(ts, epoch)
        assert tc.committees_per_slot == jc.committees_per_slot
        for slot in range(epoch * 32, epoch * 32 + 32):
            for i in range(jc.committees_per_slot):
                assert np.array_equal(tc.committee(slot, i),
                                      jc.committee(slot, i))
    for slot in range(js.slot, js.slot + 8):
        assert th.get_beacon_proposer_index(ts, slot) == \
            jh.get_beacon_proposer_index(js, slot)
    assert th.get_next_sync_committee_indices(ts) == \
        jh.get_next_sync_committee_indices(js)
    jsc, tsc = jh.get_next_sync_committee(js), th.get_next_sync_committee(ts)
    assert [bytes(p) for p in tsc.pubkeys] == [bytes(p) for p in jsc.pubkeys]


# -- harness chains -----------------------------------------------------------

_CHAINS: dict = {}


def _chains(fork: str):
    """(JAX harness, its blocks, port harness, its blocks) of two epochs
    of full participation on ``fork``, built once a module."""
    if fork not in _CHAINS:
        _fake()
        spec_j = jspec.minimal_spec(**SPECS[fork])
        spec_t = tspec.minimal_spec(**SPECS[fork])
        hj, ht = JHarness(spec_j, VALIDATORS), StateHarness(spec_t,
                                                           VALIDATORS)
        n = 2 * spec_t.preset.slots_per_epoch
        _CHAINS[fork] = (hj, hj.extend_chain(n), ht, ht.extend_chain(n))
    return _CHAINS[fork]


@pytest.mark.parametrize("fork", list(SPECS))
def test_harness_chain_matches_jax(fork):
    hj, bj, ht, bt = _chains(fork)
    assert len(bt) == len(bj) == 2 * ht.spec.preset.slots_per_epoch
    for a, b in zip(bj, bt):
        f = ht.spec.fork_name_at_slot(b.message.slot)
        assert _ssz(ht.T, f, b, tserialize) == \
            _ssz(hj.T, jspec.ForkName[f.name], a, jserialize)
    assert ht.state.fork_name.name == hj.state.fork_name.name
    assert ht.state.serialize() == hj.state.serialize()
    assert ht.state.hash_tree_root() == hj.state.hash_tree_root()


def test_block_replayer_reproduces_the_ports_state():
    _, _, ht, bt = _chains("altair")
    replayed = BlockReplayer(ht.genesis_state.copy()).apply_blocks(bt)
    assert replayed.hash_tree_root() == ht.state.hash_tree_root()


def test_bad_proposer_rejected():
    """tests/test_state_transition.py::test_bad_proposer_rejected, in both
    packages."""
    hj, _, ht, _ = _chains("phase0")
    for h, process, per_block, err, verify in (
            (hj, j_process_slots, j_per_block, JBlockProcessingError,
             JVerify),
            (ht, process_slots, per_block_processing, BlockProcessingError,
             VerifySignatures)):
        signed, _post = h.produce_block_on_state(h.genesis_state.copy(), 1)
        blk = signed.message
        blk.proposer_index = (blk.proposer_index + 1) % VALIDATORS
        st = h.genesis_state.copy()
        process(st, 1)
        with pytest.raises(err):
            per_block(st, signed, verify.FALSE)


# -- real signatures ----------------------------------------------------------

def test_sum_of_secret_keys_signs_the_aggregate():
    """The workload signs an aggregate once with the sum of its members'
    keys mod r: it equals the aggregate of their own signatures."""
    cpp = CppBackend()
    msg = b"\x21" * 32
    for rows in ([3, 9, 27, 81], [0, 1, 2, 3, 4, 5, 6, 7]):
        sigs = [cpp.sign(tbls.keygen_interop(r), msg) for r in rows]
        assert cpp.sign(_sum_keys(rows), msg) == \
            cpp.aggregate_signatures(sigs)


def test_real_block_on_the_gpu_backend_matches_jax(monkeypatch):
    """A minimal-preset Altair block signed through the cpp backend (two
    attestations and a sync aggregate) passes per_block_processing with
    signatures on the port's gpu backend, and the block with attestation
    0 carrying attestation 1's signature raises; the JAX package, on its
    cpp backend, gives the same verdicts on the same pre-state and block
    (carried across as SSZ bytes)."""
    monkeypatch.setenv("LHTPU_BLS_LANES", "8")
    tbls.set_backend("cpp")
    jbls.set_backend("cpp")
    spec_t = tspec.minimal_spec(**SPECS["altair"])
    spec_j = jspec.minimal_spec(**SPECS["altair"])
    ht = StateHarness(spec_t, VALIDATORS)
    ht.extend_chain(1)
    pre = ht.state.copy()
    (block,) = ht.extend_chain(1)
    assert len(block.message.body.attestations) == 2
    fork = tspec.ForkName.ALTAIR
    jtyp = jst.get_types(spec_j.preset).SignedBeaconBlock[
        jspec.ForkName.ALTAIR].ssz_type

    def verdicts(signed):
        st = pre.copy()
        sj = jst.BeaconState.from_ssz_bytes(
            pre.serialize(), jst.get_types(spec_j.preset), spec_j,
            jspec.ForkName.ALTAIR)
        process_slots(st, 2)
        j_process_slots(sj, 2)
        tbls.set_backend("gpu")
        try:
            per_block_processing(st, signed, VerifySignatures.TRUE)
            got = True
        except BlockProcessingError:
            got = False
        try:
            j_per_block(sj, jdeserialize(jtyp, _ssz(ht.T, fork, signed,
                                                    tserialize)),
                        JVerify.TRUE)
            want = True
        except JBlockProcessingError:
            want = False
        return got, want, st, sj

    got, want, st, sj = verdicts(block)
    assert got is want is True
    assert st.hash_tree_root() == sj.hash_tree_root()

    atts = block.message.body.attestations
    atts[0].signature = atts[1].signature
    got, want, _, _ = verdicts(block)
    assert got is want is False
