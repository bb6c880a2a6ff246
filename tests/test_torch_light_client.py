"""Light-client server: proofs verify against the state root; spec gindices
hold on our field layout.

The same cases as the JAX package's tests/test_light_client.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after the module).
"""
import pytest

from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.chain.light_client import (
    finalized_root_branch, state_field_branch,
)
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.specs import ForkName, minimal_spec
from lighthouse_tpu_torch.ssz import htr
from lighthouse_tpu_torch.ssz.merkle_proof import verify_merkle_proof_gindex
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


@pytest.fixture(autouse=True)
def fake_crypto():
    bls.set_backend("fake")
    yield


def test_sync_committee_branches_verify():
    spec = minimal_spec(altair_fork_epoch=0)
    h = BeaconChainHarness(spec, 64)
    h.extend_chain(4)
    st = h.chain.head().head_state
    root = st.hash_tree_root()
    for name, want_gindex in (("current_sync_committee", 54),
                              ("next_sync_committee", 55)):
        leaf, branch, gindex = state_field_branch(st, name)
        assert gindex == want_gindex, name
        assert verify_merkle_proof_gindex(leaf, branch, gindex, root)
        assert htr(getattr(st, name)) == leaf


def test_finality_branch_verifies():
    spec = minimal_spec(altair_fork_epoch=0)
    h = BeaconChainHarness(spec, 64)
    h.extend_chain(4 * spec.preset.slots_per_epoch)
    st = h.chain.head().head_state
    assert st.finalized_checkpoint.epoch >= 1
    leaf, branch, gindex = finalized_root_branch(st)
    assert gindex == 105
    assert verify_merkle_proof_gindex(leaf, branch, gindex,
                                      st.hash_tree_root())
    assert leaf == st.finalized_checkpoint.root


def test_electra_gindices():
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                        capella_fork_epoch=0, deneb_fork_epoch=0,
                        electra_fork_epoch=0)
    h = BeaconChainHarness(spec, 64)
    h.extend_chain(2)
    st = h.chain.head().head_state
    assert st.fork_name == ForkName.ELECTRA
    _l, _b, g_cur = state_field_branch(st, "current_sync_committee")
    _l, _b, g_next = state_field_branch(st, "next_sync_committee")
    _l, _b, g_fin = finalized_root_branch(st)
    assert (g_cur, g_next, g_fin) == (86, 87, 169)


def test_server_cache_produces_updates():
    spec = minimal_spec(altair_fork_epoch=0)
    h = BeaconChainHarness(spec, 64)
    # finality first reaches the state at the epoch-4 boundary; the attested
    # (parent) state sees it one block later — run into epoch 5
    h.extend_chain(5 * spec.preset.slots_per_epoch)
    cache = h.chain.light_client_cache
    boot = cache.produce_bootstrap(h.chain.head().head_block_root)
    assert boot is not None
    assert boot.header.beacon.slot == h.chain.head().head_state.slot
    assert len(boot.current_sync_committee_branch) == 5
    opt = cache.latest_optimistic_update
    assert opt is not None
    assert sum(1 for b in opt.sync_aggregate.sync_committee_bits if b) > 0
    fin = cache.latest_finality_update
    assert fin is not None
    # the aggregate signs the head's PARENT: signature_slot > attested.slot
    assert fin.signature_slot > fin.attested_header.beacon.slot
    # and the finality proof verifies against the ATTESTED (parent) state
    attested_state = h.chain._state_for(
        h.chain.head().head_block.message.parent_root)
    assert verify_merkle_proof_gindex(
        attested_state.finalized_checkpoint.root,
        fin.finality_branch, 105, attested_state.hash_tree_root())
    upd = cache.produce_update(h.chain.head().head_block_root)
    assert upd is not None and len(upd.next_sync_committee_branch) == 5


def test_update_range_serving():
    """Best update per sync-committee period served by range
    (light_client_server update-range)."""
    spec = minimal_spec(altair_fork_epoch=0)
    h = BeaconChainHarness(spec, 32)
    h.extend_chain(3 * spec.preset.slots_per_epoch)
    cache = h.chain.light_client_cache
    assert cache.best_updates, "best updates tracked per period"
    ups = cache.updates_by_range(0, 4)
    assert ups
    u = ups[0]
    assert u.next_sync_committee is not None
    # participation-maximal update was kept
    period0 = max(cache._best_participation)
    assert cache._best_participation[period0] > 0
    # API route shape
    from lighthouse_tpu_torch.api.backend import ApiBackend
    out = ApiBackend(h.chain).light_client_updates(0, 4)
    assert out and "attested_slot" in out[0]
