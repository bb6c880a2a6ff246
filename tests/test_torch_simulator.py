"""Multi-node simulator: the whole-client tier (basic_sim.rs equivalent).

The cases of the JAX package's tests/test_simulator.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after each test), and the port's ``LocalNetwork`` held
against the JAX package's: the same checks pass and fail and the nodes
justify and finalize the same epochs."""
import importlib.util

import pytest

from lighthouse_tpu_torch.crypto import bls as port_bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.testing.simulator import LocalNetwork


@pytest.fixture(autouse=True)
def cpu():
    prev, saved = set_device("cpu"), port_bls._current
    yield
    port_bls._current = saved
    set_device(prev)


def test_vc_failover_between_nodes():
    """fallback_sim.rs equivalent: the VC keeps performing duties when its
    primary BN dies, via BeaconNodeFallback re-sorting."""
    from lighthouse_tpu_torch.api import ApiBackend
    from lighthouse_tpu_torch.chain import BeaconChainHarness
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.validator_client import (
        BeaconNodeFallback, ValidatorClient, ValidatorStore,
    )
    bls.set_backend("fake")
    spec = minimal_spec()
    h = BeaconChainHarness(spec, 64)
    good = ApiBackend(h.chain)

    class DeadBackend:
        def is_healthy(self):
            raise ConnectionError("down")

        def __getattr__(self, name):
            def dead(*a, **k):
                raise ConnectionError("down")
            return dead

    nodes = BeaconNodeFallback([DeadBackend(), good])
    store = ValidatorStore(spec, h.chain.genesis_validators_root)
    for sk in h.secret_keys:
        store.add_validator(sk)
    vc = ValidatorClient(spec, store, nodes)
    for _ in range(spec.preset.slots_per_epoch):
        h.advance_slot()
        vc.on_slot(h.chain.slot())
        h.chain.recompute_head()
    assert vc.published_blocks >= spec.preset.slots_per_epoch - 1
    nodes.check_health()
    # healthy node re-sorted to the front
    assert nodes.nodes[0] is good


@pytest.mark.skipif(importlib.util.find_spec("cryptography") is None,
                    reason="LocalNetwork dials real noise-XX sockets")
def test_two_node_network_finalizes():
    spec = minimal_spec(altair_fork_epoch=0)
    net = LocalNetwork(spec, node_count=2, validator_count=64)
    try:
        net.run_slots(4 * spec.preset.slots_per_epoch)
        results = net.checks(min_epochs=4)
    finally:
        net.stop()
    failures = [r for r in results if not r.ok]
    assert not failures, failures


@pytest.mark.skipif(importlib.util.find_spec("cryptography") is None,
                    reason="LocalNetwork dials real noise-XX sockets")
def test_http_sim_with_node_death_fails_over():
    """fallback_sim.rs equivalent: VCs drive their nodes over REAL HTTP
    (publication takes POST /eth/v1/beacon/blocks, not an in-process
    shortcut); killing one BN mid-run leaves the chain finalizing and
    the dead node's validators proposing through the fallback URL."""
    from lighthouse_tpu_torch.specs import minimal_spec
    from lighthouse_tpu_torch.testing.simulator import LocalNetwork
    spec = minimal_spec(altair_fork_epoch=0)
    net = LocalNetwork(spec, 2, 64, use_http=True)
    try:
        spe = spec.preset.slots_per_epoch
        net.run_slots(2 * spe)
        blocks_before = net.nodes[1].vc.published_blocks
        kill_slot = net.nodes[0].harness.chain.slot()
        # kill node 1's BN (its VC lives on and fails over to node 0)
        net.kill_node(1)
        net.run_slots(2 * spe)
        results = {r.name: r for r in net.checks(4)}
        assert results["liveness"].ok, results["liveness"].detail
        assert results["finalization"].ok, results["finalization"].detail
        # the dead node's validators kept proposing via the fallback
        assert net.nodes[1].vc.published_blocks > blocks_before
        # ...and those post-kill blocks actually LANDED on the surviving
        # chain (published_blocks alone doesn't prove the POST succeeded)
        chain0 = net.nodes[0].harness.chain
        dead_validators = set(range(32, 64))
        post_kill_landed = 0
        root = chain0.head().head_block_root
        while root is not None:
            blk = chain0.store.get_block(root)
            if blk is None or blk.message.slot <= kill_slot:
                break
            if int(blk.message.proposer_index) in dead_validators:
                post_kill_landed += 1
            root = blk.message.parent_root
        assert post_kill_landed > 0, \
            "no post-kill block from the dead node's validators landed"
    finally:
        net.stop()


@pytest.mark.skipif(importlib.util.find_spec("cryptography") is None,
                    reason="LocalNetwork dials real noise-XX sockets")
def test_local_network_checks_and_finality_equal_the_jax_package():
    """Both packages' ``LocalNetwork(minimal, 2, 64)`` for two epochs: the
    same (name, ok) checks, and the same justified and finalized epochs
    on every node."""
    from lighthouse_tpu.crypto import bls as jbls
    from lighthouse_tpu.specs import minimal_spec as j_minimal_spec
    from lighthouse_tpu.testing.simulator import LocalNetwork as JNetwork
    saved = jbls._current
    out = []
    try:
        for network, make_spec in ((LocalNetwork, minimal_spec),
                                   (JNetwork, j_minimal_spec)):
            spec = make_spec(altair_fork_epoch=0)
            net = network(spec, 2, 64)
            try:
                net.run_slots(2 * spec.preset.slots_per_epoch)
                checks = [(r.name, r.ok) for r in net.checks(min_epochs=2)]
                epochs = [(n.harness.chain.head().head_state.
                           current_justified_checkpoint.epoch,
                           n.harness.chain.finalized_checkpoint()[0])
                          for n in net.nodes]
            finally:
                net.stop()
            out.append((checks, epochs))
    finally:
        jbls._current = saved
    assert out[0] == out[1]
    assert all(ok for _name, ok in out[0][0]), out[0][0]
