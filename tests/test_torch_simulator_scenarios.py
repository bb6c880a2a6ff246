"""Adversarial scenario suite (testing/scenarios.py) as pytest tier-1.

The cases of the JAX package's tests/test_simulator_scenarios.py, run on
the port (imports switched to lighthouse_tpu_torch; the port on the CPU,
its BLS backend put back after each test); the slow scenarios stay
behind the same ``slow`` marker.

The fast scenarios run inline (each ~10-30s over the plaintext socket
stack); the multi-minute ones stay behind the `slow` marker and the
CLI (`python -m lighthouse_tpu_torch.testing.simulator --scenario NAME`).
"""
import pytest

from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.testing.scenarios import (
    SLOW_SCENARIOS, run_scenario, scenario_names,
)
from lighthouse_tpu_torch.testing.simulator import LocalNetwork, main

FAST_SCENARIOS = sorted(set(scenario_names()) - SLOW_SCENARIOS)


@pytest.fixture(autouse=True)
def cpu():
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


@pytest.mark.parametrize("name", FAST_SCENARIOS)
def test_fast_scenario_passes(name):
    result = run_scenario(name, seed=0)
    assert result.ok, "\n" + result.render()


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SLOW_SCENARIOS))
def test_slow_scenario_passes(name):
    result = run_scenario(name, seed=0)
    assert result.ok, "\n" + result.render()


@pytest.mark.parametrize("name", ["equivocation", "lying_status_chain"])
def test_scenario_is_deterministic_for_a_fixed_seed(name):
    """Same seed, same verdicts: the acceptance bar for the whole suite
    is reproducibility, so the cheapest scenario of each family — one
    fault-fabric, one byzantine-sync — runs twice and every check must
    land identically (details carry wall-clock timings, so only the
    (name, ok) sequence is compared)."""
    a = run_scenario(name, seed=0)
    b = run_scenario(name, seed=0)
    assert [(c.name, c.ok) for c in a.checks] == \
           [(c.name, c.ok) for c in b.checks]
    assert a.ok and b.ok, "\n" + a.render() + "\n" + b.render()


def test_unknown_scenario_is_a_keyerror():
    with pytest.raises(KeyError):
        run_scenario("no_such_scenario")


def test_cli_lists_every_registered_scenario(capsys):
    assert main(["--scenario", "list"]) == 0
    listed = capsys.readouterr().out.split()
    assert listed == scenario_names()
    assert set(SLOW_SCENARIOS) < set(listed)


def test_partitioned_network_reports_per_group_checks():
    """checks() must judge head agreement PER PARTITION GROUP while a
    partition is active, and drop dead nodes from their group."""
    spec = minimal_spec(altair_fork_epoch=0)
    spe = spec.preset.slots_per_epoch
    from lighthouse_tpu_torch.network.faults import FaultInjector
    net = LocalNetwork(spec, 3, 48, topology="mesh",
                       injector=FaultInjector(0))
    try:
        net.run_slots(spe)
        net.partition([0, 1], [2])
        net.run_slots(spe)
        results = {r.name: r for r in net.checks(min_epochs=1)}
        assert "group0_agrees_on_head" in results
        assert "group1_agrees_on_head" in results
        assert "all_nodes_agree_on_head" not in results
        assert results["group0_agrees_on_head"].ok, \
            results["group0_agrees_on_head"].detail
        assert results["group1_agrees_on_head"].ok, \
            results["group1_agrees_on_head"].detail

        # a dead node leaves its group (and the groups) entirely
        net.kill_node(2)
        assert net.live_nodes == net.nodes[:2]
        groups = net._groups()
        assert [len(g) for g in groups] == [2, 0]
    finally:
        net.stop()
