"""The port's metrics layer (api/metrics.py, api/metrics_defs.py) against
the JAX package's: the catalog, equal under ``PORT_NAMES``; the registry
with and without prometheus_client; and the feeds the port's modules
make (spans, the BLS batch size, state copies, copy-on-write chunks, the
shuffling cache), which must move the port's catalog and never the JAX
package's."""
import importlib
import sys

import pytest

from lighthouse_tpu.api import metrics_defs as jmd
from lighthouse_tpu.obs import occupancy as jocc
from lighthouse_tpu.obs import timeseries as jts
from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.api import metrics as tmetrics
from lighthouse_tpu_torch.api import metrics_defs as tmd
from lighthouse_tpu_torch.obs import occupancy as tocc
from lighthouse_tpu_torch.obs import timeseries as tts
from lighthouse_tpu_torch.obs import tracing as ttracing

#: catalog entries whose help text the port words for its runtime (the
#: names and kinds are the JAX package's all the same)
REWORDED = {"device_hbm_bytes_in_use", "roofline_utilization_ratio"}


@pytest.fixture(autouse=True)
def _cpu():
    prev = device.set_device("cpu")
    yield
    device.set_device(prev)


@pytest.fixture
def samplers(monkeypatch):
    """Fresh slot samplers behind both packages' metric feeds."""
    j, t = jts.SlotSampler(window=16), tts.SlotSampler(window=16)
    monkeypatch.setattr(jts, "_SAMPLER", j)
    monkeypatch.setattr(tts, "_SAMPLER", t)
    return j, t


def _pending(sampler, name: str) -> int:
    """Observations of histogram ``name`` the sampler holds for its next
    row (its count once sampled)."""
    sampler.sample(1)
    return int(sampler.latest(f"{name}.count") or 0)


# -- the catalog ----------------------------------------------------------------


def test_catalog_equals_the_jax_catalog_under_port_names():
    mapped = {tmd.PORT_NAMES.get(n, n): v for n, v in jmd.CATALOG.items()}
    assert list(tmd.CATALOG) == list(mapped)
    for name, (kind, help_) in tmd.CATALOG.items():
        assert kind == mapped[name][0], name
        if name not in REWORDED and name not in tmd.PORT_NAMES.values():
            assert help_ == mapped[name][1], name
    assert tmd.EXTERNALLY_FED.keys() == jmd.EXTERNALLY_FED.keys()


def test_port_names_map_every_jax_runtime_entry_and_only_those():
    jax_names = {n for n in jmd.CATALOG if n.startswith("jax_")}
    assert set(tmd.PORT_NAMES) == jax_names
    assert not any(n.startswith("jax_") for n in tmd.CATALOG)
    assert len(set(tmd.PORT_NAMES.values())) == len(tmd.PORT_NAMES)
    # every span kind feeds a declared histogram, as in the JAX package
    for kind, metric in ttracing.SPAN_KINDS.items():
        assert tmd.CATALOG[metric][0] == "hist", kind


# -- the registry, with and without prometheus_client ---------------------------


@pytest.mark.parametrize("have_prom", [True, False])
def test_metrics_registry_with_and_without_prometheus(monkeypatch, samplers,
                                                      have_prom):
    """With prometheus_client the port keeps its own registry (the JAX
    package's stays untouched); without it (as on the card's machine)
    every helper is a no-op for prometheus and still feeds the port's
    sampler, and ``counter_value`` reads the sampler."""
    _, t = samplers
    if not have_prom:
        monkeypatch.setitem(sys.modules, "prometheus_client", None)
    importlib.reload(tmetrics)
    try:
        assert tmetrics._HAVE_PROM is have_prom
        assert tmd.register_catalog() == len(tmd.CATALOG)
        before = tmetrics.counter_value("beacon_block_imported_total")
        tmd.count("beacon_block_imported_total", 3)
        tmd.gauge("beacon_head_slot", 7)
        with tmd.timed("beacon_block_processing_seconds"):
            pass
        assert tmetrics.counter_value(
            "beacon_block_imported_total") == before + 3
        t.sample(1)
        assert t.latest("beacon_block_imported_total") == 3.0
        assert t.latest("beacon_head_slot") == 7.0
        assert t.latest("beacon_block_processing_seconds.count") == 1.0
        if have_prom:
            from prometheus_client import generate_latest
            text = generate_latest(tmetrics.REGISTRY).decode()
            assert "kernel_build_total" in text
            assert tmetrics.REGISTRY is not jmd.metrics.REGISTRY
        else:
            assert tmetrics.REGISTRY is None and tmetrics._metrics == {}
            # no sampler either: a true no-op that never reads the clock
            monkeypatch.setitem(sys.modules,
                                "lighthouse_tpu_torch.obs.timeseries", None)
            timer = tmetrics.start_timer("beacon_block_processing_seconds")
            assert timer._t0 is None
            timer.stop()
    finally:
        monkeypatch.delitem(sys.modules, "prometheus_client", raising=False)
        importlib.reload(tmetrics)
        tmd.register_catalog()
    assert tmetrics._HAVE_PROM is True


# -- the port's feeds move the port's catalog only ------------------------------


def test_port_span_feeds_only_the_port_catalog(samplers):
    j, t = samplers
    with ttracing.span("tree_hash", slot=1):
        pass
    with ttracing.span("bls_batch_verify", sets=2):
        pass
    assert _pending(t, "tree_hash_root_seconds") == 1
    assert t.latest("beacon_batch_verify_seconds.count") == 1.0
    assert _pending(j, "tree_hash_root_seconds") == 0
    assert not j.latest("beacon_batch_verify_seconds.count")


def test_verify_signature_sets_feeds_the_port_batch_size_only(samplers):
    """A two-set batch on the port's ``python`` backend: the port's
    ``bls_batch_verify_sigs`` observes 2, the JAX package's nothing."""
    from lighthouse_tpu_torch.crypto import bls
    j, t = samplers
    prev = bls._current
    try:
        backend = bls.set_backend("python")
        sets = []
        for i, msg in ((1, b"\x11" * 32), (2, b"\x22" * 32)):
            sk = bls.keygen_interop(i)
            sets.append(bls.SignatureSet(backend.sign(sk, msg),
                                         [backend.sk_to_pk(sk)], msg))
        assert bls.verify_signature_sets(sets) is True
    finally:
        bls._current = prev
    t.sample(1)
    j.sample(1)
    assert t.latest("bls_batch_verify_sigs.p50") == 2.0
    assert t.latest("beacon_batch_verify_signature_sets.count") == 1.0
    assert not j.latest("bls_batch_verify_sigs.count")


def test_state_copy_cow_and_registry_feed_the_port_catalog(samplers):
    """``BeaconState.copy`` observes ``state_copy_seconds``, its CoW
    columns count their shared and materialized chunks, the registry's
    root observes its seconds: the port's catalog only."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.specs import minimal_spec
    from lighthouse_tpu_torch.testing import StateHarness
    j, t = samplers
    prev = bls._current
    try:
        bls.set_backend("fake")
        state = StateHarness(minimal_spec(altair_fork_epoch=0), 16).state
    finally:
        bls._current = prev
    state.hash_tree_root()
    copy = state.copy()
    copy.balances[3] = 1
    copy.validators.mark_dirty()
    copy.hash_tree_root()
    t.sample(1)
    j.sample(1)
    assert t.latest("state_copy_seconds.count") >= 1.0
    assert t.latest("state_cow_chunks_shared") > 0
    assert t.latest("state_cow_chunks_materialized") >= 1.0
    # the registry's root timing is fed to the registry alone (it is not
    # a catalog entry, in the JAX package either)
    assert "validator_registry_tree_hash_seconds" in tmetrics._metrics
    for name in ("state_copy_seconds.count", "state_cow_chunks_shared"):
        assert not j.latest(name)


def test_shuffling_cache_counts_hits_and_misses(samplers):
    from lighthouse_tpu_torch.state_transition.helpers import (
        _SharedShufflingCache,
    )
    _, t = samplers
    cache = _SharedShufflingCache()
    assert cache.get(("seed", 1)) is None
    cache.insert(("seed", 1), object())
    assert cache.get(("seed", 1)) is not None
    t.sample(1)
    assert t.latest("shuffle_cache_hits_total") == 1.0
    assert t.latest("shuffle_cache_misses_total") == 1.0


# -- occupancy: the same observations, the same gauges -------------------------


def test_occupancy_publishes_what_the_jax_package_publishes(samplers):
    j, t = samplers
    seq = [("beacon_block_processing_signature_seconds", 0.25),
           ("beacon_block_processing_state_root_seconds", 0.5),
           ("beacon_block_processing_db_write_seconds", 0.125),
           ("beacon_block_pipeline_seconds", 1.0)]
    jo, to = jocc.StageOccupancy(), tocc.StageOccupancy()
    assert jo.publish(now=10.0) == to.publish(now=10.0)
    for name, v in seq:
        jo.on_observation(name, v)
        to.on_observation(name, v)
    assert jo.publish(now=12.0) == to.publish(now=12.0)
    assert list(jo.history) == list(to.history)
    assert jocc.STAGE_METRICS == tocc.STAGE_METRICS


def test_metric_feeds_stay_off_without_the_catalog(monkeypatch, samplers):
    """Without the port's metrics_defs in ``sys.modules`` (a library
    user), a span and a batch feed nothing, as in the JAX package."""
    _, t = samplers
    monkeypatch.setitem(sys.modules, "lighthouse_tpu_torch.api.metrics_defs",
                        None)
    with ttracing.span("tree_hash"):
        pass
    assert _pending(t, "tree_hash_root_seconds") == 0


def test_roofline_ratio_is_a_series_a_kernel(samplers, monkeypatch):
    """Each roofline-timed kernel sets its own ``roofline_utilization_ratio``
    series (label ``kernel``), also after ``register_catalog``; the
    sampler keeps the last value set."""
    import torch
    from prometheus_client import generate_latest

    from lighthouse_tpu_torch.obs import roofline
    _, t = samplers
    monkeypatch.setattr(roofline, "_REGISTRY", {})
    tmd.register_catalog()
    x = torch.ones(1000, dtype=torch.int32)
    for name in ("test.alpha", "test.beta"):
        toy = roofline.track_roofline(
            name, lambda x, s: x * s, lambda out, x, s: (x.numel() * 8,
                                                         x.numel() * s))
        toy(x, 3)
    text = generate_latest(tmetrics.REGISTRY).decode()
    for name in ("test.alpha", "test.beta"):
        (rec,) = roofline.snapshot()[name]
        line = next(l for l in text.splitlines() if l.startswith(
            f'roofline_utilization_ratio{{kernel="{name}"}}'))
        assert float(line.split()[-1]) == pytest.approx(
            rec["utilization_of_peak"])
    t.sample(1)
    assert t.latest("roofline_utilization_ratio") == pytest.approx(
        roofline.snapshot()["test.beta"][0]["utilization_of_peak"])


def test_kernel_launches_on_metrics_from_the_first_bound_library(
        monkeypatch):
    """The first library a process binds puts its launch counts on the
    metrics registry (``kernel_launches_total``, a series a kernel and a
    multiply variant), read at each scrape."""
    from prometheus_client import CollectorRegistry, generate_latest

    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch.obs import cuda_accounting as ca
    monkeypatch.setattr(tmetrics, "REGISTRY", CollectorRegistry())
    monkeypatch.setattr(ca, "_exposed", False)
    monkeypatch.setattr(ca, "_bound", set())
    monkeypatch.setattr(ca, "_counters", dict(ca._counters))
    monkeypatch.setattr(ca, "_metrics", lambda: None)
    monkeypatch.setattr(kernels.HASH64, "launches", 7)
    variant = kernels.FINAL_EXP.variant(1)
    monkeypatch.setattr(variant, "launches", 2)

    def series(text):
        return {l.split('"')[1]: float(l.split()[-1])
                for l in text.splitlines()
                if l.startswith('kernel_launches_total{kernel="')}

    assert series(generate_latest(tmetrics.REGISTRY).decode()) == {}
    ca.record_bound("libone.so")
    ca.record_bound("libtwo.so")
    got = series(generate_latest(tmetrics.REGISTRY).decode())
    assert got == {k: float(v) for k, v in kernels.launch_counts().items()}
    assert got["hash64"] == 7 and got["final_exp_mxu1"] == 2
    monkeypatch.setattr(kernels.HASH64, "launches", 9)
    assert series(generate_latest(tmetrics.REGISTRY).decode())[
        "hash64"] == 9


def test_kernel_launches_written_at_exit_where_asked(tmp_path):
    """With ``LHTPU_LAUNCH_COUNTS`` naming a file, a process that bound a
    library writes its launch counts there as JSON when it exits; without
    it, nothing is written."""
    import json
    import os
    import subprocess
    from pathlib import Path

    from lighthouse_tpu_torch import kernels
    code = ("from lighthouse_tpu_torch import kernels\n"
            "from lighthouse_tpu_torch.obs import cuda_accounting as ca\n"
            "ca.record_bound('libone.so')\n"
            "kernels.PATH_UPDATE.launches = 3\n"
            "kernels.FP_OPS.variant(2).launches = 5\n")
    for asked in (True, False):
        out = tmp_path / f"launches-{asked}.json"
        env = {k: v for k, v in os.environ.items()
               if k != "LHTPU_LAUNCH_COUNTS"}
        if asked:
            env["LHTPU_LAUNCH_COUNTS"] = str(out)
        subprocess.run([sys.executable, "-c", code], check=True, env=env,
                       cwd=Path(__file__).resolve().parents[1], timeout=300)
        assert out.exists() == asked
    got = json.loads((tmp_path / "launches-True.json").read_text())
    want = {name: 0 for name in kernels.KERNELS}
    want.update(path_update=3, fp_ops_mxu2=5)
    assert got == want
