"""The port's observability layer (obs/) against the JAX package's, and
its CUDA counterparts on the CPU.

Parity: the same event sequences through both packages' slot samplers,
SLO engines (``hbm_headroom`` with ``hbm_bytes`` patched in both),
scenario captures, causal stitching and critical paths, and both
doctors over the JAX package's checked-in dumps, where the outputs must
be equal apart from the differences each test names.

The port's own: the memory ledger says ``"unavailable"`` on the CPU and
never initialises CUDA; ``track_roofline`` times three calls, then
passes calls through, never catches the call's exception and marks a
broken count ``unavailable``; the build accounting of a fake
``_build/``; the declared cost of every kernel and sharded program at
the flagship shapes, equal to the counts the smoke used before the
costs moved into the wrappers.
"""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lighthouse_tpu.api.metrics_defs  # noqa: F401  (the JAX feeds on)
import lighthouse_tpu_torch.api.metrics_defs  # noqa: F401
from lighthouse_tpu.obs import causal as jcausal
from lighthouse_tpu.obs import critpath as jcritpath
from lighthouse_tpu.obs import device as jdevice
from lighthouse_tpu.obs import doctor as jdoctor
from lighthouse_tpu.obs import slo as jslo
from lighthouse_tpu.obs import timeseries as jts
from lighthouse_tpu.obs import tracing as jtracing
from lighthouse_tpu.obs.capture import scenario_capture as jcapture
from lighthouse_tpu_torch import device, kernels
from lighthouse_tpu_torch.api.metrics_defs import PORT_NAMES
from lighthouse_tpu_torch.obs import causal as tcausal
from lighthouse_tpu_torch.obs import critpath as tcritpath
from lighthouse_tpu_torch.obs import cuda_accounting
from lighthouse_tpu_torch.obs import device as tdevice
from lighthouse_tpu_torch.obs import doctor as tdoctor
from lighthouse_tpu_torch.obs import flight as tflight
from lighthouse_tpu_torch.obs import roofline
from lighthouse_tpu_torch.obs import slo as tslo
from lighthouse_tpu_torch.obs import timeseries as tts
from lighthouse_tpu_torch.obs import tracing as ttracing
from lighthouse_tpu_torch.obs.capture import scenario_capture as tcapture
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as k
from lighthouse_tpu_torch.ops import bls_cost as cost
from lighthouse_tpu_torch.ops import merkle_tree as mt
from lighthouse_tpu_torch.ops import sha256 as sh

FIXTURES = Path(__file__).parent / "graftwatch_fixtures"

#: the JAX package's SLO names the port renames with the metric it reads
SLO_NAMES = {"jax_compile_steady": "kernel_build_steady"}


@pytest.fixture(autouse=True)
def _cpu():
    prev = device.set_device("cpu")
    yield
    device.set_device(prev)


# -- slot sampler parity --------------------------------------------------------


def _ring_events(slot):
    return [("counter", "beacon_block_imported_total", 2),
            ("gauge", "beacon_head_slot", slot - 1)]


def _hist_events(slot):
    base = 10 * (slot % 3)
    return [("hist", "beacon_block_pipeline_seconds", float(base + v))
            for v in range(1, 11)]


def _mixed_events(slot):
    out = [("counter", "beacon_processor_work_dropped_total", slot % 2),
           ("gauge", "beacon_processor_queue_length", 40 - slot)]
    if slot % 4 == 0:
        out.append(("hist", "tree_hash_root_seconds", 0.001 * slot))
    return out


@pytest.mark.parametrize("events, slots", [
    (_ring_events, list(range(1, 21))),           # ring bounds, alignment
    (_hist_events, [1, 1, 2, 3, 3, 4]),           # percentiles, same-slot merge
    (_mixed_events, [1, 2, 3, 4, 5, 6, 7, 8]),
    (_ring_events, [1, 2, 3, 1, 2]),              # a slot going backwards
], ids=["ring", "hist-merge", "mixed", "backwards"])
def test_slot_sampler_rings_equal_the_jax_package(events, slots):
    j, t = jts.SlotSampler(window=8), tts.SlotSampler(window=8)
    for slot in slots:
        for kind, name, value in events(slot):
            j.record(kind, name, value)
            t.record(kind, name, value)
        j.sample(slot)
        t.sample(slot)
    want = j.window_dict()
    # each package samples its own catalog: the JAX runtime series under
    # the port's names
    want["series"] = {PORT_NAMES.get(n, n): v
                      for n, v in want["series"].items()}
    assert t.window_dict() == want
    assert t.latest_slot() == j.latest_slot()
    assert t.counter_total("beacon_block_imported_total") == \
        j.counter_total("beacon_block_imported_total")


# -- SLO incidents --------------------------------------------------------------


def _run_slos(ts, slo_mod, dev, md_name, monkeypatch, names):
    """Sixteen slots through one package's default SLO engine: a pipeline
    storm at slots 8-11 with kernel builds (or XLA compiles) beside it,
    one shed at slot 9, cache events, and device memory filling past the
    headroom budget at slots 10-12 (``hbm_bytes`` patched). The metric
    feeds go through the package's own ``metrics_defs``."""
    md = sys.modules[md_name]
    sampler = ts.SlotSampler(window=32)
    monkeypatch.setattr(ts, "_SAMPLER", sampler)
    hbm = {s: (95 if 10 <= s <= 12 else 40, 100) for s in range(1, 17)}
    slot_box = [0]
    monkeypatch.setattr(dev, "hbm_bytes", lambda: hbm[slot_box[0]])
    eng = slo_mod.SLOEngine(sampler)
    for slot in range(1, 17):
        slot_box[0] = slot
        storm = 8 <= slot <= 11
        for _ in range(4):
            md.observe("beacon_block_pipeline_seconds",
                       7.0 if storm else 0.05)
        md.count("beacon_block_imported_total", 2)
        if storm:
            md.count(names("jax_compile_total"), 3)
        md.count(names("jax_compile_cache_hits_total"), 1 if slot > 10 else 0)
        md.count(names("jax_compile_cache_misses_total"), 3)
        if slot == 9:
            md.count("beacon_processor_work_dropped_total", 5)
        dev.publish()
        sampler.sample(slot)
        eng.evaluate(slot)
    return eng


def test_slo_incidents_open_worsen_and_resolve_as_in_the_jax_package(
        monkeypatch):
    j_eng = _run_slos(jts, jslo, jdevice, "lighthouse_tpu.api.metrics_defs",
                      monkeypatch, lambda n: n)
    t_eng = _run_slos(tts, tslo, tdevice,
                      "lighthouse_tpu_torch.api.metrics_defs", monkeypatch,
                      lambda n: PORT_NAMES[n])
    want = []
    for inc in j_eng.all_incidents():
        d = inc.to_dict()
        d["slo"] = SLO_NAMES.get(d["slo"], d["slo"])
        d["metric"] = PORT_NAMES.get(d["metric"], d["metric"])
        if d["slo"] == "kernel_build_steady":
            d["detail"] = d["detail"].replace("compiles", "builds")
        want.append(d)
    got = [i.to_dict() for i in t_eng.all_incidents()]
    assert got == want
    assert {i["slo"] for i in got} >= {"block_pipeline_p95",
                                       "kernel_build_steady",
                                       "processor_shedding", "hbm_headroom",
                                       "compile_cache_hit_ratio"}
    hbm = next(i for i in got if i["slo"] == "hbm_headroom")
    assert (hbm["opened_slot"], hbm["resolved_slot"]) == (10, 14)
    status = t_eng.status()
    assert set(status) == {SLO_NAMES.get(n, n) for n in j_eng.status()}
    for name, objective in status.items():
        assert objective["metric"] in sys.modules[
            "lighthouse_tpu_torch.api.metrics_defs"].CATALOG, name


def test_hbm_headroom_is_unevaluable_on_the_cpu():
    s = tts.SlotSampler(window=8)
    eng = tslo.SLOEngine(s, slos=[o for o in tslo.default_slos()
                                  if o.name == "hbm_headroom"])
    tdevice.publish()
    s.sample(1)
    assert eng.evaluate(1) == []
    assert eng.status()["hbm_headroom"]["last_detail"] == \
        "HBM stats unavailable on this platform"


# -- captures, stitching and critical paths -------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_scenario_captures_stay_disjoint(pkg):
    capture, tracing = ((jcapture, jtracing) if pkg == "jax"
                        else (tcapture, ttracing))
    with tracing.span("gossip_verify"):
        pass
    with capture() as t1:
        with tracing.span("block_import"):
            pass
    with capture() as t2:
        with tracing.span("block_import"):
            pass
        with tracing.span("block_import"):
            pass
    with tracing.span("gossip_verify"):
        pass
    assert (t1.count("block_import"), t2.count("block_import"),
            t1.count("gossip_verify"), t2.count("gossip_verify")) == \
        (1, 2, 0, 0)


def _synthetic_spans(critpath):
    """A publish on n0, then n1's pipeline with a fork, a join into a
    queued processor hop and the import chain; times are multiples of
    5 ms."""
    SV = critpath.SpanView
    return [
        SV("tA", "P", None, "gossip_publish", 0.000, 0.010,
           {"message_id": "m1", "node": "n0"}),
        SV("tB", "R", None, "block_pipeline", 0.020, 0.100,
           {"message_id": "m1", "node": "n1"}),
        SV("tB", "C1", "R", "gossip_verify", 0.020, 0.040),
        SV("tB", "C2", "R", "batch_signature", 0.025, 0.055),
        SV("tB", "W", "R", "processor_work", 0.060, 0.095,
           {"queue_wait_s": 0.005}),
        SV("tB", "I", "W", "block_import", 0.065, 0.090),
        SV("tB", "S", "I", "state_transition", 0.070, 0.085),
    ]


def test_critical_path_and_stitching_equal_the_jax_package():
    (jc,) = jcausal.stitch(_synthetic_spans(jcritpath))
    (tc,) = tcausal.stitch(_synthetic_spans(tcritpath))
    assert tc.edges == jc.edges == [("P", "R", "propagation")]
    assert tc.node_labels() == jc.node_labels()
    jrep, trep = jcritpath.component_report(jc), tcritpath.component_report(tc)
    assert trep == jrep
    assert trep["total_ms"] == 100.0
    assert tcritpath.render_critical_path(trep, "synthetic") == \
        jcritpath.render_critical_path(jrep, "synthetic")
    assert tcritpath.critical_path([]) == jcritpath.critical_path([])


# -- the doctors over the JAX package's dumps -----------------------------------


def _jax_render_as_port(text: str) -> str:
    """The JAX doctor's report as the port's doctor must render the same
    dump. The named differences, all in the accounting lines:
    - the ``jax:`` line: the port renders a ``cuda`` section, which a JAX
      dump lacks;
    - the co-signal lines of the JAX runtime metrics (``PORT_NAMES``):
      the port correlates its own names, which a JAX dump lacks;
    - a roofline record with a cost: the port reads its integer ``ops``
      and ``bytes``, a JAX record carries XLA ``flops`` and
      ``bytes_accessed``."""
    out = []
    for line in text.splitlines():
        if line.startswith("  jax: "):
            continue
        if any(line.startswith(f"  - {n} [delta]") for n in PORT_NAMES):
            continue
        line = re.sub(r"^(    roofline \S+: )\d+ flops, \d+ B, ",
                      r"\1- int ops, - B, ", line)
        out.append(line)
    return "\n".join(out)


@pytest.mark.parametrize("fixture", ["dump_v1.json", "dump_v1_device.json"])
def test_doctor_renders_the_jax_dumps_as_the_jax_doctor(fixture):
    path = str(FIXTURES / fixture)
    jtext = jdoctor.render(jdoctor.diagnose(jdoctor.load(path)))
    ttext = tdoctor.render(tdoctor.diagnose(tdoctor.load(path)))
    assert ttext == _jax_render_as_port(jtext)
    assert ttext != jtext          # the named differences do occur


class _StubWatch:
    def __init__(self, sampler, engine):
        self.sampler = sampler
        self.engine = engine

    def chains(self):
        return []

    processors = servings = replays = chains


def test_flight_dump_renders_through_the_port_doctor(tmp_path, capsys):
    s = tts.SlotSampler(window=16)
    eng = tslo.SLOEngine(s)
    for slot in range(1, 6):
        s.record("counter", "kernel_build_total", 2 if slot == 3 else 0)
        for _ in range(3):
            s.record("hist", "beacon_block_pipeline_seconds",
                     9.0 if slot == 3 else 0.1)
        s.sample(slot)
        eng.evaluate(slot)
    with ttracing.span("tree_hash"):
        pass
    path = tflight.FlightRecorder(_StubWatch(s, eng),
                                  dump_dir=str(tmp_path)).dump("unit")
    doc = json.loads(Path(path).read_text())
    assert set(doc["cuda"]) >= {"builds", "build_seconds", "cache_hits",
                                "cache_misses", "libraries_loaded",
                                "h2d_bytes", "d2h_bytes", "libraries"}
    assert doc["device"]["platform"] == tdevice.UNAVAILABLE
    assert "jax" not in doc
    assert tdoctor.main([path]) == 0
    text = capsys.readouterr().out
    assert "  cuda: " in text
    assert "kernel_build_total [delta]" in text
    assert "incident block_pipeline_p95: opened slot 3" in text
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    assert tdoctor.main([str(bad)]) == 2


# -- the memory ledger on the CPU -----------------------------------------------


def test_ledger_is_unavailable_on_the_cpu_and_starts_no_backend():
    assert torch.cuda.is_initialized() is False
    snap = tdevice.ledger_snapshot()
    assert (snap["platform"], snap["device_kind"], snap["hbm"]) == (
        tdevice.UNAVAILABLE,) * 3
    assert snap["chip_count"] == 0
    assert tdevice.device_memory_stats() is None
    assert tdevice.hbm_bytes() is None
    with ttracing.span("tree_hash") as sp:
        with tdevice.hbm_watermark("parallel.merkle") as wm:
            pass
    assert wm.delta_bytes == tdevice.UNAVAILABLE
    assert sp.attrs["hbm_delta_bytes"] == tdevice.UNAVAILABLE
    sec = tdevice.flight_section()
    json.dumps(sec)
    assert set(sec["compile_cache"]) == {"hits", "misses"}
    assert torch.cuda.is_initialized() is False


def test_attribution_counts_storage_bytes_while_alive():
    tdevice.reset_attribution()
    try:
        a = torch.zeros(256, dtype=torch.int32)
        b = torch.zeros((4, 8), dtype=torch.int64)
        tdevice.attribute("ops.test", "bufs", a, b)
        rec = tdevice.attributed_bytes()["ops.test"]["bufs"]
        assert rec == {"live_bytes": 1024 + 256, "peak_bytes": 1280}
        del b
        rec = tdevice.attributed_bytes()["ops.test"]["bufs"]
        assert rec == {"live_bytes": 1024, "peak_bytes": 1280}
        tree = mt.DeviceTree(16, 64, device="cpu")
        tree.build(np.zeros((16, 8), np.uint32))
        live = tdevice.attributed_bytes()["ops.merkle_tree"]["levels"]
        assert live["live_bytes"] >= sum(lv.numel() * 4
                                         for lv in tree.levels)
    finally:
        tdevice.reset_attribution()


def test_staged_probe_reports_the_stage_reached(monkeypatch):
    monkeypatch.setattr(tdevice, "_PROBE_STAGES",
                        [("ok", "print('fine')"),
                         ("boom", "import sys; sys.exit(3)"),
                         ("never", "print('unreached')")])
    rec = tdevice.staged_probe(timeout=60)["default"]
    assert rec["stage_reached"] == "boom"
    assert (rec["stages"]["ok"]["rc"], rec["stages"]["boom"]["rc"]) == (0, 3)
    assert "never" not in rec["stages"]


# -- track_roofline -------------------------------------------------------------


@pytest.fixture
def registry(monkeypatch):
    monkeypatch.setattr(roofline, "_REGISTRY", {})
    return roofline._REGISTRY


def test_roofline_times_three_calls_then_passes_through(registry):
    seen = []

    def cost(out, x, scale):
        seen.append(out)
        return x.numel() * 8, x.numel() * scale

    toy = roofline.track_roofline("test.toy", lambda x, scale: x * scale,
                                  cost)
    x = torch.ones(1000, dtype=torch.int32)
    for _ in range(roofline.SAMPLE_CALLS + 2):
        assert int(toy(x, 3).sum()) == 3000
    (rec,) = roofline.snapshot()["test.toy"]
    assert len(seen) == roofline.SAMPLE_CALLS
    assert (rec["calls"], rec["timed_calls"]) == (5, 3)
    assert rec["platform"] == "cpu" and rec["device"] is None
    assert rec["peak"] == roofline.PEAKS["cpu"]["label"]
    assert (rec["bytes"], rec["ops"]) == (8000, 3000)
    assert rec["shapes"] == "int32[1000],3"
    bound = max(8000 / 50e9, 3000 / 200e9) * 1e3
    assert rec["bound_ms"] == pytest.approx(bound)
    assert rec["bound_by"] == "bytes"
    assert rec["utilization_of_peak"] == pytest.approx(
        rec["bound_ms"] / rec["ms"])
    assert 0 < rec["utilization_of_peak"] <= 1.05
    # a new shape is a new record; a capture times every call in it
    with roofline.capture() as calls:
        toy(torch.ones(10, dtype=torch.int32), 3)
        toy(x, 3)
    assert [c["bytes"] for c in calls] == [80, 8000]
    assert [c["kernel"] for c in calls] == ["test.toy"] * 2
    assert len(roofline.snapshot()["test.toy"]) == 2


def test_roofline_never_catches_and_marks_a_broken_count(registry):
    def boom(x):
        raise ValueError("kernel refused")

    raising = roofline.track_roofline("test.raises", boom,
                                      lambda out, x: (0, 0))
    with pytest.raises(ValueError, match="kernel refused"):
        raising(torch.zeros(4))
    assert "test.raises" not in roofline.snapshot()

    def bad_cost(out, x):
        raise ZeroDivisionError

    fine = roofline.track_roofline("test.badcost", lambda x: x + 1, bad_cost)
    assert int(fine(torch.zeros(4)).sum()) == 4
    (rec,) = roofline.snapshot()["test.badcost"]
    assert rec["cost"] == "unavailable"
    assert "utilization_of_peak" not in rec


def test_roofline_bounds_its_records(registry, monkeypatch):
    monkeypatch.setattr(roofline, "MAX_SHAPES", 2)
    toy = roofline.track_roofline("test.shapes", lambda x: x,
                                  lambda out, x: (x.numel(), 0))
    for n in (1, 2, 3, 4):
        toy(torch.zeros(n))
    assert [r["shapes"] for r in roofline.snapshot()["test.shapes"]] == [
        "float32[1]", "float32[2]"]


def test_roofline_peak_table_has_no_tpu_row():
    assert set(roofline.PEAKS) == {"h100", "cpu"}
    assert roofline.peak_for("cpu", "x86_64")["match"] == "cpu"
    assert roofline.peak_for("tpu", "TPU v5e") is None
    assert roofline.peak_for("cuda", "NVIDIA A100") is None


def test_roofline_records_carry_the_multiply_variant(registry):
    """A kernel's records are keyed by the variant of the multiply
    lowering in force (``fp_ops_mxu1``), as its launches are."""
    tracked = roofline.track_roofline("fp_ops", lambda x: x,
                                      lambda out, x: (x.numel(), 0))
    prev = bi.mxu_mode()
    try:
        tracked(torch.zeros(2))
        bi.set_mxu_mode(1)
        tracked(torch.zeros(2))
    finally:
        bi.set_mxu_mode(prev)
    assert [r["variant"] for r in roofline.snapshot()["fp_ops"]] == [
        "fp_ops", "fp_ops_mxu1"]


# -- the build accounting -------------------------------------------------------


def test_build_accounting_on_a_fake_build_dir(tmp_path, monkeypatch):
    """A library nvcc had to build is a miss with its seconds and ptxas
    report; the same library found in ``_build/`` a hit; a library
    bound once counts once."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    fake = kernels.CudaKernel("fake", "hash64.cu", "lh_hash64", [])
    report = ("ptxas info    : Compiling entry function '_Z4fakev' for "
              "'sm_90a'\nptxas info    : Function properties for _Z4fakev"
              "\n    16 bytes stack frame, 0 bytes spill stores, 0 bytes "
              "spill loads\nptxas info    : Used 38 registers")

    def compile_cmd(out):
        return [sys.executable, "-c",
                f"print({report!r}); open({str(out)!r}, 'w').write('x')"]

    monkeypatch.setattr(fake, "_compile_cmd", compile_cmd)
    monkeypatch.setattr(fake, "_bind", lambda path: setattr(fake, "_fn", 1))
    before = cuda_accounting.snapshot()
    kernels.build_all([fake])
    mid = cuda_accounting.snapshot()
    assert mid["cache_misses"] - before["cache_misses"] == 1
    assert mid["builds"] - before["builds"] == 1
    assert mid["build_seconds"] > before["build_seconds"]
    assert mid["cache_hits"] == before["cache_hits"]
    (entry,) = mid["libraries"]["hash64.cu"]["entries"]
    assert entry == {"entry": "_Z4fakev", "stack": 16, "spill_stores": 0,
                     "spill_loads": 0, "registers": 38}
    fake._fn = None
    kernels.build_all([fake])
    after = cuda_accounting.snapshot()
    assert after["cache_hits"] - mid["cache_hits"] == 1
    assert after["cache_misses"] == mid["cache_misses"]
    assert after["libraries_loaded"] == mid["libraries_loaded"]
    assert mid["libraries_loaded"] >= 1


def test_host_readback_and_transfers_are_accounted():
    before = cuda_accounting.snapshot()
    t = torch.arange(10, dtype=torch.int64)
    assert torch.equal(cuda_accounting.host_readback(t), t)
    cuda_accounting.account_transfer(100, "h2d")
    after = cuda_accounting.snapshot()
    assert after["d2h_bytes"] - before["d2h_bytes"] == 80
    assert after["h2d_bytes"] - before["h2d_bytes"] == 100


# -- one count per kernel: the declared costs at the smoke's shapes --------------


def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _smoke_bytes(args, got):
    """The bytes the smoke's BLS checks bounded by: every tensor among the
    arguments and the outputs."""
    got = got if isinstance(got, tuple) else (got,)
    return sum(t.numel() * t.element_size() for t in (*args, *got)
               if isinstance(t, torch.Tensor))


_RNG = np.random.default_rng(12)
L, M = 10240, 128
MUL = cost.FP_MUL_INT_OPS
H64 = sh.HASH64_INT_OPS


def _one(shape, value):
    return torch.from_numpy(np.broadcast_to(value, shape).copy())


def _bits(n):
    return torch.from_numpy(_RNG.integers(0, 2, (n, 64), dtype=np.int32))


def _z(n, degree):
    shape = (n,) if degree == 1 else (n, 2)
    vals = [int(v) for v in _RNG.integers(1, 2**62, n * degree)]
    return torch.from_numpy(k.fp_encode(vals).reshape(shape + (bi.NLIMBS,)))


def _segment_layout():
    """The 10k batch's layout: 10,000 sets over 127 messages, grouped,
    on 10,240 lanes; 128 group ends (the last a padding group)."""
    sizes = np.bincount(np.arange(10000) % 127)
    starts = np.zeros(L, np.int32)
    ends = np.zeros(M, np.int32)
    lane = 0
    for g, n in enumerate(sizes):
        starts[lane] = 1
        lane += n
        ends[g] = lane - 1
    starts[lane:] = 1
    return starts, ends


def _cases():
    """(label, tracked wrapper, out, args, kwargs, (bytes, ops) the smoke
    used)."""
    rows = np.unique(_RNG.integers(0, 1 << 20, 1024)).astype(np.int32)
    parents = sum(len(np.unique(rows.astype(np.int64) >> (lvl + 1)))
                  for lvl in range(20)) + 40 - 20
    mask = np.ones(M + 1, bool)
    mask[M - 1] = False
    wide_mask = np.zeros(L + 1, bool)
    wide_mask[:127] = wide_mask[-1] = True
    starts, ends = _segment_layout()
    one1, one2 = _one((L, bi.NLIMBS), k.FP_ONE), _one((L, 2, bi.NLIMBS),
                                                      k.FP2_ONE)
    bits1, bits2 = _bits(L), _bits(L)
    q_z, g_z = _z(M + 1, 2), _z(M, 1)
    fs = _meta(M + 1, 2, 3, 2, bi.NLIMBS)
    f12 = _meta(1024, 2, 3, 2, bi.NLIMBS)
    pts1 = tuple(_meta(L, bi.NLIMBS) for _ in range(2))
    pts2 = tuple(_meta(L, 2, bi.NLIMBS) for _ in range(2))
    out1 = tuple(_meta(L, bi.NLIMBS) for _ in range(3))
    out2 = tuple(_meta(L, 2, bi.NLIMBS) for _ in range(3))
    ok = torch.ones(L, dtype=torch.bool)
    pairs = (_meta(M + 1, bi.NLIMBS), _meta(M + 1, bi.NLIMBS),
             _meta(M + 1, 2, bi.NLIMBS), _meta(M + 1, 2, bi.NLIMBS))
    wide = tuple(_meta(L + 1, *p.shape[1:]) for p in pairs)
    fp12_out = _meta(2, 3, 2, bi.NLIMBS)
    mask_t = torch.from_numpy(mask.astype(np.int32))
    wide_t = torch.from_numpy(wide_mask.astype(np.int32))
    seg_out = tuple(_meta(M, bi.NLIMBS) for _ in range(3))
    q = (_meta(M + 1, 2, bi.NLIMBS), _meta(M + 1, 2, bi.NLIMBS), q_z)
    g = (_meta(M, bi.NLIMBS), _meta(M, bi.NLIMBS), g_z)
    q_out, g_out = (q[0], q[1]), (g[0], g[1])
    dec_in = (_meta(L, 2, bi.NLIMBS), _meta(L, dtype=torch.int32))
    dec_out = (_meta(L, 2, bi.NLIMBS), _meta(L, dtype=torch.bool))
    sub_in = pts2 + (one2,)
    u = (_meta(M, 2, bi.NLIMBS), _meta(M, 2, bi.NLIMBS))
    h2g_out = tuple(_meta(M, 2, bi.NLIMBS) for _ in range(3))
    ints = _meta(4 * L, bi.NLIMBS)
    sig_x = _meta(L, 2, bi.NLIMBS)
    g2_in = out2
    g2_out = tuple(_meta(2, bi.NLIMBS) for _ in range(3))
    final = (fp12_out, _meta(1))
    least_q, least_g = cost.affine_least(q_z, 2), cost.affine_least(g_z, 1)
    return [
        # phase 2: the state-root kernels (literal counts)
        ("hash64", sh.hash64, _meta(1 << 20, 8), (_meta(1 << 20, 16),), {},
         (100663296, 1744830464)),
        ("fold_pre build<3>", mt.fold_pre, None,
         (_meta(8_000_000, 8), _meta(1_000_000, 16), 3, 1_000_000,
          _meta(1 << 20, 8)), {}, (353554432, 13312000000)),
        ("fold_pre scatter<3>", mt.fold_pre, None,
         (_meta(8192, 8), _meta(1024, 16), 3, 1_000_000, _meta(1 << 20, 8)),
         {"rows": _meta(1024)}, (364544, 13631488)),
        ("fold_pre build<0>", mt.fold_pre, None,
         (_meta(250_000, 8), None, 0, 250_000, _meta(1 << 18, 8)), {},
         (16388608, 0)),
        ("fold_pre scatter<0>", mt.fold_pre, None,
         (_meta(1024, 8), None, 0, 250_000, _meta(1 << 18, 8)),
         {"rows": _meta(1024)}, (69632, 0)),
        ("path_update", mt._path_walk, _meta(8),
         ([_meta(1 << (20 - lvl), 8) for lvl in range(21)],
          torch.from_numpy(rows), 40), {},
         (parents * (64 + 32) + 4 * len(rows) + 32, parents * H64)),
        ("cap_fold", sh.cap_root, _meta(8), (_meta(8), 20, 40), {},
         (704, 33280)),
        ("sha256_messages", sh.sha256_messages, _meta(1 << 20, 8),
         (_meta(1 << 20, 4, 16),), {}, (301989888, 4294967296)),
        # phase 4: the BLS kernels at the 10k batch's shapes (the smoke's
        # counts: the tensors in and out; field multiplies x 576)
        ("fp_ops entry", bi.fp_ops_kernel, _meta(4 * L, bi.NLIMBS),
         (bi.FP_TO_MONT, ints), {}, (10485760, 4 * L * MUL)),
        ("fp_ops mul", bi.fp_ops_kernel, sig_x, (bi.FP_MUL, sig_x, sig_x), {},
         (7864320, 2 * L * MUL)),
        ("fp_ops add", bi.fp_ops_kernel, sig_x, (bi.FP_ADD, sig_x, sig_x), {},
         (7864320, 0)),
        ("fp_ops wide", bi.fp_ops_kernel, _meta(L, bi.NLIMBS),
         (bi.FP_WIDE, _meta(L, 2 * bi.NLIMBS)), {}, (3932160, 2 * L * MUL)),
        ("g2_intake decompress", k.g2_decompress_batch, dec_out, dec_in, {},
         (_smoke_bytes(dec_in, dec_out), cost.g2_decompress(L) * MUL)),
        ("g2_intake subgroup", k.g2_in_subgroup_batch, ok, sub_in, {},
         (_smoke_bytes(sub_in, ok), cost.g2_subgroup_lanes(
             np.ones(L, bool), np.zeros(L, bool),
             ok.numpy())["products"] * MUL)),
        ("hash_to_g2", k.hash_to_g2_batch_from_u, h2g_out, u, {},
         (163840, cost.hash_to_g2(M) * MUL)),
        ("rlc_scale G1", k._scalar_mul, out1, (k.FP,) + pts1 + (one1, bits1),
         {}, (_smoke_bytes(pts1 + (one1, bits1), out1),
              cost.scalar_mul_lanes(bits1.numpy(), 1)["products"] * MUL)),
        ("rlc_scale G2", k._scalar_mul, out2, (k.FP2,) + pts2 + (one2, bits2),
         {}, (_smoke_bytes(pts2 + (one2, bits2), out2),
              cost.scalar_mul_lanes(bits2.numpy(), 2)["products"] * MUL)),
        ("g1_segment_sum", k.g1_segment_sum, seg_out,
         out1 + (starts, ends), {},
         (_smoke_bytes(out1, seg_out),
          cost.g1_segment_sum(starts, ends) * MUL)),
        ("g2_sum", k.g2_sum, g2_out, g2_in, {},
         (7865088, (L - 1) * cost.ADD[2] * MUL)),
        ("affine Fp2", k._affine, q_out, (k.FP2,) + q, {},
         (_smoke_bytes(q, q_out), least_q[0] * MUL + least_q[1])),
        ("affine Fp", k._affine, g_out, (k.FP,) + g, {},
         (_smoke_bytes(g, g_out), least_g[0] * MUL + least_g[1])),
        ("miller_loop", k.miller_loop_batch, fs, pairs + (mask_t,), {},
         (_smoke_bytes(pairs + (mask_t,), fs),
          cost.miller_loop(mask) * MUL)),
        ("miller_loop wide, 128 live", k.miller_loop_batch,
         _meta(L + 1, 2, 3, 2, bi.NLIMBS), wide + (wide_t,), {},
         (_smoke_bytes(wide + (wide_t,), _meta(L + 1, 2, 3, 2, bi.NLIMBS)),
          cost.miller_loop(wide_mask) * MUL)),
        ("final_exp", k._final_exp_kernel, final, (1, fs), {},
         (_smoke_bytes((fs,), final), cost.final_exp(M + 1, 1) * MUL)),
        ("final_exp product", k._final_exp_kernel, final, (0, fs), {},
         (_smoke_bytes((fs,), fp12_out), cost.final_exp(M + 1, 0) * MUL)),
        # phase 6: the caller-less power
        ("fp12_pow", k.fp12_pow_const, f12, (f12, k._X_ABS), {},
         (2 * f12.numel() * 4, cost.fp12_pow(1024, k._X_ABS) * MUL)),
    ]


_CASES = _cases()


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_declared_cost_equals_the_smokes_count(case):
    _, wrapper, out, args, kwargs, want = case
    assert isinstance(wrapper, roofline.Tracked)
    if out is None:                       # fold_pre returns its ``out``
        out = args[4]
    assert tuple(wrapper.cost(out, *args, **kwargs)[:2]) == want


def test_every_kernel_launch_site_is_tracked():
    """The 15 kernels' wrappers (the 16 launch sites: ``g2_intake`` has
    two) carry their kernel's name, and nothing else launches."""
    sites = {sh.hash64: "hash64", sh.sha256_messages: "sha256_messages",
             sh.cap_root: "cap_fold", mt.fold_pre: "fold_pre",
             mt._path_walk: "path_update", bi.fp_ops_kernel: "fp_ops",
             k.g2_decompress_batch: "g2_intake",
             k.g2_in_subgroup_batch: "g2_intake",
             k.hash_to_g2_batch_from_u: "hash_to_g2",
             k._scalar_mul: "rlc_scale", k.g1_segment_sum: "g1_segment_sum",
             k.g2_sum: "g2_sum", k._affine: "affine",
             k.miller_loop_batch: "miller_loop",
             k._final_exp_kernel: "final_exp", k.fp12_pow_const: "fp12_pow"}
    assert {w.name for w in sites} == set(kernels.KERNELS)
    for wrapper, name in sites.items():
        assert isinstance(wrapper, roofline.Tracked) and wrapper.name == name
    port = Path(kernels.__file__).parent
    launching = sorted(
        str(p.relative_to(port)) for p in (port / "ops").glob("*.py")
        if re.search(r"\b[A-Z0-9_]+\.launch\(", p.read_text()))
    assert launching == ["ops/bigint.py", "ops/bls12_381.py",
                         "ops/merkle_tree.py", "ops/sha256.py"]


class _Mesh:
    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_program_costs_equal_the_entry_counts(n):
    """Each sharded program's declared cost on one rank's share equals
    the work the sharded run bounded it by before (a rank's subtree and
    the top tree; its Miller loops and their product; its lanes' scalar
    products; the other ranks' share over the links)."""
    from lighthouse_tpu_torch.parallel import bls as pb
    from lighthouse_tpu_torch.parallel import merkle as pmk
    mesh, fp12 = _Mesh(n), 2 * 3 * 2 * 32 * 4
    local = (1 << 23) // n
    got = pmk._subtree_then_top.cost(None, mesh, _meta(local, 8),
                                     local.bit_length() - 1,
                                     (n - 1).bit_length())
    assert got == (local * 32 + 32, ((local - 1) + (n - 1)) * H64,
                   {"link_bytes": (n - 1) * 32})
    n_local = (M + 1 + (-(M + 1)) % n + 1) // n
    pairs = (_meta(n_local, bi.NLIMBS), _meta(n_local, bi.NLIMBS),
             _meta(n_local, 2, bi.NLIMBS), _meta(n_local, 2, bi.NLIMBS))
    live = np.ones(n_local, bool)
    live[-1] = False
    muls = cost.miller_loop(live) + cost.final_exp(n_local, 0)
    got = pb._local_masked_product.cost(
        None, mesh, *pairs, torch.from_numpy(live.astype(np.int32)))
    assert got[:2] == (sum(t.numel() * 4 for t in pairs) + 4 * n_local
                       + n * fp12, muls * MUL)
    assert got[2]["link_bytes"] == (n - 1) * fp12
    muls = cost.miller_loop(np.ones(n_local, bool)) + cost.final_exp(
        n_local, 0)
    assert pb._local_miller_product.cost(None, mesh, *pairs)[:2] == (
        sum(t.numel() * 4 for t in pairs) + n * fp12, muls * MUL)
    for degree in (1, 2):
        lanes = L // n
        shape = (lanes,) + ((bi.NLIMBS,) if degree == 1 else (2, bi.NLIMBS))
        xy = (_meta(*shape), _meta(*shape))
        z = _one(shape, k.FP_ONE if degree == 1 else k.FP2_ONE)
        bits = _bits(lanes)
        out = tuple(_meta(L, *shape[1:]) for _ in range(3))
        out_bytes = 3 * L * 128 * degree
        program = pb._SCALAR_MUL_PROGRAMS[degree]
        assert program.name == f"bls.g{degree}_scalar_mul"
        got = program.cost(out, mesh, *xy, z, bits, "label")
        assert got[:2] == (
            sum(t.numel() * 4 for t in (*xy, z, bits)) + out_bytes,
            cost.scalar_mul_lanes(bits.numpy(), degree)["products"] * MUL)
        assert got[2]["link_bytes"] == out_bytes * (n - 1) // n
