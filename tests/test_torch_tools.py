"""The port's tools (``lighthouse_tpu_torch/tools/``), run as
``python -m lighthouse_tpu_torch.tools.<name>`` or in process, on the CPU.

Copies of the JAX package's tool tests with their commands switched to
the port's modules: ``obs_diff`` and ``trace_report`` on
``tests/trace_fixtures/`` (read in place; ``test_graftpath.py`` and
``test_tracing.py``), ``store_fsck`` on a database the port's chain
wrote (``test_crash_recovery.py``), ``obs_doctor`` on the graftwatch
fixtures. Then the three tools that measure: ``perf_model``'s products a
stage against the JAX tool's in PERF_MODEL.md §1, ``gil_throughput`` on
``cpp`` against the JAX tool at the same size, and ``bls_10k_correctness``
on the plain versions, both polarities, writing no file.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from lighthouse_tpu_torch import obs
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.obs import doctor

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "trace_fixtures"
WATCH_FIXTURES = Path(__file__).parent / "graftwatch_fixtures"


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _run_tool(name, *argv, env=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", f"lighthouse_tpu_torch.tools.{name}",
         *map(str, argv)], cwd=REPO, capture_output=True, text=True,
        timeout=timeout, env=None if env is None else {**os.environ, **env})


# -- obs_diff: the differential profiler --------------------------------------

def test_diff_tool_blames_the_stage_that_moved():
    out = _run_tool("obs_diff", "--json", FIXTURES / "trace_old.json",
                    FIXTURES / "trace_new.json")
    assert out.returncode == 0, out.stderr
    diff = json.loads(out.stdout)
    # +25 ms of state_transition surfaces in the stage totals AND as the
    # top critical-path move (its parents inflate the stage total sum)
    assert diff["total_delta_ms"] == 75.0
    by_stage = {s["stage"]: s["delta_total_ms"] for s in diff["stages"]}
    assert by_stage["state_transition"] == 25.0
    cp = diff["critical_path"]
    assert (cp["old_total_ms"], cp["new_total_ms"]) == (100.0, 125.0)
    assert cp["moved"][0]["stage"] == "state_transition"
    assert cp["moved"][0]["delta_self_ms"] == 25.0

    table = _run_tool("obs_diff", FIXTURES / "trace_old.json",
                      FIXTURES / "trace_new.json")
    assert table.returncode == 0, table.stderr
    assert "critical path: 100.000 ms -> 125.000 ms (+25.000 ms)" \
        in table.stdout
    assert "state_transition: self 30.000 -> 55.000 ms (+25.000)" \
        in table.stdout


def test_diff_tool_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    out = _run_tool("obs_diff", bad, FIXTURES / "trace_new.json")
    assert out.returncode == 2


# -- trace_report -------------------------------------------------------------

def test_trace_report_critpath_flag():
    out = _run_tool("trace_report", "--critpath", FIXTURES / "trace_new.json")
    assert out.returncode == 0, out.stderr
    first = out.stdout.splitlines()[0]
    assert first == "slowest block trace: 125.000 ms " \
                    "ending in block_pipeline on n1"
    assert "cross-node hops: 1 (propagation)" in out.stdout
    as_json = _run_tool("trace_report", "--critpath", "--json",
                        FIXTURES / "trace_new.json")
    rep = json.loads(as_json.stdout)
    assert rep["nodes"] == ["n0", "n1"]
    assert rep["block_roots"] == ["aa11"]


def test_trace_report_critpath_empty_capture_exits_2(tmp_path):
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"data": []}))
    out = _run_tool("trace_report", "--critpath", empty)
    assert out.returncode == 2
    assert "no spans in capture" in out.stderr


def test_trace_report_cli_renders_table(tmp_path):
    obs.clear()
    with obs.span("block_import"):
        with obs.span("state_root"):
            pass
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps(obs.chrome_trace()))
    out = _run_tool("trace_report", trace, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "block_import" in out.stdout and "state_root" in out.stdout
    assert "p95 ms" in out.stdout
    out_json = _run_tool("trace_report", "--json", trace, timeout=60)
    data = json.loads(out_json.stdout)
    assert data["block_import"]["count"] == 1


def test_trace_report_cli_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("not json")
    out = _run_tool("trace_report", bad, timeout=60)
    assert out.returncode == 2


# -- store_fsck -----------------------------------------------------------------

_CHILD = """
import os
from lighthouse_tpu_torch import device
device.set_device("cpu")
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.store import HotColdDB, NativeKvStore

bls.set_backend("fake")
spec = minimal_spec()
db = os.environ["LHTPU_TEST_DB"]
store = HotColdDB(NativeKvStore(os.path.join(db, "hot.db")),
                  NativeKvStore(os.path.join(db, "cold.db")), spec)
h = BeaconChainHarness(spec, 64, store=store)
h.extend_chain(2 * spec.preset.slots_per_epoch)
h.chain.persist()
print("COMPLETED", h.chain.head().head_block_root.hex())
"""


@pytest.fixture(scope="module")
def completed_db(tmp_path_factory):
    """A database the port's chain wrote and shut down cleanly, in a
    process of its own (as the JAX package's crash tests write theirs)."""
    db = tmp_path_factory.mktemp("completed")
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                          env={**os.environ, "LHTPU_TEST_DB": str(db)},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "COMPLETED" in proc.stdout
    return db


def test_fsck_cli_on_completed_db(completed_db):
    """The offline tool agrees with the in-process checker: a cleanly
    shut-down database exits 0 with parseable JSON."""
    proc = _run_tool("store_fsck", "--json", completed_db)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["clean"] is True
    assert report["checked"].get("blocks", 0) > 0
    text = _run_tool("store_fsck", completed_db)
    assert text.returncode == 0, text.stdout + text.stderr


def test_fsck_cli_rejects_missing_db(tmp_path):
    proc = _run_tool("store_fsck", tmp_path / "nope", timeout=60)
    assert proc.returncode == 2


# -- obs_doctor -----------------------------------------------------------------

def test_doctor_cli_renders_a_dump():
    path = WATCH_FIXTURES / "dump_v1.json"
    out = _run_tool("obs_doctor", path)
    assert out.returncode == 0, out.stderr
    want = doctor.render(doctor.diagnose(doctor.load(str(path))))
    assert out.stdout.strip() == want.strip()
    as_json = _run_tool("obs_doctor", "--json", path)
    assert as_json.returncode == 0, as_json.stderr
    assert [i["slo"] for i in json.loads(as_json.stdout)["incidents"]]


def test_doctor_cli_exit_codes(tmp_path):
    bad = tmp_path / "not.json"
    bad.write_text("{nope")
    assert _run_tool("obs_doctor", bad).returncode == 2
    future = tmp_path / "future.json"
    future.write_text(json.dumps({"format": "graftwatch-dump",
                                  "version": 10 ** 6}))
    assert _run_tool("obs_doctor", future).returncode == 3
    assert _run_tool("obs_doctor").returncode == 2     # no path, no probe


def test_doctor_cli_probe_reports_its_stages():
    out = _run_tool("obs_doctor", "--probe", "--json", "--probe-timeout",
                    "120", timeout=300)
    assert out.returncode == 0, out.stderr
    probe = json.loads(out.stdout)["default"]
    assert probe["stages"]["import"]["rc"] == 0
    assert probe["stage_reached"] in ("import", "devices")


# -- perf_model -----------------------------------------------------------------

#: PERF_MODEL.md §1's rows by the JAX tool's stage names
_MD_ROWS = {
    "G2 decompress": "decompress", "psi subgroup check": "subgroup",
    "hash-to-G2": "hash_to_g2", "msg jacobian": "affine_msg",
    "RLC G1 scalar mul": "rlc_g1", "RLC G2 scalar mul": "rlc_g2",
    "Miller loop": "miller_1pair", "final exponentiation": "final_exp",
    "**shared total**": "shared_total",
}


def _perf_model_md() -> dict:
    """The JAX tool's measured column products a stage for one set, read
    from PERF_MODEL.md §1 (the shared stages but the final exponentiation
    as one sum: the shared total less the final exponentiation)."""
    text = (REPO / "PERF_MODEL.md").read_text()
    section = text[text.index("## 1."):text.index("## 2.")]
    out = {}
    for line in section.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        for label, name in _MD_ROWS.items():
            if len(cells) > 1 and cells[0].startswith(label):
                out[name] = int(cells[1].strip("*").replace(",", ""))
    assert sorted(out) == sorted(_MD_ROWS.values()), out
    out["g2_sum+affine_misc+fp12_product"] = (out.pop("shared_total")
                                              - out["final_exp"])
    return out


_COLS = 3                                  # column products a product


def _zeros(k: int) -> int:
    """Unset bits of ``k`` after its top one."""
    return bin(k)[3:].count("0")


def test_perf_model_counts_each_stage_as_perf_model_md(monkeypatch):
    """The port's products a stage against the JAX tool's (PERF_MODEL.md
    §1). Where one constant exponent or scalar is shared by every lane,
    the port's plain version skips the product (or addition) on an unset
    bit that the JAX scan computes and discards: the run counts those
    skipped products (``skipped``), and the port's count plus them is the
    JAX tool's, exactly, in every stage but the four named below."""
    from lighthouse_tpu_torch.ops import bigint as bi
    from lighthouse_tpu_torch.ops import bls12_381 as k
    from lighthouse_tpu_torch.ops import bls_cost as cost
    from lighthouse_tpu_torch.tools import perf_model

    PERF_MODEL_MD = _perf_model_md()
    skipped = [0]

    def rows_of(fn, *args):
        """Rows one call of ``fn`` counts (the counter put back)."""
        rows, calls = bi.MONT_MUL_ROWS.rows, bi.MONT_MUL_ROWS.calls
        fn(*args)
        per = bi.MONT_MUL_ROWS.rows - rows
        bi.MONT_MUL_ROWS.rows, bi.MONT_MUL_ROWS.calls = rows, calls
        return per

    pow_const = k._pow_const

    def counted_pow(a, exponent, square, mul):
        skipped[0] += _zeros(exponent) * rows_of(mul, a, a)
        return pow_const(a, exponent, square, mul)

    def counted_smc(smc, add):
        def run(x, y, z, scalar):
            skipped[0] += bin(scalar)[2:].count("0") * rows_of(
                add, x, y, z, x, y, z)
            return smc(x, y, z, scalar)
        return run

    count = perf_model._count
    monkeypatch.setattr(k, "_pow_const", counted_pow)
    monkeypatch.setattr(k, "g1_scalar_mul_const",
                        counted_smc(k.g1_scalar_mul_const, k.g1_add))
    monkeypatch.setattr(k, "g2_scalar_mul_const",
                        counted_smc(k.g2_scalar_mul_const, k.g2_add))
    monkeypatch.setattr(perf_model, "_count", lambda: {
        **count(), "skipped": _COLS * skipped[0]})
    got = perf_model.measure()
    rows = got["per_stage"]
    assert list(rows) == perf_model.STAGES
    for name, row in rows.items():
        # a Montgomery product: 3 column products, 5,120 MACs in all
        assert row["int32_muls"] * _COLS == row["fp_muls"] * 5120, name
    for total, names in (("per_lane_total", perf_model.PER_LANE),
                         ("shared_total", perf_model.SHARED)):
        assert got[total]["fp_muls"] == sum(rows[n]["fp_muls"]
                                            for n in names)

    def jax_scans(names: str) -> int:
        """The port's count with the JAX scans' discarded products."""
        return sum(rows[n]["fp_muls"] + rows[n]["skipped"]
                   for n in names.split("+"))

    for name in ("decompress", "subgroup", "hash_to_g2", "affine_msg",
                 "rlc_g2"):
        assert jax_scans(name) == PERF_MODEL_MD[name], name
    # the JAX tool encodes the pubkey's two coordinates on the device
    # (fp_encode: a product by R^2 each); the port's fp_encode is host
    assert jax_scans("rlc_g1") + _COLS * 2 == PERF_MODEL_MD["rlc_g1"]
    # the JAX Miller scan computes the addition step (and its line) on
    # every bit of |x| after the top one and selects it on the set ones;
    # the port's plain loop takes it on the set bits alone
    assert jax_scans("miller_1pair") + _COLS * _zeros(abs(k.X_PARAM)) * (
        cost.MILLER_ADD + cost.ELL) == PERF_MODEL_MD["miller_1pair"]
    # the JAX product of one Fp12 value multiplies it into the identity
    # (its row scan starts from one); the port's returns it
    assert jax_scans("g2_sum+affine_misc+fp12_product") + \
        _COLS * cost.FP12_MUL == PERF_MODEL_MD[
            "g2_sum+affine_misc+fp12_product"]
    # another algorithm, so each side is held against a count of its own
    # structure. The port's hard part is the x-chain with Granger-Scott
    # cyclotomic squares (csrc/bls/pairing.cu's design, its plain version
    # the same): bls_cost's FINAL_EXP, but for the plain version's Fermat
    # inversion (the kernel's is binary) and fp6_inv's three Fp2 squares,
    # which the plain version computes as products in one batched call
    assert rows["final_exp"]["fp_muls"] == _COLS * (
        cost.FINAL_EXP - cost.FP12_INV_BINARY + cost.FP12_INV
        + 3 * (cost.FP2_MUL - cost.FP2_SQR))
    # the JAX one: the same easy part with its Fermat scan's discarded
    # products, a table of the 16 subset products of f's four Frobenius
    # powers (3 Frobenius maps, 11 products), then a scan over the base-p
    # digits' bits of (p^4 - p^2 + 1) / r, a square and a table product
    # each step
    from lighthouse_tpu.ops import bls12_381 as jax_k
    jax_inv = (cost.FP12_INV + 3 * (cost.FP2_MUL - cost.FP2_SQR)
               + _zeros(k.P_INT - 2))
    assert _COLS * (jax_inv + 2 * cost.FP12_MUL + cost.FP12_FROB
                    + 3 * cost.FP12_FROB + 11 * cost.FP12_MUL
                    + jax_k._HARD_NBITS * (cost.FP12_SQR + cost.FP12_MUL)
                    ) == PERF_MODEL_MD["final_exp"]


# -- gil_throughput -------------------------------------------------------------

GIL_SMALL = {"LHTPU_GIL_SLOTS": "4", "LHTPU_GIL_VALIDATORS": "64",
             "LHTPU_GIL_ATT_THREADS": "2", "LHTPU_GIL_BACKEND": "cpp"}


def test_gil_throughput_cpp_matches_the_jax_tool(monkeypatch, capsys):
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.tools import gil_throughput as gil
    for key, value in GIL_SMALL.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(gil, "N_SLOTS", 4)
    monkeypatch.setattr(gil, "N_VALIDATORS", 64)
    monkeypatch.setattr(gil, "ATT_THREADS", 2)
    try:
        assert gil.main() == 0
    finally:
        bls.set_backend("fake")
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    env = {**os.environ, **GIL_SMALL, "JAX_PLATFORMS": "cpu"}
    env.pop("LHTPU_GIL_OUT", None)
    jax = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "gil_throughput.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert jax.returncode == 0, jax.stdout + jax.stderr
    ref = json.loads(jax.stdout.strip().splitlines()[-1])
    assert port["real_errors"] == 0 and ref["real_errors"] == 0
    for key in ("backend", "n_slots", "n_validators", "att_threads",
                "atts_sent_once", "atts_verified", "expired_unsent"):
        assert port[key] == ref[key], key
    # every single verified: none expired or raced at this size
    assert port["atts_verified"] == port["atts_sent_once"] == 32
    assert port["blocks_per_sec"] > 0
    # the measured run's launches, every kernel's: none on the CPU, where
    # each wrapper runs its plain version
    from lighthouse_tpu_torch import kernels
    assert port["launches"] == {name: 0 for name in
                                kernels.launch_counts()}


# -- bls_10k_correctness ----------------------------------------------------------

@pytest.fixture
def writes(monkeypatch):
    """The paths this process opens for writing (``open`` and the
    ``io.open`` that ``pathlib`` calls), as the test runs."""
    import builtins
    import io
    real = io.open
    seen: list[Path] = []

    def recording(file, mode="r", *args, **kwargs):
        if isinstance(file, (str, os.PathLike)) and \
                any(c in mode for c in "wax+"):
            seen.append(Path(file).resolve())
        return real(file, mode, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", recording)
    monkeypatch.setattr(io, "open", recording)
    return seen


def _in_tree(paths) -> list:
    """Those of ``paths`` inside the checkout's tracked tree (its
    gitignored build directory aside)."""
    build = REPO / "lighthouse_tpu_torch" / "_build"
    return [p for p in paths
            if p.is_relative_to(REPO) and not p.is_relative_to(build)]


def test_bls_10k_correctness_both_polarities_writes_nothing(monkeypatch,
                                                         writes):
    """The protocol at 3 sets on the plain versions, lane options (4,
    128): the few sets run at the small shape, as a batch of few sets does
    on the card at (128, 10,240). Both polarities; no file written."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.tools import bls_10k_correctness as tenk
    monkeypatch.setenv("LHTPU_BLS_LANES", "128")
    monkeypatch.setenv("LHTPU_BLS_SMALL", "4")
    monkeypatch.delenv("LHTPU_10K_OUT", raising=False)
    monkeypatch.delenv("LHTPU_10K_SHARED", raising=False)
    monkeypatch.delenv("LHTPU_10K_FAST", raising=False)
    era = (REPO / "PERF_10K_CPU.json").read_bytes()
    try:
        rec = tenk.run(n=3)
    finally:
        bls.set_backend("fake")
    assert rec["verify_ok"] is True
    assert rec["reject_ok"] is True
    assert (rec["n_sigs"], rec["lanes"], rec["small_lanes"]) == (3, 128, 4)
    assert rec["platform"] == "cpu"
    assert _in_tree(writes) == []
    assert (REPO / "PERF_10K_CPU.json").read_bytes() == era


def test_bls_10k_correctness_writes_only_where_named(monkeypatch, capsys,
                                                     tmp_path, writes):
    from lighthouse_tpu_torch.tools import bls_10k_correctness as tenk
    rec = {"n_sigs": 1, "verify_ok": True, "reject_ok": True}
    monkeypatch.setattr(tenk, "run", lambda: rec)
    monkeypatch.delenv("LHTPU_10K_OUT", raising=False)
    assert tenk.main() == 0
    assert json.loads(capsys.readouterr().out) == rec
    assert writes == []
    out = tmp_path / "rec.json"
    monkeypatch.setenv("LHTPU_10K_OUT", str(out))
    assert tenk.main() == 0
    assert writes == [out.resolve()]
    assert json.loads(out.read_text()) == rec


def test_bls_10k_spoil_changes_only_the_middle_message():
    from lighthouse_tpu_torch.crypto.bls import SignatureSet
    from lighthouse_tpu_torch.tools import bls_10k_correctness as tenk
    sets = [SignatureSet(bytes([i]) * 96, [bytes([i]) * 48],
                         bytes([i]) * 32) for i in range(5)]
    bad = tenk.spoil_one(sets)
    assert [b is s for b, s in zip(bad, sets)] == [True, True, False,
                                                  True, True]
    assert bad[2].message == b"\xee" * 32
    assert (bad[2].signature, bad[2].pubkeys) == (sets[2].signature,
                                                  sets[2].pubkeys)
