"""graftlint over the port: the tier-1 gate of ``lighthouse_tpu_torch/``.

The port's copy of ``test_static_analysis.py``, with its imports switched
to the port's engine (``lighthouse_tpu_torch.analysis``), its scan over
``lighthouse_tpu_torch/`` against the port's own baseline, and its CLI
``python -m lighthouse_tpu_torch.tools.lint``. Layers:

1. the full suite over ``lighthouse_tpu_torch/`` reports zero
   non-baselined violations (and no stale baseline entries),
2. every rule fires on exactly the ``# seeded`` lines of its fixture and
   stays silent on the true negatives in the same file: the ten host
   rules on the JAX package's ``tests/lint_fixtures/`` (read in place),
   the four device rules on the port's ``analysis/fixtures/``,
3. the CLI keeps its exit-code contract, and the findings fixed in the
   port stay fixed,
4. on each of the ten shared fixtures the JAX package's engine and the
   port's give the same findings.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

from lighthouse_tpu_torch.analysis import (  # noqa: E402
    Project, all_rules, load_baseline, run_project,
)

HOST_FIXTURES = Path(__file__).parent / "lint_fixtures"
PORT_FIXTURES = REPO / "lighthouse_tpu_torch" / "analysis" / "fixtures"
PACKAGE = REPO / "lighthouse_tpu_torch"
BASELINE = PACKAGE / "analysis" / "baseline.json"

#: the ten host rules, copied from the JAX package with their logic
HOST_RULES = {
    "lock-discipline": "lock_discipline_fix.py",
    "thread-lifecycle": "thread_lifecycle_fix.py",
    "spec-constant-drift": "spec_constant_drift_fix.py",
    "ssz-schema": "ssz_schema_fix.py",
    "lock-order": "lock_order_fix.py",
    "shutdown-order": "shutdown_order_fix.py",
    "cow-discipline": "cow_discipline_fix.py",
    "data-race": "data_race_fix.py",
    "store-atomicity": "store_atomicity_fix.py",
    "serving-cache-discipline": "serving_cache_discipline_fix.py",
}
#: the four rules that read the port's device idiom
DEVICE_RULES = {
    "trace-safety": "trace_safety_fix.py",
    "recompile-hazard": "recompile_hazard_fix.py",
    "device-transfer": "device_transfer_fix.py",
    "compile-budget": "compile_budget_fix.py",
}
RULE_FIXTURE = {**{r: HOST_FIXTURES / f for r, f in HOST_RULES.items()},
                **{r: PORT_FIXTURES / f for r, f in DEVICE_RULES.items()}}


def _seeded_lines(path: Path) -> list[int]:
    return sorted(i for i, line in
                  enumerate(path.read_text().splitlines(), 1)
                  if "# seeded" in line)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One cold full-tree run of every rule against the port's baseline,
    filling a cache the warm-run gate and the CLI cases reuse."""
    cache = tmp_path_factory.mktemp("graftlint") / "lint.cache"
    project = Project.load(REPO, [PACKAGE])
    report = run_project(project, baseline=load_baseline(BASELINE),
                         cache_path=cache)
    return {"project": project, "report": report, "cache": cache}


def test_registry_has_all_rules():
    assert set(RULE_FIXTURE) <= set(all_rules())
    assert len(all_rules()) >= 14


@pytest.mark.parametrize("rule_name", sorted(RULE_FIXTURE))
def test_rule_fires_exactly_on_seeded_lines(rule_name):
    fixture = RULE_FIXTURE[rule_name]
    project = Project.load(REPO, [fixture])
    rules = {rule_name: all_rules()[rule_name]}
    report = run_project(project, rules)
    got = sorted(v.line for v in report["violations"])
    want = _seeded_lines(fixture)
    assert want, f"fixture {fixture.name} has no seeded markers"
    assert got == want, "\n".join(v.render()
                                  for v in report["violations"])


def test_port_tree_is_clean_under_all_rules(tree):
    report = tree["report"]
    assert not report["violations"], \
        "\n".join(v.render() for v in report["violations"])
    assert not report["stale_baseline"], report["stale_baseline"]
    assert len(report["rules"]) >= 14
    assert report["elapsed_s"] < 30


def test_package_scan_skips_the_fixtures(tree):
    """The seeded fixtures live in the package but are read only when
    named: the package scan leaves them out, naming their directory
    takes them in."""
    scanned = {m.relpath for m in tree["project"].modules}
    assert not any("/analysis/fixtures/" in rel for rel in scanned)
    assert any(rel.endswith("analysis/locksan.py") for rel in scanned)
    named = Project.load(REPO, [PORT_FIXTURES])
    assert {Path(m.relpath).name for m in named.modules} >= \
        set(DEVICE_RULES.values())


def test_full_tree_lint_stays_fast(tree):
    """The CI wall-time gate: a cache-warm full-tree run of all the rules
    must finish in ≤5 s — the content-hash cache (not luck) is what keeps
    this true as the tree grows."""
    report = run_project(tree["project"], cache_path=tree["cache"])
    assert report["cached_files"] == report["files"]
    assert report["elapsed_s"] <= 5, report["elapsed_s"]


def test_baseline_entries_are_reviewed():
    # every baseline entry must carry a non-empty justification and
    # still match a live finding (enforced as stale otherwise)
    entries = load_baseline(BASELINE)
    assert entries
    for entry in entries:
        assert entry["justification"].strip()
        assert entry["path"].split("/")[1] == "lighthouse_tpu_torch"


def test_baseline_is_the_ports_own(tree):
    """Every waiver names a file of the port and matches a live finding
    of this scan."""
    waived = {(v.rule, v.path, v.symbol) for v in tree["report"]["baselined"]}
    for entry in load_baseline(BASELINE):
        assert (entry["rule"], entry["path"], entry["symbol"]) in waived


def test_baseline_rejects_unjustified_entries(tmp_path):
    bad = tmp_path / "baseline.json"
    bad.write_text(json.dumps(
        [{"rule": "lock-discipline", "path": "x.py"}]))
    with pytest.raises(ValueError, match="justification"):
        load_baseline(bad)


def test_stale_baseline_entries_are_reported():
    project = Project.load(REPO, [HOST_FIXTURES / "lock_discipline_fix.py"])
    stale = {"rule": "lock-discipline", "path": "no/such/file.py",
             "justification": "left over after a refactor"}
    report = run_project(
        project, {"lock-discipline": all_rules()["lock-discipline"]},
        [stale])
    assert report["stale_baseline"] == [stale]


# -- CLI contract ------------------------------------------------------------

def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "lighthouse_tpu_torch.tools.lint", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120)


def test_cli_json_is_clean_and_exits_zero(tree):
    out = _run_cli("--format", "json", "--cache", str(tree["cache"]))
    assert out.returncode == 0, out.stdout + out.stderr
    data = json.loads(out.stdout)
    assert data["violations"] == []
    assert len(data["rules"]) >= 14
    assert data["files"] == tree["report"]["files"]


def test_cli_sarif_output():
    out = _run_cli("--format", "sarif", "--no-cache",
                   str(HOST_FIXTURES / "shutdown_order_fix.py"))
    assert out.returncode == 1, out.stdout + out.stderr
    doc = json.loads(out.stdout)
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "graftlint"
    results = run["results"]
    live = [r for r in results if "suppressions" not in r]
    assert live, results
    assert all(r["ruleId"] for r in results)
    loc = live[0]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith(
        "shutdown_order_fix.py")
    assert loc["region"]["startLine"] > 0


def test_cli_changed_filters_to_touched_files(tree):
    # vs HEAD with a pristine port tree nothing is reported; the
    # analysis still covers the full tree (rules list is complete)
    out = _run_cli("--changed", "HEAD", "--format", "json", "--cache",
                   str(tree["cache"]))
    assert out.returncode in (0, 1), out.stdout + out.stderr
    data = json.loads(out.stdout)
    assert len(data["rules"]) >= 14
    head_clean = subprocess.run(
        ["git", "diff", "--quiet", "HEAD", "--", "lighthouse_tpu_torch"],
        cwd=REPO).returncode == 0
    if head_clean:
        assert data["violations"] == []


def test_cli_rejects_bad_changed_ref():
    out = _run_cli("--changed", "no-such-ref-xyz")
    assert out.returncode == 2


def test_cli_exits_nonzero_on_findings():
    out = _run_cli("--rules", "thread-lifecycle", "--no-cache",
                   str(HOST_FIXTURES / "thread_lifecycle_fix.py"))
    assert out.returncode == 1, out.stdout + out.stderr
    dev = _run_cli("--rules", "device-transfer", "--no-cache",
                   str(PORT_FIXTURES / "device_transfer_fix.py"))
    assert dev.returncode == 1, dev.stdout + dev.stderr


def test_cli_rejects_unknown_rule():
    out = _run_cli("--rules", "no-such-rule")
    assert out.returncode == 2


# -- regression pins for the violations fixed in the port --------------------

def test_kzg_bytes_per_field_element_is_the_spec_constant():
    from lighthouse_tpu_torch.crypto import kzg
    from lighthouse_tpu_torch.specs import constants
    assert kzg.BYTES_PER_FIELD_ELEMENT == constants.BYTES_PER_FIELD_ELEMENT


def test_container_sizes_derive_from_spec_constants():
    from lighthouse_tpu_torch.containers import get_types
    from lighthouse_tpu_torch.specs import constants
    from lighthouse_tpu_torch.specs.presets import MINIMAL_PRESET as P
    T = get_types(P)
    agg = T.SyncCommitteeContribution.__ssz_fields__["aggregation_bits"]
    assert agg.length == \
        P.sync_committee_size // constants.SYNC_COMMITTEE_SUBNET_COUNT
    assert T.Blob.length == \
        constants.BYTES_PER_FIELD_ELEMENT * P.field_elements_per_blob


@pytest.mark.parametrize("rule_name,files", [
    ("spec-constant-drift", ("containers/core.py", "crypto/kzg.py",
                             "state_transition/block.py", "seeded_state.py",
                             "ops/bls_consts.py")),
    ("device-transfer", ("parallel/bls.py", "parallel/mesh.py",
                         "parallel/merkle.py")),
    ("trace-safety", ("ops/bls12_381.py", "ops/sha256.py",
                      "ops/merkle_tree.py", "ops/bigint.py")),
])
def test_fixed_modules_stay_clean(rule_name, files):
    # the files whose findings were fixed in the port (the drift
    # literals, the unaccounted readbacks of parallel/bls.py's costs and
    # of g1_segment_sum's range check): a reintroduced one fails here.
    # The two false positives in them stay waived by the baseline
    # (ops/bls_consts.py's 64-bit mask, g1_segment_sum's host branch)
    project = Project.load(REPO, [PACKAGE / p for p in files])
    report = run_project(project, {rule_name: all_rules()[rule_name]},
                         baseline=load_baseline(BASELINE))
    assert not report["violations"], \
        "\n".join(v.render() for v in report["violations"])


def test_seeded_state_far_epoch_is_the_spec_constant():
    from lighthouse_tpu_torch.seeded_state import seeded_columns
    from lighthouse_tpu_torch.specs.constants import FAR_FUTURE_EPOCH
    cols = seeded_columns(3)
    assert (cols["exit_epoch"] == FAR_FUTURE_EPOCH).all()
    assert (cols["withdrawable_epoch"] == FAR_FUTURE_EPOCH).all()


# -- one engine, two packages -------------------------------------------------

@pytest.mark.parametrize("rule_name", sorted(HOST_RULES))
def test_host_rule_matches_the_jax_engine(rule_name):
    """The port's copy of each host rule gives the JAX package's findings
    on the shared fixture: the same (rule, line, symbol) set."""
    from lighthouse_tpu import analysis as jax_analysis
    fixture = HOST_FIXTURES / HOST_RULES[rule_name]
    found = []
    for pkg in (jax_analysis,
                sys.modules["lighthouse_tpu_torch.analysis"]):
        report = pkg.run_project(pkg.Project.load(REPO, [fixture]),
                                 {rule_name: pkg.all_rules()[rule_name]})
        found.append(sorted((v.rule, v.line, v.symbol)
                            for v in report["violations"]))
    assert found[0] == found[1]
    assert [line for _r, line, _s in found[1]] == _seeded_lines(fixture)
