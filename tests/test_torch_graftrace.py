"""graftrace over the port: shared-state model, data-race rule, and the
port's lock sanitizer.

The port's copy of ``test_graftrace.py``, its imports switched to
``lighthouse_tpu_torch.analysis``, its subsystem cases and arming plan
read over ``lighthouse_tpu_torch/``. Beyond the copy: the sanitizer's
frame gate names the port's package exactly (a lock a ``lighthouse_tpu``
module makes stays raw), and a threaded workload of the port runs clean
under the armed sanitizer in a process of its own.

Four layers:
1. the seeded fixture must produce the *right category* on each seeded
   line (exact-line matching is already covered by the shared
   test_rule_fires_exactly_on_seeded_lines gate),
2. spawn-site seeding: escapes through ``Thread(target=...)``,
   positional ``spawn``/``submit``, and ``add_listener`` must resolve
   through the call graph to the right entry methods — including
   nested closures, which run on the spawned thread while their
   enclosing method body does not,
3. the lockset lattice: inherited locksets for private helpers, flag
   publishes, sync-object attrs, init-only publication,
4. the runtime sanitizer: an injected race must trip it, a clean locked
   workload must not, and the repo arming plan must carry the claims
   the threaded subsystems depend on (obs/timeseries, api/serving/cache).
"""
import ast
import sys
import threading
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

from lighthouse_tpu_torch.analysis import (  # noqa: E402
    Project, all_rules, run_project,
)
from lighthouse_tpu_torch.analysis import locksan  # noqa: E402
from lighthouse_tpu_torch.analysis.callgraph import (  # noqa: E402
    CallGraph, build_facts,
)
from lighthouse_tpu_torch.analysis.sharedstate import (  # noqa: E402
    build_model, classify_attrs, scan_module,
)

FIXTURE = Path(__file__).parent / "lint_fixtures" / "data_race_fix.py"


def _run_rule(paths):
    project = Project.load(REPO, [Path(p) for p in paths])
    return run_project(project, {"data-race": all_rules()["data-race"]})


def _model(**modules):
    """Shared-state model over {relpath: source} keyword modules
    (dots in relpaths written as __)."""
    data, facts = {}, {}
    for rel, src in modules.items():
        rel = rel.replace("__", "/") + ".py"
        tree = ast.parse(src)
        s = scan_module(tree, rel)
        if s is not None:
            data[rel] = s
        facts[rel] = build_facts(tree, rel)
    return build_model(data, CallGraph(facts))


# -- fixture categories ------------------------------------------------------

def test_fixture_categories_match_seeded_annotations():
    want = {}
    for i, line in enumerate(FIXTURE.read_text().splitlines(), 1):
        if "# seeded" in line:
            want[i] = line.split("# seeded", 1)[1].strip()
    report = _run_rule([FIXTURE])
    got = {v.line: v.message for v in report["violations"]}
    assert sorted(got) == sorted(want)
    for line, category in want.items():
        assert f"[{category}]" in got[line], (line, got[line])


def test_fixture_true_negative_classes_stay_silent():
    report = _run_rule([FIXTURE])
    for v in report["violations"]:
        assert not any(cls in v.symbol for cls in
                       ("CleanService", "DoubleChecked",
                        "InitOnlyConfig")), v.render()


# -- spawn-site seeding through the call graph -------------------------------

_WORKER = """
import threading

class Service:
    def __init__(self):
        self.jobs = 0
    def start(self):
        threading.Thread(target=self._work, daemon=True).start()
    def _work(self):
        self._step()
    def _step(self):
        self.jobs += 1
"""


def test_thread_target_seeds_entry_closure():
    model = _model(svc=_WORKER)
    sc = model[("svc.py", "Service")]
    assert sc.spawn_seeded
    # _work is the spawn target; _step joins via the self-call closure
    assert sc.entry_methods == {"_work", "_step"}


def test_nested_closure_is_its_own_entry_not_the_enclosing_method():
    model = _model(m="""
import threading

class Pusher:
    def __init__(self):
        self.sent = 0
        self._t = None
    def start(self):
        def loop():
            self.sent += 1
        self._t = threading.Thread(target=loop, daemon=True)
        self._t.start()
""")
    sc = model[("m.py", "Pusher")]
    assert sc.entry_methods == {"start.loop"}
    # the enclosing method body runs on the CALLER thread: `_t` is
    # start-only, single-domain, and must not be treated as entry state
    assert "start" not in sc.entry_methods


def test_positional_spawn_resolves_cross_class():
    model = _model(m="""
import threading

class Group:
    def spawn(self, target):
        def run():
            target()
        threading.Thread(target=run, daemon=True).start()

class Svc:
    def __init__(self):
        self.grp = Group()
        self.jobs = 0
    def start(self):
        self.grp.spawn(self._work)
    def _work(self):
        self.jobs += 1
""")
    sc = model[("m.py", "Svc")]
    assert sc.spawn_seeded
    assert "_work" in sc.entry_methods


def test_add_listener_seeds_the_callback():
    model = _model(m="""
class Bus:
    def add_listener(self, kinds, fn):
        pass

class Tier:
    def __init__(self, bus):
        self.events = 0
        bus.add_listener(("head",), self._on_event)
    def _on_event(self, kind):
        self.events += 1
""")
    sc = model[("m.py", "Tier")]
    assert sc.spawn_seeded
    assert "_on_event" in sc.entry_methods


def test_lockless_single_domain_class_is_not_modeled():
    model = _model(m="""
class Plain:
    def __init__(self):
        self.x = 0
    def bump(self):
        self.x += 1
""")
    assert ("m.py", "Plain") not in model


# -- lockset lattice ---------------------------------------------------------

def test_private_helper_inherits_caller_locksets():
    model = _model(m="""
import threading

class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
    def bump(self):
        with self._lock:
            self._bump_locked()
    def drain(self):
        with self._lock:
            self._bump_locked()
    def _bump_locked(self):
        self.count += 1
""")
    sc = model[("m.py", "Engine")]
    assert sc.inherited["_bump_locked"] == frozenset({"_lock"})
    reports = classify_attrs(sc)
    assert reports["count"].status == "guarded"
    assert reports["count"].guard == ("_lock",)


def test_flag_publish_and_sync_attrs_are_exempt():
    model = _model(m="""
import threading

class Svc:
    def __init__(self):
        self._lock = threading.Lock()
        self._q = threading.Condition()
        self._stop = False
    def run(self):
        threading.Thread(target=self._loop, daemon=True).start()
    def _loop(self):
        while not self._stop:
            with self._q:
                self._q.wait(timeout=0.01)
    def stop(self):
        self._stop = True
""")
    sc = model[("m.py", "Svc")]
    reports = classify_attrs(sc)
    assert reports["_stop"].status == "safe-publish"
    assert "_q" not in reports        # sync object: never classified


def test_init_only_write_is_safe_publication():
    model = _model(m="""
import threading

class Conf:
    def __init__(self, limit):
        self._lock = threading.Lock()
        self.limit = limit
    def read(self):
        return self.limit
""")
    reports = classify_attrs(model[("m.py", "Conf")])
    assert reports["limit"].status == "safe-publish"


# -- the threaded subsystems stay race-clean ---------------------------------

@pytest.mark.parametrize("path", [
    "lighthouse_tpu_torch/obs/timeseries.py",
    "lighthouse_tpu_torch/api/serving/cache.py",
    "lighthouse_tpu_torch/api/serving/shed.py",
    "lighthouse_tpu_torch/chain/replay/engine.py",
    "lighthouse_tpu_torch/beacon_processor/processor.py",
])
def test_threaded_subsystem_is_race_clean(path):
    report = _run_rule([REPO / path])
    assert not report["violations"], \
        "\n".join(v.render() for v in report["violations"])


# -- runtime sanitizer -------------------------------------------------------

@pytest.fixture
def tracking():
    installed = getattr(threading.Lock, "_locksan", None) == locksan.PACKAGE
    if not installed:
        locksan.install_lock_tracking()
    yield
    if not installed:
        locksan.uninstall_lock_tracking()
    locksan.reset()


class _Box:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0


def test_sanitizer_trips_on_injected_race(tracking):
    class Racy(_Box):
        pass
    assert locksan.arm_class(Racy, {"count": ("_lock",)}) == ["count"]
    box = Racy()

    def unguarded():
        for _ in range(50):
            box.count += 1

    t = threading.Thread(target=unguarded)
    t.start()
    t.join()
    assert locksan.REPORTS, "injected race must trip the sanitizer"
    r = locksan.REPORTS[0]
    assert (r.cls, r.attr) == ("Racy", "count")
    # deduped: one report per (class, attr), not one per write
    assert len([x for x in locksan.REPORTS
                if (x.cls, x.attr) == ("Racy", "count")]) == 1


def test_sanitizer_stays_silent_on_guarded_writes(tracking):
    class Clean(_Box):
        pass
    locksan.arm_class(Clean, {"count": ("_lock",)})
    box = Clean()

    def guarded():
        for _ in range(50):
            with box._lock:
                box.count += 1

    threads = [threading.Thread(target=guarded) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with box._lock:
        box.count += 1
    assert not locksan.REPORTS, [r.render() for r in locksan.REPORTS]
    assert box.count == 151


def test_sanitizer_allows_condition_wrapped_lock(tracking):
    class CondBox:
        def __init__(self):
            self._lock = threading.RLock()
            self.cv = threading.Condition(self._lock)
            self.items = 0
    locksan.arm_class(CondBox, {"items": ("_lock",)})
    box = CondBox()

    def producer():
        with box.cv:
            box.items += 1
            box.cv.notify()

    t = threading.Thread(target=producer)
    t.start()
    t.join()
    with box.cv:
        box.items += 1
    assert not locksan.REPORTS, [r.render() for r in locksan.REPORTS]


def test_arming_skips_slots_and_existing_class_attrs():
    class Slotted:
        __slots__ = ("x",)
    assert locksan.arm_class(Slotted, {"x": ("_lock",)}) == []

    class HasDefault:
        x = 1
    assert locksan.arm_class(HasDefault, {"x": ("_lock",)}) == []
    assert HasDefault.x == 1


def test_single_threaded_use_never_reports(tracking):
    class Solo(_Box):
        pass
    locksan.arm_class(Solo, {"count": ("_lock",)})
    box = Solo()
    for _ in range(10):
        box.count += 1              # exclusive: no second thread yet
    assert not locksan.REPORTS


def test_cli_shared_state_dump_names_the_hot_classes():
    import subprocess
    out = subprocess.run(
        [sys.executable, "-m", "lighthouse_tpu_torch.tools.lint",
         "--shared-state"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for needle in ("BeaconProcessor", "ReplayEngine", "SlotSampler",
                   "ResponseCache", "shared class(es)"):
        assert needle in out.stdout, needle


@pytest.fixture(scope="module")
def repo_plan():
    return locksan.build_plan(REPO)


def test_repo_plan_carries_the_guarded_claims(repo_plan):
    spots = {
        ("lighthouse_tpu_torch.beacon_processor.processor",
         "BeaconProcessor"): ("processed", ("_lock",)),
        ("lighthouse_tpu_torch.obs.timeseries",
         "SlotSampler"): ("_series", ("_lock",)),
        ("lighthouse_tpu_torch.api.serving.cache",
         "ResponseCache"): ("hits", ("_lock",)),
        ("lighthouse_tpu_torch.client.environment",
         "Environment"): ("shutdown_reason", ("_lock",)),
    }
    for key, (attr, guards) in spots.items():
        assert key in repo_plan, key
        assert repo_plan[key].get(attr) == guards, (key, repo_plan[key])


def test_repo_plan_never_arms_sync_objects(repo_plan):
    for picks in repo_plan.values():
        for attr in picks:
            assert not attr.endswith(("_lock", "_cv", "_cond")), attr


# -- the port's gate and plan name the port only ------------------------------

def test_repo_plan_covers_the_port_only(repo_plan):
    assert repo_plan
    for mod, _cls in repo_plan:
        assert mod.startswith("lighthouse_tpu_torch."), mod


def _lock_made_by(module_name: str):
    """A Lock made by code whose module is ``module_name``."""
    scope = {"__name__": module_name}
    exec("import threading\nlk = threading.Lock()", scope)
    return scope["lk"]


def test_gate_names_the_port_package_exactly(tracking):
    assert isinstance(_lock_made_by("lighthouse_tpu_torch.chain.x"),
                      locksan.TrackedLock)
    assert isinstance(_lock_made_by("lighthouse_tpu_torch"),
                      locksan.TrackedLock)
    for other in ("lighthouse_tpu", "lighthouse_tpu.obs.timeseries",
                  "lighthouse_tpu_torchvision", "torch.utils.data"):
        assert not isinstance(_lock_made_by(other), locksan.TrackedLock), \
            other


def test_jax_package_lock_is_not_wrapped(tracking):
    """A lock the JAX package's own code makes stays raw under the port's
    sanitizer, while the port's twin class gets a tracked one."""
    from lighthouse_tpu.obs.timeseries import SlotSampler as JaxSampler
    from lighthouse_tpu_torch.obs.timeseries import SlotSampler
    assert not isinstance(JaxSampler()._lock, locksan.TrackedLock)
    assert isinstance(SlotSampler()._lock, locksan.TrackedLock)


_SANITIZED_GIL = """
from lighthouse_tpu_torch import device
device.set_device("cpu")
from lighthouse_tpu_torch.tools import sanitize
raise SystemExit(sanitize.main(["lighthouse_tpu_torch.tools.gil_throughput"]))
"""


def test_sanitized_gossip_workload_is_race_clean():
    """gil_throughput (C++ backend, a small chain) in a process armed as
    chip_smoke.py's phase 13 arms it: tracking installed, every class of
    the plan armed, then the node's modules imported; 0 reports."""
    import json
    import os
    import subprocess
    env = {**os.environ, "LHTPU_GIL_SLOTS": "4",
           "LHTPU_GIL_VALIDATORS": "64", "LHTPU_GIL_BACKEND": "cpp"}
    out = subprocess.run([sys.executable, "-c", _SANITIZED_GIL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    tool, san = json.loads(lines[-2]), json.loads(lines[-1])["locksan"]
    assert tool["real_errors"] == 0
    assert tool["atts_verified"] == tool["atts_sent_once"]
    assert san["armed"] >= 20
    assert san["reports"] == []
