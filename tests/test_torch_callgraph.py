"""Unit tests for the port's interprocedural substrate: fact extraction,
call-graph resolution, and the content-hash file cache.

The port's copy of ``test_callgraph.py``, its imports switched to
``lighthouse_tpu_torch.analysis``. The call graph is the JAX package's,
logic unchanged: its wrapper-root flags still read the ``jax.jit`` idiom
(cases below), while the port's device-program roots (``@tracked`` /
``track_roofline``) are found by its trace-safety rule (last cases).

These pin the semantics every cross-file rule (trace-safety,
lock-order, shutdown-order, compile-budget) builds on — a resolution
regression here silently turns those rules into no-ops, so the graph
gets its own direct coverage instead of relying on the rule fixtures.
"""
import ast
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

from lighthouse_tpu_torch.analysis import Project, run_project  # noqa: E402
from lighthouse_tpu_torch.analysis.cache import (  # noqa: E402
    FileCache, compute_salt, content_key,
)
from lighthouse_tpu_torch.analysis.callgraph import (  # noqa: E402
    CallGraph, build_facts,
)
from lighthouse_tpu_torch.analysis.engine import Module  # noqa: E402
from lighthouse_tpu_torch.analysis.rules import trace_safety  # noqa: E402


def _facts(source: str, relpath: str):
    return build_facts(ast.parse(source), relpath)


def _graph(**modules):
    """CallGraph over {relpath: source} keyword modules (dots in
    relpaths passed as __)."""
    facts = {}
    for rel, src in modules.items():
        rel = rel.replace("__", "/") + ".py"
        facts[rel] = _facts(src, rel)
    return CallGraph(facts)


# -- fact extraction ---------------------------------------------------------

def test_jit_root_detection_covers_all_wrapping_styles():
    m = _facts(
        "import jax\n"
        "import functools\n"
        "@jax.jit\n"
        "def decorated(x):\n"
        "    return x\n"
        "@functools.partial(jax.jit, static_argnums=0)\n"
        "def partial_decorated(n, x):\n"
        "    return x\n"
        "def wrapped_later(x):\n"
        "    return x\n"
        "fast = jax.jit(wrapped_later)\n"
        "def plain(x):\n"
        "    return x\n",
        "m.py")
    assert m.funcs["decorated"].is_jit_root
    assert m.funcs["partial_decorated"].is_jit_root
    assert m.funcs["wrapped_later"].is_jit_root
    assert not m.funcs["plain"].is_jit_root


def test_call_site_jit_wrap_is_scoped_to_the_wrapping_function():
    # `jit(update)` inside one factory must not mark an unrelated
    # module-level `update` variant in another scope... but a
    # module-level fn wrapped at module level is a root
    m = _facts(
        "import jax\n"
        "class F:\n"
        "    def build(self):\n"
        "        def update(x):\n"
        "            return x\n"
        "        return jax.jit(update)\n"
        "def update(x):\n"
        "    return x\n",
        "m.py")
    assert m.funcs["F.build.update"].is_jit_root
    assert not m.funcs["update"].is_jit_root


def test_memoized_factory_and_builds_jit_flags():
    m = _facts(
        "import functools\n"
        "import jax\n"
        "@functools.lru_cache(maxsize=None)\n"
        "def factory(n):\n"
        "    return jax.jit(lambda x: x)\n"
        "def helper(n):\n"
        "    return factory(n)\n",
        "m.py")
    assert m.funcs["factory"].is_memoized
    assert m.funcs["factory"].builds_jit
    assert not m.funcs["helper"].is_memoized
    assert not m.funcs["helper"].builds_jit


def test_higher_order_args_become_call_edges():
    m = _facts(
        "import jax\n"
        "def body(c, x):\n"
        "    return c, x\n"
        "def driver(xs):\n"
        "    return jax.lax.scan(body, 0, xs)\n",
        "m.py")
    names = {s.name for s in m.funcs["driver"].calls}
    assert "body" in names          # the scanned callable is an edge
    assert "jax.lax.scan" in names


def test_callback_escape_suppresses_edges_inside_args():
    m = _facts(
        "import jax\n"
        "def host_fn(v):\n"
        "    return v\n"
        "def user(x):\n"
        "    return jax.pure_callback(host_fn, x, x)\n",
        "m.py")
    names = {s.name for s in m.funcs["user"].calls}
    assert "jax.pure_callback" in names   # the escape call is recorded
    assert "host_fn" not in names         # but the host fn is no edge


# -- import and call resolution ----------------------------------------------

def test_resolve_module_relative_levels():
    g = _graph(
        pkg__sub__a="from . import b\nfrom ..top import f\n",
        pkg__sub__b="def g():\n    pass\n",
        pkg__top="def f():\n    pass\n")
    assert g.resolve_module("pkg/sub/a.py", "b", 1) == "pkg/sub/b.py"
    assert g.resolve_module("pkg/sub/a.py", "top", 2) == "pkg/top.py"
    assert g.resolve_module("pkg/sub/a.py", "missing", 1) is None
    # relative import climbing above the scan root resolves to nothing
    assert g.resolve_module("pkg/top.py", "x", 5) is None


def test_resolve_module_component_aligned_suffix():
    # absolute imports written from the package root must match only on
    # whole path components: lighthouse_tpu_torch.ops.x != sops/x
    g = _graph(
        repo__lighthouse_tpu_torch__ops__x="def f():\n    pass\n",
        repo__lighthouse_tpu_torch__sops__x="def f():\n    pass\n")
    assert g.resolve_module("repo/lighthouse_tpu_torch/main.py",
                            "lighthouse_tpu_torch.ops.x", 0) == \
        "repo/lighthouse_tpu_torch/ops/x.py"


def test_resolve_call_through_from_import_alias():
    g = _graph(
        a="from b import work as w\ndef caller():\n    w()\n",
        b="def work():\n    pass\n")
    assert g.resolve_call("a.py", "caller", "w") == [("b.py", "work")]


def test_resolve_call_through_module_import_alias():
    g = _graph(
        a="import b as helpers\ndef caller():\n    helpers.work()\n",
        b="def work():\n    pass\n")
    assert g.resolve_call("a.py", "caller", "helpers.work") == \
        [("b.py", "work")]


def test_self_calls_resolve_only_when_enabled():
    g = _graph(
        a="class C:\n"
          "    def top(self):\n"
          "        self.leaf()\n"
          "    def leaf(self):\n"
          "        pass\n")
    assert g.resolve_call("a.py", "C.top", "self.leaf") == \
        [("a.py", "C.leaf")]
    assert g.resolve_call("a.py", "C.top", "self.leaf",
                          self_calls=False) == []


def test_reachable_honors_skip_call_and_skip_module():
    g = _graph(
        a="from b import down\n"
          "from c import stopper\n"
          "def root():\n"
          "    down()\n"
          "    stopper()\n",
        b="def down():\n    pass\n",
        c="def stopper():\n    pass\n")
    full = g.reachable([("a.py", "root")])
    assert ("b.py", "down") in full and ("c.py", "stopper") in full
    pruned = g.reachable([("a.py", "root")],
                         skip_call=lambda n: n == "stopper")
    assert ("c.py", "stopper") not in pruned
    modless = g.reachable([("a.py", "root")],
                          skip_module=lambda rel: rel == "b.py")
    assert ("b.py", "down") not in modless


def test_transitive_closure_is_reverse_reachability():
    g = _graph(
        a="def blocker():\n"
          "    pass\n"
          "def mid():\n"
          "    blocker()\n"
          "def top():\n"
          "    mid()\n"
          "def unrelated():\n"
          "    pass\n")
    closure = g.transitive_closure([("a.py", "blocker")])
    assert ("a.py", "mid") in closure and ("a.py", "top") in closure
    assert ("a.py", "unrelated") not in closure


# -- cache invalidation ------------------------------------------------------

def test_cache_roundtrip_and_salt_discard(tmp_path):
    path = tmp_path / "lint.cache"
    c1 = FileCache(path, salt="s1")
    c1.put("k", {"facts": 1})
    c1.save()
    assert FileCache(path, salt="s1").get("k") == {"facts": 1}
    # analyzer-code change → new salt → the whole cache is discarded
    assert FileCache(path, salt="s2").get("k") is None
    assert len(FileCache(path, salt="s2")) == 0


def test_content_key_changes_with_the_file():
    assert content_key("def f(): pass\n") != content_key("def f():  pass\n")


def test_salt_is_stable_for_the_same_tree():
    assert compute_salt(REPO) == compute_salt(REPO)


def test_edit_invalidates_only_the_edited_file(tmp_path):
    mod_a = tmp_path / "a.py"
    mod_b = tmp_path / "b.py"
    mod_a.write_text("def fa():\n    pass\n")
    mod_b.write_text("def fb():\n    pass\n")
    cache = tmp_path / "lint.cache"

    def run():
        project = Project.load(tmp_path, [mod_a, mod_b])
        return run_project(project, cache_path=cache)

    assert run()["cached_files"] == 0          # cold
    assert run()["cached_files"] == 2          # warm
    mod_a.write_text("def fa():\n    return 1\n")
    assert run()["cached_files"] == 1          # only b.py still cached
    assert run()["cached_files"] == 2          # re-warmed


def test_salt_hashes_the_ports_constant_table(tmp_path):
    """The salt covers the analyzer and the port's spec-constant table:
    a repo root without the table salts differently."""
    assert compute_salt(REPO) != compute_salt(tmp_path)


# -- the port's device-program roots -----------------------------------------

def _roots(source: str) -> set:
    mod = Module(Path("m.py"), "m.py", source)
    return set(trace_safety._FuncIndex(mod).roots)


def test_device_roots_cover_all_wrapping_styles():
    roots = _roots(
        "from lighthouse_tpu_torch.obs.roofline import track_roofline, tracked\n"
        "@tracked('k', cost)\n"
        "def decorated(x):\n"
        "    return x\n"
        "def wrapped_later(x):\n"
        "    return x\n"
        "fast = track_roofline('k2', wrapped_later, cost)\n"
        "def called_form(x):\n"
        "    return x\n"
        "other = tracked('k3', cost)(called_form)\n"
        "def plain(x):\n"
        "    return x\n")
    assert roots == {"decorated", "wrapped_later", "called_form"}


def test_device_root_wrap_is_scoped_to_the_wrapping_function():
    roots = _roots(
        "class F:\n"
        "    def build(self):\n"
        "        def run(x):\n"
        "            return x\n"
        "        return tracked('k', cost)(run)\n"
        "def run(x):\n"
        "    return x\n")
    assert roots == {"F.build.run"}
