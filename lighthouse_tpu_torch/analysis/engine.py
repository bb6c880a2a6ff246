"""graftlint engine: rule registry, project model, baseline, reporters.

Deliberately dependency-free (ast + json + pathlib only): the lint suite
must run in seconds on a CPU-only host and inside tier-1 without
touching torch or the card. Rules register themselves via the :func:`rule` decorator at
import time (``analysis/rules/__init__.py`` imports each rule module).

v2 — the interprocedural engine. Analysis runs in two stages:

1. **per-file** (parallelizable across worker processes, cached by file
   content hash — ``cache.py``): parse, build the module's
   :class:`~.callgraph.ModuleFacts`, run every rule's ``check_module``
   and ``summarize_module``. The stage's output is picklable, so a file
   that didn't change never re-parses.
2. **cross-file**: build one shared :class:`~.callgraph.CallGraph` from
   the facts and run each rule's ``finalize_project`` — trace-safety's
   device-program reachability, lock-order's acquisition-graph cycles,
   shutdown-order's guard analysis and compile-budget's shape-key
   enumeration all consume the same graph.

Baseline discipline: ``baseline.json`` is a *reviewed* allowlist. Every
entry must carry a non-empty ``justification`` and match at least one
live violation — stale entries are reported so the allowlist cannot rot
into a dumping ground (the failure mode the beacon-client security
review attributes most silent-invariant bugs to).
"""
from __future__ import annotations

import ast
import dataclasses
import json
import time
from pathlib import Path

from . import cache as cache_mod
from .callgraph import CallGraph, ModuleFacts, build_facts  # noqa: F401

#: directories never scanned (generated corpora, caches)
_SKIP_PARTS = {"__pycache__", "_build", ".git"}
#: the rule fixtures, seeded on purpose: a package scan skips them, and
#: they are read only where a caller names them (or their directory)
_FIXTURES = Path(__file__).resolve().parent / "fixtures"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding. ``symbol`` is the enclosing def/class chain — it keys
    baseline matching so entries survive unrelated line drift."""
    rule: str
    path: str            # path relative to the scan root's parent
    line: int
    message: str
    symbol: str = ""

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "symbol": self.symbol, "message": self.message}

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{loc}: {self.rule}{sym}: {self.message}"


class Module:
    """One parsed source file."""

    def __init__(self, path: Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=str(path))

    def violation(self, rule: str, node: ast.AST, message: str,
                  symbol: str = "") -> Violation:
        return Violation(rule=rule, path=self.relpath,
                         line=getattr(node, "lineno", 0),
                         message=message, symbol=symbol)


class Project:
    """The scanned file set plus the package root (for rules that need
    out-of-scan context, e.g. the spec-constant table)."""

    def __init__(self, root: Path, modules: list[Module]):
        self.root = root
        self.modules = modules

    @classmethod
    def load(cls, root: Path, paths: list[Path] | None = None) -> "Project":
        root = root.resolve()
        files: list[Path] = []
        for base in (paths or [root]):
            base = base.resolve()
            if base.is_file():
                files.append(base)
            else:
                files.extend(
                    f for f in sorted(base.rglob("*.py"))
                    if base not in _FIXTURES.parents
                    or _FIXTURES not in f.parents)
        modules = []
        for f in files:
            if _SKIP_PARTS.intersection(f.parts):
                continue
            try:
                rel = str(f.relative_to(root.parent))
            except ValueError:
                rel = str(f)
            modules.append(Module(f, rel, f.read_text()))
        return cls(root, modules)


@dataclasses.dataclass
class AnalysisContext:
    """What the cross-file stage hands each rule: the shared call graph,
    per-module facts, and whatever each rule's ``summarize_module``
    stored (all cache-safe plain data — never ASTs)."""
    project: Project
    facts: dict                 # relpath -> ModuleFacts
    rule_data: dict             # relpath -> {rule_name: data}
    graph: CallGraph

    def data_for(self, rule_name: str) -> dict:
        """relpath -> summary for one rule (modules that returned None
        are omitted)."""
        out = {}
        for rel, per_rule in self.rule_data.items():
            data = per_rule.get(rule_name)
            if data is not None:
                out[rel] = data
        return out


class Rule:
    """Base rule. Subclasses set ``name``/``description`` and override:

    - :meth:`check_module` — per file, runs in the (cached, parallel)
      per-file stage; must not look at other modules.
    - :meth:`summarize_module` — per file, same stage; returns plain
      picklable data for the cross-file stage (or None).
    - :meth:`finalize_project` — cross-file, runs once with the shared
      :class:`AnalysisContext` (call graph + all summaries).
    - :meth:`finalize` — legacy cross-file hook taking the raw Project;
      prefer ``finalize_project`` (facts are cached, ASTs are not).
    """

    name: str = ""
    description: str = ""

    def check_module(self, module: Module,
                     project: Project) -> list[Violation]:
        return []

    def summarize_module(self, module: Module, project: Project):
        return None

    def finalize_project(self, ctx: AnalysisContext) -> list[Violation]:
        return []

    def finalize(self, project: Project) -> list[Violation]:
        return []


_REGISTRY: dict[str, Rule] = {}


def rule(cls: type[Rule]) -> type[Rule]:
    """Class decorator: instantiate and register a rule by its name."""
    inst = cls()
    assert inst.name, f"{cls.__name__} has no name"
    assert inst.name not in _REGISTRY, f"duplicate rule {inst.name}"
    _REGISTRY[inst.name] = inst
    return cls


def all_rules() -> dict[str, Rule]:
    return dict(_REGISTRY)


# -- baseline ----------------------------------------------------------------

def load_baseline(path: Path) -> list[dict]:
    """Load and validate the allowlist; every entry needs rule, path and a
    non-empty justification (reviewed, not silently accumulated)."""
    if not path.exists():
        return []
    entries = json.loads(path.read_text())
    for e in entries:
        for field in ("rule", "path", "justification"):
            if not e.get(field):
                raise ValueError(
                    f"baseline entry {e!r} missing required {field!r}")
    return entries


def _baseline_matches(entry: dict, v: Violation) -> bool:
    if entry["rule"] != v.rule or entry["path"] != v.path:
        return False
    if "symbol" in entry:
        return entry["symbol"] == v.symbol
    if "line" in entry:
        return int(entry["line"]) == v.line
    return True          # whole-file waiver for this rule


# -- driver ------------------------------------------------------------------

def _analyze_module(root: Path, mod: Module) -> dict:
    """The per-file stage for one module: facts + every registered
    rule's check_module/summarize_module. Output is picklable (cached
    by content hash, shipped across worker processes)."""
    from . import rules as _  # noqa: F401  (registry, in workers too)
    mini = Project.__new__(Project)
    mini.root = root
    mini.modules = [mod]
    payload = {"facts": build_facts(mod.tree, mod.relpath),
               "violations": {}, "rule_data": {}}
    for name, r in all_rules().items():
        vs = r.check_module(mod, mini)
        if vs:
            payload["violations"][name] = \
                [dataclasses.asdict(v) for v in vs]
        data = r.summarize_module(mod, mini)
        if data is not None:
            payload["rule_data"][name] = data
    return payload


def _analyze_file(args: tuple) -> tuple:
    """Worker-process entry point: (relpath, payload)."""
    root_str, path_str, relpath, source = args
    mod = Module(Path(path_str), relpath, source)
    return relpath, _analyze_module(Path(root_str), mod)


def run_project(project: Project, rules: dict[str, Rule] | None = None,
                baseline: list[dict] | None = None, *,
                jobs: int | None = None,
                cache_path: Path | None = None) -> dict:
    """Run rules over the project. Returns a report dict:
    ``violations`` (non-baselined), ``baselined``, ``stale_baseline``
    (entries that matched nothing), ``elapsed_s``, ``cached_files``.

    ``jobs``: worker processes for the per-file stage (None/1 = in
    process). ``cache_path``: persistent per-file cache (see cache.py).
    The per-file stage always runs ALL registered rules so cached
    entries are valid for any later ``--rules`` selection; ``rules``
    filters reporting and the cross-file stage.
    """
    rules = rules if rules is not None else all_rules()
    baseline = baseline or []
    t0 = time.monotonic()

    cache = None
    if cache_path is not None:
        cache = cache_mod.FileCache(
            cache_path, cache_mod.compute_salt(project.root))
    results: dict[str, dict] = {}
    keys: dict[str, str] = {}
    misses: list[Module] = []
    for mod in project.modules:
        key = cache_mod.content_key(mod.source)
        keys[mod.relpath] = key
        hit = cache.get(key) if cache is not None else None
        if hit is not None:
            results[mod.relpath] = hit
        else:
            misses.append(mod)
    cached_files = len(results)

    if misses:
        if jobs and jobs > 1 and len(misses) > 4:
            from concurrent.futures import ProcessPoolExecutor
            args = [(str(project.root), str(m.path), m.relpath, m.source)
                    for m in misses]
            with ProcessPoolExecutor(max_workers=jobs) as ex:
                for relpath, payload in ex.map(_analyze_file, args,
                                               chunksize=8):
                    results[relpath] = payload
        else:
            for m in misses:
                results[m.relpath] = _analyze_module(project.root, m)
        if cache is not None:
            for m in misses:
                cache.put(keys[m.relpath], results[m.relpath])
            cache.save()

    found: list[Violation] = []
    for rel in results:
        per_rule = results[rel]["violations"]
        for rname in rules:
            for v in per_rule.get(rname, ()):
                found.append(Violation(**v))

    ctx = AnalysisContext(
        project=project,
        facts={rel: p["facts"] for rel, p in results.items()},
        rule_data={rel: p["rule_data"] for rel, p in results.items()},
        graph=CallGraph({rel: p["facts"] for rel, p in results.items()}))
    for r in rules.values():
        found.extend(r.finalize_project(ctx))
        found.extend(r.finalize(project))

    live, waived = [], []
    used = [False] * len(baseline)
    for v in found:
        matched = False
        for i, e in enumerate(baseline):
            if _baseline_matches(e, v):
                used[i] = True
                matched = True
        (waived if matched else live).append(v)
    live.sort(key=lambda v: (v.path, v.line, v.rule))
    waived.sort(key=lambda v: (v.path, v.line, v.rule))
    return {
        "violations": live,
        "baselined": waived,
        "stale_baseline": [e for i, e in enumerate(baseline) if not used[i]],
        "rules": sorted(rules),
        "files": len(project.modules),
        "cached_files": cached_files,
        "elapsed_s": round(time.monotonic() - t0, 3),
    }


def render_text(report: dict) -> str:
    lines = []
    for v in report["violations"]:
        lines.append(v.render())
    for v in report["baselined"]:
        lines.append(f"{v.render()}  (baselined)")
    for e in report["stale_baseline"]:
        lines.append(f"WARNING: stale baseline entry matches nothing: "
                     f"{json.dumps(e, sort_keys=True)}")
    lines.append(
        f"graftlint: {len(report['violations'])} violation(s), "
        f"{len(report['baselined'])} baselined, "
        f"{len(report['stale_baseline'])} stale baseline entr(ies) — "
        f"{len(report['rules'])} rules over {report['files']} files in "
        f"{report['elapsed_s']}s")
    return "\n".join(lines)


def render_json(report: dict) -> str:
    return json.dumps({
        "violations": [v.to_json() for v in report["violations"]],
        "baselined": [v.to_json() for v in report["baselined"]],
        "stale_baseline": report["stale_baseline"],
        "rules": report["rules"],
        "files": report["files"],
        "elapsed_s": report["elapsed_s"],
    }, indent=2)


def render_sarif(report: dict, descriptions: dict | None = None) -> str:
    """SARIF 2.1.0 for CI annotation / editor ingestion. Live findings
    are ``error`` results; baselined ones carry an external suppression
    so viewers show them struck-through instead of hiding the waiver."""
    descriptions = descriptions or {}

    def result(v: Violation, suppressed: bool) -> dict:
        r = {
            "ruleId": v.rule,
            "level": "error",
            "message": {"text": v.message +
                        (f" [{v.symbol}]" if v.symbol else "")},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": v.path},
                    "region": {"startLine": max(v.line, 1)},
                },
            }],
        }
        if suppressed:
            r["suppressions"] = [{"kind": "external"}]
        return r

    return json.dumps({
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri": "ANALYSIS.md",
                "rules": [{"id": name,
                           "shortDescription":
                               {"text": descriptions.get(name, name)}}
                          for name in report["rules"]],
            }},
            "results":
                [result(v, False) for v in report["violations"]] +
                [result(v, True) for v in report["baselined"]],
        }],
    }, indent=2)


# -- shared AST helpers (used by several rules) ------------------------------

def dotted_name(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute/Name chains, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def enclosing_symbol(stack: list[ast.AST]) -> str:
    """Dotted def/class chain for a node stack, e.g. 'Peer.close'."""
    names = [n.name for n in stack
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef))]
    return ".".join(names)


def safe_int_eval(node: ast.AST) -> int | None:
    """Evaluate a constant integer expression (literals, + - * ** << |,
    unary -). Returns None for anything non-constant. Lets the drift rule
    see through forms like ``2**64 - 1``."""
    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, int) \
            and not isinstance(node.value, bool) else None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = safe_int_eval(node.operand)
        return -v if v is not None else None
    if isinstance(node, ast.BinOp):
        lhs, rhs = safe_int_eval(node.left), safe_int_eval(node.right)
        if lhs is None or rhs is None:
            return None
        try:
            if isinstance(node.op, ast.Add):
                return lhs + rhs
            if isinstance(node.op, ast.Sub):
                return lhs - rhs
            if isinstance(node.op, ast.Mult):
                return lhs * rhs
            if isinstance(node.op, ast.Pow):
                return lhs ** rhs if abs(rhs) < 512 else None
            if isinstance(node.op, ast.LShift):
                return lhs << rhs if rhs < 512 else None
            if isinstance(node.op, ast.BitOr):
                return lhs | rhs
        except (OverflowError, ValueError):
            return None
    return None
