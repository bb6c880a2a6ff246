"""compile-budget: the fixed two-shape lane budget, and roofline pairing.

The flagship sharded paths (``parallel/bls.py``, ``parallel/merkle.py``)
run at a FIXED TWO-SHAPE lane budget: the kernels are built once for any
shape, but every lane count a batch runs at is a shape the pipeline's
buffers, padding tables and roofline records are keyed by, and the
design admits two (the full ``lanes`` batch and the sanctioned
small-batch split).  A third lane count — or one derived from a raw
input length — makes the work (and the records) track arbitrary caller
batch sizes; this rule rejects them before they run.  It is the port's
twin of the JAX package's jit compile budget.

Mechanics (on the shared interprocedural engine):

1. **lane-keyed programs**: the scoped module's functions with a
   ``lanes`` parameter (``replicated_prep``,
   ``sharded_verify_signature_sets``).
2. every call site in the scoped modules is resolved through the call
   graph; the expression passed as ``lanes`` (by position or keyword)
   IS the shape key (a program passing its own ``lanes`` on adds none).
3. **budget**: per program, the distinct keys across call sites
   (compared as canonical source text) must number ≤ 2 — the 3rd+
   distinct key is flagged at its call site, in line order.
4. **shape-key provenance**: each key expression is expanded through
   the enclosing function's assignments (textual fixpoint); a key whose
   provenance contains a raw ``len(...)`` is flagged — tensor shapes
   (``x.shape[...]``) are sanctioned, but a raw input length makes the
   key track arbitrary caller batch sizes.  Pad to the fixed lane count
   (``host_prepare(..., lanes, small=...)``) before keying.
5. **roofline pairing** (tree-wide): every ctypes kernel entry of
   ``kernels.py`` (``kernels.X.launch(...)``) must be reached only from
   a device program built with ``obs.roofline.track_roofline`` /
   ``@tracked`` — the wrapper that pairs each launch with its declared
   cost and its roofline record.  A launch in a function that is not
   tracked, and whose resolved callers are not all (transitively)
   tracked, runs unmetered against the platform peak table.
"""
from __future__ import annotations

import ast
import re

from ..engine import Module, Project, Rule, Violation, dotted_name, rule
from .device_transfer import device_programs

_SCOPED = ("parallel/bls.py", "parallel/merkle.py", "compile_budget")
_BUDGET = 2
_KEY_PARAM = "lanes"


def _in_scope(rel: str) -> bool:
    return any(rel.endswith(p) or p in rel for p in _SCOPED)


class _FuncCollect(ast.NodeVisitor):
    """Assignment provenance + call-argument texts for one function."""

    def __init__(self):
        self.assigns: dict[str, str] = {}    # var -> value source text
        self.calls: list = []                # [name, line, args, kwargs]

    def _record_assign(self, targets, value) -> None:
        try:
            text = ast.unparse(value)
        except Exception:
            return
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    self.assigns[n.id] = text

    def visit_Assign(self, node: ast.Assign) -> None:
        self._record_assign(node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_assign([node.target], node.value)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        self._record_assign([node.target], node.iter)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        if name:
            try:
                args = [ast.unparse(a) for a in node.args]
                kwargs = {kw.arg: ast.unparse(kw.value)
                          for kw in node.keywords if kw.arg}
                self.calls.append([name, node.lineno, args, kwargs])
            except Exception:
                pass
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return   # nested defs are collected under their own qualname

    visit_AsyncFunctionDef = visit_FunctionDef


def _expand(text: str, assigns: dict, rounds: int = 4) -> str:
    """Textual provenance fixpoint: substitute assigned variables by
    their defining expressions (skipping self-referential defs)."""
    for _ in range(rounds):
        before = text
        for var, val in assigns.items():
            if re.search(rf"\b{re.escape(var)}\b", val):
                continue             # x = x + 1: keep the symbol
            text = re.sub(rf"\b{re.escape(var)}\b", f"({val})", text)
            if len(text) > 10000:
                return text
        if text == before:
            return text
    return text


def _kernels_bindings(tree: ast.AST) -> tuple[set[str], set[str]]:
    """(module aliases bound to ``kernels``, kernel names imported out
    of it)."""
    aliases: set[str] = set()
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            m = (node.module or "").lstrip(".")
            if m == "kernels" or m.endswith(".kernels"):
                names.update(a.asname or a.name for a in node.names)
            else:
                aliases.update(a.asname or a.name for a in node.names
                               if a.name == "kernels")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "kernels" or a.name.endswith(".kernels"):
                    aliases.add(a.asname or a.name)
    return aliases, names


def _launch_sites(tree: ast.AST) -> dict[str, list]:
    """qualname -> [[kernel, line], ...]: ``kernels.X.launch(...)`` (or
    ``X.launch`` for an ``X`` imported out of kernels) per function."""
    aliases, names = _kernels_bindings(tree)
    out: dict[str, list] = {}
    stack: list[str] = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                stack.append(child.name)
                walk(child)
                stack.pop()
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.append(child.name)
                walk(child)
                stack.pop()
            else:
                if isinstance(child, ast.Call) and stack:
                    parts = dotted_name(child.func).split(".")
                    if len(parts) >= 2 and parts[-1] == "launch" and (
                            (len(parts) == 3 and parts[0] in aliases) or
                            (len(parts) == 2 and parts[0] in names)):
                        out.setdefault(".".join(stack), []).append(
                            [parts[-2], child.lineno])
                walk(child)

    walk(tree)
    return out


def _tracked_quals(tree: ast.AST) -> set[str]:
    """Qualnames of the module's tracked device programs."""
    names = device_programs(tree, costs=False)
    out: set[str] = set()
    stack: list[str] = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                stack.append(child.name)
                if not isinstance(child, ast.ClassDef) and \
                        child.name in names:
                    out.add(".".join(stack))
                walk(child)
                stack.pop()

    walk(tree)
    return out


@rule
class CompileBudgetRule(Rule):
    name = "compile-budget"
    description = ("fixed two-shape lane budget on the parallel/ "
                   "flagship paths (≤2 distinct lane keys per program, "
                   "none from a raw length); kernel launches reached only "
                   "from roofline-tracked device programs")

    # -- per-file (cached) stage ---------------------------------------------

    def summarize_module(self, module: Module, project: Project):
        out: dict = {}
        src = module.source
        launches = _launch_sites(module.tree) if ".launch(" in src else {}
        tracked = (_tracked_quals(module.tree)
                   if "tracked" in src or "track_roofline" in src else set())
        if launches or tracked:
            out["launches"] = launches
            out["tracked"] = sorted(tracked)
        if not _in_scope(module.relpath):
            return out or None
        funcs: dict[str, dict] = {}
        programs: dict[str, int] = {}
        stack: list[str] = []

        def walk(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    stack.append(child.name)
                    walk(child)
                    stack.pop()
                elif isinstance(child,
                                (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = ".".join(stack + [child.name])
                    params = [a.arg for a in child.args.posonlyargs
                              + child.args.args]
                    if _KEY_PARAM in params or _KEY_PARAM in \
                            [a.arg for a in child.args.kwonlyargs]:
                        programs[qual] = params.index(_KEY_PARAM) \
                            if _KEY_PARAM in params else -1
                    col = _FuncCollect()
                    for stmt in child.body:
                        col.visit(stmt)
                    if col.calls:
                        funcs[qual] = {"assigns": col.assigns,
                                       "calls": col.calls}
                    stack.append(child.name)
                    walk(child)
                    stack.pop()

        walk(module.tree)
        if funcs or programs:
            out.update(funcs=funcs, programs=programs)
        return out or None

    # -- cross-file stage -----------------------------------------------------

    def finalize_project(self, ctx) -> list:
        data = ctx.data_for(self.name)
        return self._budget(ctx, data) + self._pairing(ctx, data)

    def _budget(self, ctx, data) -> list:
        programs = {(rel, q): pos for rel, d in data.items()
                    for q, pos in d.get("programs", {}).items()}
        if not programs:
            return []
        out = []
        # resolve every scoped call site to a program
        #    site: (program, key, rel, line, caller qual, assigns)
        sites = []
        for rel, d in data.items():
            for qual, f in d.get("funcs", {}).items():
                for name, line, args, kwargs in f["calls"]:
                    for cand in ctx.graph.resolve_call(rel, qual, name):
                        if cand not in programs:
                            continue
                        pos = programs[cand]
                        # a method's self is not among the call's args
                        if "." in cand[1] and "." in name:
                            pos -= 1
                        key = kwargs.get(_KEY_PARAM)
                        if key is None and 0 <= pos < len(args):
                            key = args[pos]
                        # a program forwarding its own lane count to
                        # another adds no shape
                        forwards = key == _KEY_PARAM and \
                            (rel, qual) in programs
                        if key is not None and not forwards:
                            sites.append((cand, key, rel, line, qual,
                                          f["assigns"]))
                        break
        sites.sort(key=lambda s: (s[2], s[3]))

        # the two-shape budget per program
        seen_keys: dict[tuple, list] = {}
        for prog, key, rel, line, qual, _assigns in sites:
            keys = seen_keys.setdefault(prog, [])
            if key in keys:
                continue
            keys.append(key)
            if len(keys) > _BUDGET:
                out.append(Violation(
                    rule=self.name, path=rel, line=line,
                    message=(f"distinct lane count #{len(keys)} for "
                             f"'{prog[1]}' ({key}) exceeds the fixed "
                             "two-shape budget — reuse one of the two "
                             "sanctioned lane counts or fold this case "
                             "into the small-batch split"),
                    symbol=qual))

        # raw-length provenance on any key expression
        for prog, key, rel, line, qual, assigns in sites:
            prov = _expand(key, assigns)
            if "len(" in prov and ".shape" not in prov:
                out.append(Violation(
                    rule=self.name, path=rel, line=line,
                    message=(f"lane count '{key}' for '{prog[1]}' derives "
                             "from a raw input length (provenance: "
                             f"{prov[:120]}) — every distinct batch size "
                             "is a shape of its own; pad to the fixed "
                             "lane count first"),
                    symbol=qual))
        return out

    def _pairing(self, ctx, data) -> list:
        launches = [(rel, q, sites) for rel, d in data.items()
                    for q, sites in d.get("launches", {}).items()]
        if not launches:
            return []
        tracked = {(rel, q) for rel, d in data.items()
                   for q in d.get("tracked", ())}
        callers: dict[tuple, list] = {}
        for node in ctx.graph.nodes():
            for cand, _site in ctx.graph.callees(node):
                callers.setdefault(cand, []).append(node)
        memo: dict[tuple, bool] = {}

        def metered(node, seen) -> bool:
            """Tracked, or reached only from metered callers."""
            if node in tracked:
                return True
            if node in memo:
                return memo[node]
            if node in seen:
                return True          # a cycle adds no unmetered entry
            who = callers.get(node, [])
            ok = bool(who) and all(metered(c, seen | {node}) for c in who)
            memo[node] = ok
            return ok

        out = []
        for rel, qual, sites in sorted(launches):
            if metered((rel, qual), frozenset()):
                continue
            for kernel, line in sites:
                out.append(Violation(
                    rule=self.name, path=rel, line=line,
                    message=(f"kernel entry {kernel}.launch in '{qual}' is "
                             "reachable from outside a roofline-tracked "
                             "device program — build the launch wrapper "
                             "with obs.roofline.track_roofline / @tracked "
                             "so every launch is paired with its cost and "
                             "roofline record"),
                    symbol=qual))
        return out
