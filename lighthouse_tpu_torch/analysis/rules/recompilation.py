"""recompile-hazard: kernel libraries rebuilt or rebound per call.

The port builds each CUDA kernel once (``kernels.build_all``: ``nvcc``
into ``_build/``) and binds it once with ``ctypes``; every launch after
that is a plain C call.  A library built or bound inside a function
body that runs per call defeats that: every call re-runs the build (or
at least re-opens and re-binds the shared object), the port's
counterpart of a ``jax.jit`` wrapper rebuilt per call and re-tracing.

Flagged, inside a function body: ``CudaKernel(...)``,
``kernels._bls(...)``, ``ctypes.CDLL(...)`` / ``cdll.LoadLibrary(...)``
and ``torch.utils.cpp_extension.load`` / ``load_inline`` — unless the
library outlives the call:

- an enclosing function is memoized (``@functools.lru_cache`` /
  ``@cache``), or keeps its result by hand (a ``global`` it assigns, a
  store into a module-level container or into ``self``);
- the function is a process entry (``main``), run once a process;
- every resolved caller of the function is itself one of the above
  (a ``_load_lib`` called only from its memoizing ``get_lib``);
- it is ``kernels.py``, whose build-once path (``build_all``,
  ``CudaKernel.variant``'s per-kernel memo) is the sanctioned one.

Module-level construction (the kernel table) runs once at import: the
idiom.
"""
from __future__ import annotations

import ast

from ..engine import Module, Project, Rule, Violation, dotted_name, \
    enclosing_symbol, rule

_BUILDERS = {"CudaKernel", "_bls", "CDLL", "LoadLibrary", "load_inline"}
_CPP_EXT_LOAD = {"cpp_extension.load", "torch.utils.cpp_extension.load"}
_MEMO_DECORATORS = {"lru_cache", "cache"}
_ENTRY_POINTS = {"main"}


def _builder(node: ast.Call) -> str:
    name = dotted_name(node.func)
    if not name:
        return ""
    if name.split(".")[-1] in _BUILDERS or name in _CPP_EXT_LOAD:
        return name
    return ""


def _decorated_memo(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        name = dotted_name(dec if not isinstance(dec, ast.Call)
                           else dec.func)
        if name.split(".")[-1] in _MEMO_DECORATORS:
            return True
    return False


def _keeps_by_hand(fn: ast.FunctionDef, module_names: set[str]) -> bool:
    """A ``global`` the function assigns, or a store into a module-level
    container or into ``self``: its result outlives the call."""
    globals_: set[str] = set()
    stores = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            globals_.update(node.names)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            stores.append(node)
    for node in stores:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id in globals_:
                return True
            if isinstance(t, ast.Subscript):
                base = dotted_name(t.value)
                if base.split(".")[0] in module_names or \
                        base.startswith("self."):
                    return True
            if isinstance(t, ast.Attribute) and \
                    dotted_name(t).startswith("self."):
                return True
    return False


def _module_names(tree: ast.Module) -> set[str]:
    out: set[str] = set()
    for stmt in tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign):
            targets = [stmt.target]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out


class _Visitor(ast.NodeVisitor):
    """Per file: builder call sites with their enclosing function, and
    which functions keep their result (the 'safe' set for callers)."""

    def __init__(self, mod: Module):
        self.mod = mod
        self.module_names = _module_names(mod.tree)
        self.stack: list[ast.AST] = []
        self.sites: list = []          # [qualname, line, builder, safe]
        self.safe: set[str] = set()    # memoized / by-hand / entry quals
        self.visit(mod.tree)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.stack.append(node)
        qual = enclosing_symbol(self.stack)
        if _decorated_memo(node) or node.name in _ENTRY_POINTS or \
                _keeps_by_hand(node, self.module_names):
            self.safe.add(qual)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        name = _builder(node)
        funcs = [s for s in self.stack
                 if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))]
        if name and funcs:
            quals = [enclosing_symbol(self.stack[:self.stack.index(f) + 1])
                     for f in funcs]
            safe = any(q in self.safe for q in quals)
            self.sites.append([quals[-1], node.lineno, name, safe])
        self.generic_visit(node)


@rule
class RecompilationRule(Rule):
    name = "recompile-hazard"
    description = ("kernel libraries built or bound inside a function "
                   "body that runs per call (not memoized, not kernels.py's "
                   "build-once path)")

    def summarize_module(self, module: Module, project: Project):
        if module.relpath.replace("\\", "/").endswith("/kernels.py"):
            return None
        v = _Visitor(module)
        if not v.sites and not v.safe:
            return None
        return {"sites": v.sites, "safe": sorted(v.safe)}

    def finalize_project(self, ctx) -> list:
        data = ctx.data_for(self.name)
        pending = [(rel, site) for rel, d in data.items()
                   for site in d["sites"] if not site[3]]
        if not pending:
            return []
        safe = {(rel, q) for rel, d in data.items() for q in d["safe"]}
        callers: dict[tuple, list] = {}
        for node in ctx.graph.nodes():
            for cand, _site in ctx.graph.callees(node):
                callers.setdefault(cand, []).append(node)
        out = []
        for rel, (qual, line, name, _safe) in sorted(
                pending, key=lambda p: (p[0], p[1][1])):
            who = callers.get((rel, qual), [])
            if who and all(c in safe for c in who):
                continue
            out.append(Violation(
                rule=self.name, path=rel, line=line,
                message=(f"{name}(...) inside '{qual}' builds or binds a "
                         "kernel library on every call — the build/bind "
                         "cache dies with the call; build it once "
                         "(module level, kernels.build_all, or an "
                         "@lru_cache / global-memo loader)"),
                symbol=qual))
        return out
