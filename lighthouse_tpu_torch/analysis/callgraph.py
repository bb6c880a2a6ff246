"""Project-wide call graph: the shared interprocedural substrate.

Every rule that reasons across function or module boundaries builds on
the same three pieces:

- :func:`build_facts` — one pass over a module's AST producing a
  picklable :class:`ModuleFacts` (functions, call sites, imports, jit
  roots). Picklability is load-bearing: facts are computed in worker
  processes and cached by file content hash (``cache.py``), so they must
  survive a round-trip without their ASTs.
- :class:`CallGraph` — resolves call names to (module, qualname) nodes
  through the project's import structure: absolute and relative
  ``from X import name``, ``import X.Y as z`` aliases, same-module
  functions and methods, and ``self.method()`` within a class.
- :meth:`CallGraph.reachable` — BFS used by trace-safety (jit roots),
  and the fixpoint helpers used by lock-order (transitive may-block /
  may-acquire).

Resolution is deliberately name-based and conservative: calls on
arbitrary objects (``self.sync.drive()``) resolve only when the prefix
is an imported module — attribute types are not inferred. Rules built
on the graph under-approximate reachability rather than guess.
"""
from __future__ import annotations

import ast
import dataclasses

#: callables whose *function arguments* are traced/invoked as functions,
#: so a name passed to them is a call edge (scan bodies, cond branches)
HIGHER_ORDER = {"scan", "fori_loop", "while_loop", "cond", "switch",
                "map", "associative_scan", "vmap", "checkpoint", "remat",
                "custom_jvp", "custom_vjp", "partial", "jit", "pmap",
                "shard_map"}

#: host-callback escape hatches: the callable they receive runs on the
#: HOST, outside the trace, so its body is exempt from trace rules and
#: must not become a call edge (ROADMAP minor item; see trace-safety)
CALLBACK_ESCAPES = {"jax.pure_callback", "pure_callback",
                    "jax.io_callback", "io_callback",
                    "jax.debug.callback", "debug.callback",
                    "jax.experimental.io_callback"}

_JIT_WRAPPERS = {"jax.jit", "jit", "jax.pmap", "pmap", "shard_map",
                 "jax.shard_map", "jax.experimental.shard_map.shard_map"}

_MEMO_DECORATORS = {"lru_cache", "cache"}


def dotted_name(node: ast.AST) -> str:
    """'jax.jit' for Attribute/Name chains, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


@dataclasses.dataclass(frozen=True)
class CallSite:
    name: str            # dotted callee as written ('self._submit', 'k.f')
    line: int


@dataclasses.dataclass
class FuncFacts:
    qualname: str        # 'Class.method' / 'func' / 'Class.method.inner'
    line: int
    calls: tuple         # tuple[CallSite, ...]
    is_jit_root: bool = False
    is_memoized: bool = False      # @lru_cache/@cache factory
    builds_jit: bool = False       # body contains a jax.jit/pmap call
    decorators: tuple = ()


@dataclasses.dataclass
class ModuleFacts:
    relpath: str
    funcs: dict          # qualname -> FuncFacts
    #: ``from X import name [as alias]``: alias -> (module, orig, level)
    from_imports: dict
    #: ``import X.Y [as z]``: bound name -> (dotted module, 0)
    module_imports: dict
    #: class name -> tuple of direct base-name strings
    classes: dict


class _FactsVisitor(ast.NodeVisitor):
    """Single AST pass building ModuleFacts for one module."""

    def __init__(self, tree: ast.AST, relpath: str):
        self.relpath = relpath
        self.stack: list[str] = []
        self.funcs: dict[str, FuncFacts] = {}
        self.from_imports: dict[str, tuple] = {}
        self.module_imports: dict[str, tuple] = {}
        self.classes: dict[str, tuple] = {}
        self._calls: dict[str, list[CallSite]] = {}
        self._fn_stack: list[str] = []        # qualnames, innermost last
        # jit(fn) wrapped at call sites, with the wrapping scope so
        # `jit(update)` inside a factory doesn't taint every `update`
        self._wrapped_names: set[tuple[str, str]] = set()
        self.visit(tree)
        for prefix, name in self._wrapped_names:
            scoped = f"{prefix}.{name}" if prefix else name
            if scoped in self.funcs:
                self.funcs[scoped].is_jit_root = True
            elif name in self.funcs:          # module-level fn wrapped later
                self.funcs[name].is_jit_root = True

    # -- imports -------------------------------------------------------------

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for alias in node.names:
            self.from_imports[alias.asname or alias.name] = \
                (mod, alias.name, node.level)

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.asname:
                self.module_imports[alias.asname] = (alias.name, 0)
            else:
                # `import a.b` binds `a`; dotted uses resolve lazily
                root = alias.name.split(".")[0]
                self.module_imports.setdefault(root, (root, 0))

    # -- defs ----------------------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        qual = ".".join(self.stack + [node.name])
        self.classes[qual] = tuple(dotted_name(b) for b in node.bases
                                   if dotted_name(b))
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        qual = ".".join(self.stack + [node.name])
        decos = []
        is_root = False
        memoized = False
        for dec in node.decorator_list:
            dn = dotted_name(dec)
            if isinstance(dec, ast.Call):
                dn = dotted_name(dec.func)
                # @functools.partial(jax.jit, ...)
                if dn.endswith("partial") and dec.args and \
                        dotted_name(dec.args[0]) in _JIT_WRAPPERS:
                    is_root = True
            if dn in _JIT_WRAPPERS:
                is_root = True
            if dn.split(".")[-1] in _MEMO_DECORATORS:
                memoized = True
            decos.append(dn)
        self.funcs[qual] = FuncFacts(
            qualname=qual, line=node.lineno, calls=(),
            is_jit_root=is_root, is_memoized=memoized,
            decorators=tuple(decos))
        self._calls[qual] = []
        self.stack.append(node.name)
        self._fn_stack.append(qual)
        self.generic_visit(node)
        self._fn_stack.pop()
        self.stack.pop()
        self.funcs[qual].calls = tuple(self._calls.pop(qual))

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- calls ---------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        scope = ".".join(self.stack)
        if name in _JIT_WRAPPERS:
            if self._fn_stack:
                self.funcs[self._fn_stack[-1]].builds_jit = True
            for arg in node.args[:1]:
                target = arg
                # jax.jit(functools.partial(f, ...)) / jit(shard_map(f))
                if isinstance(target, ast.Call) and target.args:
                    target = target.args[0]
                tn = dotted_name(target)
                if tn:
                    self._wrapped_names.add((scope, tn.split(".")[-1]))
        if self._fn_stack:
            sites = self._calls[self._fn_stack[-1]]
            if name:
                sites.append(CallSite(name, node.lineno))
                if name in CALLBACK_ESCAPES:
                    # the callback body runs on the host: record the
                    # escape call itself but none of the edges inside it
                    for arg in node.args:
                        self._visit_non_call_parts(arg)
                    for kw in node.keywords:
                        self._visit_non_call_parts(kw.value)
                    return
                if name.split(".")[-1] in HIGHER_ORDER:
                    for arg in node.args:
                        an = dotted_name(arg)
                        if an:
                            sites.append(CallSite(an, node.lineno))
        self.generic_visit(node)

    def _visit_non_call_parts(self, node: ast.AST) -> None:
        """Descend for def/class bookkeeping but collect no call edges
        (used under callback escapes)."""
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested host-callback defs still get indexed (empty
                # call list is fine — they are not trace edges)
                qual = ".".join(self.stack + [sub.name])
                self.funcs.setdefault(qual, FuncFacts(
                    qualname=qual, line=sub.lineno, calls=()))


def build_facts(tree: ast.AST, relpath: str) -> ModuleFacts:
    v = _FactsVisitor(tree, relpath)
    return ModuleFacts(relpath=relpath, funcs=v.funcs,
                       from_imports=v.from_imports,
                       module_imports=v.module_imports,
                       classes=v.classes)


class CallGraph:
    """Name-based call resolution over a set of ModuleFacts.

    Nodes are ``(relpath, qualname)`` pairs. Edges are resolved lazily
    and memoized; ``self_calls`` controls whether ``self.method()``
    resolves within the enclosing class (trace-safety keeps it off to
    stay faithful to its tuned per-file behavior; the concurrency rules
    turn it on).
    """

    def __init__(self, facts: dict):
        self.facts = facts                    # relpath -> ModuleFacts
        self._mod_cache: dict[tuple, str | None] = {}
        self._edge_cache: dict[tuple, tuple] = {}

    # -- module resolution ---------------------------------------------------

    def resolve_module(self, rel: str, dotted: str,
                       level: int = 0) -> str | None:
        """Resolve an import's module to a scanned relpath, or None."""
        key = (rel, dotted, level)
        if key in self._mod_cache:
            return self._mod_cache[key]
        out = self._resolve_module(rel, dotted, level)
        self._mod_cache[key] = out
        return out

    def _resolve_module(self, rel: str, dotted: str,
                        level: int) -> str | None:
        parts = [p for p in dotted.split(".") if p]
        if level > 0:
            base = rel.split("/")[:-1]        # the module's package dir
            if rel.endswith("/__init__.py"):
                base = base                   # package itself
            up = level - 1
            if up > len(base):
                return None
            base = base[:len(base) - up] if up else base
            cands = ["/".join(base + parts)]
        else:
            cands = ["/".join(parts)]
        for cand in cands:
            for suffix in (cand + ".py", cand + "/__init__.py"):
                if suffix in self.facts:
                    return suffix
                # component-aligned suffix match for absolute imports
                # written from the package root (lighthouse_tpu.ops.x)
                for known in self.facts:
                    if known.endswith("/" + suffix):
                        return known
        return None

    # -- call resolution -----------------------------------------------------

    def resolve_call(self, rel: str, caller_qual: str, name: str,
                     self_calls: bool = True) -> list:
        """All (relpath, qualname) candidates a call name may bind to."""
        facts = self.facts.get(rel)
        if facts is None:
            return []
        cands: list[tuple] = []
        if "." not in name:
            # same-module plain functions and loosely-matched methods
            cands += [(rel, q) for q in facts.funcs
                      if q == name or q.endswith("." + name)]
            imp = facts.from_imports.get(name)
            if imp is not None:
                mod, orig, level = imp
                target = self.resolve_module(rel, mod, level)
                if target is not None:
                    tf = self.facts[target].funcs
                    if orig in tf:
                        cands.append((target, orig))
            return cands
        prefix, attr = name.rsplit(".", 1)
        if prefix == "self" or prefix.startswith("self."):
            if not self_calls or prefix != "self":
                return []
            # method on the enclosing class (or an outer class, for
            # nested defs): Class.caller -> Class.attr
            parts = caller_qual.split(".")
            for i in range(len(parts) - 1, 0, -1):
                cand = ".".join(parts[:i]) + "." + attr
                if cand in facts.funcs:
                    return [(rel, cand)]
            return []
        # Class.method / Outer.Inner.method in the same module
        if name in facts.funcs:
            cands.append((rel, name))
        # module-attribute calls through imports
        imp = facts.from_imports.get(prefix)
        if imp is not None:
            mod, orig, level = imp
            mod_path = (mod + "." + orig) if mod else orig
            target = self.resolve_module(rel, mod_path, level)
        else:
            mi = facts.module_imports.get(prefix.split(".")[0])
            if mi is not None:
                root, _lvl = mi
                rest = prefix.split(".")[1:]
                mod_path = ".".join([root] + rest) \
                    if prefix.split(".")[0] != root else prefix
                target = self.resolve_module(rel, mod_path, 0)
            else:
                target = self.resolve_module(rel, prefix, 0)
        if target is not None and attr in self.facts[target].funcs:
            cands.append((target, attr))
        return cands

    def callees(self, node: tuple, self_calls: bool = True,
                skip_call=None) -> list:
        """Resolved callee nodes with the originating CallSite."""
        key = (node, self_calls)
        cached = self._edge_cache.get(key)
        if cached is not None and skip_call is None:
            return list(cached)
        rel, qual = node
        facts = self.facts.get(rel)
        fn = facts.funcs.get(qual) if facts else None
        if fn is None:
            return []
        out = []
        for site in fn.calls:
            if skip_call is not None and skip_call(site.name):
                continue
            for cand in self.resolve_call(rel, qual, site.name,
                                          self_calls=self_calls):
                out.append((cand, site))
        if skip_call is None:
            self._edge_cache[key] = tuple(out)
        return out

    def reachable(self, roots, self_calls: bool = True,
                  skip_call=None, skip_module=None) -> set:
        """BFS closure over resolved call edges from ``roots``."""
        seen = set(roots)
        work = list(roots)
        while work:
            node = work.pop()
            for cand, _site in self.callees(node, self_calls=self_calls,
                                            skip_call=skip_call):
                if skip_module is not None and skip_module(cand[0]):
                    continue
                if cand not in seen:
                    seen.add(cand)
                    work.append(cand)
        return seen

    def nodes(self):
        for rel, facts in self.facts.items():
            for qual in facts.funcs:
                yield (rel, qual)

    def transitive_closure(self, seeds, self_calls: bool = True) -> set:
        """All nodes from which some seed node is reachable (reverse
        reachability) — the fixpoint lock-order uses for may-block."""
        seeds = set(seeds)
        # build reverse edges once over the full graph
        rev: dict[tuple, list] = {}
        for node in self.nodes():
            for cand, _site in self.callees(node, self_calls=self_calls):
                rev.setdefault(cand, []).append(node)
        out = set(seeds)
        work = list(seeds)
        while work:
            node = work.pop()
            for caller in rev.get(node, ()):
                if caller not in out:
                    out.add(caller)
                    work.append(caller)
        return out
