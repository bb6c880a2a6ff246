"""shutdown-order: submit()/spawn() reachable after stop() without a guard.

Generalizes the executor-after-shutdown race class (fixed by hand in the sync manager, network service and yamux): a concurrent
service object whose ``stop()``/``shutdown()``/``close()`` can run on
one thread while another thread is still inside a method that calls
``submit()``/``spawn()`` MUST check a ``_stopping``-style flag on that
path, or the submit lands in a torn-down executor
(``RuntimeError: cannot schedule new futures after shutdown``) — or,
worse, silently resurrects work mid-teardown.

Scope: the concurrent service layer named by the audit surface —
``beacon_processor/``, ``network/``, ``sync/``, ``execution_layer/``,
``testing/`` (the simulator drives those services from its own threads)
(plus this rule's fixture).

A submit site passes when any of:

1. the enclosing method checks a guard flag before the site
   (``if self._stopping: return`` / ``while not self._stop:`` /
   ``self._closed`` / ``Event.is_set``-style — any test referencing a
   stop-ish boolean or Event attribute of the class),
2. the call goes through a same-class method that checks a guard
   (``self._submit(...)`` where ``_submit`` rejects after close — the
   sync manager's ``_RealSyncContext._submit`` pattern), resolved via
   the shared call graph,
3. the method is lifecycle-exempt (``__init__``/``start*``: ordered
   before any stop by construction) or is itself the stop path.

A class with NO stop method is still in scope when it stores an
*injected* submit callable (``self._submit = submit`` taken from the
constructor — beacon_processor/reprocess.py's shape): the callable's
owner can stop while this object lives, and nothing on this class can
ever sever it, so every unguarded call is flagged.
"""
from __future__ import annotations

import ast
import re

from ..engine import Module, Project, Rule, Violation, dotted_name, rule

_SCOPED = ("beacon_processor/", "network/", "sync/", "execution_layer/",
           "testing/", "shutdown_order")
#: method names that constitute the object's stop path
_STOP_METHODS = re.compile(r"^(stop|shutdown|close|halt|teardown)")
#: attribute names that read as lifecycle guard flags
_GUARD_ATTR = re.compile(r"stop|clos|shut|halt|run|alive|live|active|done",
                         re.IGNORECASE)
#: call names that enqueue work onto an executor/thread
_SUBMITISH = re.compile(r"^_?(submit|spawn)", re.IGNORECASE)
_EXEMPT = re.compile(r"^(__init__|__post_init__|__enter__|start)")


def _self_attrs(node: ast.AST):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and \
                isinstance(sub.value, ast.Name) and sub.value.id == "self":
            yield sub.attr


class _MethodScan(ast.NodeVisitor):
    """Guard-check lines and submit sites for one method body."""

    def __init__(self, guard_attrs: set):
        self.guard_attrs = guard_attrs
        self.guard_lines: list[int] = []
        self.sites: list = []        # [call_name, line]

    def _test_guards(self, test: ast.AST) -> bool:
        return any(a in self.guard_attrs for a in _self_attrs(test))

    def visit_If(self, node: ast.If) -> None:
        if self._test_guards(node.test):
            self.guard_lines.append(node.lineno)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        if self._test_guards(node.test):
            self.guard_lines.append(node.lineno)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        if self._test_guards(node.test):
            self.guard_lines.append(node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        last = name.split(".")[-1] if name else ""
        if name.startswith("self.") and _SUBMITISH.match(last):
            self.sites.append([name, node.lineno])
        elif "." in name and last in ("submit", "spawn"):
            self.sites.append([name, node.lineno])
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return   # nested defs (callbacks) run on their own schedule

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


@rule
class ShutdownOrderRule(Rule):
    name = "shutdown-order"
    description = ("submit()/spawn() reachable after the owner's "
                   "stop()/shutdown() without a _stopping-style guard "
                   "(the executor-after-shutdown race class)")

    # -- per-file (cached) stage ---------------------------------------------

    def summarize_module(self, module: Module, project: Project):
        rel = module.relpath
        if not any(part in rel for part in _SCOPED):
            return None
        classes = {}
        for cls in [n for n in ast.walk(module.tree)
                    if isinstance(n, ast.ClassDef)]:
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            has_stop = any(_STOP_METHODS.match(m.name) for m in methods)
            guard_attrs, injected = set(), False
            for node in ast.walk(cls):
                if not isinstance(node, ast.Assign):
                    continue
                value_is_flag = (
                    isinstance(node.value, ast.Constant) and
                    isinstance(node.value.value, bool)) or (
                    isinstance(node.value, ast.Call) and
                    dotted_name(node.value.func).split(".")[-1] == "Event")
                for t in node.targets:
                    if not (isinstance(t, ast.Attribute) and
                            isinstance(t.value, ast.Name) and
                            t.value.id == "self"):
                        continue
                    if value_is_flag and _GUARD_ATTR.search(t.attr):
                        guard_attrs.add(t.attr)
                    if isinstance(node.value, ast.Name) and \
                            _SUBMITISH.match(t.attr):
                        injected = True
            scans = {}
            for m in methods:
                scan = _MethodScan(guard_attrs)
                for stmt in m.body:
                    scan.visit(stmt)
                if scan.sites or scan.guard_lines:
                    scans[m.name] = {"guard_lines": scan.guard_lines,
                                     "sites": scan.sites}
            if not any(s["sites"] for s in scans.values()):
                continue
            if not has_stop and not injected:
                continue             # no lifecycle to race against
            classes[cls.name] = {
                "has_stop": has_stop,
                "guards": sorted(guard_attrs),
                "injected": injected,
                "methods": scans,
            }
        return {"classes": classes} if classes else None

    # -- cross-file stage -----------------------------------------------------

    def finalize_project(self, ctx) -> list:
        out = []
        for rel, d in ctx.data_for(self.name).items():
            for cls, info in d["classes"].items():
                guarded_methods = {
                    m for m, s in info["methods"].items()
                    if s["guard_lines"]}
                for mname, scan in info["methods"].items():
                    if _EXEMPT.match(mname) or _STOP_METHODS.match(mname):
                        continue
                    for call, line in scan["sites"]:
                        if any(g <= line for g in scan["guard_lines"]):
                            continue
                        # self._submit(...) through a guarded same-class
                        # method (resolved on the shared call graph)
                        cands = ctx.graph.resolve_call(
                            rel, f"{cls}.{mname}", call)
                        if any(q.startswith(cls + ".") and
                               q.split(".")[-1] in guarded_methods
                               for _, q in cands):
                            continue
                        if info["has_stop"]:
                            why = (f"'{cls}' has a stop path but this "
                                   f"'{call}()' runs without a "
                                   f"{info['guards'] or '_stopping'}"
                                   " check — it races the teardown")
                        else:
                            why = (f"'{cls}' holds an injected submit "
                                   f"callable and no stop/close method: "
                                   f"'{call}()' outlives its owner's "
                                   "shutdown — add a close() + guard "
                                   "flag wired into the owner's stop()")
                        out.append(Violation(
                            rule=self.name, path=rel, line=line,
                            message=why, symbol=f"{cls}.{mname}"))
        return out
