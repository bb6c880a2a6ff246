"""thread-lifecycle: every started thread needs a join or shutdown path.

The usual source of unhandled thread exceptions: fire-and-forget daemon
threads (``threading.Thread(target=...).start()`` with the object
dropped) kept running through teardown and raised into closed sockets
and shut-down executors. A thread is accounted for when:

- it is stored (``self._t = Thread(...)``/local) **and** that name is
  ``.join()``-ed somewhere in the module (directly or via a local
  alias, or by iterating a list it was appended to), or
- it is handed to a tracker (appended to a joined list, passed to a
  registry call, returned to the caller), or
- it is spawned through a managed API (``Environment.spawn``,
  ``utils.threads.ThreadGroup.spawn``) — those helpers own the join.

Everything else is flagged: the fix is usually
``lighthouse_tpu_torch.utils.threads.ThreadGroup`` (spawn + join_all at stop).
``threading.Timer`` counts too — an uncancelled timer is a thread that
outlives its service.
"""
from __future__ import annotations

import ast

from ..engine import Module, Project, Rule, dotted_name, rule

_THREAD_CTORS = {"threading.Thread", "Thread", "threading.Timer", "Timer"}


def _is_thread_ctor(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and \
        dotted_name(node.func) in _THREAD_CTORS


def _target_path(node: ast.AST) -> str | None:
    """'self._thread' / 't' for simple assignment targets."""
    name = dotted_name(node)
    return name or None


class _ModuleScan(ast.NodeVisitor):
    def __init__(self) -> None:
        #: dotted receiver paths of .join()/.cancel() calls
        self.joined: set[str] = set()
        #: receiver paths of .append(thread-ish) targets, path -> thread node
        self.alias: dict[str, str] = {}      # local alias -> source path
        self.visit_calls: list[ast.Call] = []
        #: container paths iterated with a join inside: for t in X: t.join()
        self.joined_containers: set[str] = set()

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("join", "cancel"):
            path = _target_path(node.func.value)
            if path:
                self.joined.add(path)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # track `t = self._hb_thread` style aliases
        src = _target_path(node.value)
        if src:
            for t in node.targets:
                dst = _target_path(t)
                if dst:
                    self.alias[dst] = src
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        var = _target_path(node.target)
        container = _target_path(node.iter)
        if var and container:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in ("join", "cancel") and \
                        _target_path(sub.func.value) == var:
                    self.joined_containers.add(container)
        self.generic_visit(node)


def _resolve_joined(path: str, scan: _ModuleScan) -> bool:
    if path in scan.joined or path in scan.joined_containers:
        return True
    # one alias hop: t = self._thread; t.join()
    for alias, src in scan.alias.items():
        if src == path and (alias in scan.joined or
                            alias in scan.joined_containers):
            return True
    return False


@rule
class ThreadLifecycleRule(Rule):
    name = "thread-lifecycle"
    description = ("threads started without a join/cancel or shutdown "
                   "registration")

    def check_module(self, module: Module, project: Project) -> list:
        scan = _ModuleScan()
        scan.visit(module.tree)
        out = []
        for node in ast.walk(module.tree):
            # fire-and-forget: threading.Thread(...).start()
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "start" and \
                    _is_thread_ctor(node.func.value):
                out.append(module.violation(
                    self.name, node,
                    "fire-and-forget thread: the object is dropped at "
                    ".start(), so nothing can join or stop it at "
                    "shutdown — keep a reference and join it, or spawn "
                    "via utils.threads.ThreadGroup",
                    symbol=self._symbol(module, node)))
                continue
            if not isinstance(node, ast.Assign) or \
                    not _is_thread_ctor(node.value):
                continue
            stored: list[str] = []
            for t in node.targets:
                p = _target_path(t)
                if p:
                    stored.append(p)
            if not stored:
                continue
            accounted = False
            for p in stored:
                if _resolve_joined(p, scan):
                    accounted = True
                # appended to a joined container, handed to a tracker
                # (ThreadGroup.track), or returned: lifecycle owned
                # elsewhere
                short = p.split(".")[-1]
                for sub in ast.walk(module.tree):
                    if isinstance(sub, ast.Call) and \
                            isinstance(sub.func, ast.Attribute) and any(
                                dotted_name(a) == p for a in sub.args):
                        if sub.func.attr in ("track", "register"):
                            accounted = True
                        elif sub.func.attr == "append":
                            container = _target_path(sub.func.value)
                            if container and _resolve_joined(container,
                                                             scan):
                                accounted = True
                    if isinstance(sub, ast.Return) and \
                            sub.value is not None and \
                            dotted_name(sub.value) in (p, short):
                        accounted = True
            if not accounted:
                out.append(module.violation(
                    self.name, node,
                    f"thread stored in '{stored[0]}' is never joined or "
                    "cancelled in this module — wire it into the "
                    "service's stop path (join with a timeout) or spawn "
                    "via utils.threads.ThreadGroup",
                    symbol=self._symbol(module, node)))
        return out

    @staticmethod
    def _symbol(module: Module, target: ast.AST) -> str:
        """Enclosing def/class chain found by a positional walk."""
        best: list[str] = []

        def descend(node: ast.AST, chain: list[str]) -> bool:
            for child in ast.iter_child_nodes(node):
                name = child.name if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)) else None
                if child is target:
                    best[:] = chain + ([name] if name else [])
                    return True
                if descend(child, chain + ([name] if name else [])):
                    return True
            return False

        descend(module.tree, [])
        return ".".join(n for n in best if n)
