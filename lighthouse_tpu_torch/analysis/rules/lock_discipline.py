"""lock-discipline: attributes guarded in one method, unguarded in another.

Targets the concurrent service layer (``beacon_processor/``,
``network/``, ``utils/slot_clock.py``): a class that takes the trouble
to guard ``self.x`` with ``with self._lock:`` in one method but writes
``self.x`` bare in another has torn its own invariant — the bare write
races every guarded reader; shutdown races take exactly this shape.

Two findings:
1. guarded-elsewhere: ``self.x`` is written under a lock in some method
   but plainly assigned outside any lock in another (``__init__`` is
   exempt — construction precedes sharing).
2. unguarded read-modify-write: ``self.x += ...`` outside any lock in a
   class that owns a lock. ``+=`` is a read+write pair, so it loses
   updates against *any* concurrent writer; if the class is threaded
   enough to own a lock, the counter belongs under it.
"""
from __future__ import annotations

import ast

from ..engine import Module, Project, Rule, dotted_name, rule

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition",
               "Lock", "RLock", "Condition"}
#: construction/setup methods where unguarded writes are fine
_EXEMPT_METHODS = {"__init__", "__post_init__", "__new__"}


def _is_lock_ctor(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and dotted_name(node.func) in _LOCK_CTORS


def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _MethodScan(ast.NodeVisitor):
    """Record guarded/unguarded self-attribute writes in one method."""

    def __init__(self, lock_attrs: set[str]):
        self.lock_attrs = lock_attrs
        self.depth = 0                      # nested `with self._lock:` depth
        self.guarded_writes: set[str] = set()
        self.unguarded_writes: dict[str, ast.AST] = {}
        self.unguarded_augs: dict[str, ast.AST] = {}

    def _locked_item(self, item: ast.withitem) -> bool:
        expr = item.context_expr
        if isinstance(expr, ast.Call):      # e.g. self._cv (Condition call?)
            expr = expr.func
        attr = _self_attr(expr)
        return attr is not None and attr in self.lock_attrs

    def visit_With(self, node: ast.With) -> None:
        locked = any(self._locked_item(i) for i in node.items)
        if locked:
            self.depth += 1
        self.generic_visit(node)
        if locked:
            self.depth -= 1

    def _record_write(self, target: ast.AST, node: ast.AST,
                      aug: bool) -> None:
        attr = _self_attr(target)
        if attr is None or attr in self.lock_attrs:
            return
        if self.depth > 0:
            self.guarded_writes.add(attr)
        elif aug:
            self.unguarded_augs.setdefault(attr, node)
        else:
            self.unguarded_writes.setdefault(attr, node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_write(t, node, aug=False)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_write(node.target, node, aug=False)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write(node.target, node, aug=True)
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return  # nested defs (callbacks) have their own threading story

    visit_AsyncFunctionDef = visit_FunctionDef


@rule
class LockDisciplineRule(Rule):
    name = "lock-discipline"
    description = ("self attributes written under a lock in one method "
                   "but written bare in another; unguarded += in "
                   "lock-owning classes")

    def check_module(self, module: Module, project: Project) -> list:
        out = []
        for cls in [n for n in ast.walk(module.tree)
                    if isinstance(n, ast.ClassDef)]:
            lock_attrs = set()
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign) and \
                        _is_lock_ctor(node.value):
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            lock_attrs.add(attr)
            if not lock_attrs:
                continue
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            scans = {}
            for m in methods:
                scan = _MethodScan(lock_attrs)
                for stmt in m.body:
                    scan.visit(stmt)
                scans[m.name] = scan
            guarded_anywhere = set()
            for scan in scans.values():
                guarded_anywhere |= scan.guarded_writes
            for mname, scan in scans.items():
                if mname in _EXEMPT_METHODS:
                    continue
                for attr, node in scan.unguarded_writes.items():
                    if attr in guarded_anywhere:
                        out.append(module.violation(
                            self.name, node,
                            f"'{cls.name}.{attr}' is written under "
                            f"{sorted(lock_attrs)} elsewhere but "
                            f"assigned bare in '{mname}' — take the "
                            "lock or document the ownership transfer",
                            symbol=f"{cls.name}.{mname}"))
                for attr, node in scan.unguarded_augs.items():
                    out.append(module.violation(
                        self.name, node,
                        f"unguarded '{cls.name}.{attr} "
                        f"{'+'}= ...' in '{mname}': read-modify-write "
                        "races every concurrent writer — hold "
                        f"{sorted(lock_attrs)} around it",
                        symbol=f"{cls.name}.{mname}"))
        return out
