"""lock-order: acquisition-order cycles and blocking calls under a lock.

The Security Review of Ethereum Beacon Clients (PAPERS.md) puts
lock-held blocking and inconsistent acquisition order at the top of the
real-client deadlock class: thread A holds lock 1 and wants lock 2,
thread B holds 2 and wants 1 — or a thread parks forever in ``join()``/
``Future.result()``/``sock.recv()`` while every other thread queues up
behind the lock it still holds.

Built on the shared interprocedural engine (v2):

1. the cached per-file stage finds each class's/module's lock objects
   (``threading.Lock/RLock/Condition/Semaphore``) and records, per
   function: acquisitions (``with self._lock:``, ``.acquire()``), the
   acquisition *edges* (lock B taken while A is held), direct blocking
   calls with the locks held at the site, and every call made under a
   lock.
2. the cross-file stage stitches the edges into one project-wide
   lock-acquisition graph — including edges created *through* calls
   (caller holds A, callee acquires B) — and flags every acquisition
   site on a cycle. It also propagates **may-block** through the call
   graph: a call made under a lock to a function that transitively
   reaches ``join()``/``result()``/``recv()``/``accept()``/``wait()``
   is flagged at the call site.

Deliberate under-approximations (documented, not accidental):
``Condition.wait`` on the lock held at the site is the sanctioned
producer/consumer pattern (wait releases that lock) and is neither a
local violation nor a may-block source; ``time.sleep`` is flagged when
directly under a lock but is too viral to propagate through the call
graph (every retry loop sleeps); ``str.join``/``os.path.join`` are
filtered by argument shape (``Thread.join`` takes no args or a numeric
timeout, ``str.join`` always takes an iterable).
"""
from __future__ import annotations

import ast

from ..engine import Module, Project, Rule, Violation, dotted_name, rule

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
#: attribute calls that park the calling thread until someone else acts
_BLOCKING_ATTRS = {"result", "recv", "recv_into", "recvfrom", "accept"}
#: waits that are exempt when their receiver is the lock held at the site
_WAITISH = {"wait", "wait_for"}
#: blocking shapes too common to propagate interprocedurally
_LOCAL_ONLY = {"time.sleep", "sleep"}


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    return dotted_name(node.func).split(".")[-1] in _LOCK_CTORS


def _is_thread_join(node: ast.Call) -> bool:
    """`.join()` that can be Thread/Process join, not str/path join:
    no positional args, or a single numeric timeout, or a timeout kw."""
    recv = dotted_name(node.func.value) if \
        isinstance(node.func, ast.Attribute) else ""
    if not recv or recv.split(".")[-1] == "path":
        return False                 # "sep".join(...) / os.path.join(...)
    if not node.args:
        return True
    if len(node.args) == 1 and not node.keywords:
        a = node.args[0]
        return isinstance(a, ast.Constant) and \
            isinstance(a.value, (int, float))
    return any(kw.arg == "timeout" for kw in node.keywords)


class _FuncScan(ast.NodeVisitor):
    """One function body: held-lock stack + the four event streams."""

    def __init__(self, lock_id, relpath: str):
        self._lock_id = lock_id      # callable: expr -> lock id or None
        self.relpath = relpath
        self.held: list[str] = []
        self.acquires: list = []     # [lock_id, line]
        self.acq_edges: list = []    # [held(list), lock_id, line]
        self.blocking: list = []     # [label, line, held(list)]
        self.calls_under: list = []  # [call_name, line, held(list)]

    def _acquire(self, lock: str, line: int) -> None:
        self.acquires.append([lock, line])
        held = [h for h in self.held if h != lock]
        if held:
            self.acq_edges.append([held, lock, line])

    def visit_With(self, node: ast.With) -> None:
        taken = []
        for item in node.items:
            lock = self._lock_id(item.context_expr)
            if lock is not None:
                self._acquire(lock, node.lineno)
                taken.append(lock)
        self.held.extend(taken)
        for stmt in node.body:
            self.visit(stmt)
        del self.held[len(self.held) - len(taken):]

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else ""
        if attr == "acquire":
            lock = self._lock_id(node.func.value)
            if lock is not None:
                self._acquire(lock, node.lineno)
        label = None
        if attr == "join" and _is_thread_join(node):
            label = f".{attr}()"
        elif attr in _BLOCKING_ATTRS:
            label = f".{attr}()"
        elif attr in _WAITISH:
            recv = self._lock_id(node.func.value)
            if recv is None or recv not in self.held:
                label = f".{attr}()"  # Event.wait / foreign-lock wait
        elif name in _LOCAL_ONLY:
            label = f"{name}()"
        if label is not None:
            self.blocking.append([label, node.lineno, list(self.held)])
        elif name and self.held:
            self.calls_under.append([name, node.lineno, list(self.held)])
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return   # nested defs run later, on their own thread/stack

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _short(lock_id: str) -> str:
    return lock_id.split("::", 1)[-1]


@rule
class LockOrderRule(Rule):
    name = "lock-order"
    description = ("lock-acquisition cycles across classes/modules and "
                   "blocking calls (join/result/recv/wait) made while "
                   "holding a lock")

    # -- per-file (cached) stage ---------------------------------------------

    def summarize_module(self, module: Module, project: Project):
        rel = module.relpath
        class_locks: dict[str, set] = {}
        stack: list[str] = []

        def collect_classes(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    stack.append(child.name)
                    qual = ".".join(stack)
                    attrs = set()
                    for sub in ast.walk(child):
                        if isinstance(sub, ast.Assign) and \
                                _is_lock_ctor(sub.value):
                            for t in sub.targets:
                                if isinstance(t, ast.Attribute) and \
                                        isinstance(t.value, ast.Name) and \
                                        t.value.id == "self":
                                    attrs.add(t.attr)
                    if attrs:
                        class_locks[qual] = attrs
                    collect_classes(child)
                    stack.pop()
                elif isinstance(child,
                                (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue

        collect_classes(module.tree)
        module_locks = set()
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        module_locks.add(t.id)

        funcs: dict[str, dict] = {}

        def scan_functions(node, prefix, cls_qual):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    scan_functions(child, prefix + [child.name],
                                   ".".join(prefix + [child.name]))
                elif isinstance(child,
                                (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = ".".join(prefix + [child.name])

                    def lock_id(expr, _cls=cls_qual):
                        d = dotted_name(expr)
                        if d.startswith("self.") and d.count(".") == 1 \
                                and _cls:
                            attr = d.split(".", 1)[1]
                            if attr in class_locks.get(_cls, ()):
                                return f"{rel}::{_cls}.{attr}"
                        elif d in module_locks:
                            return f"{rel}::{d}"
                        return None

                    scan = _FuncScan(lock_id, rel)
                    for stmt in child.body:
                        scan.visit(stmt)
                    if scan.acquires or scan.blocking or scan.calls_under:
                        funcs[qual] = {
                            "acquires": scan.acquires,
                            "acq_edges": scan.acq_edges,
                            "blocking": scan.blocking,
                            "calls_under": scan.calls_under,
                        }
                    scan_functions(child, prefix + [child.name], cls_qual)

        scan_functions(module.tree, [], None)
        return {"funcs": funcs} if funcs else None

    # -- cross-file stage -----------------------------------------------------

    def finalize_project(self, ctx) -> list:
        data = ctx.data_for(self.name)
        graph = ctx.graph
        out = []

        def flag(rel, line, qual, message):
            out.append(Violation(rule=self.name, path=rel, line=line,
                                 message=message, symbol=qual))

        # 1. direct blocking calls made while holding a lock
        flagged_lines = set()
        may_block_base = set()
        for rel, d in data.items():
            for qual, f in d["funcs"].items():
                for label, line, held in f["blocking"]:
                    propagates = not any(label.startswith(loc)
                                         for loc in _LOCAL_ONLY)
                    if propagates:
                        may_block_base.add((rel, qual))
                    if held:
                        flag(rel, line, qual,
                             f"blocking {label} while holding "
                             f"{sorted(_short(h) for h in held)} — every "
                             "thread queuing on the lock stalls behind "
                             "this wait; release the lock first")
                        flagged_lines.add((rel, line))

        # 2. calls under a lock to functions that may transitively block
        may_block = graph.transitive_closure(may_block_base)
        for rel, d in data.items():
            for qual, f in d["funcs"].items():
                for call, line, held in f["calls_under"]:
                    if (rel, line) in flagged_lines:
                        continue
                    cands = graph.resolve_call(rel, qual, call)
                    hit = [c for c in cands if c in may_block]
                    if hit:
                        tgt = hit[0][1]
                        flag(rel, line, qual,
                             f"'{call}()' can reach a blocking "
                             f"join/result/recv/wait (via '{tgt}') while "
                             f"holding "
                             f"{sorted(_short(h) for h in held)}")
                        flagged_lines.add((rel, line))

        # 3. the project-wide lock-acquisition graph + cycle detection
        #    direct edges from with-nesting, indirect edges through calls
        acq_of: dict[tuple, set] = {}
        for rel, d in data.items():
            for qual, f in d["funcs"].items():
                acq_of[(rel, qual)] = {a for a, _ in f["acquires"]}

        def callee_acquires(node):
            total = set()
            for n in graph.reachable({node}):
                total |= acq_of.get(n, set())
            return total

        edges: dict[str, set] = {}
        sites: list = []            # (held_lock, acquired, rel, line, qual)
        for rel, d in data.items():
            for qual, f in d["funcs"].items():
                for held, lock, line in f["acq_edges"]:
                    for h in held:
                        edges.setdefault(h, set()).add(lock)
                        sites.append((h, lock, rel, line, qual))
                for call, line, held in f["calls_under"]:
                    for cand in graph.resolve_call(rel, qual, call):
                        for lock in callee_acquires(cand):
                            for h in held:
                                if h == lock:
                                    continue
                                edges.setdefault(h, set()).add(lock)
                                sites.append((h, lock, rel, line, qual))

        def reaches(src: str, dst: str) -> bool:
            seen, work = {src}, [src]
            while work:
                n = work.pop()
                if n == dst:
                    return True
                for m in edges.get(n, ()):
                    if m not in seen:
                        seen.add(m)
                        work.append(m)
            return False

        cycle_flagged = set()
        for h, lock, rel, line, qual in sites:
            if (rel, line, h, lock) in cycle_flagged:
                continue
            if reaches(lock, h):
                cycle_flagged.add((rel, line, h, lock))
                flag(rel, line, qual,
                     f"lock-order cycle: acquiring '{_short(lock)}' "
                     f"while holding '{_short(h)}', but another path "
                     f"acquires '{_short(h)}' while holding "
                     f"'{_short(lock)}' — potential deadlock; pick one "
                     "global order")
        return out
