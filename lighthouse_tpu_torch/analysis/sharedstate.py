"""graftrace shared-state model: which classes cross thread boundaries,
and with which locks each ``self.<attr>`` access is made.

This is the v3 substrate under the ``data-race`` rule and the runtime
lock sanitizer (``locksan.py``).  Two pieces:

- :func:`scan_module` — one AST pass over a module producing picklable
  per-class facts: declared lock attributes, per-method attribute
  accesses annotated with the lockset held at the access, in-class
  ``self.method()`` call sites (with locksets, for lockset
  inheritance), check-then-act candidates, and the module's *escape
  sites* (function references handed to ``spawn``/``submit``/
  ``Thread(target=...)``/``Work(run=...)``/``add_listener`` — the
  places where control crosses a thread boundary).
- :func:`build_model` — the cross-file stage: resolves every escape
  site through the shared call graph to a concrete method, marks
  the owning class *thread-seeded*, closes the entry set over in-class
  self-calls, computes inherited locksets for private helpers (a
  ``_helper`` only ever called under ``self._lock`` inherits that
  lock), and classifies every attribute of every shared class.

Deliberate under-approximations (documented, load-bearing):

- **attribute granularity** — container *mutations* through a read
  (``self.queue.append(x)``) are reads of the binding; only rebinding
  (``self.queue = []``) is a write.  Rationale: the dominant racy shape
  in this codebase is torn scalar/dict-binding state, and flagging
  every container touch would drown the signal.
- **flag publishes are safe** — a write whose value is a literal
  ``True``/``False`` is an atomic monotonic publish under the GIL
  (``self._stopping = True``); shutdown-order owns flag *semantics*.
- **sync objects are safe** — attributes bound to
  Lock/RLock/Condition/Semaphore/Event/Queue constructors are
  internally synchronized; rebinding them outside ``__init__`` is still
  a write of the binding.
- **unlocked reads alone never fire** — a bare read of a guarded attr
  is an atomic snapshot under the GIL; it only becomes a finding when
  it *feeds a write decision* (check-then-act).
- **nested defs and lambdas are skipped** — callbacks have their own
  threading story (thread-lifecycle / shutdown-order cover them).
"""
from __future__ import annotations

import ast
import dataclasses
import re

from .callgraph import CallGraph, dotted_name

#: ctor names whose result is a lock usable as a ``with`` guard
LOCK_CTORS = {"Lock", "RLock", "Condition"}

#: ctor names whose result is internally synchronized (never a race to
#: touch through a stable binding)
SYNC_CTORS = LOCK_CTORS | {
    "Semaphore", "BoundedSemaphore", "Event", "Barrier", "local",
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
}

#: callees whose positional function argument crosses a thread boundary
#: (name -> index of the callable argument)
ESCAPE_POSITIONAL = {"spawn": 0, "submit": 0, "Timer": 1,
                     "start_new_thread": 0, "add_listener": 1,
                     "call_soon_threadsafe": 0, "run_in_executor": 1}

#: keyword arguments that carry a thread-crossing callable on ANY call
#: (threading.Thread(target=...), Work(run=...), Timer(function=...))
ESCAPE_KEYWORDS = ("target", "run", "function")

_INIT_METHODS = {"__init__", "__post_init__", "__new__", "__set_name__"}

_PRIVATE = re.compile(r"^_(?!_)")        # _name but not __dunder__


def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _ctor_last(node: ast.AST) -> str:
    if isinstance(node, ast.Call):
        return dotted_name(node.func).split(".")[-1]
    return ""


def _is_flag_value(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, bool)


@dataclasses.dataclass
class Access:
    """One ``self.<attr>`` touch: r(ead) / w(rite) / a(ug rmw) /
    f(lag publish)."""
    attr: str
    kind: str
    line: int
    locks: tuple


class _MethodScan(ast.NodeVisitor):
    """Accesses + self-call sites + check-then-act candidates for one
    method body, with the held-lock stack threaded through."""

    def __init__(self, lock_attrs: set, method_names: set):
        self.lock_attrs = lock_attrs
        self.method_names = method_names
        self.held: list[str] = []
        self.acc: list = []          # [attr, kind, line, [locks]]
        self.calls: list = []        # [callee_attr, line, [locks]]
        self.cta: list = []          # [attr, line]

    # -- locks ---------------------------------------------------------------

    def _lock_of(self, expr: ast.AST) -> str | None:
        attr = _self_attr(expr)
        if attr is not None and attr in self.lock_attrs:
            return attr
        return None

    def visit_With(self, node: ast.With) -> None:
        taken = []
        for item in node.items:
            lock = self._lock_of(item.context_expr)
            if lock is not None and lock not in self.held:
                taken.append(lock)
        self.held.extend(taken)
        for item in node.items:
            if self._lock_of(item.context_expr) is None:
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        del self.held[len(self.held) - len(taken):]

    visit_AsyncWith = visit_With

    # -- accesses ------------------------------------------------------------

    def _record(self, attr: str, kind: str, line: int) -> None:
        if attr in self.lock_attrs:
            return
        self.acc.append([attr, kind, line, sorted(self.held)])

    def _record_target(self, target: ast.AST, line: int,
                       flag: bool) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_target(elt, line, flag=False)
            return
        attr = _self_attr(target)
        if attr is not None:
            self._record(attr, "f" if flag else "w", line)
        else:
            # self.d[k] = v mutates through a READ of the binding
            self.visit(target)

    def visit_Assign(self, node: ast.Assign) -> None:
        flag = _is_flag_value(node.value)
        for t in node.targets:
            self._record_target(t, node.lineno, flag)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target, node.lineno,
                                _is_flag_value(node.value))
            self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = _self_attr(node.target)
        if attr is not None:
            self._record(attr, "a", node.lineno)
        else:
            self.visit(node.target)
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            attr = _self_attr(t)
            if attr is not None:
                self._record(attr, "w", node.lineno)
            else:
                self.visit(t)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._record(attr, "r", node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        attr = _self_attr(node.func)
        if attr is not None and attr in self.method_names:
            # a self.method() call edge, not a data access
            self.calls.append([attr, node.lineno, sorted(self.held)])
        else:
            self.visit(node.func)
        for arg in node.args:
            self.visit(arg)
        for kw in node.keywords:
            self.visit(kw.value)

    # -- check-then-act ------------------------------------------------------

    def visit_If(self, node: ast.If) -> None:
        if not self.held:
            reads = {a for sub in ast.walk(node.test)
                     if (a := _self_attr(sub)) is not None
                     and isinstance(sub.ctx, ast.Load)
                     and a not in self.lock_attrs}
            if reads:
                writes = self._branch_writes(node.body)
                rechecked = self._relocked_tests(node.body)
                for attr in sorted(reads & writes - rechecked):
                    self.cta.append([attr, node.lineno])
        self.generic_visit(node)

    def _branch_writes(self, body: list) -> set:
        out = set()
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)):
                    continue
                if isinstance(sub, ast.Assign):
                    targets = sub.targets
                elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)):
                    targets = [sub.target]
                else:
                    continue
                for t in targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        out.add(attr)
        return out

    def _relocked_tests(self, body: list) -> set:
        """Attrs re-tested under a lock inside the branch: the
        double-checked pattern — the unlocked outer test is a fast
        path, the locked re-check decides (safe under the GIL)."""
        out = set()
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.With) and \
                        any(self._lock_of(i.context_expr) is not None
                            for i in sub.items):
                    for inner in sub.body:
                        for n in ast.walk(inner):
                            if isinstance(n, ast.If):
                                for t in ast.walk(n.test):
                                    a = _self_attr(t)
                                    if a is not None:
                                        out.add(a)
        return out

    # -- scope fences --------------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return            # nested defs run on their own thread/schedule

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return


def _escape_args(node: ast.Call) -> list[str]:
    """Dotted names of callables this call ships across a thread
    boundary (empty when it is not an escape site)."""
    out = []
    callee = dotted_name(node.func).split(".")[-1]
    idx = ESCAPE_POSITIONAL.get(callee)
    if idx is not None and len(node.args) > idx:
        target = node.args[idx]
        if isinstance(target, ast.Call) and target.args:
            target = target.args[0]          # submit(partial(f, x))
        name = dotted_name(target)
        if name:
            out.append(name)
    for kw in node.keywords:
        if kw.arg in ESCAPE_KEYWORDS:
            name = dotted_name(kw.value)
            if name:
                out.append(name)
    return out


def scan_module(tree: ast.AST, relpath: str) -> dict | None:
    """The per-file (cached, picklable) stage: per-class access facts +
    the module's escape sites."""
    classes: dict[str, dict] = {}
    escapes: list = []

    def walk_class(cls: ast.ClassDef, prefix: list[str]) -> None:
        qual = ".".join(prefix + [cls.name])
        lock_attrs, sync_attrs = set(), set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                last = _ctor_last(node.value)
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if last in LOCK_CTORS:
                        lock_attrs.add(attr)
                    if last in SYNC_CTORS:
                        sync_attrs.add(attr)
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
        method_names = {m.name for m in methods}
        scans = {}

        def direct_nested(fn: ast.AST) -> list:
            """Immediately-nested defs (not ones inside deeper defs):
            each closure is scanned as its own pseudo-method, because a
            closure handed to Thread(target=...) runs on the spawned
            thread while its enclosing method body does not."""
            found, work = [], list(fn.body)
            while work:
                n = work.pop()
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    found.append(n)
                    continue
                if not isinstance(n, ast.Lambda):
                    work.extend(ast.iter_child_nodes(n))
            return found

        def scan_one(fn: ast.AST, key: str) -> None:
            scan = _MethodScan(lock_attrs, method_names)
            for stmt in fn.body:
                scan.visit(stmt)
            if scan.acc or scan.calls or scan.cta:
                scans[key] = {"line": fn.lineno, "acc": scan.acc,
                              "calls": scan.calls, "cta": scan.cta}
            for sub in direct_nested(fn):
                scan_one(sub, f"{key}.{sub.name}")

        for m in methods:
            scan_one(m, m.name)
        bases = tuple(dotted_name(b).split(".")[-1] for b in cls.bases
                      if dotted_name(b))
        if scans or lock_attrs:
            classes[qual] = {
                "line": cls.lineno,
                "locks": sorted(lock_attrs),
                "sync": sorted(sync_attrs),
                "bases": bases,
                "methods": scans,
            }
        for child in cls.body:
            if isinstance(child, ast.ClassDef):
                walk_class(child, prefix + [cls.name])

    class _TopVisitor(ast.NodeVisitor):
        def __init__(self):
            self.cls_stack: list[str] = []
            self.fn_stack: list[str] = []

        def visit_ClassDef(self, node: ast.ClassDef) -> None:
            if not self.fn_stack and not self.cls_stack:
                walk_class(node, [])
            self.cls_stack.append(node.name)
            self.generic_visit(node)
            self.cls_stack.pop()

        def visit_FunctionDef(self, node) -> None:
            self.fn_stack.append(node.name)
            self.generic_visit(node)
            self.fn_stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node: ast.Call) -> None:
            for name in _escape_args(node):
                escapes.append([
                    dotted_name(node.func), name,
                    ".".join(self.cls_stack),
                    ".".join(self.cls_stack + self.fn_stack),
                    node.lineno])
            self.generic_visit(node)

    _TopVisitor().visit(tree)
    if not classes and not escapes:
        return None
    return {"classes": classes, "escapes": escapes}


# -- cross-file model --------------------------------------------------------

@dataclasses.dataclass
class SharedClass:
    """One thread-shared class with its resolved concurrency facts."""
    rel: str
    qual: str
    line: int
    locks: tuple
    sync: tuple
    seeded_by: tuple      # spawn-site descriptions ("rel:line -> method")
    entry_methods: frozenset
    #: method -> lockset inherited from in-class callers (private only)
    inherited: dict
    methods: dict         # raw per-method scan facts

    @property
    def spawn_seeded(self) -> bool:
        return bool(self.seeded_by)

    def effective_locks(self, method: str, locks) -> frozenset:
        return frozenset(locks) | self.inherited.get(method, frozenset())


def _owner_class(qual: str, class_quals) -> str | None:
    """Longest class qual that prefixes a resolved function qual."""
    best = None
    for cq in class_quals:
        if qual == cq or qual.startswith(cq + "."):
            if best is None or len(cq) > len(best):
                best = cq
    return best


def _method_key(qual: str, cls_qual: str) -> str:
    """'Cls.start.loop' -> 'start.loop': the scan key of the exact def
    (possibly a nested closure) that crosses the thread boundary."""
    return qual[len(cls_qual) + 1:] if qual != cls_qual else ""


def build_model(data: dict, graph: CallGraph) -> dict:
    """``data``: relpath -> scan_module() output for every module.
    Returns {(rel, class_qual): SharedClass} for every class that
    crosses a thread boundary (spawn-seeded through the call graph) or
    self-declares concurrency by owning a lock."""
    # 1. resolve every escape site to candidate methods
    seeded: dict[tuple, dict] = {}     # (rel, cls) -> {method: [sites]}
    for rel, d in data.items():
        for callee, arg, cls, caller_qual, line in d.get("escapes", ()):
            for cand_rel, cand_qual in graph.resolve_call(
                    rel, caller_qual, arg, self_calls=True):
                cand = data.get(cand_rel)
                if cand is None:
                    continue
                cls_qual = _owner_class(cand_qual,
                                        cand["classes"].keys())
                if cls_qual is None:
                    continue           # module-level function target
                method = _method_key(cand_qual, cls_qual)
                if not method:
                    continue
                site = f"{rel}:{line} {callee}({arg})"
                seeded.setdefault((cand_rel, cls_qual), {}) \
                    .setdefault(method, []).append(site)

    # 2. Thread subclasses: run() is an entry point by construction
    for rel, d in data.items():
        for cls_qual, c in d["classes"].items():
            if "Thread" in c.get("bases", ()) and "run" in c["methods"]:
                seeded.setdefault((rel, cls_qual), {}) \
                    .setdefault("run", []).append(f"{rel}:{c['line']} "
                                                  "Thread subclass")

    model: dict[tuple, SharedClass] = {}
    for rel, d in data.items():
        for cls_qual, c in d["classes"].items():
            sites = seeded.get((rel, cls_qual), {})
            if not sites and not c["locks"]:
                continue
            methods = c["methods"]
            # entry closure over in-class self-calls
            entry = set(sites)
            work = list(entry)
            while work:
                m = work.pop()
                for callee, _line, _locks in \
                        methods.get(m, {}).get("calls", ()):
                    if callee in methods and callee not in entry:
                        entry.add(callee)
                        work.append(callee)
            # inherited locksets for private helpers: intersection over
            # every in-class call site, to fixpoint
            callers: dict[str, list] = {}
            for m, facts in methods.items():
                for callee, _line, locks in facts.get("calls", ()):
                    callers.setdefault(callee, []).append((m, locks))
            inherited: dict[str, frozenset] = {}
            for _ in range(8):
                changed = False
                for m in methods:
                    if not _PRIVATE.match(m) or m in sites:
                        continue
                    call_sites = callers.get(m)
                    if not call_sites:
                        continue
                    acc = None
                    for caller, locks in call_sites:
                        eff = frozenset(locks) | \
                            inherited.get(caller, frozenset())
                        acc = eff if acc is None else (acc & eff)
                    acc = acc or frozenset()
                    if acc != inherited.get(m, frozenset()):
                        inherited[m] = acc
                        changed = True
                if not changed:
                    break
            model[(rel, cls_qual)] = SharedClass(
                rel=rel, qual=cls_qual, line=c["line"],
                locks=tuple(c["locks"]), sync=tuple(c["sync"]),
                seeded_by=tuple(site for m in sorted(sites)
                                for site in sites[m]),
                entry_methods=frozenset(entry),
                inherited=inherited, methods=methods)
    return model


@dataclasses.dataclass
class AttrReport:
    """Classification of one shared attribute."""
    attr: str
    status: str           # 'safe-publish' | 'guarded' | 'race'
    guard: tuple          # the consistent lockset when status=='guarded'
    findings: list        # [(category, method, line, message), ...]


def classify_attrs(sc: SharedClass) -> dict[str, AttrReport]:
    """The lockset lattice walk for one shared class: per attribute,
    either a consistent guard, a safe publication, or race findings."""
    per_attr: dict[str, list] = {}
    for mname, facts in sc.methods.items():
        for attr, kind, line, locks in facts.get("acc", ()):
            if attr in sc.sync:
                continue
            per_attr.setdefault(attr, []).append(
                (mname, kind, line, sc.effective_locks(mname, locks)))
    cta_by_attr: dict[str, list] = {}
    for mname, facts in sc.methods.items():
        if mname in _INIT_METHODS:
            continue
        if sc.inherited.get(mname):
            # a private helper only ever called with a lock held: its
            # "unlocked" test actually runs under every caller's lock
            continue
        for attr, line in facts.get("cta", ()):
            cta_by_attr.setdefault(attr, []).append((mname, line))

    out: dict[str, AttrReport] = {}
    for attr, accesses in sorted(per_attr.items()):
        live = [(m, k, ln, locks) for m, k, ln, locks in accesses
                if m not in _INIT_METHODS]
        writes = [a for a in live if a[1] in ("w", "a")]
        findings: list = []
        if not writes:
            out[attr] = AttrReport(attr, "safe-publish", (), [])
            continue
        locked_evidence = [a for a in live if a[3]]
        write_locksets = [a[3] for a in writes]
        common_w = frozenset.intersection(*write_locksets) \
            if write_locksets else frozenset()
        unlocked_writes = [a for a in writes if not a[3]]
        multi_domain = bool(
            {m for m, *_ in live} & sc.entry_methods and
            {m for m, *_ in live} - sc.entry_methods)
        if unlocked_writes and locked_evidence:
            guards = sorted({lk for a in locked_evidence for lk in a[3]})
            for m, k, ln, _locks in unlocked_writes:
                findings.append((
                    "write-no-lock", m, ln,
                    f"'{sc.qual}.{attr}' is written in '{m}' with no "
                    f"lock held, but other accesses hold {guards} — "
                    "every guarded reader can observe this torn; hold "
                    "the lock here too"))
        elif not unlocked_writes and not common_w and len(writes) > 1:
            mixes = sorted({tuple(sorted(a[3])) for a in writes})
            m, k, ln, _locks = writes[-1]
            findings.append((
                "lock-mix", m, ln,
                f"'{sc.qual}.{attr}' is written under inconsistent "
                f"locksets {[list(x) for x in mixes]} — two writers "
                "holding different locks do not exclude each other; "
                "pick ONE guard for this attribute"))
        elif unlocked_writes and not locked_evidence and \
                sc.spawn_seeded and multi_domain:
            seed = sc.seeded_by[0]
            for m, k, ln, _locks in unlocked_writes:
                findings.append((
                    "write-no-lock", m, ln,
                    f"'{sc.qual}.{attr}' is shared across threads "
                    f"(spawn site {seed}) and written in '{m}' with no "
                    "lock anywhere in the class — unsynchronized "
                    "shared mutation; add a lock or confine the field"))
        # check-then-act fires when the attr is otherwise lock-involved
        # or provably multi-thread — an unlocked test deciding a write
        if attr in cta_by_attr and (
                locked_evidence or (sc.spawn_seeded and multi_domain)):
            flagged = {ln for _c, _m, ln, _msg in findings}
            for m, ln in cta_by_attr[attr]:
                if ln in flagged:
                    continue
                findings.append((
                    "check-then-act", m, ln,
                    f"check-then-act on shared '{sc.qual}.{attr}': this "
                    "test reads it outside any lock and the branch "
                    "writes it — two threads can both pass the test; "
                    "hold one lock across the test and the write"))
        if findings:
            out[attr] = AttrReport(attr, "race", (), sorted(
                findings, key=lambda f: f[2]))
        elif common_w:
            out[attr] = AttrReport(attr, "guarded", tuple(sorted(common_w)),
                                   [])
        else:
            out[attr] = AttrReport(attr, "safe-publish", (), [])
    return out
