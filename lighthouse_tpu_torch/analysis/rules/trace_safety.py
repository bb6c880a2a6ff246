"""trace-safety: no host syncs or stray host effects in device programs.

The port's device programs are the launch wrappers of ``ops/`` and the
sharded programs of ``parallel/``: the functions built with
``obs.roofline.track_roofline`` / ``@tracked``.  A host sync inside one
(``.item()``, ``.tolist()``, ``float()``/``int()``/``bool()`` on a
tensor, ``torch.cuda.synchronize()``) stalls the host until the card's
queue drains, so the launches after it cannot overlap the host work
before them — the round-trip class of regression the merkleization and
BLS pipelines (PAPER.md) cannot afford.  ``print`` and host clocks
(``time.time()``, ...) inside one are host effects on the launch path:
the program's own timing belongs to the roofline wrapper.

Mechanics (on the shared interprocedural engine):
1. roots: functions decorated with ``@tracked(name, cost)``, passed to
   ``track_roofline(name, fn, cost)``, or wrapped as
   ``tracked(name, cost)(fn)``.
2. reachability: the shared :class:`~..callgraph.CallGraph` BFS from
   roots (same module by name, cross-module through import resolution).
   ``host_readback`` — the accounted device->host read — is the
   sanctioned exit: the graph records no edge into it, and its result
   is a host value, so a final readback through it is no finding.
3. the plain versions are host paths: the calls and findings inside a
   CPU dispatch (``if _on_cpu(...):``, ``if x.device.type == "cpu":``)
   are neither edges nor findings — on a CPU tensor nothing syncs.
4. a per-function taint pass marks values derived from parameters as
   device tensors (a parameter annotated with a host type — ``int``,
   ``bool``, ``tuple``, ... — is not one, and numpy's constructors
   return host data); ``.shape``/``.ndim``/``.dtype``/``.device`` access
   and ``.numel()``/``.size()``/``.dim()``/``.data_ptr()``/
   ``.element_size()`` calls launder taint (host metadata, no sync),
   and so do concretizing calls (``len``, ``range``, ...).  The taint
   pass runs for *every* function in the cached per-file stage; the
   cross-file stage keeps only the reachable findings.

The rule also owns the graftpath causal-scope discipline:
a delivery callback — any function with a parameter named ``peer``,
the gossip/RPC handler convention — that opens a graftscope span must
attach a causal identity (``message_id``/``block_root``/``root``/
``req_id``, obs/causal.py CAUSAL_KEYS) as a span kwarg or via
``annotate(...)``, or the cross-node stitcher can never join its trace
to the publisher's.  This check is per-module (no reachability gate)
and pins its violation to the bare ``span(...)`` call line.
"""
from __future__ import annotations

import ast

from ..engine import Module, Project, Rule, Violation, dotted_name, rule

_ROOF_WRAPPERS = {"tracked", "track_roofline"}
#: attribute calls that force a device->host sync
_SYNC_METHODS = {"item", "tolist"}
#: calls that block the host on the card whatever their arguments
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
_HOST_CASTS = {"float", "int", "bool"}
#: host effects on the launch path
_IMPURE_CALLS = {"time.time", "time.monotonic", "time.perf_counter",
                 "time.sleep"}
#: attribute access that yields host metadata of a tensor
_TAINT_LAUNDER = {"shape", "ndim", "dtype", "device", "is_cuda"}
#: tensor methods that return host metadata without a sync
_METADATA_CALLS = {"numel", "size", "dim", "data_ptr", "element_size",
                   "stride", "is_contiguous", "nelement", "get_device"}
#: calls that REQUIRE a host int (or return host data whatever their
#: argument): data derived through them is host data, not a sync
_CONCRETIZERS = {"bin", "hex", "oct", "len", "range", "isinstance",
                 "host_readback"}
#: numpy constructors: they raise on a device tensor, so what they
#: return is host data
_HOST_CONSTRUCTORS = {"np.asarray", "np.array", "np.ascontiguousarray",
                      "np.frombuffer", "numpy.asarray", "numpy.array",
                      "numpy.ascontiguousarray", "numpy.frombuffer"}
#: parameter annotations that name host values, not tensors
_HOST_ANNOTATIONS = {"int", "float", "bool", "str", "bytes", "tuple",
                     "list", "dict", "set", "Tuple", "List", "Dict", "Set",
                     "Sequence", "Iterable", "None"}
#: graftscope (lighthouse_tpu_torch/obs) span calls and the accounted
#: readback are sanctioned: device programs open spans freely, and the
#: rule neither follows these call edges into the observability layer
#: (whose clock use is the point) nor flags the calls themselves.
_SANCTIONED_TRACE_CALLS = {"span", "annotate", "record_event",
                           "current_span", "capture", "attach",
                           "host_readback", "account_transfer"}
#: modules never entered by the reachability BFS
_SANCTIONED_MODULE_PARTS = ("/obs/",)
#: causal span attrs (obs/causal.py CAUSAL_KEYS) — delivery callbacks
#: must stamp one so the cross-node stitcher can join their traces
_CAUSAL_KEYS = {"message_id", "block_root", "root", "req_id"}
#: the gossip/RPC handler convention: first non-self parameter is `peer`
_DELIVERY_PARAM = "peer"


def _causal_violations(rule_name: str, mod: Module, qualname: str,
                       fn: ast.FunctionDef) -> list:
    """Bare ``span(...)`` calls inside a delivery callback (a function
    with a ``peer`` parameter).  One causal kwarg on any span, or one
    ``annotate(...)`` with a causal key, clears the whole function —
    the scope attaches to the trace either way."""
    args = fn.args
    params = {a.arg for a in
              args.posonlyargs + args.args + args.kwonlyargs}
    if _DELIVERY_PARAM not in params:
        return []
    bare_spans: list[ast.Call] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        last = name.split(".")[-1] if name else ""
        kw = {k.arg for k in node.keywords if k.arg}
        if last == "span":
            if kw & _CAUSAL_KEYS:
                return []
            bare_spans.append(node)
        elif last == "annotate" and kw & _CAUSAL_KEYS:
            return []
    return [mod.violation(
        rule_name, node,
        "delivery callback opens a span with no causal scope "
        "(message_id/block_root/root/req_id) — the cross-node "
        "stitcher (obs/causal.py) cannot join this trace to its "
        "publisher; stamp the id as a span kwarg or annotate() it",
        symbol=qualname) for node in bare_spans]


def _host_annotation(ann: ast.AST | None) -> bool:
    """int, tuple[int, ...], int | None, Optional[int]: a host value."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant):
        return ann.value is None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _host_annotation(ann.left) and _host_annotation(ann.right)
    if isinstance(ann, ast.Subscript):
        base = dotted_name(ann.value).split(".")[-1]
        if base == "Optional":
            return _host_annotation(ann.slice)
        return base in _HOST_ANNOTATIONS
    return dotted_name(ann).split(".")[-1] in _HOST_ANNOTATIONS


def _cpu_test(test: ast.AST) -> bool:
    """``_on_cpu(...)`` / ``x.device.type == "cpu"`` / ``dev.type ==
    "cpu"``: the test that sends a call to its plain version."""
    if isinstance(test, ast.Call):
        return dotted_name(test.func).split(".")[-1] == "_on_cpu"
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
            isinstance(test.ops[0], ast.Eq):
        sides = [test.left] + test.comparators
        return any(isinstance(x, ast.Constant) and x.value == "cpu"
                   for x in sides) and any(
            isinstance(x, ast.Attribute) and x.attr == "type"
            for x in sides)
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(_cpu_test(v) for v in test.values)
    return False


def cpu_lines(tree: ast.AST) -> set[int]:
    """Source lines that run only on the host's plain path: the bodies
    of the CPU-dispatch branches (nested defs included)."""
    out: set[int] = set()
    for node in ast.walk(tree):
        body = []
        if isinstance(node, ast.If):
            if _cpu_test(node.test):
                body = node.body
            elif isinstance(node.test, ast.UnaryOp) and \
                    isinstance(node.test.op, ast.Not) and \
                    _cpu_test(node.test.operand):
                body = node.orelse
        elif isinstance(node, ast.IfExp) and _cpu_test(node.test):
            body = [node.body]
        for stmt in body:
            for sub in ast.walk(stmt):
                line = getattr(sub, "lineno", None)
                if line is not None:
                    out.update(range(line, getattr(sub, "end_lineno",
                                                   line) + 1))
    return out


def _roof_name(node: ast.AST) -> bool:
    return dotted_name(node).split(".")[-1] in _ROOF_WRAPPERS


class _FuncIndex(ast.NodeVisitor):
    """Collect every function in a module by qualified name, plus which
    are device-program roots."""

    def __init__(self, mod: Module):
        self.mod = mod
        self.stack: list[str] = []
        self.funcs: dict[str, ast.FunctionDef] = {}
        self.roots: set[str] = set()
        # decorator-less names wrapped at call sites: track_roofline(n,
        # fn, c), tracked(n, c)(fn); recorded with the scope the wrap
        # happened in, so a wrap inside a factory doesn't mark every
        # function of that name
        self._wrapped_names: set[tuple[str, str]] = set()
        self.visit(mod.tree)
        for prefix, name in self._wrapped_names:
            scoped = f"{prefix}.{name}" if prefix else name
            if scoped in self.funcs:
                self.roots.add(scoped)
            elif name in self.funcs:    # module-level fn wrapped elsewhere
                self.roots.add(name)

    def _qual(self, name: str) -> str:
        return ".".join(self.stack + [name])

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        qn = self._qual(node.name)
        self.funcs[qn] = node
        for dec in node.decorator_list:
            # @tracked(name, cost) / @roofline.tracked(name, cost)
            if isinstance(dec, ast.Call) and _roof_name(dec.func):
                self.roots.add(qn)
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        target = None
        if _roof_name(node.func) and \
                dotted_name(node.func).endswith("track_roofline"):
            target = node.args[1] if len(node.args) > 1 else None
        elif isinstance(node.func, ast.Call) and \
                _roof_name(node.func.func):
            target = node.args[0] if node.args else None
        name = dotted_name(target) if target is not None else ""
        if name:
            self._wrapped_names.add((".".join(self.stack),
                                     name.split(".")[-1]))
        self.generic_visit(node)


class _TaintChecker(ast.NodeVisitor):
    """Scan one function with parameter taint."""

    def __init__(self, rule_name: str, mod: Module, qualname: str,
                 fn: ast.FunctionDef):
        self.rule_name = rule_name
        self.mod = mod
        self.qualname = qualname
        self.fn = fn
        args = fn.args
        params = [a.arg for a in
                  args.posonlyargs + args.args + args.kwonlyargs
                  if not _host_annotation(a.annotation)]
        if args.vararg:
            params.append(args.vararg.arg)
        if args.kwarg:
            params.append(args.kwarg.arg)
        self.tainted = {p for p in params if p not in ("self", "cls")}
        self.violations = []
        # two passes: settle assignments first so use-before-def within
        # loops still sees the taint
        for _ in range(2):
            for stmt in fn.body:
                self._collect_assigns(stmt)
        for stmt in fn.body:
            self.visit(stmt)

    # -- taint propagation ---------------------------------------------------

    def _expr_tainted(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id in self.tainted:
                if self._laundered(node, sub):
                    continue
                return True
        return False

    def _laundered(self, root: ast.AST, name: ast.Name) -> bool:
        """True if the use of `name` inside `root` goes through host
        metadata (.shape/.numel()/...), a concretizing call (len/...),
        or the accounted readback — all host values."""
        for sub in ast.walk(root):
            if isinstance(sub, ast.Attribute) and sub.attr in _TAINT_LAUNDER:
                if any(s is name for s in ast.walk(sub.value)):
                    return True
            if isinstance(sub, ast.Call):
                fn = dotted_name(sub.func)
                if fn.split(".")[-1] in _CONCRETIZERS or \
                        fn in _HOST_CONSTRUCTORS or (
                        isinstance(sub.func, ast.Attribute) and
                        sub.func.attr in _METADATA_CALLS):
                    if any(s is name for s in ast.walk(sub)):
                        return True
        return False

    def _collect_assigns(self, stmt: ast.AST) -> None:
        for node in ast.walk(stmt):
            targets = []
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                    and node.value is not None:
                targets, value = [node.target], node.value
            elif isinstance(node, ast.For):
                targets, value = [node.target], node.iter
            else:
                continue
            names = [n.id for t in targets for n in ast.walk(t)
                     if isinstance(n, ast.Name)]
            if self._expr_tainted(value):
                self.tainted.update(names)

    # -- checks --------------------------------------------------------------

    def _flag(self, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if any(v.line == line for v in self.violations):
            return      # one sync a line: bool(x.item()) is one finding
        self.violations.append(self.mod.violation(
            self.rule_name, node, message, symbol=self.qualname))

    def visit_Call(self, node: ast.Call) -> None:
        fname = dotted_name(node.func)
        if fname == "print":
            self._flag(node, "print() inside a device program runs on the "
                             "launch path every call — log outside the "
                             "program or drop it")
        elif fname in _IMPURE_CALLS:
            self._flag(node, f"{fname}() inside a device program reads the "
                             "host clock on the launch path, unsynchronised "
                             "with the card — the roofline wrapper times "
                             "the program; hoist it to the caller")
        elif fname in _SYNC_CALLS:
            self._flag(node, f"{fname}() inside a device program blocks the "
                             "host until the card drains — return the "
                             "tensor and let the caller read it back "
                             "(obs.cuda_accounting.host_readback)")
        elif fname in _HOST_CASTS:
            if node.args and self._expr_tainted(node.args[0]):
                self._flag(node, f"{fname}() on a device tensor is a host "
                                 "sync inside a device program — keep it "
                                 "on the card, or read it back once "
                                 "through host_readback")
        elif isinstance(node.func, ast.Attribute):
            if node.func.attr in _SYNC_METHODS and \
                    self._expr_tainted(node.func.value):
                self._flag(node, f".{node.func.attr}() on a device tensor "
                                 "is a device->host sync inside a device "
                                 "program — read it back once through "
                                 "host_readback")
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested defs are visited through the call graph if reachable
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


@rule
class TraceSafetyRule(Rule):
    name = "trace-safety"
    description = ("host syncs and host effects inside device programs "
                   "(functions reachable from track_roofline/@tracked "
                   "wrappers)")

    def summarize_module(self, module: Module, project: Project) -> dict:
        """Cached per-file stage: device-program roots + candidate
        findings for EVERY function (keyed by qualname). Whether a
        function is actually reachable is a cross-file question answered in
        :meth:`finalize_project`; computing candidates for all of them
        keeps this stage independent of the rest of the tree."""
        idx = _FuncIndex(module)
        cands: dict[str, list] = {}
        causal: list = []
        lines = cpu_lines(module.tree) if "cpu" in module.source else set()
        for qn, fn in idx.funcs.items():
            checker = _TaintChecker(self.name, module, qn, fn)
            found = [v.to_json() for v in checker.violations
                     if v.line not in lines]
            if found:
                cands[qn] = found
            causal.extend(v.to_json() for v in _causal_violations(
                self.name, module, qn, fn))
        return {"roots": sorted(idx.roots), "cands": cands,
                "host": sorted(lines), "causal": causal}

    def finalize_project(self, ctx) -> list:
        data = ctx.data_for(self.name)
        roots = [(rel, qn) for rel, d in data.items()
                 for qn in d["roots"]]
        host = {rel: set(d["host"]) for rel, d in data.items()}
        # BFS over the shared graph; an edge from inside a CPU dispatch
        # leads to a plain version, never into the device program
        reach = set(roots)
        work = list(roots)
        while work:
            node = work.pop()
            skip = host.get(node[0], ())
            for cand, site in ctx.graph.callees(node, self_calls=False):
                if site.line in skip or cand in reach or \
                        site.name.split(".")[-1] in \
                        _SANCTIONED_TRACE_CALLS or \
                        any(part in cand[0]
                            for part in _SANCTIONED_MODULE_PARTS):
                    continue
                reach.add(cand)
                work.append(cand)
        out = []
        for rel, qn in sorted(reach):
            d = data.get(rel)
            if d is None:
                continue
            for v in d["cands"].get(qn, ()):
                out.append(Violation(**v))
        # causal-scope findings are per-module truths, emitted without a
        # reachability gate (.get: caches from before the check existed)
        for rel in sorted(data):
            for v in data[rel].get("causal", ()):
                out.append(Violation(**v))
        return out
