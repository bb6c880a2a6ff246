"""device-transfer: unaccounted host round-trips at shard boundaries.

Scope: modules that hold the sharding machinery — in this tree,
``parallel/`` — or that import ``torch.distributed``.  At a shard
boundary a host<->device transfer is either part of the designed
dataflow (placement on the rank's card, readback of the final verdict)
or a silent performance bug (a mid-pipeline sync serializes the mesh).
Either way it must be *visible*: the sanctioned crossings are
``obs.cuda_accounting.host_readback`` (device->host, byte-accounted
into ``device_transfer_device_to_host_bytes_total``) and
``parallel.mesh.shard_batch`` / ``parallel.bls._put`` (host->device, on
the rank's explicit device).

Flagged:

1. a placement with no explicit device: ``.cuda()`` with no argument,
   ``.to("cuda")`` / ``torch.device("cuda")`` without a card index, or a
   ``torch`` factory (``torch.zeros``, ``torch.tensor``, ...) with no
   ``device=`` — each lands on the process's current card (or the
   host), which at a shard boundary is a resharding hazard; place on
   the rank's device (``mesh.device``, ``x.device``).
2. ``.cpu()`` / ``.numpy()`` / ``.item()`` / ``.tolist()``, or
   ``np.asarray`` / ``np.array`` / ``np.frombuffer``, on a
   *device-tainted* value — a host round-trip that bypasses the
   transfer accounting.  Route it through ``host_readback()``.

Device taint seeds per function: results of calls into ``ops/`` kernels
(resolved through imports and module aliases), of a device placement
(``.to(...)``, ``.cuda(...)``, a factory with ``device=``), and the
parameters of a device program — a function wrapped with
``obs.roofline.tracked`` / ``track_roofline`` and its declared ``cost``
function, whose arguments are the program's tensors.  Taint propagates
through assignments; ``host_readback(...)`` and ``.cpu()`` results are
host values.  Host-side numpy work (mesh rows, padding tables) stays
silent.
"""
from __future__ import annotations

import ast

from ..engine import Module, Project, Rule, dotted_name, enclosing_symbol, \
    rule

_HOST_PULLS = {"np.asarray", "np.array", "np.frombuffer",
               "numpy.asarray", "numpy.array", "numpy.frombuffer"}
#: tensor methods that read a device value back to the host
_PULL_METHODS = {"cpu", "numpy", "item", "tolist"}
#: torch factories that allocate on ``device=`` (the host without it);
#: the ``*_like`` forms inherit their input's device and are exempt
_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "tensor",
              "as_tensor", "rand", "randn", "randint", "linspace", "eye"}
_DIST_MODULES = ("torch.distributed",)
_ROOF_WRAPPERS = {"tracked", "track_roofline"}


def _module_is_scoped(mod: Module) -> bool:
    """True when the module imports the collective machinery (or lives
    under parallel/) — the rule's blast radius stays at shard code."""
    if "/parallel/" in mod.relpath.replace("\\", "/"):
        return True
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module is not None:
            if node.module in _DIST_MODULES or node.module == "torch" and \
                    any(a.name == "distributed" for a in node.names):
                return True
        elif isinstance(node, ast.Import):
            if any(a.name in _DIST_MODULES for a in node.names):
                return True
    return False


def _ops_bindings(mod: Module) -> tuple[set[str], set[str]]:
    """(aliases, names): module aliases bound to ops kernels
    (``from ..ops import bls12_381 as k``) and names from-imported out
    of ops modules (``from ..ops.bls12_381 import fp12_eq``)."""
    aliases: set[str] = set()
    names: set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if ".ops." in a.name or a.name.endswith(".ops"):
                    aliases.add(a.asname or a.name.split(".")[-1])
        elif isinstance(node, ast.ImportFrom) and node.module is not None:
            m = node.module.lstrip(".")
            if m == "ops" or m.endswith(".ops"):
                for a in node.names:        # from ..ops import bigint as bi
                    aliases.add(a.asname or a.name)
            elif m.startswith("ops.") or ".ops." in m:
                for a in node.names:
                    names.add(a.asname or a.name)
    return aliases, names


def _roof_name(node: ast.AST) -> bool:
    return dotted_name(node).split(".")[-1] in _ROOF_WRAPPERS


def device_programs(tree: ast.AST, costs: bool = True) -> set[str]:
    """Names of the module's device programs (``@tracked(name, cost)``
    defs, ``track_roofline(name, fn, cost)``, ``tracked(name, cost)(fn)``)
    and, with ``costs``, of their cost functions."""
    out: set[str] = set()

    def add(node, is_cost=False):
        name = dotted_name(node)
        if name and (costs or not is_cost):
            out.add(name.split(".")[-1])

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and _roof_name(dec.func):
                    out.add(node.name)
                    for arg in dec.args[1:2]:
                        add(arg, True)
        elif isinstance(node, ast.Call):
            if _roof_name(node.func) and \
                    dotted_name(node.func).endswith("track_roofline"):
                for arg in node.args[1:2]:
                    add(arg)
                for arg in node.args[2:3]:
                    add(arg, True)
            elif isinstance(node.func, ast.Call) and \
                    _roof_name(node.func.func):
                for arg in node.args[:1]:
                    add(arg)
                for arg in node.func.args[1:2]:
                    add(arg, True)
    return out


def _bare_cuda(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cuda"


def _unplaced(node: ast.Call) -> str:
    """What makes this call a placement with no explicit device, or ''."""
    fn = dotted_name(node.func)
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr == "cuda" and not node.args and not node.keywords:
            return ".cuda() with no card"
        if attr == "to":
            dev = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "device"),
                None)
            if dev is not None and _bare_cuda(dev):
                return ".to('cuda') with no card index"
    if fn == "torch.device" and len(node.args) == 1 and \
            _bare_cuda(node.args[0]):
        return "torch.device('cuda') with no card index"
    if fn.startswith("torch.") and fn.split(".", 1)[1] in _FACTORIES:
        if not any(kw.arg == "device" for kw in node.keywords):
            return f"{fn}() with no device="
    return ""


def _iter_scope(body: list[ast.stmt]):
    """Walk a statement list WITHOUT descending into nested function or
    class definitions (each gets its own _Scope)."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            stack.append(child)


class _Scope:
    """Device-taint analysis of one function (or the module body)."""

    def __init__(self, rule_name: str, mod: Module, symbol: str,
                 body: list[ast.stmt], ops_aliases: set[str],
                 ops_names: set[str], params: set[str] = frozenset()):
        self.rule_name = rule_name
        self.mod = mod
        self.symbol = symbol
        self.ops_aliases = ops_aliases
        self.ops_names = ops_names
        self.tainted: set[str] = set(params)
        self.violations: list = []
        # two passes so loops see taint settled by later statements
        for _ in range(2):
            for stmt in body:
                self._collect(stmt)
        for stmt in body:
            self._check(stmt)

    # -- taint ---------------------------------------------------------------

    def _seed_call(self, node: ast.Call) -> bool:
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("to", "cuda"):
            return True
        fn = dotted_name(node.func)
        if not fn:
            return False
        if fn.startswith("torch.") and \
                fn.split(".", 1)[1] in _FACTORIES and \
                any(kw.arg == "device" for kw in node.keywords):
            return True
        head = fn.split(".")[0]
        if head in self.ops_aliases:
            return True
        return fn in self.ops_names

    def _tainted_expr(self, node: ast.AST) -> bool:
        """A device value: a tainted name or a seeding call, not behind a
        host readback (``host_readback(x)``, ``x.cpu()``)."""
        stack = [node]
        while stack:
            sub = stack.pop()
            if isinstance(sub, ast.Call):
                name = dotted_name(sub.func)
                if name.split(".")[-1] == "host_readback":
                    continue
                if isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr == "cpu":
                    continue
                if self._seed_call(sub):
                    return True
            if isinstance(sub, ast.Name) and sub.id in self.tainted:
                return True
            stack.extend(ast.iter_child_nodes(sub))
        return False

    def _collect(self, stmt: ast.AST) -> None:
        for node in _iter_scope([stmt]):
            targets, value = [], None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and \
                    node.value is not None:
                targets, value = [node.target], node.value
            elif isinstance(node, ast.For):
                targets, value = [node.target], node.iter
            else:
                continue
            if self._tainted_expr(value):
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            self.tainted.add(n.id)

    # -- checks --------------------------------------------------------------

    def _flag(self, node: ast.AST, message: str) -> None:
        self.violations.append(self.mod.violation(
            self.rule_name, node, message, symbol=self.symbol))

    def _check(self, stmt: ast.AST) -> None:
        for node in _iter_scope([stmt]):
            if not isinstance(node, ast.Call):
                continue
            what = _unplaced(node)
            if what:
                self._flag(node, f"{what} at a shard boundary lands on the "
                                 "process's current card (or the host) — "
                                 "place it on the rank's device "
                                 "(mesh.device / x.device); accounted "
                                 "placement lives in "
                                 "parallel.mesh.shard_batch")
                continue
            fn = dotted_name(node.func)
            if fn in _HOST_PULLS and node.args and \
                    self._tainted_expr(node.args[0]):
                self._flag(node, f"{fn}() on a device value is an "
                                 "unaccounted host round-trip at a shard "
                                 "boundary — route it through "
                                 "obs.cuda_accounting.host_readback() so "
                                 "transfer bytes are observable")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _PULL_METHODS and \
                    self._tainted_expr(node.func.value):
                self._flag(node, f".{node.func.attr}() on a device value "
                                 "is an unaccounted host round-trip at a "
                                 "shard boundary — route it through "
                                 "obs.cuda_accounting.host_readback() so "
                                 "transfer bytes are observable")


def _params(fn: ast.FunctionDef) -> set[str]:
    args = fn.args
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    return names - {"self", "cls"}


@rule
class DeviceTransferRule(Rule):
    name = "device-transfer"
    description = ("unaccounted host readbacks / placements with no "
                   "explicit device at shard boundaries (parallel/)")

    def check_module(self, module: Module, project: Project) -> list:
        if not _module_is_scoped(module):
            return []
        aliases, names = _ops_bindings(module)
        programs = device_programs(module.tree)
        out: list = []

        # module-level body (function/class defs get their own scope)
        top = [s for s in module.tree.body
               if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef))]
        out.extend(_Scope(self.name, module, "", top, aliases,
                          names).violations)

        stack: list[ast.AST] = []

        def visit(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    stack.append(child)
                    params = _params(child) if child.name in programs \
                        else set()
                    out.extend(_Scope(
                        self.name, module,
                        enclosing_symbol(stack), child.body, aliases,
                        names, params).violations)
                    visit(child)
                    stack.pop()
                elif isinstance(child, ast.ClassDef):
                    stack.append(child)
                    visit(child)
                    stack.pop()
                else:
                    visit(child)

        visit(module.tree)
        return out
