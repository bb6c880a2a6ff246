"""spec-constant-drift: numeric literals shadowing named spec constants.

``specs/constants.py`` is the single source of truth for spec-fixed
numbers. A literal ``4`` where ``SYNC_COMMITTEE_SUBNET_COUNT`` is meant
compiles fine today and silently forks consensus the day the constant
moves (the drift class the beacon-client security review calls out).

Matching policy — tuned for near-zero false positives:

- *distinctive* values (``>= 1000``, e.g. ``FAR_FUTURE_EPOCH`` even
  written as ``2**64 - 1``, ``DOMAIN_APPLICATION_BUILDER``) are flagged
  anywhere on value alone; constant-integer expressions are folded first.
- *small* values (the 0/1/2/4/64/128 family) are flagged only when the
  surrounding statement shares >= 2 name tokens with the constant
  (``Topic.sync_subnet(subnet)`` + literal ``4`` matches
  ``SYNC_COMMITTEE_SUBNET_COUNT`` via {sync, subnet}); a bare ``4`` in
  unrelated code stays silent.

Scope: ``specs/`` itself is exempt (it *defines* the constants), as is
``ef_tests/`` — the scalar spec oracle deliberately imports nothing from
the implementation, duplication there is its documented purpose.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from ..engine import (
    Module, Project, Rule, enclosing_symbol, rule, safe_int_eval,
)

_EXEMPT_PARTS = {"specs", "ef_tests"}
_DISTINCTIVE_MIN = 1000
#: tokens too generic to indicate a constant by themselves
_GENERIC_TOKENS = {"count", "index", "length", "number", "per", "of",
                   "the", "value", "size", "len", "max", "min", "mask",
                   "bits", "start", "end", "kzg", "version", "epoch",
                   "slot", "block", "state", "root", "chain", "spec"}
#: values so ubiquitous they are never flagged even with token overlap
_IGNORED_VALUES = {0, 1}


def _load_constants(project: Project) -> dict[int, list[str]]:
    """value -> constant names, parsed from specs/constants.py (scanned
    copy if present, else the packaged file next to this rule)."""
    tree = None
    for m in project.modules:
        if m.relpath.endswith("specs/constants.py"):
            tree = m.tree
            break
    if tree is None:
        path = Path(__file__).resolve().parents[2] / "specs" / "constants.py"
        tree = ast.parse(path.read_text())
    table: dict[int, list[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if not name.isupper():
                continue
            value = safe_int_eval(node.value)
            if value is not None and value not in _IGNORED_VALUES:
                table.setdefault(value, []).append(name)
    return table


def _stem(word: str) -> str:
    return word[:-1] if len(word) > 4 and word.endswith("s") else word


def _tokens(name: str) -> set[str]:
    return {_stem(t) for t in name.lower().split("_")
            if len(t) >= 3 and t not in _GENERIC_TOKENS}


def _expr_tokens(exprs: list[ast.AST], extra: list[str]) -> set[str]:
    words: set[str] = set()
    for expr in exprs:
        for node in ast.walk(expr):
            ident = None
            if isinstance(node, ast.Name):
                ident = node.id
            elif isinstance(node, ast.Attribute):
                ident = node.attr
            elif isinstance(node, ast.arg):
                ident = node.arg
            elif isinstance(node, ast.keyword) and node.arg:
                ident = node.arg
            if ident:
                words.update(_stem(w) for w in
                             re.split(r"[_\W]+", ident.lower()) if w)
    for ident in extra:
        words.update(_stem(w) for w in
                     re.split(r"[_\W]+", ident.lower()) if w)
    return words


def _header_exprs(stmt: ast.stmt) -> tuple[list[ast.AST], list[str]]:
    """Expressions belonging to *this* statement (for compound
    statements: the header only — nested statements get their own pass),
    plus extra identifier context (e.g. the function name)."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
        exprs: list[ast.AST] = list(stmt.decorator_list)
        exprs += [a.annotation for a in stmt.args.args +
                  stmt.args.posonlyargs + stmt.args.kwonlyargs
                  if a.annotation is not None]
        exprs += [d for d in stmt.args.defaults + stmt.args.kw_defaults
                  if d is not None]
        return exprs, [stmt.name]
    if isinstance(stmt, ast.ClassDef):
        return list(stmt.bases) + list(stmt.decorator_list) + \
            [k.value for k in stmt.keywords], [stmt.name]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.target, stmt.iter], []
    if isinstance(stmt, (ast.While, ast.If)):
        return [stmt.test], []
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items], []
    if isinstance(stmt, ast.Try):
        return [], []
    # simple statements: every child expression
    return [c for c in ast.iter_child_nodes(stmt)
            if isinstance(c, ast.expr)], []


@rule
class SpecConstantDriftRule(Rule):
    name = "spec-constant-drift"
    description = ("numeric literals duplicating named constants from "
                   "specs/constants.py")

    def check_module(self, module: Module, project: Project) -> list:
        parts = set(Path(module.relpath).parts)
        if _EXEMPT_PARTS & parts:
            return []
        table = _load_constants(project)
        out: list = []
        seen: set[tuple] = set()
        stack: list[ast.AST] = []

        def visit(node: ast.AST) -> None:
            is_scope = isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef))
            if is_scope:
                stack.append(node)
            if isinstance(node, ast.stmt):
                self._check_stmt(module, node, table, stack, seen, out)
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_scope:
                stack.pop()

        visit(module.tree)
        return out

    def _check_stmt(self, module: Module, stmt: ast.stmt,
                    table: dict[int, list[str]], stack: list[ast.AST],
                    seen: set, out: list) -> None:
        exprs, extra = _header_exprs(stmt)
        if self._own_constant_def(stmt, table):
            return
        ctx_tokens: set[str] | None = None
        idioms = self._idiom_literals(exprs)
        for expr in exprs:
            for node in ast.walk(expr):
                if node in idioms:
                    continue
                value = None
                if isinstance(node, ast.BinOp):
                    value = safe_int_eval(node)
                    if value is not None and value < (1 << 32):
                        value = None    # folded exprs only for huge values
                elif isinstance(node, ast.Constant) and \
                        isinstance(node.value, int) and \
                        not isinstance(node.value, bool):
                    value = node.value
                if value is None or value in _IGNORED_VALUES or \
                        value not in table:
                    continue
                names = table[value]
                key = (getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), value)
                if key in seen:
                    continue
                if value >= _DISTINCTIVE_MIN:
                    if self._is_bitmask_idiom(module, node, value):
                        continue
                    seen.add(key)
                    out.append(module.violation(
                        self.name, node,
                        f"literal {value} duplicates spec constant "
                        f"{'/'.join(names)} — import it from "
                        "specs.constants instead",
                        symbol=enclosing_symbol(stack)))
                    continue
                if ctx_tokens is None:
                    ctx_tokens = _expr_tokens(exprs, extra)
                for cname in names:
                    overlap = _tokens(cname) & ctx_tokens
                    if len(overlap) >= 2:
                        seen.add(key)
                        out.append(module.violation(
                            self.name, node,
                            f"literal {value} with context "
                            f"{sorted(overlap)} duplicates spec "
                            f"constant {cname} — import it from "
                            "specs.constants",
                            symbol=enclosing_symbol(stack)))
                        break

    @staticmethod
    def _own_constant_def(stmt: ast.stmt, table: dict) -> bool:
        """``MAX_TREE_DEPTH = 32`` defines the module's *own* named
        constant — that is the cure for drift, not an instance of it.
        Re-defining a name that exists in specs/constants.py (same name,
        any value) is still flagged: two sources of truth."""
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            return False
        t = stmt.targets[0]
        if not isinstance(t, ast.Name) or not t.id.isupper():
            return False
        spec_names = {n for names in table.values() for n in names}
        return t.id not in spec_names

    @staticmethod
    def _idiom_literals(exprs: list[ast.AST]) -> set[ast.AST]:
        """Literals in positions that are byte/index plumbing, never spec
        values: slice bounds (``proof[:8]``), subscript indices
        (``m[2]``) and the length argument of ``int.to_bytes``
        (``x.to_bytes(32, 'little')``)."""
        out: set[ast.AST] = set()
        for expr in exprs:
            for node in ast.walk(expr):
                if isinstance(node, ast.Slice):
                    for part in (node.lower, node.upper, node.step):
                        if part is not None:
                            out.update(ast.walk(part))
                elif isinstance(node, ast.Subscript) and \
                        isinstance(node.slice, ast.Constant):
                    out.add(node.slice)
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "to_bytes" and node.args:
                    out.update(ast.walk(node.args[0]))
        return out

    @staticmethod
    def _is_bitmask_idiom(module: Module, node: ast.AST,
                          value: int) -> bool:
        """An all-ones value spelled in hex (0xFFFF...) is a bitmask, not
        spec-constant drift (keccak lane masks vs FAR_FUTURE_EPOCH)."""
        if value <= 0 or (value & (value + 1)) != 0:
            return False                # not 2**n - 1
        if not isinstance(node, ast.Constant):
            return False                # folded exprs like 2**64-1: flag
        line = module.source.splitlines()[node.lineno - 1]
        seg = line[node.col_offset:node.col_offset + 2].lower()
        return seg == "0x"
