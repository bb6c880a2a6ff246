"""store-atomicity: direct store mutations on crash-critical paths.

The crash-consistency contract (RECOVERY.md) is that block import, head
persistence, genesis anchoring and migration commit through
``HotColdDB.do_atomically`` — one CRC'd batch record per commit point, so
a ``kill -9`` can only land before-or-after, never between a block and
its post-state.  A direct ``store.put_block(...)`` / ``store.put_state``
/ ``store._put_meta`` on one of those paths silently re-opens the torn
window the batch API closed.

Scope:
- ``chain/`` and ``network/sync/`` modules: every direct call to a
  mutator is flagged — these layers must only speak StoreOp batches
  (``StoreOp.put_block(...)`` constructors are of course exempt).  This
  includes the graftflow replay commit sequences (``chain/replay/``),
  where the per-epoch ``do_atomically`` batch is the single
  commit point the crashpoint ladder recovers to — a bare per-block put
  inside a commit stage tears the epoch;
- ``store/hot_cold.py``: only inside the commit-sequence methods
  (``store_genesis`` / ``migrate_database`` / ``_migrate_database``) —
  the rest of the file IS the implementation of the single-put API and
  batches alike;
- this rule's fixture.

Non-critical single puts elsewhere (backfill anchor meta, schema stamps,
tooling) stay legal: per-record CRC already makes individual puts atomic;
only multi-write commit points need the batch.
"""
from __future__ import annotations

import ast

from ..engine import Module, Project, Rule, Violation, dotted_name, rule

_SCOPED = ("chain/", "network/sync/", "store/hot_cold.py",
           "store_atomicity")
#: store mutators that bypass the batch commit when called directly
_MUTATORS = {"put_block", "put_state", "_put_meta"}
#: hot_cold.py methods that are commit sequences (everything else in the
#: file is the storage API implementation itself)
_HOT_COLD_CRITICAL = {"store_genesis", "migrate_database",
                      "_migrate_database"}


class _Scan(ast.NodeVisitor):
    def __init__(self, rule_name: str, module: Module,
                 critical_only: bool):
        self.rule_name = rule_name
        self.module = module
        self.critical_only = critical_only
        self.stack: list[str] = []
        self.violations: list[Violation] = []
        self.visit(module.tree)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        last = name.split(".")[-1] if name else ""
        if last in _MUTATORS and "." in name:
            receiver = name.rsplit(".", 1)[0].split(".")[-1]
            if receiver != "StoreOp":       # batch-op constructors are the fix
                if not (self.critical_only and
                        (not self.stack or
                         self.stack[-1] not in _HOT_COLD_CRITICAL)):
                    qual = ".".join(self.stack) or "<module>"
                    self.violations.append(self.module.violation(
                        self.rule_name, node,
                        f"direct '{name}()' on a crash-critical path "
                        f"bypasses the atomic batch API — build StoreOp "
                        f"ops and commit them via "
                        f"HotColdDB.do_atomically so a crash cannot "
                        f"land between the writes",
                        symbol=qual))
        self.generic_visit(node)


@rule
class StoreAtomicityRule(Rule):
    name = "store-atomicity"
    description = ("direct put_block/put_state/_put_meta on import/"
                   "replay-commit/genesis/migrate/persist paths "
                   "bypassing the HotColdDB.do_atomically batch API")

    def summarize_module(self, module: Module, project: Project):
        rel = module.relpath
        if not any(part in rel for part in _SCOPED):
            return None
        critical_only = "store/hot_cold.py" in rel
        scan = _Scan(self.name, module, critical_only)
        if not scan.violations:
            return None
        return {"violations": [v.to_json() for v in scan.violations]}

    def finalize_project(self, ctx) -> list:
        out = []
        for _rel, d in ctx.data_for(self.name).items():
            out.extend(Violation(**v) for v in d["violations"])
        return out
