"""serving-cache-discipline: coalesced endpoints must use the tier.

A serving tier (``api/serving/``) stands between the HTTP router
and ``api/backend.py``: attestation_data, duties, headers, and the
light-client objects are coalesced, cached under the current head root,
and priority-shed there.  A handler in ``api/http_server.py`` that calls
the backend directly for one of those endpoints silently reopens the
thundering herd the tier closed — every poll recomputes, nothing is
invalidated on reorg, and the admission queue never sees the load.

Scope: ``api/http_server.py`` and this rule's fixture only.  The tier
itself (``api/serving/tier.py``) is of course allowed to call the
backend — that is the one sanctioned path — and backend-internal calls
are out of scope.
"""
from __future__ import annotations

import ast

from ..engine import Module, Project, Rule, Violation, dotted_name, rule

_SCOPED = ("api/http_server.py", "serving_cache_discipline")
#: backend methods fronted by the serving tier; a direct router call to
#: any of these bypasses coalescing + caching + shedding
_COALESCED = {
    "attestation_data",
    "get_attester_duties",
    "get_proposer_duties",
    "headers",
    "light_client_bootstrap",
    "light_client_finality_update",
    "light_client_optimistic_update",
    "light_client_updates",
}


class _Scan(ast.NodeVisitor):
    def __init__(self, rule_name: str, module: Module):
        self.rule_name = rule_name
        self.module = module
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
        if last in _COALESCED and "." in name:
            receiver = name.rsplit(".", 1)[0].split(".")[-1]
            if "backend" in receiver.lower():
                qual = ".".join(self.stack) or "<module>"
                self.violations.append(self.module.violation(
                    self.rule_name, node,
                    f"direct '{name}()' bypasses the serving tier for a "
                    f"coalesced endpoint — route through "
                    f"ServingTier.{last.replace('get_', '')} so the "
                    f"request is coalesced, cached under the current "
                    f"head, and priority-shed under load",
                    symbol=qual))
        self.generic_visit(node)


@rule
class ServingCacheDisciplineRule(Rule):
    name = "serving-cache-discipline"
    description = ("http_server handlers calling backend duties/"
                   "attestation_data/headers/light-client methods "
                   "directly instead of through the api/serving tier")

    def summarize_module(self, module: Module, project: Project):
        rel = module.relpath
        if not any(part in rel for part in _SCOPED):
            return None
        scan = _Scan(self.name, module)
        if not scan.violations:
            return None
        return {"violations": [v.to_json() for v in scan.violations]}

    def finalize_project(self, ctx) -> list:
        out = []
        for _rel, d in ctx.data_for(self.name).items():
            out.extend(Violation(**v) for v in d["violations"])
        return out
