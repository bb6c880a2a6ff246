"""cow-discipline: writes must not bypass the CoW column API.

``containers/cow.py`` keeps state columns as refcounted chunk lists:
``col[rows] = v`` privatizes the touched chunks AND records the dirty
merkle leaves.  Two write patterns silently break both invariants:

1. reaching into the column internals — ``col._base[...] = v`` or
   ``col._chunks[c][...] = v`` skips the refcount (corrupting every
   fork sharing the chunk) and the dirty set (stale roots);
2. writing through a densified alias — ``np.asarray(state.balances)``
   (or ``np.ascontiguousarray``) hands back the backing array, so
   subscript-assigning it has the same two failure modes.  Reads
   through ``asarray`` are fine and common.

``self._base``/``self._chunks`` writes inside the column implementation
are the API itself and stay exempt.
"""
from __future__ import annotations

import ast

from ..engine import Module, Project, Rule, dotted_name, rule

#: attribute names that are CoW-backed columns on BeaconState /
#: ValidatorRegistry (containers/state.py _COLUMN_CACHES, _VEC_COLUMNS,
#: ValidatorRegistry.COLUMNS)
_COW_FIELDS = {
    "balances", "inactivity_scores",
    "previous_epoch_participation", "current_epoch_participation",
    "block_roots", "state_roots", "randao_mixes", "slashings",
    "pubkeys", "withdrawal_credentials", "effective_balance",
    "slashed", "activation_eligibility_epoch", "activation_epoch",
    "exit_epoch", "withdrawable_epoch",
}
_DENSIFIERS = {"asarray", "ascontiguousarray"}


def _subscript_root(node: ast.AST) -> ast.AST:
    """Peel nested subscripts: ``x._chunks[c][o]`` -> ``x._chunks``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node


def _is_internal_reach(node: ast.AST) -> ast.Attribute | None:
    """``<expr>._base`` / ``<expr>._chunks`` (not on ``self``)."""
    if isinstance(node, ast.Attribute) and node.attr in ("_base", "_chunks"):
        owner = dotted_name(node.value)
        if owner != "self":
            return node
    return None


def _is_densified_column(node: ast.AST) -> ast.Call | None:
    """``np.asarray(<...>.cow_field)`` / ``ascontiguousarray(...)``."""
    if isinstance(node, ast.Call) and node.args:
        fn = dotted_name(node.func).split(".")[-1]
        if fn in _DENSIFIERS:
            arg = node.args[0]
            if isinstance(arg, ast.Attribute) and arg.attr in _COW_FIELDS:
                return node
    return None


@rule
class CowDisciplineRule(Rule):
    name = "cow-discipline"
    description = ("in-place writes bypassing the CoW column API "
                   "(col._base/_chunks or a densified asarray alias)")

    def check_module(self, module: Module, project: Project) -> list:
        out = []
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
            else:
                continue
            for tgt in targets:
                if not isinstance(tgt, ast.Subscript):
                    continue
                root = _subscript_root(tgt)
                reach = _is_internal_reach(root)
                if reach is not None:
                    out.append(module.violation(
                        self.name, tgt,
                        f"write through the CoW column internals "
                        f"'{dotted_name(reach)}' skips the chunk "
                        f"refcount and the dirty-leaf set — use "
                        f"'col[rows] = value' / mark_dirty_many",
                        symbol=dotted_name(reach)))
                    continue
                dens = _is_densified_column(root)
                if dens is not None:
                    arg = dotted_name(dens.args[0])
                    out.append(module.violation(
                        self.name, tgt,
                        f"subscript-assigning the densified alias of "
                        f"CoW column '{arg}' bypasses copy-on-write "
                        f"and dirty tracking — write through the "
                        f"column: '{arg}[rows] = value'",
                        symbol=arg))
        return out
