"""ssz-schema: container declarations must BE their SSZ schema.

The ``@container`` decorator builds ``__ssz_fields__`` from the class
``__annotations__`` at runtime, keeping only annotations that are SSZ
type *instances* (ssz/types.py:164-174). Two silent failure modes
follow, both root-changing:

1. ``from __future__ import annotations`` in a container module
   stringifies every annotation, so the decorator sees no SSZ types and
   the container serializes to **zero fields** — containers/core.py
   carries a hand-written NOTE about exactly this; the rule makes it
   mechanical.
2. a field annotated with a non-SSZ type (``int``, ``bytes``, a typo'd
   name) is silently dropped from the schema: the attribute exists in
   Python, vanishes on the wire, and every tree-hash downstream is
   wrong. Field order is root-determining, so a dropped field shifts
   every later sibling.

Also flagged: bare (non-annotated) class-level assignments in a
container body — they look like fields but are invisible to SSZ.
"""
from __future__ import annotations

import ast

from ..engine import Module, Project, Rule, dotted_name, rule

#: names producing SSZ type instances (ssz/types.py singletons + factories)
_SSZ_NAMES = {
    "boolean", "uint8", "uint16", "uint32", "uint64", "uint128", "uint256",
    "Bytes4", "Bytes8", "Bytes20", "Bytes32", "Bytes48", "Bytes96", "Root",
}
_SSZ_FACTORIES = {"List", "Vector", "Bitlist", "Bitvector", "ByteList",
                  "ByteVector", "Union"}
#: class-level names that are legitimately not SSZ fields
_ALLOWED_ATTRS = {"ssz_type", "fork_name"}


def _container_classes(tree: ast.Module) -> list[ast.ClassDef]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for dec in node.decorator_list:
                if dotted_name(dec).split(".")[-1] == "container":
                    out.append(node)
    return out


def _is_ssz_annotation(ann: ast.AST) -> bool:
    name = dotted_name(ann)
    if name.split(".")[-1] in _SSZ_NAMES:
        return True
    if isinstance(ann, ast.Attribute) and ann.attr == "ssz_type":
        return True                        # nested container reference
    if isinstance(ann, ast.Call):
        fn = dotted_name(ann.func).split(".")[-1]
        return fn in _SSZ_FACTORIES
    if isinstance(ann, ast.Subscript):     # Vector[...] style, if ever used
        return dotted_name(ann.value).split(".")[-1] in _SSZ_FACTORIES
    # locally-computed annotation exprs (e.g. a variable holding List(...))
    if isinstance(ann, ast.Name):
        return False
    return False


@rule
class SszSchemaRule(Rule):
    name = "ssz-schema"
    description = ("container fields whose annotations are invisible to "
                   "the SSZ schema (stringified or non-SSZ types)")

    def check_module(self, module: Module, project: Project) -> list:
        classes = _container_classes(module.tree)
        if not classes:
            return []
        out = []
        future_ann = None
        for node in module.tree.body:
            if isinstance(node, ast.ImportFrom) and \
                    node.module == "__future__":
                for alias in node.names:
                    if alias.name == "annotations":
                        future_ann = node
        if future_ann is not None:
            out.append(module.violation(
                self.name, future_ann,
                "'from __future__ import annotations' in a @container "
                "module stringifies field annotations — the decorator "
                "then sees ZERO SSZ fields and every container here "
                "serializes empty; remove it (containers/core.py NOTE)"))
        for cls in classes:
            for stmt in cls.body:
                if isinstance(stmt, ast.AnnAssign):
                    ann = stmt.annotation
                    target = stmt.target
                    fname = target.id if isinstance(target, ast.Name) \
                        else dotted_name(target)
                    if isinstance(ann, ast.Constant):
                        out.append(module.violation(
                            self.name, stmt,
                            f"field '{cls.name}.{fname}' has a string "
                            "annotation — invisible to the SSZ schema "
                            "(dropped from serialization and "
                            "tree-hash)", symbol=cls.name))
                    elif not _is_ssz_annotation(ann) and \
                            not isinstance(ann, ast.Name):
                        out.append(module.violation(
                            self.name, stmt,
                            f"field '{cls.name}.{fname}' annotation is "
                            "not an SSZ type expression — it will be "
                            "silently dropped from the schema, "
                            "shifting every later field's "
                            "tree-hash position", symbol=cls.name))
                    elif isinstance(ann, ast.Name) and \
                            ann.id not in _SSZ_NAMES and \
                            ann.id in ("int", "str", "bytes", "float",
                                       "bool"):
                        out.append(module.violation(
                            self.name, stmt,
                            f"field '{cls.name}.{fname}' annotated as "
                            f"Python '{ann.id}' — not an SSZ type, "
                            "silently dropped from the schema",
                            symbol=cls.name))
                elif isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        fname = dotted_name(t)
                        if fname and not fname.startswith("_") and \
                                fname not in _ALLOWED_ATTRS:
                            out.append(module.violation(
                                self.name, stmt,
                                f"bare assignment '{cls.name}.{fname}' "
                                "in a @container body looks like a "
                                "field but is invisible to SSZ — "
                                "annotate it with an SSZ type or move "
                                "it out", symbol=cls.name))
        return out
