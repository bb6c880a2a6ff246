"""SSZ type descriptors.

Each SSZ type is an instance of an SSZType subclass. Containers are Python
dataclasses declared with the ``@container`` decorator whose field annotations
*are* SSZType instances:

    @container
    class Checkpoint:
        epoch: uint64
        root: Root

Values are plain Python: int, bool, bytes, list, dataclass instances.
"""
from __future__ import annotations

import dataclasses
from typing import Any


class SSZType:
    """Base descriptor; concrete logic lives in codec.py / merkle.py."""

    def __repr__(self) -> str:  # pragma: no cover
        return self.__class__.__name__


class Boolean(SSZType):
    pass


class UInt(SSZType):
    def __init__(self, byte_len: int):
        assert byte_len in (1, 2, 4, 8, 16, 32)
        self.byte_len = byte_len

    def __repr__(self) -> str:
        return f"uint{self.byte_len * 8}"


class ByteVector(SSZType):
    def __init__(self, length: int):
        assert length > 0
        self.length = length

    def __repr__(self) -> str:
        return f"ByteVector[{self.length}]"


class ByteList(SSZType):
    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self) -> str:
        return f"ByteList[{self.limit}]"


class Bitvector(SSZType):
    def __init__(self, length: int):
        assert length > 0
        self.length = length

    def __repr__(self) -> str:
        return f"Bitvector[{self.length}]"


class Bitlist(SSZType):
    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self) -> str:
        return f"Bitlist[{self.limit}]"


class Vector(SSZType):
    def __init__(self, elem: SSZType, length: int):
        assert length > 0
        self.elem = elem
        self.length = length

    def __repr__(self) -> str:
        return f"Vector[{self.elem!r}, {self.length}]"


class List(SSZType):
    def __init__(self, elem: SSZType, limit: int):
        self.elem = elem
        self.limit = limit

    def __repr__(self) -> str:
        return f"List[{self.elem!r}, {self.limit}]"


class Container(SSZType):
    """Descriptor wrapping a @container dataclass."""

    def __init__(self, cls: type):
        self.cls = cls
        self.fields: list[tuple[str, SSZType]] = list(cls.__ssz_fields__.items())

    def __repr__(self) -> str:
        return self.cls.__name__


class Union(SSZType):
    """SSZ Union[None | T1 | T2 ...]; options[i] may be None (only at index 0)."""

    def __init__(self, options: list[SSZType | None]):
        assert 1 <= len(options) <= 128
        assert all(o is None for o in options[:1] if o is None)
        self.options = options


@dataclasses.dataclass
class UnionValue:
    selector: int
    value: Any


# ---------------------------------------------------------------------------
# Canonical basic-type singletons
# ---------------------------------------------------------------------------

boolean = Boolean()
uint8 = UInt(1)
uint16 = UInt(2)
uint32 = UInt(4)
uint64 = UInt(8)
uint128 = UInt(16)
uint256 = UInt(32)

Bytes4 = ByteVector(4)
Bytes8 = ByteVector(8)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)
Root = Bytes32


def default_value(typ: SSZType) -> Any:
    """The SSZ default (zeroed) value for a type."""
    if isinstance(typ, Boolean):
        return False
    if isinstance(typ, UInt):
        return 0
    if isinstance(typ, ByteVector):
        return b"\x00" * typ.length
    if isinstance(typ, ByteList):
        return b""
    if isinstance(typ, Bitvector):
        return [False] * typ.length
    if isinstance(typ, (Bitlist, List)):
        return []
    if isinstance(typ, Vector):
        return [default_value(typ.elem) for _ in range(typ.length)]
    if isinstance(typ, Container):
        return typ.cls()
    if isinstance(typ, Union):
        first = typ.options[0]
        return UnionValue(0, None if first is None else default_value(first))
    raise TypeError(f"no default for {typ!r}")


def container(cls: type) -> type:
    """Decorator: turn an annotated class into an SSZ container dataclass.

    Adds: ``__ssz_fields__`` (name -> SSZType), ``ssz_type`` (Container
    descriptor), per-field zeroed defaults, and a ``copy()`` deep-copy helper.
    """
    ssz_fields: dict[str, SSZType] = {}
    for name, ann in cls.__dict__.get("__annotations__", {}).items():
        if isinstance(ann, SSZType):
            ssz_fields[name] = ann
    cls.__ssz_fields__ = ssz_fields

    # dataclass defaults: zeroed SSZ values (mutable ones via factories)
    for name, typ in ssz_fields.items():
        if not hasattr(cls, name):
            if isinstance(typ, (Boolean, UInt, ByteVector, ByteList)):
                setattr(cls, name, dataclasses.field(
                    default=default_value(typ)))
            else:
                setattr(cls, name, dataclasses.field(
                    default_factory=lambda t=typ: default_value(t)))
    dc = dataclasses.dataclass(cls)
    dc.ssz_type = Container(dc)

    def copy(self):
        out = {}
        for name, typ in ssz_fields.items():
            out[name] = _copy_value(typ, getattr(self, name))
        return dc(**out)

    dc.copy = copy
    return dc


def _copy_value(typ: SSZType, v: Any) -> Any:
    if isinstance(typ, (Boolean, UInt, ByteVector, ByteList)):
        return v
    if isinstance(typ, (Bitvector, Bitlist)):
        return list(v)
    if isinstance(typ, (Vector, List)):
        return [_copy_value(typ.elem, e) for e in v]
    if isinstance(typ, Container):
        return v.copy()
    if isinstance(typ, Union):
        opt = typ.options[v.selector]
        return UnionValue(v.selector,
                          None if opt is None else _copy_value(opt, v.value))
    raise TypeError(f"cannot copy {typ!r}")


def field_types(value: Any) -> list[tuple[str, SSZType]]:
    return list(type(value).__ssz_fields__.items())
