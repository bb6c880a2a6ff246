"""Spec JSON representation of SSZ values.

The Beacon API's JSON wire form (eth2.0-APIs): uint64 as decimal strings,
byte vectors/lists as 0x-hex, bitfields as 0x-hex of their SSZ encoding,
containers as objects — the same representation `serde` derives give the
reference's types (common/eth2/src/types.rs).  Used by the v2 block/state
GET endpoints and everything that returns whole SSZ containers.
"""
from __future__ import annotations

from ..ssz import serialize
from ..ssz import types as T


def to_spec_json(typ, v):
    if isinstance(typ, T.Boolean):
        return bool(v)
    if isinstance(typ, T.UInt):
        return str(int(v))
    if isinstance(typ, (T.ByteVector, T.ByteList)):
        return "0x" + bytes(v).hex()
    if isinstance(typ, (T.Bitvector, T.Bitlist)):
        return "0x" + serialize(typ, v).hex()
    if isinstance(typ, (T.Vector, T.List)):
        return [to_spec_json(typ.elem, x) for x in _iter_elems(v)]
    if isinstance(typ, T.Container):
        return {name: to_spec_json(ft, getattr(v, name))
                for name, ft in typ.fields}
    if isinstance(typ, T.Union):
        sel = v.selector
        opt = typ.options[sel]
        return {"selector": sel,
                "value": None if opt is None else to_spec_json(opt, v.value)}
    # unknown leaf: hex of its encoding
    return "0x" + serialize(typ, v).hex()


def _iter_elems(v):
    try:
        return list(v)
    except TypeError:
        return []


def container_json(value) -> dict:
    """JSON form of a @container dataclass instance."""
    return to_spec_json(type(value).ssz_type, value)
