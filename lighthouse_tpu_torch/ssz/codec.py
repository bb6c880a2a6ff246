"""SSZ serialize/deserialize (ethereum_ssz equivalent)."""
from __future__ import annotations

from typing import Any

from .types import (
    SSZType, Boolean, UInt, ByteVector, ByteList, Bitvector, Bitlist,
    Vector, List, Container, Union, UnionValue,
)

BYTES_PER_LENGTH_OFFSET = 4


class DeserializeError(ValueError):
    pass


def is_fixed_size(typ: SSZType) -> bool:
    if isinstance(typ, (Boolean, UInt, ByteVector, Bitvector)):
        return True
    if isinstance(typ, (ByteList, Bitlist, List, Union)):
        return False
    if isinstance(typ, Vector):
        return is_fixed_size(typ.elem)
    if isinstance(typ, Container):
        return all(is_fixed_size(t) for _, t in typ.fields)
    raise TypeError(f"unknown type {typ!r}")


def fixed_size(typ: SSZType) -> int:
    """Serialized size of a fixed-size type (offset slot size otherwise)."""
    if isinstance(typ, Boolean):
        return 1
    if isinstance(typ, UInt):
        return typ.byte_len
    if isinstance(typ, ByteVector):
        return typ.length
    if isinstance(typ, Bitvector):
        return (typ.length + 7) // 8
    if isinstance(typ, Vector) and is_fixed_size(typ.elem):
        return typ.length * fixed_size(typ.elem)
    if isinstance(typ, Container) and is_fixed_size(typ):
        return sum(fixed_size(t) for _, t in typ.fields)
    raise TypeError(f"{typ!r} is not fixed size")


def _pack_bits(bits, with_delimiter: bool) -> bytes:
    n = len(bits)
    total = n + (1 if with_delimiter else 0)
    out = bytearray((total + 7) // 8 if total else (1 if with_delimiter else 0))
    if with_delimiter and not out:
        out = bytearray(1)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    if with_delimiter:
        out[n // 8] |= 1 << (n % 8)
    return bytes(out)


def _unpack_bits(data: bytes, n: int) -> list[bool]:
    return [bool(data[i // 8] >> (i % 8) & 1) for i in range(n)]


def serialize(typ: SSZType, value: Any) -> bytes:
    if isinstance(typ, Boolean):
        return b"\x01" if value else b"\x00"
    if isinstance(typ, UInt):
        return int(value).to_bytes(typ.byte_len, "little")
    if isinstance(typ, ByteVector):
        b = bytes(value)
        if len(b) != typ.length:
            raise ValueError(f"ByteVector[{typ.length}] got {len(b)} bytes")
        return b
    if isinstance(typ, ByteList):
        b = bytes(value)
        if len(b) > typ.limit:
            raise ValueError("ByteList over limit")
        return b
    if isinstance(typ, Bitvector):
        if len(value) != typ.length:
            raise ValueError("Bitvector length mismatch")
        return _pack_bits(value, with_delimiter=False)
    if isinstance(typ, Bitlist):
        if len(value) > typ.limit:
            raise ValueError("Bitlist over limit")
        return _pack_bits(value, with_delimiter=True)
    if isinstance(typ, (Vector, List)):
        if isinstance(typ, Vector) and len(value) != typ.length:
            raise ValueError(f"Vector length {len(value)} != {typ.length}")
        if isinstance(typ, List) and len(value) > typ.limit:
            raise ValueError("List over limit")
        return _serialize_sequence([typ.elem] * len(value), value)
    if isinstance(typ, Container):
        types = [t for _, t in typ.fields]
        values = [getattr(value, n) for n, _ in typ.fields]
        return _serialize_sequence(types, values)
    if isinstance(typ, Union):
        assert isinstance(value, UnionValue)
        opt = typ.options[value.selector]
        body = b"" if opt is None else serialize(opt, value.value)
        return bytes([value.selector]) + body
    raise TypeError(f"cannot serialize {typ!r}")


def _serialize_sequence(types: list[SSZType], values: list[Any]) -> bytes:
    fixed_parts: list[bytes | None] = []
    variable_parts: list[bytes] = []
    for t, v in zip(types, values):
        if is_fixed_size(t):
            fixed_parts.append(serialize(t, v))
            variable_parts.append(b"")
        else:
            fixed_parts.append(None)
            variable_parts.append(serialize(t, v))
    fixed_len = sum(
        len(p) if p is not None else BYTES_PER_LENGTH_OFFSET
        for p in fixed_parts)
    out = bytearray()
    offset = fixed_len
    for p, v in zip(fixed_parts, variable_parts):
        if p is not None:
            out += p
        else:
            out += offset.to_bytes(BYTES_PER_LENGTH_OFFSET, "little")
            offset += len(v)
    for v in variable_parts:
        out += v
    return bytes(out)


def deserialize(typ: SSZType, data: bytes) -> Any:
    if isinstance(typ, Boolean):
        if data == b"\x01":
            return True
        if data == b"\x00":
            return False
        raise DeserializeError("bad boolean")
    if isinstance(typ, UInt):
        if len(data) != typ.byte_len:
            raise DeserializeError("bad uint length")
        return int.from_bytes(data, "little")
    if isinstance(typ, ByteVector):
        if len(data) != typ.length:
            raise DeserializeError("bad ByteVector length")
        return bytes(data)
    if isinstance(typ, ByteList):
        if len(data) > typ.limit:
            raise DeserializeError("ByteList over limit")
        return bytes(data)
    if isinstance(typ, Bitvector):
        if len(data) != (typ.length + 7) // 8:
            raise DeserializeError("bad Bitvector length")
        if typ.length % 8 and data[-1] >> (typ.length % 8):
            raise DeserializeError("Bitvector high bits set")
        return _unpack_bits(data, typ.length)
    if isinstance(typ, Bitlist):
        if not data:
            raise DeserializeError("empty Bitlist payload")
        last = data[-1]
        if last == 0:
            raise DeserializeError("missing Bitlist delimiter")
        n = (len(data) - 1) * 8 + last.bit_length() - 1
        if n > typ.limit:
            raise DeserializeError("Bitlist over limit")
        return _unpack_bits(data, n)
    if isinstance(typ, Vector):
        if is_fixed_size(typ.elem):
            es = fixed_size(typ.elem)
            if len(data) != es * typ.length:
                raise DeserializeError("bad Vector length")
            return [deserialize(typ.elem, data[i * es:(i + 1) * es])
                    for i in range(typ.length)]
        parts = _split_variable(data)
        if len(parts) != typ.length:
            raise DeserializeError("bad Vector element count")
        return [deserialize(typ.elem, p) for p in parts]
    if isinstance(typ, List):
        if is_fixed_size(typ.elem):
            es = fixed_size(typ.elem)
            if es == 0 or len(data) % es:
                raise DeserializeError("bad List length")
            n = len(data) // es
            if n > typ.limit:
                raise DeserializeError("List over limit")
            return [deserialize(typ.elem, data[i * es:(i + 1) * es])
                    for i in range(n)]
        parts = _split_variable(data)
        if len(parts) > typ.limit:
            raise DeserializeError("List over limit")
        return [deserialize(typ.elem, p) for p in parts]
    if isinstance(typ, Container):
        return _deserialize_container(typ, data)
    if isinstance(typ, Union):
        if not data:
            raise DeserializeError("empty union")
        sel = data[0]
        if sel >= len(typ.options):
            raise DeserializeError("bad union selector")
        opt = typ.options[sel]
        if opt is None:
            if len(data) != 1:
                raise DeserializeError("None union with body")
            return UnionValue(0, None)
        return UnionValue(sel, deserialize(opt, data[1:]))
    raise TypeError(f"cannot deserialize {typ!r}")


def _split_variable(data: bytes) -> list[bytes]:
    """Split an all-variable-size sequence body by its offset table."""
    if not data:
        return []
    first = int.from_bytes(data[:BYTES_PER_LENGTH_OFFSET], "little")
    if first % BYTES_PER_LENGTH_OFFSET or first == 0:
        raise DeserializeError("bad first offset")
    if first > len(data):
        # bound BEFORE allocating the offset table: a corrupted first
        # offset must not drive a multi-GB allocation (r5 fuzz review)
        raise DeserializeError("first offset beyond data")
    n = first // BYTES_PER_LENGTH_OFFSET
    offsets = [int.from_bytes(
        data[i * 4:(i + 1) * 4], "little") for i in range(n)]
    offsets.append(len(data))
    parts = []
    for i in range(n):
        if offsets[i] > offsets[i + 1] or offsets[i] > len(data):
            raise DeserializeError("offsets not monotonic")
        parts.append(data[offsets[i]:offsets[i + 1]])
    return parts


def _deserialize_container(typ: Container, data: bytes) -> Any:
    pos = 0
    fixed_raw: list[tuple[str, SSZType, bytes | int]] = []
    offsets: list[int] = []
    for name, t in typ.fields:
        if is_fixed_size(t):
            es = fixed_size(t)
            fixed_raw.append((name, t, data[pos:pos + es]))
            pos += es
        else:
            off = int.from_bytes(data[pos:pos + 4], "little")
            fixed_raw.append((name, t, off))
            offsets.append(off)
            pos += 4
    if not offsets and len(data) != pos:
        # fully-fixed container: decoding must consume EVERY byte —
        # trailing garbage is a distinct wire form for the same value
        # (found by the r5 SSZ fuzzer, tests/test_fuzz.py)
        raise DeserializeError("container length mismatch")
    offsets.append(len(data))
    if len(offsets) > 1 and offsets[0] != pos:
        raise DeserializeError("first offset != fixed size")
    kw = {}
    oi = 0
    for name, t, raw in fixed_raw:
        if isinstance(raw, int):
            start, end = offsets[oi], offsets[oi + 1]
            if start > end or end > len(data):
                raise DeserializeError("bad container offsets")
            kw[name] = deserialize(t, data[start:end])
            oi += 1
        else:
            if len(raw) != fixed_size(t):
                raise DeserializeError("container truncated")
            kw[name] = deserialize(t, raw)
    return typ.cls(**kw)
