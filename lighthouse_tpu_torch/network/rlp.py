"""Recursive Length Prefix (RLP) encoding — the Ethereum wire/identity
serialization used by ENRs (EIP-778) and discv5.

Wire-compatible with the `rlp` crate the reference pulls in for its ENR
handling (ref: beacon_node/lighthouse_network/src/discovery/enr.rs:186 —
the reference's ENRs are RLP records signed per EIP-778).

Items are either bytes (strings) or lists of items.  Integers are
encoded big-endian with no leading zeros (the canonical scalar form the
ENR spec requires); `decode` returns raw bytes, leaving scalar
interpretation to the caller.
"""
from __future__ import annotations


class RlpError(Exception):
    pass


def encode_int(v: int) -> bytes:
    """Canonical scalar: big-endian, no leading zeros, 0 -> empty."""
    if v < 0:
        raise RlpError("negative scalar")
    if v == 0:
        return b""
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


def decode_int(b: bytes) -> int:
    if b[:1] == b"\x00":
        raise RlpError("non-canonical scalar (leading zero)")
    return int.from_bytes(b, "big")


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    ll = encode_int(length)
    return bytes([offset + 55 + len(ll)]) + ll


def encode(item) -> bytes:
    """item: bytes | int | list (recursively)."""
    if isinstance(item, int):
        item = encode_int(item)
    if isinstance(item, (bytes, bytearray, memoryview)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _encode_length(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _encode_length(len(payload), 0xC0) + payload
    raise RlpError(f"cannot RLP-encode {type(item).__name__}")


def _decode_at(data: bytes, pos: int):
    """-> (item, next_pos); item is bytes or list."""
    if pos >= len(data):
        raise RlpError("truncated")
    b0 = data[pos]
    if b0 < 0x80:                       # single byte
        return data[pos:pos + 1], pos + 1
    if b0 < 0xB8:                       # short string
        n = b0 - 0x80
        end = pos + 1 + n
        if end > len(data):
            raise RlpError("truncated string")
        s = data[pos + 1:end]
        if n == 1 and s[0] < 0x80:
            raise RlpError("non-canonical single byte")
        return s, end
    if b0 < 0xC0:                       # long string
        ln = b0 - 0xB7
        if pos + 1 + ln > len(data):
            raise RlpError("truncated length")
        n = decode_int(data[pos + 1:pos + 1 + ln])
        if n < 56:
            raise RlpError("non-canonical long length")
        end = pos + 1 + ln + n
        if end > len(data):
            raise RlpError("truncated string")
        return data[pos + 1 + ln:end], end
    if b0 < 0xF8:                       # short list
        n = b0 - 0xC0
        end = pos + 1 + n
        if end > len(data):
            raise RlpError("truncated list")
        return _decode_list(data, pos + 1, end), end
    ln = b0 - 0xF7                      # long list
    if pos + 1 + ln > len(data):
        raise RlpError("truncated length")
    n = decode_int(data[pos + 1:pos + 1 + ln])
    if n < 56:
        raise RlpError("non-canonical long length")
    end = pos + 1 + ln + n
    if end > len(data):
        raise RlpError("truncated list")
    return _decode_list(data, pos + 1 + ln, end), end


def _decode_list(data: bytes, pos: int, end: int) -> list:
    out = []
    while pos < end:
        item, pos = _decode_at(data, pos)
        out.append(item)
    if pos != end:
        raise RlpError("list payload overrun")
    return out


def decode(data: bytes):
    item, end = _decode_at(bytes(data), 0)
    if end != len(data):
        raise RlpError(f"trailing bytes after RLP item ({len(data)-end})")
    return item
