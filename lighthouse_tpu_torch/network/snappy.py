"""Pure-Python snappy codec: raw/block format + the framing format.

The consensus wire spec uses snappy in both shapes (ref:
beacon_node/lighthouse_network/src/rpc/codec/ssz_snappy.rs): gossip
payloads are raw-snappy blocks, req/resp chunks are snappy FRAMES
(stream identifier + CRC32C-masked chunks).  No snappy library is baked
into this image, so both are implemented here; compression is a greedy
4-byte-hash matcher (valid output beats maximal ratio), decompression is
format-complete and bounds-checked.
"""
from __future__ import annotations

import struct

MAX_UNCOMPRESSED = 64 * 1024 * 1024

# -- varint -------------------------------------------------------------------


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    out = 0
    while True:
        if pos >= len(data) or shift > 35:
            raise ValueError("bad varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


# -- raw (block) format -------------------------------------------------------

def compress_block(data: bytes) -> bytes:
    """Greedy matcher: 4-byte hash table, 2-byte-offset copies."""
    n = len(data)
    out = bytearray(_uvarint(n))
    if n == 0:
        return bytes(out)
    table: dict[int, int] = {}
    i = 0
    lit_start = 0

    def emit_literal(start: int, end: int) -> None:
        length = end - start
        while length > 0:
            take = min(length, 60)
            if take < 60:
                out.append((take - 1) << 2)
            else:
                # use the 1-extra-byte form for runs of 60..255
                take = min(length, 256)
                out.append(60 << 2)
                out.append(take - 1)
            out.extend(data[start:start + take])
            start += take
            length -= take

    while i + 4 <= n:
        key = int.from_bytes(data[i:i + 4], "little")
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and \
                data[cand:cand + 4] == data[i:i + 4]:
            emit_literal(lit_start, i)
            # extend the match
            m = 4
            while i + m < n and m < 64 and data[cand + m] == data[i + m]:
                m += 1
            offset = i - cand
            # copy with 2-byte offset: tag 10, len 1..64
            out.append(((m - 1) << 2) | 2)
            out += struct.pack("<H", offset)
            i += m
            lit_start = i
        else:
            i += 1
    emit_literal(lit_start, n)
    return bytes(out)


def decompress_block(data: bytes, max_len: int = MAX_UNCOMPRESSED) -> bytes:
    want, pos = _read_uvarint(data, 0)
    if want > max_len:
        raise ValueError("snappy: declared size too large")
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                       # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    raise ValueError("snappy: truncated literal length")
                length = int.from_bytes(data[pos:pos + extra], "little") + 1
                pos += extra
            if pos + length > n:
                raise ValueError("snappy: truncated literal")
            out += data[pos:pos + length]
            pos += length
        else:                               # copy
            if kind == 1:
                length = ((tag >> 2) & 0x7) + 4
                if pos + 1 > n:
                    raise ValueError("snappy: truncated copy-1")
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:
                length = (tag >> 2) + 1
                if pos + 2 > n:
                    raise ValueError("snappy: truncated copy-2")
                offset = struct.unpack_from("<H", data, pos)[0]
                pos += 2
            else:
                length = (tag >> 2) + 1
                if pos + 4 > n:
                    raise ValueError("snappy: truncated copy-4")
                offset = struct.unpack_from("<I", data, pos)[0]
                pos += 4
            if offset == 0 or offset > len(out):
                raise ValueError("snappy: bad copy offset")
            if len(out) + length > max_len:
                raise ValueError("snappy: output too large")
            start = len(out) - offset
            for k in range(length):        # may self-overlap (RLE)
                out.append(out[start + k])
    if len(out) != want:
        raise ValueError("snappy: length mismatch")
    return bytes(out)


# -- CRC32C (Castagnoli, reflected 0x82F63B78) --------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- framing format -----------------------------------------------------------

_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_MAX_CHUNK = 65536


def compress_frames(data: bytes) -> bytes:
    out = bytearray(_STREAM_ID)
    for off in range(0, max(len(data), 1), _MAX_CHUNK):
        chunk = data[off:off + _MAX_CHUNK]
        crc = struct.pack("<I", _masked_crc(chunk))
        comp = compress_block(chunk)
        if len(comp) < len(chunk):
            body = crc + comp
            out += b"\x00" + struct.pack("<I", len(body))[:3] + body
        else:
            body = crc + chunk
            out += b"\x01" + struct.pack("<I", len(body))[:3] + body
    return bytes(out)


def decompress_frames(data: bytes, max_len: int = MAX_UNCOMPRESSED) -> bytes:
    if not data.startswith(_STREAM_ID):
        raise ValueError("snappy-frames: missing stream identifier")
    pos = len(_STREAM_ID)
    out = bytearray()
    while pos < len(data):
        if pos + 4 > len(data):
            raise ValueError("snappy-frames: truncated chunk header")
        kind = data[pos]
        length = int.from_bytes(data[pos + 1:pos + 4], "little")
        pos += 4
        if pos + length > len(data):
            raise ValueError("snappy-frames: truncated chunk")
        body = data[pos:pos + length]
        pos += length
        if kind == 0x00 or kind == 0x01:
            if length < 4:
                raise ValueError("snappy-frames: chunk too short")
            want_crc = struct.unpack("<I", body[:4])[0]
            payload = (decompress_block(body[4:], max_len) if kind == 0
                       else body[4:])
            if _masked_crc(payload) != want_crc:
                raise ValueError("snappy-frames: CRC mismatch")
            out += payload
            if len(out) > max_len:
                raise ValueError("snappy-frames: output too large")
        elif kind == 0xFF:
            if body != _STREAM_ID[4:]:
                raise ValueError("snappy-frames: bad stream identifier")
        elif 0x80 <= kind <= 0xFE:
            continue                        # skippable padding
        else:
            raise ValueError(f"snappy-frames: reserved chunk {kind:#x}")
    return bytes(out)
