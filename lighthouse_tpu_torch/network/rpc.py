"""Req/resp RPC — the REAL eth2 stream protocol over yamux.

Each request runs on its own negotiated stream (ref: beacon_node/
lighthouse_network/src/rpc/protocol.rs:236-266 protocol ids;
rpc/codec/ssz_snappy.rs framing):

    protocol id:  /eth2/beacon_chain/req/<name>/<version>/ssz_snappy
    request:      varint(ssz_len) || snappy-frames(ssz)      (one payload;
                  metadata requests are empty)
    response:     chunk*  where chunk =
                  result(1B: 0 ok, 1 invalid, 2 server_error, 3 unavail)
                  || [4B fork-context, block chunks on v2 protocols]
                  || varint(ssz_len) || snappy-frames(ssz)
    requester half-closes (FIN) after the request; responder writes its
    chunks and closes.

A dict-level codec API sits above the wire
(handlers speak dicts / hex chunk strings); token-bucket rate limiting
per (peer, protocol) as in rpc/rate_limiter.rs.
"""
from __future__ import annotations

import hashlib
import struct
import threading
import time
from dataclasses import dataclass

from ..obs import tracing
from . import snappy
from .multistream import write_uvarint
from .yamux import Stream, YamuxEOF, YamuxError

RESULT_SUCCESS = 0
RESULT_INVALID_REQUEST = 1
RESULT_SERVER_ERROR = 2
RESULT_RESOURCE_UNAVAILABLE = 3
RESULT_RATE_LIMITED = 139       # lighthouse extension code


@dataclass
class StatusMessage:
    fork_digest: bytes
    finalized_root: bytes
    finalized_epoch: int
    head_root: bytes
    head_slot: int

    def to_json(self) -> dict:
        return {"fork_digest": self.fork_digest.hex(),
                "finalized_root": self.finalized_root.hex(),
                "finalized_epoch": self.finalized_epoch,
                "head_root": self.head_root.hex(),
                "head_slot": self.head_slot}

    @classmethod
    def from_json(cls, d: dict) -> "StatusMessage":
        return cls(bytes.fromhex(d["fork_digest"]),
                   bytes.fromhex(d["finalized_root"]),
                   int(d["finalized_epoch"]),
                   bytes.fromhex(d["head_root"]), int(d["head_slot"]))


# ---------------------------------------------------------------------------
# per-protocol SSZ codecs (dict <-> canonical SSZ bytes)
# ---------------------------------------------------------------------------

def _enc_status(d: dict) -> bytes:
    return (bytes.fromhex(d["fork_digest"])
            + bytes.fromhex(d["finalized_root"])
            + struct.pack("<Q", int(d["finalized_epoch"]))
            + bytes.fromhex(d["head_root"])
            + struct.pack("<Q", int(d["head_slot"])))


def _dec_status(b: bytes) -> dict:
    if len(b) != 84:
        raise ValueError("bad status size")
    return {"fork_digest": b[0:4].hex(), "finalized_root": b[4:36].hex(),
            "finalized_epoch": struct.unpack_from("<Q", b, 36)[0],
            "head_root": b[44:76].hex(),
            "head_slot": struct.unpack_from("<Q", b, 76)[0]}


def _enc_u64(key):
    def enc(d):
        return struct.pack("<Q", int((d or {}).get(key, 0)))

    def dec(b):
        if len(b) != 8:
            raise ValueError("bad u64 payload")
        return {key: struct.unpack("<Q", b)[0]}
    return enc, dec


def _enc_empty(_d) -> bytes:
    return b""


def _dec_empty(_b) -> dict:
    return {}


def _enc_metadata(d: dict) -> bytes:
    attnets = bytes.fromhex((d or {}).get("attnets", "00"))
    syncnets = bytes.fromhex((d or {}).get("syncnets", "00"))
    return struct.pack("<Q", int((d or {}).get("seq_number", 0))) \
        + attnets[:8].ljust(8, b"\x00") + syncnets[:1].ljust(1, b"\x00")


def _dec_metadata(b: bytes) -> dict:
    if len(b) not in (16, 17):      # v1 (no syncnets) tolerated
        raise ValueError("bad metadata size")
    return {"seq_number": struct.unpack_from("<Q", b)[0],
            "attnets": b[8:16].hex(),
            "syncnets": b[16:17].hex() if len(b) > 16 else "00"}


def _enc_by_range(d: dict) -> bytes:
    return struct.pack("<QQQ", int(d["start_slot"]), int(d["count"]),
                       int(d.get("step", 1)))


def _dec_by_range(b: bytes) -> dict:
    if len(b) != 24:
        raise ValueError("bad by_range size")
    s, c, st = struct.unpack("<QQQ", b)
    return {"start_slot": s, "count": c, "step": st}


def _enc_by_root(d: dict) -> bytes:
    roots = [bytes.fromhex(r) for r in d.get("roots", [])]
    if any(len(r) != 32 for r in roots):
        raise ValueError("bad root size")
    return b"".join(roots)


def _dec_by_root(b: bytes) -> dict:
    if len(b) % 32:
        raise ValueError("bad by_root size")
    return {"roots": [b[i:i + 32].hex() for i in range(0, len(b), 32)]}


def _enc_lc_bootstrap_req(d: dict) -> bytes:
    root = bytes.fromhex(d["root"])
    if len(root) != 32:
        raise ValueError("bad root size")
    return root


def _dec_lc_bootstrap_req(b: bytes) -> dict:
    if len(b) != 32:
        raise ValueError("bad root size")
    return {"root": b.hex()}


def _enc_lc_range_req(d: dict) -> bytes:
    return struct.pack("<QQ", int(d["start_period"]), int(d["count"]))


def _dec_lc_range_req(b: bytes) -> dict:
    if len(b) != 16:
        raise ValueError("bad range size")
    s, c = struct.unpack("<QQ", b)
    return {"start_period": s, "count": c}


def _enc_hexpayload(h) -> bytes:
    """Opaque context-prefixed payload chunks carried as hex strings."""
    return bytes.fromhex(h or "")


def _dec_hexpayload(b: bytes):
    return b.hex()


_PING_ENC, _PING_DEC = _enc_u64("seq")
_GOODBYE_ENC, _GOODBYE_DEC = _enc_u64("reason")


@dataclass(frozen=True)
class ProtocolSpec:
    name: str
    version: int
    enc_req: callable
    dec_req: callable
    enc_resp: callable
    dec_resp: callable
    #: response is a stream of context-prefixed chunks (each returned as
    #: a hex string), not a single SSZ payload
    chunked: bool = False
    #: v2 chunks lead with a 4-byte fork-context (blocks, LC updates)
    context_bytes: bool = False
    #: a response chunk is expected (goodbye tolerates none)
    expect_response: bool = True

    @property
    def id(self) -> str:
        return f"/eth2/beacon_chain/req/{self.name}/{self.version}" \
            "/ssz_snappy"


_SPECS = [
    ProtocolSpec("status", 1, _enc_status, _dec_status,
                 _enc_status, _dec_status),
    ProtocolSpec("goodbye", 1, _GOODBYE_ENC, _GOODBYE_DEC,
                 _enc_empty, _dec_empty, expect_response=False),
    ProtocolSpec("ping", 1, _PING_ENC, _PING_DEC, _PING_ENC, _PING_DEC),
    ProtocolSpec("metadata", 2, _enc_empty, _dec_empty,
                 _enc_metadata, _dec_metadata),
    ProtocolSpec("beacon_blocks_by_range", 2, _enc_by_range, _dec_by_range,
                 _enc_hexpayload, _dec_hexpayload, chunked=True,
                 context_bytes=True),
    ProtocolSpec("beacon_blocks_by_root", 2, _enc_by_root, _dec_by_root,
                 _enc_hexpayload, _dec_hexpayload, chunked=True,
                 context_bytes=True),
    ProtocolSpec("blob_sidecars_by_range", 1, _enc_by_range, _dec_by_range,
                 _enc_hexpayload, _dec_hexpayload, chunked=True,
                 context_bytes=True),
    ProtocolSpec("blob_sidecars_by_root", 1, _enc_by_root, _dec_by_root,
                 _enc_hexpayload, _dec_hexpayload, chunked=True,
                 context_bytes=True),
    ProtocolSpec("data_column_sidecars_by_range", 1, _enc_by_range,
                 _dec_by_range, _enc_hexpayload, _dec_hexpayload,
                 chunked=True, context_bytes=True),
    ProtocolSpec("data_column_sidecars_by_root", 1, _enc_by_root,
                 _dec_by_root, _enc_hexpayload, _dec_hexpayload,
                 chunked=True, context_bytes=True),
    ProtocolSpec("light_client_bootstrap", 1, _enc_lc_bootstrap_req,
                 _dec_lc_bootstrap_req, _enc_hexpayload, _dec_hexpayload,
                 chunked=True, context_bytes=True),
    ProtocolSpec("light_client_optimistic_update", 1, _enc_empty,
                 _dec_empty, _enc_hexpayload, _dec_hexpayload,
                 chunked=True, context_bytes=True),
    ProtocolSpec("light_client_finality_update", 1, _enc_empty,
                 _dec_empty, _enc_hexpayload, _dec_hexpayload,
                 chunked=True, context_bytes=True),
    ProtocolSpec("light_client_updates_by_range", 1, _enc_lc_range_req,
                 _dec_lc_range_req, _enc_hexpayload, _dec_hexpayload,
                 chunked=True, context_bytes=True),
]
SPECS: dict[str, ProtocolSpec] = {s.name: s for s in _SPECS}
BY_ID: dict[str, ProtocolSpec] = {s.id: s for s in _SPECS}


class RateLimiter:
    """Token bucket per (peer, protocol) (rpc/rate_limiter.rs)."""

    LIMITS = {"beacon_blocks_by_range": (128, 10.0),
              "beacon_blocks_by_root": (128, 10.0),
              "blob_sidecars_by_range": (128, 10.0),
              "blob_sidecars_by_root": (128, 10.0),
              "light_client_updates_by_range": (64, 10.0),
              "status": (16, 10.0), "ping": (16, 10.0),
              "metadata": (8, 10.0), "goodbye": (2, 10.0)}

    def __init__(self):
        self._buckets: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def allow(self, peer_id: str, protocol: str, cost: int = 1) -> bool:
        cap, window = self.LIMITS.get(protocol, (64, 10.0))
        now = time.monotonic()
        with self._lock:
            tokens, ts = self._buckets.get((peer_id, protocol), (cap, now))
            tokens = min(cap, tokens + (now - ts) * cap / window)
            if tokens < cost:
                self._buckets[(peer_id, protocol)] = (tokens, now)
                return False
            self._buckets[(peer_id, protocol)] = (tokens - cost, now)
            return True


# -- stream payload codec (varint + snappy frames) ----------------------------

MAX_PAYLOAD = 32 * 1024 * 1024


def write_payload(stream: Stream, ssz: bytes) -> None:
    stream.write(write_uvarint(len(ssz)) + snappy.compress_frames(ssz))


def read_payload(stream: Stream, timeout: float = 10.0) -> bytes:
    """varint(len) || snappy frames, decoded incrementally frame by
    frame (each snappy frame header carries its own length — the
    property the real codec exploits to know where a chunk ends)."""
    n = _read_stream_uvarint(stream, timeout)
    if n > MAX_PAYLOAD:
        raise ValueError(f"payload too large ({n})")
    out = bytearray()
    while len(out) < n:
        hdr = stream.read_exact(4, timeout)
        ftype = hdr[0]
        flen = int.from_bytes(hdr[1:4], "little")
        if flen > 1 << 24:
            raise ValueError("snappy frame too large")
        body = stream.read_exact(flen, timeout)
        if ftype == 0xFF:                   # stream identifier
            if body != snappy._STREAM_ID[4:]:
                raise ValueError("bad snappy stream id")
        elif ftype == 0x00:                 # compressed data
            raw = snappy.decompress_block(body[4:], MAX_PAYLOAD)
            if snappy._masked_crc(raw) != int.from_bytes(body[:4],
                                                         "little"):
                raise ValueError("snappy crc mismatch")
            out += raw
        elif ftype == 0x01:                 # uncompressed data
            raw = body[4:]
            if snappy._masked_crc(raw) != int.from_bytes(body[:4],
                                                         "little"):
                raise ValueError("snappy crc mismatch")
            out += raw
        elif 0x80 <= ftype <= 0xFD:
            continue                        # skippable padding
        else:
            raise ValueError(f"bad snappy frame type {ftype:#x}")
    if len(out) != n:
        raise ValueError(f"payload length mismatch {len(out)} != {n}")
    return bytes(out)


def _read_stream_uvarint(stream: Stream, timeout: float) -> int:
    shift = v = 0
    while True:
        b = stream.read_exact(1, timeout)[0]
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v
        shift += 7
        if shift > 63:
            raise ValueError("varint overflow")


def _req_id(spec, req_ssz: bytes) -> str:
    """Content-derived request id: both sides of a stream hold the exact
    same request bytes (the requester encodes them, the responder reads
    them), so hashing protocol id + payload yields a shared identifier
    WITHOUT any wire change — graftpath stitches rpc_request/rpc_serve
    spans across nodes on it."""
    if spec.name == "metadata":
        req_ssz = b""              # responder never reads a payload
    return hashlib.sha256(spec.id.encode() + req_ssz).hexdigest()[:16]


class RpcHandler:
    """Stream-per-request req/resp engine over the libp2p transport."""

    def __init__(self, transport):
        self.transport = transport
        self.node_label = (getattr(transport, "label", None)
                           or str(getattr(transport, "node_id", ""))[:8])
        self.handlers: dict[str, callable] = {}
        self.rate_limiter = RateLimiter()
        self.on_rate_limited = lambda peer, protocol: None
        transport.on_rpc_stream = self.serve_stream
        transport.rpc_protocols = [s.id for s in _SPECS]

    def register(self, protocol: str, handler) -> None:
        """handler(peer, request_dict) -> response object (per codec)."""
        self.handlers[protocol] = handler

    # -- requester side --------------------------------------------------------

    def request(self, peer, protocol: str, payload: dict,
                timeout: float = 10.0):
        spec = SPECS[protocol]
        req_ssz = spec.enc_req(payload or {})
        with tracing.span("rpc_request", protocol=spec.name,
                          req_id=_req_id(spec, req_ssz),
                          node=self.node_label):
            try:
                stream, _ = peer.open_protocol([spec.id], timeout)
            except Exception as e:
                raise TimeoutError(
                    f"rpc {protocol}: open failed: {e}") from None
            try:
                if req_ssz or spec.name != "metadata":
                    write_payload(stream, req_ssz)
                stream.close()                  # FIN: request complete
                if spec.chunked:
                    return self._read_chunks(spec, stream, timeout)
                return self._read_single(spec, stream, timeout)
            finally:
                if not stream.reset:
                    stream.close()

    def _read_result_byte(self, spec, stream, timeout: float) -> int | None:
        """-> result code, or None on CLEAN EOF only; a stall or RST
        raises (a truncated chunk stream must not look complete —
        sync would mis-penalize peers on 'short' batches otherwise)."""
        try:
            b = stream.read_exact(1, timeout)
        except YamuxEOF:
            return None
        except YamuxError as e:
            raise TimeoutError(f"rpc {spec.name}: {e}") from None
        return b[0]

    def _read_single(self, spec, stream, timeout: float):
        code = self._read_result_byte(spec, stream, timeout)
        if code is None:
            if not spec.expect_response:
                return {}
            raise TimeoutError(f"rpc {spec.name}: no response")
        if code != RESULT_SUCCESS:
            raise RuntimeError(f"rpc error {code}")
        return spec.dec_resp(read_payload(stream, timeout))

    def _read_chunks(self, spec, stream, timeout: float) -> list:
        out = []
        while True:
            code = self._read_result_byte(spec, stream, timeout)
            if code is None:
                return out                     # clean EOF: stream done
            if code != RESULT_SUCCESS:
                raise RuntimeError(f"rpc error {code}")
            ctx = stream.read_exact(4, timeout) if spec.context_bytes \
                else b""
            ssz = read_payload(stream, timeout)
            out.append(spec.dec_resp(ctx + ssz))

    # -- responder side --------------------------------------------------------

    def serve_stream(self, peer, protocol_id: str, stream: Stream) -> None:
        spec = BY_ID.get(protocol_id)
        if spec is None:
            stream.rst()
            return
        if not self.rate_limiter.allow(peer.node_id, spec.name):
            self.on_rate_limited(peer, spec.name)
            stream.write(bytes([RESULT_RATE_LIMITED]))
            write_payload(stream, b"rate limited")
            stream.close()
            return
        handler = self.handlers.get(spec.name)
        if handler is None:
            stream.write(bytes([RESULT_RESOURCE_UNAVAILABLE]))
            write_payload(stream, b"unsupported")
            stream.close()
            return
        try:
            req_ssz = b"" if spec.name == "metadata" \
                else read_payload(stream)
            req = spec.dec_req(req_ssz)
        except (ValueError, YamuxError, struct.error):
            stream.write(bytes([RESULT_INVALID_REQUEST]))
            write_payload(stream, b"bad request")
            stream.close()
            return
        try:
            with tracing.span("rpc_serve", protocol=spec.name,
                              req_id=_req_id(spec, req_ssz),
                              node=self.node_label):
                resp = handler(peer, req)
        except Exception:
            stream.write(bytes([RESULT_SERVER_ERROR]))
            write_payload(stream, b"server error")
            stream.close()
            return
        try:
            if spec.chunked:
                for chunk_hex in resp or []:
                    raw = spec.enc_resp(chunk_hex)
                    stream.write(bytes([RESULT_SUCCESS]))
                    if spec.context_bytes:
                        stream.write(raw[:4])
                        write_payload(stream, raw[4:])
                    else:
                        write_payload(stream, raw)
            elif spec.expect_response or resp:
                stream.write(bytes([RESULT_SUCCESS]))
                write_payload(stream, spec.enc_resp(resp))
            stream.close()
        except (YamuxError, OSError):
            pass
