"""multistream-select 1.0 — libp2p's protocol negotiation wire format.

Every libp2p connection/stream opens with this exchange (ref:
beacon_node/lighthouse_network/src/service/utils.rs build_transport —
the upgrade path core-upgrade::apply uses multistream-select):

    varint-length-prefixed lines, each ending "\\n":
      both sides:  "/multistream/1.0.0\\n"
      initiator:   "<protocol>\\n"
      responder:   echo the protocol to accept, or "na\\n" to refuse.

The varint is unsigned LEB128 and the length INCLUDES the trailing
newline — `/multistream/1.0.0` frames as 0x13 + 19 bytes.
"""
from __future__ import annotations

MULTISTREAM = "/multistream/1.0.0"
NA = "na"


class MultistreamError(Exception):
    pass


def write_uvarint(n: int) -> bytes:
    out = b""
    while n >= 0x80:
        out += bytes([(n & 0x7F) | 0x80])
        n >>= 7
    return out + bytes([n])


def read_uvarint(read_exact) -> int:
    """read_exact(n) -> bytes; decodes one LEB128 varint."""
    shift = v = 0
    while True:
        b = read_exact(1)[0]
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v
        shift += 7
        if shift > 63:
            raise MultistreamError("varint overflow")


def encode_msg(proto: str) -> bytes:
    line = proto.encode() + b"\n"
    return write_uvarint(len(line)) + line


def decode_msg(read_exact) -> str:
    n = read_uvarint(read_exact)
    if n == 0 or n > 1024:
        raise MultistreamError(f"bad message length {n}")
    line = read_exact(n)
    if line[-1:] != b"\n":
        raise MultistreamError("message missing newline")
    return line[:-1].decode()


class _SockIO:
    """Adapts a blocking socket to read_exact/write."""

    def __init__(self, sock):
        self.sock = sock

    def read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise MultistreamError("connection closed mid-negotiation")
            buf += chunk
        return buf

    def write(self, data: bytes) -> None:
        self.sock.sendall(data)


def negotiate_out(io, protocols: list[str]) -> str:
    """Dial side: propose protocols in order; -> the accepted one.
    `io` needs read_exact(n) and write(bytes) (socket via _SockIO, or a
    yamux/noise stream adapter)."""
    if hasattr(io, "recv"):
        io = _SockIO(io)
    io.write(encode_msg(MULTISTREAM))
    hello = decode_msg(io.read_exact)
    if hello != MULTISTREAM:
        raise MultistreamError(f"bad multistream hello {hello!r}")
    for proto in protocols:
        io.write(encode_msg(proto))
        resp = decode_msg(io.read_exact)
        if resp == proto:
            return proto
        if resp != NA:
            raise MultistreamError(f"unexpected response {resp!r}")
    raise MultistreamError(f"all protocols refused: {protocols}")


def negotiate_in(io, supported: list[str], max_proposals: int = 16) -> str:
    """Listen side: accept the first supported proposal."""
    if hasattr(io, "recv"):
        io = _SockIO(io)
    hello = decode_msg(io.read_exact)
    if hello != MULTISTREAM:
        raise MultistreamError(f"bad multistream hello {hello!r}")
    io.write(encode_msg(MULTISTREAM))
    for _ in range(max_proposals):
        proposal = decode_msg(io.read_exact)
        if proposal in supported:
            io.write(encode_msg(proposal))
            return proposal
        io.write(encode_msg(NA))
    raise MultistreamError("too many refused proposals")
