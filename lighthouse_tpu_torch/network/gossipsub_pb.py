"""Gossipsub RPC protobufs — the real meshsub wire format.

Hand-rolled proto2 encoding of the RPC schema every libp2p gossipsub
implementation shares (ref: the reference vendors it at
beacon_node/lighthouse_network/gossipsub/src/rpc.proto /
generated/gossipsub/pb/mod.rs; protocol ids /meshsub/1.1.0, /meshsub/
1.2.0 in gossipsub/src/protocol.rs):

    message RPC {
      repeated SubOpts subscriptions = 1;
      repeated Message publish = 2;
      optional ControlMessage control = 3;
    }
    message SubOpts   { bool subscribe = 1; string topic_id = 2; }
    message Message   { bytes from = 1; bytes data = 2; bytes seqno = 3;
                        string topic = 4; bytes signature = 5;
                        bytes key = 6; }
    message ControlMessage {
      repeated ControlIHave ihave = 1;      // topic + message_ids
      repeated ControlIWant iwant = 2;      // message_ids
      repeated ControlGraft graft = 3;      // topic
      repeated ControlPrune prune = 4;      // topic + peers + backoff
      repeated ControlIDontWant idontwant = 5;  // message_ids (v1.2)
    }

On the stream, each RPC is varint-length-delimited.
"""
from __future__ import annotations

from dataclasses import dataclass, field


class PbError(Exception):
    pass


# -- primitive proto wire helpers ---------------------------------------------

def _uvarint(n: int) -> bytes:
    out = b""
    while n >= 0x80:
        out += bytes([(n & 0x7F) | 0x80])
        n >>= 7
    return out + bytes([n])


def _tag_bytes(tag: int, data: bytes) -> bytes:
    return _uvarint((tag << 3) | 2) + _uvarint(len(data)) + data


def _tag_varint(tag: int, v: int) -> bytes:
    return _uvarint(tag << 3) + _uvarint(v)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def uvarint(self) -> int:
        shift = v = 0
        while True:
            if self.pos >= len(self.data):
                raise PbError("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise PbError("varint overflow")

    def bytes_(self) -> bytes:
        n = self.uvarint()
        if self.pos + n > len(self.data):
            raise PbError("truncated bytes field")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def skip(self, wire_type: int) -> None:
        if wire_type == 0:
            self.uvarint()
        elif wire_type == 2:
            self.bytes_()
        elif wire_type == 5:
            self.pos += 4
        elif wire_type == 1:
            self.pos += 8
        else:
            raise PbError(f"unsupported wire type {wire_type}")


# -- schema dataclasses -------------------------------------------------------

@dataclass
class SubOpts:
    subscribe: bool = True
    topic: str = ""

    def encode(self) -> bytes:
        return _tag_varint(1, 1 if self.subscribe else 0) + \
            _tag_bytes(2, self.topic.encode())

    @classmethod
    def decode(cls, data: bytes) -> "SubOpts":
        r, out = _Reader(data), cls()
        while not r.eof():
            key = r.uvarint()
            tag, wt = key >> 3, key & 7
            if tag == 1 and wt == 0:
                out.subscribe = bool(r.uvarint())
            elif tag == 2 and wt == 2:
                out.topic = r.bytes_().decode()
            else:
                r.skip(wt)
        return out


@dataclass
class PubMessage:
    from_peer: bytes = b""
    data: bytes = b""
    seqno: bytes = b""
    topic: str = ""
    signature: bytes = b""
    key: bytes = b""

    def encode(self) -> bytes:
        out = b""
        if self.from_peer:
            out += _tag_bytes(1, self.from_peer)
        if self.data:
            out += _tag_bytes(2, self.data)
        if self.seqno:
            out += _tag_bytes(3, self.seqno)
        out += _tag_bytes(4, self.topic.encode())
        if self.signature:
            out += _tag_bytes(5, self.signature)
        if self.key:
            out += _tag_bytes(6, self.key)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "PubMessage":
        r, out = _Reader(data), cls()
        while not r.eof():
            key = r.uvarint()
            tag, wt = key >> 3, key & 7
            if wt != 2:
                r.skip(wt)
                continue
            v = r.bytes_()
            if tag == 1:
                out.from_peer = v
            elif tag == 2:
                out.data = v
            elif tag == 3:
                out.seqno = v
            elif tag == 4:
                out.topic = v.decode()
            elif tag == 5:
                out.signature = v
            elif tag == 6:
                out.key = v
        return out


@dataclass
class ControlIHave:
    topic: str = ""
    message_ids: list[bytes] = field(default_factory=list)

    def encode(self) -> bytes:
        out = _tag_bytes(1, self.topic.encode())
        for mid in self.message_ids:
            out += _tag_bytes(2, mid)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ControlIHave":
        r, out = _Reader(data), cls()
        while not r.eof():
            key = r.uvarint()
            tag, wt = key >> 3, key & 7
            if wt != 2:
                r.skip(wt)
                continue
            v = r.bytes_()
            if tag == 1:
                out.topic = v.decode()
            elif tag == 2:
                out.message_ids.append(v)
        return out


@dataclass
class ControlIWant:
    message_ids: list[bytes] = field(default_factory=list)

    def encode(self) -> bytes:
        return b"".join(_tag_bytes(1, m) for m in self.message_ids)

    @classmethod
    def decode(cls, data: bytes) -> "ControlIWant":
        r, out = _Reader(data), cls()
        while not r.eof():
            key = r.uvarint()
            tag, wt = key >> 3, key & 7
            if tag == 1 and wt == 2:
                out.message_ids.append(r.bytes_())
            else:
                r.skip(wt)
        return out


# IDONTWANT (gossipsub v1.2) shares ControlIWant's shape
ControlIDontWant = ControlIWant


@dataclass
class ControlGraft:
    topic: str = ""

    def encode(self) -> bytes:
        return _tag_bytes(1, self.topic.encode())

    @classmethod
    def decode(cls, data: bytes) -> "ControlGraft":
        r, out = _Reader(data), cls()
        while not r.eof():
            key = r.uvarint()
            tag, wt = key >> 3, key & 7
            if tag == 1 and wt == 2:
                out.topic = r.bytes_().decode()
            else:
                r.skip(wt)
        return out


@dataclass
class PeerInfo:
    peer_id: bytes = b""
    signed_peer_record: bytes = b""

    def encode(self) -> bytes:
        out = b""
        if self.peer_id:
            out += _tag_bytes(1, self.peer_id)
        if self.signed_peer_record:
            out += _tag_bytes(2, self.signed_peer_record)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "PeerInfo":
        r, out = _Reader(data), cls()
        while not r.eof():
            key = r.uvarint()
            tag, wt = key >> 3, key & 7
            if wt != 2:
                r.skip(wt)
                continue
            v = r.bytes_()
            if tag == 1:
                out.peer_id = v
            elif tag == 2:
                out.signed_peer_record = v
        return out


@dataclass
class ControlPrune:
    topic: str = ""
    peers: list[PeerInfo] = field(default_factory=list)
    backoff: int = 0

    def encode(self) -> bytes:
        out = _tag_bytes(1, self.topic.encode())
        for p in self.peers:
            out += _tag_bytes(2, p.encode())
        if self.backoff:
            out += _tag_varint(3, self.backoff)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ControlPrune":
        r, out = _Reader(data), cls()
        while not r.eof():
            key = r.uvarint()
            tag, wt = key >> 3, key & 7
            if tag == 1 and wt == 2:
                out.topic = r.bytes_().decode()
            elif tag == 2 and wt == 2:
                out.peers.append(PeerInfo.decode(r.bytes_()))
            elif tag == 3 and wt == 0:
                out.backoff = r.uvarint()
            else:
                r.skip(wt)
        return out


@dataclass
class ControlMessage:
    ihave: list[ControlIHave] = field(default_factory=list)
    iwant: list[ControlIWant] = field(default_factory=list)
    graft: list[ControlGraft] = field(default_factory=list)
    prune: list[ControlPrune] = field(default_factory=list)
    idontwant: list[ControlIWant] = field(default_factory=list)

    def encode(self) -> bytes:
        out = b""
        for tag, items in ((1, self.ihave), (2, self.iwant),
                           (3, self.graft), (4, self.prune),
                           (5, self.idontwant)):
            for item in items:
                out += _tag_bytes(tag, item.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "ControlMessage":
        r, out = _Reader(data), cls()
        while not r.eof():
            key = r.uvarint()
            tag, wt = key >> 3, key & 7
            if wt != 2:
                r.skip(wt)
                continue
            v = r.bytes_()
            if tag == 1:
                out.ihave.append(ControlIHave.decode(v))
            elif tag == 2:
                out.iwant.append(ControlIWant.decode(v))
            elif tag == 3:
                out.graft.append(ControlGraft.decode(v))
            elif tag == 4:
                out.prune.append(ControlPrune.decode(v))
            elif tag == 5:
                out.idontwant.append(ControlIWant.decode(v))
        return out

    def empty(self) -> bool:
        return not (self.ihave or self.iwant or self.graft or self.prune
                    or self.idontwant)


@dataclass
class Rpc:
    subscriptions: list[SubOpts] = field(default_factory=list)
    publish: list[PubMessage] = field(default_factory=list)
    control: ControlMessage | None = None

    def encode(self) -> bytes:
        out = b""
        for s in self.subscriptions:
            out += _tag_bytes(1, s.encode())
        for m in self.publish:
            out += _tag_bytes(2, m.encode())
        if self.control is not None and not self.control.empty():
            out += _tag_bytes(3, self.control.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Rpc":
        r, out = _Reader(data), cls()
        while not r.eof():
            key = r.uvarint()
            tag, wt = key >> 3, key & 7
            if wt != 2:
                r.skip(wt)
                continue
            v = r.bytes_()
            if tag == 1:
                out.subscriptions.append(SubOpts.decode(v))
            elif tag == 2:
                out.publish.append(PubMessage.decode(v))
            elif tag == 3:
                out.control = ControlMessage.decode(v)
        return out


# -- stream framing (varint-delimited RPCs) -----------------------------------

#: one RPC may carry a max-size gossip payload (10 MiB) plus framing slack
MAX_RPC_SIZE = 16 * 1024 * 1024


def frame(rpc: Rpc) -> bytes:
    body = rpc.encode()
    return _uvarint(len(body)) + body


def unframe(buf: bytearray) -> Rpc | None:
    """Consume one complete RPC from `buf`, or return None if partial.
    Raises PbError on an oversized declared length or a malformed body
    (the caller must treat either as peer misbehavior)."""
    r = _Reader(bytes(buf[:10]))
    try:
        n = r.uvarint()
    except PbError:
        if len(buf) >= 10:
            raise                  # 10 bytes cannot fail to hold a varint
        return None
    if n > MAX_RPC_SIZE:
        raise PbError(f"rpc frame too large ({n})")
    if r.pos + n > len(buf):
        return None
    body = bytes(buf[r.pos:r.pos + n])
    del buf[:r.pos + n]
    try:
        return Rpc.decode(body)
    except (UnicodeDecodeError, ValueError) as e:   # bad topic bytes etc.
        raise PbError(f"malformed rpc: {e}") from None
