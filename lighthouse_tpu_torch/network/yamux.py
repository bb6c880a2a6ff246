"""yamux — libp2p's stream multiplexer, real wire format.

Frame header (12 bytes, big-endian), per the hashicorp/yamux spec the
reference's transport stack negotiates (ref: beacon_node/
lighthouse_network/src/service/utils.rs build_transport — yamux over
noise):

    version(1)=0 | type(1) | flags(2) | stream_id(4) | length(4)

Types: 0 Data, 1 WindowUpdate, 2 Ping, 3 GoAway.
Flags: 1 SYN, 2 ACK, 4 FIN, 8 RST.
Stream ids: odd from the connection initiator, even from the responder.
Data frames consume receive window (256 KiB default); WindowUpdate
replenishes it.  Ping carries an opaque 4-byte value in `length`.
"""
from __future__ import annotations

import struct
import threading

VERSION = 0
TYPE_DATA = 0
TYPE_WINDOW_UPDATE = 1
TYPE_PING = 2
TYPE_GOAWAY = 3
FLAG_SYN = 0x1
FLAG_ACK = 0x2
FLAG_FIN = 0x4
FLAG_RST = 0x8
DEFAULT_WINDOW = 256 * 1024
HEADER = struct.Struct(">BBHII")


class YamuxError(Exception):
    pass


class YamuxEOF(YamuxError):
    """Clean half-close: the peer FINished and the buffer is drained."""


class YamuxTimeout(YamuxError):
    """No data within the deadline (stream still open)."""


class YamuxReset(YamuxError):
    """Stream was RST."""


def encode_frame(ftype: int, flags: int, stream_id: int,
                 payload: bytes = b"", length: int | None = None) -> bytes:
    """Data frames: length = len(payload).  Other types carry `length`
    as a bare value (window delta / ping opaque / goaway code)."""
    n = len(payload) if length is None else length
    return HEADER.pack(VERSION, ftype, flags, stream_id, n) + payload


def decode_header(hdr12: bytes) -> tuple[int, int, int, int]:
    version, ftype, flags, stream_id, length = HEADER.unpack(hdr12)
    if version != VERSION:
        raise YamuxError(f"bad yamux version {version}")
    if ftype > TYPE_GOAWAY:
        raise YamuxError(f"bad yamux type {ftype}")
    return ftype, flags, stream_id, length


class Stream:
    """One logical stream: buffered inbound data + flow-control window."""

    def __init__(self, session: "Session", stream_id: int):
        self.session = session
        self.id = stream_id
        self.recv_buf = bytearray()
        self.recv_closed = False
        self.send_closed = False
        self.reset = False
        self.send_window = DEFAULT_WINDOW
        self.recv_window = DEFAULT_WINDOW
        self.cv = threading.Condition()

    # -- app side -------------------------------------------------------------

    def write(self, data: bytes) -> None:
        if self.send_closed or self.reset:
            raise YamuxError("write on closed stream")
        off = 0
        while off < len(data):
            with self.cv:
                while self.send_window == 0 and not self.reset:
                    self.cv.wait(timeout=5)
                if self.reset:
                    raise YamuxError("stream reset")
                n = min(self.send_window, len(data) - off, 16384)
                self.send_window -= n
            self.session._send(encode_frame(TYPE_DATA, 0, self.id,
                                            data[off:off + n]))
            off += n

    def read(self, max_bytes: int = 1 << 20, timeout: float = 10.0
             ) -> bytes:
        """-> b"" on clean EOF or timeout (check recv_closed to tell;
        empty-payload frames notify the condvar, so WAIT IN A LOOP)."""
        import time as _time
        deadline = _time.monotonic() + timeout
        with self.cv:
            while not self.recv_buf and not self.recv_closed \
                    and not self.reset:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    break
                self.cv.wait(timeout=remaining)
            if self.reset:
                raise YamuxReset("stream reset")
            data = bytes(self.recv_buf[:max_bytes])
            del self.recv_buf[:len(data)]
        if data:
            self._replenish(len(data))
        return data

    def read_exact(self, n: int, timeout: float = 10.0) -> bytes:
        import time as _time
        deadline = _time.monotonic() + timeout
        buf = b""
        while len(buf) < n:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise YamuxTimeout(f"stream read timeout ({n} bytes)")
            chunk = self.read(n - len(buf), remaining)
            if not chunk:
                if self.recv_closed:
                    raise YamuxEOF("stream EOF mid-read")
                continue
            buf += chunk
        return buf

    def close(self) -> None:
        """Half-close our sending direction (FIN). Best-effort at
        teardown: the peer (and its socket) may already be gone."""
        with self.cv:
            already = self.send_closed
            self.send_closed = True
        if not already:                 # exactly one FIN, racing closers
            try:
                self.session._send(encode_frame(TYPE_DATA, FLAG_FIN,
                                                self.id))
            except (YamuxError, OSError):
                pass
        self.session._maybe_gc(self)

    def rst(self) -> None:
        # mark + WAKE waiters under the condvar (a blocked read would
        # otherwise sleep out its full timeout), then best-effort RST on
        # the wire — during shutdown the socket may already be closed
        # (an OSError must not escape a serve_stream thread)
        with self.cv:
            self.reset = True
            self.cv.notify_all()
        try:
            self.session._send(encode_frame(TYPE_DATA, FLAG_RST, self.id))
        except (YamuxError, OSError):
            pass
        self.session._maybe_gc(self)

    def _replenish(self, n: int) -> None:
        with self.cv:
            self.recv_window -= n
            if self.recv_window > DEFAULT_WINDOW // 2:
                return
            delta = DEFAULT_WINDOW - self.recv_window
            self.recv_window = DEFAULT_WINDOW
        self.session._send(encode_frame(TYPE_WINDOW_UPDATE, 0,
                                        self.id, length=delta))

    # -- session side ---------------------------------------------------------

    def _on_data(self, data: bytes, flags: int) -> None:
        with self.cv:
            if data:
                self.recv_buf += data
            if flags & FLAG_FIN:
                self.recv_closed = True
            if flags & FLAG_RST:
                self.reset = True
            self.cv.notify_all()

    def _on_window(self, delta: int) -> None:
        with self.cv:
            self.send_window += delta
            self.cv.notify_all()


class Session:
    """A yamux session over any reliable byte transport.

    `send_fn(bytes)` writes to the wire; feed inbound bytes through
    `on_bytes`.  `on_stream(stream)` fires for peer-opened streams.
    Typically wrapped around a NoiseSession (see transport.py).
    """

    def __init__(self, send_fn, initiator: bool, on_stream=None,
                 on_ping=None):
        self._send_fn = send_fn
        self._next_id = 1 if initiator else 2
        self.streams: dict[int, Stream] = {}
        self.on_stream = on_stream
        self.on_ping = on_ping
        self._buf = bytearray()
        self._lock = threading.Lock()
        self.closed = False
        self.goaway_code: int | None = None

    def _send(self, frame: bytes) -> None:
        with self._lock:
            if self.closed:
                return
            try:
                self._send_fn(frame)
            except OSError as e:
                # wire gone mid-write (teardown race): the session is
                # dead; surface a protocol error instead of letting the
                # raw OSError escape on a service thread
                self.closed = True
                raise YamuxError("session write failed") from e

    def _maybe_gc(self, st: Stream) -> None:
        """Drop fully-dead streams so long-lived connections (one stream
        per req/resp call) do not leak Stream objects."""
        if st.reset or (st.send_closed and st.recv_closed):
            self.streams.pop(st.id, None)

    # -- opening --------------------------------------------------------------

    def open_stream(self) -> Stream:
        with self._lock:
            sid = self._next_id
            self._next_id += 2
        st = Stream(self, sid)
        self.streams[sid] = st
        self._send(encode_frame(TYPE_DATA, FLAG_SYN, sid))
        return st

    def ping(self, value: int = 0) -> None:
        self._send(encode_frame(TYPE_PING, FLAG_SYN, 0, length=value))

    def goaway(self, code: int = 0) -> None:
        self._send(encode_frame(TYPE_GOAWAY, 0, 0, length=code))
        with self._lock:
            self.closed = True

    # -- inbound pump ---------------------------------------------------------

    def on_bytes(self, data: bytes) -> None:
        """Feed raw wire bytes; dispatches complete frames.

        Framing happens under the session lock (the reassembly buffer is
        shared state); dispatch runs OUTSIDE it — handlers send ACKs and
        window updates through `_send`, which takes the same lock."""
        frames = []
        with self._lock:
            self._buf += data
            while True:
                if len(self._buf) < 12:
                    break
                ftype, flags, sid, length = decode_header(
                    bytes(self._buf[:12]))
                if ftype == TYPE_DATA:
                    if len(self._buf) < 12 + length:
                        break
                    payload = bytes(self._buf[12:12 + length])
                    del self._buf[:12 + length]
                    frames.append((ftype, flags, sid, length, payload))
                else:
                    del self._buf[:12]
                    frames.append((ftype, flags, sid, length, b""))
        for ftype, flags, sid, length, payload in frames:
            if ftype == TYPE_DATA:
                self._dispatch_data(sid, flags, payload)
            else:
                self._dispatch_ctrl(ftype, flags, sid, length)

    def _dispatch_data(self, sid: int, flags: int, payload: bytes) -> None:
        st = self.streams.get(sid)
        if st is None:
            if flags & FLAG_SYN:
                st = Stream(self, sid)
                self.streams[sid] = st
                self._send(encode_frame(TYPE_DATA, FLAG_ACK, sid))
                st._on_data(payload, flags)
                if self.on_stream:
                    self.on_stream(st)
                return
            if not flags & FLAG_RST:       # unknown stream: protocol error
                self._send(encode_frame(TYPE_DATA, FLAG_RST, sid))
            return
        st._on_data(payload, flags)
        if flags & (FLAG_FIN | FLAG_RST):
            self._maybe_gc(st)

    def _dispatch_ctrl(self, ftype: int, flags: int, sid: int,
                       length: int) -> None:
        if ftype == TYPE_WINDOW_UPDATE:
            st = self.streams.get(sid)
            if st is None and flags & FLAG_SYN:
                st = Stream(self, sid)
                self.streams[sid] = st
                self._send(encode_frame(TYPE_WINDOW_UPDATE, FLAG_ACK, sid,
                                        length=0))
                st._on_window(length)
                if self.on_stream:
                    self.on_stream(st)
                return
            if st is not None:
                st._on_window(length)
        elif ftype == TYPE_PING:
            if flags & FLAG_SYN:
                self._send(encode_frame(TYPE_PING, FLAG_ACK, 0,
                                        length=length))
            if self.on_ping:
                self.on_ping(length, flags)
        elif ftype == TYPE_GOAWAY:
            # dispatch runs outside the session lock (see on_bytes), so
            # the closed flag must be flipped under it like everywhere else
            with self._lock:
                self.goaway_code = length
                self.closed = True


class StreamIO:
    """multistream-select adapter over a yamux Stream."""

    def __init__(self, stream: Stream, timeout: float = 10.0):
        self.stream = stream
        self.timeout = timeout

    def read_exact(self, n: int) -> bytes:
        return self.stream.read_exact(n, self.timeout)

    def write(self, data: bytes) -> None:
        self.stream.write(data)
