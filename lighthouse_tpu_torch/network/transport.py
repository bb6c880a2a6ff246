"""The libp2p transport stack — REAL wire protocols end to end.

Connection upgrade path, exactly as the reference builds it
(beacon_node/lighthouse_network/src/service/utils.rs:80-130
build_transport):

    TCP
    └─ multistream-select          "/noise"
       └─ Noise XX                 (noise_xx.py — identity-certified)
          └─ multistream-select    "/yamux/1.0.0"   (inside noise frames)
             └─ yamux session      (yamux.py — SYN/ACK streams, windows)
                ├─ /meshsub/1.2.0 streams: varint-delimited gossipsub
                │    RPC protobufs (gossipsub_pb.py), one long-lived
                │    outbound stream per peer
                └─ /eth2/beacon_chain/req/* streams: one per request
                     (rpc.py — SSZ-snappy with result/context bytes)

Peers are identified by their libp2p peer id (identity multihash of the
secp256k1 identity key, authenticated inside the noise handshake).
"""
from __future__ import annotations

import secrets
import socket
import threading

from ..utils.threads import ThreadGroup
from . import multistream as ms
from . import secp256k1
from .gossipsub_pb import unframe
from .noise_xx import (
    HAVE_CRYPTOGRAPHY, NoiseError, NoiseSession, initiator_handshake,
    peer_id_from_pubkey, responder_handshake,
)
from .plaintext import plaintext_handshake
from .yamux import Session, Stream, StreamIO, YamuxError

PROTO_NOISE = "/noise"
PROTO_PLAINTEXT = "/plaintext/2.0.0"
PROTO_YAMUX = "/yamux/1.0.0"
PROTO_MESHSUB = ["/meshsub/1.2.0", "/meshsub/1.1.0"]


class NodeIdentity:
    """secp256k1 libp2p identity keypair."""

    def __init__(self, priv: int | None = None):
        self.priv = priv or int.from_bytes(secrets.token_bytes(32), "big") \
            % (secp256k1.N - 1) + 1
        self.pub = secp256k1.compress(secp256k1.pubkey(self.priv))
        self.peer_id = peer_id_from_pubkey(self.pub)
        self.node_id = self.peer_id.hex()


class _NoiseIO:
    """Byte-stream view over a NoiseSession (for multistream + yamux)."""

    def __init__(self, sock, session: NoiseSession):
        self.sock = sock
        self.session = session
        self._buf = bytearray()
        self._wlock = threading.Lock()

    def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._buf += self.session.recv(self.sock)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def recv_any(self) -> bytes:
        """One noise frame's plaintext (+ any buffered leftovers)."""
        if self._buf:
            out = bytes(self._buf)
            self._buf.clear()
            return out
        return self.session.recv(self.sock)

    def write(self, data: bytes) -> None:
        with self._wlock:
            self.session.send(self.sock, data)


class Peer:
    """One upgraded connection: noise-authenticated, yamux-multiplexed."""

    def __init__(self, transport: "Transport", sock, addr,
                 io: _NoiseIO, outbound: bool):
        self.transport = transport
        self.sock = sock
        self.addr = addr
        self.io = io
        self.outbound = outbound
        self.node_id = io.session.remote_peer_id.hex()
        self.alive = True
        self.mux = Session(io.write, initiator=outbound,
                           on_stream=self._on_inbound_stream)
        self._gossip_out: Stream | None = None
        self._gossip_lock = threading.Lock()
        self._gossip_in_buf = bytearray()

    # -- outbound streams ------------------------------------------------------

    def open_protocol(self, protocols: list[str],
                      timeout: float = 10.0) -> tuple[Stream, str]:
        st = self.mux.open_stream()
        proto = ms.negotiate_out(StreamIO(st, timeout), protocols)
        return st, proto

    def send_gossip_rpc(self, framed: bytes) -> None:
        """Write one varint-framed gossipsub RPC on the persistent
        meshsub stream (opened lazily)."""
        with self._gossip_lock:
            if self._gossip_out is None or self._gossip_out.reset:
                try:
                    self._gossip_out, _ = self.open_protocol(PROTO_MESHSUB)
                except (ms.MultistreamError, YamuxError, OSError):
                    self._gossip_out = None
                    return
            try:
                self._gossip_out.write(framed)
            except (YamuxError, OSError):
                self._gossip_out = None

    # -- inbound streams -------------------------------------------------------

    def _on_inbound_stream(self, stream: Stream) -> None:
        if not self.alive:
            return          # close() raced the mux callback
        self.transport._threads.spawn(self._serve_stream, stream,
                                      name="peer.serve_stream")

    def _serve_stream(self, stream: Stream) -> None:
        try:
            supported = PROTO_MESHSUB + self.transport.rpc_protocols
            proto = ms.negotiate_in(StreamIO(stream), supported)
        except (ms.MultistreamError, YamuxError, OSError):
            try:
                stream.rst()
            except (YamuxError, OSError):
                pass            # socket already gone at teardown
            return
        if proto in PROTO_MESHSUB:
            self._gossip_read_loop(stream)
        else:
            try:
                self.transport.on_rpc_stream(self, proto, stream)
            except Exception:
                import logging
                logging.getLogger("lighthouse_tpu_torch.network").exception(
                    "rpc stream handler failed (peer %s)", self.node_id)
                try:
                    stream.rst()
                except (YamuxError, OSError):
                    pass

    def _gossip_read_loop(self, stream: Stream) -> None:
        from .gossipsub_pb import MAX_RPC_SIZE, PbError
        buf = bytearray()
        while self.alive and not stream.reset:
            try:
                chunk = stream.read(timeout=30.0)
            except YamuxError:
                return
            if not chunk:
                if stream.recv_closed:
                    return
                continue
            buf += chunk
            if len(buf) > MAX_RPC_SIZE + 10:
                stream.rst()       # oversized frame: peer misbehavior
                return
            while True:
                try:
                    rpc = unframe(buf)
                except PbError:
                    stream.rst()   # malformed frame: stop reading them
                    return
                if rpc is None:
                    break
                try:
                    self.transport.on_gossip_rpc(self, rpc)
                except Exception:
                    import logging
                    logging.getLogger("lighthouse_tpu_torch.network").exception(
                        "gossip handler failed (peer %s)", self.node_id)

    def close(self) -> None:
        self.alive = False
        try:
            self.mux.goaway()
        except Exception:
            pass
        try:
            # close() alone does not wake a recv() blocked in another
            # thread; shutdown() delivers EOF to it first
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class Transport:
    """Listener + dialer; hands upgraded Peers to `on_peer`, gossipsub
    RPCs to `on_gossip_rpc(peer, rpc)`, req/resp streams to
    `on_rpc_stream(peer, protocol, stream)`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 identity: NodeIdentity | None = None,
                 security: str | None = None):
        """`security`: "noise" | "plaintext" | None (auto: noise when the
        cryptography package is available, else the plaintext fallback).
        Both sides of a connection must agree — the chosen protocol is
        what multistream offers, so a mismatch fails the negotiation
        instead of silently downgrading."""
        if security is None:
            security = "noise" if HAVE_CRYPTOGRAPHY else "plaintext"
        if security == "noise" and not HAVE_CRYPTOGRAPHY:
            raise NoiseError("noise security requires the 'cryptography' "
                             "package; use security='plaintext'")
        if security not in ("noise", "plaintext"):
            raise ValueError(f"unknown security mode {security!r}")
        self.security = security
        self.identity = identity or NodeIdentity()
        self.node_id = self.identity.node_id
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen(64)
        self.port = self.listener.getsockname()[1]
        self.host = host
        self.on_peer = lambda peer: None
        self.on_gossip_rpc = lambda peer, rpc: None
        self.on_rpc_stream = lambda peer, protocol, stream: None
        self.on_disconnect = lambda peer: None
        #: protocol ids served on inbound streams (set by RpcHandler)
        self.rpc_protocols: list[str] = []
        self.peers: dict[str, Peer] = {}
        self._stop = False
        self._threads = ThreadGroup("transport")

    def start(self) -> None:
        self._threads.spawn(self._accept_loop, name="transport.accept")

    def stop(self) -> None:
        # close the sockets first (unblocks accept/read threads), then
        # join them so no transport thread outlives the transport
        self._stop = True
        try:
            self.listener.close()
        except OSError:
            pass
        for p in list(self.peers.values()):
            p.close()
        self._threads.join_all(timeout=2)

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                sock, addr = self.listener.accept()
            except OSError:
                return
            self._threads.spawn(self._upgrade_in, sock, addr,
                                name="transport.upgrade_in")

    # -- the upgrade path ------------------------------------------------------

    def _security_proto(self) -> str:
        return PROTO_NOISE if self.security == "noise" else PROTO_PLAINTEXT

    def _upgrade_in(self, sock, addr) -> None:
        try:
            sock.settimeout(10)
            proto = ms.negotiate_in(sock, [self._security_proto()])
            session = (responder_handshake(sock, self.identity.priv)
                       if proto == PROTO_NOISE
                       else plaintext_handshake(sock, self.identity.priv))
            io = _NoiseIO(sock, session)
            ms.negotiate_in(io, [PROTO_YAMUX])
            sock.settimeout(None)
            self._register(Peer(self, sock, addr, io, outbound=False))
        except (OSError, ValueError, NoiseError, ms.MultistreamError):
            sock.close()

    def dial(self, host: str, port: int) -> Peer | None:
        try:
            sock = socket.create_connection((host, port), timeout=5)
            sock.settimeout(10)
            proto = ms.negotiate_out(sock, [self._security_proto()])
            session = (initiator_handshake(sock, self.identity.priv)
                       if proto == PROTO_NOISE
                       else plaintext_handshake(sock, self.identity.priv))
            io = _NoiseIO(sock, session)
            ms.negotiate_out(io, [PROTO_YAMUX])
            sock.settimeout(None)
            peer = Peer(self, sock, (host, port), io, outbound=True)
            self._register(peer)
            return peer
        except (OSError, ValueError, NoiseError, ms.MultistreamError):
            return None

    def _register(self, peer: Peer) -> None:
        if self._stop:
            peer.close()    # accept/dial raced stop(): no thread may
            return          # spawn after join_all has run
        self.peers[peer.node_id] = peer
        self._threads.spawn(self._read_loop, peer,
                            name="transport.read_loop")
        self.on_peer(peer)

    def _read_loop(self, peer: Peer) -> None:
        """Pump noise plaintext into the yamux session."""
        try:
            while peer.alive and not self._stop:
                peer.mux.on_bytes(peer.io.recv_any())
                if peer.mux.closed:
                    break
        except (OSError, NoiseError, YamuxError):
            pass
        peer.alive = False
        # a redialed peer may have replaced this entry — only pop ourselves
        if self.peers.get(peer.node_id) is peer:
            self.peers.pop(peer.node_id, None)
            self.on_disconnect(peer)
