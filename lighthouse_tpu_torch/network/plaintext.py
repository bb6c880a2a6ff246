"""libp2p ``/plaintext/2.0.0``-style security "upgrade" — no encryption.

The real libp2p plaintext 2.0 protocol exchanges each side's identity
public key in an ``Exchange`` protobuf and then passes bytes through
unchanged (libp2p/specs/plaintext/README.md).  We implement that shape —
a single length-prefixed exchange message carrying the compressed
secp256k1 identity key, then a raw byte stream — with one hardening
twist the spec leaves out: the exchange message also carries a signature
over the advertised key, so a peer cannot claim an identity it does not
hold (proof of possession; there is still no transport privacy and no
MITM resistance, which is the point of this mode).

Why it exists: the noise XX upgrade (noise_xx.py) needs the python
``cryptography`` package for X25519/ChaCha20-Poly1305.  The scenario
suite (testing/scenarios.py) must run the full TCP/yamux/gossipsub stack
deterministically on machines without it, so the transport negotiates
``/plaintext/2.0.0`` as a fallback security protocol.  Everything above
the security layer (multistream, yamux, meshsub, req/resp) is byte-for-
byte identical to the noise path.
"""
from __future__ import annotations

import struct

from . import secp256k1
from .noise_xx import (
    NoiseError, _pb_bytes_field, _pb_parse, _identity_key_pb,
    peer_id_from_pubkey,
)

EXCHANGE_PREFIX = b"libp2p-plaintext-exchange:"
MAX_EXCHANGE = 4096


class PlaintextError(NoiseError):
    """Subclass of NoiseError so transport except-clauses need no edits."""


def _send_frame(sock, data: bytes) -> None:
    sock.sendall(struct.pack(">H", len(data)) + data)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise PlaintextError("connection closed during exchange")
        buf += chunk
    return buf


def _recv_frame(sock) -> bytes:
    (n,) = struct.unpack(">H", _recv_exact(sock, 2))
    if n > MAX_EXCHANGE:
        raise PlaintextError("oversized exchange message")
    return _recv_exact(sock, n)


def _make_exchange(identity_priv: int) -> bytes:
    """Exchange { id = 1, pubkey = 2, sig = 3 (our extension) }."""
    pub = secp256k1.compress(secp256k1.pubkey(identity_priv))
    import hashlib
    digest = hashlib.sha256(EXCHANGE_PREFIX + pub).digest()
    sig = secp256k1.sign(identity_priv, digest)
    return (_pb_bytes_field(1, peer_id_from_pubkey(pub))
            + _pb_bytes_field(2, _identity_key_pb(pub))
            + _pb_bytes_field(3, sig))


def _parse_exchange(msg: bytes) -> bytes:
    """-> the peer's compressed secp256k1 identity key (33B), verified."""
    fields = _pb_parse(msg)
    key_pb = _pb_parse(fields[2])
    if key_pb.get(1) != 2:
        raise PlaintextError("identity key is not secp256k1")
    pub33 = key_pb[2]
    import hashlib
    digest = hashlib.sha256(EXCHANGE_PREFIX + pub33).digest()
    if not secp256k1.verify(secp256k1.decompress(pub33), digest,
                            fields.get(3, b"")):
        raise PlaintextError("identity possession signature invalid")
    if fields.get(1) != peer_id_from_pubkey(pub33):
        raise PlaintextError("advertised peer id does not match key")
    return pub33


class PlaintextSession:
    """Same surface as NoiseSession (send/recv/remote_peer_id): raw
    socket pass-through after the identity exchange."""

    RECV_CHUNK = 65536

    def __init__(self, remote_identity: bytes):
        self.remote_identity = remote_identity
        self.remote_peer_id = peer_id_from_pubkey(remote_identity)
        self.handshake_hash = b"\x00" * 32   # no channel binding

    def send(self, sock, data: bytes) -> None:
        sock.sendall(data)

    def recv(self, sock) -> bytes:
        chunk = sock.recv(self.RECV_CHUNK)
        if not chunk:
            raise PlaintextError("connection closed")
        return chunk


def plaintext_handshake(sock, identity_priv: int) -> PlaintextSession:
    """Symmetric: both sides send their exchange, then read the peer's."""
    _send_frame(sock, _make_exchange(identity_priv))
    remote = _parse_exchange(_recv_frame(sock))
    return PlaintextSession(remote)
