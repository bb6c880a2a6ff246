"""Noise XX — the REAL Noise Protocol state machine, as libp2p uses it.

Noise_XX_25519_ChaChaPoly_SHA256 per the Noise spec (rev 34): full
CipherState / SymmetricState / HandshakeState objects, HKDF chaining,
and the XX message pattern

    -> e
    <- e, ee, s, es
    -> s, se

with libp2p's identity payload carried in messages 2 and 3: the static
Noise key is certified by the peer's libp2p identity key via a
signature over "noise-libp2p-static-key:" || static_pub (we use
secp256k1 identities, the eth2 default).

Ref: beacon_node/lighthouse_network/src/service/utils.rs:80-130
(build_transport: noise XX authentication upgrade).

Wire framing (libp2p noise spec): every handshake and transport message
is prefixed by a 2-byte big-endian length; transport messages carry
AEAD ciphertext (max 65535 bytes each).
"""
from __future__ import annotations

import hashlib
import hmac as hmac_mod
import struct

try:
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey, X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.serialization import (
        Encoding, PublicFormat,
    )
    HAVE_CRYPTOGRAPHY = True
except ImportError:   # gate: the STF/chain layers must import without it
    HAVE_CRYPTOGRAPHY = False

    class _MissingCryptography:
        _ERR = ("python 'cryptography' package is required for the noise "
                "transport but is not installed")

        def __init__(self, *a, **kw):
            raise NotImplementedError(self._ERR)

        @classmethod
        def generate(cls, *a, **kw):
            raise NotImplementedError(cls._ERR)

        @classmethod
        def from_public_bytes(cls, *a, **kw):
            raise NotImplementedError(cls._ERR)

    X25519PrivateKey = X25519PublicKey = ChaCha20Poly1305 = \
        _MissingCryptography
    Encoding = PublicFormat = None

from . import secp256k1

PROTOCOL_NAME = b"Noise_XX_25519_ChaChaPoly_SHA256"
LIBP2P_STATIC_PREFIX = b"noise-libp2p-static-key:"
MAX_MSG = 65535


class NoiseError(Exception):
    pass


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _hmac(key: bytes, data: bytes) -> bytes:
    return hmac_mod.new(key, data, hashlib.sha256).digest()


def _hkdf2(ck: bytes, ikm: bytes) -> tuple[bytes, bytes]:
    """Noise-spec HKDF with 2 outputs."""
    prk = _hmac(ck, ikm)
    o1 = _hmac(prk, b"\x01")
    o2 = _hmac(prk, o1 + b"\x02")
    return o1, o2


def _dh(priv: X25519PrivateKey, pub_raw: bytes) -> bytes:
    return priv.exchange(X25519PublicKey.from_public_bytes(pub_raw))


def _pub_raw(priv: X25519PrivateKey) -> bytes:
    return priv.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)


class CipherState:
    """Noise spec 5.1: (k, n) with 12-byte little-endian-counter nonces
    (4 zero bytes || u64le n — the 25519/ChaChaPoly nonce form)."""

    def __init__(self, key: bytes | None = None):
        self.k = key
        self.n = 0

    def has_key(self) -> bool:
        return self.k is not None

    def _nonce(self) -> bytes:
        return b"\x00" * 4 + struct.pack("<Q", self.n)

    def encrypt_with_ad(self, ad: bytes, plaintext: bytes) -> bytes:
        if self.k is None:
            return plaintext
        out = ChaCha20Poly1305(self.k).encrypt(self._nonce(), plaintext, ad)
        self.n += 1
        return out

    def decrypt_with_ad(self, ad: bytes, ciphertext: bytes) -> bytes:
        if self.k is None:
            return ciphertext
        try:
            out = ChaCha20Poly1305(self.k).decrypt(self._nonce(),
                                                   ciphertext, ad)
        except Exception as e:
            raise NoiseError(f"decrypt failed: {e}") from None
        self.n += 1
        return out


class SymmetricState:
    """Noise spec 5.2: (ck, h) + an inner CipherState."""

    def __init__(self):
        self.h = _sha256(PROTOCOL_NAME) if len(PROTOCOL_NAME) > 32 \
            else PROTOCOL_NAME.ljust(32, b"\x00")
        self.ck = self.h
        self.cs = CipherState()

    def mix_hash(self, data: bytes) -> None:
        self.h = _sha256(self.h + data)

    def mix_key(self, ikm: bytes) -> None:
        self.ck, temp_k = _hkdf2(self.ck, ikm)
        self.cs = CipherState(temp_k)

    def encrypt_and_hash(self, plaintext: bytes) -> bytes:
        ct = self.cs.encrypt_with_ad(self.h, plaintext)
        self.mix_hash(ct)
        return ct

    def decrypt_and_hash(self, ciphertext: bytes) -> bytes:
        pt = self.cs.decrypt_with_ad(self.h, ciphertext)
        self.mix_hash(ciphertext)
        return pt

    def split(self) -> tuple[CipherState, CipherState]:
        k1, k2 = _hkdf2(self.ck, b"")
        return CipherState(k1), CipherState(k2)


# -- libp2p identity payload (protobuf NoiseHandshakePayload) -----------------
#
#   message NoiseHandshakePayload {
#     bytes identity_key = 1;   // libp2p PublicKey protobuf
#     bytes identity_sig = 2;
#   }
#   message PublicKey { KeyType Type = 1; bytes Data = 2; }  Secp256k1 = 2

def _pb_bytes_field(tag: int, data: bytes) -> bytes:
    out = bytes([(tag << 3) | 2])
    n = len(data)
    while n >= 0x80:
        out += bytes([(n & 0x7F) | 0x80])
        n >>= 7
    return out + bytes([n]) + data


def _pb_varint_field(tag: int, v: int) -> bytes:
    out = bytes([tag << 3])
    while v >= 0x80:
        out += bytes([(v & 0x7F) | 0x80])
        v >>= 7
    return out + bytes([v])


def _pb_parse(data: bytes) -> dict[int, bytes | int]:
    out: dict[int, bytes | int] = {}
    pos = 0
    while pos < len(data):
        key = data[pos]
        tag, wt = key >> 3, key & 7
        pos += 1
        if wt == 0:
            v, shift = 0, 0
            while True:
                b = data[pos]
                v |= (b & 0x7F) << shift
                pos += 1
                if not b & 0x80:
                    break
                shift += 7
            out[tag] = v
        elif wt == 2:
            n, shift = 0, 0
            while True:
                b = data[pos]
                n |= (b & 0x7F) << shift
                pos += 1
                if not b & 0x80:
                    break
                shift += 7
            out[tag] = data[pos:pos + n]
            pos += n
        else:
            raise NoiseError(f"unsupported protobuf wire type {wt}")
    return out


def _identity_key_pb(pub33: bytes) -> bytes:
    return _pb_varint_field(1, 2) + _pb_bytes_field(2, pub33)   # Secp256k1


def make_payload(identity_priv: int, noise_static_pub: bytes) -> bytes:
    """NoiseHandshakePayload certifying our Noise static key."""
    digest = _sha256(LIBP2P_STATIC_PREFIX + noise_static_pub)
    sig = secp256k1.sign(identity_priv, digest)
    pub = secp256k1.compress(secp256k1.pubkey(identity_priv))
    return _pb_bytes_field(1, _identity_key_pb(pub)) + \
        _pb_bytes_field(2, sig)


def verify_payload(payload: bytes, noise_static_pub: bytes) -> bytes:
    """-> the peer's identity pubkey (compressed secp256k1, 33B)."""
    fields = _pb_parse(payload)
    key_pb = _pb_parse(fields[1])
    if key_pb.get(1) != 2:
        raise NoiseError("identity key is not secp256k1")
    pub33 = key_pb[2]
    digest = _sha256(LIBP2P_STATIC_PREFIX + noise_static_pub)
    if not secp256k1.verify(secp256k1.decompress(pub33), digest, fields[2]):
        raise NoiseError("identity signature invalid")
    return pub33


def peer_id_from_pubkey(pub33: bytes) -> bytes:
    """libp2p peer id: multihash of the PublicKey protobuf.  secp256k1
    keys are short, so identity-hashed: 0x00 || len || pb."""
    pb = _identity_key_pb(pub33)
    return bytes([0x00, len(pb)]) + pb


# -- XX handshake state machine -----------------------------------------------

class HandshakeState:
    """One side of Noise_XX.  Drive with write_message/read_message in
    pattern order; after message 3 both sides hold (send_cs, recv_cs,
    remote_identity)."""

    def __init__(self, initiator: bool, identity_priv: int,
                 static_priv: X25519PrivateKey | None = None,
                 prologue: bytes = b""):
        self.initiator = initiator
        self.identity_priv = identity_priv
        self.s = static_priv or X25519PrivateKey.generate()
        self.e: X25519PrivateKey | None = None
        self.re: bytes | None = None
        self.rs: bytes | None = None
        self.ss = SymmetricState()
        self.ss.mix_hash(prologue)
        self.remote_identity: bytes | None = None   # compressed secp256k1
        self.remote_payload: bytes | None = None

    # message 1: -> e
    def write_msg1(self) -> bytes:
        if not self.initiator:
            raise NoiseError("responder cannot write message 1")
        self.e = X25519PrivateKey.generate()
        e_pub = _pub_raw(self.e)
        self.ss.mix_hash(e_pub)
        self.ss.mix_hash(b"")                       # empty payload
        return e_pub

    def read_msg1(self, msg: bytes) -> None:
        if self.initiator:
            raise NoiseError("initiator cannot read message 1")
        if len(msg) != 32:
            raise NoiseError("bad message 1 length")
        self.re = msg
        self.ss.mix_hash(self.re)
        self.ss.mix_hash(b"")

    # message 2: <- e, ee, s, es  (+ payload)
    def write_msg2(self) -> bytes:
        self.e = X25519PrivateKey.generate()
        e_pub = _pub_raw(self.e)
        self.ss.mix_hash(e_pub)
        self.ss.mix_key(_dh(self.e, self.re))       # ee
        s_pub = _pub_raw(self.s)
        enc_s = self.ss.encrypt_and_hash(s_pub)
        self.ss.mix_key(_dh(self.s, self.re))       # es (responder side)
        payload = make_payload(self.identity_priv, s_pub)
        enc_payload = self.ss.encrypt_and_hash(payload)
        return e_pub + enc_s + enc_payload

    def read_msg2(self, msg: bytes) -> None:
        if len(msg) < 32 + 48:
            raise NoiseError("bad message 2 length")
        self.re = msg[:32]
        self.ss.mix_hash(self.re)
        self.ss.mix_key(_dh(self.e, self.re))       # ee
        enc_s, enc_payload = msg[32:32 + 48], msg[32 + 48:]
        self.rs = self.ss.decrypt_and_hash(enc_s)
        self.ss.mix_key(_dh(self.e, self.rs))       # es (initiator side)
        payload = self.ss.decrypt_and_hash(enc_payload)
        self.remote_identity = verify_payload(payload, self.rs)
        self.remote_payload = payload

    # message 3: -> s, se  (+ payload)
    def write_msg3(self) -> bytes:
        s_pub = _pub_raw(self.s)
        enc_s = self.ss.encrypt_and_hash(s_pub)
        self.ss.mix_key(_dh(self.s, self.re))       # se (initiator side)
        payload = make_payload(self.identity_priv, s_pub)
        enc_payload = self.ss.encrypt_and_hash(payload)
        return enc_s + enc_payload

    def read_msg3(self, msg: bytes) -> None:
        enc_s, enc_payload = msg[:48], msg[48:]
        self.rs = self.ss.decrypt_and_hash(enc_s)
        self.ss.mix_key(_dh(self.e, self.rs))       # se (responder side)
        payload = self.ss.decrypt_and_hash(enc_payload)
        self.remote_identity = verify_payload(payload, self.rs)
        self.remote_payload = payload

    def split(self) -> tuple[CipherState, CipherState]:
        """-> (send, recv) for THIS side (initiator sends with k1)."""
        c1, c2 = self.ss.split()
        return (c1, c2) if self.initiator else (c2, c1)

    @property
    def handshake_hash(self) -> bytes:
        return self.ss.h


# -- framed session over a socket-like object ---------------------------------

def _send_frame(sock, data: bytes) -> None:
    if len(data) > MAX_MSG:
        raise NoiseError("frame too large")
    sock.sendall(struct.pack(">H", len(data)) + data)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise NoiseError("connection closed during noise exchange")
        buf += chunk
    return buf


def _recv_frame(sock) -> bytes:
    (n,) = struct.unpack(">H", _recv_exact(sock, 2))
    return _recv_exact(sock, n)


class NoiseSession:
    """An authenticated, encrypted session after a completed handshake."""

    def __init__(self, send_cs: CipherState, recv_cs: CipherState,
                 remote_identity: bytes, handshake_hash: bytes):
        self.send_cs = send_cs
        self.recv_cs = recv_cs
        self.remote_identity = remote_identity
        self.remote_peer_id = peer_id_from_pubkey(remote_identity)
        self.handshake_hash = handshake_hash

    def send(self, sock, data: bytes) -> None:
        # chunk to respect the 65535-byte noise message bound (16B tag)
        for off in range(0, len(data), MAX_MSG - 16) or [0]:
            chunk = data[off:off + MAX_MSG - 16]
            _send_frame(sock, self.send_cs.encrypt_with_ad(b"", chunk))

    def recv(self, sock) -> bytes:
        return self.recv_cs.decrypt_with_ad(b"", _recv_frame(sock))


def initiator_handshake(sock, identity_priv: int) -> NoiseSession:
    hs = HandshakeState(True, identity_priv)
    _send_frame(sock, hs.write_msg1())
    hs.read_msg2(_recv_frame(sock))
    _send_frame(sock, hs.write_msg3())
    send_cs, recv_cs = hs.split()
    return NoiseSession(send_cs, recv_cs, hs.remote_identity,
                        hs.handshake_hash)


def responder_handshake(sock, identity_priv: int) -> NoiseSession:
    hs = HandshakeState(False, identity_priv)
    hs.read_msg1(_recv_frame(sock))
    _send_frame(sock, hs.write_msg2())
    hs.read_msg3(_recv_frame(sock))
    send_cs, recv_cs = hs.split()
    return NoiseSession(send_cs, recv_cs, hs.remote_identity,
                        hs.handshake_hash)
