"""discv5 v5.1 wire protocol — the REAL packet format.

Every byte here follows the devp2p discv5-wire spec the reference's `discv5`
crate implements (ref: beacon_node/lighthouse_network/src/discovery/
mod.rs drives it; boot_node/src/server.rs runs it standalone):

    packet        = masking-iv || masked-header || message
    masked-header = aesctr(masking-key=dest-id[:16], masking-iv, header)
    header        = static-header || authdata
    static-header = "discv5" || version(0x0001) || flag || nonce(12) ||
                    authdata-size(2, BE)

Flags: 0 = ordinary message (authdata = src-id, 32B), 1 = WHOAREYOU
(authdata = id-nonce(16) || enr-seq(8 BE)), 2 = handshake message
(authdata = src-id(32) || sig-size(1) || eph-key-size(1) ||
id-signature || eph-pubkey || record?).

Messages are AES-128-GCM sealed with the session key, nonce =
header.nonce, AD = masking-iv || header; plaintext = message-type ||
rlp(message-data).

Session keys (spec 4.5.2):
    challenge-data = masking-iv || static-header || authdata   (of the
                     WHOAREYOU packet, unmasked)
    secret    = ecdh(dest-pubkey, eph-privkey)      (compressed, 33B)
    kdf-info  = "discovery v5 key agreement" || id-A || id-B
    out       = HKDF-SHA256(secret, salt=challenge-data, info, 32)
    initiator-key, recipient-key = out[:16], out[16:]

id-signature (spec 4.5.3) = ecdsa(sha256("discovery v5 identity proof"
    || challenge-data || eph-pubkey || dest-node-id)).
"""
from __future__ import annotations

import hashlib
import os
import struct

from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import AESGCM
from cryptography.hazmat.primitives.kdf.hkdf import HKDF

from . import rlp, secp256k1

PROTOCOL_ID = b"discv5"
VERSION = 1
FLAG_ORDINARY = 0
FLAG_WHOAREYOU = 1
FLAG_HANDSHAKE = 2
MAX_PACKET = 1280
MIN_PACKET = 63

ID_PROOF_TEXT = b"discovery v5 identity proof"
KDF_INFO_TEXT = b"discovery v5 key agreement"

# message types (spec 5)
MSG_PING = 0x01
MSG_PONG = 0x02
MSG_FINDNODE = 0x03
MSG_NODES = 0x04
MSG_TALKREQ = 0x05
MSG_TALKRESP = 0x06


class WireError(Exception):
    pass


def _aes_ctr(key16: bytes, iv16: bytes, data: bytes) -> bytes:
    c = Cipher(algorithms.AES(key16), modes.CTR(iv16)).encryptor()
    return c.update(data) + c.finalize()


def _static_header(flag: int, nonce12: bytes, authdata_size: int) -> bytes:
    return PROTOCOL_ID + struct.pack(">HB", VERSION, flag) + nonce12 + \
        struct.pack(">H", authdata_size)


def _mask(dest_id: bytes, header: bytes, message: bytes,
          iv: bytes | None) -> bytes:
    iv = iv if iv is not None else os.urandom(16)
    return iv + _aes_ctr(dest_id[:16], iv, header) + message


class Header:
    """Decoded packet header (+ the raw bytes AEAD binds as AD)."""

    def __init__(self, flag: int, nonce: bytes, authdata: bytes,
                 iv: bytes, raw: bytes):
        self.flag = flag
        self.nonce = nonce
        self.authdata = authdata
        self.iv = iv
        self.raw = raw          # iv || unmasked header  (the AEAD AD)

    @property
    def challenge_data(self) -> bytes:
        """For WHOAREYOU packets: what handshake crypto binds to."""
        return self.raw


def encode_ordinary(dest_id: bytes, src_id: bytes, nonce12: bytes,
                    key16: bytes, plaintext: bytes,
                    iv: bytes | None = None) -> bytes:
    header = _static_header(FLAG_ORDINARY, nonce12, 32) + src_id
    iv = iv if iv is not None else os.urandom(16)
    ad = iv + header
    ct = AESGCM(key16).encrypt(nonce12, plaintext, ad)
    return _mask(dest_id, header, ct, iv)


def encode_random(dest_id: bytes, src_id: bytes) -> bytes:
    """An ordinary packet with unreadable payload — the session poke
    that elicits WHOAREYOU (spec: random packet)."""
    header = _static_header(FLAG_ORDINARY, os.urandom(12), 32) + src_id
    return _mask(dest_id, header, os.urandom(44), None)


def encode_whoareyou(dest_id: bytes, request_nonce: bytes,
                     id_nonce: bytes, enr_seq: int,
                     iv: bytes | None = None) -> bytes:
    authdata = id_nonce + struct.pack(">Q", enr_seq)
    header = _static_header(FLAG_WHOAREYOU, request_nonce, 24) + authdata
    return _mask(dest_id, header, b"", iv)


def encode_handshake(dest_id: bytes, src_id: bytes, nonce12: bytes,
                     key16: bytes, plaintext: bytes, id_signature: bytes,
                     eph_pubkey: bytes, record_rlp: bytes | None,
                     iv: bytes | None = None) -> bytes:
    authdata = src_id + bytes([len(id_signature), len(eph_pubkey)]) + \
        id_signature + eph_pubkey + (record_rlp or b"")
    header = _static_header(FLAG_HANDSHAKE, nonce12, len(authdata)) + \
        authdata
    iv = iv if iv is not None else os.urandom(16)
    ad = iv + header
    ct = AESGCM(key16).encrypt(nonce12, plaintext, ad)
    return _mask(dest_id, header, ct, iv)


def decode_packet(local_id: bytes, data: bytes) -> tuple[Header, bytes]:
    """Unmask with our node id -> (Header, message ciphertext)."""
    if not MIN_PACKET <= len(data) <= MAX_PACKET:
        raise WireError(f"bad packet size {len(data)}")
    iv = data[:16]
    dec = Cipher(algorithms.AES(local_id[:16]), modes.CTR(iv)).decryptor()
    fixed = dec.update(data[16:16 + 23])
    if fixed[:6] != PROTOCOL_ID:
        raise WireError("bad protocol id")
    version, flag = struct.unpack_from(">HB", fixed, 6)
    if version != VERSION:
        raise WireError(f"bad version {version}")
    if flag not in (FLAG_ORDINARY, FLAG_WHOAREYOU, FLAG_HANDSHAKE):
        raise WireError(f"bad flag {flag}")
    nonce = fixed[9:21]
    (authdata_size,) = struct.unpack_from(">H", fixed, 21)
    if 16 + 23 + authdata_size > len(data):
        raise WireError("truncated authdata")
    authdata = dec.update(data[16 + 23:16 + 23 + authdata_size])
    message = data[16 + 23 + authdata_size:]
    raw = iv + fixed + authdata
    return Header(flag, nonce, authdata, iv, raw), message


def parse_handshake_authdata(authdata: bytes
                             ) -> tuple[bytes, bytes, bytes, bytes]:
    """-> (src_id, id_signature, eph_pubkey, record_rlp)."""
    if len(authdata) < 34:
        raise WireError("handshake authdata too short")
    src_id = authdata[:32]
    sig_size, key_size = authdata[32], authdata[33]
    need = 34 + sig_size + key_size
    if len(authdata) < need:
        raise WireError("handshake authdata truncated")
    sig = authdata[34:34 + sig_size]
    eph = authdata[34 + sig_size:need]
    return src_id, sig, eph, authdata[need:]


def open_message(key16: bytes, header: Header, ciphertext: bytes) -> bytes:
    return AESGCM(key16).decrypt(header.nonce, ciphertext, header.raw)


# -- handshake crypto ---------------------------------------------------------

def id_sign(priv: int, challenge_data: bytes, eph_pubkey: bytes,
            dest_id: bytes) -> bytes:
    digest = hashlib.sha256(ID_PROOF_TEXT + challenge_data + eph_pubkey
                            + dest_id).digest()
    return secp256k1.sign(priv, digest)


def id_verify(static_pub_pt, signature: bytes, challenge_data: bytes,
              eph_pubkey: bytes, dest_id: bytes) -> bool:
    digest = hashlib.sha256(ID_PROOF_TEXT + challenge_data + eph_pubkey
                            + dest_id).digest()
    return secp256k1.verify(static_pub_pt, digest, signature)


def session_keys(secret33: bytes, challenge_data: bytes,
                 initiator_id: bytes, recipient_id: bytes
                 ) -> tuple[bytes, bytes]:
    okm = HKDF(algorithm=hashes.SHA256(), length=32, salt=challenge_data,
               info=KDF_INFO_TEXT + initiator_id + recipient_id
               ).derive(secret33)
    return okm[:16], okm[16:]


# -- message codec (RLP payloads, spec 5) -------------------------------------

def enc_ping(req_id: bytes, enr_seq: int) -> bytes:
    return bytes([MSG_PING]) + rlp.encode([req_id, enr_seq])


def enc_pong(req_id: bytes, enr_seq: int, ip: str, port: int) -> bytes:
    ip_bytes = bytes(int(x) for x in ip.split("."))
    return bytes([MSG_PONG]) + rlp.encode([req_id, enr_seq, ip_bytes, port])


def enc_findnode(req_id: bytes, distances: list[int]) -> bytes:
    return bytes([MSG_FINDNODE]) + rlp.encode([req_id, list(distances)])


def enc_nodes(req_id: bytes, total: int, enr_rlps: list) -> bytes:
    """enr_rlps: decoded RLP item lists (so records nest structurally,
    matching every other implementation's NODES encoding)."""
    return bytes([MSG_NODES]) + rlp.encode([req_id, total, enr_rlps])


def enc_talkreq(req_id: bytes, protocol: bytes, request: bytes) -> bytes:
    return bytes([MSG_TALKREQ]) + rlp.encode([req_id, protocol, request])


def enc_talkresp(req_id: bytes, response: bytes) -> bytes:
    return bytes([MSG_TALKRESP]) + rlp.encode([req_id, response])


def decode_message(plaintext: bytes) -> tuple[int, list]:
    if not plaintext:
        raise WireError("empty message")
    body = rlp.decode(plaintext[1:])
    if not isinstance(body, list) or not body:
        raise WireError("message body not a list")
    return plaintext[0], body
