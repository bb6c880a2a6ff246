"""EIP-778 Ethereum Node Records — the REAL wire format.

Records are RLP lists `[signature, seq, k, v, ...]` with
identity scheme "v4" (secp256k1; signature = deterministic low-s ECDSA
over keccak256(rlp([seq, k, v, ...])); node id = keccak256(uncompressed
pubkey)); text form `enr:` + unpadded base64url.

Ref parity: beacon_node/lighthouse_network/src/discovery/enr.rs:186
(build_enr — eth2/attnets/syncnets/quic fields ride the same kv space);
the encoding itself matches the `enr` crate the reference re-exports.

Golden fixture: the EIP-778 sample record round-trips bit-exactly
(tests/test_torch_enr.py) — proving interop with every other client's ENRs.
"""
from __future__ import annotations

import base64

from . import rlp, secp256k1
from .keccak import keccak256

MAX_ENR_SIZE = 300
ID_V4 = b"v4"


class EnrError(Exception):
    pass


class Enr:
    """An Ethereum Node Record.

    kv values are raw bytes; helpers expose the common typed fields
    (ip/udp/tcp/quic as ints, eth2/attnets/syncnets as bytes).
    """

    def __init__(self, seq: int = 1, kv: dict[bytes, bytes] | None = None,
                 signature: bytes = b""):
        self.seq = seq
        self.kv = dict(kv or {})
        self.signature = signature

    # -- content --------------------------------------------------------------

    def _content_items(self) -> list:
        items: list = [rlp.encode_int(self.seq)]
        for k in sorted(self.kv):
            items += [k, self.kv[k]]
        return items

    def signing_digest(self) -> bytes:
        return keccak256(rlp.encode(self._content_items()))

    def sign(self, priv: int) -> "Enr":
        pub = secp256k1.pubkey(priv)
        self.kv[b"id"] = ID_V4
        self.kv[b"secp256k1"] = secp256k1.compress(pub)
        self.signature = secp256k1.sign(priv, self.signing_digest())
        if len(self.to_rlp()) > MAX_ENR_SIZE:
            raise EnrError("record exceeds 300 bytes")
        return self

    def verify(self) -> bool:
        if self.kv.get(b"id") != ID_V4:
            return False
        try:
            pub = secp256k1.decompress(self.kv[b"secp256k1"])
        except (KeyError, ValueError):
            return False
        return secp256k1.verify(pub, self.signing_digest(), self.signature)

    @property
    def node_id(self) -> bytes:
        pub = secp256k1.decompress(self.kv[b"secp256k1"])
        return keccak256(secp256k1.uncompressed64(pub))

    @property
    def public_key(self) -> bytes:
        return self.kv[b"secp256k1"]

    # -- codec ----------------------------------------------------------------

    def to_rlp(self) -> bytes:
        return rlp.encode([self.signature] + self._content_items())

    @classmethod
    def from_rlp(cls, data: bytes) -> "Enr":
        if len(data) > MAX_ENR_SIZE:
            raise EnrError("record exceeds 300 bytes")
        items = rlp.decode(data)
        if not isinstance(items, list) or len(items) < 2 or \
                len(items) % 2 != 0:
            raise EnrError("malformed record list")
        sig, seq_raw, rest = items[0], items[1], items[2:]
        kv: dict[bytes, bytes] = {}
        prev = None
        for i in range(0, len(rest), 2):
            k, v = rest[i], rest[i + 1]
            if not isinstance(k, bytes) or not isinstance(v, bytes):
                raise EnrError("non-bytes kv")
            if prev is not None and k <= prev:
                raise EnrError("kv keys not strictly sorted")
            prev = k
            kv[k] = v
        rec = cls(seq=rlp.decode_int(seq_raw) if seq_raw else 0, kv=kv,
                  signature=sig)
        if not rec.verify():
            raise EnrError("invalid record signature")
        return rec

    def to_text(self) -> str:
        return "enr:" + base64.urlsafe_b64encode(
            self.to_rlp()).rstrip(b"=").decode()

    @classmethod
    def from_text(cls, text: str) -> "Enr":
        if not text.startswith("enr:"):
            raise EnrError("missing enr: prefix")
        b64 = text[4:]
        return cls.from_rlp(base64.urlsafe_b64decode(
            b64 + "=" * (-len(b64) % 4)))

    # -- typed field helpers --------------------------------------------------

    def _set_int(self, key: bytes, v: int | None, width: int) -> None:
        if v is None:
            self.kv.pop(key, None)
        else:
            self.kv[key] = v.to_bytes(width, "big")

    def set_fields(self, ip=None, udp: int | None = None,
                   tcp: int | None = None, quic: int | None = None,
                   eth2: bytes | None = None, attnets: bytes | None = None,
                   syncnets: bytes | None = None) -> "Enr":
        if ip is not None:
            parts = [int(x) for x in ip.split(".")] \
                if isinstance(ip, str) else list(ip)
            self.kv[b"ip"] = bytes(parts)
        for key, val in ((b"udp", udp), (b"tcp", tcp), (b"quic", quic)):
            if val is not None:
                self._set_int(key, val, 2)
        for key, val in ((b"eth2", eth2), (b"attnets", attnets),
                         (b"syncnets", syncnets)):
            if val is not None:
                self.kv[key] = val
        return self

    def ip(self) -> str | None:
        raw = self.kv.get(b"ip")
        return ".".join(str(b) for b in raw) if raw else None

    def udp(self) -> int | None:
        raw = self.kv.get(b"udp")
        return int.from_bytes(raw, "big") if raw else None

    def tcp(self) -> int | None:
        raw = self.kv.get(b"tcp")
        return int.from_bytes(raw, "big") if raw else None

    def quic(self) -> int | None:
        raw = self.kv.get(b"quic")
        return int.from_bytes(raw, "big") if raw else None

    def eth2(self) -> bytes | None:
        return self.kv.get(b"eth2")

    def attnets(self) -> bytes | None:
        return self.kv.get(b"attnets")

    def syncnets(self) -> bytes | None:
        return self.kv.get(b"syncnets")
