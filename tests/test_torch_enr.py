"""RLP / keccak / EIP-778 ENR wire-format tests.

The point of these: byte-level golden fixtures
from OUTSIDE this repo — the canonical RLP examples from the Ethereum
wiki test suite, the keccak-256 reference digests, and the EIP-778
sample record itself — so the formats are proven against what real
clients emit, not merely self-to-self round-trips.  The same cases as the JAX package's
tests/test_enr.py, run on the port (imports switched to
lighthouse_tpu_torch).
"""
import pytest

from lighthouse_tpu_torch.network import rlp, secp256k1
from lighthouse_tpu_torch.network.enr import Enr, EnrError
from lighthouse_tpu_torch.network.keccak import keccak256

# the sample record published in EIP-778 (produced by go-ethereum)
EIP778_SAMPLE = (
    "enr:-IS4QHCYrYZbAKWCBRlAy5zzaDZXJBGkcnh4MHcBFZntXNFrdvJjX04jRzjzCBOo"
    "nrkTfj499SZuOh8R33Ls8RRcy5wBgmlkgnY0gmlwhH8AAAGJc2VjcDI1NmsxoQPKY0yu"
    "DUmstAHYpMa2_oxVtw0RW_QAdpzBQA8yWM0xOIN1ZHCCdl8"
)
EIP778_NODE_ID = \
    "a448f24c6d18e575453db13171562b71999873db5b286df957af199ec94617f7"


class TestKeccak:
    def test_reference_digests(self):
        # canonical Keccak-256 vectors (pre-FIPS padding)
        assert keccak256(b"").hex() == (
            "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
        assert keccak256(b"abc").hex() == (
            "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")

    def test_differs_from_sha3(self):
        import hashlib
        assert keccak256(b"abc") != hashlib.sha3_256(b"abc").digest()

    def test_multiblock(self):
        # > one 136-byte rate block
        out = keccak256(b"q" * 300)
        assert len(out) == 32 and out != keccak256(b"q" * 299)


class TestRlp:
    # the classic Ethereum-wiki RLP test vectors
    VECTORS = [
        (b"dog", "83646f67"),
        ([b"cat", b"dog"], "c88363617483646f67"),
        (b"", "80"),
        ([], "c0"),
        (0, "80"),
        (15, "0f"),
        (1024, "820400"),
        ([[], [[]], [[], [[]]]], "c7c0c1c0c3c0c1c0"),
        (b"Lorem ipsum dolor sit amet, consectetur adipisicing elit",
         "b8384c6f72656d20697073756d20646f6c6f722073697420616d65742c2063"
         "6f6e7365637465747572206164697069736963696e6720656c6974"),
    ]

    def test_encode_vectors(self):
        for item, hexs in self.VECTORS:
            assert rlp.encode(item).hex() == hexs, item

    def test_decode_roundtrip(self):
        for item, hexs in self.VECTORS:
            got = rlp.decode(bytes.fromhex(hexs))
            if isinstance(item, int):
                assert rlp.decode_int(got) == item if item else got == b""
            else:
                assert got == item or _canon(got) == _canon(item)

    def test_rejects_noncanonical(self):
        with pytest.raises(rlp.RlpError):
            rlp.decode(bytes.fromhex("8100"))       # 1-byte string < 0x80
        with pytest.raises(rlp.RlpError):
            rlp.decode(bytes.fromhex("b80100"))     # long form for len<56
        with pytest.raises(rlp.RlpError):
            rlp.decode(bytes.fromhex("83646f"))     # truncated
        with pytest.raises(rlp.RlpError):
            rlp.decode(bytes.fromhex("83646f6767"))  # trailing bytes


def _canon(x):
    if isinstance(x, list):
        return [_canon(i) for i in x]
    return bytes(x)


class TestSecp256k1:
    def test_sign_verify(self):
        priv = 0xDEADBEEF12345678
        pub = secp256k1.pubkey(priv)
        digest = keccak256(b"hello world")
        sig = secp256k1.sign(priv, digest)
        assert len(sig) == 64
        assert secp256k1.verify(pub, digest, sig)
        assert not secp256k1.verify(pub, keccak256(b"other"), sig)
        # deterministic: same digest -> same signature
        assert secp256k1.sign(priv, digest) == sig
        # low-s normalized
        s = int.from_bytes(sig[32:], "big")
        assert s <= secp256k1.N // 2

    def test_compress_roundtrip(self):
        pt = secp256k1.pubkey(7)
        assert secp256k1.decompress(secp256k1.compress(pt)) == pt

    def test_ecdh_symmetry(self):
        a, b = 1234567, 7654321
        pa, pb = secp256k1.pubkey(a), secp256k1.pubkey(b)
        assert secp256k1.ecdh(pb, a) == secp256k1.ecdh(pa, b)
        assert len(secp256k1.ecdh(pb, a)) == 33


class TestEnr:
    def test_eip778_sample_decodes_and_verifies(self):
        """The published sample record is the golden interop fixture:
        RLP layout, keccak content digest, secp256k1 signature check and
        node-id derivation all must match what go-ethereum produced."""
        rec = Enr.from_text(EIP778_SAMPLE)     # from_rlp verifies the sig
        assert rec.seq == 1
        assert rec.ip() == "127.0.0.1"
        assert rec.udp() == 30303
        assert rec.kv[b"id"] == b"v4"
        assert rec.node_id.hex() == EIP778_NODE_ID
        # text form round-trips bit-exactly
        assert rec.to_text() == EIP778_SAMPLE

    def test_tampered_record_rejected(self):
        rec = Enr.from_text(EIP778_SAMPLE)
        rec.kv[b"udp"] = (9999).to_bytes(2, "big")
        assert not rec.verify()
        with pytest.raises(EnrError):
            Enr.from_rlp(rec.to_rlp())

    def test_sign_roundtrip_own_key(self):
        priv = 0x3141592653589793
        rec = Enr(seq=5).set_fields(
            ip="10.0.0.2", udp=9000, tcp=9000, quic=9001,
            eth2=bytes.fromhex("ffaabbcc00000000"),
            attnets=b"\xff" * 8, syncnets=b"\x0f").sign(priv)
        back = Enr.from_rlp(rec.to_rlp())
        assert back.node_id == rec.node_id
        assert back.udp() == 9000 and back.quic() == 9001
        assert back.eth2() == bytes.fromhex("ffaabbcc00000000")
        assert back.to_text() == rec.to_text()

    def test_keys_must_be_sorted(self):
        rec = Enr(seq=1).set_fields(ip="1.2.3.4", udp=1).sign(42)
        items = rlp.decode(rec.to_rlp())
        # swap two kv pairs out of order
        items[2], items[4] = items[4], items[2]
        items[3], items[5] = items[5], items[3]
        with pytest.raises(EnrError):
            Enr.from_rlp(rlp.encode(items))

    def test_size_limit(self):
        rec = Enr(seq=1)
        rec.kv[b"huge"] = b"\x7f" * 400
        with pytest.raises(EnrError):
            rec.sign(42)
