"""The port's libp2p wire formats against the JAX package's, tolerance
zero: every frame the two packages put on a socket for the same inputs is
byte-equal. The noise XX handshake with fixed keys (the keys and the
frozen transcript of tests/test_wire_transcripts.py), the plaintext
identity exchange, secp256k1 identities, multistream-select lines and
uvarints, yamux frames, snappy block and frame codecs on payloads made from
a seed with numpy, gossipsub protobuf RPCs and their varint framing, the
eth2 gossip message id, the req/resp request codecs and the response
chunks of ``encode_block`` (harness blocks, minimal preset, 64 validators,
fake crypto). No socket is opened."""
import types

import numpy as np
import pytest

import lighthouse_tpu.network.gossip as jgossip
import lighthouse_tpu.network.gossipsub_pb as jpb
import lighthouse_tpu.network.multistream as jms
import lighthouse_tpu.network.noise_xx as jnx
import lighthouse_tpu.network.plaintext as jplain
import lighthouse_tpu.network.rpc as jrpc
import lighthouse_tpu.network.secp256k1 as jsecp
import lighthouse_tpu.network.snappy as jsnappy
import lighthouse_tpu.network.yamux as jyamux
import lighthouse_tpu_torch.network.gossip as gossip
import lighthouse_tpu_torch.network.gossipsub_pb as pb
import lighthouse_tpu_torch.network.multistream as ms
import lighthouse_tpu_torch.network.noise_xx as nx
import lighthouse_tpu_torch.network.plaintext as plain
import lighthouse_tpu_torch.network.rpc as rpc
import lighthouse_tpu_torch.network.secp256k1 as secp
import lighthouse_tpu_torch.network.snappy as snappy
import lighthouse_tpu_torch.network.yamux as yamux
from lighthouse_tpu.chain import BeaconChainHarness as JHarness
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.network.sync import encode_block as j_encode_block
from lighthouse_tpu.specs import minimal_spec as j_minimal_spec
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.network.sync import encode_block
from lighthouse_tpu_torch.specs import minimal_spec

SEED = 15

# the fixed keys and the frozen transcript of tests/test_wire_transcripts.py
FIXED_KEYS = (0x41, 0x42, 0x11, 0x22)   # static_i, static_r, eph_i, eph_r
INIT_ID, RESP_ID = 7, 9
PIN_M1 = "7b4e909bbe7ffe44c465a220037d608ee35897d31ef972f07f74892cb0f73f13"
PIN_M2 = (
    "0faa684ed28867b97f4a6a2dee5df8ce974e76b7018e3f22a1c4cf2678570f20"
    "0929bb819495ecb9de426834fd1b99a769e27779566122d61772e4621f380bdf"
    "ae3658ce1992efd61e742742311ebf0f6dd9a69cfb6c1639137fe1e5bc6038ff"
    "2cade14eec62e50b12b6f8a7d036e9d0853f0cd4cb965eb4095149b650c76839"
    "c84f8bf61ad210b26c2308833261ff000c004b5987b1c2046ab29056fad48dcc"
    "45213128baf914454a634888b1c6f7f846771025a06701355d57c7fcd3487533"
    "8beb2d0e499f00cb32")
PIN_M3 = (
    "fca1aa7080fce2a80670215fa9d3f1645ac2cb69f0c61a0e76c0b4192b5c9fac"
    "18b5d073b22e23723adf6ef344ab25ccfa1fa339c9a84faf6c572e7418617084"
    "ff090a6ff14908558140930a59a2158702c6b795af0548ea93889a8586873a3e"
    "9bf060eb2dd6e409e6ea772d0cf5707d59a09ddebd266e0ccbd4982a229516f6"
    "453e2167992a1dfe185a9194baac4a7dcd8b2e96c585c144dc0b1b38a0dae8a9"
    "3f937dcece37b5ec35")
PIN_HSHASH = \
    "b3c83b21a1105f43a16e9b86e5076ee637763dcbeec43a946af4c79efac843a9"
PIN_T0 = "89a3e454635ad8dcb12390033c68d0b315de01246317cd34f14514bcb9611b"


def _payloads() -> list[bytes]:
    """Snappy inputs from the seed: random bytes (incompressible), a run,
    bytes from a small alphabet (copies of every length), an SSZ-like mix
    of zeros and words, and sizes across the 65,536-byte frame bound."""
    rng = np.random.default_rng(SEED)
    out = [b"", b"\x00", bytes(rng.integers(0, 256, 1, np.uint8))]
    for n in (17, 1_000, 65_536, 65_537, 200_000):
        out.append(rng.integers(0, 256, n, np.uint8).tobytes())
        out.append(rng.integers(0, 4, n, np.uint8).tobytes())
    out.append(b"\x07" * 100_000)
    words = rng.integers(0, 2**32, 4_096, np.uint32)
    words[rng.random(4_096) < 0.7] = 0
    out.append(words.tobytes())
    return out


def _handshake(module):
    hi = module.HandshakeState(True, INIT_ID)
    hr = module.HandshakeState(False, RESP_ID)
    m1 = hi.write_msg1()
    hr.read_msg1(m1)
    m2 = hr.write_msg2()
    hi.read_msg2(m2)
    m3 = hi.write_msg3()
    hr.read_msg3(m3)
    si_send, _ = hi.split()
    _, sr_recv = hr.split()
    ct = si_send.encrypt_with_ad(b"", b"transcript-ping")
    assert sr_recv.decrypt_with_ad(b"", ct) == b"transcript-ping"
    return (m1.hex(), m2.hex(), m3.hex(), hi.handshake_hash.hex(),
            ct.hex(), hr.remote_identity, hi.remote_identity)


def test_noise_xx_transcript_equals_the_jax_package_and_the_pins(
        monkeypatch):
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
    )
    got = []
    for module in (jnx, nx):
        queue = [X25519PrivateKey.from_private_bytes(bytes([i]) * 32)
                 for i in FIXED_KEYS]
        monkeypatch.setattr(X25519PrivateKey, "generate",
                            staticmethod(lambda q=queue: q.pop(0)))
        got.append(_handshake(module))
        assert not queue
    assert got[0] == got[1]
    assert got[1][:5] == (PIN_M1, PIN_M2, PIN_M3, PIN_HSHASH, PIN_T0)


@pytest.mark.parametrize("priv", [1, 7, 9, 0x41, secp.N - 1,
                                  0xDEADBEEF * 2**200 + 12345])
def test_identities_and_plaintext_exchange_equal(priv):
    pt, jpt = secp.pubkey(priv), jsecp.pubkey(priv)
    assert secp.compress(pt) == jsecp.compress(jpt)
    assert secp.uncompressed64(pt) == jsecp.uncompressed64(jpt)
    digest = bytes(range(32))
    assert secp.sign(priv, digest) == jsecp.sign(priv, digest)
    assert secp.verify(pt, digest, secp.sign(priv, digest))
    pub = secp.compress(pt)
    assert nx.peer_id_from_pubkey(pub) == jnx.peer_id_from_pubkey(pub)
    exchange = plain._make_exchange(priv)
    assert exchange == jplain._make_exchange(priv)
    assert plain._parse_exchange(exchange) == pub
    static = bytes(range(32))
    if nx.HAVE_CRYPTOGRAPHY:
        assert nx.make_payload(priv, static) == jnx.make_payload(priv, static)


def test_multistream_and_yamux_frames_equal():
    rng = np.random.default_rng(SEED)
    ints = [0, 1, 127, 128, 300, 16_383, 16_384, 2**32, 2**63 - 1] + [
        int(x) for x in rng.integers(0, 2**62, 64, np.int64)]
    for n in ints:
        assert ms.write_uvarint(n) == jms.write_uvarint(n)
        enc = ms.write_uvarint(n)
        pos = iter(range(len(enc)))

        def read(k, enc=enc, pos=pos):
            i = next(pos)
            return enc[i:i + k]
        assert ms.read_uvarint(read) == n
    for proto in ("/multistream/1.0.0", "/noise", "/plaintext/2.0.0",
                  "/yamux/1.0.0", "/meshsub/1.2.0", "na",
                  *(s.id for s in rpc._SPECS)):
        assert ms.encode_msg(proto) == jms.encode_msg(proto)
    assert [s.id for s in rpc._SPECS] == [s.id for s in jrpc._SPECS]
    for _ in range(64):
        ftype = int(rng.integers(0, 4))
        flags = int(rng.integers(0, 16))
        sid = int(rng.integers(0, 2**32))
        payload = rng.integers(0, 256, int(rng.integers(0, 300)),
                               np.uint8).tobytes() if ftype == 0 else b""
        length = None if ftype == 0 else int(rng.integers(0, 2**32))
        frame = yamux.encode_frame(ftype, flags, sid, payload, length)
        assert frame == jyamux.encode_frame(ftype, flags, sid, payload,
                                            length)
        assert yamux.decode_header(frame[:12]) == \
            jyamux.decode_header(frame[:12])


def test_snappy_block_and_frame_codecs_equal():
    for data in _payloads():
        block = snappy.compress_block(data)
        assert block == jsnappy.compress_block(data)
        assert snappy.decompress_block(block) == data
        frames = snappy.compress_frames(data)
        assert frames == jsnappy.compress_frames(data)
        assert snappy.decompress_frames(frames) == data
        assert snappy.crc32c(data) == jsnappy.crc32c(data)


def _rpc(module, rng) -> object:
    """A gossipsub RPC with every field the engine writes, made from
    ``rng``."""
    def b(n):
        return rng.integers(0, 256, n, np.uint8).tobytes()
    topics = [f"/eth2/{b(4).hex()}/beacon_attestation_{i}/ssz_snappy"
              for i in range(3)]
    mids = [b(20) for _ in range(5)]
    return module.Rpc(
        subscriptions=[module.SubOpts(bool(i % 2), t)
                       for i, t in enumerate(topics)],
        publish=[module.PubMessage(topic=t, data=b(100 + 50 * i))
                 for i, t in enumerate(topics)],
        control=module.ControlMessage(
            ihave=[module.ControlIHave(topics[0], mids[:3])],
            iwant=[module.ControlIWant(mids[3:])],
            graft=[module.ControlGraft(topics[1])],
            prune=[module.ControlPrune(
                topics[2], [module.PeerInfo(b(38), b(64))], backoff=60)],
            idontwant=[module.ControlIWant(mids[:2])]))


def test_gossipsub_protobuf_frames_equal():
    for i in range(8):
        ours = _rpc(pb, np.random.default_rng(SEED + i))
        theirs = _rpc(jpb, np.random.default_rng(SEED + i))
        enc = ours.encode()
        assert enc == theirs.encode()
        assert pb.frame(ours) == jpb.frame(theirs)
        assert pb.Rpc.decode(enc).encode() == enc
        buf = bytearray(pb.frame(ours) + pb.frame(ours))
        assert pb.unframe(buf).encode() == enc
        assert pb.unframe(buf).encode() == enc
        assert pb.unframe(buf) is None


def test_eth2_message_id_and_gossip_payload_equal():
    rng = np.random.default_rng(SEED)
    stub = types.SimpleNamespace(node_id="ab" * 16, peers={})
    for digest in (b"\xaa\xbb\xcc\xdd", b"\x01\x02\x03\x04"):
        ours = gossip.GossipEngine(stub, digest)
        theirs = jgossip.GossipEngine(stub, digest)
        for topic in (gossip.Topic.BLOCK, gossip.Topic.AGGREGATE,
                      gossip.Topic.attestation_subnet(17),
                      gossip.Topic.sync_subnet(2)):
            data = rng.integers(0, 256, int(rng.integers(1, 5_000)),
                                np.uint8).tobytes()
            assert gossip.full_topic(topic, digest) == \
                jgossip.full_topic(topic, digest)
            assert ours._message_id(topic, data) == \
                theirs._message_id(topic, data)
            assert ours._pub_msg(topic, data).encode() == \
                theirs._pub_msg(topic, data).encode()


class _Sink:
    def __init__(self):
        self.data = b""

    def write(self, data: bytes) -> None:
        self.data += data


def test_request_codecs_and_block_chunks_equal():
    """Each req/resp request's SSZ, and the response chunks of harness
    blocks (fork context + SSZ by ``encode_block``) with their varint +
    snappy framing."""
    requests = {"status": {"fork_digest": "01020304",
                           "finalized_root": "11" * 32,
                           "finalized_epoch": 3, "head_root": "22" * 32,
                           "head_slot": 99},
                "ping": {"seq": 5}, "goodbye": {"reason": 2},
                "metadata": {},
                "beacon_blocks_by_range": {"start_slot": 8, "count": 16},
                "beacon_blocks_by_root": {"roots": ["33" * 32, "44" * 32]}}
    for name, payload in requests.items():
        ssz = rpc.SPECS[name].enc_req(payload)
        assert ssz == jrpc.SPECS[name].enc_req(payload)
        assert rpc.SPECS[name].dec_req(ssz) == jrpc.SPECS[name].dec_req(ssz)
    meta = {"seq_number": 1, "attnets": "ff"}
    assert rpc.SPECS["metadata"].enc_resp(meta) == \
        jrpc.SPECS["metadata"].enc_resp(meta)

    prev, saved = set_device("cpu"), (bls._current, jbls._current)
    bls.set_backend("fake")
    jbls.set_backend("fake")
    try:
        ht = BeaconChainHarness(minimal_spec(), 64)
        hj = JHarness(j_minimal_spec(), 64)
        roots = ht.extend_chain(3)
        assert roots == hj.extend_chain(3)
        for root in roots:
            chunk = encode_block(ht.chain.store.get_block(root), ht.chain)
            assert chunk == j_encode_block(hj.chain.store.get_block(root),
                                           hj.chain)
            ours, theirs = _Sink(), _Sink()
            rpc.write_payload(ours, bytes.fromhex(chunk))
            jrpc.write_payload(theirs, bytes.fromhex(chunk))
            assert ours.data == theirs.data
    finally:
        bls._current, jbls._current = saved
        set_device(prev)
