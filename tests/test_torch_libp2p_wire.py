"""libp2p wire formats: noise XX, multistream-select, yamux, gossipsub
protobufs (real formats, byte-level checks).

Independence strategy: gossipsub RPCs are cross-checked against
protoc-compiled google.protobuf code generated from the schema text (an
entirely separate encoder); multistream/yamux frames are golden
hand-written bytes from the specs; noise runs the full XX state machine
both ways plus tamper/downgrade rejection.  The same cases as the JAX
package's tests/test_libp2p_wire.py, run on the port (imports switched
to lighthouse_tpu_torch).
"""
import socket
import struct
import subprocess
import sys
import threading
import importlib.util
from pathlib import Path

import pytest

from lighthouse_tpu_torch.network import gossipsub_pb as pb
from lighthouse_tpu_torch.network import multistream as ms
from lighthouse_tpu_torch.network import noise_xx, yamux
from lighthouse_tpu_torch.network.noise_xx import (
    HandshakeState, NoiseError, initiator_handshake, responder_handshake,
    peer_id_from_pubkey,
)


def _sock_pair():
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    return a, b


@pytest.mark.skipif(importlib.util.find_spec("cryptography") is None,
                    reason="noise XX needs real X25519/ChaCha20 primitives")
class TestNoiseXX:
    def test_full_handshake_and_transport(self):
        a, b = _sock_pair()
        ida, idb = 1111, 2222
        out = {}

        def responder():
            out["resp"] = responder_handshake(b, idb)

        t = threading.Thread(target=responder)
        t.start()
        init = initiator_handshake(a, ida)
        t.join()
        resp = out["resp"]
        # both sides authenticated the other's libp2p identity
        from lighthouse_tpu_torch.network import secp256k1
        assert init.remote_identity == secp256k1.compress(
            secp256k1.pubkey(idb))
        assert resp.remote_identity == secp256k1.compress(
            secp256k1.pubkey(ida))
        # identical handshake transcript hash
        assert init.handshake_hash == resp.handshake_hash
        # transport messages flow both ways
        init.send(a, b"hello from initiator")
        assert resp.recv(b) == b"hello from initiator"
        resp.send(b, b"hi back")
        assert init.recv(a) == b"hi back"
        a.close(); b.close()

    def test_message_structure(self):
        """XX message 2 = e(32) || enc_s(48) || enc_payload; the 48 bytes
        are exactly ChaChaPoly(s_pub) with its 16-byte tag (Noise spec
        sizes — a wire-compat invariant)."""
        i = HandshakeState(True, 1)
        r = HandshakeState(False, 2)
        m1 = i.write_msg1()
        assert len(m1) == 32
        r.read_msg1(m1)
        m2 = r.write_msg2()
        assert len(m2) > 32 + 48
        i.read_msg2(m2)
        m3 = i.write_msg3()
        assert len(m3) > 48
        r.read_msg3(m3)
        ics, icr = i.split()
        rcs, rcr = r.split()
        assert ics.k == rcr.k and icr.k == rcs.k and ics.k != icr.k

    def test_tampered_static_rejected(self):
        i = HandshakeState(True, 1)
        r = HandshakeState(False, 2)
        r.read_msg1(i.write_msg1())
        m2 = bytearray(r.write_msg2())
        m2[40] ^= 1          # inside enc_s
        with pytest.raises(NoiseError):
            i.read_msg2(bytes(m2))

    def test_wrong_identity_signature_rejected(self):
        """A payload signed over a different static key must not verify
        (key-delegation binding)."""
        payload = noise_xx.make_payload(99, b"\x01" * 32)
        with pytest.raises(NoiseError):
            noise_xx.verify_payload(payload, b"\x02" * 32)

    def test_peer_id_identity_multihash(self):
        from lighthouse_tpu_torch.network import secp256k1
        pub = secp256k1.compress(secp256k1.pubkey(5))
        pid = peer_id_from_pubkey(pub)
        # identity multihash: 0x00 || length || PublicKey protobuf
        assert pid[0] == 0x00 and pid[1] == len(pid) - 2
        assert pub in pid


class TestMultistream:
    def test_golden_frame_bytes(self):
        # '/multistream/1.0.0\n' is 19 bytes -> varint 0x13
        assert ms.encode_msg(ms.MULTISTREAM) == \
            b"\x13/multistream/1.0.0\n"
        assert ms.encode_msg("na") == b"\x03na\n"
        assert ms.encode_msg("/yamux/1.0.0") == b"\x0d/yamux/1.0.0\n"

    def test_negotiation_accept_and_refuse(self):
        a, b = _sock_pair()
        out = {}

        def listener():
            out["got"] = ms.negotiate_in(b, ["/yamux/1.0.0"])

        t = threading.Thread(target=listener)
        t.start()
        chosen = ms.negotiate_out(a, ["/mplex/6.7.0", "/yamux/1.0.0"])
        t.join()
        assert chosen == "/yamux/1.0.0" and out["got"] == "/yamux/1.0.0"
        a.close(); b.close()

    def test_all_refused(self):
        a, b = _sock_pair()

        def listener():
            # the dialer gives up after the refusal and closes its end;
            # the responder's next read failing is the expected outcome
            try:
                ms.negotiate_in(b, ["/noise"])
            except (ms.MultistreamError, OSError):
                pass

        t = threading.Thread(target=listener)
        t.start()
        with pytest.raises(ms.MultistreamError):
            ms.negotiate_out(a, ["/tls/1.0.0"])
        a.close()
        t.join()
        b.close()

    def test_varint_multibyte(self):
        data = []
        proto = "/" + "x" * 200      # line length 202 -> 2-byte varint
        enc = ms.encode_msg(proto)
        assert enc[:2] == bytes([0xCA, 0x01])
        it = iter([enc])
        buf = bytearray(enc)

        def read_exact(n):
            out = bytes(buf[:n]); del buf[:n]; return out

        assert ms.decode_msg(read_exact) == proto


class TestYamux:
    def test_golden_header_bytes(self):
        # version 0, type Data(0), flags SYN(1), stream 1, len 5
        frame = yamux.encode_frame(yamux.TYPE_DATA, yamux.FLAG_SYN, 1,
                                   b"hello")
        assert frame[:12] == bytes.fromhex("000000010000000100000005")
        assert frame[12:] == b"hello"
        # window update of 64 KiB on stream 2
        wu = yamux.encode_frame(yamux.TYPE_WINDOW_UPDATE, 0, 2,
                                length=65536)
        assert wu == bytes.fromhex("000100000000000200010000")

    def test_session_pair_streams(self):
        """Two sessions wired back-to-back: SYN/ACK, data both ways,
        FIN half-close, ping, window replenish."""
        wires = {"a": bytearray(), "b": bytearray()}
        accepted = []
        sa = yamux.Session(lambda d: wires["a"].extend(d), initiator=True)
        sb = yamux.Session(lambda d: wires["b"].extend(d), initiator=False,
                           on_stream=accepted.append)

        def pump():
            moved = True
            while moved:
                moved = False
                if wires["a"]:
                    data, wires["a"] = bytes(wires["a"]), bytearray()
                    sb.on_bytes(data); moved = True
                if wires["b"]:
                    data, wires["b"] = bytes(wires["b"]), bytearray()
                    sa.on_bytes(data); moved = True

        st = sa.open_stream()
        assert st.id == 1          # initiator streams are odd
        st.write(b"ping over yamux")
        pump()
        assert len(accepted) == 1
        peer_st = accepted[0]
        assert peer_st.read(timeout=1) == b"ping over yamux"
        peer_st.write(b"pong")
        pump()
        assert st.read(timeout=1) == b"pong"
        # half close
        st.close()
        pump()
        assert peer_st.recv_closed
        # ping round-trip
        sa.ping(0xDEAD)
        pump()
        assert not sb.closed

    def test_large_transfer_flow_control(self):
        lock = threading.Lock()
        wires = {"a": bytearray(), "b": bytearray()}

        def _send(which):
            def fn(d):
                with lock:
                    wires[which].extend(d)
            return fn

        def _drain(which):
            with lock:
                data = bytes(wires[which])
                wires[which].clear()
            return data

        accepted = []
        sa = yamux.Session(_send("a"), initiator=True)
        sb = yamux.Session(_send("b"), initiator=False,
                           on_stream=accepted.append)
        st = sa.open_stream()
        payload = bytes(range(256)) * 2048         # 512 KiB > window
        received = bytearray()
        done = threading.Event()

        def writer():
            st.write(payload)
            done.set()

        t = threading.Thread(target=writer)
        t.start()
        import time
        deadline = time.monotonic() + 20
        while len(received) < len(payload) and \
                time.monotonic() < deadline:
            moved = False
            data = _drain("a")
            if data:
                sb.on_bytes(data)
                moved = True
            if accepted and accepted[0].recv_buf:
                received += accepted[0].read(timeout=0.01)
                moved = True
            data = _drain("b")
            if data:
                sa.on_bytes(data)
                moved = True
            if not moved:
                time.sleep(0.001)   # let the blocked writer run
        t.join(timeout=5)
        assert bytes(received) == payload

    def test_unknown_stream_rst(self):
        sent = bytearray()
        s = yamux.Session(sent.extend, initiator=False)
        s.on_bytes(yamux.encode_frame(yamux.TYPE_DATA, 0, 99, b"zz"))
        ftype, flags, sid, _ = yamux.decode_header(bytes(sent[:12]))
        assert ftype == yamux.TYPE_DATA and flags & yamux.FLAG_RST \
            and sid == 99


RPC_PROTO = """
syntax = "proto2";
package compat;
message RPC {
  repeated SubOpts subscriptions = 1;
  repeated Message publish = 2;
  optional ControlMessage control = 3;
  message SubOpts { optional bool subscribe = 1;
                    optional string topic_id = 2; }
}
message Message {
  optional bytes from = 1;
  optional bytes data = 2;
  optional bytes seqno = 3;
  required string topic = 4;
  optional bytes signature = 5;
  optional bytes key = 6;
}
message ControlMessage {
  repeated ControlIHave ihave = 1;
  repeated ControlIWant iwant = 2;
  repeated ControlGraft graft = 3;
  repeated ControlPrune prune = 4;
  repeated ControlIDontWant idontwant = 5;
}
message ControlIHave { optional string topic_id = 1;
                       repeated bytes message_ids = 2; }
message ControlIWant { repeated bytes message_ids = 1; }
message ControlGraft { optional string topic_id = 1; }
message ControlPrune { optional string topic_id = 1;
                       repeated PeerInfo peers = 2;
                       optional uint64 backoff = 3; }
message PeerInfo { optional bytes peer_id = 1;
                   optional bytes signed_peer_record = 2; }
message ControlIDontWant { repeated bytes message_ids = 1; }
"""


@pytest.fixture(scope="module")
def protoc_module(tmp_path_factory):
    """Compile the gossipsub schema with protoc -> an INDEPENDENT
    google.protobuf encoder to cross-check ours against."""
    d = tmp_path_factory.mktemp("pb")
    (d / "rpc.proto").write_text(RPC_PROTO)
    try:
        subprocess.run(["protoc", f"--python_out={d}", "rpc.proto"],
                       cwd=d, check=True, capture_output=True)
    except (FileNotFoundError, subprocess.CalledProcessError) as e:
        pytest.skip(f"protoc unavailable: {e}")
    sys.path.insert(0, str(d))
    try:
        import rpc_pb2   # noqa
        yield rpc_pb2
    finally:
        sys.path.remove(str(d))
        sys.modules.pop("rpc_pb2", None)


class TestGossipsubPb:
    def _sample(self):
        return pb.Rpc(
            subscriptions=[pb.SubOpts(True, "/eth2/aabbccdd/beacon_block/"
                                            "ssz_snappy"),
                           pb.SubOpts(False, "old_topic")],
            publish=[pb.PubMessage(data=b"\x01" * 40, topic="t1",
                                   seqno=b"\x00" * 8),
                     pb.PubMessage(data=b"block bytes", topic="t2")],
            control=pb.ControlMessage(
                ihave=[pb.ControlIHave("t1", [b"m" * 20, b"n" * 20])],
                iwant=[pb.ControlIWant([b"w" * 20])],
                graft=[pb.ControlGraft("t1")],
                prune=[pb.ControlPrune("t2", [pb.PeerInfo(b"\x00\x25pid")],
                                       backoff=60)],
                idontwant=[pb.ControlIWant([b"d" * 20])]))

    def test_roundtrip(self):
        rpc = self._sample()
        back = pb.Rpc.decode(rpc.encode())
        assert [s.topic for s in back.subscriptions] == \
            [s.topic for s in rpc.subscriptions]
        assert back.publish[0].data == b"\x01" * 40
        assert back.control.prune[0].backoff == 60
        assert back.control.idontwant[0].message_ids == [b"d" * 20]

    def test_cross_check_against_protoc(self, protoc_module):
        """Byte-for-byte equality with the protoc/google.protobuf
        encoding of the same RPC — proves wire interop."""
        m = protoc_module
        rpc = m.RPC()
        s1 = rpc.subscriptions.add()
        s1.subscribe = True
        s1.topic_id = "/eth2/aabbccdd/beacon_block/ssz_snappy"
        s2 = rpc.subscriptions.add()
        s2.subscribe = False
        s2.topic_id = "old_topic"
        p1 = rpc.publish.add()
        p1.data = b"\x01" * 40
        p1.seqno = b"\x00" * 8
        p1.topic = "t1"
        p2 = rpc.publish.add()
        p2.data = b"block bytes"
        p2.topic = "t2"
        ih = rpc.control.ihave.add()
        ih.topic_id = "t1"
        ih.message_ids.extend([b"m" * 20, b"n" * 20])
        rpc.control.iwant.add().message_ids.append(b"w" * 20)
        rpc.control.graft.add().topic_id = "t1"
        pr = rpc.control.prune.add()
        pr.topic_id = "t2"
        pr.peers.add().peer_id = b"\x00\x25pid"
        pr.backoff = 60
        rpc.control.idontwant.add().message_ids.append(b"d" * 20)
        theirs = rpc.SerializeToString()
        assert self._sample().encode() == theirs
        # and our decoder reads their bytes
        back = pb.Rpc.decode(theirs)
        assert back.publish[1].topic == "t2"
        assert back.control.ihave[0].message_ids[1] == b"n" * 20

    def test_framing(self):
        rpc = self._sample()
        buf = bytearray(pb.frame(rpc) + pb.frame(pb.Rpc(
            publish=[pb.PubMessage(topic="x")])))
        first = pb.unframe(buf)
        assert first is not None and first.control is not None
        second = pb.unframe(buf)
        assert second is not None and second.publish[0].topic == "x"
        assert pb.unframe(buf) is None and not buf

    def test_partial_frame(self):
        whole = pb.frame(self._sample())
        buf = bytearray(whole[:10])
        assert pb.unframe(buf) is None
        buf += whole[10:]
        assert pb.unframe(buf) is not None
