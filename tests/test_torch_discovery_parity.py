"""The discovery group, the fault fabric, the named networks and the key
store, the port against the JAX package on the CPU. Tolerance: exact bytes.

Every input is drawn from a numpy seed (node keys, seq numbers, nonces,
salts, IVs, seeds), goes through each package's function, and the outputs
must be byte-equal: keccak-256 and RLP; a signed ENR's RLP and text form,
each package decoding the other's text; discv5 ordinary, WHOAREYOU and
handshake packets under fixed ephemeral keys, nonces and masking IVs (and
each package opens the other's); an EIP-2335 keystore's JSON under a fixed
salt, IV and UUID, and its decrypted secret; EIP-2333 keys along
``m/12381/3600/i/0/0``; ``FaultInjector``'s drop pattern; every field of
``network_spec(name)``. Last, the port's ``MonitoringService`` posts to a
local HTTP server."""
import dataclasses
import http.server
import json
import os
import threading
import time
import uuid

import numpy as np
import pytest

pytest.importorskip("cryptography")

from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.crypto import key_derivation as jkd
from lighthouse_tpu.crypto import keystore as jks
from lighthouse_tpu.network import discv5_wire as jwire
from lighthouse_tpu.network import faults as jfaults
from lighthouse_tpu.network import keccak as jkeccak
from lighthouse_tpu.network import rlp as jrlp
from lighthouse_tpu.network import secp256k1 as jsecp
from lighthouse_tpu.network.enr import Enr as JEnr
from lighthouse_tpu.specs import networks as jnetworks
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto import key_derivation as kd
from lighthouse_tpu_torch.crypto import keystore as ks
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.network import discv5_wire as wire
from lighthouse_tpu_torch.network import faults
from lighthouse_tpu_torch.network import keccak
from lighthouse_tpu_torch.network import rlp
from lighthouse_tpu_torch.network import secp256k1 as secp
from lighthouse_tpu_torch.network.enr import Enr
from lighthouse_tpu_torch.specs import networks
from lighthouse_tpu_torch.utils.monitoring import MonitoringService

SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev, saved, jsaved = set_device("cpu"), bls._current, jbls._current
    yield
    bls._current, jbls._current = saved, jsaved
    set_device(prev)


def _bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _key(rng):
    return int.from_bytes(_bytes(rng, 32), "big") % (SECP_N - 1) + 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keccak_and_rlp_bytes_equal(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 55, 56, 135, 136, 137, 300):
        data = _bytes(rng, n)
        assert keccak.keccak256(data) == jkeccak.keccak256(data)
    ints = [0, 1, 127, 128, 255, 256, 2**64 - 1,
            int(rng.integers(0, 2**62))]
    items = [_bytes(rng, n) for n in (0, 1, 55, 56, 1024)]
    nested = [items[:2], [ints[:3], [b"", []]], items[4], ints[-1]]
    for item in ints + items + [nested]:
        mine = rlp.encode(item)
        assert mine == jrlp.encode(item)
        assert rlp.decode(mine) == jrlp.decode(mine)
    for v in ints:
        assert rlp.encode_int(v) == jrlp.encode_int(v)


def _enr_pair(rng):
    priv = _key(rng)
    seq = int(rng.integers(1, 2**40))
    ip = ".".join(str(int(x)) for x in rng.integers(1, 255, 4))
    udp, tcp = (int(x) for x in rng.integers(1024, 65535, 2))
    eth2, attnets = _bytes(rng, 16), _bytes(rng, 8)
    made = []
    for cls in (Enr, JEnr):
        e = cls(seq=seq)
        e.set_fields(ip=ip, udp=udp, tcp=tcp, eth2=eth2, attnets=attnets,
                     syncnets=b"\x05")
        made.append(e.sign(priv))
    return made


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_signed_enr_bytes_and_text_equal(seed):
    mine, theirs = _enr_pair(np.random.default_rng(seed))
    assert mine.to_rlp() == theirs.to_rlp()
    assert mine.to_text() == theirs.to_text()
    assert mine.node_id == theirs.node_id
    # each package decodes the other's text form and re-encodes it
    back = Enr.from_text(theirs.to_text())
    jback = JEnr.from_text(mine.to_text())
    assert back.verify() and jback.verify()
    assert back.to_rlp() == theirs.to_rlp() and jback.to_rlp() == mine.to_rlp()
    assert (back.ip(), back.udp(), back.tcp()) == \
        (theirs.ip(), theirs.udp(), theirs.tcp())


@pytest.mark.parametrize("seed", [0, 1])
def test_discv5_packets_bytes_equal(seed):
    rng = np.random.default_rng(seed)
    a_priv, b_priv, eph_priv = _key(rng), _key(rng), _key(rng)
    a_id = keccak.keccak256(secp.uncompressed64(secp.pubkey(a_priv)))
    b_id = keccak.keccak256(secp.uncompressed64(secp.pubkey(b_priv)))
    nonce, id_nonce = _bytes(rng, 12), _bytes(rng, 16)
    iv_w, iv_h, iv_o = _bytes(rng, 16), _bytes(rng, 16), _bytes(rng, 16)
    req_id = _bytes(rng, 8)
    enr_seq = int(rng.integers(1, 2**32))
    record = Enr(seq=enr_seq).set_fields(ip="127.0.0.1", udp=9000) \
        .sign(a_priv).to_rlp()
    out = {}
    for name, w, s in (("port", wire, secp), ("jax", jwire, jsecp)):
        # b answers a's random packet with WHOAREYOU
        who = w.encode_whoareyou(a_id, nonce, id_nonce, enr_seq, iv=iv_w)
        header, _ = w.decode_packet(a_id, who)
        chal = header.challenge_data
        eph_pub = s.compress(s.pubkey(eph_priv))
        secret = s.ecdh(s.pubkey(b_priv), eph_priv)
        ikey, rkey = w.session_keys(secret, chal, a_id, b_id)
        id_sig = w.id_sign(a_priv, chal, eph_pub, b_id)
        msg = w.enc_findnode(req_id, [256, 255, 0])
        hs = w.encode_handshake(b_id, a_id, nonce, ikey, msg, id_sig,
                                eph_pub, record, iv=iv_h)
        pong = w.enc_pong(req_id, enr_seq, "10.1.2.3", 30303)
        ordinary = w.encode_ordinary(a_id, b_id, nonce[::-1], rkey, pong,
                                     iv=iv_o)
        out[name] = (who, ikey, rkey, id_sig, hs, ordinary)
    assert out["port"] == out["jax"]
    who, ikey, rkey, id_sig, hs, ordinary = out["port"]
    # each package opens the other's packets
    for w, pkt, local, key, want in ((wire, out["jax"][4], b_id, ikey,
                                      jwire.MSG_FINDNODE),
                                     (jwire, hs, b_id, ikey, wire.MSG_FINDNODE),
                                     (wire, out["jax"][5], a_id, rkey,
                                      jwire.MSG_PONG)):
        header, ct = w.decode_packet(local, pkt)
        kind, body = w.decode_message(w.open_message(key, header, ct))
        assert kind == want and body[0] == req_id
    src, sig, eph, rec = jwire.parse_handshake_authdata(
        wire.decode_packet(b_id, hs)[0].authdata)
    assert (src, sig, rec) == (a_id, id_sig, record)
    assert jwire.id_verify(jsecp.pubkey(a_priv), sig,
                           wire.decode_packet(a_id, who)[0].challenge_data,
                           eph, b_id)


def _fixed_randomness(monkeypatch, rng_seed):
    """os.urandom and uuid.uuid4 from a numpy stream that restarts at each
    call of the returned reset()."""
    state = {}

    def reset():
        state["rng"] = np.random.default_rng(rng_seed)

    reset()
    monkeypatch.setattr(os, "urandom", lambda n: _bytes(state["rng"], n))
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(bytes=_bytes(state["rng"], 16)))
    return reset


@pytest.mark.parametrize("seed", [0, 1])
def test_keystore_json_and_secret_equal(seed, monkeypatch):
    rng = np.random.default_rng(100 + seed)
    sk = int.from_bytes(_bytes(rng, 32), "big") % jkd.R
    password = _bytes(rng, 12).hex().encode()
    bls.set_backend("python")
    jbls.set_backend("python")
    reset = _fixed_randomness(monkeypatch, seed)
    mine = ks.create_keystore(sk, password)
    reset()
    theirs = jks.create_keystore(sk, password)
    assert json.dumps(mine, sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)
    assert ks.decrypt_keystore(theirs, password) == sk
    assert jks.decrypt_keystore(mine, password) == sk
    assert ks.decrypt_secret(mine["crypto"], password) == \
        jks.decrypt_secret(theirs["crypto"], password)


def test_eip2333_keys_equal():
    rng = np.random.default_rng(7)
    for _ in range(2):
        seed = _bytes(rng, 32)
        assert kd.derive_master_sk(seed) == jkd.derive_master_sk(seed)
        for i in range(4):
            path = f"m/12381/3600/{i}/0/0"
            assert kd.derive_path(seed, path) == jkd.derive_path(seed, path)


@pytest.mark.parametrize("seed", [3, 11])
def test_fault_injector_drop_pattern_equal(seed):
    rng = np.random.default_rng(seed)
    rate = float(rng.uniform(0.1, 0.9))
    ticks = [int(x) for x in rng.integers(0, 3, 60)]
    runs = []
    for mod in (faults, jfaults):
        clock = mod.ScenarioClock()
        inj = mod.FaultInjector(seed, clock)
        inj.set_link("a", "b", mod.LinkPolicy(drop_rate=rate))
        delivered = []
        for i, t in enumerate(ticks):
            got = []
            inj.on_gossip_frame("a", "b", got.append, bytes([i]))
            delivered.append(bool(got))
            clock.advance(t)
            inj.tick()
        runs.append((delivered, inj.frames_dropped))
    assert runs[0] == runs[1]
    assert 0 < runs[0][1] < len(ticks)


def _fields(spec):
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                     else v)
            for f in dataclasses.fields(spec)
            for v in [getattr(spec, f.name)]}


@pytest.mark.parametrize("name", sorted(jnetworks.NETWORKS))
def test_network_spec_fields_equal(name):
    assert sorted(networks.NETWORKS) == sorted(jnetworks.NETWORKS)
    mine, theirs = networks.network_spec(name), jnetworks.network_spec(name)
    assert _fields(mine) == _fields(theirs)
    assert networks.spec_to_config(mine) == jnetworks.spec_to_config(theirs)


def test_monitoring_posts_snapshots_to_a_local_endpoint():
    got = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            got.append((self.path, self.headers["Content-Type"],
                        json.loads(self.rfile.read(n))))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    svc = MonitoringService(f"http://127.0.0.1:{srv.server_port}/push",
                            period=0.05, process_name="validator")
    try:
        assert svc.push_once()
        path, ctype, body = got[0]
        assert path == "/push" and ctype == "application/json"
        assert isinstance(body, list) and len(body) == 1
        assert body[0]["version"] == 1 and body[0]["process"] == "validator"
        assert isinstance(body[0]["timestamp"], int)
        svc.start()
        svc.start()                      # a second start is a no-op
        deadline = time.monotonic() + 10
        while svc.sent < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert svc.sent >= 3 and svc.errors == 0
    finally:
        svc.stop()
        srv.shutdown()
        srv.server_close()
    # an endpoint that refuses counts an error, never raises
    dead = MonitoringService(f"http://127.0.0.1:{srv.server_port}/push")
    assert dead.push_once() is False and dead.errors == 1
