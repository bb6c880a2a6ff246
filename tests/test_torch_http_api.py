"""HTTP Beacon-API round-trips over a real socket (InteractiveTester style,
http_api/tests/ in the reference).

The same cases as the JAX package's tests/test_http_api.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after the module).
"""
import http.client
import json

import pytest

from lighthouse_tpu_torch.api import ApiBackend, BeaconApiServer
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.ssz import serialize
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


@pytest.fixture
def server():
    bls.set_backend("fake")
    h = BeaconChainHarness(minimal_spec(), 64)
    h.extend_chain(10)
    srv = BeaconApiServer(ApiBackend(h.chain))
    srv.start()
    yield h, srv
    srv.stop()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, body


def test_routes(server):
    h, srv = server
    port = srv.port
    status, body = _get(port, "/eth/v1/beacon/genesis")
    assert status == 200
    data = json.loads(body)["data"]
    assert data["genesis_validators_root"] == \
        "0x" + h.chain.genesis_validators_root.hex()

    status, body = _get(port, "/eth/v1/beacon/states/head/root")
    assert status == 200
    assert json.loads(body)["data"]["root"].startswith("0x")

    status, body = _get(port, "/eth/v1/beacon/states/head/finality_checkpoints")
    assert status == 200

    status, body = _get(port, "/eth/v1/beacon/states/head/validators?id=0&id=1")
    assert status == 200
    vals = json.loads(body)["data"]
    assert len(vals) == 2 and vals[0]["status"] == "active_ongoing"

    status, body = _get(port, "/eth/v1/node/syncing")
    assert json.loads(body)["data"]["is_syncing"] is False

    status, body = _get(port, "/eth/v1/beacon/headers/head")
    hdr = json.loads(body)["data"]
    assert hdr["canonical"] is True
    assert int(hdr["header"]["message"]["slot"]) == 10

    # block ssz download
    status, body = _get(port, "/eth/v2/beacon/blocks/head")
    assert status == 200 and len(body) > 100

    # 404 on unknown
    status, _ = _get(port, "/eth/v1/beacon/headers/0x" + "ab" * 32)
    assert status == 404


def test_sse_events_stream(server):
    """/eth/v1/events: head events arrive over a live SSE connection."""
    import socket
    h, srv = server
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    sock.sendall(b"GET /eth/v1/events?topics=head HTTP/1.1\r\n"
                 b"Host: localhost\r\nAccept: text/event-stream\r\n\r\n")
    # read headers
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += sock.recv(1024)
    assert b"200" in buf.split(b"\r\n")[0]
    assert b"text/event-stream" in buf
    # trigger a head event
    h.advance_slot()
    signed, _ = h.produce_signed_block()
    h.chain.process_block(signed)
    sock.settimeout(10)
    data = buf.split(b"\r\n\r\n", 1)[1]
    while b"event: head" not in data:
        data += sock.recv(4096)
    assert b"data: " in data
    sock.close()


def test_publish_block_roundtrip(server):
    h, srv = server
    h.advance_slot()
    signed, _post = h.produce_signed_block()
    raw = serialize(type(signed).ssz_type, signed)
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    conn.request("POST", "/eth/v1/beacon/blocks", body=raw,
                 headers={"Content-Type": "application/octet-stream"})
    r = conn.getresponse()
    assert r.status == 200, r.read()
    r.read()
    conn.close()
    assert h.chain.head().head_state.slot == 11
    # duplicate returns 200 (idempotent), bad block 400
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    conn.request("POST", "/eth/v1/beacon/blocks", body=raw[:-10] + b"\x00" * 10)
    r = conn.getresponse()
    assert r.status == 400
    r.read()
    conn.close()
