"""UPnP-IGD port mapping (network/src/nat.rs analog) against a local
fake gateway, and persisted-DHT restart (persisted_dht.rs analog).

The same cases as the JAX package's tests/test_nat.py, run on the port
(imports switched to lighthouse_tpu_torch)."""
from __future__ import annotations

import socket
import threading

from lighthouse_tpu_torch.network import nat
from lighthouse_tpu_torch.network.discv5 import Discv5
from lighthouse_tpu_torch.network.persisted_dht import (
    clear_dht, load_dht, persist_dht,
)

DESCRIPTION_XML = b"""<?xml version="1.0"?>
<root xmlns="urn:schemas-upnp-org:device-1-0">
 <device>
  <deviceType>urn:schemas-upnp-org:device:InternetGatewayDevice:1</deviceType>
  <serviceList>
   <service>
    <serviceType>urn:schemas-upnp-org:service:Layer3Forwarding:1</serviceType>
    <controlURL>/l3f</controlURL>
   </service>
  </serviceList>
  <deviceList><device><deviceList><device>
   <serviceList>
    <service>
     <serviceType>urn:schemas-upnp-org:service:WANIPConnection:1</serviceType>
     <controlURL>/ctl/wanip</controlURL>
    </service>
   </serviceList>
  </device></deviceList></device></deviceList>
 </device>
</root>"""

SOAP_OK = (b"<?xml version=\"1.0\"?><s:Envelope><s:Body>"
           b"<u:AddPortMappingResponse "
           b"xmlns:u=\"urn:schemas-upnp-org:service:WANIPConnection:1\"/>"
           b"</s:Body></s:Envelope>")


class FakeGateway:
    """Minimal IGD: serves the device description and AddPortMapping."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.mappings = []
        self._stop = False
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    @property
    def location(self):
        return f"http://127.0.0.1:{self.port}/rootDesc.xml"

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            try:
                req = b""
                conn.settimeout(2)
                while b"\r\n\r\n" not in req:
                    req += conn.recv(65536)
                head, _, body = req.partition(b"\r\n\r\n")
                clen = 0
                for line in head.split(b"\r\n"):
                    if line.lower().startswith(b"content-length:"):
                        clen = int(line.split(b":")[1])
                while len(body) < clen:
                    body += conn.recv(65536)
                if head.startswith(b"GET /rootDesc.xml"):
                    payload = DESCRIPTION_XML
                elif head.startswith(b"POST /ctl/wanip") and \
                        b"AddPortMapping" in body:
                    import re
                    port = int(re.search(rb"<NewExternalPort>(\d+)<",
                                         body).group(1))
                    proto = re.search(rb"<NewProtocol>(\w+)<",
                                      body).group(1).decode()
                    self.mappings.append((proto, port))
                    payload = SOAP_OK
                else:
                    payload = b""
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: "
                             + str(len(payload)).encode()
                             + b"\r\nConnection: close\r\n\r\n" + payload)
            except OSError:
                pass
            finally:
                conn.close()

    def stop(self):
        self._stop = True
        self.sock.close()
        self.thread.join(timeout=2)


def test_msearch_and_ssdp_parse():
    m = nat.build_msearch()
    assert m.startswith(b"M-SEARCH * HTTP/1.1\r\n")
    assert b'MAN: "ssdp:discover"' in m
    resp = (b"HTTP/1.1 200 OK\r\nST: upnp:rootdevice\r\n"
            b"LOCATION: http://192.168.1.1:5000/rootDesc.xml\r\n\r\n")
    assert nat.parse_ssdp_response(resp) == \
        "http://192.168.1.1:5000/rootDesc.xml"
    assert nat.parse_ssdp_response(b"HTTP/1.1 404 NF\r\n\r\n") is None
    assert nat.parse_ssdp_response(b"junk") is None


def test_control_url_extraction():
    found = nat.parse_control_url(DESCRIPTION_XML,
                                  "http://10.0.0.1:80/rootDesc.xml")
    assert found == ("http://10.0.0.1:80/ctl/wanip",
                     "urn:schemas-upnp-org:service:WANIPConnection:1")
    assert nat.parse_control_url(b"<root/>", "http://x/") is None


def test_establish_mappings_against_fake_gateway():
    gw = FakeGateway()
    try:
        out = nat.establish_mappings(
            9000, 9001, discover=lambda *a, **k: gw.location)
        assert out.ok, out.error
        assert ("TCP", 9000) in out.mapped and ("UDP", 9001) in out.mapped
        assert sorted(gw.mappings) == [("TCP", 9000), ("UDP", 9001)]
        assert out.service_type.endswith("WANIPConnection:1")
    finally:
        gw.stop()


def test_establish_mappings_no_gateway_is_advisory():
    out = nat.establish_mappings(9000, None,
                                 discover=lambda *a, **k: None)
    assert out.attempted and not out.ok
    assert "no UPnP gateway" in out.error


class DictStore:
    def __init__(self):
        self.d = {}

    def put_item(self, k, v):
        self.d[k] = v

    def get_item(self, k):
        return self.d.get(k)


def test_persisted_dht_roundtrip_and_tamper():
    a = Discv5()
    b = Discv5()
    try:
        a.table.update(b.local_enr.record)
        store = DictStore()
        assert persist_dht(store, a.table.all()) == 1
        loaded = load_dht(store)
        assert [e.node_id for e in loaded] == [b.local_enr.node_id]
        # tampered record bytes are dropped, not imported
        raw = bytearray(store.d[b"dht_enrs"])
        raw[-1] ^= 0xFF
        store.put_item(b"dht_enrs", bytes(raw))
        assert load_dht(store) == []
        clear_dht(store)
        assert load_dht(store) == []
    finally:
        a.stop()
        b.stop()


def test_restart_reconnects_from_persisted_table_without_bootnodes():
    """THE done-criterion (persisted_dht.rs): after a restart with NO
    bootnodes, the node reaches its old peers from the stored table."""
    peer = Discv5()
    peer.start()
    store = DictStore()
    first = Discv5()
    try:
        first.start()
        first.table.update(peer.local_enr.record)
        assert first.ping(peer.local_enr.record)
        persist_dht(store, first.table.all())
    finally:
        first.stop()

    reborn = Discv5()                  # NO bootnodes configured
    try:
        reborn.start()
        assert len(reborn.table) == 0
        for e in load_dht(store):
            reborn.table.update(e)
        assert len(reborn.table) == 1
        # live contact re-established purely from the persisted table
        target = reborn.table.all()[0]
        assert reborn.ping(target)
        found = reborn.find_node(target, [0])
        assert any(e.node_id == peer.local_enr.node_id for e in found)
    finally:
        reborn.stop()
        peer.stop()
