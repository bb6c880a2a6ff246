"""UPnP-IGD port mapping (NAT traversal attempt).

Equivalent of beacon_node/network/src/nat.rs (which uses the `igd` crate):
best-effort establishment of external TCP/UDP port mappings on the local
internet gateway so inbound libp2p/discv5 traffic reaches a node behind a
home NAT.  The full protocol is implemented — SSDP M-SEARCH discovery,
device-description fetch, WANIPConnection/WANPPPConnection control-URL
extraction, and the AddPortMapping SOAP action — with the socket/HTTP
edges injectable so the byte-level behavior is testable against a local
fake gateway (tests/test_torch_nat.py); on a real network the defaults talk to
239.255.255.250:1900 like any UPnP client.

Failures are reported, never raised: NAT mapping is advisory
(nat.rs logs and continues).
"""
from __future__ import annotations

import re
import socket
from dataclasses import dataclass, field
from urllib.parse import urljoin, urlparse

SSDP_ADDR = ("239.255.255.250", 1900)
SSDP_ST = "urn:schemas-upnp-org:device:InternetGatewayDevice:1"
SERVICE_TYPES = (
    "urn:schemas-upnp-org:service:WANIPConnection:1",
    "urn:schemas-upnp-org:service:WANPPPConnection:1",
)


@dataclass
class NatOutcome:
    attempted: bool = False
    gateway_location: str | None = None
    control_url: str | None = None
    service_type: str | None = None
    mapped: list = field(default_factory=list)   # (proto, ext_port)
    error: str | None = None

    @property
    def ok(self) -> bool:
        return bool(self.mapped) and self.error is None


def build_msearch() -> bytes:
    return ("M-SEARCH * HTTP/1.1\r\n"
            f"HOST: {SSDP_ADDR[0]}:{SSDP_ADDR[1]}\r\n"
            'MAN: "ssdp:discover"\r\n'
            "MX: 2\r\n"
            f"ST: {SSDP_ST}\r\n"
            "\r\n").encode()


def parse_ssdp_response(data: bytes) -> str | None:
    """LOCATION header of an SSDP HTTP/1.1 200 response."""
    try:
        text = data.decode("latin-1")
    except Exception:
        return None
    if not text.upper().startswith("HTTP/1.1 200"):
        return None
    for line in text.split("\r\n")[1:]:
        k, _, v = line.partition(":")
        if k.strip().upper() == "LOCATION":
            return v.strip()
    return None


def ssdp_discover(timeout: float = 2.0, addr=SSDP_ADDR) -> str | None:
    """Multicast M-SEARCH; first well-formed LOCATION wins."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.settimeout(timeout)
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 2)
        sock.sendto(build_msearch(), addr)
        while True:
            try:
                data, _src = sock.recvfrom(4096)
            except (socket.timeout, OSError):
                return None
            loc = parse_ssdp_response(data)
            if loc:
                return loc
    finally:
        sock.close()


def _http(method: str, url: str, body: bytes = b"",
          headers: dict | None = None, timeout: float = 3.0) -> bytes:
    """Tiny dependency-free HTTP/1.1 one-shot."""
    u = urlparse(url)
    host, port = u.hostname, u.port or 80
    path = u.path or "/"
    if u.query:
        path += "?" + u.query
    lines = [f"{method} {path} HTTP/1.1", f"Host: {host}:{port}",
             "Connection: close", f"Content-Length: {len(body)}"]
    for k, v in (headers or {}).items():
        lines.append(f"{k}: {v}")
    req = ("\r\n".join(lines) + "\r\n\r\n").encode() + body
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(req)
        chunks = []
        while True:
            c = s.recv(65536)
            if not c:
                break
            chunks.append(c)
    resp = b"".join(chunks)
    head, _, payload = resp.partition(b"\r\n\r\n")
    return payload


def parse_control_url(xml: bytes, base_url: str
                      ) -> tuple[str, str] | None:
    """(control_url, service_type) for the WAN*Connection service."""
    text = xml.decode("utf-8", "replace")
    for st in SERVICE_TYPES:
        # the <service> block containing this serviceType
        for m in re.finditer(r"<service>(.*?)</service>", text,
                             re.S | re.I):
            block = m.group(1)
            if st not in block:
                continue
            cu = re.search(r"<controlURL>(.*?)</controlURL>", block,
                           re.S | re.I)
            if cu:
                return urljoin(base_url, cu.group(1).strip()), st
    return None


def build_soap_add_mapping(service_type: str, ext_port: int,
                           proto: str, int_port: int, int_ip: str,
                           description: str, lease: int = 0) -> bytes:
    return (f"""<?xml version="1.0"?>
<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"
 s:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">
 <s:Body>
  <u:AddPortMapping xmlns:u="{service_type}">
   <NewRemoteHost></NewRemoteHost>
   <NewExternalPort>{ext_port}</NewExternalPort>
   <NewProtocol>{proto}</NewProtocol>
   <NewInternalPort>{int_port}</NewInternalPort>
   <NewInternalClient>{int_ip}</NewInternalClient>
   <NewEnabled>1</NewEnabled>
   <NewPortMappingDescription>{description}</NewPortMappingDescription>
   <NewLeaseDuration>{lease}</NewLeaseDuration>
  </u:AddPortMapping>
 </s:Body>
</s:Envelope>""").encode()


def add_port_mapping(control_url: str, service_type: str, ext_port: int,
                     proto: str, int_port: int, int_ip: str,
                     description: str = "lighthouse_tpu",
                     http=_http) -> bool:
    body = build_soap_add_mapping(service_type, ext_port, proto,
                                  int_port, int_ip, description)
    headers = {
        "Content-Type": 'text/xml; charset="utf-8"',
        "SOAPAction": f'"{service_type}#AddPortMapping"',
    }
    try:
        resp = http("POST", control_url, body, headers)
    except OSError:
        return False
    return b"AddPortMappingResponse" in resp


def local_ip_towards(gateway_url: str) -> str:
    """The local interface address used to reach the gateway."""
    u = urlparse(gateway_url)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((u.hostname, u.port or 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def establish_mappings(tcp_port: int | None, udp_port: int | None,
                       discover=ssdp_discover, http=_http) -> NatOutcome:
    """The nat.rs entry point: try to map the libp2p TCP and discv5 UDP
    ports on the gateway; advisory (never raises)."""
    out = NatOutcome(attempted=True)
    try:
        loc = discover()
        if loc is None:
            out.error = "no UPnP gateway responded"
            return out
        out.gateway_location = loc
        desc = http("GET", loc)
        found = parse_control_url(desc, loc)
        if found is None:
            out.error = "gateway exposes no WAN*Connection service"
            return out
        out.control_url, out.service_type = found
        int_ip = local_ip_towards(out.control_url)
        for proto, port in (("TCP", tcp_port), ("UDP", udp_port)):
            if port and add_port_mapping(out.control_url,
                                         out.service_type, port, proto,
                                         port, int_ip, http=http):
                out.mapped.append((proto, port))
        if not out.mapped:
            out.error = "gateway refused all mappings"
    except Exception as e:               # advisory: report, never raise
        out.error = repr(e)[:200]
    return out
