"""BeaconNodeHttpClient bounded retry discipline against a flaky server.

A raw TCP stub (no HTTP framework) closes the first N accepted
connections before writing a byte — the classic mid-restart BN — then
serves real responses.  The client must absorb exactly N connection
failures, succeed, and account for them; an HTTP 4xx must never be
retried (the BN heard us and said no).

The same cases as the JAX package's tests/test_http_retry.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after the module).
"""
import socket
import threading

import pytest

from lighthouse_tpu_torch.api.metrics import counter_value
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.validator_client.http_client import (
    BeaconNodeHttpClient, HttpApiError,
)
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)

OK_RESPONSE = (b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
               b"Content-Length: 2\r\nConnection: close\r\n\r\n{}")
BAD_RESPONSE = (b"HTTP/1.1 400 Bad Request\r\nContent-Type: text/plain\r\n"
                b"Content-Length: 3\r\nConnection: close\r\n\r\nnope")


class FlakyServer:
    """Closes the first `failures` connections unanswered, then serves
    `response` to every later one."""

    def __init__(self, failures: int, response: bytes = OK_RESPONSE):
        self.failures = failures
        self.response = response
        self.accepted = 0
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(8)
        self.port = self.listener.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while True:
            try:
                sock, _ = self.listener.accept()
            except OSError:
                return
            self.accepted += 1
            if self.accepted <= self.failures:
                # RST instead of FIN so the client sees a hard reset
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                b"\x01\x00\x00\x00\x00\x00\x00\x00")
                sock.close()
                continue
            try:
                sock.settimeout(5)
                sock.recv(65536)                 # drain the request
                sock.sendall(self.response)
            except OSError:
                pass
            finally:
                sock.close()

    def close(self):
        self.listener.close()
        self._thread.join(timeout=2)


def _client(port: int, retries: int) -> BeaconNodeHttpClient:
    return BeaconNodeHttpClient(f"http://127.0.0.1:{port}",
                                minimal_spec(), timeout=5,
                                retries=retries, backoff=0.01)


def test_transient_connection_failures_are_retried_and_counted():
    srv = FlakyServer(failures=2)
    try:
        client = _client(srv.port, retries=2)
        metric_before = counter_value("vc_http_retries_total")
        assert client.is_healthy()
        assert client.retry_count == 2
        assert srv.accepted == 3
        assert counter_value("vc_http_retries_total") == metric_before + 2
    finally:
        srv.close()


def test_retry_budget_is_bounded():
    srv = FlakyServer(failures=100)
    try:
        client = _client(srv.port, retries=1)
        with pytest.raises(OSError):
            client._req("GET", "/eth/v1/node/health")
        assert client.retry_count == 1           # retries=1 -> 2 attempts
        assert srv.accepted == 2
    finally:
        srv.close()


def test_http_4xx_is_never_retried():
    srv = FlakyServer(failures=0, response=BAD_RESPONSE)
    try:
        client = _client(srv.port, retries=3)
        with pytest.raises(HttpApiError) as e:
            client._req("GET", "/eth/v1/node/health")
        assert e.value.status == 400
        assert client.retry_count == 0
        assert srv.accepted == 1
    finally:
        srv.close()
