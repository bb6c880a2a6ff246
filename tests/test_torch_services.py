"""Engine-API tests: JWT tokens, the JSON-RPC client against the mock engine.

The engine-API cases of the JAX package's tests/test_services.py, run on
the port (imports switched to lighthouse_tpu_torch).
"""
import pytest

from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.execution_layer import (
    EngineApiClient, EngineState, Engines, ExecutionLayer, JwtAuth,
    MockEngineServer,
)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU; its BLS backend put back after each test."""
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


def test_jwt_roundtrip():
    auth = JwtAuth(b"\x11" * 32)
    tok = auth.generate_token()
    assert auth.validate(tok)
    assert not auth.validate(tok[:-2] + "zz")
    assert not JwtAuth(b"\x22" * 32).validate(tok)


def test_engine_api_against_mock_server():
    secret = b"\x42" * 32
    srv = MockEngineServer(secret)
    srv.start()
    try:
        client = EngineApiClient("127.0.0.1", srv.port, JwtAuth(secret))
        caps = client.exchange_capabilities()
        assert "engine_newPayloadV3" in caps
        engines = Engines(client)
        assert engines.upcheck() == EngineState.ONLINE
        # forkchoice + invalidation scripting
        el = ExecutionLayer(client)
        status, _pid = el.notify_forkchoice_updated(b"\xaa" * 32,
                                                    b"\x00" * 32,
                                                    b"\x00" * 32)
        assert status == "valid"
        srv.invalid_hashes.add("0x" + "bb" * 32)
        status, _ = el.notify_forkchoice_updated(b"\xbb" * 32, b"\x00" * 32,
                                                 b"\x00" * 32)
        assert status == "invalid"
        srv.static_response = "SYNCING"
        status, _ = el.notify_forkchoice_updated(b"\xaa" * 32, b"\x00" * 32,
                                                 b"\x00" * 32)
        assert status == "optimistic"
        # wrong JWT is rejected
        bad = EngineApiClient("127.0.0.1", srv.port, JwtAuth(b"\x43" * 32))
        from lighthouse_tpu_torch.execution_layer import EngineError
        with pytest.raises(EngineError):
            bad.exchange_capabilities()
    finally:
        srv.stop()
