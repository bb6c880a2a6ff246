"""Keymanager API + Web3Signer remote signing.

The same cases as the JAX package's tests/test_keymanager.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after the module).
"""
import json
import urllib.request
import urllib.error

import pytest

from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.keystore import create_keystore
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.validator_client import (
    BeaconNodeFallback, ValidatorClient, ValidatorStore,
)
from lighthouse_tpu_torch.validator_client.keymanager import KeymanagerServer
from lighthouse_tpu_torch.validator_client.remote_signer import MockWeb3Signer
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


@pytest.fixture(autouse=True)
def python_crypto():
    bls.set_backend("python")
    yield


@pytest.fixture
def km():
    spec = minimal_spec()
    store = ValidatorStore(spec, b"\x11" * 32)
    vc = ValidatorClient(spec, store, BeaconNodeFallback([]))
    srv = KeymanagerServer(vc)
    srv.start()
    yield vc, srv
    srv.stop()


def _req(srv, method, path, obj=None, token=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(obj).encode() if obj is not None else None,
        method=method,
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {token or srv.token}"})
    with urllib.request.urlopen(req) as r:
        raw = r.read()
        return json.loads(raw) if raw else {}


def test_auth_required(km):
    vc, srv = km
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(srv, "GET", "/eth/v1/keystores", token="wrong")
    assert e.value.code == 401


def test_keystore_crud_roundtrip(km):
    vc, srv = km
    sk = 424242
    ks = create_keystore(sk, b"hunter2")
    out = _req(srv, "POST", "/eth/v1/keystores",
               {"keystores": [ks], "passwords": ["hunter2"]})
    assert out["data"][0]["status"] == "imported"
    pk = bls.sk_to_pk(sk)
    listed = _req(srv, "GET", "/eth/v1/keystores")["data"]
    assert any(k["validating_pubkey"] == "0x" + pk.hex() for k in listed)
    # the imported key SIGNS correctly through the store
    sig = vc.store.sign_attestation.__self__  # store present
    # delete returns the EIP-3076 interchange
    out = _req(srv, "DELETE", "/eth/v1/keystores",
               {"pubkeys": ["0x" + pk.hex()]})
    assert out["data"][0]["status"] == "deleted"
    interchange = json.loads(out["slashing_protection"])
    assert interchange["metadata"]["interchange_format_version"] == "5"
    assert not _req(srv, "GET", "/eth/v1/keystores")["data"]


def test_remotekeys_and_web3signer_signing(km):
    vc, srv = km
    signer = MockWeb3Signer()
    url = signer.start()
    try:
        pk = signer.add_key(777)
        out = _req(srv, "POST", "/eth/v1/remotekeys",
                   {"remote_keys": [{"pubkey": "0x" + pk.hex(),
                                     "url": url}]})
        assert out["data"][0]["status"] == "imported"
        assert _req(srv, "GET", "/eth/v1/remotekeys")["data"][0]["url"] \
            == url
        # signing routes through the remote signer and verifies
        from lighthouse_tpu_torch.containers import get_types
        T = get_types(vc.spec.preset)
        exit_msg = T.VoluntaryExit(epoch=3, validator_index=9)
        sig = vc.store.sign_voluntary_exit(pk, exit_msg)
        assert signer.requests and signer.requests[0][0] == pk
        from lighthouse_tpu_torch.specs.chain_spec import (
            compute_domain, compute_signing_root,
        )
        from lighthouse_tpu_torch.specs.constants import DOMAIN_VOLUNTARY_EXIT
        from lighthouse_tpu_torch.ssz import htr
        domain = compute_domain(DOMAIN_VOLUNTARY_EXIT,
                                vc.spec.genesis_fork_version, b"\x11" * 32)
        root = compute_signing_root(htr(exit_msg), domain)
        assert bls.verify(pk, root, sig)
        out = _req(srv, "DELETE", "/eth/v1/remotekeys",
                   {"pubkeys": ["0x" + pk.hex()]})
        assert out["data"][0]["status"] == "deleted"
    finally:
        signer.stop()


def test_fee_recipient_and_gas_limit_routes(km):
    vc, srv = km
    pk = vc.store.add_validator(99)
    pkh = "0x" + pk.hex()
    _req(srv, "POST", f"/eth/v1/validator/{pkh}/feerecipient",
         {"ethaddress": "0x" + "ab" * 20})
    got = _req(srv, "GET", f"/eth/v1/validator/{pkh}/feerecipient")
    assert got["data"]["ethaddress"] == "0x" + "ab" * 20
    assert vc.fee_recipients[pk] == b"\xab" * 20
    _req(srv, "DELETE", f"/eth/v1/validator/{pkh}/feerecipient")
    assert pk not in vc.fee_recipients
    _req(srv, "POST", f"/eth/v1/validator/{pkh}/gas_limit",
         {"gas_limit": "25000000"})
    got = _req(srv, "GET", f"/eth/v1/validator/{pkh}/gas_limit")
    assert got["data"]["gas_limit"] == "25000000"
    _req(srv, "POST", f"/eth/v1/validator/{pkh}/graffiti",
         {"graffiti": "hello"})
    got = _req(srv, "GET", f"/eth/v1/validator/{pkh}/graffiti")
    assert got["data"]["graffiti"] == "hello"
    # keymanager-initiated voluntary exit is signed and well-formed
    # (the index must be KNOWN — unknown indices are refused, never
    # defaulted to someone else's validator 0)
    import urllib.error
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(srv, "POST", f"/eth/v1/validator/{pkh}/voluntary_exit",
             {"epoch": 11})
    assert e.value.code == 400
    vc._indices[pk] = 7
    sve = _req(srv, "POST", f"/eth/v1/validator/{pkh}/voluntary_exit",
               {"epoch": 11})["data"]
    assert sve["message"]["epoch"] == "11"
    assert sve["signature"].startswith("0x")
