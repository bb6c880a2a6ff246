"""Round-trip tests for the HTTP API semantics.

Broadcast-validation modes on publish
(http_api/src/publish_blocks.rs:1-60 + broadcast_validation_tests.rs),
fork-versioned response headers, and SSZ accept negotiation — exercised
over a real HTTP server like the reference's InteractiveTester.

The same cases as the JAX package's tests/test_api_semantics.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after the module).
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

from lighthouse_tpu_torch.api import BeaconApiServer
from lighthouse_tpu_torch.api.backend import ApiBackend
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


@pytest.fixture(autouse=True)
def fake_bls():
    bls.set_backend("fake")
    yield
    bls.set_backend("python")


@pytest.fixture()
def api():
    h = BeaconChainHarness(minimal_spec(), 64)
    h.extend_chain(3, attest=False)
    srv = BeaconApiServer(ApiBackend(h.chain))
    srv.start()
    yield h, srv
    srv.stop()


def _get(srv, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 headers=headers or {})
    return urllib.request.urlopen(req)


def _post(srv, path, body: bytes, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=body,
        headers=headers or {}, method="POST")
    return urllib.request.urlopen(req)


def _signed_next_block(h):
    h.advance_slot()
    signed, _post_state = h.produce_signed_block()
    return signed


# ---------------------------------------------------------------------------
# broadcast validation
# ---------------------------------------------------------------------------

def test_publish_gossip_mode_accepts_valid_block(api):
    h, srv = api
    signed = _signed_next_block(h)
    body = serialize(type(signed).ssz_type, signed)
    r = _post(srv, "/eth/v1/beacon/blocks", body)
    assert r.status == 200
    assert h.chain.head().head_state.slot == signed.message.slot


def test_publish_consensus_mode_round_trip(api):
    h, srv = api
    signed = _signed_next_block(h)
    body = serialize(type(signed).ssz_type, signed)
    r = _post(srv, "/eth/v2/beacon/blocks?broadcast_validation=consensus",
              body)
    assert r.status == 200


def test_publish_rejects_gossip_invalid_block_with_400(api):
    h, srv = api
    signed = _signed_next_block(h)
    # wrong proposer index breaks gossip verification
    signed.message.proposer_index = (signed.message.proposer_index + 1) % 64
    body = serialize(type(signed).ssz_type, signed)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "/eth/v1/beacon/blocks", body)
    assert e.value.code == 400


def test_publish_consensus_rejects_state_invalid_with_400(api):
    h, srv = api
    signed = _signed_next_block(h)
    # gossip-passable but consensus-invalid: corrupt the state root
    signed.message.state_root = b"\x13" * 32
    body = serialize(type(signed).ssz_type, signed)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv,
              "/eth/v2/beacon/blocks?broadcast_validation=consensus", body)
    assert e.value.code == 400
    # NOT imported
    assert h.chain.head().head_state.slot < signed.message.slot


def test_publish_gossip_mode_broadcasts_then_202_on_import_failure(api):
    """gossip mode: the block is broadcast once gossip checks pass even
    if full import then fails (202 per the Beacon API spec)."""
    h, srv = api
    backend = srv.backend
    published = []
    backend.publish_fn = published.append
    signed = _signed_next_block(h)
    signed.message.state_root = b"\x13" * 32   # passes gossip, fails STF
    # signature is over the modified block for the fake backend
    body = serialize(type(signed).ssz_type, signed)
    r = _post(srv, "/eth/v1/beacon/blocks", body)
    assert r.status == 202
    assert published, "gossip mode must broadcast before full import"


def test_publish_consensus_mode_does_not_broadcast_invalid(api):
    h, srv = api
    backend = srv.backend
    published = []
    backend.publish_fn = published.append
    signed = _signed_next_block(h)
    signed.message.state_root = b"\x13" * 32
    body = serialize(type(signed).ssz_type, signed)
    with pytest.raises(urllib.error.HTTPError):
        _post(srv,
              "/eth/v2/beacon/blocks?broadcast_validation=consensus", body)
    assert not published


def test_publish_unknown_validation_level_400(api):
    h, srv = api
    signed = _signed_next_block(h)
    body = serialize(type(signed).ssz_type, signed)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "/eth/v1/beacon/blocks?broadcast_validation=bogus", body)
    assert e.value.code == 400


def test_publish_with_consensus_version_header(api):
    """SSZ POSTs carry Eth-Consensus-Version; the server decodes with
    that fork."""
    h, srv = api
    signed = _signed_next_block(h)
    version = type(signed).fork_name.name.lower()
    body = serialize(type(signed).ssz_type, signed)
    r = _post(srv, "/eth/v1/beacon/blocks", body,
              headers={"Eth-Consensus-Version": version})
    assert r.status == 200
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "/eth/v1/beacon/blocks", b"\x00" * 8,
              headers={"Eth-Consensus-Version": "notafork"})
    assert e.value.code == 400


# ---------------------------------------------------------------------------
# fork-versioned headers + SSZ negotiation
# ---------------------------------------------------------------------------

def test_block_endpoints_carry_version_headers(api):
    h, srv = api
    for path in ("/eth/v2/beacon/blocks/head",
                 "/eth/v1/beacon/blinded_blocks/head",
                 "/eth/v2/beacon/blocks/head/attestations"):
        with _get(srv, path) as r:
            env = json.loads(r.read())
            assert r.headers.get("Eth-Consensus-Version") == env["version"]
            assert "finalized" in env and "execution_optimistic" in env


def test_ssz_negotiation_on_debug_state(api):
    h, srv = api
    with _get(srv, "/lighthouse/beacon/states/head/ssz",
              headers={"Accept": "application/octet-stream"}) as r:
        raw = r.read()
        assert r.headers.get("Content-Type") == "application/octet-stream"
        assert r.headers.get("Eth-Consensus-Version")
    assert raw == srv.backend.debug_state_ssz("head")


def test_produce_block_v2_negotiates_json_and_ssz(api):
    h, srv = api
    h.advance_slot()
    slot = h.chain.slot()
    # deterministic randao for the fake backend
    reveal = "0x" + ("00" * 96)
    path = f"/eth/v2/validator/blocks/{slot}?randao_reveal={reveal}"
    with _get(srv, path) as r:
        env = json.loads(r.read())
        # data is the UNSIGNED BeaconBlock (v2 produce)
        assert env["data"]["slot"] == str(slot)
        assert r.headers.get("Eth-Consensus-Version") == env["version"]
    with _get(srv, path,
              headers={"Accept": "application/octet-stream"}) as r:
        assert r.headers.get("Content-Type") == "application/octet-stream"
        assert len(r.read()) > 100


# ---------------------------------------------------------------------------
# new route families round-trip
# ---------------------------------------------------------------------------

def test_light_client_bootstrap_route(api):
    h, srv = api
    root = h.chain.head().head_block_root.hex()
    try:
        with _get(srv, f"/eth/v1/beacon/light_client/bootstrap/0x{root}") \
                as r:
            body = json.loads(r.read())
            assert "data" in body
    except urllib.error.HTTPError as e:
        # pre-altair chains legitimately have no bootstrap
        assert e.code in (404, 400)


def test_pool_bls_changes_get_route(api):
    h, srv = api
    with _get(srv, "/eth/v1/beacon/pool/bls_to_execution_changes") as r:
        assert json.loads(r.read())["data"] == []


def test_lighthouse_liveness_post(api):
    h, srv = api
    body = json.dumps({"epoch": "0", "indices": ["0", "1"]}).encode()
    with _post(srv, "/lighthouse/liveness", body) as r:
        data = json.loads(r.read())["data"]
        assert len(data) == 2
        assert data[0]["index"] == "0" and "is_live" in data[0]


def test_validator_inclusion_per_validator():
    # participation flags need altair+
    h = BeaconChainHarness(minimal_spec(altair_fork_epoch=0), 64)
    spe = h.chain.spec.preset.slots_per_epoch
    h.extend_chain(spe + 2)
    srv = BeaconApiServer(ApiBackend(h.chain))
    srv.start()
    with _get(srv, "/lighthouse/validator_inclusion/1/0") as r:
        data = json.loads(r.read())["data"]
        assert "is_previous_epoch_target_attester" in data
        assert "current_epoch_effective_balance_gwei" in data
    srv.stop()


def test_pending_queues_routes(api):
    h, srv = api
    for kind in ("pending_consolidations", "pending_partial_withdrawals"):
        with _get(srv, f"/eth/v1/beacon/states/head/{kind}") as r:
            assert json.loads(r.read())["data"] == []


# ---------------------------------------------------------------------------
# v2 attester-slashing variants (electra payloads)
# ---------------------------------------------------------------------------

def test_pool_attester_slashings_v2_versioned(api):
    h, srv = api
    want = h.chain.spec.fork_name_at_slot(h.chain.slot()).name.lower()
    r = _get(srv, "/eth/v2/beacon/pool/attester_slashings")
    assert r.headers.get("Eth-Consensus-Version") == want
    out = json.loads(r.read())
    assert out["version"] == want and out["data"] == []
    # v1 stays unversioned (no header, bare data)
    r1 = _get(srv, "/eth/v1/beacon/pool/attester_slashings")
    assert r1.headers.get("Eth-Consensus-Version") is None


def test_pool_attester_slashings_v2_post_decodes_per_version(api):
    """POST v2 picks the payload TYPE from Eth-Consensus-Version: an
    electra-typed body must decode with the electra container (larger
    committee-wide index lists) and then fail VERIFICATION (not
    decoding) on this altair chain; the same bytes without the header
    decode as the altair type and fail differently or identically —
    either way no 5xx and no decode crash."""
    import random
    from lighthouse_tpu_torch.testing.fuzz import arbitrary
    h, srv = api
    T = h.chain.T
    rng = random.Random(5)
    sl = arbitrary(T.AttesterSlashingElectra.ssz_type, rng)
    body = serialize(T.AttesterSlashingElectra.ssz_type, sl)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "/eth/v2/beacon/pool/attester_slashings", body,
              {"Eth-Consensus-Version": "electra"})
    assert e.value.code == 400
    # the 400 must come from VERIFICATION (submit_pool_op's "invalid
    # <kind>" ApiError), proving the electra-typed DECODE succeeded —
    # a decode failure would 400 with a different message
    assert b"invalid attester_slashings" in e.value.read()
    # unknown version header -> clean 400
    with pytest.raises(urllib.error.HTTPError) as e2:
        _post(srv, "/eth/v2/beacon/pool/attester_slashings", body,
              {"Eth-Consensus-Version": "banana"})
    assert e2.value.code == 400
