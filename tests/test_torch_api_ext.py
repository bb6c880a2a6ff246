"""Expanded HTTP API surface: route inventory >= 100
and a live exercise of each new route group over real HTTP.

The same cases as the JAX package's tests/test_api_ext.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after the module).
"""
import json
import urllib.request

import pytest

from lighthouse_tpu_torch.api import BeaconApiServer
from lighthouse_tpu_torch.api.backend import ApiBackend
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


@pytest.fixture(autouse=True)
def fake_crypto():
    bls.set_backend("fake")
    yield


@pytest.fixture(scope="module")
def api():
    bls.set_backend("fake")
    spec = minimal_spec(altair_fork_epoch=0)
    h = BeaconChainHarness(spec, 32)
    h.extend_chain(4 * spec.preset.slots_per_epoch + 1)
    srv = BeaconApiServer(ApiBackend(h.chain))
    srv.start()
    yield h, srv
    srv.stop()


def _get(srv, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}{path}") as r:
        return json.loads(r.read())


def _post(srv, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read() or b"{}")


def test_route_inventory_over_100():
    from lighthouse_tpu_torch.api import http_server as hs
    keymanager_methods = 16   # keymanager.py docstring surface
    total = len(hs.build_get_routes(None)) + len(hs.POST_ROUTES) \
        + keymanager_methods + 2   # SSE events + prometheus metrics
    assert total >= 100, total


def test_beacon_block_and_state_views(api):
    h, srv = api
    root = _get(srv, "/eth/v1/beacon/blocks/head/root")["data"]["root"]
    assert root == "0x" + h.chain.head().head_block_root.hex()
    atts = _get(srv, "/eth/v1/beacon/blocks/head/attestations")["data"]
    assert isinstance(atts, list)
    bals = _get(srv, "/eth/v1/beacon/states/head/validator_balances"
                     "?id=0&id=1")["data"]
    assert len(bals) == 2 and int(bals[0]["balance"]) > 0
    com = _get(srv, "/eth/v1/beacon/states/head/committees")["data"]
    assert com and com[0]["validators"]
    sc = _get(srv, "/eth/v1/beacon/states/head/sync_committees")["data"]
    assert len(sc["validators"]) == h.spec.preset.sync_committee_size
    rnd = _get(srv, "/eth/v1/beacon/states/head/randao")["data"]
    assert rnd["randao"].startswith("0x")
    one = _get(srv, "/eth/v1/beacon/states/head/validators/0")["data"]
    assert one["index"] == "0"
    hdrs = _get(srv, "/eth/v1/beacon/headers")["data"]
    assert hdrs and hdrs[0]["root"] == root


def test_pool_routes(api):
    h, srv = api
    for kind in ("attester_slashings", "proposer_slashings",
                 "voluntary_exits", "bls_to_execution_changes"):
        out = _get(srv, f"/eth/v1/beacon/pool/{kind}")["data"]
        assert isinstance(out, list)
    atts = _get(srv, "/eth/v1/beacon/pool/attestations")["data"]
    assert isinstance(atts, list)


def test_rewards_routes(api):
    h, srv = api
    br = _get(srv, "/eth/v1/beacon/rewards/blocks/head")["data"]
    assert "proposer_index" in br
    ar = _post(srv, "/eth/v1/beacon/rewards/attestations/1", [0, 1])
    assert "total_rewards" in ar["data"]
    sr = _post(srv, "/eth/v1/beacon/rewards/sync_committee/head", [])
    assert isinstance(sr["data"], list)


def test_light_client_routes(api):
    h, srv = api
    fu = _get(srv, "/eth/v1/beacon/light_client/finality_update")
    assert "attested_slot" in fu["data"]
    ou = _get(srv, "/eth/v1/beacon/light_client/optimistic_update")
    assert "attested_slot" in ou["data"]


def test_config_node_debug_routes(api):
    h, srv = api
    spec_out = _get(srv, "/eth/v1/config/spec")["data"]
    assert spec_out["SLOTS_PER_EPOCH"] == str(h.spec.preset.slots_per_epoch)
    fs = _get(srv, "/eth/v1/config/fork_schedule")["data"]
    assert any(f["epoch"] == "0" for f in fs)
    _get(srv, "/eth/v1/config/deposit_contract")
    ident = _get(srv, "/eth/v1/node/identity")["data"]
    assert "peer_id" in ident
    _get(srv, "/eth/v1/node/peer_count")
    heads = _get(srv, "/eth/v1/debug/beacon/heads")["data"]
    assert heads
    fc = _get(srv, "/eth/v1/debug/fork_choice")
    assert fc["fork_choice_nodes"]
    st = _get(srv, "/eth/v2/debug/beacon/states/head")["data"]["ssz"]
    assert len(st) > 1000
    _get(srv, "/lighthouse/database/info")
    _get(srv, "/lighthouse/proto_array")
    assert _get(srv, "/lighthouse/staking")["data"] is True


def test_electra_pending_queues(api):
    h, srv = api
    out = _get(srv, "/eth/v1/beacon/states/head/pending_deposits")["data"]
    assert out == []    # altair state: empty, not an error


def test_block_retrieval_and_withdrawals_routes(api):
    """v2 full-block retrieval, expected withdrawals, validator
    identities, v2 production, electra v2 pool aliases."""
    h, srv = api
    from lighthouse_tpu_torch.ssz import deserialize
    # v2 negotiates: JSON by default (with the fork-versioned header),
    # raw SSZ under Accept: application/octet-stream (checkpoint sync)
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/eth/v2/beacon/blocks/head",
        headers={"Accept": "application/octet-stream"})
    with urllib.request.urlopen(req) as r:
        raw = r.read()
        assert r.headers.get("Content-Type") == "application/octet-stream"
        assert r.headers.get("Eth-Consensus-Version")
    fork = h.chain.spec.fork_name_at_slot(h.chain.slot())
    cls = h.chain.T.SignedBeaconBlock[fork]
    signed = deserialize(cls.ssz_type, raw)
    assert signed.message.slot == h.chain.head().head_state.slot
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/eth/v2/beacon/blocks/head") as r:
        env = json.loads(r.read())
        assert r.headers.get("Eth-Consensus-Version") == env["version"]
    assert env["data"]["message"]["slot"] ==         str(h.chain.head().head_state.slot)
    assert env["finalized"] in (True, False)
    # identities + POST validator filters
    ids = _get(srv, "/eth/v1/beacon/states/head/validator_identities"
                    "?id=0&id=1")["data"]
    assert len(ids) == 2 and ids[0]["index"] == "0"
    vals = _post(srv, "/eth/v1/beacon/states/head/validators",
                 {"ids": ["0", "3"]})["data"]
    assert len(vals) == 2
    bals = _post(srv, "/eth/v1/beacon/states/head/validator_balances",
                 ["1", "2"])["data"]
    assert len(bals) == 2
    # debug heads v2 + electra pool aliases respond
    assert _get(srv, "/eth/v2/debug/beacon/heads")["data"]
    _get(srv, "/eth/v2/beacon/pool/attester_slashings")
    _get(srv, "/eth/v2/beacon/pool/attestations")


def test_expected_withdrawals_route():
    """Withdrawals need a capella+ chain."""
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                        capella_fork_epoch=0)
    h = BeaconChainHarness(spec, 32)
    h.extend_chain(3)
    srv = BeaconApiServer(ApiBackend(h.chain))
    srv.start()
    try:
        data = _get(
            srv,
            "/eth/v1/builder/states/head/expected_withdrawals")["data"]
        assert isinstance(data, list)   # no full balances -> may be empty
        for w in data:
            assert set(w) == {"index", "validator_index", "address",
                              "amount"}
    finally:
        srv.stop()


def test_analysis_and_ops_routes(api):
    h, srv = api
    # graffiti / readiness / eth1 / ws
    assert "graffiti" in _get(srv, "/lighthouse/ui/graffiti")["data"]
    assert "graffiti" in _get(srv, "/eth/v1/node/graffiti")["data"]
    mr = _get(srv, "/lighthouse/merge_readiness")["data"]
    assert mr["type"] in ("ready", "not_synced")
    _get(srv, "/lighthouse/eth1/syncing")
    _get(srv, "/lighthouse/eth1/block_cache")
    ws = _get(srv, "/eth/v1/beacon/weak_subjectivity")["data"]
    assert ws["ws_checkpoint"].startswith("0x")
    assert _get(srv, "/lighthouse/finalized_checkpoint")["data"]
    # packing + attestation performance analysis
    packing = _get(srv, "/lighthouse/analysis/block_packing"
                        "?start_epoch=1&end_epoch=2")["data"]
    assert packing and all(0 <= p["packing_efficiency"] <= 1
                           for p in packing)
    assert _get(srv, "/lighthouse/analysis/block_packing_efficiency"
                     "?start_epoch=1&end_epoch=1")["data"]
    perf = _get(srv, "/lighthouse/analysis/attestation_performance/3"
                     "?start_epoch=0&end_epoch=99")["data"]
    assert perf[0]["index"] == 3 and "received_target" in perf[0]
    # per-validator inclusion
    inc = _get(srv, "/lighthouse/validator_inclusion/2/5")["data"]
    assert "is_previous_epoch_target_attester" in inc
    # fork-choice heads + connected peers + validator_count
    _get(srv, "/lighthouse/fork_choice/heads")
    _get(srv, "/lighthouse/peers/connected")
    vc = _get(srv, "/eth/v1/beacon/states/head/validator_count")["data"]
    assert int(vc["active_ongoing"]) == 32
    # log tail (emit one record through the buffered logger first)
    import logging
    from lighthouse_tpu_torch.utils.log_buffer import global_log_buffer
    global_log_buffer()
    logging.getLogger("lighthouse_tpu_torch.test").info("analysis route test")
    tail = _get(srv, "/lighthouse/logs/tail?n=10")["data"]
    assert any("analysis route test" in e["msg"] for e in tail)


def test_analysis_post_routes(api):
    h, srv = api
    # POST liveness
    out = _post(srv, "/eth/v1/validator/liveness/2", ["0", "1", "9"])
    data = out["data"]
    assert len(data) == 3 and all("is_live" in d for d in data)
    # ui validator metrics/info
    vm = _post(srv, "/lighthouse/ui/validator_metrics",
               {"indices": [0, 1]})["data"]["validators"]
    assert set(vm) == {"0", "1"}
    vi = _post(srv, "/lighthouse/ui/validator_info",
               {"indices": [2]})["data"]["validators"]
    assert "2" in vi and vi["2"]["status"]
    # POST validator_identities
    ids = _post(srv, "/eth/v1/beacon/states/head/validator_identities",
                ["4"])["data"]
    assert len(ids) == 1
    # db ops
    assert _post(srv, "/lighthouse/database/reconstruct", {})["data"]
    assert _post(srv, "/lighthouse/compaction", {})["data"]


def test_blinded_block_get_route(api):
    h, srv = api
    # altair chain: blinded GET falls back to the full block SSZ
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/eth/v1/beacon/blinded_blocks/head",
        headers={"Accept": "application/octet-stream"})
    raw = urllib.request.urlopen(req).read()
    from lighthouse_tpu_torch.ssz import deserialize
    fork = h.chain.spec.fork_name_at_slot(h.chain.head().head_state.slot)
    blk = deserialize(h.chain.T.SignedBeaconBlock[fork].ssz_type, raw)
    assert blk.message.slot == h.chain.head().head_state.slot


def test_database_info_and_nat_status(api):
    h, srv = api
    d = _get(srv, "/lighthouse/database/info")["data"]
    # schema_version is a NUMBER (reference DatabaseInfo u64 shape)
    assert d["schema_version"] == h.chain.store.schema_version()
    assert d["split"]["state_root"].startswith("0x")
    # /lighthouse/nat stays a bare bool (reference observe_nat shape)
    assert _get(srv, "/lighthouse/nat")["data"] is True
    nat = _get(srv, "/lighthouse/nat/status")["data"]
    assert nat == {"attempted": False, "gateway": None, "mapped": [],
                   "error": None}
    # with a UPnP outcome attached, both report the real result
    from lighthouse_tpu_torch.network.nat import NatOutcome
    try:
        h.chain.nat_outcome = NatOutcome(attempted=True,
                                         mapped=[("TCP", 9000)])
        assert _get(srv, "/lighthouse/nat")["data"] is True
        nat2 = _get(srv, "/lighthouse/nat/status")["data"]
        assert nat2["mapped"] == [["TCP", 9000]]
    finally:
        h.chain.nat_outcome = None
