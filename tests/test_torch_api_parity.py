"""The port's Beacon API (``api/backend.py``, ``api/http_server.py``,
``api/serving/``, ``api/json_repr.py``) against the JAX package's,
tolerance zero: twin minimal-preset ``BeaconChainHarness`` chains of 64
validators (fake crypto, the same blocks in both packages), each behind
its own package's ``BeaconApiServer`` on 127.0.0.1. Every route answers
with the same status, the same ``Eth-Consensus-Version`` and content type
and the same body bytes; the refusals (an unknown header, a truncated
block, an unknown ``broadcast_validation``, a poisoned-signature
attestation) carry the same status and message; ``container_json`` of a
block and the serving tier's cached bytes are equal."""
import http.client
import json

import pytest

from lighthouse_tpu.api import ApiBackend as JApiBackend
from lighthouse_tpu.api import BeaconApiServer as JBeaconApiServer
from lighthouse_tpu.api.json_repr import container_json as j_container_json
from lighthouse_tpu.chain import BeaconChainHarness as JHarness
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.specs import minimal_spec as j_minimal_spec
from lighthouse_tpu_torch.api import ApiBackend, BeaconApiServer
from lighthouse_tpu_torch.api.json_repr import container_json
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.ssz import serialize

VALIDATORS = 64
#: blocks on each chain before the servers start (two epochs and a half
#: of the minimal preset: a justified checkpoint, a mid-epoch head)
SLOTS = 20


@pytest.fixture(scope="module")
def twins():
    prev = set_device("cpu")
    saved = bls._current, jbls._current
    bls.set_backend("fake")
    jbls.set_backend("fake")
    h, jh = (BeaconChainHarness(minimal_spec(), VALIDATORS),
             JHarness(j_minimal_spec(), VALIDATORS))
    assert h.extend_chain(SLOTS) == jh.extend_chain(SLOTS)
    h.advance_slot()
    jh.advance_slot()
    srv, jsrv = (BeaconApiServer(ApiBackend(h.chain)),
                 JBeaconApiServer(JApiBackend(jh.chain)))
    srv.start()
    jsrv.start()
    try:
        yield h, jh, srv, jsrv
    finally:
        srv.stop()
        jsrv.stop()
        bls._current, jbls._current = saved
        set_device(prev)


def _call(port: int, method: str, path: str, body: bytes | None = None,
          headers: dict | None = None) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        return (r.status, r.getheader("Eth-Consensus-Version"),
                r.getheader("Content-Type"), data)
    finally:
        conn.close()


def _both(twins, method, path, body=None, headers=None):
    _h, _jh, srv, jsrv = twins
    got = _call(srv.port, method, path, body, headers)
    want = _call(jsrv.port, method, path, body, headers)
    assert got == want, (path, got[:3], want[:3], got[3][:200], want[3][:200])
    return got


SSZ = {"Accept": "application/octet-stream"}


#: (method, path, request headers); ``{slot}``, ``{epoch}`` and
#: ``{pubkey}`` are the chain's clock slot, its epoch and validator 7's key
ROUTES = [
    ("GET", "/eth/v1/beacon/genesis", None),
    ("GET", "/eth/v1/beacon/states/head/root", None),
    ("GET", "/eth/v1/beacon/states/head/fork", None),
    ("GET", "/eth/v1/beacon/states/head/finality_checkpoints", None),
    ("GET", "/eth/v1/beacon/states/head/validators?id=0&id=5&id=63", None),
    ("GET", "/eth/v1/beacon/states/head/validators/3", None),
    ("GET", "/eth/v1/beacon/states/head/validators/0x{pubkey}", None),
    ("GET", "/eth/v1/beacon/states/head/committees", None),
    ("GET", "/eth/v1/beacon/headers/head", None),
    ("GET", f"/eth/v1/beacon/headers/{SLOTS - 3}", None),
    ("GET", "/eth/v1/beacon/blocks/head/root", None),
    ("GET", "/eth/v2/beacon/blocks/head", None),
    ("GET", "/eth/v2/beacon/blocks/head", SSZ),
    ("GET", f"/eth/v2/beacon/blocks/{SLOTS - 5}", SSZ),
    ("GET", "/eth/v1/validator/duties/proposer/{epoch}", None),
    ("GET", "/eth/v1/validator/attestation_data?slot={slot}"
            "&committee_index=0", None),
    ("GET", "/eth/v1/validator/validator_index?pubkey=0x{pubkey}", None),
    ("GET", "/eth/v1/validator/fork_version", None),
    ("GET", "/eth/v1/config/spec", None),
    ("GET", "/eth/v1/config/fork_schedule", None),
    ("GET", "/eth/v1/node/syncing", None),
    ("GET", "/eth/v1/node/version", None),
    ("GET", "/lighthouse/head_root", None),
]


@pytest.mark.parametrize("method,path,headers", ROUTES)
def test_route_byte_equal(twins, method, path, headers):
    chain = twins[0].chain
    slot = chain.slot()
    path = path.format(
        slot=slot, epoch=slot // chain.spec.preset.slots_per_epoch,
        pubkey=chain.head().head_state.validators.pubkey(7).hex())
    status, *_ = _both(twins, method, path, headers=headers)
    assert status == 200


def test_attester_duties_post_byte_equal(twins):
    h = twins[0]
    epoch = h.chain.slot() // h.chain.spec.preset.slots_per_epoch
    for e in (epoch, epoch + 1):
        status, _v, _c, body = _both(
            twins, "POST", f"/eth/v1/validator/duties/attester/{e}",
            json.dumps([str(i) for i in range(0, VALIDATORS, 3)]).encode(),
            {"Content-Type": "application/json"})
        assert status == 200 and json.loads(body)["data"]


def test_produce_block_ssz_byte_equal(twins):
    h, jh = twins[0], twins[1]
    slot = h.chain.slot()
    state = h.chain.head().head_state
    from lighthouse_tpu_torch.state_transition import process_slots
    from lighthouse_tpu_torch.state_transition.helpers import (
        get_beacon_proposer_index,
    )
    advanced = state.copy()
    process_slots(advanced, slot)
    proposer = get_beacon_proposer_index(advanced, slot)
    reveal = h.randao_reveal(advanced, slot, proposer)
    status, version, ctype, body = _both(
        twins, "GET", f"/eth/v2/validator/blocks/{slot}?randao_reveal=0x"
                      f"{reveal.hex()}", headers=SSZ)
    assert status == 200 and ctype == "application/octet-stream"
    assert version == h.chain.spec.fork_name_at_slot(slot).name.lower()
    assert len(body) > 100


def test_refusals_equal(twins):
    h = twins[0]
    chain = h.chain
    head = chain.head()
    status, *_ = _both(twins, "GET", "/eth/v1/beacon/headers/0x" + "00" * 32)
    assert status == 404
    block = head.head_block
    raw = serialize(type(block).ssz_type, block)
    status, *_ = _both(twins, "POST", "/eth/v1/beacon/blocks", raw[:-7],
                       {"Content-Type": "application/octet-stream"})
    assert status == 400
    status, _v, _c, body = _both(
        twins, "POST", "/eth/v1/beacon/blocks?broadcast_validation=banana",
        raw, {"Content-Type": "application/octet-stream"})
    assert status == 400 and b"broadcast_validation" in body
    # an attestation of the slot by a committee member, its signature
    # poisoned (the fake backend refuses a signature that leads with 0xff)
    backend = ApiBackend(chain)
    slot = chain.slot()
    data = backend.attestation_data(slot, 0)
    duties = backend.get_attester_duties(
        slot // chain.spec.preset.slots_per_epoch, list(range(VALIDATORS)))
    _s, _ci, _v, size, pos = next(d for d in duties
                                  if d[0] == slot and d[1] == 0)
    att = chain.T.Attestation(
        aggregation_bits=[i == pos for i in range(size)], data=data,
        signature=bytes([bls.POISON_SIGNATURE_BYTE]) + bytes(95))
    status, _v, _c, body = _both(
        twins, "POST", "/eth/v1/beacon/pool/attestations",
        serialize(chain.T.Attestation.ssz_type, att),
        {"Content-Type": "application/octet-stream"})
    assert status == 400 and b"attestation rejected" in body


def test_container_json_of_a_block(twins):
    h, jh = twins[0], twins[1]
    block, jblock = h.chain.head().head_block, jh.chain.head().head_block
    got, want = container_json(block), j_container_json(jblock)
    assert got == want
    assert json.dumps(got) == json.dumps(want)


def test_serving_tier_cached_bytes_equal(twins):
    h, _jh, srv, jsrv = twins
    slot = h.chain.slot()
    epoch = slot // h.chain.spec.preset.slots_per_epoch
    paths = [f"/eth/v1/validator/duties/proposer/{epoch}",
             f"/eth/v1/validator/duties/proposer/{epoch + 1}",
             f"/eth/v1/validator/attestation_data?slot={slot}"
             f"&committee_index=1"]
    served = [_both(twins, "GET", p)[3] for p in paths]
    # a repeat is a cache hit with the same bytes
    hits = srv.serving.cache.hits
    assert [_both(twins, "GET", p)[3] for p in paths] == served
    assert srv.serving.cache.hits >= hits + len(paths)

    def entries(server):
        with server.serving.cache._lock:
            return {k: v.body for k, v in server.serving.cache._entries.items()}

    got, want = entries(srv), entries(jsrv)
    assert got and got == want
    assert set(served) <= set(got.values())
