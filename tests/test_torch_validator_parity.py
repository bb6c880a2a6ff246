"""The port's validator client (``validator_client/``) and validator
manager against the JAX package's, tolerance zero. Each package's
``ValidatorClient`` holds the 64 interop keys of a minimal-preset
``BeaconChainHarness`` chain and drives it for one epoch through its own
package's ``ApiBackend``, signing on the ``cpp`` backend: every slot's
block root and signature, the op pool's attestations, the head and the
justified and finalized checkpoints and the slashing-protection
interchange are byte-equal. So are a keymanager keystore import and its
listing over HTTP, a ``remote_signer`` signature (and the local one), and
``validator_manager.create_validators``' keystore files under a fixed
``os.urandom`` / ``uuid.uuid4``."""
import json
import os
import urllib.request
import uuid

import numpy as np
import pytest

import lighthouse_tpu.validator_client.keymanager as jkm
import lighthouse_tpu.validator_client.remote_signer as jrs
import lighthouse_tpu.validator_manager as jvm
from lighthouse_tpu.api import ApiBackend as JApiBackend
from lighthouse_tpu.chain import BeaconChainHarness as JHarness
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.crypto.keystore import create_keystore as j_create_ks
from lighthouse_tpu.specs import minimal_spec as j_minimal_spec
from lighthouse_tpu.ssz import serialize as jserialize
import lighthouse_tpu.validator_client as jvc
import lighthouse_tpu_torch.validator_client as vc_mod
import lighthouse_tpu_torch.validator_client.keymanager as km
import lighthouse_tpu_torch.validator_client.remote_signer as rs
import lighthouse_tpu_torch.validator_manager as vm
from lighthouse_tpu_torch.api import ApiBackend
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.keystore import create_keystore
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.ssz import serialize

VALIDATORS = 64

PORT = {"harness": BeaconChainHarness, "spec": minimal_spec,
        "api": ApiBackend, "vc": vc_mod, "ser": serialize}
JAX = {"harness": JHarness, "spec": j_minimal_spec, "api": JApiBackend,
       "vc": jvc, "ser": jserialize}


@pytest.fixture(autouse=True, scope="module")
def cpp_crypto():
    prev = set_device("cpu")
    saved = bls._current, jbls._current
    bls.set_backend("cpp")
    jbls.set_backend("cpp")
    yield
    bls._current, jbls._current = saved
    set_device(prev)


def _epoch_of_duties(pkg: dict) -> dict:
    """One epoch of a validator client's duties on a fresh chain: the
    record of each slot and what the chain and the client hold after."""
    spec = pkg["spec"]()
    h = pkg["harness"](spec, VALIDATORS)
    vc = pkg["vc"]
    store = vc.ValidatorStore(spec, h.chain.genesis_validators_root)
    for sk in h.secret_keys:
        store.add_validator(sk)
    client = vc.ValidatorClient(spec, store, vc.BeaconNodeFallback(
        [pkg["api"](h.chain)]))
    slots = []
    for _ in range(spec.preset.slots_per_epoch):
        h.advance_slot()
        client.on_slot(h.chain.slot())
        h.chain.recompute_head()
        head = h.chain.head()
        slots.append((head.head_block_root, bytes(head.head_block.signature)))
    pool = h.chain.op_pool
    with pool._lock:
        attestations = [pkg["ser"](type(a).ssz_type, a)
                        for bucket in pool._attestations.values()
                        for a in bucket]
    return {"slots": slots, "attestations": attestations,
            "head": h.chain.head().head_block_root,
            "justified": h.chain.justified_checkpoint(),
            "finalized": h.chain.finalized_checkpoint(),
            "published": (client.published_blocks,
                          client.published_attestations,
                          client.published_aggregates),
            "interchange": json.dumps(store.slashing_db.export_interchange(
                h.chain.genesis_validators_root), sort_keys=True)}


@pytest.fixture(scope="module")
def epochs():
    return _epoch_of_duties(PORT), _epoch_of_duties(JAX)


def test_block_roots_and_signatures_equal(epochs):
    mine, theirs = epochs
    assert mine["slots"] == theirs["slots"]
    assert len({root for root, _sig in mine["slots"]}) == len(mine["slots"])
    assert mine["published"] == theirs["published"]
    assert mine["published"][0] == len(mine["slots"])


def test_op_pool_attestations_equal(epochs):
    mine, theirs = epochs
    assert mine["attestations"] and \
        mine["attestations"] == theirs["attestations"]


def test_head_and_checkpoints_equal(epochs):
    mine, theirs = epochs
    for key in ("head", "justified", "finalized"):
        assert mine[key] == theirs[key], key


def test_slashing_interchange_equal(epochs):
    mine, theirs = epochs
    doc = json.loads(mine["interchange"])
    assert len(doc["data"]) == VALIDATORS
    assert sum(len(d["signed_attestations"]) for d in doc["data"]) > 0
    assert mine["interchange"] == theirs["interchange"]


def _bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _fixed_randomness(monkeypatch, seed):
    """os.urandom and uuid.uuid4 from a numpy stream that restarts at each
    call of the returned reset()."""
    state = {}

    def reset():
        state["rng"] = np.random.default_rng(seed)

    reset()
    monkeypatch.setattr(os, "urandom", lambda n: _bytes(state["rng"], n))
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(bytes=_bytes(state["rng"], 16)))
    return reset


def _keymanager_call(srv, method, path, obj=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(obj).encode() if obj is not None else None,
        method=method, headers={"Content-Type": "application/json",
                                "Authorization": f"Bearer {srv.token}"})
    with urllib.request.urlopen(req) as r:
        return r.read()


def test_keymanager_import_and_listing_equal(monkeypatch):
    reset = _fixed_randomness(monkeypatch, 17)
    keystores = [create_keystore(sk, b"hunter2") for sk in (4242, 777)]
    reset()
    assert [j_create_ks(sk, b"hunter2") for sk in (4242, 777)] == keystores
    answers = []
    for mod, vc in ((km, vc_mod), (jkm, jvc)):
        spec = (minimal_spec if vc is vc_mod else j_minimal_spec)()
        client = vc.ValidatorClient(spec, vc.ValidatorStore(
            spec, b"\x11" * 32), vc.BeaconNodeFallback([]))
        srv = mod.KeymanagerServer(client, token="t" * 32)
        srv.start()
        try:
            answers.append((
                _keymanager_call(srv, "POST", "/eth/v1/keystores", {
                    "keystores": [json.dumps(k) for k in keystores],
                    "passwords": ["hunter2", "wrong"]}),
                _keymanager_call(srv, "GET", "/eth/v1/keystores")))
        finally:
            srv.stop()
    assert answers[0] == answers[1]
    imported, listed = (json.loads(a) for a in answers[0])
    assert [d["status"] for d in imported["data"]] == ["imported", "error"]
    assert [d["validating_pubkey"] for d in listed["data"]] == \
        ["0x" + bls.sk_to_pk(4242).hex()]


def test_remote_signer_signature_equal():
    root = bytes(range(32))
    sigs = []
    for mod, b in ((rs, bls), (jrs, jbls)):
        signer = mod.MockWeb3Signer()
        url = signer.start()
        try:
            pk = signer.add_key(9001)
            remote = mod.remote_sign(url, pk, root)
        finally:
            signer.stop()
        assert remote == b.sign(9001, root)
        sigs.append((pk, remote))
    assert sigs[0] == sigs[1]


def test_create_validators_keystores_equal(tmp_path, monkeypatch):
    seed = bytes(range(32))
    reset = _fixed_randomness(monkeypatch, 23)
    mine = vm.create_validators(seed, 2, str(tmp_path / "port"), b"pw")
    reset()
    theirs = jvm.create_validators(seed, 2, str(tmp_path / "jax"), b"pw")
    assert mine == theirs
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 2
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
