"""The port's client builder (``client/builder.py``, ``client/environment.py``)
against the JAX package's, tolerance zero: twin minimal-preset nodes built
by each package's ``ClientBuilder(...).build()`` (the ``cpp`` backend, HTTP
on port 0, the network and discovery on ephemeral ports), from interop
genesis and from a checkpoint state and block, answer the same routes with
the same bytes; a block POSTed to both imports to the same head. Then the
datadir path: each node on ``NativeKvStore``s in a directory of its own,
stopped and built again from the directory alone (``resume_from_store``),
comes back with the same genesis, finalized checkpoint and head in both
packages (the anchor's: neither persists its head before finality). Only routes that do not read the wall clock are compared (the
two nodes are built a moment apart)."""
import http.client
import time

import pytest

from lighthouse_tpu.client import ClientBuilder as JClientBuilder
from lighthouse_tpu.client import Environment as JEnvironment
from lighthouse_tpu.client.builder import ClientConfig as JClientConfig
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.specs import minimal_spec as j_minimal_spec
from lighthouse_tpu_torch.client import ClientBuilder, Environment
from lighthouse_tpu_torch.client.builder import ClientConfig
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.ssz import htr, serialize
from lighthouse_tpu_torch.testing.state_harness import StateHarness

VALIDATORS = 64
#: the checkpoint: the state and block at this slot (minimal's second
#: epoch boundary); the blocks POSTed are the next epoch's eight, the last
#: of which justifies the anchor (fork choice keeps a block off the head
#: until its state's justified checkpoint is the anchor)
ANCHOR_SLOT = 16
POSTED = 8

ROUTES = [
    "/eth/v1/beacon/genesis",
    "/eth/v1/beacon/states/head/root",
    "/eth/v1/beacon/states/head/fork",
    "/eth/v1/beacon/states/head/finality_checkpoints",
    "/eth/v1/beacon/states/head/validators?id=0&id=5&id=63",
    "/eth/v1/beacon/headers/head",
    "/eth/v1/beacon/blocks/head/root",
    "/eth/v2/beacon/blocks/head",
    "/eth/v1/config/spec",
    "/eth/v1/config/fork_schedule",
    "/eth/v1/config/deposit_contract",
    "/eth/v1/node/version",
    "/eth/v1/node/health",
    "/lighthouse/head_root",
]


@pytest.fixture(autouse=True)
def cpu_cpp():
    prev = set_device("cpu")
    saved = bls._current, jbls._current
    bls.set_backend("cpp")
    jbls.set_backend("cpp")
    yield
    bls._current, jbls._current = saved
    set_device(prev)


def _call(port: int, path: str, method: str = "GET", body=None,
          headers=None) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return (r.status, r.getheader("Eth-Consensus-Version"),
                r.getheader("Content-Type"), r.read())
    finally:
        conn.close()


def _nodes(make: dict) -> list:
    """Build the port's node, then the JAX package's, from ``make``: a
    dict of ClientConfig fields (both packages' configs take the same)."""
    out = []
    for builder, config, env, spec in (
            (ClientBuilder, ClientConfig, Environment, minimal_spec()),
            (JClientBuilder, JClientConfig, JEnvironment, j_minimal_spec())):
        cfg = config(http_port=0, crypto_backend="cpp", **make)
        e = env("WARNING")
        out.append((builder(spec, e).with_config(cfg).build(), e))
    return out


def _stop(nodes) -> None:
    for client, env in nodes:
        client.stop()
        env.shutdown("test over")
        store = client.chain.store
        for kv in (store.hot, store.cold):
            kv.close()


def _same_routes(nodes, routes=ROUTES) -> None:
    (port_node, _), (jax_node, _) = nodes
    for path in routes:
        got = _call(port_node.api_server.port, path)
        want = _call(jax_node.api_server.port, path)
        assert got == want, (path, got[:3], want[:3], got[3][:300],
                             want[3][:300])


def test_interop_genesis_nodes_answer_the_same():
    # genesis a minute ahead: both clocks stand before it (slot 0)
    nodes = _nodes({"interop_validator_count": VALIDATORS,
                    "genesis_time": int(time.time()) + 60})
    try:
        _same_routes(nodes)
        (a, _), (b, _) = nodes
        assert a.chain.genesis_validators_root == \
            b.chain.genesis_validators_root
        assert bls.get_backend().name == "cpp"
    finally:
        _stop(nodes)


def _checkpoint():
    """A chain of the port's ``StateHarness`` (signed on cpp) whose genesis
    time puts the wall clock one slot past the last block's: the anchor
    state and block (fork byte + SSZ) and the ``POSTED`` blocks after it."""
    spec = minimal_spec()
    genesis_time = int(time.time()) - (ANCHOR_SLOT + POSTED + 1) * \
        spec.seconds_per_slot
    sh = StateHarness(spec, VALIDATORS, genesis_time=genesis_time)
    blocks = sh.extend_chain(ANCHOR_SLOT)
    anchor_state = sh.state.copy()
    anchor = blocks[-1]
    assert anchor.message.slot == ANCHOR_SLOT
    assert anchor.message.state_root == anchor_state.hash_tree_root()
    posted = sh.extend_chain(POSTED)
    fork = bytes([anchor_state.fork_name.value])
    return (fork + anchor_state.serialize(),
            fork + serialize(type(anchor).ssz_type, anchor),
            posted, htr(anchor.message))


def _post_blocks(nodes, blocks) -> None:
    """POST each block as SSZ to both nodes: 200 from each."""
    for block in blocks:
        body = serialize(type(block).ssz_type, block)
        version = minimal_spec().fork_name_at_slot(
            block.message.slot).name.lower()
        for client, _env in nodes:
            got = _call(client.api_server.port, "/eth/v1/beacon/blocks",
                        "POST", body,
                        {"Content-Type": "application/octet-stream",
                         "Eth-Consensus-Version": version})
            assert got[0] == 200, got


def test_checkpoint_nodes_answer_the_same_and_import_a_posted_block():
    state, block, posted, anchor_root = _checkpoint()
    nodes = _nodes({"checkpoint_sync_state": state,
                    "checkpoint_sync_block": block})
    try:
        (a, _), (b, _) = nodes
        assert a.chain.head().head_block_root == anchor_root == \
            b.chain.head().head_block_root
        _same_routes(nodes)
        _post_blocks(nodes, posted)
        root = htr(posted[-1].message)
        assert a.chain.head().head_block_root == root == \
            b.chain.head().head_block_root
        _same_routes(nodes)
    finally:
        _stop(nodes)


def _datadir_nodes(tmp_path, **make) -> list:
    """Both packages' nodes on ``NativeKvStore``s, each in a datadir of its
    own under ``tmp_path``."""
    out = []
    for name, builder, config, env, spec in (
            ("port", ClientBuilder, ClientConfig, Environment,
             minimal_spec()),
            ("jax", JClientBuilder, JClientConfig, JEnvironment,
             j_minimal_spec())):
        e = env("WARNING")
        cfg = config(http_port=0, crypto_backend="cpp",
                     datadir=str(tmp_path / name), **make)
        out.append((builder(spec, e).with_config(cfg).build(), e))
    return out


def _where(nodes) -> list:
    return [(c.chain.genesis_block_root, c.chain.finalized_checkpoint(),
             c.chain.head().head_block_root) for c, _e in nodes]


def test_datadir_resume_gives_the_same_genesis_finality_and_head(tmp_path):
    state, block, posted, anchor_root = _checkpoint()
    nodes = _datadir_nodes(tmp_path, checkpoint_sync_state=state,
                           checkpoint_sync_block=block)
    try:
        _post_blocks(nodes, posted)
        before = _where(nodes)
    finally:
        _stop(nodes)
    assert before[0] == before[1]
    nodes = _datadir_nodes(tmp_path)
    try:
        after = _where(nodes)
        _same_routes(nodes, ["/eth/v1/beacon/genesis",
                             "/eth/v1/beacon/states/head/root",
                             "/eth/v1/beacon/states/head/"
                             "finality_checkpoints",
                             "/eth/v1/beacon/headers/head"])
    finally:
        _stop(nodes)
    assert after[0] == after[1]
    # both packages' nodes persist fork choice and the head at finality
    # only (``BeaconChain.persist``): a node stopped before its anchor's
    # epoch finalizes comes back at the anchor, the POSTed blocks stored
    epoch = ANCHOR_SLOT // minimal_spec().preset.slots_per_epoch
    assert before[0] == (anchor_root, (epoch, anchor_root),
                         htr(posted[-1].message))
    assert after[0] == (anchor_root, (epoch, anchor_root), anchor_root)
