"""The port's beacon node layers (chain/, fork_choice/, operation_pool/,
store/) against the JAX package's, tolerance zero: the same
BeaconChainHarness scenario, five epochs of blocks with every validator
attesting each slot (minimal preset, 64 validators, fake crypto), run in
both packages on MemoryStore and on NativeKvStore. Equal, with states and
blocks carried across as SSZ bytes: the genesis state, every block, the
head root and head state, the justified and finalized checkpoints, the
proto-array nodes (weights, best children and descendants), every key and
value of the hot and cold stores, and the op pool's packing for the next
block."""
import pytest

from lighthouse_tpu.chain import BeaconChainHarness as JHarness
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.specs import minimal_spec as j_minimal_spec
from lighthouse_tpu.ssz import serialize as jserialize
from lighthouse_tpu.state_transition import process_slots as j_process_slots
from lighthouse_tpu.store import HotColdDB as JHotColdDB
from lighthouse_tpu.store import MemoryStore as JMemoryStore
from lighthouse_tpu.store import NativeKvStore as JNativeKvStore
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.ssz import serialize
from lighthouse_tpu_torch.state_transition import process_slots
from lighthouse_tpu_torch.store import HotColdDB, MemoryStore, NativeKvStore

VALIDATORS = 64
EPOCHS = 5


@pytest.fixture(autouse=True)
def cpu_and_fake_crypto():
    prev = set_device("cpu")
    saved = bls._current, jbls._current
    bls.set_backend("fake")
    jbls.set_backend("fake")
    yield
    bls._current, jbls._current = saved
    set_device(prev)


def _kv_pair(kind: str, root):
    """(port hot, port cold, JAX hot, JAX cold) key-value stores."""
    if kind == "memory":
        return MemoryStore(), MemoryStore(), JMemoryStore(), JMemoryStore()
    return (NativeKvStore(root / "port" / "hot"),
            NativeKvStore(root / "port" / "cold"),
            JNativeKvStore(root / "jax" / "hot"),
            JNativeKvStore(root / "jax" / "cold"))


def _block_bytes(block, ser) -> bytes:
    return ser(type(block).ssz_type, block)


def _nodes(fork_choice) -> list[tuple]:
    return [(n.slot, n.root, n.parent, n.weight, n.best_child,
             n.best_descendant, n.justified_checkpoint,
             n.finalized_checkpoint, n.execution_status.name)
            for n in fork_choice.proto_array.nodes]


@pytest.mark.parametrize("kind", ["memory", "native"])
def test_harness_chain_matches_jax(kind, tmp_path):
    hot, cold, jhot, jcold = _kv_pair(kind, tmp_path)
    spec, jspec = minimal_spec(), j_minimal_spec()
    ht = BeaconChainHarness(spec, VALIDATORS,
                            store=HotColdDB(hot, cold, spec))
    hj = JHarness(jspec, VALIDATORS, store=JHotColdDB(jhot, jcold, jspec))
    assert ht.chain.genesis_state.serialize() == \
        hj.chain.genesis_state.serialize()

    n = EPOCHS * spec.preset.slots_per_epoch
    roots = ht.extend_chain(n)
    assert roots == hj.extend_chain(n)
    for root in roots:
        assert _block_bytes(ht.chain.store.get_block(root), serialize) == \
            _block_bytes(hj.chain.store.get_block(root), jserialize)

    head, jhead = ht.chain.head(), hj.chain.head()
    assert head.head_block_root == jhead.head_block_root == roots[-1]
    assert head.head_state.serialize() == jhead.head_state.serialize()
    assert ht.chain.justified_checkpoint() == hj.chain.justified_checkpoint()
    assert ht.chain.finalized_checkpoint() == \
        hj.chain.finalized_checkpoint()
    assert ht.chain.finalized_checkpoint()[0] >= 2
    assert _nodes(ht.chain.fork_choice) == _nodes(hj.chain.fork_choice)
    assert ht.chain.store.split.slot == hj.chain.store.split.slot > 0

    for port_kv, jax_kv in ((hot, jhot), (cold, jcold)):
        items = list(port_kv.iter_prefix(b""))
        assert items and items == list(jax_kv.iter_prefix(b""))

    # the op pool's packing for the next slot's block
    state, jstate = head.head_state.copy(), jhead.head_state.copy()
    process_slots(state, state.slot + 1)
    j_process_slots(jstate, jstate.slot + 1)
    packed = ht.chain.op_pool.get_attestations_for_block(state)
    jpacked = hj.chain.op_pool.get_attestations_for_block(jstate)
    assert packed
    assert [_block_bytes(a, serialize) for a in packed] == \
        [_block_bytes(a, jserialize) for a in jpacked]
