"""graftflow oracle-equivalence suite (chain/replay/), on the port.

The epoch-pipelined replay engine must be observationally identical to
the sequential import loop it replaces: replaying a multi-epoch segment
through ``ReplayEngine`` yields a bit-identical head block root and head
state root versus ``process_chain_segment`` on a twin chain, across
forks and across a mid-segment fork upgrade.  Corrupt segments are
rejected by both paths with the same committed prefix (whole epochs for
the pipeline), the gossip-dedup satellite drops already-verified
proposal sets, and the engine's snapshot feeds the flight recorder /
doctor.  The same cases as the JAX package's tests/test_replay.py, with
the imports switched to lighthouse_tpu_torch.
"""
from __future__ import annotations

import pytest

from lighthouse_tpu_torch.chain import BeaconChainHarness, BlockError
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.ssz import htr
from lighthouse_tpu_torch.testing.state_harness import StateHarness

FORK_SPECS = {
    "altair": dict(altair_fork_epoch=0),
    "capella": dict(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                    capella_fork_epoch=0),
    "electra": dict(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                    capella_fork_epoch=0, deneb_fork_epoch=0,
                    electra_fork_epoch=0),
}


@pytest.fixture(autouse=True)
def fake_crypto():
    prev, saved = set_device("cpu"), bls._current
    bls.set_backend("fake")
    yield
    bls._current = saved
    set_device(prev)


def _segment(spec, epochs):
    """A deterministic `epochs`-epoch segment of signed blocks."""
    prod = StateHarness(spec, 64)
    return prod, prod.extend_chain(epochs * spec.preset.slots_per_epoch)


def _twin(spec, top_slot):
    h = BeaconChainHarness(spec, 64)
    h.set_slot(top_slot)
    return h


def _heads(h):
    head = h.chain.head()
    return head.head_block_root, head.head_state.hash_tree_root()


@pytest.mark.parametrize("fork", sorted(FORK_SPECS))
def test_pipelined_replay_matches_sequential_oracle(fork):
    spec = minimal_spec(**FORK_SPECS[fork])
    _, blocks = _segment(spec, 3)
    top = blocks[-1].message.slot + 1
    oracle, pipe = _twin(spec, top), _twin(spec, top)
    n_seq = oracle.chain.process_chain_segment(list(blocks))
    n_pipe = pipe.chain.replay_engine().replay_segment(list(blocks))
    assert n_seq == n_pipe == len(blocks)
    assert _heads(oracle) == _heads(pipe)
    # the committed store agrees too: head block + post-state retrievable
    root = pipe.chain.head().head_block_root
    sb = pipe.chain.store.get_block(root)
    assert sb is not None
    assert pipe.chain.store.get_hot_state(sb.message.state_root) is not None


def test_replay_across_mid_segment_fork_upgrade():
    """The deferred-merkleization slot advance must ride through
    ``_maybe_upgrade_fork`` exactly like the sequential path."""
    spec = minimal_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0,
                        capella_fork_epoch=0, deneb_fork_epoch=2)
    _, blocks = _segment(spec, 3)
    top = blocks[-1].message.slot + 1
    oracle, pipe = _twin(spec, top), _twin(spec, top)
    assert oracle.chain.process_chain_segment(list(blocks)) == \
        pipe.chain.replay_engine().replay_segment(list(blocks))
    assert _heads(oracle) == _heads(pipe)


def test_gossip_verified_proposals_are_deduped():
    spec = minimal_spec()
    _, blocks = _segment(spec, 2)
    top = blocks[-1].message.slot + 1
    pipe = _twin(spec, top)
    # mark every block as having passed the gossip-edge proposer check
    # (observe() only ever runs after a successful gossip verification)
    for sb in blocks:
        pipe.chain.observed_block_producers.observe(
            int(sb.message.slot), int(sb.message.proposer_index),
            htr(sb.message))
    engine = pipe.chain.replay_engine()
    assert engine.replay_segment(list(blocks)) == len(blocks)
    assert engine.sigs_deduped == len(blocks)
    # dedup must not change the outcome: a clean twin replay agrees
    fresh = _twin(spec, top)
    assert fresh.chain.replay_engine().replay_segment(list(blocks)) \
        == len(blocks)
    assert _heads(fresh) == _heads(pipe)


def test_invalid_signature_rejects_epoch_and_matches_oracle():
    """A poisoned signature on the first block of an epoch: both paths
    raise with the same kind, and nothing from the failing epoch lands.
    The pipeline keeps the epochs committed before the failure (partial
    progress the sync layer re-filters on retry); the sequential oracle
    is all-or-nothing — so the pipeline's committed prefix must equal
    the oracle's import of the valid prefix."""
    spec = minimal_spec()
    spe = spec.preset.slots_per_epoch
    _, blocks = _segment(spec, 3)
    bad = next(i for i, sb in enumerate(blocks)
               if sb.message.slot == 2 * spe)
    blocks[bad].signature = b"\xff" + bytes(blocks[bad].signature[1:])
    top = blocks[-1].message.slot + 1
    oracle, pipe = _twin(spec, top), _twin(spec, top)
    with pytest.raises(BlockError) as e_seq:
        oracle.chain.process_chain_segment(list(blocks))
    with pytest.raises(BlockError) as e_pipe:
        pipe.chain.replay_engine().replay_segment(list(blocks))
    assert e_seq.value.kind == e_pipe.value.kind == "invalid_signature"
    # oracle staged-then-imported: the raise left it untouched
    assert oracle.chain.head().head_state.slot == 0
    # pipeline committed exactly the epochs before the poisoned one
    assert pipe.chain.head().head_state.slot == 2 * spe - 1
    assert oracle.chain.process_chain_segment(blocks[:bad]) == bad
    assert _heads(oracle) == _heads(pipe)


def test_claimed_state_root_mismatch_rejects_epoch():
    """A wrong claimed state root is caught at the epoch flush; nothing
    from the failing epoch commits and the oracle agrees on the head."""
    spec = minimal_spec()
    spe = spec.preset.slots_per_epoch
    _, blocks = _segment(spec, 3)
    bad = next(i for i, sb in enumerate(blocks)
               if sb.message.slot == 2 * spe + 1)
    blocks[bad].message.state_root = b"\x37" * 32
    top = blocks[-1].message.slot + 1
    oracle, pipe = _twin(spec, top), _twin(spec, top)
    with pytest.raises(BlockError):
        oracle.chain.process_chain_segment(list(blocks))
    with pytest.raises(BlockError):
        pipe.chain.replay_engine().replay_segment(list(blocks))
    assert oracle.chain.head().head_state.slot == 0
    assert pipe.chain.head().head_state.slot == 2 * spe - 1
    valid_prefix = [sb for sb in blocks if sb.message.slot < 2 * spe]
    assert oracle.chain.process_chain_segment(valid_prefix) \
        == len(valid_prefix)
    assert _heads(oracle) == _heads(pipe)


def test_known_blocks_are_filtered_and_resume_converges():
    """Retrying a segment whose prefix already committed (the partial-
    progress contract after a mid-segment failure) re-imports nothing
    and converges on the same head as a one-shot replay."""
    spec = minimal_spec()
    _, blocks = _segment(spec, 2)
    spe = spec.preset.slots_per_epoch
    top = blocks[-1].message.slot + 1
    pipe = _twin(spec, top)
    engine = pipe.chain.replay_engine()
    first = [sb for sb in blocks if sb.message.slot < spe]
    assert engine.replay_segment(first) == len(first)
    # the retry carries the whole segment; the known prefix is admitted
    # away and only the tail imports
    assert engine.replay_segment(list(blocks)) == len(blocks) - len(first)
    oneshot = _twin(spec, top)
    oneshot.chain.replay_engine().replay_segment(list(blocks))
    assert _heads(oneshot) == _heads(pipe)


def test_backfill_batch_commits_atomically():
    spec = minimal_spec()
    _, blocks = _segment(spec, 1)
    h = BeaconChainHarness(spec, 64)
    engine = h.chain.replay_engine()
    pairs = [(htr(sb.message), sb) for sb in blocks]
    engine.backfill_batch(pairs)
    assert engine.backfill_batches == 1
    for root, _sb in pairs:
        assert h.chain.store.get_block(root) is not None


def test_snapshot_feeds_flight_recorder_and_doctor():
    from lighthouse_tpu_torch.obs import doctor, graftwatch
    spec = minimal_spec()
    _, blocks = _segment(spec, 2)
    top = blocks[-1].message.slot + 1
    pipe = _twin(spec, top)
    engine = pipe.chain.replay_engine()
    engine.replay_segment(list(blocks))
    snap = engine.snapshot()
    assert snap["active"] == 0
    assert snap["commit_seq"] >= 2
    assert snap["blocks_committed"] == len(blocks)
    assert set(snap["queue_high_water"]) == {"signature", "commit"}
    last = snap["last_segment"]
    assert last["blocks"] == len(blocks)
    assert last["epochs_per_sec"] > 0
    assert set(last["occupancy"]) == {
        "admission", "signature", "stf", "merkle", "commit"}
    doc = graftwatch.get().recorder.build(reason="test")
    assert doc["replay"], "flight dump must carry the replay section"
    assert any(s.get("commit_seq", 0) >= 2 for s in doc["replay"]
               if isinstance(s, dict))
    rendered = doctor.render(doctor.diagnose(doc))
    assert "replay:" in rendered
