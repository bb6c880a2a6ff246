"""The port's chain analytics (``watch/monitor.py``) against the JAX
package's, tolerance zero: twin minimal-preset ``BeaconChainHarness``
chains (fake BLS, interop keys, two epochs, the same blocks in both
packages), each followed by its own package's ``WatchMonitor``; after each
``update()`` every sqlite table holds the same rows, and the monitors'
HTTP fronts answer the same bytes."""
import urllib.request

import pytest

from lighthouse_tpu.chain import BeaconChainHarness as JHarness
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.specs import minimal_spec as j_minimal_spec
from lighthouse_tpu.watch import WatchMonitor as JWatchMonitor
from lighthouse_tpu.watch.monitor import WatchServer as JWatchServer
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.watch import WatchMonitor
from lighthouse_tpu_torch.watch.monitor import WatchServer

VALIDATORS = 64
TABLES = ("canonical_blocks", "epoch_summaries", "proposer_counts",
          "blockprint", "block_packing", "suboptimal_attestations")


@pytest.fixture(autouse=True)
def fake_crypto():
    prev = set_device("cpu")
    saved = bls._current, jbls._current
    bls.set_backend("fake")
    jbls.set_backend("fake")
    yield
    bls._current, jbls._current = saved
    set_device(prev)


def _rows(mon) -> dict:
    return {t: list(mon._db.execute(f"SELECT * FROM {t} ORDER BY 1, 2"))
            for t in TABLES}


def _twins():
    spec = minimal_spec(altair_fork_epoch=0)
    jspec = j_minimal_spec(altair_fork_epoch=0)
    return BeaconChainHarness(spec, VALIDATORS), JHarness(jspec, VALIDATORS)


@pytest.mark.parametrize("attesters", [None, 48])
def test_watch_tables_equal_row_for_row(attesters):
    """Full attestation (``extend_chain``), and a quarter of the
    validators never attesting (suboptimal rows, packing below one)."""
    h, jh = _twins()
    mons = WatchMonitor(h.chain), JWatchMonitor(jh.chain)
    spe = h.spec.preset.slots_per_epoch
    for step in range(2):
        for harness in (h, jh):
            if attesters is None:
                harness.extend_chain(spe)
                continue
            for _ in range(spe):
                harness.advance_slot()
                signed, _post = harness.produce_signed_block()
                harness.chain.process_block(signed)
                harness.attest_to_head(list(range(attesters)))
        assert h.chain.head().head_block_root == \
            jh.chain.head().head_block_root
        added = [m.update() for m in mons]
        assert added[0] == added[1] > 0
        got, want = (_rows(m) for m in mons)
        assert got == want, step
        assert len(got["canonical_blocks"]) == (step + 1) * spe + 1
    if attesters is not None:
        assert got["suboptimal_attestations"]
    epoch = h.chain.head().head_state.previous_epoch()
    assert mons[0].participation(epoch) == mons[1].participation(epoch)
    assert mons[0].blockprint_diversity() == mons[1].blockprint_diversity()


def test_watch_http_fronts_answer_the_same_bytes():
    h, jh = _twins()
    for harness in (h, jh):
        harness.extend_chain(h.spec.preset.slots_per_epoch + 3)
    mons = WatchMonitor(h.chain), JWatchMonitor(jh.chain)
    for m in mons:
        m.update()
    servers = WatchServer(mons[0]), JWatchServer(mons[1])
    for s in servers:
        s.start()
    epoch = h.chain.head().head_state.previous_epoch()
    try:
        for path in ("/v1/blocks?start=1&end=8", "/v1/blocks/5",
                     "/v1/validators/proposers", f"/v1/epochs/{epoch}",
                     "/v1/slots/missed?start=1&end=11",
                     "/v1/blockprint/blocks/3", "/v1/blockprint/diversity",
                     "/v1/blocks/packing?start=1&end=11",
                     f"/v1/epochs/{epoch}/suboptimal",
                     "/v1/validators/3/attestations"):
            got, want = (urllib.request.urlopen(
                f"http://127.0.0.1:{s.port}{path}").read() for s in servers)
            assert got == want, path
    finally:
        for s in servers:
            s.stop()
