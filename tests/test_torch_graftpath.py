"""graftpath's fleet helper on the port: ``simulator.write_stitched_trace``
renders a stitched capture as a Chrome trace, one pid a node.

The simulator case of the JAX package's tests/test_graftpath.py, run on
the port (imports switched to lighthouse_tpu_torch; the port on the CPU).
That file's other ``LocalNetwork`` case,
``test_stitcher_digest_deterministic_across_seeded_runs``, is not copied:
it fails in runs of the JAX package itself (two wall-clock fleet runs do
not always stitch to the same digest).
"""
import json
from pathlib import Path

import pytest

from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.obs import critpath
from lighthouse_tpu_torch.testing import simulator


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _synthetic_spans():
    """Publish on n0, pipeline on n1 with a fork (gossip_verify overlaps
    batch_signature), a join into a queued processor_work hop, and the
    import chain.  All times are exact multiples of 5 ms so the golden
    is stable under float rounding."""
    SV = critpath.SpanView
    return [
        SV("tA", "P", None, "gossip_publish", 0.000, 0.010,
           {"message_id": "m1", "node": "n0"}),
        SV("tB", "R", None, "block_pipeline", 0.020, 0.100,
           {"message_id": "m1", "node": "n1"}),
        SV("tB", "C1", "R", "gossip_verify", 0.020, 0.040),
        SV("tB", "C2", "R", "batch_signature", 0.025, 0.055),
        SV("tB", "W", "R", "processor_work", 0.060, 0.095,
           {"queue_wait_s": 0.005}),
        SV("tB", "I", "W", "block_import", 0.065, 0.090),
        SV("tB", "S", "I", "state_transition", 0.070, 0.085),
    ]


def test_write_stitched_trace_one_pid_per_node(tmp_path):
    path = simulator.write_stitched_trace(str(tmp_path / "fleet.json"),
                                          _synthetic_spans())
    doc = json.loads(Path(path).read_text())
    procs = {ev["args"]["name"] for ev in doc["traceEvents"]
             if ev["name"] == "process_name"}
    assert procs == {"n0", "n1"}
    slices = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    assert len(slices) == len(_synthetic_spans())
    # the propagation edge renders as a Perfetto flow arrow pair
    assert {ev["ph"] for ev in doc["traceEvents"]
            if ev.get("cat") == "graftpath"} == {"s", "f"}
