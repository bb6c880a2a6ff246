"""Fault-injecting network fabric units (network/faults.py).

The injector's data plane is tested headless (send_fn lambdas — the
policy logic never touches sockets), then FaultyTransport is exercised
over real loopback TCP with the plaintext security upgrade, which the
fabric guarantees works without the cryptography package.  The same cases
as the JAX package's tests/test_faults.py, run on the port (imports
switched to lighthouse_tpu_torch).
"""
import time

import pytest

from lighthouse_tpu_torch.network.faults import (
    FaultInjector, FaultyTransport, LinkPolicy, PeerBehavior, ScenarioClock,
)


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


# -- headless injector data plane ---------------------------------------------

def _run_drops(seed: int, frames: int = 200) -> list[bool]:
    inj = FaultInjector(seed)
    inj.set_link("a", "b", LinkPolicy(drop_rate=0.5))
    delivered = []
    for i in range(frames):
        got = []
        inj.on_gossip_frame("a", "b", got.append, bytes([i % 256]))
        delivered.append(bool(got))
    return delivered


def test_drop_pattern_is_a_pure_function_of_the_seed():
    a, b = _run_drops(7), _run_drops(7)
    assert a == b
    assert a != _run_drops(8)
    dropped = a.count(False)
    assert 40 < dropped < 160         # drop_rate=0.5 actually drops
    inj = FaultInjector(7)
    inj.set_link("a", "b", LinkPolicy(drop_rate=0.5))
    for i in range(200):
        inj.on_gossip_frame("a", "b", lambda f: None, b"x")
    assert inj.frames_dropped == dropped


def test_default_link_is_transparent():
    inj = FaultInjector(0)
    got = []
    inj.on_gossip_frame("a", "b", got.append, b"hello")
    # unknown labels (None) are transparent too: un-registered peers
    # must never be faulted
    inj.on_gossip_frame("a", None, got.append, b"world")
    assert got == [b"hello", b"world"]
    assert inj.frames_dropped == inj.frames_delayed == 0


def test_delay_holds_frames_until_the_tick_releases_them():
    inj = FaultInjector(0)
    inj.set_link("a", "b", LinkPolicy(delay_ticks=2))
    got = []
    for i in range(3):
        inj.on_gossip_frame("a", "b", got.append, bytes([i]))
    assert got == [] and inj.frames_delayed == 3
    assert inj.tick() == 0            # tick 1: not due yet
    assert got == []
    assert inj.tick() == 3            # tick 2: all released, in order
    assert got == [b"\x00", b"\x01", b"\x02"]


def test_reorder_shuffles_a_release_batch_deterministically():
    def run(seed):
        inj = FaultInjector(seed)
        inj.set_link("a", "b", LinkPolicy(delay_ticks=1, reorder=True))
        got = []
        for i in range(16):
            inj.on_gossip_frame("a", "b", got.append, bytes([i]))
        inj.tick()
        assert inj.frames_reordered == 16
        return got

    first = run(3)
    assert sorted(first) == [bytes([i]) for i in range(16)]
    assert first == run(3)            # same seed, same shuffle
    assert first != run(4)


def test_heal_flushes_held_frames_in_submit_order():
    inj = FaultInjector(0)
    inj.set_link("a", "b", LinkPolicy(delay_ticks=50))
    got = []
    for i in range(4):
        inj.on_gossip_frame("a", "b", got.append, bytes([i]))
    assert got == []
    inj.heal()
    assert got == [bytes([i]) for i in range(4)]
    # policies cleared: the link is transparent again
    inj.on_gossip_frame("a", "b", got.append, b"post")
    assert got[-1] == b"post"


def test_peer_behavior_rejects_unknown_kind():
    with pytest.raises(ValueError):
        PeerBehavior("slowpoke")
    for kind in ("stall", "junk", "truncate", "trickle", "lying_status"):
        PeerBehavior(kind)                # every documented kind constructs


def test_lying_status_defaults_to_the_status_protocol():
    liar = PeerBehavior("lying_status", status_lie={"head_slot": 999})
    assert liar.protocols == ("status",)
    # an explicit protocol tuple is honored, not overwritten
    both = PeerBehavior("lying_status",
                        protocols=("status", "beacon_blocks_by_range"))
    assert both.protocols == ("status", "beacon_blocks_by_range")
    # non-status kinds keep the by_range default
    assert PeerBehavior("stall").protocols == ("beacon_blocks_by_range",)


def test_set_behavior_is_directed_and_clearable():
    inj = FaultInjector(0)
    b = PeerBehavior("junk")
    inj.set_behavior("a", "b", b)
    assert inj.behavior("a", "b") is b
    assert inj.behavior("b", "a") is None     # directed, not symmetric
    assert inj.behavior("a", None) is None    # unlabeled peers untouched
    assert inj.behavior(None, "b") is None
    inj.set_behavior("a", "b", None)
    assert inj.behavior("a", "b") is None


def test_heal_clears_behaviors_and_counts_survive():
    inj = FaultInjector(0)
    inj.set_behavior("a", "b", PeerBehavior("stall"))
    inj.note_behavior("stall")
    inj.heal()
    assert inj.behavior("a", "b") is None
    assert inj.behaviors_served == {"stall": 1}   # the ledger is history


def test_scenario_clock_is_explicit():
    clk = ScenarioClock(start=5)
    assert clk.tick == 5
    assert clk.advance(3) == 8
    inj = FaultInjector(0, clock=clk)
    assert inj.clock is clk


# -- FaultyTransport over real loopback sockets -------------------------------

def _pair(inj):
    ta = FaultyTransport("127.0.0.1", 0, security="plaintext",
                         injector=inj, label="a")
    tb = FaultyTransport("127.0.0.1", 0, security="plaintext",
                         injector=inj, label="b")
    ta.start()
    tb.start()
    return ta, tb


def test_plaintext_dial_and_partition_severs_and_refuses():
    inj = FaultInjector(0)
    ta, tb = _pair(inj)
    try:
        peer = ta.dial("127.0.0.1", tb.port)
        assert peer is not None
        assert _wait(lambda: ta.node_id in tb.peers)
        assert inj.label_of(ta.node_id) == "a"
        assert inj.label_of(tb.node_id) == "b"

        inj.partition(["a"], ["b"])
        # existing connections crossing the cut are closed...
        assert inj.links_severed >= 1
        assert _wait(lambda: not ta.peers and not tb.peers)
        # ...and new dials are refused without touching the socket
        refused_before = inj.dials_refused
        assert ta.dial("127.0.0.1", tb.port) is None
        assert inj.dials_refused > refused_before

        inj.heal()
        assert ta.dial("127.0.0.1", tb.port) is not None
        assert _wait(lambda: ta.node_id in tb.peers)
    finally:
        ta.stop()
        tb.stop()


def test_gossip_frames_cross_a_healthy_link_and_die_on_a_cut_one():
    from lighthouse_tpu_torch.network import gossipsub_pb as pb

    def rpc(data: bytes) -> bytes:
        return pb.frame(pb.Rpc(
            publish=[pb.PubMessage(topic="topic", data=data)]))

    inj = FaultInjector(0)
    ta, tb = _pair(inj)
    try:
        got = []
        tb.on_gossip_rpc = lambda peer, r: got.append(r)
        peer = ta.dial("127.0.0.1", tb.port)
        assert peer is not None and _wait(lambda: ta.node_id in tb.peers)

        peer.send_gossip_rpc(rpc(b"payload-1"))
        assert _wait(lambda: got)
        assert got[0].publish[0].data == b"payload-1"

        # a lossy link drops frames at the injector, not the socket
        inj.set_link("a", "b", LinkPolicy(drop_rate=1.0))
        dropped_before = inj.frames_dropped
        peer.send_gossip_rpc(rpc(b"payload-2"))
        assert inj.frames_dropped == dropped_before + 1
    finally:
        ta.stop()
        tb.stop()
