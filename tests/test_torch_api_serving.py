"""Serving-tier tests.

Covers the four core behaviours — single-flight coalescing,
fork-aware response-cache invalidation, priority shedding, and
pre-encoded-byte equality with the uncached path — plus the
surfaces: HTTP keep-alive / idle timeout / connection cap, the
attester-cache prime coalescing in the backend, the serving SLOs, and
the flight-recorder/doctor serving section.

The same cases as the JAX package's tests/test_api_serving.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after the module).
"""
import http.client
import json
import socket
import threading
import time

import pytest

from lighthouse_tpu_torch.api import ApiBackend, BeaconApiServer
from lighthouse_tpu_torch.api.serving import (
    BLOCKS, BULK, CRITICAL, AdmissionQueue, ResponseCache, ServingTier,
    ShedError,
)
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.obs import doctor, graftwatch, slo, timeseries
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.ssz import serialize
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


def _wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, body


@pytest.fixture(scope="module")
def harness():
    bls.set_backend("fake")
    h = BeaconChainHarness(minimal_spec(), 64)
    h.extend_chain(10)
    return h


@pytest.fixture(scope="module")
def server(harness):
    srv = BeaconApiServer(ApiBackend(harness.chain))
    srv.start()
    yield srv
    srv.stop()


class _SlowBackend:
    """Chainless backend stub: 150 ms per duties computation, counted."""

    def __init__(self, delay=0.15):
        self.delay = delay
        self.calls = 0
        self._lock = threading.Lock()

    def get_proposer_duties(self, epoch):
        with self._lock:
            self.calls += 1
        time.sleep(self.delay)
        return [[epoch * 8 + i, i] for i in range(8)]

    def headers(self, slot, parent_root):
        return []


# -- coalescing --------------------------------------------------------------

def test_concurrent_identical_requests_share_one_backend_call():
    be = _SlowBackend()
    tier = ServingTier(be)
    n = 8
    barrier = threading.Barrier(n)
    bodies = []
    errs = []

    def worker():
        try:
            barrier.wait()
            bodies.append(tier.proposer_duties(3).body)
        except Exception as e:  # pragma: no cover - surfaced via assert
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not errs
    assert be.calls == 1
    assert len(bodies) == n and len(set(bodies)) == 1
    snap = tier.snapshot()
    # every non-leader either coalesced into the flight or hit the
    # cache the leader populated; nobody recomputed
    assert snap["coalesced"] + snap["cache_hits"] == n - 1
    assert snap["flights"] == 1
    assert snap["requests"] == n


def test_sequential_repeat_is_a_cache_hit():
    be = _SlowBackend(delay=0.0)
    tier = ServingTier(be)
    b1 = tier.proposer_duties(5).body
    b2 = tier.proposer_duties(5).body
    assert b1 == b2
    assert be.calls == 1
    assert tier.cache.hits == 1


# -- fork-aware invalidation -------------------------------------------------

def test_stale_head_entry_is_never_served():
    be = _SlowBackend(delay=0.0)
    tier = ServingTier(be)
    tier.proposer_duties(1)
    tier.proposer_duties(1)
    assert be.calls == 1
    # the head moves: lookups key on the new root, so the old entry is
    # structurally unreachable even before any pruning runs
    tier.static_head_root = b"\x11" * 32
    tier.proposer_duties(1)
    assert be.calls == 2
    assert len(tier.cache) == 2
    pruned = tier.cache.on_head_change(b"\x11" * 32)
    assert pruned == 1
    assert len(tier.cache) == 1


def test_head_event_prunes_entries_built_under_old_head():
    bls.set_backend("fake")
    h = BeaconChainHarness(minimal_spec(), 64)
    h.extend_chain(3)
    tier = ServingTier(ApiBackend(h.chain))
    tier.proposer_duties(0)
    assert len(tier.cache) == 1
    # a new block moves the head; the chain's head event reaches the
    # tier's listener and drops every old-head entry
    h.extend_chain(1)
    assert len(tier.cache) == 0
    assert tier.cache.invalidated >= 1
    # the next request recomputes under the new head and re-caches
    tier.proposer_duties(0)
    assert len(tier.cache) == 1


def test_response_cache_is_bounded():
    c = ResponseCache(capacity=2)
    for i in range(3):
        c.put("ep", (i,), b"h", object())
    assert len(c) == 2
    assert c.get("ep", (0,), b"h") is None  # oldest evicted
    assert c.get("ep", (2,), b"h") is not None


# -- priority shedding -------------------------------------------------------

def test_admission_queue_sheds_lowest_priority_first():
    q = AdmissionQueue(workers=1, capacity=2)
    q.acquire(CRITICAL)            # occupy the only worker slot
    order, shed = [], []

    def waiter(prio, tag):
        try:
            q.acquire(prio)
            order.append(tag)
            q.release()
        except ShedError:
            shed.append(tag)

    t_bulk = threading.Thread(target=waiter, args=(BULK, "bulk"))
    t_bulk.start()
    assert _wait_until(lambda: q.depth() == 1)
    t_blocks = threading.Thread(target=waiter, args=(BLOCKS, "blocks"))
    t_blocks.start()
    assert _wait_until(lambda: q.depth() == 2)
    # waiting list full: an incoming CRITICAL evicts the worst waiter
    t_crit = threading.Thread(target=waiter, args=(CRITICAL, "critical"))
    t_crit.start()
    assert _wait_until(lambda: shed == ["bulk"])
    assert q.depth() == 2
    # an incoming BULK is no better than any waiter: shed on arrival
    with pytest.raises(ShedError):
        q.acquire(BULK)
    # slot transfer on release: best waiter first (CRITICAL, then BLOCKS)
    q.release()
    for t in (t_bulk, t_blocks, t_crit):
        t.join(timeout=10)
    assert order == ["critical", "blocks"]
    assert q.shed_counts[BULK] == 2
    assert q.high_water == 2
    assert q.depth() == 0 and q.active == 0


def test_tier_sheds_bulk_under_pressure_and_counts_it():
    class _GateBackend:
        def __init__(self):
            self.entered = threading.Event()
            self.gate = threading.Event()

        def get_proposer_duties(self, epoch):
            self.entered.set()
            self.gate.wait(10)
            return [[1, 1]]

        def headers(self, slot, parent_root):
            return []

        def light_client_finality_update(self):
            return None

    be = _GateBackend()
    tier = ServingTier(be, queue_workers=1, queue_capacity=1)
    t1 = threading.Thread(target=tier.proposer_duties, args=(1,))
    t1.start()
    assert be.entered.wait(5)                   # t1 holds the worker
    t2 = threading.Thread(target=tier.headers, args=(None, None))
    t2.start()
    assert _wait_until(lambda: tier.queue.depth() == 1)
    with pytest.raises(ShedError):              # queue full, BULK worst
        tier.light_client_finality_update()
    be.gate.set()
    t1.join(timeout=10)
    t2.join(timeout=10)
    snap = tier.snapshot()
    assert snap["shed"] == {"critical": 0, "blocks": 0, "bulk": 1}
    assert snap["shed_total"] == 1


# -- pre-encoded bytes over the real HTTP server -----------------------------

def test_cached_bytes_equal_uncached_rendering(server, harness):
    path = "/eth/v1/validator/attestation_data?slot=10&committee_index=0"
    st1, body1 = _get(server.port, path)
    st2, body2 = _get(server.port, path)
    assert st1 == st2 == 200
    assert body1 == body2
    data = ApiBackend(harness.chain).attestation_data(10, 0)
    expected = json.dumps(
        {"data": {"ssz": serialize(type(data).ssz_type, data).hex()}}
    ).encode()
    assert body1 == expected
    assert server.serving.cache.hits >= 1


# -- keep-alive / idle timeout / connection cap ------------------------------

def test_keep_alive_reuses_one_tcp_connection(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                      timeout=10)
    conn.request("GET", "/eth/v1/beacon/headers?slot=10")
    r1 = conn.getresponse()
    r1.read()
    assert r1.status == 200
    sock = conn.sock
    assert sock is not None
    conn.request("GET", "/eth/v1/beacon/headers?slot=10")
    r2 = conn.getresponse()
    r2.read()
    assert r2.status == 200
    assert conn.sock is sock       # same TCP connection, no reconnect
    conn.close()


def test_idle_connection_is_closed_after_timeout(harness):
    srv = BeaconApiServer(ApiBackend(harness.chain), idle_timeout=0.3)
    srv.start()
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        s.settimeout(10)
        s.sendall(b"GET /eth/v1/beacon/headers?slot=1 HTTP/1.1\r\n"
                  b"Host: x\r\n\r\n")
        first = s.recv(65536)
        assert first.startswith(b"HTTP/1.1 200")
        time.sleep(1.0)            # > idle_timeout with margin
        closed = False
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if s.recv(65536) == b"":
                closed = True
                break
        assert closed
        s.close()
    finally:
        srv.stop()


def test_connection_over_cap_gets_raw_503(harness):
    srv = BeaconApiServer(ApiBackend(harness.chain), max_connections=1)
    srv.start()
    try:
        c1 = http.client.HTTPConnection("127.0.0.1", srv.port,
                                        timeout=10)
        c1.request("GET", "/eth/v1/beacon/headers?slot=1")
        r1 = c1.getresponse()
        r1.read()
        assert r1.status == 200
        # c1's keep-alive handler thread still holds the only slot
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        s.settimeout(10)
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
        assert data.startswith(b"HTTP/1.1 503")
        s.close()
        c1.close()
    finally:
        srv.stop()


# -- attester-cache prime coalescing (backend.py) ----------------------------

def test_attester_prime_runs_once_for_concurrent_misses(harness,
                                                        monkeypatch):
    chain = harness.chain
    be = ApiBackend(chain)
    # force the slow path: both fast caches miss for the whole test
    monkeypatch.setattr(chain.early_attester_cache, "try_attest",
                        lambda *a, **k: None)
    monkeypatch.setattr(chain.attester_cache, "attestation_data",
                        lambda *a, **k: None)
    calls = []
    orig = chain.attester_cache.cache_state

    def counting_cache_state(c, st):
        time.sleep(0.25)      # hold the flight open so every thread
        calls.append(1)       # arrives while the leader is priming
        return orig(c, st)

    monkeypatch.setattr(chain.attester_cache, "cache_state",
                        counting_cache_state)
    slot = int(chain.head().head_state.slot) + 1
    n = 8
    barrier = threading.Barrier(n)
    results = []
    errs = []

    def worker():
        try:
            barrier.wait()
            d = be.attestation_data(slot, 0)
            results.append(bytes(serialize(type(d).ssz_type, d)))
        except Exception as e:  # pragma: no cover - surfaced via assert
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs
    assert len(calls) == 1     # one replay primed the cache for all 8
    assert len(results) == n and len(set(results)) == 1


# -- SLOs and flight recorder ------------------------------------------------

def test_serving_slos_open_and_resolve():
    sampler = timeseries.SlotSampler()
    engine = slo.SLOEngine(sampler)
    sampler.record("counter", "api_requests_total", 10)
    sampler.record("counter", "api_shed_total", 8)
    for _ in range(3):
        sampler.record("hist", "api_request_seconds", 0.9)
    sampler.sample(1)
    opened = {i.slo for i in engine.evaluate(1)}
    assert {"serving_p95", "serving_shed_rate"} <= opened
    # two clean slots (no serving traffic) resolve both incidents
    sampler.sample(2)
    engine.evaluate(2)
    sampler.sample(3)
    engine.evaluate(3)
    still_open = {i.slo for i in engine.open_incidents()}
    assert not still_open & {"serving_p95", "serving_shed_rate"}


def test_flight_dump_and_doctor_render_serving_section():
    be = _SlowBackend(delay=0.0)
    tier = ServingTier(be)
    tier.proposer_duties(7)
    tier.proposer_duties(7)
    doc = graftwatch.get().recorder.build(reason="test")
    sections = doc.get("serving") or []
    snap = tier.snapshot()
    assert any(s.get("requests") == snap["requests"]
               and s.get("cache_hits") == snap["cache_hits"]
               and "cache_hit_ratio" in s and "shed" in s
               for s in sections if isinstance(s, dict))
    text = doctor.render(doctor.diagnose(doc))
    assert "serving:" in text
