"""Fault-injecting network fabric: link control for adversarial scenarios.

Three pieces:

``ScenarioClock``
    A deterministic logical clock.  The scenario engine advances it
    explicitly (one tick per duty phase); nothing in the fabric reads
    wall time, so a run's fault schedule is a pure function of the seed
    and the tick sequence.

``FaultInjector``
    The shared link-control plane.  Every node's ``FaultyTransport``
    registers under a scenario-chosen label; per-directed-link
    ``LinkPolicy`` entries then drop, delay (released on later ticks),
    or reorder gossip RPC frames, and ``partition()`` cuts whole link
    sets — existing cross-partition connections are closed and new
    dials refused, which is how long partitions look on mainnet (TCP
    sessions die; reconnection attempts fail).  ``heal()`` clears every
    policy; re-dialing is the caller's job (LocalNetwork.heal) because
    only it knows the intended topology.

``FaultyTransport``
    A Transport subclass wired to the injector: dials consult the cut
    matrix, inbound upgrades of cut peers are refused post-handshake,
    and each registered peer's ``send_gossip_rpc`` is wrapped with the
    link policy.  Req/resp mux frames are still never dropped (that
    would corrupt the yamux state machine, not model a network fault) —
    instead the fabric adds *application-level* req/resp adversaries:

``PeerBehavior``
    A byzantine req/resp serving policy for one directed link,
    installed with ``injector.set_behavior(server, client, behavior)``
    the way gossip faults use ``set_link``.  The server's
    ``FaultyTransport`` intercepts inbound RPC streams from that client
    and serves them adversarially — ``stall`` (read the request, never
    answer, RST late), ``junk`` (answer with real decodable blocks from
    the WRONG slot range), ``truncate`` (serve then drop the tail of
    the chunk stream), ``trickle`` (slowloris: long pauses between
    chunks), ``lying_status`` (a fake-ahead STATUS) — while every other
    link is served honestly.  This is the fabric the byzantine sync
    scenarios point at range sync and backfill.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from . import rpc as rpc_mod
from .transport import Transport


class ScenarioClock:
    """Logical tick counter; advanced only by the scenario engine."""

    def __init__(self, start: int = 0):
        self.tick = start

    def advance(self, n: int = 1) -> int:
        self.tick += n
        return self.tick


_BEHAVIOR_KINDS = ("stall", "junk", "truncate", "trickle", "lying_status")


@dataclass
class PeerBehavior:
    """Byzantine req/resp serving policy for one directed link
    (server label -> client label).  The server still speaks the wire
    protocol correctly — chunk framing, result codes, snappy — so the
    client's decode succeeds and the *content* defenses (download-time
    validation, deadlines, STATUS sanity) are what must catch it.

    kinds:
      ``stall``        read the request, answer nothing, RST after
                       ``stall_secs`` (or when the peer/stream dies).
      ``junk``         serve real, decodable blocks from the WRONG slot
                       range (request shifted by ``slot_shift``, default
                       the request's own count) — guaranteed
                       ``out_of_range`` at download-time validation.
      ``truncate``     serve honestly but drop the tail of the chunk
                       stream, keeping ``keep_fraction`` of the chunks.
      ``trickle``      slowloris: sleep ``chunk_delay`` between chunks.
      ``lying_status`` answer STATUS with ``status_lie`` fields merged
                       over the honest response (fake-ahead head).
    """
    kind: str
    protocols: tuple = ("beacon_blocks_by_range",)
    stall_secs: float = 8.0
    keep_fraction: float = 0.5
    chunk_delay: float = 0.0
    slot_shift: int | None = None
    status_lie: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in _BEHAVIOR_KINDS:
            raise ValueError(f"unknown behavior kind {self.kind!r}")
        if self.kind == "lying_status" and \
                self.protocols == ("beacon_blocks_by_range",):
            # the default protocol tuple makes no sense for a STATUS liar
            self.protocols = ("status",)


@dataclass
class LinkPolicy:
    """Fault policy for one directed link (src label -> dst label)."""
    cut: bool = False           # refuse dials, close connections
    drop_rate: float = 0.0      # P(drop) per gossip RPC frame
    delay_ticks: int = 0        # hold frames for N scenario ticks
    reorder: bool = False       # shuffle frames released on the same tick

    @property
    def is_default(self) -> bool:
        return (not self.cut and self.drop_rate == 0.0
                and self.delay_ticks == 0 and not self.reorder)


class FaultInjector:
    """Seeded, deterministic link-control plane shared by every
    FaultyTransport in one scenario."""

    def __init__(self, seed: int = 0, clock: ScenarioClock | None = None):
        self.seed = seed
        self.rng = random.Random(seed)
        self.clock = clock or ScenarioClock()
        self._lock = threading.Lock()
        self._policies: dict[tuple[str, str], LinkPolicy] = {}
        self._behaviors: dict[tuple[str, str], PeerBehavior] = {}
        self._transports: dict[str, Transport] = {}
        self._labels: dict[str, str] = {}       # node_id hex -> label
        self._addrs: dict[tuple[str, int], str] = {}
        #: [(release_tick, seq, link, send_fn, frame)]
        self._delayed: list = []
        self._seq = 0
        # counters the scenarios assert on
        self.frames_dropped = 0
        self.frames_delayed = 0
        self.frames_reordered = 0
        self.dials_refused = 0
        self.links_severed = 0
        #: byzantine req/resp serves, by behavior kind
        self.behaviors_served: dict[str, int] = {}

    # -- registration --------------------------------------------------------

    def register(self, label: str, transport: Transport) -> None:
        with self._lock:
            self._transports[label] = transport
            self._labels[transport.node_id] = label
            self._addrs[(transport.host, transport.port)] = label

    def label_of(self, node_id: str) -> str | None:
        return self._labels.get(node_id)

    def label_at(self, host: str, port: int) -> str | None:
        return self._addrs.get((host, port))

    # -- policy --------------------------------------------------------------

    def policy(self, src: str | None, dst: str | None) -> LinkPolicy:
        if src is None or dst is None:
            return _DEFAULT
        return self._policies.get((src, dst), _DEFAULT)

    def set_link(self, src: str, dst: str, policy: LinkPolicy,
                 symmetric: bool = True) -> None:
        with self._lock:
            self._policies[(src, dst)] = policy
            if symmetric:
                self._policies[(dst, src)] = policy
        if policy.cut:
            self._sever(src, dst)
            if symmetric:
                self._sever(dst, src)

    def set_behavior(self, src: str, dst: str,
                     behavior: PeerBehavior | None) -> None:
        """Install (or clear, with None) a byzantine serving behavior on
        the directed link src -> dst: requests FROM dst are served
        adversarially BY src's transport.  Directed only — a byzantine
        server is byzantine toward a chosen victim, not symmetric."""
        with self._lock:
            if behavior is None:
                self._behaviors.pop((src, dst), None)
            else:
                self._behaviors[(src, dst)] = behavior

    def behavior(self, src: str | None, dst: str | None) \
            -> PeerBehavior | None:
        if src is None or dst is None:
            return None
        return self._behaviors.get((src, dst))

    def note_behavior(self, kind: str) -> None:
        with self._lock:
            self.behaviors_served[kind] = \
                self.behaviors_served.get(kind, 0) + 1

    def partition(self, *groups) -> None:
        """Cut every link between nodes in different label groups."""
        cut = LinkPolicy(cut=True)
        for i, ga in enumerate(groups):
            for gb in groups[i + 1:]:
                for a in ga:
                    for b in gb:
                        self.set_link(a, b, cut, symmetric=True)

    def heal(self) -> None:
        """Clear every policy and flush held frames (they were faulted
        while in flight; delivering them now models late arrival)."""
        with self._lock:
            self._policies.clear()
            self._behaviors.clear()
            due, self._delayed = self._delayed, []
        for _tick, _seq, _link, send_fn, frame in sorted(due,
                                                         key=lambda d: d[1]):
            try:
                send_fn(frame)
            except Exception:
                pass    # peer may be gone; gossip is lossy by contract

    def _note_refused(self) -> None:
        with self._lock:
            self.dials_refused += 1

    def _sever(self, src: str, dst: str) -> None:
        """Close existing connections crossing a newly-cut link."""
        t = self._transports.get(src)
        if t is None:
            return
        for peer in list(t.peers.values()):
            if self._labels.get(peer.node_id) == dst:
                with self._lock:
                    self.links_severed += 1
                peer.close()

    # -- the gossip-frame data plane -----------------------------------------

    def on_gossip_frame(self, src: str, dst: str | None, send_fn,
                        frame: bytes) -> None:
        pol = self.policy(src, dst)
        if pol.is_default:
            send_fn(frame)
            return
        with self._lock:
            if pol.cut or (pol.drop_rate and
                           self.rng.random() < pol.drop_rate):
                self.frames_dropped += 1
                return
            if pol.delay_ticks > 0:
                self._seq += 1
                self.frames_delayed += 1
                self._delayed.append((self.clock.tick + pol.delay_ticks,
                                      self._seq, (src, dst), send_fn, frame))
                return
        send_fn(frame)

    def tick(self, n: int = 1) -> int:
        """Advance the scenario clock and release due delayed frames.
        Release order is deterministic: by (due tick, submit order),
        except frames on a reordering link, which are shuffled with the
        seeded RNG within their release batch."""
        released = 0
        for _ in range(n):
            now = self.clock.advance()
            with self._lock:
                due = [d for d in self._delayed if d[0] <= now]
                self._delayed = [d for d in self._delayed if d[0] > now]
                due.sort(key=lambda d: (d[0], d[1]))
                by_link: dict[tuple, list] = {}
                for d in due:
                    by_link.setdefault(d[2], []).append(d)
                batches = []
                for link, items in sorted(by_link.items()):
                    if self.policy(*link).reorder and len(items) > 1:
                        self.rng.shuffle(items)
                        self.frames_reordered += len(items)
                    batches.extend(items)
            for _tick, _seq, _link, send_fn, frame in batches:
                released += 1
                try:
                    send_fn(frame)
                except Exception:
                    pass
        return released

    # -- dial/accept control (used by FaultyTransport) -----------------------

    def refuse_dial(self, src: str, host: str, port: int) -> bool:
        dst = self.label_at(host, port)
        if dst is not None and self.policy(src, dst).cut:
            self._note_refused()
            return True
        return False

    def refuse_peer(self, src: str, node_id: str) -> bool:
        dst = self.label_of(node_id)
        return dst is not None and self.policy(src, dst).cut


_DEFAULT = LinkPolicy()


# -- byzantine req/resp serving ----------------------------------------------

def _interruptible_sleep(peer, stream, secs: float) -> None:
    """Sleep up to `secs` on a server stream thread, waking early when
    the peer or stream dies so scenario teardown never blocks on us."""
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        if not getattr(peer, "alive", False) or stream.reset:
            return
        time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))


def _serve_byzantine(raw_serve, behavior: PeerBehavior, peer,
                     spec, stream) -> None:
    """Serve one inbound RPC stream adversarially.  Wire framing stays
    protocol-correct (the client must successfully DECODE the lie); only
    the content / timing is hostile."""
    if behavior.kind == "stall":
        # read the request so the client believes it was accepted, then
        # go silent; the client's per-request deadline is the defense
        try:
            if spec.name != "metadata":
                rpc_mod.read_payload(stream)
        except Exception:
            pass
        _interruptible_sleep(peer, stream, behavior.stall_secs)
        try:
            stream.rst()
        except Exception:
            pass
        return
    handlers = getattr(getattr(raw_serve, "__self__", None), "handlers", {})
    handler = handlers.get(spec.name)
    if handler is None:
        # no honest handler to pervert — fall back to the real server
        raw_serve(peer, spec.id, stream)
        return
    try:
        req_ssz = b"" if spec.name == "metadata" \
            else rpc_mod.read_payload(stream)
        req = spec.dec_req(req_ssz)
    except Exception:
        try:
            stream.rst()
        except Exception:
            pass
        return
    if behavior.kind == "junk" and isinstance(req, dict) \
            and "start_slot" in req:
        # shift the requested window so the HONEST handler serves real,
        # decodable, hash-linked blocks from the wrong range — the junk
        # that only download-time validation (out_of_range) can catch
        req = dict(req)
        start = int(req["start_slot"])
        shift = behavior.slot_shift if behavior.slot_shift is not None \
            else max(1, int(req.get("count", 1)))
        req["start_slot"] = start - shift if start >= shift \
            else start + shift
    try:
        resp = handler(peer, req)
    except Exception:
        try:
            stream.write(bytes([rpc_mod.RESULT_SERVER_ERROR]))
            rpc_mod.write_payload(stream, b"server error")
            stream.close()
        except Exception:
            pass
        return
    if behavior.kind == "lying_status" and isinstance(resp, dict) \
            and behavior.status_lie:
        resp = {**resp, **behavior.status_lie}
    try:
        if spec.chunked:
            chunks = list(resp or [])
            if behavior.kind == "truncate" and len(chunks) > 1:
                keep = max(1, int(len(chunks) * behavior.keep_fraction))
                chunks = chunks[:keep]
            for chunk_hex in chunks:
                raw = spec.enc_resp(chunk_hex)
                stream.write(bytes([rpc_mod.RESULT_SUCCESS]))
                if spec.context_bytes:
                    stream.write(raw[:4])
                    rpc_mod.write_payload(stream, raw[4:])
                else:
                    rpc_mod.write_payload(stream, raw)
                if behavior.kind == "trickle" and behavior.chunk_delay > 0:
                    _interruptible_sleep(peer, stream,
                                         behavior.chunk_delay)
        elif spec.expect_response or resp:
            stream.write(bytes([rpc_mod.RESULT_SUCCESS]))
            rpc_mod.write_payload(stream, spec.enc_resp(resp))
        stream.close()
    except Exception:
        pass        # client hung up mid-lie; nothing to clean


class FaultyTransport(Transport):
    """Transport with every fault choke point routed through a
    FaultInjector.  Constructed exactly like Transport plus
    (injector, label); registers itself on construction so the
    injector's address/label maps are complete before any dial."""

    def __init__(self, *args, injector: FaultInjector, label: str,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.injector = injector
        self.label = label
        injector.register(label, self)

    # `on_rpc_stream` is a plain attribute on Transport (assigned in
    # __init__, later overwritten by RpcHandler with its bound
    # serve_stream).  Making it a data descriptor here intercepts BOTH
    # assignments, so every inbound req/resp stream can be routed through
    # the injector's behavior table without RpcHandler knowing.
    @property
    def on_rpc_stream(self):
        raw = self._raw_on_rpc_stream
        injector = getattr(self, "injector", None)
        if injector is None:        # mid-super().__init__, before wiring
            return raw

        def serve(peer, protocol_id, stream):
            dst = injector.label_of(peer.node_id)
            behavior = injector.behavior(self.label, dst)
            spec = rpc_mod.BY_ID.get(protocol_id)
            if behavior is None or spec is None \
                    or spec.name not in behavior.protocols:
                raw(peer, protocol_id, stream)
                return
            injector.note_behavior(behavior.kind)
            _serve_byzantine(raw, behavior, peer, spec, stream)

        return serve

    @on_rpc_stream.setter
    def on_rpc_stream(self, fn) -> None:
        # runs during Transport.__init__ (default lambda) before
        # self.injector exists — must not touch injector state
        self._raw_on_rpc_stream = fn

    def dial(self, host: str, port: int):
        if self.injector.refuse_dial(self.label, host, port):
            return None
        return super().dial(host, port)

    def _register(self, peer) -> None:
        if self.injector.refuse_peer(self.label, peer.node_id):
            # an inbound upgrade (or a raced dial) crossed a cut link:
            # drop it post-handshake, exactly like a firewalled RST
            self.injector._note_refused()
            peer.close()
            return
        raw_send = peer.send_gossip_rpc
        peer.send_gossip_rpc = lambda framed: self.injector.on_gossip_frame(
            self.label, self.injector.label_of(peer.node_id), raw_send,
            framed)
        super()._register(peer)
