"""Peer scoring + lifecycle (peer_manager/peerdb/score.rs equivalent)."""
from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field


def _metrics():
    """metrics_defs, sys.modules-gated (wire tests run the network layer
    without the metrics stack); a module still mid-import reads as
    absent so racing network threads never see a half-built module."""
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    return md if hasattr(md, "count") and hasattr(md, "gauge") else None


@dataclass
class PeerInfo:
    node_id: str
    connected_at: float = field(default_factory=time.monotonic)
    score: float = 0.0
    status: object = None          # last StatusMessage
    banned: bool = False


class PeerManager:
    BAN_THRESHOLD = -20.0
    # IGNORE is benign by the gossipsub validation contract (duplicates,
    # not-yet-known head blocks): penalizing it makes every long-lived
    # honest connection drift toward the ban threshold, since aggregates
    # routinely cover already-seen attestations.  Only REJECT (provably
    # invalid) and protocol abuse carry weight.
    # Sync failure reasons carry distinct weights:
    # a peer that *disconnected* mid-request is barely at fault
    # (peer_gone), a stalled request is protocol abuse lighter than junk
    # (stall), and a payload we could not even decode is near-certain
    # malice (decode_error).  "shutdown" is OUR close path and must never
    # reach report() — machines skip the penalty entirely.
    SCORES = {"reject": -5.0, "ignore": 0.0, "accept": 0.1,
              "rate_limited": -1.0, "timeout": -2.0, "bad_segment": -10.0,
              "empty_batch": -3.0, "peer_gone": -0.5, "stall": -3.0,
              "decode_error": -6.0, "truncated_batch": -6.0}

    def __init__(self, target_peers: int = 16):
        self.peers: dict[str, PeerInfo] = {}
        self.target_peers = target_peers
        self._lock = threading.Lock()
        self.on_ban = lambda node_id: None

    def on_connect(self, node_id: str) -> None:
        with self._lock:
            new = node_id not in self.peers
            self.peers.setdefault(node_id, PeerInfo(node_id))
            n = len(self.peers)
        md = _metrics()
        if md is not None:
            if new:
                md.count("libp2p_peer_connect_total")
            md.gauge("libp2p_peers", n)

    def on_disconnect(self, node_id: str) -> None:
        with self._lock:
            gone = self.peers.pop(node_id, None)
            n = len(self.peers)
        md = _metrics()
        if md is not None:
            if gone is not None:
                md.count("libp2p_peer_disconnect_total")
            md.gauge("libp2p_peers", n)

    def set_status(self, node_id: str, status) -> None:
        with self._lock:
            info = self.peers.get(node_id)
            if info:
                info.status = status

    def report(self, node_id: str, event: str) -> None:
        delta = self.SCORES.get(event, 0.0)
        ban = False
        with self._lock:
            info = self.peers.get(node_id)
            if info is None:
                return
            info.score += delta
            if info.score < self.BAN_THRESHOLD and not info.banned:
                info.banned = True
                ban = True
        if ban:
            self.on_ban(node_id)

    def score(self, node_id: str) -> float:
        with self._lock:
            info = self.peers.get(node_id)
            return info.score if info is not None else 0.0

    def connected(self) -> list[PeerInfo]:
        with self._lock:
            return [p for p in self.peers.values() if not p.banned]

    def best_peer_for_sync(self) -> PeerInfo | None:
        best, best_slot = None, -1
        for p in self.connected():
            if p.status is not None and p.status.head_slot > best_slot:
                best, best_slot = p, p.status.head_slot
        return best
