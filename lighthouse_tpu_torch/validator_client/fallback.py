"""Multi-beacon-node failover.

Equivalent of the reference's validator_client/src/beacon_node_fallback.rs:
an ordered BN list, health-checked and re-sorted; operations walk the list
until one succeeds; broadcast-capable for publish operations.
"""
from __future__ import annotations

import time


class BeaconNodeFallback:
    def __init__(self, nodes: list):
        self.nodes = list(nodes)
        self.health: dict[int, bool] = {i: True for i in range(len(nodes))}
        self.last_check: float = 0.0

    def check_health(self) -> None:
        for i, node in enumerate(self.nodes):
            try:
                ok = node.is_healthy()
            except Exception:
                ok = False
            self.health[i] = ok
        self.last_check = time.monotonic()
        # healthy nodes first, stable order otherwise
        order = sorted(range(len(self.nodes)),
                       key=lambda i: (not self.health[i], i))
        self.nodes = [self.nodes[i] for i in order]
        self.health = {i: self.health.get(j, True)
                       for i, j in enumerate(order)}

    def first_success(self, fn_name: str, *args, **kwargs):
        """Try each node in order; return the first success."""
        last_err: Exception | None = None
        for i, node in enumerate(self.nodes):
            try:
                out = getattr(node, fn_name)(*args, **kwargs)
                self.health[i] = True
                return out
            except Exception as e:
                self.health[i] = False
                last_err = e
        raise last_err if last_err else RuntimeError("no beacon nodes")

    def broadcast(self, fn_name: str, *args, **kwargs) -> int:
        """Publish to every node; returns success count."""
        ok = 0
        for node in self.nodes:
            try:
                getattr(node, fn_name)(*args, **kwargs)
                ok += 1
            except Exception:
                pass
        return ok
