"""Block lookups: by-root resolution of unknown blocks and parent chains.

Equivalent of the reference's lookup machinery (network/src/sync/
block_lookups/mod.rs): a gossip block whose parent is unknown — or an
attestation referencing an unknown root — triggers a by-root lookup that
walks parents until it connects to the known chain, then imports the
accumulated segment oldest-first.  Guarantees mirrored from the reference:

- concurrent lookups are deduplicated (a second trigger for the same root
  or for any root already inside a walking chain just adds its peer to the
  pool);
- parent walks are depth-limited (PARENT_DEPTH_TOLERANCE) so a malicious
  peer can't lead us down an endless bogus ancestry — the lookup dies and
  every serving peer is penalized;
- request failures rotate through the lookup's peer pool with bounded
  attempts;
- invalid segments penalize the peers that served the blocks.
"""
from __future__ import annotations

import sys


def _count(name: str, amount: float = 1) -> None:
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    count = getattr(md, "count", None)
    if count is not None:
        count(name, amount)


class Lookup:
    MAX_ATTEMPTS = 4

    def __init__(self, lookup_id: int, root: bytes, peer_id: str,
                 depth_limit: int | None = None):
        self.id = lookup_id
        self.original_root = root
        self.awaiting = root              # next root to fetch
        self.peers: set[str] = {peer_id}
        self.chain: list = []             # (root, block), newest first
        self.served_by: set[str] = set()
        self.attempts = 0
        self.req_id: int | None = None
        self.depth_limit = depth_limit

    def pick_peer(self) -> str | None:
        """Rotate by attempt count so exhausted-pool retries walk the
        pool instead of hammering the same (possibly failed) peer."""
        fresh = sorted(self.peers - self.served_by)
        if fresh:
            return fresh[self.attempts % len(fresh)]
        pool = sorted(self.peers)
        return pool[self.attempts % len(pool)] if pool else None


class BlockLookups:
    PARENT_DEPTH_TOLERANCE = 32
    MAX_CONCURRENT = 64

    def __init__(self, ctx):
        self.ctx = ctx
        self.lookups: dict[int, Lookup] = {}
        self.requests: dict[int, int] = {}    # req_id -> lookup_id
        self._next_id = 0
        self.imported = 0

    # -- triggers ------------------------------------------------------------

    def search(self, root: bytes, peer_id: str,
               max_depth: int | None = None) -> None:
        """Start (or join) a lookup for `root`."""
        if self.ctx.block_known(root):
            return
        for lk in self.lookups.values():
            if lk.awaiting == root or lk.original_root == root or any(
                    r == root for r, _b in lk.chain):
                lk.peers.add(peer_id)
                return
        if len(self.lookups) >= self.MAX_CONCURRENT:
            return
        lk = Lookup(self._next_id, root, peer_id, depth_limit=max_depth)
        self._next_id += 1
        self.lookups[lk.id] = lk
        _count("sync_parent_lookups_total")
        self._request(lk)

    def _request(self, lk: Lookup) -> None:
        peer = lk.pick_peer()
        if peer is None or lk.attempts >= Lookup.MAX_ATTEMPTS:
            self.lookups.pop(lk.id, None)
            return
        lk.attempts += 1
        req_id = self.ctx.send_root(peer, lk.awaiting, self)
        lk.req_id = req_id
        lk.served_by.add(peer)
        self.requests[req_id] = lk.id

    # -- events --------------------------------------------------------------

    def on_root_response(self, req_id: int, block, peer_id: str,
                         reason: str = "timeout") -> None:
        """block=None means error/timeout/empty — rotate peers.  `reason`
        distinguishes peer_gone / decode_error / stall (distinct penalty
        weights) and "shutdown" (our close path: no penalty, no retry)."""
        lid = self.requests.pop(req_id, None)
        if lid is None:
            return
        lk = self.lookups.get(lid)
        if lk is None:
            return
        lk.req_id = None
        if block is None:
            if reason == "shutdown":
                self.lookups.pop(lk.id, None)
                return
            self.ctx.penalize(peer_id, reason)
            self._request(lk)
            return
        if self.ctx.block_root(block) != lk.awaiting:
            # peer answered with a different block than asked
            self.ctx.penalize(peer_id, "bad_segment")
            self._request(lk)
            return
        if block.message.slot <= self.ctx.finalized_slot():
            # an unknown block at/below the finalized slot can never join
            # the canonical chain: remember the root so gossip referencing
            # it is rejected instantly (pre_finalization_cache.rs)
            self.ctx.note_pre_finalization(lk.awaiting)
            self.ctx.penalize(peer_id, "ignore")
            self.lookups.pop(lk.id, None)
            return
        lk.chain.append((lk.awaiting, block))
        parent = block.message.parent_root
        if self.ctx.block_known(parent):
            self._import(lk)
            return
        limit = min(lk.depth_limit or self.PARENT_DEPTH_TOLERANCE,
                    self.PARENT_DEPTH_TOLERANCE)
        if len(lk.chain) >= limit:
            # endless bogus ancestry: drop and penalize every server
            for p in sorted(lk.served_by):
                self.ctx.penalize(p, "bad_segment")
            self.lookups.pop(lk.id, None)
            return
        lk.awaiting = parent
        lk.attempts = 0                    # fresh target, fresh attempts
        self._request(lk)

    def _import(self, lk: Lookup) -> None:
        self.lookups.pop(lk.id, None)
        blocks = [b for _r, b in reversed(lk.chain)]   # oldest first
        imported, err = self.ctx.process_segment(blocks)
        if err is None:
            self.imported += imported
            self.ctx.on_lookup_imported(lk.original_root)
        else:
            for p in sorted(lk.served_by):
                self.ctx.penalize(p, "bad_segment")

    @property
    def in_flight(self) -> int:
        return len(self.requests)
