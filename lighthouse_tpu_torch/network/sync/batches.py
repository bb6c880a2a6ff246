"""Batch lifecycle state machine shared by range sync and backfill.

Equivalent of the reference's per-batch state machine
(network/src/sync/range_sync/batch.rs: AwaitingDownload -> Downloading ->
AwaitingProcessing -> Processing -> {AwaitingValidation, Failed}), redesigned
as an explicit enum + attempt bookkeeping.  A batch remembers every peer that
served or failed it so retries rotate through the pool, and it permanently
fails after bounded download/processing attempts — the chain then drops and
the pool is penalized by the owner.
"""
from __future__ import annotations

from enum import Enum


class BatchState(Enum):
    AWAITING_DOWNLOAD = "awaiting_download"
    DOWNLOADING = "downloading"
    AWAITING_PROCESSING = "awaiting_processing"
    PROCESSING = "processing"
    PROCESSED = "processed"
    FAILED = "failed"


class Batch:
    """One epoch-aligned span of slots moving through download/processing."""

    MAX_DOWNLOAD_ATTEMPTS = 5
    MAX_PROCESSING_ATTEMPTS = 3

    def __init__(self, batch_id: int, start_slot: int, count: int):
        self.id = batch_id
        self.start_slot = start_slot
        self.count = count
        self.state = BatchState.AWAITING_DOWNLOAD
        self.blocks: list = []
        self.peer: str | None = None          # current / last serving peer
        self.attempted_peers: set[str] = set()
        self.download_attempts = 0
        self.processing_attempts = 0
        self.req_id: int | None = None

    # -- transitions ---------------------------------------------------------

    def start_download(self, peer: str, req_id: int) -> None:
        assert self.state == BatchState.AWAITING_DOWNLOAD, self.state
        self.state = BatchState.DOWNLOADING
        self.peer = peer
        self.req_id = req_id
        self.attempted_peers.add(peer)
        self.download_attempts += 1

    def download_failed(self) -> BatchState:
        """Download error/timeout: back to the queue or FAILED out."""
        assert self.state == BatchState.DOWNLOADING, self.state
        self.req_id = None
        if self.download_attempts >= self.MAX_DOWNLOAD_ATTEMPTS:
            self.state = BatchState.FAILED
        else:
            self.state = BatchState.AWAITING_DOWNLOAD
        return self.state

    def downloaded(self, blocks: list) -> None:
        assert self.state == BatchState.DOWNLOADING, self.state
        self.req_id = None
        self.blocks = blocks
        self.state = BatchState.AWAITING_PROCESSING

    def start_processing(self) -> list:
        assert self.state == BatchState.AWAITING_PROCESSING, self.state
        self.state = BatchState.PROCESSING
        self.processing_attempts += 1
        return self.blocks

    def processed(self) -> None:
        assert self.state == BatchState.PROCESSING, self.state
        self.blocks = []
        self.state = BatchState.PROCESSED

    def processing_failed(self) -> BatchState:
        """Invalid segment: the serving peer lied (or an ancestor batch
        did) — re-download from a different peer, or FAIL the batch after
        MAX_PROCESSING_ATTEMPTS (the owner drops the whole chain)."""
        assert self.state == BatchState.PROCESSING, self.state
        self.blocks = []
        if self.processing_attempts >= self.MAX_PROCESSING_ATTEMPTS:
            self.state = BatchState.FAILED
        else:
            self.state = BatchState.AWAITING_DOWNLOAD
        return self.state

    # -- helpers -------------------------------------------------------------

    def pick_peer(self, pool: list[str], salt: int = 0) -> str | None:
        """Prefer a pool peer that has never touched this batch; fall back
        to any pool peer (the batch may outlive fresh peers).  `salt`
        (seeded on attempt count + batch id by callers) rotates the pick
        so a deterministic `pool[0]` can't retry the same failed peer
        forever."""
        fresh = [p for p in pool if p not in self.attempted_peers]
        if fresh:
            return fresh[salt % len(fresh)]
        return pool[salt % len(pool)] if pool else None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Batch({self.id}, slots=[{self.start_slot},"
                f"{self.start_slot + self.count}), {self.state.value},"
                f" dl={self.download_attempts}, pr={self.processing_attempts})")
