"""The watch updater + queries (watch/src/{updater,database}).

Follows a chain (in-process or via the API backend), recording:
- canonical blocks: slot, proposer, attestation count, packing efficiency
  (fraction of available pool attestations included — block_packing),
- per-epoch participation balances (suboptimal_attestations analog),
- per-validator proposal counts,
- blockprint client classification: the reference's watch stores a
  per-block consensus-client guess from the external blockprint service
  (watch/src/blockprint); here the classifier is an in-process graffiti
  fingerprint with the same storage/query surface (per-block label +
  network diversity summary).
"""
from __future__ import annotations

import sqlite3
import threading

#: graffiti fingerprints -> consensus client (blockprint-style labels)
_CLIENT_PATTERNS = [
    (b"lighthouse_tpu", "LighthouseTpu"),
    (b"lighthouse", "Lighthouse"),
    (b"teku", "Teku"),
    (b"nimbus", "Nimbus"),
    (b"prysm", "Prysm"),
    (b"lodestar", "Lodestar"),
    (b"grandine", "Grandine"),
]


def classify_graffiti(graffiti: bytes) -> str:
    """Best-guess client label from the block graffiti (the in-process
    stand-in for the blockprint ML service's best_guess_single)."""
    low = bytes(graffiti).rstrip(b"\x00").lower()
    for pat, label in _CLIENT_PATTERNS:
        if pat in low:
            return label
    return "Unknown"


class WatchMonitor:
    def __init__(self, chain, db_path: str = ":memory:"):
        self.chain = chain
        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._lock = threading.Lock()
        self._db.executescript("""
        CREATE TABLE IF NOT EXISTS canonical_blocks (
            slot INTEGER PRIMARY KEY, root BLOB, proposer INTEGER,
            attestations INTEGER, deposits INTEGER, exits INTEGER,
            sync_participation REAL);
        CREATE TABLE IF NOT EXISTS epoch_summaries (
            epoch INTEGER PRIMARY KEY, active_balance INTEGER,
            target_balance INTEGER, participation_rate REAL,
            justified INTEGER, finalized INTEGER);
        CREATE TABLE IF NOT EXISTS proposer_counts (
            validator INTEGER PRIMARY KEY, proposals INTEGER);
        CREATE TABLE IF NOT EXISTS blockprint (
            slot INTEGER PRIMARY KEY, best_guess TEXT);
        CREATE TABLE IF NOT EXISTS block_packing (
            slot INTEGER PRIMARY KEY, included INTEGER,
            available INTEGER, efficiency REAL);
        CREATE TABLE IF NOT EXISTS suboptimal_attestations (
            epoch INTEGER, validator INTEGER, source INTEGER,
            target INTEGER, head INTEGER,
            PRIMARY KEY (epoch, validator));
        """)
        self._last_slot = -1

    # -- updater (watch/src/updater) -----------------------------------------

    def update(self) -> int:
        """Ingest new canonical blocks up to the head; returns rows added."""
        chain = self.chain
        head = chain.head()
        added = 0
        with self._lock:
            if head.head_state.slot <= self._last_slot:
                return 0           # nothing new: no summary, no commit
            for slot in range(self._last_slot + 1,
                              head.head_state.slot + 1):
                root = chain.block_root_at_slot(slot)
                if root is None:
                    continue
                blk = chain.store.get_block(root)
                if blk is None or blk.message.slot != slot:
                    continue
                body = blk.message.body
                sync_part = 0.0
                if hasattr(body, "sync_aggregate"):
                    bits = body.sync_aggregate.sync_committee_bits
                    sync_part = sum(1 for b in bits if b) / max(1, len(bits))
                self._db.execute(
                    "INSERT OR REPLACE INTO canonical_blocks VALUES "
                    "(?,?,?,?,?,?,?)",
                    (slot, root, blk.message.proposer_index,
                     len(body.attestations), len(body.deposits),
                     len(body.voluntary_exits), sync_part))
                self._db.execute(
                    "INSERT OR REPLACE INTO blockprint VALUES (?, ?)",
                    (slot, classify_graffiti(bytes(body.graffiti))))
                self._db.execute(
                    "INSERT INTO proposer_counts VALUES (?, 1) "
                    "ON CONFLICT(validator) DO UPDATE SET "
                    "proposals = proposals + 1",
                    (blk.message.proposer_index,))
                self._record_packing(slot, body, head.head_state)
                added += 1
            self._last_slot = head.head_state.slot
            self._update_epoch_summary(head.head_state)
            self._db.commit()
        return added

    def _record_packing(self, slot: int, body, head_state) -> None:
        """watch/src/block_packing: included attester seats vs the seats
        of the attestable window (prior epoch of slots).  Seats are
        deduplicated per (slot, committee) — overlapping aggregates for
        the same committee must not double-count."""
        from ..state_transition.helpers import is_active_validator_mask
        p = self.chain.spec.preset
        active = int(is_active_validator_mask(
            head_state, head_state.current_epoch()).sum())
        seats_per_slot = max(1, active // p.slots_per_epoch)
        union: dict[tuple, int] = {}
        for a in body.attestations:
            key = (int(a.data.slot), int(a.data.index))
            bits = 0
            for i, b in enumerate(a.aggregation_bits):
                if b:
                    bits |= 1 << i
            union[key] = union.get(key, 0) | bits
        included = sum(bin(v).count("1") for v in union.values())
        available = max(1, seats_per_slot * min(slot, p.slots_per_epoch))
        self._db.execute(
            "INSERT OR REPLACE INTO block_packing VALUES (?,?,?,?)",
            (slot, included, available,
             min(1.0, included / available)))

    def _update_epoch_summary(self, state) -> None:
        import numpy as np
        from ..specs.chain_spec import ForkName
        from ..state_transition.epoch import _unslashed_participating_mask
        from ..state_transition.helpers import (
            get_total_active_balance, is_active_validator_mask,
        )
        epoch = state.previous_epoch()
        active = get_total_active_balance(state)
        if state.fork_name >= ForkName.ALTAIR:
            mask = _unslashed_participating_mask(state, 1, epoch)
            target = int(state.validators.effective_balance[mask].sum())
            self._record_suboptimal(state, epoch)
        else:
            target = 0
        self._db.execute(
            "INSERT OR REPLACE INTO epoch_summaries VALUES (?,?,?,?,?,?)",
            (epoch, active, target,
             target / active if active else 0.0,
             state.current_justified_checkpoint.epoch,
             state.finalized_checkpoint.epoch))

    def _record_suboptimal(self, state, epoch: int) -> None:
        """watch/src/suboptimal_attestations: per-validator flag rows for
        every ACTIVE validator that missed source, target or head in the
        previous epoch (optimal attesters are not stored — the
        reference's space discipline).  The epoch's rows are rebuilt
        wholesale: participation keeps accruing through the inclusion
        window, so a validator recorded suboptimal early must drop out
        once its late attestation lands.  Only the head's previous epoch
        is reconstructible — `missing_epoch_summaries` exposes gaps from
        infrequent polling so 'no rows' is distinguishable from 'all
        optimal'."""
        import numpy as np
        from ..state_transition.helpers import is_active_validator_mask
        part = state.previous_epoch_participation
        if part is None:
            return
        part = np.asarray(part)
        active = np.asarray(is_active_validator_mask(state, epoch))
        suboptimal = active & ((part & 0b111) != 0b111)
        self._db.execute(
            "DELETE FROM suboptimal_attestations WHERE epoch = ?",
            (int(epoch),))
        for i in np.flatnonzero(suboptimal):
            flags = int(part[i])
            self._db.execute(
                "INSERT INTO suboptimal_attestations VALUES (?,?,?,?,?)",
                (int(epoch), int(i), flags & 1, (flags >> 1) & 1,
                 (flags >> 2) & 1))

    # -- queries (watch/src/server) ------------------------------------------

    def block_rewards_range(self, start_slot: int, end_slot: int):
        with self._lock:
            return list(self._db.execute(
                "SELECT slot, proposer, attestations, sync_participation "
                "FROM canonical_blocks WHERE slot BETWEEN ? AND ? "
                "ORDER BY slot", (start_slot, end_slot)))

    def participation(self, epoch: int):
        with self._lock:
            row = self._db.execute(
                "SELECT participation_rate, justified, finalized FROM "
                "epoch_summaries WHERE epoch = ?", (epoch,)).fetchone()
        return row

    def top_proposers(self, limit: int = 10):
        with self._lock:
            return list(self._db.execute(
                "SELECT validator, proposals FROM proposer_counts "
                "ORDER BY proposals DESC LIMIT ?", (limit,)))

    def blockprint_block(self, slot: int):
        with self._lock:
            row = self._db.execute(
                "SELECT best_guess FROM blockprint WHERE slot = ?",
                (slot,)).fetchone()
        return row[0] if row else None

    def blockprint_diversity(self):
        """Client share over all ingested blocks (watch blockprint's
        blocks_per_client)."""
        with self._lock:
            rows = list(self._db.execute(
                "SELECT best_guess, COUNT(*) FROM blockprint "
                "GROUP BY best_guess ORDER BY COUNT(*) DESC"))
        total = sum(n for _, n in rows) or 1
        return [{"client": c, "blocks": n, "share": n / total}
                for c, n in rows]

    def missed_slots(self, start_slot: int, end_slot: int) -> list[int]:
        with self._lock:
            have = {r[0] for r in self._db.execute(
                "SELECT slot FROM canonical_blocks WHERE slot BETWEEN ? "
                "AND ?", (start_slot, end_slot))}
        return [s for s in range(start_slot, end_slot + 1) if s not in have]

    def block_packing(self, start_slot: int, end_slot: int):
        with self._lock:
            return [{"slot": r[0], "included": r[1], "available": r[2],
                     "efficiency": r[3]}
                    for r in self._db.execute(
                        "SELECT slot, included, available, efficiency "
                        "FROM block_packing WHERE slot BETWEEN ? AND ? "
                        "ORDER BY slot", (start_slot, end_slot))]

    def suboptimal_at_epoch(self, epoch: int):
        """All suboptimal attesters for an epoch (missed flags)."""
        with self._lock:
            return [{"validator_index": r[0], "source": bool(r[1]),
                     "target": bool(r[2]), "head": bool(r[3])}
                    for r in self._db.execute(
                        "SELECT validator, source, target, head FROM "
                        "suboptimal_attestations WHERE epoch = ? "
                        "ORDER BY validator", (epoch,))]

    def missing_epoch_summaries(self, start_epoch: int,
                                end_epoch: int) -> list[int]:
        """Epochs with no summary row — update() only reconstructs the
        head's previous epoch, so infrequent polling leaves gaps that
        must be distinguishable from 'all validators optimal'."""
        with self._lock:
            have = {r[0] for r in self._db.execute(
                "SELECT epoch FROM epoch_summaries WHERE epoch BETWEEN "
                "? AND ?", (start_epoch, end_epoch))}
        return [e for e in range(start_epoch, end_epoch + 1)
                if e not in have]

    def validator_attestation_history(self, validator: int):
        with self._lock:
            return [{"epoch": r[0], "source": bool(r[1]),
                     "target": bool(r[2]), "head": bool(r[3])}
                    for r in self._db.execute(
                        "SELECT epoch, source, target, head FROM "
                        "suboptimal_attestations WHERE validator = ? "
                        "ORDER BY epoch", (validator,))]


class WatchServer:
    """HTTP front for the monitor DB (watch/src/server in the reference):

      GET /v1/blocks/{slot}            one canonical block row
      GET /v1/blocks?start=&end=       reward rows for a range
      GET /v1/validators/proposers     top proposers
      GET /v1/epochs/{epoch}           participation summary
      GET /v1/slots/missed?start=&end= missed slots
      GET /v1/blockprint/blocks/{slot} client guess for a block
      GET /v1/blockprint/diversity     client-share summary
    """

    def __init__(self, monitor: WatchMonitor, host: str = "127.0.0.1",
                 port: int = 0):
        import json
        import threading
        from http.server import (
            BaseHTTPRequestHandler, ThreadingHTTPServer,
        )
        from urllib.parse import parse_qs, urlparse
        mon = monitor

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                try:
                    mon.update()
                    if url.path == "/v1/blocks":
                        rows = mon.block_rewards_range(
                            int(q["start"][0]), int(q["end"][0]))
                        return self._json(200, {"data": [
                            {"slot": r[0], "proposer_index": r[1],
                             "attestations": r[2],
                             "sync_participation": r[3]} for r in rows]})
                    if url.path == "/v1/blocks/packing":
                        return self._json(200, {"data": mon.block_packing(
                            int(q["start"][0]), int(q["end"][0]))})
                    if url.path.startswith("/v1/blocks/"):
                        slot = int(url.path.rsplit("/", 1)[1])
                        rows = mon.block_rewards_range(slot, slot)
                        if not rows:
                            return self._json(404, {"message": "no block"})
                        r = rows[0]
                        return self._json(200, {"data": {
                            "slot": r[0], "proposer_index": r[1]}})
                    if url.path == "/v1/validators/proposers":
                        return self._json(200, {"data": [
                            {"validator_index": v, "blocks": n}
                            for v, n in mon.top_proposers(
                                int(q.get("limit", [10])[0]))]})
                    if url.path.startswith("/v1/epochs/") and \
                            url.path.endswith("/suboptimal"):
                        epoch = int(url.path.split("/")[3])
                        return self._json(200, {
                            "data": mon.suboptimal_at_epoch(epoch)})
                    if url.path.startswith("/v1/epochs/"):
                        epoch = int(url.path.rsplit("/", 1)[1])
                        part = mon.participation(epoch)
                        if part is None:
                            return self._json(404, {"message": "no epoch"})
                        return self._json(200, {"data": {
                            "epoch": epoch, "participation": part[0]}})
                    if url.path.startswith("/v1/blockprint/blocks/"):
                        slot = int(url.path.rsplit("/", 1)[1])
                        guess = mon.blockprint_block(slot)
                        if guess is None:
                            return self._json(404, {"message": "no block"})
                        return self._json(200, {"data": {
                            "slot": slot, "best_guess_single": guess}})
                    if url.path == "/v1/blockprint/diversity":
                        return self._json(
                            200, {"data": mon.blockprint_diversity()})
                    if url.path == "/v1/slots/missed":
                        return self._json(200, {"data": mon.missed_slots(
                            int(q["start"][0]), int(q["end"][0]))})
                    if url.path.startswith("/v1/validators/") and \
                            url.path.endswith("/attestations"):
                        v = int(url.path.split("/")[3])
                        return self._json(200, {
                            "data": mon.validator_attestation_history(v)})
                    return self._json(404, {"message": "route not found"})
                except Exception as e:
                    return self._json(400, {"message": repr(e)})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=2)
