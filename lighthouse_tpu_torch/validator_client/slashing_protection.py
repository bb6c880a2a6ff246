"""SQLite slashing protection (EIP-3076 interchange format).

Equivalent of the reference's validator_client/slashing_protection: the
authoritative "don't double sign" database — checked on EVERY signature,
transactional, with interchange import/export.
"""
from __future__ import annotations

import json
import sqlite3
import threading


class SlashingError(Exception):
    pass


class SlashingDatabase:
    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._db.executescript("""
        CREATE TABLE IF NOT EXISTS validators (
            id INTEGER PRIMARY KEY, pubkey BLOB UNIQUE NOT NULL);
        CREATE TABLE IF NOT EXISTS signed_blocks (
            validator_id INTEGER NOT NULL REFERENCES validators(id),
            slot INTEGER NOT NULL, signing_root BLOB,
            UNIQUE (validator_id, slot));
        CREATE TABLE IF NOT EXISTS signed_attestations (
            validator_id INTEGER NOT NULL REFERENCES validators(id),
            source_epoch INTEGER NOT NULL, target_epoch INTEGER NOT NULL,
            signing_root BLOB, UNIQUE (validator_id, target_epoch));
        CREATE TABLE IF NOT EXISTS metadata (
            key TEXT PRIMARY KEY, value TEXT);
        """)
        self._db.commit()

    def register_validator(self, pubkey: bytes) -> int:
        with self._lock:
            cur = self._db.execute(
                "INSERT OR IGNORE INTO validators (pubkey) VALUES (?)",
                (pubkey,))
            self._db.commit()
            row = self._db.execute(
                "SELECT id FROM validators WHERE pubkey = ?",
                (pubkey,)).fetchone()
            return row[0]

    def _vid(self, pubkey: bytes) -> int | None:
        row = self._db.execute("SELECT id FROM validators WHERE pubkey = ?",
                               (pubkey,)).fetchone()
        return row[0] if row else None

    # -- blocks --------------------------------------------------------------

    def check_and_insert_block_proposal(self, pubkey: bytes, slot: int,
                                        signing_root: bytes) -> None:
        with self._lock:
            vid = self._vid(pubkey)
            if vid is None:
                raise SlashingError("unregistered validator")
            row = self._db.execute(
                "SELECT slot, signing_root FROM signed_blocks "
                "WHERE validator_id = ? AND slot = ?",
                (vid, slot)).fetchone()
            if row is not None:
                if row[1] == signing_root:
                    return  # same proposal, safe re-sign
                raise SlashingError(f"double block proposal at slot {slot}")
            low = self._db.execute(
                "SELECT MAX(slot) FROM signed_blocks WHERE validator_id = ?",
                (vid,)).fetchone()[0]
            if low is not None and slot <= low:
                raise SlashingError(
                    f"block slot {slot} not above previous {low}")
            self._db.execute(
                "INSERT INTO signed_blocks VALUES (?, ?, ?)",
                (vid, slot, signing_root))
            self._db.commit()

    # -- attestations --------------------------------------------------------

    def check_and_insert_attestation(self, pubkey: bytes, source_epoch: int,
                                     target_epoch: int,
                                     signing_root: bytes) -> None:
        if source_epoch > target_epoch:
            raise SlashingError("source after target")
        with self._lock:
            vid = self._vid(pubkey)
            if vid is None:
                raise SlashingError("unregistered validator")
            row = self._db.execute(
                "SELECT source_epoch, signing_root FROM signed_attestations "
                "WHERE validator_id = ? AND target_epoch = ?",
                (vid, target_epoch)).fetchone()
            if row is not None:
                if row[1] == signing_root:
                    return
                raise SlashingError(
                    f"double vote at target epoch {target_epoch}")
            # surround checks
            surrounding = self._db.execute(
                "SELECT 1 FROM signed_attestations WHERE validator_id = ? "
                "AND source_epoch < ? AND target_epoch > ?",
                (vid, source_epoch, target_epoch)).fetchone()
            if surrounding:
                raise SlashingError("attestation surrounded by prior vote")
            surrounded = self._db.execute(
                "SELECT 1 FROM signed_attestations WHERE validator_id = ? "
                "AND source_epoch > ? AND target_epoch < ?",
                (vid, source_epoch, target_epoch)).fetchone()
            if surrounded:
                raise SlashingError("attestation surrounds prior vote")
            self._db.execute(
                "INSERT INTO signed_attestations VALUES (?, ?, ?, ?)",
                (vid, source_epoch, target_epoch, signing_root))
            self._db.commit()

    # -- EIP-3076 interchange ------------------------------------------------

    def export_interchange(self, genesis_validators_root: bytes) -> dict:
        out = {"metadata": {
            "interchange_format_version": "5",
            "genesis_validators_root": "0x" + genesis_validators_root.hex()},
            "data": []}
        with self._lock:
            for vid, pk in self._db.execute(
                    "SELECT id, pubkey FROM validators"):
                blocks = [{"slot": str(s),
                           "signing_root": "0x" + (r or b"").hex()}
                          for s, r in self._db.execute(
                              "SELECT slot, signing_root FROM signed_blocks "
                              "WHERE validator_id = ?", (vid,))]
                atts = [{"source_epoch": str(s), "target_epoch": str(t),
                         "signing_root": "0x" + (r or b"").hex()}
                        for s, t, r in self._db.execute(
                            "SELECT source_epoch, target_epoch, signing_root "
                            "FROM signed_attestations WHERE validator_id = ?",
                            (vid,))]
                out["data"].append({"pubkey": "0x" + pk.hex(),
                                    "signed_blocks": blocks,
                                    "signed_attestations": atts})
        return out

    def import_interchange(self, data: dict,
                           genesis_validators_root: bytes) -> None:
        meta_root = bytes.fromhex(
            data["metadata"]["genesis_validators_root"][2:])
        if meta_root != genesis_validators_root:
            raise SlashingError("interchange for a different chain")
        for entry in data["data"]:
            pk = bytes.fromhex(entry["pubkey"][2:])
            self.register_validator(pk)
            for b in entry.get("signed_blocks", []):
                try:
                    self.check_and_insert_block_proposal(
                        pk, int(b["slot"]),
                        bytes.fromhex(b.get("signing_root", "0x")[2:]))
                except SlashingError:
                    pass  # keep the most restrictive record
            for a in entry.get("signed_attestations", []):
                try:
                    self.check_and_insert_attestation(
                        pk, int(a["source_epoch"]), int(a["target_epoch"]),
                        bytes.fromhex(a.get("signing_root", "0x")[2:]))
                except SlashingError:
                    pass
