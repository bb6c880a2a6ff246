"""Typed Beacon-API HTTP client.

Equivalent of the reference's common/eth2 (BeaconNodeHttpClient,
src/lib.rs:158): the VC-facing client implementing BeaconNodeInterface over
HTTP, so `ValidatorClient` runs identically in-process or against a remote
beacon node.
"""
from __future__ import annotations

import http.client
import json
import time
from urllib.parse import urlencode, urlparse

from ..containers import get_types
from ..specs.chain_spec import ChainSpec
from ..ssz import deserialize, serialize
from .client import BeaconNodeInterface


class HttpApiError(Exception):
    def __init__(self, status: int, message: str = ""):
        self.status = status
        super().__init__(f"http {status}: {message}")


class BeaconNodeHttpClient(BeaconNodeInterface):
    def __init__(self, url: str, spec: ChainSpec, timeout: float = 10.0,
                 retries: int = 2, backoff: float = 0.1):
        p = urlparse(url)
        self.host = p.hostname or "127.0.0.1"
        self.port = p.port or 5052
        self.timeout = timeout
        self.retries = retries          # extra attempts after the first
        self.backoff = backoff          # base delay, doubled per attempt
        self.retry_count = 0
        self.spec = spec
        self.T = get_types(spec.preset)

    def _req(self, method: str, path: str, body: bytes | None = None,
             json_body=None, raw: bool = False):
        """One request with bounded connection-level retries.  Only
        transport failures (refused/reset/timeout — OSError family) are
        retried: an HTTP status >= 400 means the BN heard us and said no,
        and blindly re-POSTing a block or attestation would not change
        its mind (the eth2 client's no-retry-on-4xx discipline)."""
        headers = {}
        if raw:
            # SSZ responses are opt-in (the server
            # negotiates JSON by default, per the Beacon API spec)
            headers["Accept"] = "application/octet-stream"
        if json_body is not None:
            body = json.dumps(json_body).encode()
            headers["Content-Type"] = "application/json"
        elif body is not None:
            headers["Content-Type"] = "application/octet-stream"
        last_err: Exception | None = None
        for attempt in range(self.retries + 1):
            if attempt:
                self.retry_count += 1
                from ..api import metrics_defs as M
                M.count("vc_http_retries_total")
                time.sleep(self.backoff * (2 ** (attempt - 1)))
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
            try:
                conn.request(method, path, body=body, headers=headers)
                r = conn.getresponse()
                data = r.read()
                if r.status >= 400:
                    raise HttpApiError(r.status,
                                       data[:200].decode("latin1"))
                return data if raw else (json.loads(data) if data else {})
            except (OSError, TimeoutError, http.client.HTTPException) as e:
                last_err = e
            finally:
                conn.close()
        assert last_err is not None
        raise last_err

    # -- BeaconNodeInterface -------------------------------------------------

    def is_healthy(self) -> bool:
        try:
            self._req("GET", "/eth/v1/node/health")
            return True
        except (HttpApiError, OSError):
            return False

    def get_proposer_duties(self, epoch: int):
        out = self._req("GET", f"/eth/v1/validator/duties/proposer/{epoch}")
        return [(int(d["slot"]), int(d["validator_index"]))
                for d in out["data"]]

    def get_attester_duties(self, epoch: int, indices: list[int]):
        out = self._req("POST", f"/eth/v1/validator/duties/attester/{epoch}",
                        json_body=[str(i) for i in indices])
        return [(int(d["slot"]), int(d["committee_index"]),
                 int(d["validator_index"]), int(d["committee_length"]),
                 int(d["validator_committee_index"])) for d in out["data"]]

    def get_validator_index(self, pubkey: bytes):
        out = self._req("GET", "/eth/v1/validator/validator_index?"
                        + urlencode({"pubkey": "0x" + pubkey.hex()}))
        idx = out["data"]["index"]
        return int(idx) if idx is not None else None

    def produce_block(self, slot: int, randao_reveal: bytes,
                      graffiti: bytes | None = None):
        params = {"randao_reveal": "0x" + randao_reveal.hex()}
        if graffiti:
            params["graffiti"] = "0x" + graffiti.hex()
        raw = self._req("GET", f"/eth/v2/validator/blocks/{slot}?"
                        + urlencode(params), raw=True)
        fork = self.spec.fork_name_at_slot(slot)
        return deserialize(self.T.BeaconBlock[fork].ssz_type, raw)

    def publish_block(self, signed_block) -> None:
        self._req("POST", "/eth/v1/beacon/blocks",
                  body=serialize(type(signed_block).ssz_type, signed_block))

    def attestation_data(self, slot: int, committee_index: int):
        out = self._req("GET", "/eth/v1/validator/attestation_data?"
                        + urlencode({"slot": slot,
                                     "committee_index": committee_index}))
        return deserialize(self.T.AttestationData.ssz_type,
                           bytes.fromhex(out["data"]["ssz"]))

    def publish_attestation(self, attestation) -> None:
        self._req("POST", "/eth/v1/beacon/pool/attestations",
                  body=serialize(type(attestation).ssz_type, attestation))

    def get_aggregate(self, slot: int, committee_index: int):
        try:
            out = self._req("GET", "/eth/v1/validator/aggregate_attestation?"
                            + urlencode({"slot": slot,
                                         "committee_index": committee_index}))
        except HttpApiError as e:
            if e.status == 404:
                return None
            raise
        return deserialize(self.T.Attestation.ssz_type,
                           bytes.fromhex(out["data"]["ssz"]))

    def publish_aggregate(self, signed_aggregate) -> None:
        self._req("POST", "/eth/v1/validator/aggregate_and_proofs",
                  body=serialize(type(signed_aggregate).ssz_type,
                                 signed_aggregate))

    def head_fork_version(self) -> bytes:
        out = self._req("GET", "/eth/v1/validator/fork_version")
        return bytes.fromhex(out["data"]["version"][2:])

    def get_sync_duties(self, epoch: int, indices: list[int]) -> list[int]:
        qs = "&".join(f"id={i}" for i in indices)
        out = self._req("GET", f"/eth/v1/validator/sync_duties/{epoch}?{qs}")
        return [int(i) for i in out["data"]]

    def head_root(self) -> bytes:
        out = self._req("GET", "/lighthouse/head_root")
        return bytes.fromhex(out["data"]["root"][2:])

    def publish_sync_committee_message(self, msg) -> None:
        self._req("POST", "/eth/v1/beacon/pool/sync_committees",
                  body=serialize(type(msg).ssz_type, msg))

    def seen_liveness(self, indices: list[int], epoch: int):
        qs = "&".join(f"id={i}" for i in indices)
        out = self._req("GET", f"/eth/v1/validator/liveness/{epoch}?{qs}")
        return out["data"]

    def prepare_beacon_proposer(self, entries: list[dict]) -> None:
        self._req("POST", "/eth/v1/validator/prepare_beacon_proposer",
                  json_body=entries)

    def register_validator(self, registrations: list[dict]) -> None:
        self._req("POST", "/eth/v1/validator/register_validator",
                  json_body=registrations)
