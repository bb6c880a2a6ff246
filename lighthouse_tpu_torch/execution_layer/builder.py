"""External builder (MEV) client + mock builder server.

Equivalent of beacon_node/builder_client/src/lib.rs (the BN-side HTTP
client) and execution_layer/src/test_utils/mock_builder.rs.  Endpoints
follow the builder-specs shapes:

  POST /eth/v1/builder/validators                (registrations)
  GET  /eth/v1/builder/header/{slot}/{parent_hash}/{pubkey}
  POST /eth/v1/builder/blinded_blocks            (unblinding)

Miniature deviation (documented in PARITY.md): there are no separate
Blinded* SSZ container types — get_header returns the bid value + the
payload header fields, and the full payload is fetched through the
blinded_blocks endpoint keyed by the header's block_hash, so the
three-step bid/sign/unblind protocol and the builder-vs-local decision
are exercised end-to-end without a parallel type hierarchy.
"""
from __future__ import annotations

import hashlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib import request as urlrequest


class BuilderError(Exception):
    pass


class BuilderHttpClient:
    """BN-side client (builder_client/src/lib.rs)."""

    def __init__(self, base_url: str, timeout: float = 3.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str):
        try:
            with urlrequest.urlopen(self.base_url + path,
                                    timeout=self.timeout) as r:
                return json.loads(r.read())
        except Exception as e:
            raise BuilderError(str(e)) from None

    def _post(self, path: str, payload) -> dict:
        data = json.dumps(payload).encode()
        req = urlrequest.Request(self.base_url + path, data=data,
                                 headers={"Content-Type":
                                          "application/json"})
        try:
            with urlrequest.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read() or b"{}")
        except Exception as e:
            raise BuilderError(str(e)) from None

    def register_validators(self, registrations: list[dict]) -> None:
        self._post("/eth/v1/builder/validators", registrations)

    def get_header(self, slot: int, parent_hash: bytes,
                   pubkey: bytes) -> dict | None:
        """Returns {"value": int_wei, "header": {...}} or None (no bid)."""
        try:
            resp = self._get(f"/eth/v1/builder/header/{slot}/"
                             f"0x{parent_hash.hex()}/0x{pubkey.hex()}")
            if not resp or "data" not in resp:
                return None
            data = resp["data"]
            return {"value": int(data["value"]),
                    "header": data["header"]}
        except (BuilderError, ValueError, KeyError, TypeError):
            return None       # malformed bid == no bid, never a miss

    def submit_blinded_block(self, block_hash: bytes) -> dict | None:
        """Unblind: exchange the signed header's block_hash for the full
        payload JSON."""
        try:
            resp = self._post("/eth/v1/builder/blinded_blocks",
                              {"block_hash": "0x" + block_hash.hex()})
        except BuilderError:
            return None
        return resp.get("data")


class MockBuilder:
    """In-process builder backed by the local chain's payload machinery
    (mock_builder.rs).  `bid_wei` controls the builder-vs-local race;
    `fee_recipient` is the BUILDER's recipient unless the proposer
    registered one."""

    def __init__(self, chain, fee_recipient: bytes = b"\xbb" * 20,
                 bid_wei: int = 10**9 + 1):
        self.chain = chain
        self.fee_recipient = fee_recipient
        self.bid_wei = bid_wei
        self.registrations: dict[str, dict] = {}   # pubkey hex -> message
        self.payloads: dict[bytes, dict] = {}      # block_hash -> json
        self.header_requests: list = []
        self.unblind_requests: list = []
        self._server: ThreadingHTTPServer | None = None

    # -- builder logic --------------------------------------------------------

    def on_register(self, regs: list[dict]) -> None:
        for r in regs:
            msg = r.get("message", r)
            self.registrations[msg["pubkey"]] = msg

    def build_bid(self, slot: int, parent_hash: bytes,
                  pubkey: bytes) -> dict | None:
        self.header_requests.append((slot, parent_hash, pubkey))
        reg = self.registrations.get("0x" + pubkey.hex())
        if reg is None:
            return None                  # unregistered proposer: no bid
        fee = bytes.fromhex(reg["fee_recipient"][2:])
        from .execution_layer import _payload_to_json
        payload = self.chain.build_payload_on_parent(
            slot, parent_hash, fee,
            extra_entropy=b"builder")    # distinct block_hash vs local
        pj = _payload_to_json(payload)
        self.payloads[payload.block_hash] = pj
        header = {k: v for k, v in pj.items()
                  if k not in ("transactions",)}
        header["transactionsRoot"] = "0x" + hashlib.sha256(
            b"".join(bytes.fromhex(t[2:]) for t in pj["transactions"])
        ).hexdigest()
        return {"value": str(self.bid_wei), "header": header}

    def unblind(self, block_hash: bytes) -> dict | None:
        self.unblind_requests.append(block_hash)
        return self.payloads.get(block_hash)

    # -- HTTP surface ---------------------------------------------------------

    def start_http(self, port: int = 0) -> str:
        mock = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                if parts[:3] == ["eth", "v1", "builder"] and \
                        parts[3] == "header" and len(parts) == 7:
                    slot = int(parts[4])
                    parent = bytes.fromhex(parts[5][2:])
                    pubkey = bytes.fromhex(parts[6][2:])
                    bid = mock.build_bid(slot, parent, pubkey)
                    if bid is None:
                        self._json(204, {})
                    else:
                        self._json(200, {"data": bid})
                    return
                self._json(404, {"message": "unknown route"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/eth/v1/builder/validators":
                    mock.on_register(body if isinstance(body, list)
                                     else [body])
                    self._json(200, {})
                    return
                if self.path == "/eth/v1/builder/blinded_blocks":
                    bh = bytes.fromhex(body["block_hash"][2:])
                    payload = mock.unblind(bh)
                    if payload is None:
                        self._json(404, {"message": "unknown payload"})
                    else:
                        self._json(200, {"data": payload})
                    return
                self._json(404, {"message": "unknown route"})

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return f"http://127.0.0.1:{self._server.server_port}"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
        if getattr(self, "_thread", None) is not None:
            self._thread.join(timeout=2)
            self._thread = None
