"""Mock engine-API HTTP server (test double).

Equivalent of execution_layer/src/test_utils/{mock_server,handle_rpc,
execution_block_generator}.rs: a real HTTP endpoint speaking engine JSON-RPC
with JWT validation, block tree tracking, and scriptable VALID/INVALID/
SYNCING responses for payload-invalidation tests.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .engine_api import JwtAuth


class MockEngineServer:
    def __init__(self, jwt_secret: bytes, host: str = "127.0.0.1",
                 port: int = 0):
        self.auth = JwtAuth(jwt_secret)
        self.blocks: dict[str, dict] = {}
        self.invalid_hashes: set[str] = set()
        self.static_response: str | None = None  # force SYNCING etc.
        self.requests: list[str] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                auth = self.headers.get("Authorization", "")
                if not auth.startswith("Bearer ") or \
                        not outer.auth.validate(auth[7:]):
                    self.send_response(401)
                    self.end_headers()
                    return
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                outer.requests.append(req["method"])
                result = outer._dispatch(req["method"], req.get("params", []))
                body = json.dumps({"jsonrpc": "2.0", "id": req["id"],
                                   "result": result}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if getattr(self, "_thread", None) is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _status_for(self, block_hash: str) -> str:
        if self.static_response:
            return self.static_response
        if block_hash in self.invalid_hashes:
            return "INVALID"
        return "VALID"

    def _dispatch(self, method: str, params: list):
        if method == "engine_exchangeCapabilities":
            return params[0]
        if method.startswith("engine_newPayload"):
            payload = params[0]
            h = payload["blockHash"]
            status = self._status_for(h)
            if status == "VALID":
                self.blocks[h] = payload
            return {"status": status, "latestValidHash": h
                    if status == "VALID" else None,
                    "validationError": None}
        if method.startswith("engine_forkchoiceUpdated"):
            state = params[0]
            h = state["headBlockHash"]
            status = self._status_for(h)
            payload_id = None
            if len(params) > 1 and params[1]:
                payload_id = "0x0102030405060708"
            return {"payloadStatus": {"status": status,
                                      "latestValidHash": h,
                                      "validationError": None},
                    "payloadId": payload_id}
        if method.startswith("engine_getPayload"):
            return {"executionPayload": {}, "blockValue": "0x0"}
        return None
