"""Keymanager API server (validator_client/http_api in the reference).

Implements the standard keymanager routes against the ValidatorStore +
slashing database:

  GET/POST/DELETE /eth/v1/keystores            (local keys, EIP-2335)
  GET/POST/DELETE /eth/v1/remotekeys           (Web3Signer-backed keys)
  GET/POST/DELETE /eth/v1/validator/{pubkey}/feerecipient
  GET/POST/DELETE /eth/v1/validator/{pubkey}/gas_limit
  POST            /eth/v1/validator/{pubkey}/voluntary_exit
  GET/POST/DELETE /eth/v1/validator/{pubkey}/graffiti

DELETE /eth/v1/keystores returns the EIP-3076 slashing-protection
interchange for the deleted keys, as the spec requires.  Auth: a bearer
token generated at startup (api-token.txt convention).
"""
from __future__ import annotations

import json
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

from ..crypto.keystore import decrypt_keystore


class KeymanagerServer:
    def __init__(self, vc, host: str = "127.0.0.1", port: int = 0,
                 token: str | None = None):
        self.vc = vc                       # ValidatorClient
        self.store = vc.store
        self.token = token or secrets.token_hex(16)
        handler = self._make_handler()
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # -- handlers ------------------------------------------------------------

    def list_keystores(self) -> list[dict]:
        return [{"validating_pubkey": "0x" + pk.hex(),
                 "derivation_path": "", "readonly": False}
                for pk in self.store.voting_pubkeys()
                if pk not in getattr(self.store, "_remote_keys", {})]

    def import_keystores(self, body: dict) -> list[dict]:
        out = []
        for ks_json, password in zip(body.get("keystores", []),
                                     body.get("passwords", [])):
            try:
                ks = (json.loads(ks_json) if isinstance(ks_json, str)
                      else ks_json)
                sk = decrypt_keystore(ks, password.encode()
                                      if isinstance(password, str)
                                      else password)
                self.store.add_validator(sk)
                out.append({"status": "imported"})
            except Exception as e:
                out.append({"status": "error", "message": repr(e)})
        if body.get("slashing_protection"):
            data = body["slashing_protection"]
            self.store.slashing_db.import_interchange(
                json.loads(data) if isinstance(data, str) else data,
                self.store.genesis_validators_root)
        return out

    def delete_keystores(self, pubkeys: list[str]) -> dict:
        statuses = []
        deleted = []
        for pk_hex in pubkeys:
            pk = bytes.fromhex(pk_hex[2:])
            if pk in self.store._keys:
                del self.store._keys[pk]
                deleted.append(pk)
                statuses.append({"status": "deleted"})
            else:
                statuses.append({"status": "not_found"})
        interchange = self.store.slashing_db.export_interchange(
            self.store.genesis_validators_root)
        keep = {"0x" + pk.hex() for pk in deleted}
        interchange["data"] = [d for d in interchange.get("data", [])
                               if d.get("pubkey") in keep]
        return {"data": statuses,
                "slashing_protection": json.dumps(interchange)}

    def list_remotekeys(self) -> list[dict]:
        remote = getattr(self.store, "_remote_keys", {})
        return [{"pubkey": "0x" + pk.hex(), "url": url, "readonly": False}
                for pk, url in remote.items()]

    def import_remotekeys(self, body: dict) -> list[dict]:
        out = []
        for rk in body.get("remote_keys", []):
            try:
                pk = bytes.fromhex(rk["pubkey"][2:])
                self.store.add_remote_validator(pk, rk["url"])
                out.append({"status": "imported"})
            except Exception as e:
                out.append({"status": "error", "message": repr(e)})
        return out

    def delete_remotekeys(self, pubkeys: list[str]) -> list[dict]:
        remote = getattr(self.store, "_remote_keys", {})
        out = []
        for pk_hex in pubkeys:
            pk = bytes.fromhex(pk_hex[2:])
            if pk in remote:
                self.store.remove_remote_validator(pk)
                out.append({"status": "deleted"})
            else:
                out.append({"status": "not_found"})
        return out

    def _make_handler(self):
        km = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, status: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authed(self) -> bool:
                auth = self.headers.get("Authorization", "")
                return auth == f"Bearer {km.token}"

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                return json.loads(raw) if raw else {}

            def _route(self, method: str):
                if not self._authed():
                    return self._json(401, {"message": "unauthorized"})
                path = urlparse(self.path).path
                vc = km.vc
                try:
                    if path == "/eth/v1/keystores":
                        if method == "GET":
                            return self._json(200,
                                              {"data": km.list_keystores()})
                        if method == "POST":
                            return self._json(200, {
                                "data": km.import_keystores(self._body())})
                        if method == "DELETE":
                            return self._json(
                                200, km.delete_keystores(
                                    self._body().get("pubkeys", [])))
                    if path == "/eth/v1/remotekeys":
                        if method == "GET":
                            return self._json(200,
                                              {"data": km.list_remotekeys()})
                        if method == "POST":
                            return self._json(200, {
                                "data": km.import_remotekeys(self._body())})
                        if method == "DELETE":
                            return self._json(200, {
                                "data": km.delete_remotekeys(
                                    self._body().get("pubkeys", []))})
                    import re as _re
                    m = _re.match(
                        r"^/eth/v1/validator/(0x[0-9a-fA-F]+)/"
                        r"voluntary_exit$", path)
                    if m and method == "POST":
                        pk = bytes.fromhex(m[1][2:])
                        idx = vc._indices.get(pk)
                        if idx is None:
                            return self._json(
                                400, {"message":
                                      "validator index unknown; wait for "
                                      "duties resolution"})
                        epoch = int(self._body().get("epoch", 0))
                        sve = vc.sign_voluntary_exit(pk, idx, epoch)
                        return self._json(200, {"data": sve})
                    m = _re.match(
                        r"^/eth/v1/validator/(0x[0-9a-fA-F]+)/"
                        r"(feerecipient|gas_limit|graffiti)$", path)
                    if m:
                        pk = bytes.fromhex(m[1][2:])
                        kind = m[2]
                        if kind == "feerecipient":
                            if method == "GET":
                                fee = vc._fee_recipient(pk)
                                if fee is None:
                                    return self._json(404, {
                                        "message": "no fee recipient"})
                                return self._json(200, {"data": {
                                    "pubkey": m[1],
                                    "ethaddress": "0x" + fee.hex()}})
                            if method == "POST":
                                addr = self._body()["ethaddress"]
                                vc.fee_recipients[pk] = \
                                    bytes.fromhex(addr[2:])
                                vc._prepared_epoch = -1  # re-push
                                return self._json(202, {})
                            if method == "DELETE":
                                vc.fee_recipients.pop(pk, None)
                                return self._json(204, {})
                        if kind == "gas_limit":
                            if method == "GET":
                                return self._json(200, {"data": {
                                    "pubkey": m[1],
                                    "gas_limit": str(vc.gas_limit)}})
                            if method == "POST":
                                vc.gas_limit = int(
                                    self._body()["gas_limit"])
                                return self._json(202, {})
                            if method == "DELETE":
                                vc.gas_limit = 30_000_000
                                return self._json(204, {})
                        if kind == "graffiti":
                            g = getattr(vc, "graffiti", {})
                            if method == "GET":
                                return self._json(200, {"data": {
                                    "pubkey": m[1],
                                    "graffiti": g.get(pk, "")}})
                            if method == "POST":
                                vc.graffiti = g
                                g[pk] = self._body()["graffiti"]
                                return self._json(202, {})
                            if method == "DELETE":
                                g.pop(pk, None)
                                return self._json(204, {})
                    return self._json(404, {"message": "route not found"})
                except Exception as e:
                    return self._json(400, {"message": repr(e)})

            def do_GET(self):
                self._route("GET")

            def do_POST(self):
                self._route("POST")

            def do_DELETE(self):
                self._route("DELETE")

        return Handler
