"""Engine JSON-RPC client + JWT (engine_api/http.rs, auth.rs)."""
from __future__ import annotations

import base64
import hashlib
import hmac
import http.client
import json
import time


class EngineError(Exception):
    pass


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


class JwtAuth:
    """HS256 JWT with iat claim (EIP: engine API auth)."""

    def __init__(self, secret: bytes):
        if len(secret) != 32:
            raise EngineError("jwt secret must be 32 bytes")
        self.secret = secret

    def generate_token(self) -> str:
        header = _b64url(json.dumps(
            {"alg": "HS256", "typ": "JWT"}, separators=(",", ":")).encode())
        payload = _b64url(json.dumps(
            {"iat": int(time.time())}, separators=(",", ":")).encode())
        msg = header + b"." + payload
        sig = _b64url(hmac.new(self.secret, msg, hashlib.sha256).digest())
        return (msg + b"." + sig).decode()

    def validate(self, token: str, max_drift: int = 60) -> bool:
        try:
            h, p, s = token.split(".")
            msg = (h + "." + p).encode()
            want = _b64url(hmac.new(self.secret, msg,
                                    hashlib.sha256).digest()).decode()
            if not hmac.compare_digest(want, s):
                return False
            pad = "=" * (-len(p) % 4)
            claims = json.loads(base64.urlsafe_b64decode(p + pad))
            return abs(int(time.time()) - int(claims["iat"])) <= max_drift
        except Exception:
            return False


class EngineApiClient:
    """Blocking JSON-RPC client for one engine endpoint."""

    def __init__(self, host: str, port: int, jwt: JwtAuth,
                 timeout: float = 8.0):
        self.host = host
        self.port = port
        self.jwt = jwt
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, params: list):
        self._id += 1
        body = json.dumps({"jsonrpc": "2.0", "id": self._id,
                           "method": method, "params": params}).encode()
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request("POST", "/", body=body, headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.jwt.generate_token()}"})
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status != 200:
                raise EngineError(f"engine http {resp.status}")
            out = json.loads(raw)
            if "error" in out and out["error"]:
                raise EngineError(out["error"].get("message", "rpc error"))
            return out.get("result")
        finally:
            conn.close()

    # -- engine methods ------------------------------------------------------

    def exchange_capabilities(self) -> list[str]:
        return self.call("engine_exchangeCapabilities", [[
            "engine_newPayloadV3", "engine_forkchoiceUpdatedV3",
            "engine_getPayloadV3"]]) or []

    def new_payload(self, payload_json: dict) -> dict:
        return self.call("engine_newPayloadV3", [payload_json])

    def forkchoice_updated(self, head: bytes, safe: bytes, finalized: bytes,
                           attributes: dict | None = None) -> dict:
        state = {"headBlockHash": "0x" + head.hex(),
                 "safeBlockHash": "0x" + safe.hex(),
                 "finalizedBlockHash": "0x" + finalized.hex()}
        return self.call("engine_forkchoiceUpdatedV3", [state, attributes])

    def get_payload(self, payload_id: str) -> dict:
        return self.call("engine_getPayloadV3", [payload_id])
