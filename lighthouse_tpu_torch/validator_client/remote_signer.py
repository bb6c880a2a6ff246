"""Web3Signer-style remote signing (signing_method.rs:80-95).

The VC holds only the PUBLIC key for remote validators; signing requests
go to the signer over HTTP:

  POST {url}/api/v1/eth2/sign/{pubkey}   body: {"signing_root": "0x.."}
  -> {"signature": "0x.."}

MockWeb3Signer is the test-side server holding the secret keys (the
reference tests against a real Web3Signer container; same surface).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib import request as urlrequest


class RemoteSignerError(Exception):
    pass


def remote_sign(url: str, pubkey: bytes, signing_root: bytes,
                timeout: float = 5.0) -> bytes:
    req = urlrequest.Request(
        f"{url.rstrip('/')}/api/v1/eth2/sign/0x{pubkey.hex()}",
        data=json.dumps({"signing_root": "0x" + signing_root.hex()}
                        ).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urlrequest.urlopen(req, timeout=timeout) as r:
            out = json.loads(r.read())
        return bytes.fromhex(out["signature"][2:])
    except Exception as e:
        raise RemoteSignerError(str(e)) from None


class MockWeb3Signer:
    """Holds secret keys; signs any root it is asked to (the slashing
    protection lives VC-side, as with the real Web3Signer default)."""

    def __init__(self):
        self._keys: dict[bytes, int] = {}
        self.requests: list[tuple[bytes, bytes]] = []
        self._server: ThreadingHTTPServer | None = None

    def add_key(self, sk: int) -> bytes:
        from ..crypto import bls
        pk = bls.sk_to_pk(sk)
        self._keys[pk] = sk
        return pk

    def start(self, port: int = 0) -> str:
        signer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                from ..crypto import bls
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                parts = self.path.strip("/").split("/")
                resp, code = {"message": "not found"}, 404
                if parts[:4] == ["api", "v1", "eth2", "sign"] and \
                        len(parts) == 5:
                    pk = bytes.fromhex(parts[4][2:])
                    sk = signer._keys.get(pk)
                    root = bytes.fromhex(body["signing_root"][2:])
                    if sk is not None:
                        signer.requests.append((pk, root))
                        sig = bls.sign(sk, root)
                        resp, code = {"signature": "0x" + sig.hex()}, 200
                out = json.dumps(resp).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

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
