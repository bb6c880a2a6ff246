"""Remote monitoring push (common/monitoring_api equivalent).

Posts beaconcha.in-style process snapshots
(`{"version":1,"timestamp":...,"process":"beaconnode",...}`) to a
configured endpoint on an interval — the reference's
`--monitoring-endpoint` feature.
"""
from __future__ import annotations

import json
import threading
import time
from urllib import request as urlrequest

from .system_health import snapshot

DEFAULT_PERIOD = 60.0


class MonitoringService:
    def __init__(self, endpoint: str, chain=None,
                 period: float = DEFAULT_PERIOD,
                 process_name: str = "beaconnode"):
        self.endpoint = endpoint
        self.chain = chain
        self.period = period
        self.process_name = process_name
        self.sent = 0
        self.errors = 0
        self._stop = threading.Event()
        # guards _thread: two start() calls (config reload racing boot)
        # must not leak an unstoppable pusher — graftrace data-race fix
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def payload(self) -> list[dict]:
        health = snapshot()
        body = {
            "version": 1,
            "timestamp": int(time.time() * 1000),
            "process": self.process_name,
            **{k: int(v) if isinstance(v, float) else v
               for k, v in health.items()},
        }
        if self.chain is not None:
            head = self.chain.head()
            body["sync_beacon_head_slot"] = int(head.head_state.slot)
            body["sync_eth2_synced"] = True
        return [body]

    def push_once(self) -> bool:
        data = json.dumps(self.payload()).encode()
        req = urlrequest.Request(
            self.endpoint, data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urlrequest.urlopen(req, timeout=5) as r:
                r.read()
            with self._lock:
                self.sent += 1
            return True
        except Exception:
            with self._lock:
                self.errors += 1
            return False

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.period):
                self.push_once()
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None:
            thread.join(timeout=2)
