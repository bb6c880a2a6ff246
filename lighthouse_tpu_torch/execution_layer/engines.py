"""Engine health state machine (execution_layer/src/engines.rs): tracks
online/offline/syncing, retries with backoff, re-negotiates capabilities on
recovery, and exposes a subscribable responsiveness signal
(get_responsiveness_watch, lib.rs:566)."""
from __future__ import annotations

import enum
import threading
import time


class EngineState(enum.Enum):
    ONLINE = "online"
    OFFLINE = "offline"
    SYNCING = "syncing"
    AUTH_FAILED = "auth_failed"


class Engines:
    def __init__(self, client, retry_interval: float = 2.0):
        self.client = client
        self.state = EngineState.OFFLINE
        self.capabilities: list[str] = []
        self.retry_interval = retry_interval
        self._last_attempt = 0.0
        self._lock = threading.Lock()
        self._watchers: list = []

    def subscribe(self, fn) -> None:
        self._watchers.append(fn)

    def _set_state(self, state: EngineState) -> None:
        changed = state != self.state
        self.state = state
        if changed:
            for fn in self._watchers:
                try:
                    fn(state)
                except Exception:
                    pass

    def upcheck(self) -> EngineState:
        with self._lock:
            now = time.monotonic()
            if self.state == EngineState.ONLINE or \
                    now - self._last_attempt < self.retry_interval:
                return self.state
            self._last_attempt = now
            try:
                self.capabilities = self.client.exchange_capabilities()
                self._set_state(EngineState.ONLINE)
            except Exception as e:
                if "auth" in str(e).lower() or "401" in str(e):
                    self._set_state(EngineState.AUTH_FAILED)
                else:
                    self._set_state(EngineState.OFFLINE)
            return self.state

    def on_error(self) -> None:
        with self._lock:
            self._set_state(EngineState.OFFLINE)

    def on_success(self, syncing: bool = False) -> None:
        with self._lock:
            self._set_state(EngineState.SYNCING if syncing
                            else EngineState.ONLINE)

    def is_online(self) -> bool:
        return self.state in (EngineState.ONLINE, EngineState.SYNCING)
