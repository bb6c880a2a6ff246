"""Single-flight request coalescing (serving tier).

A mainnet VC fleet polls the same few endpoints with the same
parameters every slot; without coalescing, N concurrent identical
requests become N identical backend computations (FAFO's observation:
hot-path work must be deduplicated across callers, not repeated per
caller).  The :class:`Coalescer` keys an in-flight computation and
hands its result — or its exception — to every caller that arrived
while it ran.  Once the flight lands the key is free again, so results
are never retained here; caching is the response cache's job.
"""
from __future__ import annotations

import threading


class _Flight:
    __slots__ = ("event", "value", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.exc: BaseException | None = None


class Coalescer:
    """``do(key, fn)`` runs ``fn`` once per concurrent caller set."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: dict = {}
        self.flights = 0        # computations actually run
        self.coalesced = 0      # callers served by someone else's flight

    def do(self, key, fn):
        """Returns ``(value, led)``: ``led`` is True for the one caller
        that computed.  The leader's exception propagates to every
        waiter of the same flight (they asked the same question)."""
        with self._lock:
            fl = self._inflight.get(key)
            if fl is None:
                fl = self._inflight[key] = _Flight()
                led = True
                self.flights += 1
            else:
                led = False
                self.coalesced += 1
        if led:
            try:
                fl.value = fn()
            except BaseException as exc:
                fl.exc = exc
                raise
            finally:
                # unkey BEFORE waking waiters: a caller arriving after
                # the flight landed must start a fresh computation, not
                # read a result produced under an older head
                with self._lock:
                    self._inflight.pop(key, None)
                fl.event.set()
            return fl.value, True
        fl.event.wait()
        if fl.exc is not None:
            raise fl.exc
        return fl.value, False
