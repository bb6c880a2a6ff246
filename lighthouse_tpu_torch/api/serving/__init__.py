"""Beacon-API serving tier: coalescing, fork-aware response
caching, and priority load-shedding between the HTTP router and the
backend.  See :mod:`.tier` for the request flow; :mod:`.coalesce`,
:mod:`.cache`, and :mod:`.shed` are the three mechanisms it composes.

Import discipline (pinned by the ``serving-cache-discipline`` lint
rule's host, and by backend.py importing the coalescer from here): this
package never imports ``api.backend``.
"""
from .cache import CachedResponse, ResponseCache
from .coalesce import Coalescer
from .shed import (
    BLOCKS, BULK, CRITICAL, PRIORITY_NAMES, AdmissionQueue, ShedError,
)
from .tier import ServingTier

__all__ = [
    "AdmissionQueue", "BLOCKS", "BULK", "CRITICAL", "CachedResponse",
    "Coalescer", "PRIORITY_NAMES", "ResponseCache", "ServingTier",
    "ShedError",
]
