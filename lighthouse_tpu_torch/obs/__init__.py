"""Observability of the port: the tracing span (obs/tracing.py)."""
from .tracing import span

__all__ = ["span"]
