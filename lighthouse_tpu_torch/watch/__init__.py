"""Chain-health monitor ("watch").

Equivalent of the reference's watch (6.5k LoC, Postgres): an updater that
follows a beacon node recording per-slot/per-epoch health — block rewards
proxies, packing efficiency, suboptimal attestations — into SQLite, plus a
query API. Compact but functional: the same tables/queries, stdlib sqlite3.
"""
from .monitor import WatchMonitor
