"""Named, env-armed crash sites for the restart-recovery suite.

Lighthouse survives ``kill -9`` because every commit point is atomic;
proving the same for this port needs a way to die AT a specific commit
boundary, not merely near one.  A crashpoint is a named call site on a
persistence path (``crashpoint("migrate:mid_freeze")``); arming it via
``LHTPU_CRASHPOINT=<name>`` makes the process ``os._exit`` there —
no atexit hooks, no buffered flushes, the closest a test harness gets
to power loss.  ``tests/test_crash_recovery.py`` drives a chain in a
child process, kills it at every registered site, reopens the store
and asserts the recovery invariants.

Environment contract:

- ``LHTPU_CRASHPOINT``: name of the armed site (unset = all disabled;
  production runs never set it, so the sites cost one dict lookup).
- ``LHTPU_CRASHPOINT_HIT``: 1-based hit count to crash on (default 1),
  so e.g. the 20th block import can be targeted instead of the first.

Every site must be declared in ``REGISTRY`` — arming an unknown name
raises at the first ``crashpoint()`` call, and the recovery suite
enumerates the registry so a new site cannot ship untested.
"""
from __future__ import annotations

import os

#: exit code a crashed child reports — distinguishable from real faults
CRASH_EXIT_CODE = 86

#: site name -> where it sits in the commit sequence
REGISTRY: dict[str, str] = {
    "genesis:mid_store":
        "store_genesis: after the freezer batch, before the hot anchor "
        "batch (the anchor meta is genesis' commit point)",
    "block_import:before_batch":
        "import_block: fork choice updated in memory, block+state batch "
        "not yet committed",
    "block_import:after_state_write":
        "import_block: block+state batch committed, head/fork-choice "
        "snapshot not yet persisted",
    "persist:between_fc_and_head":
        "persist_chain: fork-choice snapshot (seq N) committed, head "
        "item still at seq N-1",
    "persist:between_head_and_op_pool":
        "persist_chain: head committed, op-pool snapshot still stale",
    "replay:before_epoch_commit":
        "graftflow commit stage: fork choice updated in memory, the "
        "epoch's block+state batch not yet committed",
    "replay:after_epoch_commit":
        "graftflow commit stage: epoch batch committed, head recompute "
        "and chain persist not yet run",
    "migrate:mid_freeze":
        "migrate_database: freezer batch committed, hot prune + split "
        "advance not yet committed",
    "migrate:before_split_write":
        "migrate_database: hot prune/split batch assembled but not yet "
        "committed",
}

_hits: dict[str, int] = {}


def crashpoint(name: str) -> None:
    """Die here iff this site is armed (see module docstring)."""
    armed = os.environ.get("LHTPU_CRASHPOINT")
    if not armed:
        return
    if name not in REGISTRY:
        raise AssertionError(f"unregistered crashpoint {name!r}")
    if armed != name:
        return
    _hits[name] = _hits.get(name, 0) + 1
    if _hits[name] < int(os.environ.get("LHTPU_CRASHPOINT_HIT", "1")):
        return
    os._exit(CRASH_EXIT_CODE)
