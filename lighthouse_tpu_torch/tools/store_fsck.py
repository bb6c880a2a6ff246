"""Offline store fsck — structural check of a hot/cold database.

    python -m lighthouse_tpu_torch.tools.store_fsck /var/lib/lhtpu/db
    python -m lighthouse_tpu_torch.tools.store_fsck --preset mainnet --json db_dir

Opens the ``hot.db`` / ``cold.db`` pair under the given directory
read-only (the checker never writes) and runs every invariant in
:mod:`lighthouse_tpu_torch.store.fsck`: split/anchor agreement, hot-block
parent connectivity, state-summary reachability, blob ownership, and
the persisted fork-choice/head/op-pool items including the torn-persist
sequence check.  The same checks run at node boot when
``LHTPU_FSCK_ON_OPEN=1`` is set; this tool is for the post-mortem case
where the node won't come up (RECOVERY.md walks the repair ladder).

Exit codes: 0 clean (warnings allowed), 1 errors found, 2 unusable
database directory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..specs import mainnet_spec, minimal_spec
from ..store import HotColdDB, run_fsck
from ..store.kv import NativeKvStore


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("db_dir", help="directory holding hot.db / cold.db")
    ap.add_argument("--preset", choices=("minimal", "mainnet"),
                    default="minimal",
                    help="chain preset the database was written under")
    ap.add_argument("--json", action="store_true",
                    help="print the report as JSON instead of text")
    args = ap.parse_args(argv)

    hot_path = os.path.join(args.db_dir, "hot.db")
    cold_path = os.path.join(args.db_dir, "cold.db")
    if not os.path.isfile(hot_path):
        print(f"no hot database at {hot_path}", file=sys.stderr)
        return 2
    spec = mainnet_spec() if args.preset == "mainnet" else minimal_spec()
    try:
        db = HotColdDB(NativeKvStore(hot_path),
                       NativeKvStore(cold_path), spec)
    except Exception as exc:
        print(f"cannot open store under {args.db_dir!r}: {exc}",
              file=sys.stderr)
        return 2
    report = run_fsck(db)
    print(json.dumps(report.to_dict(), indent=2) if args.json
          else report.render())
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
