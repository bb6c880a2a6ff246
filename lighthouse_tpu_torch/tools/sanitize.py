"""Run a module of the port (or pytest) under the graftrace lock sanitizer.

    python -m lighthouse_tpu_torch.tools.sanitize lighthouse_tpu_torch.tools.gil_throughput
    python -m lighthouse_tpu_torch.tools.sanitize pytest tests/test_torch_beacon_processor.py -q

Installs the port's lock tracking, arms every class of
``locksan.build_plan`` over ``lighthouse_tpu_torch/`` (importing their
modules), and only then runs ``MODULE`` as ``python -m MODULE ARGS``
would: arming first is what lets every lock the run makes be tracked.
After the module returns (or exits), prints one JSON line, ``{"locksan":
{"armed": N, "reports": [...]}}``, each report an unguarded cross-thread
write of an attribute the static model proved guarded.

Exit codes: the module's own; 1 when it exited 0 but the sanitizer
reported.
"""
from __future__ import annotations

import json
import runpy
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def run(module: str, args: list[str]) -> tuple[int, dict]:
    """(exit code, sanitizer record) of ``python -m module *args`` run
    here under the armed sanitizer."""
    from ..analysis import locksan
    locksan.install_lock_tracking()
    armed = locksan.arm_repo(REPO)
    argv = sys.argv
    sys.argv = [module, *args]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                      else 1)
    finally:
        sys.argv = argv
    return rc, {"armed": len(armed),
                "reports": [r.render() for r in locksan.REPORTS]}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    rc, rec = run(argv[0], argv[1:])
    print(json.dumps({"locksan": rec}), flush=True)
    return rc if rc or not rec["reports"] else 1


if __name__ == "__main__":
    sys.exit(main())
