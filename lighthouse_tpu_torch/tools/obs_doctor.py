"""graftwatch doctor — offline diagnosis of a flight-recorder dump.

    python -m lighthouse_tpu_torch.tools.obs_doctor graftwatch_24_001_incident_head_lag.json
    python -m lighthouse_tpu_torch.tools.obs_doctor --json dump.json   # machine-readable
    python -m lighthouse_tpu_torch.tools.obs_doctor --probe            # live device probe

Loads a versioned dump written by the flight recorder (auto-dump on
incident-open, /lighthouse/graftwatch/dump, or SIGUSR2) and correlates
every SLO breach in it with the co-occurring signals bundled alongside:
runtime XLA recompiles, device transfer bytes, processor shedding and
queue depth, reorgs, block-import throughput.  The breached metric's own
trajectory always leads each incident's diagnosis.

``--probe`` skips the dump entirely and runs the staged device-health
probe (graftgauge, ``obs.device.staged_probe``): subprocesses answering
"how far does torch get on this host" — importing, then initialising
CUDA and counting the cards — each stage with its own hard timeout so a
wedged driver reports instead of hanging.

Exit codes: 0 report produced, 2 unreadable/invalid dump, 3 dump format
version unsupported.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..obs import doctor

REPO = Path(__file__).resolve().parents[2]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", nargs="?", help="flight-recorder dump file")
    ap.add_argument("--json", action="store_true",
                    help="print the diagnosis as JSON instead of text")
    ap.add_argument("--probe", action="store_true",
                    help="run the staged device-health probe instead of "
                         "reading a dump")
    ap.add_argument("--probe-timeout", type=int, default=90,
                    help="per-stage probe timeout in seconds")
    args = ap.parse_args(argv)
    if args.probe:
        from ..obs import device
        probe = device.staged_probe(timeout=args.probe_timeout,
                                    cwd=str(REPO))
        if args.json:
            print(json.dumps(probe, indent=2))
        else:
            print(f"device probe (per-stage timeout "
                  f"{probe['timeout_s']}s)")
            for label in ("default",):
                rec = probe.get(label) or {}
                print(f"  {label}: reached stage "
                      f"{rec.get('stage_reached')}")
                for stage, st in (rec.get("stages") or {}).items():
                    rc = st.get("rc")
                    rc_s = "timeout" if rc is None else f"rc {rc}"
                    print(f"    {stage}: {rc_s} in {st.get('wall_s')}s")
        return 0
    if not args.path:
        ap.error("path required unless --probe")
    try:
        doc = doctor.load(args.path)
    except doctor.DoctorError as e:
        print(str(e), file=sys.stderr)
        return e.exit_code
    diag = doctor.diagnose(doc)
    print(json.dumps(diag, indent=2) if args.json
          else doctor.render(diag))
    return 0


if __name__ == "__main__":
    sys.exit(main())
