"""Where the time of the 1M-validator state root goes on the card.

    python -m lighthouse_tpu_torch.profile_state_root [--out F]

Builds the seeded Deneb mainnet-preset state of ``chip_smoke.py``
(``seeded_state.seeded_columns(N_VALIDATORS, STATE_SEED)``), then times
the full build root and the ``REPS`` ``bench_tree_hash`` reps under
``torch.profiler`` (CPU and CUDA activities): wall time on the host clock,
device time by kernel and copy name, and the device's busy share of the
wall time (the union of the device intervals over the wall time). A ``cProfile`` of one more rep
names the host functions that hold the time (``cProfile`` inflates Python
calls, so its shares are candidates, not measurements). Needs a card.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import time
from pathlib import Path


def device_summary(prof, wall_ms: float) -> dict:
    from torch.autograd import DeviceType
    by_name: dict[str, float] = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) / 1e3
        spans.append((start, end))
    spans.sort()
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall_ms if wall_ms else 0.0,
            "device_events": len(spans),
            "device_ms_by_name": {k: round(v, 4) for k, v in top}}


def profiled(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_summary(prof, wall_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the report as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_state_root needs a CUDA card")
    from . import kernels
    from .containers.state import ValidatorRegistry, new_state
    from .seeded_state import (
        N_VALIDATORS, REPS, STATE_SEED, apply_bench_rep, bench_reps,
        fill_state, seeded_columns,
    )
    from .specs import ForkName, mainnet_spec

    kernels.build_all()
    torch.zeros(1, device="cuda")           # the CUDA context, outside
    state = new_state(mainnet_spec(), ForkName.DENEB)
    fill_state(state, ValidatorRegistry(),
               seeded_columns(N_VALIDATORS, STATE_SEED))
    report = {"n_validators": N_VALIDATORS,
              "build": profiled(state.hash_tree_root), "reps": []}
    reps = bench_reps(N_VALIDATORS, REPS + 1)
    for rows, brows in reps[:-1]:
        report["reps"].append(profiled(
            lambda: (apply_bench_rep(state, rows, brows),
                     state.hash_tree_root())))
    rows, brows = reps[-1]
    cp = cProfile.Profile()
    cp.enable()
    apply_bench_rep(state, rows, brows)
    state.hash_tree_root()
    cp.disable()
    stats = pstats.Stats(cp)
    host = sorted(((f"{fn[0].split('/')[-1]}:{fn[1]}:{fn[2]}", row[3] * 1e3)
                   for fn, row in stats.stats.items()),
                  key=lambda kv: -kv[1])[:15]
    report["host_cumulative_ms_one_rep_cprofile"] = host
    print(json.dumps(report, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
