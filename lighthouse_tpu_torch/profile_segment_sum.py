"""Where a segment sum's time goes: its kernel, its copies, the host.

    python -m lighthouse_tpu_torch.profile_segment_sum [--out REPORT.json]

On the scaled G1 points of ``compare_kernels`` (``default_rng(5)``) at
10,240 and 2,560 lanes, in the layouts ``compare_kernels`` times (the
batch's 127 segments and a padding group, one segment of all live
lanes, every live lane its own segment), ``ops/bls12_381.py``
``g1_segment_sum`` runs 5 times under ``torch.profiler``: the device
microseconds a call of its one cooperative launch (``seg_sum_kernel``
at the layout's piece size) and of the copies of the host layout arrays;
then the ms a call of 20 back-to-back calls between two CUDA events
(the wrapper's host work included: where it exceeds the device's, the
calls are host-bound).
Prints a line a layout with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report as JSON here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_segment_sum needs an NVIDIA card")
    from . import kernels
    from .compare_kernels import _inputs
    from .measure import nvidia_smi
    from .ops import bls12_381 as k

    card = nvidia_smi("name,power.limit")
    kernels.build_all([kernels.G1_SEGMENT_SUM, kernels.RLC_SCALE,
                       kernels.AFFINE])
    _, _, lane = _inputs(10240)
    report = []
    for n in (10240, 2560):
        x, y, z = (c[:n].contiguous() for c in lane["pk"])
        m = n * 10000 // 10240
        sizes = np.array([m // 127 + (g < m % 127) for g in range(127)])
        firsts = np.cumsum(sizes) - sizes
        batch = np.zeros(n, np.int32)
        batch[firsts] = 1
        batch[m] = 1
        one = np.zeros(n, np.int32)
        one[[0, m]] = 1
        layouts = (
            ("the batch's 127 segments", batch,
             np.append(firsts + sizes - 1, 0)),
            (f"one segment of {m} lanes", one, np.array([m - 1] + [0] * 127)),
            (f"{m} one-lane segments", np.ones(n, np.int32), np.arange(m)))
        for what, starts, ends in layouts:
            ends = ends.astype(np.int32)
            for _ in range(3):
                k.g1_segment_sum(x, y, z, starts, ends)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    k.g1_segment_sum(x, y, z, starts, ends)
                torch.cuda.synchronize()
            by_name = {}
            for e in prof.key_averages():
                us = getattr(e, "device_time_total", 0) or getattr(
                    e, "cuda_time_total", 0)
                if us:
                    by_name[e.key.split("(")[0]] = round(us / 5, 2)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                k.g1_segment_sum(x, y, z, starts, ends)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b) / 20
            rec = {"lanes": n, "layout": what, "device_us_by_kernel": by_name,
                   "ms_per_call": ms, "card": card}
            report.append(rec)
            print(f"g1_segment_sum, {n} lanes, {what}: device us a call "
                  f"{by_name}; {ms:.4f} ms a call, 20 back to back "
                  f"[{card}]", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
