"""The warm 10,000-set batch of one checkout, for A/B runs of two trees on
one card. Run it as a file, once a tree, each in its own process, in the
order parent, change, change, parent:

    python3 lighthouse_tpu_torch/ab_batch.py --tree DIR [--calls 15]
        [--out FILE]

``DIR`` is the checkout whose ``lighthouse_tpu_torch`` is imported; its
mode-0 kernels build into that checkout's ``_build/``. Signs the batch
with the C++ host backend, warms the pubkey cache, makes one cold call of
``crypto.bls.verify_signature_sets`` on the card, then ``--calls`` warm
calls, each followed by a timed ``parse_sets`` and ``host_prepare`` (the
host share of a call). Prints one JSON line: the warm times and their
median, the medians of parse and prepare, the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, required=True)
    ap.add_argument("--calls", type=int, default=15)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    # this file's own directory is not a package root: import the tree's
    sys.path[0] = str(args.tree.resolve())

    import torch
    if not torch.cuda.is_available():
        print("ab_batch: no CUDA device", file=sys.stderr)
        return 1
    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch.bls_batch import N_SETS, build_sets
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import gpu_backend as gb
    from lighthouse_tpu_torch.crypto.bls.cpp_backend import CppBackend

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    build_s = kernels.build_all(kernels.variants(0))
    sets = build_sets(CppBackend())
    gpu = bls.get_backend()
    if not isinstance(gpu, gb.GpuBackend):
        raise SystemExit(f"the default backend is {type(gpu).__name__}")
    gpu.warm([pk for s in sets for pk in s.pubkeys])
    t0 = time.perf_counter()
    if bls.verify_signature_sets(sets) is not True:
        raise SystemExit("the batch did not verify")
    cold_ms = (time.perf_counter() - t0) * 1e3

    small, lanes = gb.lane_options()
    warm, parse, prepare = [], [], []
    for _ in range(args.calls):
        t0 = time.perf_counter()
        ok = bls.verify_signature_sets(sets)
        t1 = time.perf_counter()
        if ok is not True:
            raise SystemExit("a warm call did not verify")
        parsed = gb.parse_sets(gpu, sets)
        t2 = time.perf_counter()
        gb.host_prepare(*parsed, lanes, small)
        t3 = time.perf_counter()
        warm.append((t1 - t0) * 1e3)
        parse.append((t2 - t1) * 1e3)
        prepare.append((t3 - t2) * 1e3)
    rec = {"tree": str(args.tree), "sets": N_SETS, "card": card,
           "build_s": build_s, "cold_ms": cold_ms, "warm_ms": warm,
           "warm_median_ms": statistics.median(warm),
           "parse_median_ms": statistics.median(parse),
           "prepare_median_ms": statistics.median(prepare)}
    print(json.dumps(rec), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as fh:
            fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
