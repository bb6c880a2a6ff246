#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out REPORT.json]

Phases (each prints its lines; any failure raises and exits nonzero):

1. Card and build: ``nvidia-smi`` name and power limit; build every CUDA
   kernel of the state-root path from ``lighthouse_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and print the build time.
2. Kernels against their plain PyTorch versions, on the card, at the shapes
   the state root gives them; equality is bit-exact (max_abs_err 0). Each
   kernel's time (CUDA events, median of repeats), its plain version's
   time and its bound (the least time the card could take for the same
   work: bytes over the memory rate, or integer ops over the INT32 rate).
3. The slice: a Deneb mainnet-preset BeaconState at 1,000,000 validators
   from ``seeded_columns(N_VALIDATORS, STATE_SEED)``; ``hash_tree_root()``
   on the card must equal ``EXPECTED_STATE_ROOT_1M``; ``REPS`` (5) reps of
   the ``bench.py`` ``bench_tree_hash`` writes (1,024 effective-balance and
   1,024 balance writes each), each followed by the state root; the last
   must equal ``EXPECTED_STATE_ROOT_1M_AFTER_REPS``; a rebuild from scratch
   must equal the incremental root; every kernel's launch count over the
   full build and the reps must be nonzero.

The two expected roots are the JAX package's, pinned by
tests/test_torch_state_root.py. Importing this module touches no CUDA.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from lighthouse_tpu_torch.seeded_state import N_VALIDATORS, REPS, STATE_SEED

#: hash_tree_root() of the seeded 1M-validator Deneb mainnet-preset state,
#: before and after the 5 bench_tree_hash reps (the JAX package's roots).
EXPECTED_STATE_ROOT_1M = (
    "59e47648a621b500758fe08b6de5ab2739568ac9204bac064a7082abbf709b2a")
EXPECTED_STATE_ROOT_1M_AFTER_REPS = (
    "b8fa02b5aad146b8cefc2e4210cb338f476f2e884b477a89e8b0ba5043c47cdd")

#: H100 SXM: HBM3 at 3.35 TB/s; 132 SMs, 64 INT32 lanes each per clock.
HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT32_LANES_PER_SM = 64

REPLACES = {
    "hash64": "lighthouse_tpu/ops/sha256.py:102",
    "cap_fold": "lighthouse_tpu/ops/sha256.py:135",
    "fold_pre": "lighthouse_tpu/ops/merkle_tree.py:52",
    "path_update": "lighthouse_tpu/ops/merkle_tree.py:105",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def time_cuda(fn, repeats: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``repeats`` CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    import torch
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


class Bounds:
    """Least time the card could take: the larger of bytes over the memory
    rate and integer ops over the INT32 rate at the card's max SM clock."""

    def __init__(self, sm_clock_mhz: float):
        self.int_ops_per_s = SMS * INT32_LANES_PER_SM * sm_clock_mhz * 1e6

    def __call__(self, n_bytes: float, n_ops: float) -> tuple[float, str]:
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / self.int_ops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


def kernel_phase(bounds: Bounds) -> tuple[list[dict], dict]:
    """Each kernel against its plain version at the state root's shapes:
    the JSON rows, and the further modes checked (kernel -> list)."""
    import torch

    from lighthouse_tpu_torch.ops import merkle_tree as mt
    from lighthouse_tpu_torch.ops import sha256 as sh

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    ops = sh.HASH64_INT_OPS
    results, modes = [], {}

    def rand_words(*shape):
        arr = rng.integers(0, 2**32, size=shape, dtype=np.uint64)
        return torch.from_numpy(arr.astype(np.uint32).view(np.int32)).to(dev)

    def record(name, got, want, fn, plain, n_bytes, n_ops, mode=None,
               repeats=20):
        """Check ``got`` against ``want`` bit-exact and time both. The
        first check of a kernel makes its row; a further ``mode`` (another
        shape or template instance the main path launches) adds its error
        to the row and its times to ``modes`` (the report's
        ``kernel_modes``; the JSON line keeps the first check's times)."""
        err = max_abs_err(got, want)
        label = name if mode is None else f"{name} [{mode}]"
        check(torch.equal(got, want), f"{label}: kernel != plain "
                                      f"(max_abs_err {err})")
        ms = time_cuda(fn, repeats)
        plain_ms = time_cuda(plain, 3, warmup=0)
        bound_ms, bound_by = bounds(n_bytes, n_ops)
        print(f"kernel {label}: ok bit-exact, {ms:.4f} ms (plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by})",
              flush=True)
        if mode is not None:
            row = next(r for r in results if r["name"] == name)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            modes.setdefault(name, []).append(
                {"mode": mode, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by})
            return
        results.append({"name": name, "route": "cuda",
                        "source": f"lighthouse_tpu_torch/csrc/{name}.cu",
                        "replaces": REPLACES[name], "launches": 0,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})

    def sorted_rows(count, high):
        """``count`` sorted distinct leaf rows in [0, high), as the state's
        dirty-row sets reach DeviceTree.update."""
        got = np.sort(rng.choice(high, size=count, replace=False))
        return torch.from_numpy(got.astype(np.int32)).to(dev)

    # hash64 on 2^20 random 64-byte blocks (one level of the registry tree)
    n = 1 << 20
    blocks = rand_words(n, 16)
    record("hash64", sh.hash64(blocks), sh._hash64_plain(blocks),
           lambda: sh.hash64(blocks), lambda: sh._hash64_plain(blocks),
           n * (64 + 32), n * ops)
    del blocks

    # fold_pre, the registry build (<3>): 2^20 slots, 1,000,000 live
    # validators with pubkeys
    n_live, p = N_VALIDATORS, 3
    chunks = rand_words(n_live * 8, 8)
    pk = rand_words(n_live, 16)
    out_k = torch.empty((n, 8), dtype=torch.int32, device=dev)
    out_p = torch.empty_like(out_k)
    mt.fold_pre(chunks, pk, p, n_live, out_k)
    mt._fold_pre_plain(chunks, pk, None, n, n_live, p, out_p)
    record("fold_pre", out_k, out_p,
           lambda: mt.fold_pre(chunks, pk, p, n_live, out_k),
           lambda: mt._fold_pre_plain(chunks, pk, None, n, n_live, p, out_p),
           n_live * (8 * 32 + 64) + n * 32, n_live * 8 * ops)
    del chunks, pk

    # fold_pre, a registry update (<3>, scatter): 1,024 dirty validators
    # with pubkeys into the 2^20-slot level 0 above
    r = 1024
    rows = sorted_rows(r, n_live)
    chunks, pk = rand_words(r * 8, 8), rand_words(r, 16)
    mt.fold_pre(chunks, pk, p, n_live, out_k, rows=rows)
    mt._fold_pre_plain(chunks, pk, rows, r, n_live, p, out_p)
    record("fold_pre", out_k, out_p,
           lambda: mt.fold_pre(chunks, pk, p, n_live, out_k, rows=rows),
           lambda: mt._fold_pre_plain(chunks, pk, rows, r, n_live, p, out_p),
           r * (8 * 32 + 64 + 4 + 32), r * 8 * ops, mode="scatter<3>")
    del out_k, out_p

    # fold_pre, the balances column (<0>, no pubkeys): 1,000,000 u64 are
    # 250,000 chunks in a 2^18-slot level 0; a build, then a 1,024-leaf
    # update
    n_live, n0 = N_VALIDATORS * 8 // 32, 1 << 18
    chunks = rand_words(n_live, 8)
    out_k = torch.empty((n0, 8), dtype=torch.int32, device=dev)
    out_p = torch.empty_like(out_k)
    mt.fold_pre(chunks, None, 0, n_live, out_k)
    mt._fold_pre_plain(chunks, None, None, n0, n_live, 0, out_p)
    record("fold_pre", out_k, out_p,
           lambda: mt.fold_pre(chunks, None, 0, n_live, out_k),
           lambda: mt._fold_pre_plain(chunks, None, None, n0, n_live, 0,
                                      out_p),
           n_live * 32 + n0 * 32, 0, mode="build<0>")
    rows = sorted_rows(r, n_live)
    chunks = rand_words(r, 8)
    mt.fold_pre(chunks, None, 0, n_live, out_k, rows=rows)
    mt._fold_pre_plain(chunks, None, rows, r, n_live, 0, out_p)
    record("fold_pre", out_k, out_p,
           lambda: mt.fold_pre(chunks, None, 0, n_live, out_k, rows=rows),
           lambda: mt._fold_pre_plain(chunks, None, rows, r, n_live, 0,
                                      out_p),
           r * (32 + 4 + 32), 0, mode="scatter<0>")
    del chunks, out_k, out_p

    # path_update: R = 1,024 dirty rows up a depth-20 tree
    depth = 20
    levels = [rand_words(1 << depth, 8)]
    for _ in range(depth):
        levels.append(sh.hash64(levels[-1].reshape(-1, 16)))
    rows_np = rng.integers(0, 1 << depth, size=1024).astype(np.int32)
    rows = torch.from_numpy(rows_np).to(dev)
    levels[0][rows.long()] = rand_words(1024, 8)   # the dirty leaves
    lv_k = [lv.clone() for lv in levels]
    lv_p = [lv.clone() for lv in levels]

    def walk_kernel():
        for lvl in range(depth):
            mt.path_update(lv_k[lvl], lv_k[lvl + 1], rows, lvl)

    def walk_plain():
        for lvl in range(depth):
            mt._path_update_plain(lv_p[lvl], lv_p[lvl + 1], rows, lvl)

    walk_kernel()
    walk_plain()
    # the work this data needs: one hash per distinct parent per level
    parents = sum(len(np.unique(rows_np.astype(np.int64) >> (lvl + 1)))
                  for lvl in range(depth))
    record("path_update", torch.cat(lv_k), torch.cat(lv_p), walk_kernel,
           walk_plain, parents * (64 + 32) + 4 * 1024, parents * ops)
    del levels, lv_k, lv_p

    # cap_fold: K = 20 zero-subtree caps (registry: 2^20 dense, 2^40 limit)
    root = rand_words(8)
    zeros = sh.words_to_tensor(sh.ZERO_HASH_WORDS[20:40], dev)
    record("cap_fold", sh.cap_fold(root, zeros),
           sh._cap_fold_plain(root, zeros),
           lambda: sh.cap_fold(root, zeros),
           lambda: sh._cap_fold_plain(root, zeros),
           (1 + 20) * 32 + 32, 20 * ops)
    torch.cuda.synchronize()
    return results, modes


def reset_trees(state) -> None:
    """Drop every incremental tree so the next root rebuilds from scratch."""
    state.validators.mark_dirty()
    for name in ("balances", "inactivity_scores",
                 "previous_epoch_participation",
                 "current_epoch_participation"):
        getattr(state, name).mark_dirty()


def slice_phase(card: str) -> dict:
    """The 1M-validator Deneb state root, its reps, and the rebuild."""
    import torch

    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch.containers.state import (
        ValidatorRegistry, new_state,
    )
    from lighthouse_tpu_torch.seeded_state import (
        apply_bench_rep, bench_reps, fill_state, seeded_columns,
    )
    from lighthouse_tpu_torch.specs import ForkName, mainnet_spec

    t0 = time.perf_counter()
    state = new_state(mainnet_spec(), ForkName.DENEB)
    fill_state(state, ValidatorRegistry(),
               seeded_columns(N_VALIDATORS, STATE_SEED))
    setup_s = time.perf_counter() - t0
    print(f"slice: seeded {N_VALIDATORS} validators in {setup_s:.2f} s "
          f"(host)", flush=True)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    root = state.hash_tree_root()
    build_ms = (time.perf_counter() - t0) * 1e3
    check(root.hex() == EXPECTED_STATE_ROOT_1M,
          f"1M state root {root.hex()} != {EXPECTED_STATE_ROOT_1M}")
    print(f"slice: full build state root {root.hex()} ok, {build_ms:.1f} ms "
          f"[{card}]", flush=True)

    rep_ms, mutate_ms, root_ms = [], [], []
    for rows, brows in bench_reps(N_VALIDATORS, REPS):
        t0 = time.perf_counter()
        apply_bench_rep(state, rows, brows)
        t1 = time.perf_counter()
        root = state.hash_tree_root()
        t2 = time.perf_counter()
        mutate_ms.append((t1 - t0) * 1e3)
        root_ms.append((t2 - t1) * 1e3)
        rep_ms.append((t2 - t0) * 1e3)
    launches = kernels.counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    check(root.hex() == EXPECTED_STATE_ROOT_1M_AFTER_REPS,
          f"state root after {REPS} reps {root.hex()} != "
          f"{EXPECTED_STATE_ROOT_1M_AFTER_REPS}")
    print(f"slice: {REPS} reps ok, root {root.hex()}; ms per rep "
          f"{[round(x, 2) for x in rep_ms]} (writes "
          f"{[round(x, 2) for x in mutate_ms]}, root "
          f"{[round(x, 2) for x in root_ms]}) [{card}]", flush=True)
    print(f"slice: launches on the main path {launches}; peak device "
          f"memory {peak_mib:.0f} MiB", flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    reset_trees(state)
    t0 = time.perf_counter()
    rebuilt = state.hash_tree_root()
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    check(rebuilt == root, f"rebuilt root {rebuilt.hex()} != incremental "
                           f"root {root.hex()}")
    print(f"slice: rebuild from scratch equals the incremental root, "
          f"{rebuild_ms:.1f} ms", flush=True)
    return {"launches": launches, "build_ms": build_ms,
            "rebuild_ms": rebuild_ms, "rep_ms": rep_ms,
            "rep_mutate_ms": mutate_ms, "rep_root_ms": root_ms,
            "peak_device_mib": peak_mib, "setup_s": setup_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch import kernels

    # phase 1: card and build
    card_line = nvidia_smi("name,power.limit")
    print(card_line, flush=True)
    sm_clock = float(nvidia_smi("clocks.max.sm").split()[0])
    build_s = kernels.build_all()
    print(f"build: {len(kernels.KERNELS)} kernels in {build_s:.1f} s "
          f"(nvcc, sm_90a); max SM clock {sm_clock:.0f} MHz", flush=True)

    # phase 2: kernels against their plain versions
    rows, modes = kernel_phase(Bounds(sm_clock))

    # phase 3: the slice
    sl = slice_phase(card_line)
    for row in rows:
        row["launches"] = sl["launches"][row["name"]]

    report = {"card": card_line, "sm_clock_max_mhz": sm_clock,
              "build_s": build_s, "kernels": rows, "kernel_modes": modes,
              "slice": sl}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
