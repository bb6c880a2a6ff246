"""Measurement on the card: CUDA-event timing, errors, and the least time
the card could take for a piece of work (the bound beside each kernel's
time in ``chip_smoke.py`` and ``entry.py``).

The rates are NVIDIA's data-sheet figures for one H100 SXM at its full
power limit: HBM3 at 3.35 TB/s; 132 SMs with 64 INT32 lanes each per
clock (the clock is the card's maximum SM clock, read by the caller);
NVLink at 450 GB/s each way to the other cards of the host.
"""
from __future__ import annotations

import statistics
import subprocess

HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT32_LANES_PER_SM = 64
NVLINK_BYTES_PER_S = 450e9


class Bounds:
    """Least time the card could take: the larger of bytes over the memory
    rate and integer ops over the INT32 rate at the card's max SM clock,
    plus the bytes a collective brings in from the other cards over
    NVLink."""

    def __init__(self, sm_clock_mhz: float):
        self.sm_clock_mhz = sm_clock_mhz
        self.int_ops_per_s = SMS * INT32_LANES_PER_SM * sm_clock_mhz * 1e6

    def __call__(self, n_bytes: float, n_ops: float,
                 link_bytes: float = 0) -> tuple[float, str]:
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / self.int_ops_per_s * 1e3
        t_link = link_bytes / NVLINK_BYTES_PER_S * 1e3
        if t_bytes >= t_ops:
            return t_bytes + t_link, "bytes"
        return t_ops + t_link, ("operations" if t_ops >= t_link
                                else "bytes")


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


def device_us(call, reps: int = 20) -> float:
    """Device microseconds a call of ``call`` (every kernel and copy it
    issues, host work left out): ``torch.profiler``'s CUDA activity over
    ``reps`` calls after a warm-up, summed by name over the calls. A
    profile that recorded nothing is taken again, up to three times; then
    it raises, as a device time was not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        total = sum(getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0)
                    for e in prof.key_averages())
        if total:
            return total / reps
    raise RuntimeError("torch.profiler recorded no device time in three "
                       "profiles")


def max_abs_err(a, b) -> int:
    import torch
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def field_err(got, want, canonical: bool = True) -> int:
    """Largest absolute difference over the tensors of ``got`` and
    ``want`` (each a tensor or a tuple of them): of canonical field values
    when ``canonical``, else of the raw words; a pair of flag tensors
    counts 1 where the flags differ."""
    import torch

    from .ops import bigint as bi
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        w = w.to(g.device)
        if g.dtype == torch.bool or w.dtype == torch.bool:
            same = torch.equal(g.to(torch.bool), w.to(torch.bool))
            err = max(err, 0 if same else 1)
        elif canonical:
            err = max(err, max_abs_err(bi.canonical(g), bi.canonical(w)))
        else:
            err = max(err, max_abs_err(g, w))
    return err


def g2_projective_err(got, want) -> int:
    """``field_err`` of two Jacobian G2 points (x, y, z), each [..., 2, 32],
    as points: of their canonical affine forms (X/Z^2, Y/Z^3; infinity
    maps to (0, 0), which no curve point has), plus 1 where one is
    infinity and the other is not. Zero exactly when the two are the same
    point, whatever their Jacobian representatives (a tree-ordered sum
    and a row-ordered one differ by (l^2, l^3, l))."""
    import torch

    from .ops import bigint as bi
    from .ops import bls12_381 as k
    want = tuple(w.to(got[0].device) for w in want)
    inf_g, inf_w = bi.is_zero_mod(got[2]).all(-1), bi.is_zero_mod(
        want[2]).all(-1)
    return field_err(k._jacobian_to_affine_fp2_plain(*got),
                     k._jacobian_to_affine_fp2_plain(*want)) + int(
        not torch.equal(inf_g, inf_w))


def g1_projective_err(got, want) -> int:
    """``g2_projective_err`` for Jacobian G1 points, each [..., 32]."""
    import torch

    from .ops import bigint as bi
    from .ops import bls12_381 as k
    want = tuple(w.to(got[0].device) for w in want)
    inf_g, inf_w = bi.is_zero_mod(got[2]), bi.is_zero_mod(want[2])
    return field_err(k._jacobian_to_affine_fp_plain(*got),
                     k._jacobian_to_affine_fp_plain(*want)) + int(
        not torch.equal(inf_g, inf_w))


def nvidia_smi(query: str) -> str:
    """The first card's answer to ``nvidia-smi --query-gpu=QUERY``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def mont_mul_modes(batch: int = 1 << 16, k: int = 32, reps: int = 3,
                   check_lanes: int = 1024) -> dict:
    """Montgomery products a second for each multiply lowering (0, 1, 2):
    the port of ``bench.py`` ``bench_mont_mul_modes``. ``k`` dependent
    products ``acc = mont_mul(acc, v)`` over a [batch, 32] batch (``k``
    launches of ``bigint.mont_mul``), best of ``reps`` on the host clock
    around a synchronised run, after a warm run that builds the mode's
    variant. The input is built as the bench builds it (``default_rng(3)``,
    top limb below 0x1A0, so values below 2p). Also: the first
    ``check_lanes`` of each mode's chain against the plain chain of the
    same mode (max_abs_err of the limbs: the plain version takes the JAX
    steps, the kernel its own, so of canonical values), and whether the
    three modes' final accumulators are canonically equal. Runs on the
    port's device; the mode in force before the call is restored, also on
    a failure."""
    import time

    import numpy as np
    import torch

    from .device import resolve
    from .ops import bigint as bi

    dev = resolve(None)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << bi.LIMB_BITS, size=(batch, bi.NLIMBS),
                     dtype=np.int32)
    x[:, -1] = rng.integers(0, 0x1A0, size=batch)
    v = torch.from_numpy(x).to(dev)
    cuda = v.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def chain(mul, lanes):
        acc = lanes
        for _ in range(k):
            acc = mul(acc, lanes)
        return acc

    per_sec, best_s, err, finals = {}, {}, {}, {}
    prev = bi.mxu_mode()
    try:
        for mode in (0, 1, 2):
            bi.set_mxu_mode(mode)
            final = chain(bi.mont_mul, v)            # build, warm
            sync()
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                chain(bi.mont_mul, v)
                sync()
                best = min(best, time.perf_counter() - t0)
            per_sec[mode], best_s[mode] = batch * k / best, best
            head = v[:check_lanes]
            err[mode] = field_err(final[:check_lanes],
                                  chain(bi._mont_mul_plain, head))
            finals[mode] = bi.canonical(final)
    finally:
        bi.set_mxu_mode(prev)
    return {"batch": batch, "k": k, "per_sec": per_sec, "best_s": best_s,
            "speedup_vs_mode0": max(per_sec[1], per_sec[2]) / per_sec[0],
            "max_abs_err_vs_plain": err,
            "modes_agree": all(torch.equal(finals[0], finals[m])
                               for m in (1, 2))}
