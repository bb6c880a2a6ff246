"""``g2_sum`` and ``miller_loop`` of this tree against another tree's, on
one card, in one process.

    git archive <commit> lighthouse_tpu_torch/csrc | tar -x -C BASE
    python -m lighthouse_tpu_torch.compare_kernels --base BASE \\
        --out compare_kernels.json

Builds both trees' ``aggregate.cu`` (``lh_g2_sum``) and ``pairing.cu``
(``lh_miller_loop``) in each multiply lowering (modes 0, 1, 2) with the
flags of ``kernels.py``, and this tree's ``pairing.cu`` once more with
each of its two Miller designs forced (``-DLH_ML_COOP_MAX``). On seeded
inputs (``default_rng(5)``: 64 G2 and 64 G1 points, tiled and scaled by
random 64-bit scalars on the card, so every lane is its own Jacobian
point; the Miller pairs their affine forms) it times, by CUDA events
(median of 5 after a warm-up), in the order base, this, this, base: the
G2 sum of 10,240 points (the 10k batch's signature lanes) and the Miller
loop of 129 pairs, one masked (its pairs); then the two Miller designs
on the verification's pairs past 128 messages (mode 0): 10,241 pairs of
which L are live (the first L - 1 and the last, as the verification
lays out its message lanes and the aggregate), a thread a pair on all
10,241 against a block a pair on the L live pairs gathered, their
outputs scattered back among identities, as ``miller_loop_batch`` does
(the sweep that sets ``LH_ML_COOP_MAX``); and the G2 sums at growing
point counts, the base tree's against this one's. Every pair of outputs
is held equal: Miller values canonically, sums as points
(``measure.g2_projective_err``: the trees add in different orders).
Prints a line a measurement, with the card's name and power limit, and
writes them as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from . import kernels
from .measure import field_err, g2_projective_err, nvidia_smi

_MILLER_PAIRS = 10241
_MILLER_LIVE = (129, 257, 513, 1025, 1537, 2049, 2561, 3073, 5121, 10241)
_SUM_SWEEP = (128, 256, 1024, 4096, 10240)
_ENTRIES = {"lh_g2_sum": kernels.G2_SUM, "lh_miller_loop": kernels.MILLER_LOOP}


def _build(jobs: dict, out_dir: Path) -> dict:
    """{tag: (source, defines, symbol)} -> {tag: bound C entry}, all
    nvcc processes at once."""
    procs = {}
    for tag, (src, defines, _) in jobs.items():
        lib = out_dir / f"{tag}.so"
        procs[tag] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        symbol = jobs[tag][2]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = _ENTRIES[symbol].argtypes
        fn.restype = ctypes.c_int
        fns[tag] = fn
    return fns


def _inputs(n_max: int):
    """``n_max`` Jacobian G2 points and ``n_max`` affine pairs on the
    card (see the module docstring)."""
    import torch

    from .crypto.bls12_381 import G1_GENERATOR, G2_GENERATOR
    from .ops import bls12_381 as k

    rng = np.random.default_rng(5)
    base = 64

    def tiled(arr, shape):
        return torch.from_numpy(np.ascontiguousarray(
            np.resize(arr, (n_max,) + shape))).cuda()

    def bits():
        return torch.from_numpy(k.scalars_to_bits(
            [int(s) for s in rng.integers(1, 2**63, size=n_max)],
            64)).cuda()

    g2 = [G2_GENERATOR.mul(int(rng.integers(1, 2**62))).to_affine()
          for _ in range(base)]
    g1 = [G1_GENERATOR.mul(int(rng.integers(1, 2**62))).to_affine()
          for _ in range(base)]
    one2 = tiled(k.FP2_ONE, (2, 32))
    one1 = tiled(k.FP_ONE, (32,))
    sig = k.g2_scalar_mul(tiled(k.fp2_encode([p[0] for p in g2]), (2, 32)),
                          tiled(k.fp2_encode([p[1] for p in g2]), (2, 32)),
                          one2, bits())
    pk = k.g1_scalar_mul(tiled(k.fp_encode([p[0] for p in g1]), (32,)),
                         tiled(k.fp_encode([p[1] for p in g1]), (32,)),
                         one1, bits())
    qx, qy = k.jacobian_to_affine_fp2(*sig)
    px, py = k.jacobian_to_affine_fp(*pk)
    return sig, (px, py, qx, qy)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="a directory holding another tree's "
                         "lighthouse_tpu_torch/csrc")
    ap.add_argument("--out", help="also write the measurements as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels needs an NVIDIA card")

    card = nvidia_smi("name,power.limit")
    trees = {"base": args.base / "lighthouse_tpu_torch" / "csrc" / "bls",
             "this": kernels.CSRC / "bls"}
    jobs = {}
    for tree, d in trees.items():
        for m in (0, 1, 2):
            flag = (f"-DLH_FP_MODE={m}",)
            jobs[f"{tree}_sum{m}"] = (d / "aggregate.cu", flag, "lh_g2_sum")
            jobs[f"{tree}_ml{m}"] = (d / "pairing.cu", flag,
                                     "lh_miller_loop")
    for tag, cap in (("one_thread", 0), ("cooperative", 1 << 30)):
        jobs[tag] = (trees["this"] / "pairing.cu",
                     (f"-DLH_ML_COOP_MAX={cap}",), "lh_miller_loop")
    from .ops import bls12_381 as k
    kernels.build_all([kernels.RLC_SCALE, kernels.AFFINE])
    with tempfile.TemporaryDirectory() as tmp:
        fns = _build(jobs, Path(tmp))
        stream = torch.cuda.current_stream().cuda_stream
        n_max = max(_MILLER_PAIRS, max(_SUM_SWEEP))
        sig, pairs = _inputs(n_max)

        def g2_sum(fn, n):
            x, y, z = (c[:n].contiguous() for c in sig)
            out = [torch.empty(2, 32, dtype=torch.int32, device="cuda")
                   for _ in range(3)]
            assert fn(x.data_ptr(), y.data_ptr(), z.data_ptr(), n,
                      *(o.data_ptr() for o in out), stream) == 0
            return tuple(out)

        def miller(fn, args, mask):
            n = args[0].shape[0]
            px, py, qx, qy = (c.contiguous() for c in args)
            out = torch.empty(n, 2, 3, 2, 32, dtype=torch.int32,
                              device="cuda")
            assert fn(px.data_ptr(), py.data_ptr(), qx.data_ptr(),
                      qy.data_ptr(), mask.data_ptr(), out.data_ptr(), n,
                      stream) == 0
            return out

        def miller_live(fn, n, live):
            """``fn`` on the pairs at lanes ``live`` of the first n alone,
            scattered back among identities (``miller_loop_batch``)."""
            ones = torch.ones(live.size, dtype=torch.int32, device="cuda")
            return k._on_live_lanes(lambda *a: miller(fn, a, ones), live,
                                    *(c[:n] for c in pairs))

        one_masked = np.ones(129, np.int32)
        one_masked[127] = 0                  # the batch's padding lane
        one_masked = torch.from_numpy(one_masked).cuda()

        def ms(call):
            call()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            return statistics.median(times)

        def pair(label, first, second, err):
            """first(), second(), second(), first(); outputs equal by
            ``err``."""
            e = err(first(), second())
            if e != 0:
                raise SystemExit(f"{label}: the two differ "
                                 f"(max_abs_err {e})")
            t = [ms(first), ms(second), ms(second), ms(first)]
            rec = {"label": label, "first_ms": [t[0], t[3]],
                   "second_ms": [t[1], t[2]], "card": card}
            print(f"{label}: outputs equal; {t[0]:.4f} / {t[3]:.4f} ms "
                  f"against {t[1]:.4f} / {t[2]:.4f} ms [{card}]",
                  flush=True)
            return rec

        report = []
        p129 = [c[:129] for c in pairs]
        for m in (0, 1, 2):
            report.append(pair(
                f"mode {m} g2_sum, 10240 points: base against this",
                lambda m=m: g2_sum(fns[f"base_sum{m}"], 10240),
                lambda m=m: g2_sum(fns[f"this_sum{m}"], 10240),
                g2_projective_err))
            report.append(pair(
                f"mode {m} miller_loop, 129 pairs (one masked): base "
                f"against this",
                lambda m=m: miller(fns[f"base_ml{m}"], p129, one_masked),
                lambda m=m: miller(fns[f"this_ml{m}"], p129, one_masked),
                field_err))
        n = _MILLER_PAIRS
        for n_live in _MILLER_LIVE:
            mask = np.zeros(n, np.int32)
            mask[:n_live - 1] = mask[-1] = 1
            live, mask = np.flatnonzero(mask), torch.from_numpy(mask).cuda()
            report.append(pair(
                f"mode 0 miller_loop, {n} pairs, {n_live} live: a thread a "
                f"pair on all against a block a pair on the live",
                lambda mask=mask: miller(fns["one_thread"],
                                         [c[:n] for c in pairs], mask),
                lambda live=live: miller_live(fns["cooperative"], n, live),
                field_err))
        for n in _SUM_SWEEP:
            report.append(pair(
                f"mode 0 g2_sum, {n} points: base against this",
                lambda n=n: g2_sum(fns["base_sum0"], n),
                lambda n=n: g2_sum(fns["this_sum0"], n),
                g2_projective_err))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
