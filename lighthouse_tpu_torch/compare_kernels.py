"""``final_exp`` and ``hash_to_g2`` of this tree against another tree's, on
one card, in one process.

    git archive <commit> lighthouse_tpu_torch/csrc | tar -x -C BASE
    python -m lighthouse_tpu_torch.compare_kernels --base BASE \\
        --out compare_kernels.json

Builds both trees' ``pairing.cu`` and ``hash_to_g2.cu`` in each multiply
lowering (modes 0, 1, 2) with the flags of ``kernels.py``, and this tree's
``hash_to_g2.cu`` once more with each of its two designs forced
(``-DLH_H2G_COOP_MAX``). On seeded inputs (129 Fp12 values, the 10k
batch's Miller pair count; 128 messages' u0, u1, its message lanes) it
times, by CUDA events (median of 5 after a warm-up), in the order base,
this, this, base: the final exponentiation of the product, the product
alone, and hash-to-G2; then the two hash-to-G2 designs at growing batches
and the product at growing n (mode 0). Every pair of outputs is held
canonical-equal. Prints a line a measurement, with the card's name and
power limit, and writes them as JSON.
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
from .measure import nvidia_smi

_WIDE_HASH = (128, 256, 512, 1024, 1536, 2048, 4096, 10240)
_WIDE_PRODUCT = (129, 257, 1025, 4097, 10241)


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
        fn.argtypes = (kernels.FINAL_EXP if symbol == "lh_final_exp"
                       else kernels.HASH_TO_G2).argtypes
        fn.restype = ctypes.c_int
        fns[tag] = fn
    return fns


def main(argv=None) -> int:
    import torch

    from .crypto.bls12_381.hash_to_curve import DST_POP
    from .ops import bigint as bi
    from .ops import bls12_381 as k

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
            jobs[f"{tree}_fe{m}"] = (d / "pairing.cu", flag, "lh_final_exp")
            jobs[f"{tree}_h2g{m}"] = (d / "hash_to_g2.cu", flag,
                                      "lh_hash_to_g2")
    for tag, cap in (("one_thread", 0), ("cooperative", 1 << 30)):
        jobs[tag] = (trees["this"] / "hash_to_g2.cu",
                     (f"-DLH_H2G_COOP_MAX={cap}",), "lh_hash_to_g2")
    with tempfile.TemporaryDirectory() as tmp:
        fns = _build(jobs, Path(tmp))
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(5)
        vals = [int.from_bytes(rng.bytes(48), "little") % k.P_INT
                for _ in range(12 * max(_WIDE_PRODUCT))]
        fs_all = torch.from_numpy(k.fp_encode(vals).reshape(
            -1, 2, 3, 2, 32)).cuda()
        u_all = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in k.hash_to_field_host(
                     [rng.bytes(32) for _ in range(max(_WIDE_HASH))],
                     DST_POP)]

        def final_exp(fn, mode, n):
            fs = fs_all[:n].contiguous()
            out = torch.empty(2, 3, 2, 32, dtype=torch.int32, device="cuda")
            flag = torch.empty(1, dtype=torch.int32, device="cuda")
            assert fn(mode, fs.data_ptr(), n, out.data_ptr(),
                      flag.data_ptr(), stream) == 0
            return [out]

        def hash_to_g2(fn, n):
            u0, u1 = (u[:n].contiguous() for u in u_all)
            out = [torch.empty(n, 2, 32, dtype=torch.int32, device="cuda")
                   for _ in range(3)]
            assert fn(u0.data_ptr(), u1.data_ptr(),
                      *(o.data_ptr() for o in out), n, stream) == 0
            return out

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

        def equal(xs, ys):
            return all(torch.equal(bi.canonical(x.cpu()),
                                   bi.canonical(y.cpu()))
                       for x, y in zip(xs, ys))

        def pair(label, first, second, run):
            """first, second, second, first; outputs equal."""
            if not equal(run(first), run(second)):
                raise SystemExit(f"{label}: the two builds differ")
            t = [ms(lambda: run(first)), ms(lambda: run(second))]
            t += [ms(lambda: run(second)), ms(lambda: run(first))]
            rec = {"label": label, "first_ms": [t[0], t[3]],
                   "second_ms": [t[1], t[2]], "card": card}
            print(f"{label}: outputs equal; {t[0]:.4f} / {t[3]:.4f} ms "
                  f"against {t[1]:.4f} / {t[2]:.4f} ms [{card}]",
                  flush=True)
            return rec

        report = []
        for m in (0, 1, 2):
            base_fe, this_fe = fns[f"base_fe{m}"], fns[f"this_fe{m}"]
            base_h, this_h = fns[f"base_h2g{m}"], fns[f"this_h2g{m}"]
            report.append(pair(
                f"mode {m} final_exp, 129 values + final exp: base against "
                f"this", base_fe, this_fe, lambda f: final_exp(f, 1, 129)))
            report.append(pair(
                f"mode {m} final_exp product, 129 values: base against "
                f"this", base_fe, this_fe, lambda f: final_exp(f, 0, 129)))
            report.append(pair(
                f"mode {m} hash_to_g2, 128 messages: base against this",
                base_h, this_h, lambda f: hash_to_g2(f, 128)))
        for n in _WIDE_HASH:
            report.append(pair(
                f"mode 0 hash_to_g2, {n} messages: one-thread against "
                f"cooperative", fns["one_thread"], fns["cooperative"],
                lambda f, n=n: hash_to_g2(f, n)))
        for n in _WIDE_PRODUCT:
            report.append(pair(
                f"mode 0 final_exp product, {n} values: base against this",
                fns["base_fe0"], fns["this_fe0"],
                lambda f, n=n: final_exp(f, 0, n)))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
