"""Where a lane-group kernel's time goes, on the card: clock64 per phase.

    python -m lighthouse_tpu_torch.profile_lane_steps --out profile.json

Copies ``csrc/bls`` into a temporary directory and instruments
``coop.cuh`` ``lg_step`` there (the clock before the products, after
them, after the sync that ends them, and after the linear stages) and
the lane-group kernels' loops (``rlc_scale.cu``, ``g2_intake.cu``), each
group's first thread adding its totals to a device array at the end;
builds the instrumented sources at a few widths (mode 0) and runs them
on seeded inputs (``default_rng(5)``: affine points tiled to 10,240 and
2,560 lanes, z one, random 63-bit scalars), printing each kernel's ms
(one CUDA-event run) and, a group on average: its steps, its multiply
rounds, and the cycles a step of products, of the wait at their sync,
of linear stages and of the whole loop. Then two micro-kernels: a chain
of dependent ``fp_mul_inl`` and of ``fp_add`` at 0.25-8 warps a
scheduler, the cycles an operation takes a warp. The instrumentation
stays in the temporary copy; the repository's sources are not touched.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from . import kernels
from .measure import nvidia_smi
from .testing.host_cuda import set_define

_WIDTHS = {"rlc_scale": (2, 3, 4, 8), "g2_intake": (3, 4, 8)}
_MACROS = {"rlc_scale": ("LH_RLC_G1_WIDTH", "LH_RLC_G2_WIDTH"),
           "g2_intake": ("LH_G2I_WIDTH",)}
_LANES = (10240, 2560)

_PROF_DECL = r'''
__device__ unsigned long long lg_prof[8];
struct LgProf { unsigned long long a[5]; };
'''

_MICRO = r'''
template <int ADD>
__global__ void lat_kernel(int iters, unsigned long long* out) {
    Fp a, b;
    fp_one(a);
    fp_one(b);
    a.w[0] += threadIdx.x;
    const long long c0 = clock64();
    for (int i = 0; i < iters; ++i) {
        if (ADD) fp_add(a, a, b); else fp_mul_inl(a, a, b);
    }
    const long long c1 = clock64();
    if ((threadIdx.x & 31) == 0)
        atomicAdd(out, (unsigned long long)(c1 - c0));
    if (a.w[3] == 12345u) out[1] = 1;     // keep the chain
}

extern "C" int lh_latency(int add, int blocks, int threads, int iters,
                          void* out) {
    if (add) lat_kernel<1><<<blocks, threads>>>(iters, (unsigned long long*)out);
    else lat_kernel<0><<<blocks, threads>>>(iters, (unsigned long long*)out);
    return (int)cudaDeviceSynchronize();
}

extern "C" int lh_prof(void* dst) {
    unsigned long long zero[8] = {0};
    cudaMemcpyFromSymbol(dst, lg_prof, sizeof(zero));
    cudaMemcpyToSymbol(lg_prof, zero, sizeof(zero));
    return (int)cudaDeviceSynchronize();
}
'''

_PROF_END = (
    "#define LG_PROF_END if (g.t == 0) { for (int q = 0; q < 5; ++q) "
    "atomicAdd(&lg_prof[q], P.a[q]); atomicAdd(&lg_prof[5], "
    "(unsigned long long)(clock64() - k0)); atomicAdd(&lg_prof[6], 1ull); }")


def _instrument_coop(text: str) -> str:
    """lg_step with clocks around its phases, accumulated into P."""
    pairs = [
        ("struct LgStep {", _PROF_DECL + "struct LgStep {"),
        ("LH_DEV void lg_step(const Lg& g, int s) {\n",
         "LH_DEV void lg_step(const Lg& g, int s, LgProf& P) {\n"
         "    const long long c0 = clock64();\n"),
        ("        lg_st(g.V + (d & 255u), r);\n    }\n    __syncwarp(g.mask);\n",
         "        lg_st(g.V + (d & 255u), r);\n    }\n"
         "    const long long c1 = clock64();\n    __syncwarp(g.mask);\n"
         "    const long long c2 = clock64();\n"),
        ("        __syncwarp(g.mask);\n    }\n}\n",
         "        __syncwarp(g.mask);\n    }\n"
         "    P.a[0] += c1 - c0; P.a[1] += c2 - c1; P.a[2] += clock64() - c2;\n"
         "    P.a[3] += 1; P.a[4] += (st.nj + g.G - 1) / g.G;\n}\n"),
    ]
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"coop.cuh changed: cannot instrument {old!r}")
        text = text.replace(old, new)
    return text + _MICRO


def _instrument_kernel(text: str) -> str:
    """The kernels' lg_step calls take P; each group reports at its end."""
    text = re.sub(r"lg_step\(g, ([^;]*)\);", r"lg_step(g, \1, P);", text)
    text = text.replace("    Lg g;\n    long long lane;\n",
                        "    Lg g;\n    long long lane;\n    LgProf P = {};\n"
                        "    const long long k0 = clock64();\n")
    text = text.replace('#include "coop.cuh"',
                        '#include "coop.cuh"\n' + _PROF_END)
    for end in ("    lg_store_point(g, L::D, ox, oy, oz, lane, L::X);\n}",
                "    if (g.t == 0) ok[lane] = good ? 1 : 0;\n}"):
        text = text.replace(end, "    LG_PROF_END\n" + end)
    if "LgProf P" not in text or text.count("LG_PROF_END") < 2:
        raise RuntimeError("the kernel changed: cannot instrument it")
    return text


def _build(tmp: Path) -> dict:
    """{(source, width): library} of the instrumented sources."""
    jobs = {}
    for name, widths in _WIDTHS.items():
        for w in widths:
            d = tmp / f"{name}_w{w}"
            shutil.copytree(kernels.CSRC / "bls", d)
            coop = d / "coop.cuh"
            coop.write_text(_instrument_coop(coop.read_text()))
            src = d / f"{name}.cu"
            text = src.read_text()
            for macro in _MACROS[name]:
                text = set_define(text, macro, w)
            src.write_text(_instrument_kernel(text))
            jobs[(name, w)] = (src, d / f"lib{name}.so")
    procs = {key: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, (src, lib) in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(jobs[key][1]))
    return libs


def main(argv=None) -> int:
    import torch

    from .crypto.bls12_381 import G1_GENERATOR, G2_GENERATOR
    from .ops import bls12_381 as k

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_lane_steps needs an NVIDIA card")
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    rng = np.random.default_rng(5)
    n_max = max(_LANES)

    def tiled(a, shape):
        return torch.from_numpy(np.ascontiguousarray(
            np.resize(a, (n_max,) + shape))).cuda()

    g2 = [G2_GENERATOR.mul(int(rng.integers(1, 2**62))).to_affine()
          for _ in range(32)]
    g1 = [G1_GENERATOR.mul(int(rng.integers(1, 2**62))).to_affine()
          for _ in range(32)]
    pts = {2: (tiled(k.fp2_encode([p[0] for p in g2]), (2, 32)),
               tiled(k.fp2_encode([p[1] for p in g2]), (2, 32)),
               tiled(k.FP2_ONE, (2, 32))),
           1: (tiled(k.fp_encode([p[0] for p in g1]), (32,)),
               tiled(k.fp_encode([p[1] for p in g1]), (32,)),
               tiled(k.FP_ONE, (32,)))}
    bits = torch.from_numpy(k.scalars_to_bits(
        [int(s) for s in rng.integers(1, 2**63, size=n_max)], 64)).cuda()
    flags = torch.zeros(n_max, dtype=torch.int32, device="cuda")
    ok = torch.empty(n_max, dtype=torch.int32, device="cuda")
    y = torch.empty_like(pts[2][0])
    outs = {d: [torch.empty_like(pts[d][0]) for _ in range(3)]
            for d in (1, 2)}
    stream = torch.cuda.current_stream().cuda_stream
    P = ctypes.c_void_p
    prof = np.zeros(8, np.uint64)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(Path(tmp))
        for (name, w), lib in libs.items():
            for n in _LANES:
                for what in ((1, 2) if name == "rlc_scale" else (0, 1)):
                    if name == "rlc_scale":
                        def call(lib=lib, d=what, n=n):
                            return lib.lh_rlc_scale(
                                d, *(P(t.data_ptr()) for t in pts[d]),
                                P(bits.data_ptr()), 64,
                                *(P(t.data_ptr()) for t in outs[d]),
                                ctypes.c_longlong(n), P(stream))
                        label = f"rlc_scale G{what}"
                    else:
                        x2, y2, z2 = pts[2]

                        def call(lib=lib, mode=what, n=n):
                            if mode == 0:
                                return lib.lh_g2_intake(
                                    0, P(x2.data_ptr()), P(flags.data_ptr()),
                                    P(y.data_ptr()), None, P(ok.data_ptr()),
                                    ctypes.c_longlong(n), P(stream))
                            return lib.lh_g2_intake(
                                1, P(x2.data_ptr()), None, P(y2.data_ptr()),
                                P(z2.data_ptr()), P(ok.data_ptr()),
                                ctypes.c_longlong(n), P(stream))
                        label = ("g2_intake decompress" if what == 0
                                 else "g2_intake subgroup")
                    assert call() == 0
                    torch.cuda.synchronize()
                    lib.lh_prof(prof.ctypes.data_as(P))
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    assert call() == 0
                    b.record()
                    b.synchronize()
                    lib.lh_prof(prof.ctypes.data_as(P))
                    groups, steps = int(prof[6]), int(prof[3])
                    rec = {"kernel": label, "width": w, "lanes": n,
                           "ms": a.elapsed_time(b),
                           "steps": steps / groups,
                           "rounds": int(prof[4]) / groups,
                           "products_cycles": int(prof[0]) / steps,
                           "wait_cycles": int(prof[1]) / steps,
                           "linear_cycles": int(prof[2]) / steps,
                           "loop_cycles": int(prof[5]) / steps,
                           "card": card}
                    rows.append(rec)
                    print(f"{label}, {w} threads a lane, {n} lanes: "
                          f"{rec['ms']:.3f} ms; a group {rec['steps']:.0f} "
                          f"steps, {rec['rounds']:.0f} rounds; cycles a "
                          f"step: products {rec['products_cycles']:.0f}, "
                          f"wait {rec['wait_cycles']:.0f}, linear "
                          f"{rec['linear_cycles']:.0f}, loop "
                          f"{rec['loop_cycles']:.0f} [{card}]", flush=True)
        lib = next(iter(libs.values()))
        for add, op in ((0, "fp_mul_inl"), (1, "fp_add")):
            for blocks, threads in ((132, 32), (132, 128), (132, 256),
                                    (264, 256), (528, 256)):
                out = torch.zeros(2, dtype=torch.int64, device="cuda")
                assert lib.lh_latency(add, blocks, threads, 200,
                                      P(out.data_ptr())) == 0
                out.zero_()
                assert lib.lh_latency(add, blocks, threads, 200,
                                      P(out.data_ptr())) == 0
                warps = blocks * threads // 32
                cyc = int(out[0]) / warps / 200
                rows.append({"op": op, "warps_a_scheduler": warps / 528,
                             "cycles": cyc, "card": card})
                print(f"{op}: {warps / 528:.2f} warps a scheduler, "
                      f"{cyc:.0f} cycles an op a warp [{card}]", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
