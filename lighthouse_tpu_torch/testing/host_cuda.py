"""Build and run the port's cooperative kernels on the host.

``build(name, out_dir, mode)`` cuts the C entries (their launch syntax)
off ``csrc/<source>``, compiles it with g++ against the stand-ins of
``host_cuda.h`` (one std::thread a CUDA thread, barriers for
``__syncthreads``/``__syncwarp`` and for a cooperative launch's grid
barrier; ``host_include/`` for the CUDA headers) and returns the
program; ``final_exp``, ``hash_to_g2``, ``g2_sum``, ``miller_loop``,
``rlc_scale``, ``g2_intake``, ``affine``, ``g1_segment_sum``,
``cap_fold``, ``path_walk``, ``fp12_pow`` and ``fp_ops`` run it on
int32 arrays as the kernels' C entries take them, launching the
kernels as the C entries do (each main repeats its entry's choice). The CPU tests hold the
results to the plain versions: the arithmetic of the CUDA source, not
its build for the card.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..kernels import CSRC

_HERE = Path(__file__).resolve().parent

_MAINS = {
    "final_exp": ("bls/pairing.cu", r'''
int main(int, char** argv) {
    const int mode = atoi(argv[1]);
    const std::vector<int32_t> fs = host_read(argv[2]);
    std::vector<int32_t> out(12 * LH_LIMBS), flag(1);
    host_launch(1, LH_FE_THREADS, [&] {
        final_exp_kernel(mode, fs.data(), (long long)fs.size() / (12 * LH_LIMBS),
                         out.data(), flag.data());
    });
    host_write(argv[3], out);
    host_write(argv[4], flag);
}
'''),
    "hash_to_g2": ("bls/hash_to_g2.cu", r'''
int main(int, char** argv) {
    const std::vector<int32_t> u0 = host_read(argv[1]), u1 = host_read(argv[2]);
    const unsigned n = u0.size() / (2 * LH_LIMBS);
    std::vector<int32_t> ox(u0.size()), oy(u0.size()), oz(u0.size());
    if (n > LH_H2G_COOP_MAX)        // as lh_hash_to_g2 picks the design
        host_launch((n + 31) / 32, 32, [&] {
            hash_to_g2_kernel(u0.data(), u1.data(), ox.data(), oy.data(),
                              oz.data(), n);
        });
    else
        host_launch(n, LH_H2G_THREADS, [&] {
            hash_to_g2_coop_kernel(u0.data(), u1.data(), ox.data(),
                                   oy.data(), oz.data());
        });
    host_write(argv[3], ox);
    host_write(argv[4], oy);
    host_write(argv[5], oz);
}
'''),
    "g2_sum": ("bls/aggregate.cu", r'''
int main(int, char** argv) {
    const std::vector<int32_t> x = host_read(argv[1]), y = host_read(argv[2]),
                               z = host_read(argv[3]);
    const long long n = x.size() / (2 * LH_LIMBS);
    const long long blocks = g2_sum_blocks(n);
    std::vector<int32_t> px(blocks * 2 * LH_LIMBS), py(px.size()),
        pz(px.size()), ox(2 * LH_LIMBS), oy(ox.size()), oz(ox.size());
    host_launch(blocks, LH_G2_SUM_T, [&] {    // as lh_g2_sum: two launches
        g2_sum_kernel(x.data(), y.data(), z.data(), n, px.data(), py.data(),
                      pz.data());
    });
    host_launch(1, LH_G2_SUM_T, [&] {
        g2_sum_kernel(px.data(), py.data(), pz.data(), blocks, ox.data(),
                      oy.data(), oz.data());
    });
    host_write(argv[4], ox);
    host_write(argv[5], oy);
    host_write(argv[6], oz);
}
'''),
    "rlc_scale": ("bls/rlc_scale.cu", r'''
int main(int, char** argv) {
    const int field = atoi(argv[1]), nbits = atoi(argv[2]);
    const std::vector<int32_t> x = host_read(argv[3]), y = host_read(argv[4]),
                               z = host_read(argv[5]), bits = host_read(argv[6]);
    const int d = field == 1 ? 1 : 2;
    const long long n = x.size() / (d * LH_LIMBS);
    std::vector<int32_t> ox(x.size()), oy(x.size()), oz(x.size());
    auto run = [&](auto kernel, int G) {     // as lh_rlc_scale launches
        const int lanes = lg_lanes(LH_RLC_THREADS, G);
        host_launch((n + lanes - 1) / lanes, LH_RLC_THREADS, [&] {
            kernel(x.data(), y.data(), z.data(), bits.data(), nbits,
                   ox.data(), oy.data(), oz.data(), n);
        });
    };
    if (field == 1) run(scale_kernel<Fp>, RlcLayout<Fp>::G);
    else run(scale_kernel<Fp2>, RlcLayout<Fp2>::G);
    host_write(argv[7], ox);
    host_write(argv[8], oy);
    host_write(argv[9], oz);
}
'''),
    "g2_intake": ("bls/g2_intake.cu", r'''
int main(int, char** argv) {
    const int mode = atoi(argv[1]);
    const std::vector<int32_t> x = host_read(argv[2]), b = host_read(argv[3]),
                               c = host_read(argv[4]);
    const long long n = x.size() / (2 * LH_LIMBS);
    std::vector<int32_t> y(x.size()), ok(n);
    const int lanes = lg_lanes(LH_G2I_THREADS, LH_G2I_WIDTH);
    host_launch((n + lanes - 1) / lanes, LH_G2I_THREADS, [&] {
        if (mode == 0)      // b: the sign flags
            decompress_kernel(x.data(), b.data(), y.data(), ok.data(), n);
        else                // b, c: y and z
            subgroup_kernel(x.data(), b.data(), c.data(), ok.data(), n);
    });
    host_write(argv[5], y);
    host_write(argv[6], ok);
}
'''),
    "miller_loop": ("bls/pairing.cu", r'''
int main(int, char** argv) {
    const std::vector<int32_t> px = host_read(argv[1]), py = host_read(argv[2]),
                               qx = host_read(argv[3]), qy = host_read(argv[4]),
                               mask = host_read(argv[5]);
    const long long n = mask.size();
    std::vector<int32_t> out(n * 12 * LH_LIMBS);
    if (n > LH_ML_COOP_MAX)         // as lh_miller_loop picks the design
        host_launch((n + 31) / 32, 32, [&] {
            miller_loop_kernel(px.data(), py.data(), qx.data(), qy.data(),
                               mask.data(), out.data(), n);
        });
    else
        host_launch(n, LH_ML_THREADS, [&] {
            miller_loop_coop_kernel(px.data(), py.data(), qx.data(),
                                    qy.data(), mask.data(), out.data());
        });
    host_write(argv[6], out);
}
'''),
    "affine": ("bls/aggregate.cu", r'''
int main(int, char** argv) {
    const int field = atoi(argv[1]);
    const std::vector<int32_t> x = host_read(argv[2]), y = host_read(argv[3]),
                               z = host_read(argv[4]);
    const long long n = x.size() / (field * LH_LIMBS);
    std::vector<int32_t> ox(x.size()), oy(x.size());
    const int t = LH_AFFINE_THREADS;        // as lh_affine launches
    host_launch((n + t - 1) / t, t, [&] {
        if (field == 1)
            affine_kernel<Fp>(x.data(), y.data(), z.data(), ox.data(),
                              oy.data(), n);
        else
            affine_kernel<Fp2>(x.data(), y.data(), z.data(), ox.data(),
                               oy.data(), n);
    });
    host_write(argv[5], ox);
    host_write(argv[6], oy);
}
'''),
    "g1_segment_sum": ("bls/aggregate.cu", r'''
// as lh_g1_segment_sum: one cooperative launch at its T
template <int T>
void seg_run(long long grid, const int32_t* x, const int32_t* y,
             const int32_t* z, const int32_t* starts, long long n,
             const int32_t* ends, long long g, SegWork w, int32_t* ox,
             int32_t* oy, int32_t* oz) {
    host_launch_coop(grid, SegShape<T>::threads, [&] {
        seg_sum_kernel<T>(x, y, z, starts, n, ends, g, w, ox, oy, oz);
    });
}

int main(int, char** argv) {
    const long long cap = atoll(argv[1]);     // the co-resident blocks
    const std::vector<int32_t> x = host_read(argv[2]), y = host_read(argv[3]),
                               z = host_read(argv[4]),
                               starts = host_read(argv[5]),
                               ends = host_read(argv[6]);
    const long long n = starts.size(), g = ends.size();
    std::vector<int32_t> work(seg_work_words(n, g)), ox(g * LH_LIMBS),
        oy(ox.size()), oz(ox.size());
    const SegWork w = seg_work(work.data(), n, g);
    const int t = seg_piece_lanes(n, g);
    const long long grid = seg_grid(n, t, cap);
    if (t == LH_SEG_T_SHORT)
        seg_run<LH_SEG_T_SHORT>(grid, x.data(), y.data(), z.data(),
                                starts.data(), n, ends.data(), g, w,
                                ox.data(), oy.data(), oz.data());
    else
        seg_run<LH_SEG_T_LONG>(grid, x.data(), y.data(), z.data(),
                               starts.data(), n, ends.data(), g, w,
                               ox.data(), oy.data(), oz.data());
    host_write(argv[7], ox);
    host_write(argv[8], oy);
    host_write(argv[9], oz);
}
'''),
    "cap_fold": ("cap_fold.cu", r'''
int main(int, char** argv) {
    const int dense = atoi(argv[1]), limit = atoi(argv[2]);
    const std::vector<int32_t> root = host_read(argv[3]);
    std::vector<int32_t> out(8);
    host_launch(1, 1, [&] {
        cap_fold_kernel((const uint32_t*)root.data(), dense, limit,
                        (uint32_t*)out.data());
    });
    host_write(argv[4], out);
}
'''),
    "path_walk": ("path_update.cu", r'''
int main(int, char** argv) {
    const int depth = atoi(argv[1]);
    long long blocks = atoll(argv[2]);    // 0: as lh_path_walk picks
    const int limit = atoi(argv[3]);      // the root's caps' limit
    const std::vector<int32_t> rows = host_read(argv[4]);
    std::vector<int32_t> levels = host_read(argv[5]);   // level 0 first
    std::vector<int32_t> root(8);
    PathLevels L;
    long long at = 0;
    for (int l = 0; l <= depth; ++l) {
        L.lv[l] = (uint32_t*)levels.data() + at;
        at += (8LL << (depth - l));
    }
    const long long r = rows.size();
    if (blocks == 0) blocks = (r + LH_PATH_THREADS - 1) / LH_PATH_THREADS;
    host_launch_coop(blocks, LH_PATH_THREADS, [&] {
        path_walk_kernel(L, depth, rows.data(), r, limit,
                         (uint32_t*)root.data());
    });
    host_write(argv[6], levels);
    host_write(argv[7], root);
}
'''),
    "fp12_pow": ("bls/fp12_pow.cu", r'''
int main(int, char** argv) {
    const int lanes = atoi(argv[1]), nbits = atoi(argv[2]);
    const std::vector<int32_t> f = host_read(argv[3]), bits = host_read(argv[4]);
    const long long n = f.size() / (12 * LH_LIMBS);
    std::vector<int32_t> out(f.size());
    auto run = [&](auto kernel) {   // as lh_fp12_pow launches at L lanes
        host_launch((n + lanes - 1) / lanes, lanes * LH_POW_TPL, [&] {
            kernel(f.data(), bits.data(), nbits, out.data(), n);
        });
    };
    if (lanes == 1) run(fp12_pow_kernel<1>);
    else if (lanes == 2) run(fp12_pow_kernel<2>);
    else run(fp12_pow_kernel<4>);
    host_write(argv[5], out);
}
'''),
    "fp_ops": ("bls/fp_ops.cu", r'''
int main(int, char** argv) {
    const int op = atoi(argv[1]);
    const std::vector<int32_t> a = host_read(argv[2]), b = host_read(argv[3]);
    const long long n = a.size() / (op == FP_OP_WIDE ? 2 * LH_LIMBS
                                                     : LH_LIMBS);
    std::vector<int32_t> out(n * LH_LIMBS);
    host_launch((n + FP_OPS_THREADS - 1) / FP_OPS_THREADS, FP_OPS_THREADS,
                [&] { fp_ops_kernel(op, a.data(), b.data(), out.data(), n); });
    host_write(argv[4], out);
}
'''),
}


def compiler() -> str | None:
    return shutil.which("g++")


def set_define(text: str, macro: str, value) -> str:
    """``text`` with its ``#define macro ...`` line set to ``value`` (a
    design constant of a source, such as a lane group's width)."""
    line = re.compile(rf"^#define {macro} .*$", re.M)
    assert line.search(text), f"no #define {macro}"
    return line.sub(f"#define {macro} {value}", text)


def build(name: str, out_dir: Path, defines: tuple = (),
          constants: dict | None = None) -> Path:
    """The host program of kernel ``name`` (a key of ``_MAINS``), multiply
    lowering 0 (CIOS); ``defines``: ``-D`` flags of the build (a source's
    ``#ifndef`` knobs); ``constants``: ``#define`` lines of the source set
    to other values (``set_define``). Each build in a directory of its
    own."""
    source, main = _MAINS[name]
    text = (CSRC / source).read_text()
    for macro, value in (constants or {}).items():
        text = set_define(text, macro, value)
    body = text[:text.index('extern "C"')]
    tag = "".join("_" + d.lstrip("-D").replace("=", "") for d in defines)
    tag += "".join(f"_{m}{v}" for m, v in (constants or {}).items())
    out_dir = Path(out_dir) / (name + tag)
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}_host.cpp"
    src.write_text('#include "host_cuda.h"\n' + body + main)
    exe = out_dir / f"{name}_host"
    subprocess.run([compiler(), "-std=c++20", "-O2", "-pthread", "-w",
                    *defines, f"-I{_HERE}", f"-I{_HERE / 'host_include'}",
                    f"-I{CSRC}", f"-I{CSRC / 'bls'}", str(src), "-o",
                    str(exe)], check=True, capture_output=True, text=True)
    return exe


def _arr(path: Path, shape) -> np.ndarray:
    return np.fromfile(path, np.int32).reshape(shape)


def final_exp(exe: Path, mode: int, fs: np.ndarray):
    """(out [2, 3, 2, 32], flag) of the final_exp kernel on fs [n, 2, 3,
    2, 32]: the product, and in mode 1 its final exponentiation."""
    d = exe.parent
    np.ascontiguousarray(fs, np.int32).tofile(d / "fs.bin")
    subprocess.run([str(exe), str(mode), str(d / "fs.bin"),
                    str(d / "out.bin"), str(d / "flag.bin")], check=True)
    return _arr(d / "out.bin", (2, 3, 2, 32)), int(_arr(d / "flag.bin", 1)[0])


def hash_to_g2(exe: Path, u0: np.ndarray, u1: np.ndarray):
    """The Jacobian (x, y, z) [n, 2, 32] of the hash_to_g2 kernel."""
    d = exe.parent
    for name, u in (("u0", u0), ("u1", u1)):
        np.ascontiguousarray(u, np.int32).tofile(d / f"{name}.bin")
    subprocess.run([str(exe), *(str(d / f) for f in
                                ("u0.bin", "u1.bin", "ox.bin", "oy.bin",
                                 "oz.bin"))], check=True)
    return tuple(_arr(d / f"o{c}.bin", u0.shape) for c in "xyz")


def _run(exe: Path, inputs: dict, outputs: tuple, args: tuple = ()) -> None:
    """Write ``inputs`` (name -> int32 array) beside ``exe``, run it on
    ``args``, then them and the output files' paths, in that order."""
    d = exe.parent
    for name, a in inputs.items():
        np.ascontiguousarray(a, np.int32).tofile(d / f"{name}.bin")
    subprocess.run([str(exe), *map(str, args),
                    *(str(d / f"{f}.bin") for f in (*inputs, *outputs))],
                   check=True)


def g2_sum(exe: Path, x: np.ndarray, y: np.ndarray, z: np.ndarray):
    """The Jacobian sum (x, y, z) [2, 32] of the g2_sum kernel's two
    launches on n points [n, 2, 32]."""
    _run(exe, {"x": x, "y": y, "z": z}, ("sx", "sy", "sz"))
    return tuple(_arr(exe.parent / f"s{c}.bin", (2, 32)) for c in "xyz")


def miller_loop(exe: Path, px, py, qx, qy, mask):
    """The Miller outputs [n, 2, 3, 2, 32] of the miller_loop kernel (the
    design its C entry picks for n) on pairs px, py [n, 32], qx, qy [n, 2,
    32], mask [n] (0: the identity)."""
    n = len(mask)
    _run(exe, {"px": px, "py": py, "qx": qx, "qy": qy, "mask": mask},
         ("fs",))
    return _arr(exe.parent / "fs.bin", (n, 2, 3, 2, 32))


def rlc_scale(exe: Path, field: int, x, y, z, bits):
    """The Jacobian [b_i]P_i (x, y, z) of the rlc_scale kernel over Fp
    (field 1, [n, 32]) or Fp2 (field 2, [n, 2, 32]); bits [n, nbits]."""
    bits = np.asarray(bits)
    _run(exe, {"x": x, "y": y, "z": z, "bits": bits}, ("ox", "oy", "oz"),
         (field, bits.shape[1]))
    shape = np.asarray(x).shape
    return tuple(_arr(exe.parent / f"o{c}.bin", shape) for c in "xyz")


def g2_decompress(exe: Path, x, flags):
    """(y [n, 2, 32], ok [n]) of the g2_intake kernel's mode 0."""
    n = len(flags)
    _run(exe, {"x": x, "b": flags, "c": np.zeros(1)}, ("y", "ok"), (0,))
    return (_arr(exe.parent / "y.bin", (n, 2, 32)),
            _arr(exe.parent / "ok.bin", n))


def g2_in_subgroup(exe: Path, x, y, z):
    """ok [n] of the g2_intake kernel's mode 1 on Jacobian points."""
    _run(exe, {"x": x, "b": y, "c": z}, ("y", "ok"), (1,))
    return _arr(exe.parent / "ok.bin", np.asarray(x).shape[0])


def affine(exe: Path, field: int, x, y, z):
    """(X/Z^2, Y/Z^3) of the affine kernel over Fp (field 1, [n, 32]) or
    Fp2 (field 2, [n, 2, 32])."""
    _run(exe, {"x": x, "y": y, "z": z}, ("ox", "oy"), (field,))
    shape = np.asarray(x).shape
    return tuple(_arr(exe.parent / f"o{c}.bin", shape) for c in "xy")


def cap_fold(exe: Path, root, dense_depth: int, limit_depth: int):
    """The cap_fold kernel's u32[8] root with the zero caps dense_depth ..
    limit_depth - 1 (from its constant table) folded in."""
    _run(exe, {"root": root}, ("out",), (dense_depth, limit_depth))
    return _arr(exe.parent / "out.bin", 8)


def g1_segment_sum(exe: Path, x, y, z, starts, ends, resident: int = 3):
    """The per-range sums (x, y, z) [g, 32] of the segment sum's one
    cooperative launch (its grid as ``lh_g1_segment_sum`` picks it, with
    ``resident`` co-resident blocks) on Jacobian G1 lanes [n, 32], flags
    ``starts`` [n] and ``ends`` [g]."""
    g = len(ends)
    _run(exe, {"x": x, "y": y, "z": z, "starts": starts, "ends": ends},
         ("ox", "oy", "oz"), (resident,))
    return tuple(_arr(exe.parent / f"o{c}.bin", (g, 32)) for c in "xyz")


def path_walk(exe: Path, levels: list, rows, limit_depth: int,
              blocks: int = 0):
    """The walk kernel's levels and root after one cooperative launch of
    ``blocks`` blocks (0: ceil(R / threads), as ``lh_path_walk`` picks on
    a card with room) on levels (level 0 first, u32 [2^(D - l), 8] each)
    and sorted distinct rows: (levels, the top node with the zero caps D
    .. limit_depth - 1 folded in by the same launch)."""
    depth = len(levels) - 1
    flat = np.concatenate([np.asarray(lv).reshape(-1) for lv in levels])
    _run(exe, {"rows": rows, "levels": flat}, ("walked", "root"),
         (depth, blocks, limit_depth))
    out = _arr(exe.parent / "walked.bin", flat.shape)
    cuts = np.cumsum([np.asarray(lv).size for lv in levels])[:-1]
    walked = [a.reshape(-1, 8) for a in np.split(out, cuts)]
    return walked, _arr(exe.parent / "root.bin", 8)


def fp12_pow(exe: Path, lanes: int, f, exponent: int):
    """f^exponent [n, 2, 3, 2, 32] of the fp12_pow kernel at ``lanes``
    lanes a block (1, 2 or 4), its exponent's bits from the bottom one as ``ops/bls12_381.py`` ``fp12_pow_const`` passes
    them."""
    nbits = exponent.bit_length()
    bits = [(exponent >> i) & 1 for i in range(nbits)] or [0]
    _run(exe, {"f": f, "bits": np.asarray(bits)}, ("out",), (lanes, nbits))
    return _arr(exe.parent / "out.bin", np.asarray(f).shape)


def fp_ops(exe: Path, op: int, a, b=None):
    """The fp_ops kernel's op on a [n, 32] (and b), or on a [n, 64] for
    the wide op 4: [n, 32]."""
    a = np.asarray(a)
    _run(exe, {"a": a, "b": np.zeros(1) if b is None else b}, ("out",),
         (op,))
    return _arr(exe.parent / "out.bin", (a.shape[0], 32))
