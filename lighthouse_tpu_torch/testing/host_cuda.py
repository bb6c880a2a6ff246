"""Build and run the thread-cooperative BLS kernels on the host.

``build(name, out_dir, mode)`` cuts the C entries (their launch syntax)
off ``csrc/bls/<source>``, compiles it with g++ against the stand-ins of
``host_cuda.h`` (one std::thread a CUDA thread, barriers for
``__syncthreads``/``__syncwarp``) and returns the program; ``final_exp`` and ``hash_to_g2`` run it on int32
limb arrays as the kernels' C entries take them. The CPU tests hold the
results to the plain versions: the arithmetic of the CUDA source, not
its build for the card.
"""
from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..kernels import CSRC

_HERE = Path(__file__).resolve().parent

_MAINS = {
    "final_exp": ("pairing.cu", r'''
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
    "hash_to_g2": ("hash_to_g2.cu", r'''
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
}


def compiler() -> str | None:
    return shutil.which("g++")


def build(name: str, out_dir: Path) -> Path:
    """The host program of kernel ``name`` ("final_exp", "hash_to_g2"),
    multiply lowering 0 (CIOS)."""
    source, main = _MAINS[name]
    text = (CSRC / "bls" / source).read_text()
    body = text[:text.index('extern "C"')]
    out_dir = Path(out_dir) / name
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}_host.cpp"
    src.write_text('#include "host_cuda.h"\n' + body + main)
    exe = out_dir / f"{name}_host"
    subprocess.run([compiler(), "-std=c++20", "-O2", "-pthread", "-w",
                    f"-I{_HERE}", f"-I{CSRC / 'bls'}", str(src), "-o",
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
