"""Build and bind the port's CUDA kernels (csrc/*.cu, csrc/bls/*.cu).

Each source is compiled at first use by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``; a
source may hold several kernels, each its own C entry. The library's file
name carries a digest of its source and of the shared headers, so an
edited source never loads a stale build. ``build_all()`` starts one
``nvcc`` per source at once and waits for all of them; ``BUILD_LOGS``
keeps each source's ``-Xptxas -v`` report (registers, spills, stack).

Every C entry takes device pointers and the stream as ``void*`` and returns
``cudaGetLastError()`` after its launch; ``CudaKernel.launch`` raises on a
nonzero code and counts the launch. Nothing here runs at import time: the
CPU tests import every module, and this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_HEADERS = ("sha256.cuh", "bls/fp.cuh", "bls/tower.cuh", "bls/curve.cuh",
            "bls/consts.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: source -> the compiler's report of its last build in this process
BUILD_LOGS: dict[str, str] = {}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaKernel:
    """One kernel: its source, its C entry, and a count of its launches."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in (self.source_path, *(CSRC / f for f in _HEADERS)):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source_path.stem}-{h.hexdigest()[:16]}.so"

    def _compile_cmd(self, out: Path) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source_path)]

    def _bind(self, lib_path: Path) -> None:
        fn = getattr(ctypes.CDLL(str(lib_path)), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def load(self):
        if self._fn is None:
            build_all([self])
        return self._fn

    def launch(self, *args) -> None:
        rc = self.load()(*args)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {rc}")
        self.launches += 1


def build_all(kernels=None) -> float:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all at once; bind each. Returns the wall seconds it took.
    Raises with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, started = [], set()
    for k in kernels:
        out = k.library_path()
        if out.exists() or out in started:
            continue
        started.add(out)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(k._compile_cmd(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((k, proc, tmp, out))
    failures = []
    for k, proc, tmp, out in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[k.source] = log
        if proc.returncode != 0:
            failures.append(f"--- {k.source} (nvcc rc {proc.returncode})\n"
                            f"{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    for k in kernels:
        if k._fn is None:
            k._bind(k.library_path())
    return time.perf_counter() - t0


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def stream_ptr(device) -> int:
    """The current stream of ``device``, for a launch. The C entries
    launch on the CUDA runtime's current device, so a tensor on another
    card raises here instead of running a kernel with another card's
    stream and pointers."""
    import torch
    device = torch.device(device)
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise ValueError(f"launch on {device} while the current device is "
                         f"cuda:{current}: call torch.cuda.set_device first")
    return torch.cuda.current_stream(device).cuda_stream


HASH64 = CudaKernel("hash64", "hash64.cu", "lh_hash64", [_P, _P, _I64, _P])
CAP_FOLD = CudaKernel("cap_fold", "cap_fold.cu", "lh_cap_fold",
                      [_P, _P, _I32, _P, _P])
FOLD_PRE = CudaKernel("fold_pre", "fold_pre.cu", "lh_fold_pre",
                      [_P, _P, _P, _I64, _I64, _I32, _P, _P])
PATH_UPDATE = CudaKernel("path_update", "path_update.cu", "lh_path_update",
                         [_P, _P, _P, _I64, _I32, _P])

# BLS12-381 (csrc/bls/): the batched signature verification path
FP_OPS = CudaKernel("fp_ops", "bls/fp_ops.cu", "lh_fp_ops",
                    [_I32, _P, _P, _P, _I64, _P])
G2_INTAKE = CudaKernel("g2_intake", "bls/g2_intake.cu", "lh_g2_intake",
                       [_I32, _P, _P, _P, _P, _P, _I64, _P])
HASH_TO_G2 = CudaKernel("hash_to_g2", "bls/hash_to_g2.cu", "lh_hash_to_g2",
                        [_P, _P, _P, _P, _P, _I64, _P])
RLC_SCALE = CudaKernel("rlc_scale", "bls/rlc_scale.cu", "lh_rlc_scale",
                       [_I32, _P, _P, _P, _P, _I32, _P, _P, _P, _I64, _P])
G1_SEGMENT_SUM = CudaKernel("g1_segment_sum", "bls/aggregate.cu",
                            "lh_g1_segment_sum",
                            [_P, _P, _P, _P, _I64, _P, _I64, _P, _P, _P, _P])
G2_SUM = CudaKernel("g2_sum", "bls/aggregate.cu", "lh_g2_sum",
                    [_P, _P, _P, _I64, _P, _P, _P, _P])
AFFINE = CudaKernel("affine", "bls/aggregate.cu", "lh_affine",
                    [_I32, _P, _P, _P, _P, _P, _I64, _P])
MILLER_LOOP = CudaKernel("miller_loop", "bls/pairing.cu", "lh_miller_loop",
                         [_P, _P, _P, _P, _P, _P, _I64, _P])
FINAL_EXP = CudaKernel("final_exp", "bls/pairing.cu", "lh_final_exp",
                       [_I32, _P, _I64, _P, _P, _P])

STATE_ROOT_KERNELS = (HASH64, CAP_FOLD, FOLD_PRE, PATH_UPDATE)
BLS_KERNELS = (FP_OPS, G2_INTAKE, HASH_TO_G2, RLC_SCALE, G1_SEGMENT_SUM,
               G2_SUM, AFFINE, MILLER_LOOP, FINAL_EXP)
KERNELS = {k.name: k for k in STATE_ROOT_KERNELS + BLS_KERNELS}
