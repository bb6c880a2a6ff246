"""Build and bind the port's CUDA kernels (csrc/*.cu, csrc/bls/*.cu).

Each source is compiled at first use by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``; a
source may hold several kernels, each its own C entry. The library's file
name carries a digest of its source and of the shared headers, so an
edited source never loads a stale build. ``build_all()`` starts one
``nvcc`` per source at once and waits for all of them; ``BUILD_LOGS``
keeps each source's ``-Xptxas -v`` report (registers, spills, stack), and
``obs.cuda_accounting`` counts the builds, their seconds and the
``_build/`` cache's hits.

Every C entry takes device pointers and the stream as ``void*`` and returns
``cudaGetLastError()`` after its launch; ``CudaKernel.launch`` raises on a
nonzero code and counts the launch. Nothing here runs at import time: the
CPU tests import every module, and this machine may have no ``nvcc``.

The BLS kernels (``BLS_KERNELS``) come in one variant for each multiply
lowering of ``ops/bigint.py`` (``mxu_mode()``, from ``LHTPU_BIGINT_MXU``):
variant n is the same source built with ``-DLH_FP_MODE=n`` into its own
library, named ``<kernel>_mxu<n>``, with its own launch count and build
log. A launch runs the variant of the current mode, building it at first
use; ``build_all(variants(n))`` builds the mode-n variants of every kernel
at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_HEADERS = ("sha256.cuh", "zero_hashes.cuh", "bls/fp.cuh", "bls/tower.cuh",
            "bls/curve.cuh", "bls/consts.cuh", "bls/coop.cuh",
            "bls/lane_prog.cuh")
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
    """One kernel: its source, its C entry, and a count of its launches.
    A kernel with ``mxu_variants`` launches its variant for the current
    multiply lowering (``fp_mode`` is the lowering a library is built
    with)."""

    def __init__(self, name: str, source: str, symbol: str, argtypes,
                 mxu_variants: bool = False, fp_mode: int = 0):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.mxu_variants = mxu_variants
        self.fp_mode = fp_mode
        self.launches = 0
        self._fn = None
        self._variants: dict[int, CudaKernel] = {}

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    @property
    def build_key(self) -> str:
        """The source, and the lowering when it is not mode 0."""
        return (self.source if self.fp_mode == 0
                else f"{self.source}@mxu{self.fp_mode}")

    def flags(self) -> tuple:
        return NVCC_FLAGS + ((f"-DLH_FP_MODE={self.fp_mode}",)
                             if self.fp_mode else ())

    def variant(self, mxu: int) -> "CudaKernel":
        """This kernel built for multiply lowering ``mxu`` (itself for 0)."""
        if mxu == 0:
            return self
        if not self.mxu_variants:
            raise ValueError(f"{self.name} has no multiply variants")
        if mxu not in (1, 2):
            raise ValueError(f"no multiply lowering {mxu}")
        k = self._variants.get(mxu)
        if k is None:
            k = CudaKernel(f"{self.name}_mxu{mxu}", self.source, self.symbol,
                           self.argtypes, fp_mode=mxu)
            self._variants[mxu] = k
        return k

    def current(self) -> "CudaKernel":
        """The kernel a launch runs now: the variant of the current mode."""
        if not self.mxu_variants:
            return self
        from .ops.bigint import mxu_mode
        return self.variant(mxu_mode())

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in (self.source_path, *(CSRC / f for f in _HEADERS)):
            h.update(p.read_bytes())
        h.update(" ".join(self.flags()).encode())
        tag = f"-mxu{self.fp_mode}" if self.fp_mode else ""
        return BUILD_DIR / (f"{self.source_path.stem}{tag}-"
                            f"{h.hexdigest()[:16]}.so")

    def _compile_cmd(self, out: Path) -> list[str]:
        return [_nvcc(), *self.flags(), "-o", str(out),
                str(self.source_path)]

    def _bind(self, lib_path: Path) -> None:
        fn = getattr(ctypes.CDLL(str(lib_path)), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def load(self):
        if self._fn is None:
            build_all([self])
        return self._fn

    def launch(self, *args, count: int = 1) -> None:
        """Call the C entry; ``count``: the kernel launches it makes (two
        for a G2 sum past one block)."""
        k = self.current()
        rc = k.load()(*args)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {k.name} failed to launch: cudaError {rc}")
        k.launches += count


def _run_nvcc(k: CudaKernel, tmp: Path) -> tuple[int, str, float]:
    """One nvcc build: its return code, its output and its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(k._compile_cmd(tmp), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def build_all(kernels=None) -> float:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all at once; bind each (default: every mode-0 kernel).
    Returns the wall seconds it took. Raises with the compiler's output if
    any build fails. Each library asked for feeds ``obs.cuda_accounting``:
    one found in ``_build/`` is a cache hit, one nvcc built is a miss with
    its seconds and its ptxas report."""
    from .obs import cuda_accounting
    t0 = time.perf_counter()
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, seen = [], set()
    for k in kernels:
        out = k.library_path()
        if out in seen:
            continue
        seen.add(out)
        if out.exists():
            cuda_accounting.record_hit(k.build_key)
        else:
            todo.append((k, out.with_suffix(f".{os.getpid()}.tmp"), out))
    failures = []
    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            runs = list(pool.map(lambda t: _run_nvcc(t[0], t[1]), todo))
        for (k, tmp, out), (rc, log, seconds) in zip(todo, runs):
            BUILD_LOGS[k.build_key] = log
            if rc != 0:
                failures.append(f"--- {k.build_key} (nvcc rc {rc})\n{log}")
            else:
                os.replace(tmp, out)
                cuda_accounting.record_build(k.build_key, out.name, seconds,
                                             log)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    for k in kernels:
        if k._fn is None:
            lib = k.library_path()
            k._bind(lib)
            cuda_accounting.record_bound(lib.name)
    return time.perf_counter() - t0


def variants(mxu: int) -> list[CudaKernel]:
    """The multiply-lowering-``mxu`` variant of every kernel that has
    them."""
    return [k.variant(mxu) for k in KERNELS.values() if k.mxu_variants]


def reset_counts() -> None:
    """Zero every kernel's launch count, its multiply variants' too."""
    for k in KERNELS.values():
        k.launches = 0
        for v in k._variants.values():
            v.launches = 0


def launch_counts() -> dict[str, int]:
    """Every kernel's launches in this process by name, each multiply
    variant's under its own (``<kernel>_mxu<n>``)."""
    out = {}
    for k in KERNELS.values():
        out[k.name] = k.launches
        for v in k._variants.values():
            out[v.name] = v.launches
    return out


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
                      [_P, _I32, _I32, _P, _P])
FOLD_PRE = CudaKernel("fold_pre", "fold_pre.cu", "lh_fold_pre",
                      [_P, _P, _P, _I64, _I64, _I32, _P, _P])
#: the whole dirty-path walk of an update and its root's caps (one
#: cooperative launch)
PATH_UPDATE = CudaKernel("path_update", "path_update.cu", "lh_path_walk",
                         [_P, _I32, _P, _I64, _I32, _P, _P])

#: multi-block SHA-256 of padded messages (no caller on a path)
SHA256_MESSAGES = CudaKernel("sha256_messages", "sha256_messages.cu",
                             "lh_sha256_messages", [_P, _P, _I64, _I32, _P])

# BLS12-381 (csrc/bls/): the batched signature verification path, each
# kernel in one variant for each multiply lowering
def _bls(name, source, symbol, argtypes):
    return CudaKernel(name, source, symbol, argtypes, mxu_variants=True)


FP_OPS = _bls("fp_ops", "bls/fp_ops.cu", "lh_fp_ops",
              [_I32, _P, _P, _P, _I64, _P])
G2_INTAKE = _bls("g2_intake", "bls/g2_intake.cu", "lh_g2_intake",
                 [_I32, _P, _P, _P, _P, _P, _I64, _P])
HASH_TO_G2 = _bls("hash_to_g2", "bls/hash_to_g2.cu", "lh_hash_to_g2",
                  [_P, _P, _P, _P, _P, _I64, _P])
RLC_SCALE = _bls("rlc_scale", "bls/rlc_scale.cu", "lh_rlc_scale",
                 [_I32, _P, _P, _P, _P, _I32, _P, _P, _P, _I64, _P])
G1_SEGMENT_SUM = _bls("g1_segment_sum", "bls/aggregate.cu",
                      "lh_g1_segment_sum",
                      [_P, _P, _P, _P, _I64, _P, _I64, _P, _I64, _P, _P, _P,
                       _P])
G2_SUM = _bls("g2_sum", "bls/aggregate.cu", "lh_g2_sum",
              [_P, _P, _P, _I64, _P, _P, _P, _P, _P])
AFFINE = _bls("affine", "bls/aggregate.cu", "lh_affine",
              [_I32, _P, _P, _P, _P, _P, _I64, _P])
MILLER_LOOP = _bls("miller_loop", "bls/pairing.cu", "lh_miller_loop",
                   [_P, _P, _P, _P, _P, _P, _I64, _P])
FINAL_EXP = _bls("final_exp", "bls/pairing.cu", "lh_final_exp",
                 [_I32, _P, _I64, _P, _P, _P])
#: f^e for a constant e (no caller on a path)
FP12_POW = _bls("fp12_pow", "bls/fp12_pow.cu", "lh_fp12_pow",
                [_P, _P, _I32, _P, _I64, _P])

STATE_ROOT_KERNELS = (HASH64, CAP_FOLD, FOLD_PRE, PATH_UPDATE)
BLS_KERNELS = (FP_OPS, G2_INTAKE, HASH_TO_G2, RLC_SCALE, G1_SEGMENT_SUM,
               G2_SUM, AFFINE, MILLER_LOOP, FINAL_EXP)
KERNELS = {k.name: k for k in STATE_ROOT_KERNELS + BLS_KERNELS
           + (SHA256_MESSAGES, FP12_POW)}
