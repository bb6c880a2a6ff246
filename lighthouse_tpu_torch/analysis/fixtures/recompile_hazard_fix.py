"""Seeded fixture for the recompile-hazard rule.

Every true-positive line carries a ``seeded`` marker; the true
negatives (module-level construction, memoized or by-hand cached
loaders, a loader reached only from its cache, a process entry) must
stay silent.
"""
import ctypes
import functools

from lighthouse_tpu_torch import kernels
from lighthouse_tpu_torch.kernels import CudaKernel

_P = ctypes.c_void_p


def bad_kernel_per_call(x):
    k = CudaKernel("fixture", "hash64.cu", "lh_hash64", [_P])  # seeded
    return k.launch(x)


def bad_bls_per_call():
    return kernels._bls("fixture", "bls/fp_ops.cu", "lh_fp_ops", [_P])  # seeded


def bad_bind_per_call(path: str, x):
    lib = ctypes.CDLL(path)  # seeded
    return lib.entry(x)


def bad_extension_per_call(src: str):
    from torch.utils import cpp_extension
    return cpp_extension.load_inline("fixture", [src])  # seeded


class Runner:
    def run(self, path: str):
        fn = ctypes.cdll.LoadLibrary(path).entry  # seeded
        return fn()


def _loader(path: str):
    return ctypes.CDLL(path)  # seeded


def calls_loader_twice(path: str):
    # a plain caller: the loader runs on every call
    return _loader(path), _loader(path)


# -- true negatives ----------------------------------------------------------

MODULE_KERNEL = CudaKernel("fixture_ok", "hash64.cu", "lh_hash64", [_P])
MODULE_BLS = kernels._bls("fixture_ok", "bls/fp_ops.cu", "lh_fp_ops", [_P])


@functools.lru_cache(maxsize=None)
def memoized_lib(path: str):
    return ctypes.CDLL(path)


_LIB = None
_LIBS: dict = {}


def global_memo(path: str):
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(path)
    return _LIB


def dict_memo(path: str):
    if path not in _LIBS:
        _LIBS[path] = ctypes.CDLL(path)
    return _LIBS[path]


def _load_once(path: str):
    lib = ctypes.CDLL(path)
    lib.entry.restype = ctypes.c_int
    return lib


_ONCE = None


def get_lib(path: str):
    # the only caller of _load_once keeps its result
    global _ONCE
    if _ONCE is None:
        _ONCE = _load_once(path)
    return _ONCE


def main(argv=None):
    # a process entry: binds once a process
    return ctypes.CDLL(argv[0]).entry()
