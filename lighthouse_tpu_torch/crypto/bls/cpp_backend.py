"""C++ host pairing backend (the blst-equivalent, SURVEY.md §2.6 ★NATIVE).

Off the card's path: the host signer and the verdict oracle beside the
``gpu`` backend. ctypes wrapper over native/bls12_381.cpp (built by g++
into lighthouse_tpu_torch/_build/ at first use): 6x64 Montgomery Fp, sextic-basis
Fp12, affine multi-Miller with batch inversion, psi-endomorphism subgroup
checks and Budroni-Pintore cofactor clearing (both runtime-verified at
library init against the slow mul-by-r / mul-by-h_eff paths).

Byte-compatible with the Python oracle (crypto/bls12_381) and therefore
with blst: hash_to_g2 is the RFC 9380 8.8.2 ciphersuite incl. the RFC
h_eff, cross-checked byte-exact in tests/test_cpp_backend.py.

Reference parity: crypto/bls/src/impls/blst.rs (DST :15, sign :187-220,
verify_signature_sets :37-119).
"""
from __future__ import annotations

import ctypes as C
import secrets
import time

from ...utils.gxx import NATIVE, build
from . import BlsBackend, SignatureSet

_DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
_RAND_BITS = 64
_SOURCE = NATIVE / "bls12_381.cpp"


def _load_lib():
    lib = C.CDLL(str(build(_SOURCE, "bls12381")))
    u32p, u64p = C.POINTER(C.c_uint32), C.POINTER(C.c_uint64)
    lib.bls_selftest.restype = C.c_int
    lib.bls_sk_to_pk.argtypes = [C.c_char_p, C.c_char_p]
    lib.bls_sign.argtypes = [C.c_char_p, C.c_char_p, C.c_size_t,
                             C.c_char_p, C.c_size_t, C.c_char_p]
    lib.bls_hash_to_g2.argtypes = [C.c_char_p, C.c_size_t,
                                   C.c_char_p, C.c_size_t, C.c_char_p]
    lib.bls_hash_to_g2_affine.argtypes = [C.c_char_p, C.c_size_t,
                                          C.c_char_p, C.c_size_t, C.c_char_p]
    lib.bls_verify_signature_sets.restype = C.c_int
    lib.bls_verify_signature_sets.argtypes = [
        C.c_size_t, C.c_char_p, C.c_char_p, u32p,
        C.c_char_p, u32p, C.c_char_p, C.c_size_t, u64p]
    lib.bls_aggregate_verify.restype = C.c_int
    lib.bls_aggregate_verify.argtypes = [
        C.c_size_t, C.c_char_p, C.c_char_p, u32p, C.c_char_p,
        C.c_char_p, C.c_size_t]
    lib.bls_aggregate_sigs.restype = C.c_int
    lib.bls_aggregate_sigs.argtypes = [C.c_size_t, C.c_char_p, C.c_char_p]
    lib.bls_aggregate_pks.restype = C.c_int
    lib.bls_aggregate_pks.argtypes = [C.c_size_t, C.c_char_p, C.c_char_p]
    lib.bls_validate_pubkey.restype = C.c_int
    lib.bls_validate_pubkey.argtypes = [C.c_char_p]
    try:  # KZG surface (crypto/kzg.py host acceleration)
        lib.kzg_g1_msm.restype = C.c_int
        lib.kzg_g1_msm.argtypes = [C.c_size_t, C.c_char_p, C.c_char_p,
                                   C.c_char_p]
        lib.kzg_pairing_check.restype = C.c_int
        lib.kzg_pairing_check.argtypes = [C.c_size_t, C.c_char_p, C.c_char_p]
        lib.kzg_g1_mul.restype = C.c_int
        lib.kzg_g1_mul.argtypes = [C.c_char_p, C.c_char_p, C.c_char_p]
    except AttributeError:
        pass  # stale .so predating the KZG exports; kzg.py falls back
    rc = lib.bls_selftest()
    if rc != 0:
        raise RuntimeError(f"bls12_381 native selftest failed: {rc}")
    return lib


_lib = None


def get_lib():
    global _lib
    if _lib is None:
        _lib = _load_lib()
    return _lib


class CppBackend(BlsBackend):
    name = "cpp"

    def __init__(self):
        self.lib = get_lib()

    def sk_to_pk(self, sk: int) -> bytes:
        out = C.create_string_buffer(48)
        self.lib.bls_sk_to_pk(sk.to_bytes(32, "big"), out)
        return bytes(out.raw)

    def sign(self, sk: int, msg: bytes) -> bytes:
        out = C.create_string_buffer(96)
        self.lib.bls_sign(sk.to_bytes(32, "big"), msg, len(msg),
                          _DST, len(_DST), out)
        return bytes(out.raw)

    def _verify_sets_raw(self, sets: list[tuple[bytes, list, bytes]],
                         rands: list[int]) -> bool:
        n = len(sets)
        if n == 0:
            return False
        counts = (C.c_uint32 * n)(*[len(s[1]) for s in sets])
        mlens = (C.c_uint32 * n)(*[len(s[2]) for s in sets])
        r = (C.c_uint64 * n)(*rands)
        return self.lib.bls_verify_signature_sets(
            n, b"".join(s[0] for s in sets),
            b"".join(b"".join(s[1]) for s in sets), counts,
            b"".join(s[2] for s in sets), mlens,
            _DST, len(_DST), r) == 1

    def verify(self, pk: bytes, msg: bytes, sig: bytes) -> bool:
        return self._verify_sets_raw([(sig, [pk], msg)], [1])

    def fast_aggregate_verify(self, pks, msg, sig) -> bool:
        if not pks:
            return False
        return self._verify_sets_raw([(sig, list(pks), msg)], [1])

    def aggregate_verify(self, pks, msgs, sig) -> bool:
        if not pks or len(pks) != len(msgs):
            return False
        n = len(pks)
        mlens = (C.c_uint32 * n)(*[len(m) for m in msgs])
        return self.lib.bls_aggregate_verify(
            n, b"".join(pks), b"".join(msgs), mlens, sig,
            _DST, len(_DST)) == 1

    def verify_signature_sets(self, sets: list[SignatureSet]) -> bool:
        if not sets:
            return False
        rands = ([1] if len(sets) == 1 else
                 [secrets.randbits(_RAND_BITS) | 1 for _ in sets])
        return self._verify_sets_raw(
            [(s.signature, list(s.pubkeys), s.message) for s in sets], rands)

    def aggregate_signatures(self, sigs) -> bytes:
        out = C.create_string_buffer(96)
        if self.lib.bls_aggregate_sigs(len(sigs), b"".join(sigs), out):
            raise ValueError("invalid signature bytes")
        return bytes(out.raw)

    def aggregate_public_keys(self, pks) -> bytes:
        out = C.create_string_buffer(48)
        if self.lib.bls_aggregate_pks(len(pks), b"".join(pks), out):
            raise ValueError("invalid pubkey bytes")
        return bytes(out.raw)

    def validate_pubkey(self, pk: bytes) -> bool:
        return self.lib.bls_validate_pubkey(pk) == 1


def hash_to_g2_affine(msg: bytes, dst: bytes = _DST) -> tuple:
    """(x.c0, x.c1, y.c0, y.c1) as ints — cross-check helper."""
    out = C.create_string_buffer(192)
    get_lib().bls_hash_to_g2_affine(msg, len(msg), dst, len(dst), out)
    b = bytes(out.raw)
    return tuple(int.from_bytes(b[i * 48:(i + 1) * 48], "big")
                 for i in range(4))


def measure_pairing_throughput(n: int = 64) -> float:
    """Verified signature-sets per second on this host (one process) —
    the bench's measured stand-in for the blst node baseline."""
    b = CppBackend()
    sets = [(b.sign(1000 + i, bytes([i & 0xff, 1]) * 16),
             [b.sk_to_pk(1000 + i)], bytes([i & 0xff, 1]) * 16)
            for i in range(n)]
    rands = [(7 * i + 5) | 1 for i in range(n)]
    assert b._verify_sets_raw(sets, rands)
    t0 = time.perf_counter()
    assert b._verify_sets_raw(sets, rands)
    dt = time.perf_counter() - t0
    return n / dt
