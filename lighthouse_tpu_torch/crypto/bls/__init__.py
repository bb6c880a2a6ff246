"""Backend-generic BLS interface (wire-format level).

Equivalent of sigp/lighthouse crypto/bls/src/lib.rs:86-141 (`define_mod!`
backend selection): the whole client talks to this module in terms of
compressed bytes (pk 48B, sig 96B) and `SignatureSet`s; the backend — chosen
via ``set_backend`` / ``--crypto-backend`` — decides how
``verify_signature_sets`` actually runs:

- ``python``: pure-Python pairing (reference oracle, crypto/bls12_381/)
- ``fake``:   always-valid (fake_crypto equivalent, impls/fake_crypto.rs)
- ``gpu``:    limb-kernel batch verification on the card (ops/bls12_381.py,
              the CUDA kernels of csrc/bls/)
- ``cpp``:    C++ host pairing (native/bls12_381.cpp)
"""
from __future__ import annotations

from dataclasses import dataclass

INFINITY_PUBKEY = bytes([0xC0]) + b"\x00" * 47
INFINITY_SIGNATURE = bytes([0xC0]) + b"\x00" * 95


@dataclass
class SignatureSet:
    """One message, one signature, 1+ pubkeys (pre-aggregation)."""
    signature: bytes
    pubkeys: list
    message: bytes


class BlsBackend:
    name = "abstract"

    def sk_to_pk(self, sk: int) -> bytes:
        raise NotImplementedError

    def sign(self, sk: int, msg: bytes) -> bytes:
        raise NotImplementedError

    def verify(self, pk: bytes, msg: bytes, sig: bytes) -> bool:
        raise NotImplementedError

    def fast_aggregate_verify(self, pks: list, msg: bytes,
                              sig: bytes) -> bool:
        raise NotImplementedError

    def aggregate_verify(self, pks: list, msgs: list, sig: bytes) -> bool:
        raise NotImplementedError

    def verify_signature_sets(self, sets: list[SignatureSet]) -> bool:
        raise NotImplementedError

    def aggregate_signatures(self, sigs: list) -> bytes:
        raise NotImplementedError

    def aggregate_public_keys(self, pks: list) -> bytes:
        raise NotImplementedError

    def validate_pubkey(self, pk: bytes) -> bool:
        raise NotImplementedError


#: first byte of a signature the Fake backend treats as INVALID.  A real
#: compressed G2 point can never lead with 0xff (compression + infinity
#: bits both set with a nonzero body), so adversarial tests can forge
#: "cryptographically bad" signatures that still exercise the full
#: verification pipeline: b"\xff" + 95 arbitrary bytes.
POISON_SIGNATURE_BYTE = 0xFF


class FakeBackend(BlsBackend):
    """Always-valid crypto for tests that exercise everything *but* crypto
    (the reference runs most chain tests this way, impls/fake_crypto.rs).
    One carve-out: signatures leading with POISON_SIGNATURE_BYTE fail, so
    invalid-signature adversarial scenarios keep working without real
    pairings."""

    name = "fake"

    @staticmethod
    def _poisoned(sig: bytes) -> bool:
        return len(sig) > 0 and sig[0] == POISON_SIGNATURE_BYTE

    def sk_to_pk(self, sk: int) -> bytes:
        return bytes([0x80]) + (sk % 2**376).to_bytes(47, "big")

    def sign(self, sk: int, msg: bytes) -> bytes:
        return bytes([0x80]) + (sk % 2**120).to_bytes(15, "big") \
            + msg[:32].ljust(32, b"\0") + b"\x00" * 48

    def verify(self, pk, msg, sig) -> bool:
        return not self._poisoned(sig)

    def fast_aggregate_verify(self, pks, msg, sig) -> bool:
        return bool(pks) and not self._poisoned(sig)

    def aggregate_verify(self, pks, msgs, sig) -> bool:
        return bool(pks) and not self._poisoned(sig)

    def verify_signature_sets(self, sets) -> bool:
        return all(s.pubkeys and not self._poisoned(s.signature)
                   for s in sets)

    def aggregate_signatures(self, sigs) -> bytes:
        return sigs[0] if sigs else INFINITY_SIGNATURE

    def aggregate_public_keys(self, pks) -> bytes:
        return pks[0] if pks else INFINITY_PUBKEY

    def validate_pubkey(self, pk: bytes) -> bool:
        return len(pk) == 48


class PythonBackend(BlsBackend):
    """Pure-Python pairing backend (the correctness oracle)."""

    name = "python"

    def __init__(self):
        self._pk_cache: dict[bytes, object] = {}

    def _pk(self, pk: bytes):
        from ..bls12_381 import g1_decompress
        pt = self._pk_cache.get(pk)
        if pt is None:
            pt = g1_decompress(pk)
            if pt is None:
                raise ValueError("invalid pubkey")
            self._pk_cache[pk] = pt
        return pt

    def sk_to_pk(self, sk: int) -> bytes:
        from ..bls12_381 import g1_compress, sk_to_pk
        return g1_compress(sk_to_pk(sk))

    def sign(self, sk: int, msg: bytes) -> bytes:
        from ..bls12_381 import g2_compress, sign
        return g2_compress(sign(sk, msg))

    def verify(self, pk, msg, sig) -> bool:
        from ..bls12_381 import g2_decompress, verify
        try:
            p = self._pk(pk)
        except ValueError:
            return False
        s = g2_decompress(sig)
        return s is not None and verify(p, msg, s)

    def fast_aggregate_verify(self, pks, msg, sig) -> bool:
        from ..bls12_381 import fast_aggregate_verify, g2_decompress
        s = g2_decompress(sig)
        if s is None or not pks:
            return False
        try:
            return fast_aggregate_verify([self._pk(p) for p in pks], msg, s)
        except ValueError:
            return False

    def aggregate_verify(self, pks, msgs, sig) -> bool:
        from ..bls12_381 import aggregate_verify, g2_decompress
        s = g2_decompress(sig)
        if s is None:
            return False
        try:
            return aggregate_verify([self._pk(p) for p in pks], msgs, s)
        except ValueError:
            return False

    def verify_signature_sets(self, sets) -> bool:
        from ..bls12_381 import g2_decompress
        from ..bls12_381.sig import (
            SignatureSet as PySet, verify_signature_sets_rlc,
        )
        py_sets = []
        try:
            for s in sets:
                sig = g2_decompress(s.signature)
                if sig is None:
                    return False
                py_sets.append(
                    PySet(sig, [self._pk(p) for p in s.pubkeys], s.message))
        except ValueError:
            return False
        return verify_signature_sets_rlc(py_sets)

    def aggregate_signatures(self, sigs) -> bytes:
        from ..bls12_381 import g2_compress, g2_decompress
        from ..bls12_381.curve import B_G2, Point
        out = Point.infinity(B_G2)
        for s in sigs:
            pt = g2_decompress(s)
            if pt is None:
                raise ValueError("invalid signature in aggregate")
            out = out.add(pt)
        return g2_compress(out)

    def aggregate_public_keys(self, pks) -> bytes:
        from ..bls12_381 import g1_compress
        from ..bls12_381.curve import B_G1, Point
        out = Point.infinity(B_G1)
        for p in pks:
            out = out.add(self._pk(p))
        return g1_compress(out)

    def validate_pubkey(self, pk: bytes) -> bool:
        # spec KeyValidate: reject the identity point as well as
        # malformed/off-curve encodings
        if pk == b"\xc0" + b"\x00" * 47:
            return False
        try:
            self._pk(pk)
            return True
        except ValueError:
            return False


_BACKENDS: dict[str, BlsBackend] = {}
_current: BlsBackend | None = None


def get_backend() -> BlsBackend:
    """Fail-closed: an entry point that never called set_backend gets real
    crypto on the card (``gpu``, which raises without one unless the
    caller switched the port's device to the CPU), never the always-valid
    fake backend — 'fake' must be an explicit opt-in (--crypto-backend=fake
    / tests), mirroring the reference's fake_crypto feature gate; the
    ``python`` and ``cpp`` host backends are opt-ins too."""
    global _current
    if _current is None:
        _current = _make("gpu")
    return _current


def _make(name: str) -> BlsBackend:
    if name not in _BACKENDS:
        if name == "fake":
            _BACKENDS[name] = FakeBackend()
        elif name == "python":
            _BACKENDS[name] = PythonBackend()
        elif name == "gpu":
            from .gpu_backend import GpuBackend
            _BACKENDS[name] = GpuBackend()
        elif name == "cpp":
            from .cpp_backend import CppBackend
            _BACKENDS[name] = CppBackend()
        else:
            raise ValueError(f"unknown bls backend {name!r}")
    return _BACKENDS[name]


def set_backend(name: str) -> BlsBackend:
    global _current
    _current = _make(name)
    return _current


# -- module-level convenience (dispatch to current backend) -------------------

def sk_to_pk(sk: int) -> bytes:
    return get_backend().sk_to_pk(sk)


def sign(sk: int, msg: bytes) -> bytes:
    return get_backend().sign(sk, msg)


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    return get_backend().verify(pk, msg, sig)


def fast_aggregate_verify(pks, msg, sig) -> bool:
    return get_backend().fast_aggregate_verify(pks, msg, sig)


def aggregate_verify(pks, msgs, sig) -> bool:
    return get_backend().aggregate_verify(pks, msgs, sig)


def verify_signature_sets(sets: list[SignatureSet]) -> bool:
    # hot-path tracing (beacon_chain/src/metrics.rs style): the span
    # joins whatever trace is active (block import, attestation batch)
    from ...obs import tracing
    with tracing.span("bls_batch_verify", sets=len(sets)):
        return get_backend().verify_signature_sets(sets)


def aggregate_signatures(sigs) -> bytes:
    return get_backend().aggregate_signatures(sigs)


def aggregate_public_keys(pks) -> bytes:
    return get_backend().aggregate_public_keys(pks)


def keygen_interop(index: int) -> int:
    from ..bls12_381.sig import keygen_interop as _k
    return _k(index)
