"""The `gpu` backend's aggregation on the C++ host library against the
pure-Python backends of both packages and the `cpp` backend: byte-equal
aggregates of valid points, and the same ValueError as the pure-Python
backend on each invalid kind (a wrong length, a point off the curve, a
point off the subgroup, a malformed infinity encoding). Also the pubkey
warm-up's decompression (its subgroup check on the C++ library) against
the pure-Python decompression."""
import numpy as np
import pytest

from lighthouse_tpu.crypto.bls import PythonBackend as JPythonBackend
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import PythonBackend
from lighthouse_tpu_torch.crypto.bls.cpp_backend import CppBackend
from lighthouse_tpu_torch.crypto.bls.gpu_backend import GpuBackend
from lighthouse_tpu_torch.crypto.bls12_381 import g1_compress, g2_compress
from lighthouse_tpu_torch.crypto.bls12_381.curve import B_G1, B_G2, Point
from lighthouse_tpu_torch.crypto.bls12_381.fields import Fp, Fp2
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU; its BLS backend put back after each test."""
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


@pytest.fixture(scope="module")
def backends():
    return GpuBackend(), PythonBackend(), JPythonBackend(), CppBackend()


@pytest.fixture(scope="module")
def signed():
    cpp = CppBackend()
    rng = np.random.default_rng(14)
    sks = [int(rng.integers(1, 1 << 62)) for _ in range(5)]
    sigs = [cpp.sign(sk, b"message %d" % (i % 2)) for i, sk in
            enumerate(sks)]
    return sigs, [cpp.sk_to_pk(sk) for sk in sks]


def _off_subgroup(b, field):
    """A compressed point of the curve y^2 = x^3 + b outside the
    prime-order subgroup."""
    for i in range(1, 200):
        x = field(i) if field is Fp else Fp2(i, 1)
        y = (x * x * x + b).sqrt()
        if y is not None:
            pt = Point.from_affine(x, y, b)
            if not pt.in_subgroup():
                return (g1_compress if field is Fp else g2_compress)(pt)
    raise AssertionError("no point found")


def _off_curve(width):
    """x = 1..: the first x whose x^3 + b is not a square, compressed."""
    from lighthouse_tpu_torch.crypto.bls12_381 import (
        g1_decompress, g2_decompress,
    )
    dec = g1_decompress if width == 48 else g2_decompress
    for i in range(1, 200):
        raw = bytes([0x80]) + b"\x00" * (width - 2) + bytes([i])
        if dec(raw, subgroup_check=False) is None:
            return raw
    raise AssertionError("no x found")


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_gpu_aggregates_equal_the_pure_python_and_cpp(backends, signed, n):
    gpu, py, jpy, cpp = backends
    sigs, pks = signed
    agg = gpu.aggregate_signatures(sigs[:n])
    assert agg == py.aggregate_signatures(sigs[:n]) == \
        jpy.aggregate_signatures(sigs[:n]) == cpp.aggregate_signatures(
            sigs[:n])
    apk = gpu.aggregate_public_keys(pks[:n])
    assert apk == py.aggregate_public_keys(pks[:n]) == \
        jpy.aggregate_public_keys(pks[:n]) == cpp.aggregate_public_keys(
            pks[:n])
    inf_sig, inf_pk = b"\xc0" + b"\x00" * 95, b"\xc0" + b"\x00" * 47
    assert gpu.aggregate_signatures(sigs[:n] + [inf_sig]) == \
        py.aggregate_signatures(sigs[:n] + [inf_sig])
    assert gpu.aggregate_public_keys(pks[:n] + [inf_pk]) == \
        py.aggregate_public_keys(pks[:n] + [inf_pk])


_BAD_KINDS = ["short", "long", "off_curve", "off_subgroup", "no_flag",
              "infinity_body", "infinity_sign"]


def _bad(kind, width):
    b, field = (B_G1, Fp) if width == 48 else (B_G2, Fp2)
    return {
        "short": b"\xa0" * (width - 1),
        "long": b"\xa0" * (width + 1),
        "off_curve": _off_curve(width),
        "off_subgroup": _off_subgroup(b, field),
        "no_flag": b"\x00" * width,
        "infinity_body": b"\xc0" + b"\x00" * (width - 2) + b"\x01",
        "infinity_sign": b"\xe0" + b"\x00" * (width - 1),
    }[kind]


@pytest.mark.parametrize("kind", _BAD_KINDS)
def test_gpu_aggregation_refuses_as_the_pure_python_does(backends, signed,
                                                         kind):
    gpu, py, jpy, _cpp = backends
    sigs, pks = signed
    for good, width, method in ((sigs, 96, "aggregate_signatures"),
                                (pks, 48, "aggregate_public_keys")):
        points = [good[0], _bad(kind, width), good[1]]
        errors = []
        for backend in (gpu, py, jpy):
            with pytest.raises(ValueError) as e:
                getattr(backend, method)(points)
            errors.append(str(e.value))
        assert errors[0] == errors[1] == errors[2]


def test_cpp_aggregation_differs_on_a_point_off_the_subgroup(backends):
    """The one invalid kind where the `cpp` backend's aggregate differs
    from the pure-Python reference: it does not check the subgroup."""
    gpu, py, _jpy, cpp = backends
    bad = _off_subgroup(B_G2, Fp2)
    assert len(cpp.aggregate_signatures([bad])) == 96
    for backend in (gpu, py):
        with pytest.raises(ValueError):
            backend.aggregate_signatures([bad])


def test_pubkey_warm_chunk_equals_the_pure_python_decompression(signed):
    from lighthouse_tpu_torch.bls_batch import _decompress_chunk
    from lighthouse_tpu_torch.crypto.bls12_381 import g1_decompress
    _sigs, pks = signed
    keys = pks + [b"\xc0" + b"\x00" * 47] + [
        _bad(kind, 48) for kind in _BAD_KINDS]
    got = _decompress_chunk(keys)
    want = [g1_decompress(k) for k in keys]
    assert [None if p is None else g1_compress(p) for p in got] == \
        [None if p is None else g1_compress(p) for p in want]
    assert sum(p is None for p in got) == len(_BAD_KINDS)
