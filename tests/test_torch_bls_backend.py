"""The port's `gpu` BLS backend on the CPU (its stages' plain versions, at
8 lanes as tests/test_parallel.py runs the JAX verifier) against the
Python backends of both packages: the same verdicts (tolerance: exact
booleans) on signature sets made by the JAX package and carried across by
``convert.signature_sets_from``."""
import pytest

from lighthouse_tpu.crypto.bls import PythonBackend as JaxPythonBackend
from lighthouse_tpu.crypto.bls import SignatureSet as JaxSignatureSet
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.crypto.bls import gpu_backend
from lighthouse_tpu_torch.device import set_device

SIGNER = JaxPythonBackend()


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setenv("LHTPU_BLS_LANES", "8")
    prev = set_device("cpu")
    yield
    set_device(prev)


def _sets(n, shared=2):
    """n JAX-package sets over ``shared`` distinct messages."""
    out = []
    for i in range(n):
        msg = bytes([i % shared]) * 32
        out.append(JaxSignatureSet(SIGNER.sign(100 + i, msg),
                                   [SIGNER.sk_to_pk(100 + i)], msg))
    return out


def _verdicts(jax_sets):
    port_sets = convert.signature_sets_from(jax_sets)
    gpu = gpu_backend.GpuBackend()
    got = gpu.verify_signature_sets(port_sets)
    assert got == bls.PythonBackend().verify_signature_sets(port_sets)
    assert got == SIGNER.verify_signature_sets(jax_sets)
    return got


def test_registry_has_gpu_and_no_tpu():
    assert isinstance(bls._make("gpu"), gpu_backend.GpuBackend)
    with pytest.raises(ValueError):
        bls._make("tpu")
    assert gpu_backend.lane_options() == (8, 8)


def test_valid_sets_with_shared_message():
    assert _verdicts(_sets(3)) is True


def test_one_corrupted_message():
    sets = _sets(3)
    s = sets[1]
    sets[1] = JaxSignatureSet(s.signature, s.pubkeys, b"\xee" * 32)
    assert _verdicts(sets) is False


def test_malformed_bytes_infinity_and_empty():
    sets = _sets(2)
    s = sets[0]
    sets[0] = JaxSignatureSet(s.signature[:95], s.pubkeys, s.message)
    assert _verdicts(sets) is False
    sets[0] = JaxSignatureSet(bytes([0xC0]) + b"\x00" * 95, s.pubkeys,
                              s.message)
    assert _verdicts(sets) is False
    sets[0] = JaxSignatureSet(s.signature, [b"\x80" + b"\x00" * 47],
                              s.message)
    assert _verdicts(sets) is False
    assert gpu_backend.GpuBackend().verify_signature_sets([]) is False


def test_point_outside_subgroup_rejected():
    from lighthouse_tpu_torch.crypto.bls12_381 import Fp2
    from lighthouse_tpu_torch.crypto.bls12_381.curve import B_G2, G2Point, R
    from lighthouse_tpu_torch.crypto.bls12_381.sig import g2_compress
    xx = 1
    while True:
        yy = (Fp2(xx, 0) * Fp2(xx, 0) * Fp2(xx, 0) + B_G2).sqrt()
        if yy is not None:
            break
        xx += 1
    pt = G2Point(Fp2(xx, 0), yy)
    assert not pt.mul(R).is_infinity()
    sets = _sets(2)
    s = sets[1]
    sets[1] = JaxSignatureSet(g2_compress(pt), s.pubkeys, s.message)
    assert _verdicts(sets) is False


def test_module_entry_point_runs_the_gpu_backend(monkeypatch):
    calls = []
    real = gpu_backend.GpuBackend.verify_signature_sets

    def spy(self, sets):
        calls.append(len(sets))
        return real(self, sets)

    monkeypatch.setattr(gpu_backend.GpuBackend, "verify_signature_sets", spy)
    prev = bls._current
    try:
        bls._current = None                      # the default: gpu
        assert isinstance(bls.get_backend(), gpu_backend.GpuBackend)
        sets = convert.signature_sets_from(_sets(2))
        sets[0].signature = bytes(96)            # malformed: no flag bit
        assert bls.verify_signature_sets(sets) is False
    finally:
        bls._current = prev
    assert calls == [2]


@pytest.mark.parametrize("mode,corrupt", [(1, False), (2, True)])
def test_verdicts_under_digit_modes(mode, corrupt):
    """Under LHTPU_BIGINT_MXU modes 1 and 2 the pipeline gives the mode-0
    verdicts (those of the Python backends): a valid batch True in mode 1,
    one wrong message False in mode 2. The pad and pubkey caches are
    filled under mode 0 first: they hold integers and [0, 2p) Montgomery
    limbs, valid in every mode."""
    from lighthouse_tpu_torch.ops import bigint as bi
    sets = _sets(3)
    if corrupt:
        s = sets[1]
        sets[1] = JaxSignatureSet(s.signature, s.pubkeys, b"\xee" * 32)
    port_sets = convert.signature_sets_from(sets)
    gpu = gpu_backend.GpuBackend()
    assert bi.mxu_mode() == 0
    gpu_backend._pad_cache()
    assert gpu_backend.parse_sets(gpu, port_sets) is not None
    try:
        bi.set_mxu_mode(mode)
        got = gpu.verify_signature_sets(port_sets)
    finally:
        bi.set_mxu_mode(0)
    assert got is (not corrupt)
    assert got == bls.PythonBackend().verify_signature_sets(port_sets)
    assert got == SIGNER.verify_signature_sets(sets)
