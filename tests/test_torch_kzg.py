"""KZG commitments on our own pairing (devnet setup).

The same cases as the JAX package's tests/test_kzg.py, run on the port
(imports switched to lighthouse_tpu_torch).
"""
import pytest

from lighthouse_tpu_torch.crypto.kzg import Kzg, KzgError
from lighthouse_tpu_torch.crypto.bls12_381.fields import R
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU; its BLS backend put back after each test."""
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


@pytest.fixture(scope="module")
def kzg():
    return Kzg(devnet_size=8)


def _blob(values, size=8):
    assert len(values) <= size
    vals = list(values) + [0] * (size - len(values))
    return b"".join(v.to_bytes(32, "big") for v in vals)


def test_commit_and_verify_proof(kzg):
    blob = _blob([5, 7, 11, 13])
    c = kzg.blob_to_kzg_commitment(blob)
    proof, y = kzg.compute_kzg_proof(blob, z=12345)
    assert kzg.verify_kzg_proof(c, 12345, y, proof)
    assert not kzg.verify_kzg_proof(c, 12345, (y + 1) % R, proof)
    assert not kzg.verify_kzg_proof(c, 12346, y, proof)


def test_blob_proof_roundtrip(kzg):
    blob = _blob([1, 2, 3, 4, 5])
    c = kzg.blob_to_kzg_commitment(blob)
    proof = kzg.compute_blob_kzg_proof(blob, c)
    assert kzg.verify_blob_kzg_proof(blob, c, proof)
    other = _blob([9, 9, 9])
    assert not kzg.verify_blob_kzg_proof(other, c, proof)
    assert kzg.verify_blob_kzg_proof_batch([blob], [c], [proof])


def test_commitment_matches_evaluations(kzg):
    """p evaluated on the domain must reproduce the blob values."""
    vals = [3, 1, 4, 1, 5, 9, 2, 6]
    blob = _blob(vals)
    coeffs = kzg._coeffs(kzg._evals_from_blob(blob))
    from lighthouse_tpu_torch.crypto.kzg import _poly_eval
    for x, want in zip(kzg.domain, vals):
        assert _poly_eval(coeffs, x) == want


def test_non_canonical_blob_rejected(kzg):
    blob = (R).to_bytes(32, "big") * 8
    with pytest.raises(KzgError):
        kzg.blob_to_kzg_commitment(blob)


def test_ntt_matches_naive_and_batch_verify_speed():
    """iNTT interpolation equals direct evaluation; RLC batch verify is 2
    pairings for the whole deneb sidecar batch."""
    import time
    k = Kzg(devnet_size=64)
    blob = b"".join(j.to_bytes(32, "big") for j in range(64))
    evals = k._evals_from_blob(blob)
    coeffs = k._coeffs(evals)
    # coefficients re-evaluate to the original evals on the domain
    from lighthouse_tpu_torch.crypto.kzg import _poly_eval
    for i in (0, 1, 31, 63):
        assert _poly_eval(coeffs, k.domain[i]) == evals[i]
    # barycentric agrees with coefficient evaluation off-domain
    z = 123456789
    from lighthouse_tpu_torch.crypto.kzg import _poly_eval as pe
    assert k._eval_barycentric(evals, z) == pe(coeffs, z)
    # and ON the domain returns the eval directly
    assert k._eval_barycentric(evals, k.domain[7]) == evals[7]
    # batch verify: 6 valid blobs in one 2-pairing check
    blobs, comms, proofs = [], [], []
    for i in range(6):
        b = b"".join((i * 64 + j).to_bytes(32, "big") for j in range(64))
        c = k.blob_to_kzg_commitment(b)
        p = k.compute_blob_kzg_proof(b, c)
        blobs.append(b); comms.append(c); proofs.append(p)
    t0 = time.perf_counter()
    assert k.verify_blob_kzg_proof_batch(blobs, comms, proofs)
    batch_t = time.perf_counter() - t0
    # a corrupted proof in the batch must fail
    bad = list(proofs)
    bad[3] = proofs[2]
    assert not k.verify_blob_kzg_proof_batch(blobs, comms, bad)
    # mismatched lengths rejected, empty accepted
    assert not k.verify_blob_kzg_proof_batch(blobs[:2], comms, proofs)
    assert k.verify_blob_kzg_proof_batch([], [], [])
    # the batch should cost roughly ONE pairing check, not six; with the
    # native pairing, singles are fast enough that per-blob python
    # overhead (barycentric evals) shows — allow ~4.5x one verification
    t0 = time.perf_counter()
    assert k.verify_blob_kzg_proof(blobs[0], comms[0], proofs[0])
    single_t = time.perf_counter() - t0
    assert batch_t < 4.5 * single_t, (batch_t, single_t)
