"""EIP-7594 cells-KZG: RS extension, per-cell proofs, batch verify,
50% erasure recovery (c-kzg cells surface; the reference's crypto/kzg,
CELLS_PER_EXT_BLOB crypto/kzg/src/lib.rs:31).

Devnet-size setups; the port's group arithmetic runs on the native C++
MSM/pairing path (native/bls12_381.cpp kzg_g1_msm / kzg_pairing_check).

The same cases as the JAX package's tests/test_kzg_cells.py, run on the port
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
    # 2n = 32 extended points, 8 cells of l = 4 field elements
    return Kzg(devnet_size=16, cells_per_ext_blob=8)


def _blob(kzg, seed=1):
    return b"".join(((i * 7 + seed) % R).to_bytes(32, "big")
                    for i in range(kzg.size))


def test_cells_roundtrip_and_systematic_half(kzg):
    blob = _blob(kzg)
    cells = kzg.compute_cells(blob)
    assert len(cells) == 8 and all(len(c) == 4 * 32 for c in cells)
    # systematic: first half of the cells in brp order IS the blob
    assert kzg.cells_to_blob(cells) == blob


def test_cell_proofs_verify_and_reject(kzg):
    blob = _blob(kzg)
    c = kzg.blob_to_kzg_commitment(blob)
    cells, proofs = kzg.compute_cells_and_kzg_proofs(blob)
    n = kzg.cells_per_ext_blob
    assert kzg.verify_cell_kzg_proof_batch([c] * n, list(range(n)),
                                           cells, proofs)
    # single-cell verification (sampling path)
    assert kzg.verify_cell_kzg_proof_batch([c], [5], [cells[5]],
                                           [proofs[5]])
    # tampered cell value
    bad = bytearray(cells[3]); bad[-1] ^= 1
    assert not kzg.verify_cell_kzg_proof_batch([c], [3], [bytes(bad)],
                                               [proofs[3]])
    # right cell, wrong coset index
    assert not kzg.verify_cell_kzg_proof_batch([c], [4], [cells[3]],
                                               [proofs[3]])
    # proof swapped between cells
    assert not kzg.verify_cell_kzg_proof_batch([c], [3], [cells[3]],
                                               [proofs[4]])
    # out-of-range index / non-canonical cell element
    assert not kzg.verify_cell_kzg_proof_batch([c], [8], [cells[0]],
                                               [proofs[0]])
    assert not kzg.verify_cell_kzg_proof_batch(
        [c], [0], [R.to_bytes(32, "big") * 4], [proofs[0]])


def test_mixed_blob_batch(kzg):
    b1, b2 = _blob(kzg, 1), _blob(kzg, 99)
    c1, c2 = (kzg.blob_to_kzg_commitment(b) for b in (b1, b2))
    cl1, pf1 = kzg.compute_cells_and_kzg_proofs(b1)
    cl2, pf2 = kzg.compute_cells_and_kzg_proofs(b2)
    assert kzg.verify_cell_kzg_proof_batch(
        [c1, c2, c1, c2], [0, 5, 7, 2],
        [cl1[0], cl2[5], cl1[7], cl2[2]],
        [pf1[0], pf2[5], pf1[7], pf2[2]])
    # one bad entry poisons the whole batch
    assert not kzg.verify_cell_kzg_proof_batch(
        [c1, c2], [0, 5], [cl1[0], cl1[5]], [pf1[0], pf2[5]])


def test_recover_from_any_half(kzg):
    blob = _blob(kzg, 42)
    cells, proofs = kzg.compute_cells_and_kzg_proofs(blob)
    for keep in ([0, 2, 5, 7], [4, 5, 6, 7], [1, 3, 4, 6]):
        rc, rp = kzg.recover_cells_and_kzg_proofs(
            keep, [cells[i] for i in keep])
        assert rc == cells and rp == proofs
    with pytest.raises(KzgError):
        kzg.recover_cells_and_kzg_proofs([0, 2, 5],
                                         [cells[i] for i in [0, 2, 5]])
    # corrupted shares: with MORE than half the cells there is redundancy,
    # so inconsistency is detected (recovered degree >= n).  At exactly
    # half, any data interpolates — detection is impossible there, which
    # is why sampling verifies cell proofs before recovery.
    bad = bytearray(cells[2]); bad[-1] ^= 1
    with pytest.raises(KzgError):
        kzg.recover_cells_and_kzg_proofs(
            [0, 2, 4, 5, 7],
            [cells[0], bytes(bad), cells[4], cells[5], cells[7]])


def test_spec_shape_128_cells():
    """The spec cell count (128 cells, CELLS_PER_EXT_BLOB) over a devnet
    64-element setup: l = 1, single-point proofs."""
    from lighthouse_tpu_torch.crypto.kzg import _native
    _native()   # the port raises where the library does not build
    k = Kzg(devnet_size=64)
    blob = b"".join(((i * 3 + 1) % R).to_bytes(32, "big") for i in range(64))
    c = k.blob_to_kzg_commitment(blob)
    assert k.cells_per_ext_blob == 128
    cells, proofs = k.compute_cells_and_kzg_proofs(blob)
    sample = [0, 17, 64, 127]
    assert k.verify_cell_kzg_proof_batch([c] * 4, sample,
                                         [cells[i] for i in sample],
                                         [proofs[i] for i in sample])
    half = list(range(1, 128, 2))   # odd columns only — no systematic half
    rc, _rp = k.recover_cells_and_kzg_proofs(half, [cells[i] for i in half])
    assert k.cells_to_blob(rc) == blob
