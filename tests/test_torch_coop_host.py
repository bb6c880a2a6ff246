"""The thread-cooperative BLS kernels' CUDA sources (csrc/bls/pairing.cu
final_exp, csrc/bls/hash_to_g2.cu on csrc/bls/coop.cuh) built with g++
and run on the host, one thread per CUDA thread
(lighthouse_tpu_torch/testing/host_cuda.py), against the plain versions:
the product tree's edges, the final exponentiation, and hash-to-G2 with
SSWU's exceptional input. Canonical field values equal (tolerance zero).
The card tests (tests/test_torch_cuda.py, ``-m cuda``) hold the real
builds."""
import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto.bls12_381.hash_to_curve import DST_POP
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.ops import bigint as bi
from lighthouse_tpu_torch.ops import bls12_381 as k
from lighthouse_tpu_torch.testing import host_cuda


@pytest.fixture(autouse=True)
def cpu_device():
    prev = set_device("cpu")
    yield
    set_device(prev)


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    if host_cuda.compiler() is None:
        pytest.skip("needs g++ to build the kernels' sources on the host")
    d = tmp_path_factory.mktemp("host_cuda")
    return {name: host_cuda.build(name, d) for name in
            ("final_exp", "hash_to_g2")}


def _canon(a):
    return bi.canonical(torch.as_tensor(np.asarray(a)))


def _rand_f12(seed, n):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % k.P_INT
            for _ in range(12 * n)]
    return k.fp_encode(vals).reshape(n, 2, 3, 2, 32)


@pytest.mark.parametrize("n,mode", [(1, 1), (2, 0), (3, 0), (64, 0),
                                    (129, 0), (257, 0), (513, 0)])
def test_final_exp_source_on_host(programs, n, mode):
    """The product of n values (the tree over 256 slots, and the threads'
    folds past them), then in mode 1 the final exponentiation (the
    cooperative inverse, the x-chain); the flag is whether it is one."""
    fs = _rand_f12(n, n)
    out, flag = host_cuda.final_exp(programs["final_exp"], mode, fs)
    want = k._fp12_product_plain(convert.limbs_from_numpy(fs))
    if mode == 1:
        want = k._final_exponentiation_plain(want)
    assert torch.equal(_canon(out), bi.canonical(want))
    assert flag == int(bool(k.fp12_eq(want, k.fp12_one_like((), want))))


def test_final_exp_source_flags_one(programs):
    """A product that is one: f and its inverse."""
    f = convert.limbs_from_numpy(_rand_f12(7, 1))[0]
    fs = torch.stack([f, k.fp12_inv(f)]).numpy()
    for mode in (0, 1):
        out, flag = host_cuda.final_exp(programs["final_exp"], mode, fs)
        assert flag == 1
        assert torch.equal(_canon(out),
                           bi.canonical(k.fp12_one_like((), f)))


def test_hash_to_g2_source_on_host(programs):
    """Two messages, lane 0's u0 zero (SSWU's exceptional case, tv1 = 0):
    the Jacobian coordinates of the plain version (the cooperative design;
    the card tests hold the one-thread design of wide batches)."""
    u0, u1 = (np.ascontiguousarray(a) for a in
              k.hash_to_field_host([b"", b"abc"], DST_POP))
    u0[0] = 0
    got = host_cuda.hash_to_g2(programs["hash_to_g2"], u0, u1)
    want = k._hash_to_g2_plain(convert.limbs_from_numpy(u0),
                               convert.limbs_from_numpy(u1))
    for g, w in zip(got, want):
        assert torch.equal(_canon(g), bi.canonical(w))
