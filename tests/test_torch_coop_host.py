"""The thread-cooperative BLS kernels' CUDA sources (csrc/bls/pairing.cu
final_exp and the cooperative Miller loop, csrc/bls/hash_to_g2.cu on
csrc/bls/coop.cuh, and csrc/bls/aggregate.cu's tree g2_sum) built with
g++ and run on the host, one thread per CUDA thread
(lighthouse_tpu_torch/testing/host_cuda.py), against the plain versions:
the product tree's edges, the final exponentiation, hash-to-G2 with
SSWU's exceptional input, the Miller loop with a masked lane, and the
G2 sum over blocks with infinity, doubling and opposite points. Canonical
field values equal (tolerance zero); the G2 sum, whose tree adds in
another order than the plain version, as points (projectively), and limb
for limb against a plain model of its own order. The card tests
(tests/test_torch_cuda.py, ``-m cuda``) hold the real builds."""
import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto.bls12_381.hash_to_curve import DST_POP
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.measure import g2_projective_err
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
    progs = {name: host_cuda.build(name, d) for name in
             ("final_exp", "hash_to_g2", "g2_sum", "miller_loop")}
    # four threads a block (and so at most four blocks): a thread folds
    # several points in series past 16, as past 128^2 at full width
    progs["g2_sum_t4"] = host_cuda.build("g2_sum", d, ("-DLH_G2_SUM_T=4",))
    # the one-thread Miller design at any n
    progs["miller_loop_serial"] = host_cuda.build(
        "miller_loop", d, ("-DLH_ML_COOP_MAX=0",))
    return progs


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


def _g2_points(seed, n, kinds):
    """n Jacobian G2 points with random Z (each k_i G scaled by a random
    l: (x l^2, y l^3, l)); ``kinds`` sets lanes apart: "inf" at infinity,
    ("dup", j) the point of lane j, ("neg", j) its negation."""
    from lighthouse_tpu_torch.crypto.bls12_381 import G2_GENERATOR
    rng = np.random.default_rng(seed)
    pts = [G2_GENERATOR.mul(int(rng.integers(1, 2**62))) for _ in range(n)]
    for i, kind in kinds.items():
        if kind != "inf":
            pts[i] = pts[kind[1]] if kind[0] == "dup" else pts[kind[1]].neg()
    xs, ys = zip(*(p.to_affine() for p in pts))
    lam = torch.from_numpy(k.fp_encode(
        [int.from_bytes(rng.bytes(48), "little") % k.P_INT
         for _ in range(2 * n)]).reshape(n, 2, 32))
    x = torch.from_numpy(np.ascontiguousarray(k.fp2_encode(xs)))
    y = torch.from_numpy(np.ascontiguousarray(k.fp2_encode(ys)))
    l2 = k.fp2_mul(lam, lam)
    x, y, z = k.fp2_mul(x, l2), k.fp2_mul(y, k.fp2_mul(l2, lam)), lam
    for i, kind in kinds.items():
        if kind == "inf":
            z[i] = 0
    return x, y, z


def _tree_sum_plain(x, y, z, t):
    """The g2_sum kernel's order in plain ops: G = min(ceil(n / t), t)
    blocks of t threads, thread g folding g, g + G t, ...; each block's
    tree (slot i takes slot i + ceil(w / 2)); then the partials' tree."""
    def tree(pts):
        while len(pts) > 1:
            h = (len(pts) + 1) // 2
            pts = [k.g2_add(*pts[i], *pts[i + h]) if i + h < len(pts)
                   else pts[i] for i in range(h)]
        return pts[0]

    def launch(pts, grid):
        out = []
        for b in range(grid):
            slots = []
            for g in range(b * t, min((b + 1) * t, len(pts))):
                acc = pts[g]
                for i in range(g + grid * t, len(pts), grid * t):
                    acc = k.g2_add(*acc, *pts[i])
                slots.append(acc)
            out.append(tree(slots))
        return out

    n = x.shape[0]
    grid = min(-(-n // t), t)
    parts = launch([(x[i:i + 1], y[i:i + 1], z[i:i + 1])
                    for i in range(n)], grid)
    return tuple(c[0] for c in launch(parts, 1)[0])


@pytest.mark.parametrize("n,kinds", [
    (1, {}),
    (2, {1: ("neg", 0)}),                          # P + (-P): infinity
    (2, {1: ("dup", 0)}),                          # P + P: the doubling
    (3, {0: "inf"}),
    (130, {0: "inf", 65: ("dup", 1), 7: ("neg", 71), 129: "inf"}),
    (300, {4: ("dup", 132), 200: ("neg", 72)}),
])
def test_g2_sum_source_on_host(programs, n, kinds):
    """The tree g2_sum over one to three blocks of 128 threads (130 and
    300 points: not multiples of the block), with infinity, a doubling
    and opposite points meeting in the tree, held as a point to the plain
    version's JAX-order sum, and limb for limb to a plain model of the
    tree's own order."""
    x, y, z = _g2_points(n, n, kinds)
    got = tuple(torch.from_numpy(a) for a in host_cuda.g2_sum(
        programs["g2_sum"], x.numpy(), y.numpy(), z.numpy()))
    assert g2_projective_err(got, k._g2_sum_plain(x, y, z)) == 0
    want = _tree_sum_plain(x, y, z, 128)
    for g, w in zip(got, want):
        assert torch.equal(bi.canonical(g), bi.canonical(w))


@pytest.mark.parametrize("n", [5, 40])
def test_g2_sum_source_folds_on_host(programs, n):
    """Built with four threads a block: 5 points take two blocks, 40
    take four, each thread folding up to three points in series before
    the trees (the path of more than 128^2 points at full width)."""
    x, y, z = _g2_points(100 + n, n, {1: "inf", 3: ("dup", 19 % n)})
    got = tuple(torch.from_numpy(a) for a in host_cuda.g2_sum(
        programs["g2_sum_t4"], x.numpy(), y.numpy(), z.numpy()))
    assert g2_projective_err(got, k._g2_sum_plain(x, y, z)) == 0
    for g, w in zip(got, _tree_sum_plain(x, y, z, 4)):
        assert torch.equal(bi.canonical(g), bi.canonical(w))


def _pairs(seed, n):
    from lighthouse_tpu_torch.crypto.bls12_381 import (
        G1_GENERATOR, G2_GENERATOR,
    )
    rng = np.random.default_rng(seed)
    ps = [G1_GENERATOR.mul(int(rng.integers(1, 2**62))).to_affine()
          for _ in range(n)]
    qs = [G2_GENERATOR.mul(int(rng.integers(1, 2**62))).to_affine()
          for _ in range(n)]
    px, py = (np.ascontiguousarray(k.fp_encode([p[c] for p in ps]))
              for c in (0, 1))
    qx, qy = (np.ascontiguousarray(k.fp2_encode([q[c] for q in qs]))
              for c in (0, 1))
    return px, py, qx, qy


@pytest.mark.parametrize("n,masked,program", [
    (1, (), "miller_loop"),
    (2, (0,), "miller_loop"),
    (3, (1,), "miller_loop"),
    (2, (1,), "miller_loop_serial"),
])
def test_miller_loop_source_on_host(programs, n, masked, program):
    """The cooperative Miller loop (a block of 128 threads a pair: T's
    layers, the line's scalings, the sparse product and f's square on
    the block's steps), and the one-thread design its C entry picks past
    LH_ML_COOP_MAX, on 1-3 pairs with a masked lane: each lane canonically
    equal to the plain loop (the identity where masked)."""
    px, py, qx, qy = _pairs(n + 10 * len(masked), n)
    mask = np.ones(n, np.int32)
    mask[list(masked)] = 0
    got = host_cuda.miller_loop(programs[program], px, py, qx, qy, mask)
    want = k._mask_to_one(k._miller_loop_plain(
        *(convert.limbs_from_numpy(a) for a in (px, py, qx, qy))), mask)
    assert torch.equal(_canon(got), bi.canonical(want))


@pytest.mark.parametrize("n,live,ran", [
    (129, 128, 129),             # within the crossover: every pair
    (10241, 128, 128),           # the verification past 128 messages
    (10241, 2561, 2561),
    (10241, 2562, 10241),        # too many live pairs for a block each
    (10241, 0, 0),
])
def test_miller_loop_runs_on_the_live_pairs_past_the_crossover(n, live, ran):
    """Past LH_ML_COOP_MAX, ``miller_loop_batch`` hands the kernel the
    live pairs alone when they are within it (so it picks a block a
    pair), else all n; within it, every pair."""
    from lighthouse_tpu_torch.ops import bls_cost as cost
    assert cost.miller_loop_pairs(n, live) == ran
    mask = np.zeros(n, bool)
    mask[:live] = True
    for m in (mask, torch.from_numpy(mask.astype(np.int32))):
        got = k._miller_live_lanes(n, m)
        if ran == n:
            assert got is None
        else:
            assert np.array_equal(got, np.flatnonzero(mask))
    assert k._miller_live_lanes(n, None) is None


def test_live_pairs_alone_give_the_masked_loop():
    """The Miller loop on the live pairs alone, scattered back among
    identities, is the masked loop lane for lane."""
    px, py, qx, qy = (convert.limbs_from_numpy(a) for a in _pairs(77, 3))
    mask = np.array([True, False, True])
    got = k._on_live_lanes(k._miller_loop_plain, np.flatnonzero(mask),
                           px, py, qx, qy)
    want = k._mask_to_one(k._miller_loop_plain(px, py, qx, qy), mask)
    assert torch.equal(bi.canonical(got), bi.canonical(want))


@pytest.mark.parametrize("source,macro,value", [
    ("pairing.cu", "LH_ML_COOP_MAX", "ML_COOP_MAX"),
    ("aggregate.cu", "LH_G2_SUM_T", "G2_SUM_THREADS"),
    ("aggregate.cu", "LH_G2_SUM_WARP_ROUNDS", "G2_SUM_WARP_ROUNDS"),
    ("hash_to_g2.cu", "LH_H2G_COOP_MAX", "H2G_COOP_MAX"),
])
def test_cost_model_matches_the_sources(source, macro, value):
    """ops/bls_cost.py's copies of the sources' design constants (which
    design a size picks, the tree's shape) are the sources' values."""
    import re

    from lighthouse_tpu_torch.kernels import CSRC
    from lighthouse_tpu_torch.ops import bls_cost as cost
    text = (CSRC / "bls" / source).read_text()
    m = re.search(rf"#define {macro} (\d+)", text)
    assert m is not None and int(m.group(1)) == getattr(cost, value)


def test_miller_depth_counts_the_steps():
    """271 cooperative steps: 4 a doubling bit below the top of |x| and 4
    an addition (its 5 set bits below the top), less the last doubling's
    fourth (bit 0 of |x| is clear)."""
    from lighthouse_tpu_torch.ops import bls_cost as cost
    bits = bin(k._X_ABS)[3:]
    assert len(bits) == 63 and bits.count("1") == 5 and bits[-1] == "0"
    assert cost.MILLER_COOP_DEPTH == 4 * 63 + 4 * 5 - 1 == 271
    assert cost.miller_loop_depth(cost.ML_COOP_MAX) == 271
    assert cost.miller_loop_depth(cost.ML_COOP_MAX + 1) == cost.MILLER_LANE
