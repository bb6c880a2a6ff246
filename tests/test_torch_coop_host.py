"""The thread-cooperative BLS kernels' CUDA sources (csrc/bls/pairing.cu
final_exp and the cooperative Miller loop, csrc/bls/hash_to_g2.cu on
csrc/bls/coop.cuh, csrc/bls/aggregate.cu's tree g2_sum, and the
lane-group kernels csrc/bls/rlc_scale.cu and g2_intake.cu) built with
g++ and run on the host, one thread per CUDA thread
(lighthouse_tpu_torch/testing/host_cuda.py), against the plain versions:
the product tree's edges, the final exponentiation, hash-to-G2 with
SSWU's exceptional input, the Miller loop with a masked lane, the G2 sum
over blocks with infinity, doubling and opposite points, the scalar
multiplies with infinity, zero and all-ones scalars and lanes of either
z, decompression with an x that has no root, and the subgroup check.
The segment sums' trees (csrc/bls/aggregate.cu, at T = 128 and at T = 8
where ranges take several pieces and a fold past T^2 lanes) on ranges of
~40, one-lane ranges, ends in the middle of segments, padding ends at 0,
and lanes at infinity, doubling and opposite; the walk with its root's
caps folded in (csrc/path_update.cu) and the standalone cap fold
(csrc/cap_fold.cu) against the CPU tree and the JAX ``_cap_root``.
The lane programs' tables (csrc/bls/lane_prog.cuh) are checked against
their generator and run with Python integers against the formulas. Canonical
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
    for name in ("rlc_scale", "g2_intake", "affine"):
        progs[name] = host_cuda.build(name, d)
    # other lane-group widths than the sources' three threads (two idle a
    # warp): one, four, a whole warp
    progs["rlc_scale_w14"] = host_cuda.build(
        "rlc_scale", d, constants={"LH_RLC_G1_WIDTH": 1,
                                   "LH_RLC_G2_WIDTH": 4})
    progs["rlc_scale_w32"] = host_cuda.build(
        "rlc_scale", d, constants={"LH_RLC_G1_WIDTH": 32,
                                   "LH_RLC_G2_WIDTH": 32})
    progs["g2_intake_w4"] = host_cuda.build(
        "g2_intake", d, constants={"LH_G2I_WIDTH": 4})
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
    ("rlc_scale.cu", "LH_RLC_G1_WIDTH", "RLC_G1_WIDTH"),
    ("rlc_scale.cu", "LH_RLC_G2_WIDTH", "RLC_G2_WIDTH"),
    ("g2_intake.cu", "LH_G2I_WIDTH", "G2I_WIDTH"),
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


def _affine_points(seed, n, g2):
    """n affine points k_i G (z one), as the main path sends them."""
    from lighthouse_tpu_torch.crypto.bls12_381 import (
        G1_GENERATOR, G2_GENERATOR,
    )
    rng = np.random.default_rng(seed)
    gen = G2_GENERATOR if g2 else G1_GENERATOR
    pts = [gen.mul(int(rng.integers(1, 2**62))).to_affine()
           for _ in range(n)]
    enc = k.fp2_encode if g2 else k.fp_encode
    one = k.FP2_ONE if g2 else k.FP_ONE
    x, y = (np.ascontiguousarray(enc([p[c] for p in pts])) for c in (0, 1))
    z = np.array(np.broadcast_to(one, x.shape))
    return x, y, z


def _rescale(x, y, z, lanes, g2, seed):
    """The given lanes' points with z a random l: (x l^2, y l^3, z l)."""
    rng = np.random.default_rng(seed)
    shape = (len(lanes),) + x.shape[1:]
    lam = torch.from_numpy(k.fp_encode(
        [int.from_bytes(rng.bytes(48), "little") % k.P_INT
         for _ in range(int(np.prod(shape)) // 32)]).reshape(shape))
    mul = k.fp2_mul if g2 else bi.mont_mul
    l2 = mul(lam, lam)
    x, y, z = x.copy(), y.copy(), z.copy()
    x[lanes] = mul(torch.from_numpy(x[lanes]), l2).numpy()
    y[lanes] = mul(torch.from_numpy(y[lanes]), mul(l2, lam)).numpy()
    z[lanes] = mul(torch.from_numpy(z[lanes]), lam).numpy()
    return x, y, z


@pytest.mark.parametrize("program", ["rlc_scale", "rlc_scale_w14",
                                     "rlc_scale_w32"])
@pytest.mark.parametrize("g2", [False, True])
@pytest.mark.parametrize("n", [1, 3, 19])
def test_rlc_scale_source_on_host(programs, program, g2, n):
    """[b_i]P_i on the lane groups (at the source's widths, at 1 and 4
    threads a lane, and at a whole warp), at lane counts that fill no
    warp: lane 0 at infinity, a zero scalar (the last lane) and one of all
    ones, affine lanes (the mixed addition) beside lanes of another z (the
    general one); over G1 also the point (0, 2) of order 3 with scalars 5
    (T + T: the addition's doubling branch, its group a program behind
    the others of its warp) and 7 (2T + T: the opposite points); the
    Jacobian output canonically, coordinate for coordinate, equal to the
    plain scalar multiply."""
    x, y, z = _affine_points(n + (10 if g2 else 20), n, g2)
    x, y, z = _rescale(x, y, z, list(range(1, n, 2)), g2, n)
    z[0] = 0
    rng = np.random.default_rng(n)
    scalars = [int(s) for s in rng.integers(1, 2**63, size=n)]
    scalars[n // 2] = 2**64 - 1
    if not g2 and n >= 3:
        for lane, scalar in ((1, 5), (2, 7)):
            x[lane], y[lane] = k.fp_encode([0, 2])
            z[lane] = k.FP_ONE
            scalars[lane] = scalar
    scalars[-1] = 0
    bits = k.scalars_to_bits(scalars, 64)
    got = host_cuda.rlc_scale(programs[program], 2 if g2 else 1, x, y, z,
                              bits)
    mul = k._g2_scalar_mul_plain if g2 else k._g1_scalar_mul_plain
    want = mul(*(torch.from_numpy(a) for a in (x, y, z)), bits)
    for g, w in zip(got, want):
        assert torch.equal(_canon(g), bi.canonical(w))


@pytest.mark.parametrize("g2", [False, True])
def test_rlc_scale_source_long_scalars_on_host(programs, g2):
    """Scalars of more than 64 bits (70 here: the kernel reads them bit by
    bit where it packs 64 into a register), one of them zero."""
    x, y, z = _affine_points(60, 3, g2)
    rng = np.random.default_rng(70)
    scalars = [int(rng.integers(1, 2**62)) << 8 | 0xA5 for _ in range(2)]
    bits = k.scalars_to_bits(scalars + [0], 70)
    got = host_cuda.rlc_scale(programs["rlc_scale"], 2 if g2 else 1, x, y,
                              z, bits)
    mul = k._g2_scalar_mul_plain if g2 else k._g1_scalar_mul_plain
    want = mul(*(torch.from_numpy(a) for a in (x, y, z)), bits)
    for g, w in zip(got, want):
        assert torch.equal(_canon(g), bi.canonical(w))


@pytest.mark.parametrize("program", ["g2_intake", "g2_intake_w4"])
@pytest.mark.parametrize("n", [1, 3, 11])
def test_g2_intake_source_on_host(programs, program, n):
    """Decompression on the lane groups: y and ok canonically equal to
    the plain version with both sign flags, lane 0's x with no root (its
    y too); the subgroup check on affine points and one of another z,
    lane 0 at infinity, and on a point outside the subgroup."""
    x, y, z = _affine_points(40 + n, n, True)
    xs = x.copy()
    xs[0] = k.fp_encode([5, 7]).reshape(2, 32)          # no root
    flags = np.arange(n, dtype=np.int32) % 2
    gy, gok = host_cuda.g2_decompress(programs[program], xs, flags)
    wy, wok = k._g2_decompress_plain(torch.from_numpy(xs), flags)
    assert not bool(wok[0])
    assert torch.equal(_canon(gy), bi.canonical(wy))
    assert np.array_equal(gok.astype(bool), wok.numpy())
    x, y, z = _rescale(x, y, z, list(range(1, n, 2)), True, n)
    z[0] = 0
    if n > 2:
        # a curve point outside G2: the no-root x's neighbour with a root
        from lighthouse_tpu_torch.crypto.bls12_381.fields import Fp2
        from lighthouse_tpu_torch.crypto.bls12_381.curve import B_G2
        for c in range(1, 100):
            xx = Fp2(c, 1)
            yy = (xx * xx * xx + B_G2).sqrt()
            if yy is not None:
                break
        x[2], y[2] = (k.fp2_encode([v]).reshape(2, 32) for v in (xx, yy))
        z[2] = k.FP2_ONE
    got = host_cuda.g2_in_subgroup(programs[program], x, y, z)
    want = k._g2_in_subgroup_plain(*(torch.from_numpy(a) for a in (x, y, z)))
    assert np.array_equal(got.astype(bool), want.numpy())
    if n > 2:
        assert not bool(want[2]) and bool(want[1])


@pytest.fixture(scope="module")
def walk_programs(tmp_path_factory):
    """The walk's source at its own threads a block, and at 32 (so a few
    hundred rows take several blocks and several grid levels)."""
    if host_cuda.compiler() is None:
        pytest.skip("needs g++ to build the kernels' sources on the host")
    d = tmp_path_factory.mktemp("host_walk")
    return {"source": host_cuda.build("path_walk", d),
            "t32": host_cuda.build("path_walk", d,
                                   constants={"LH_PATH_THREADS": 32})}


def _walk_case(depth, n_rows, seed):
    """Random levels of a depth-``depth`` tree, ``n_rows`` dirty leaves
    written, and their sorted distinct rows."""
    from lighthouse_tpu_torch.ops import sha256 as sh
    rng = np.random.default_rng(seed)
    levels = [torch.from_numpy(rng.integers(
        0, 2**32, size=(1 << depth, 8), dtype=np.uint64).astype(
            np.uint32).view(np.int32))]
    for _ in range(depth):
        levels.append(sh.hash64(levels[-1].reshape(-1, 16)))
    rows = np.unique(rng.integers(0, 1 << depth, size=n_rows))
    levels[0][rows] = torch.from_numpy(rng.integers(
        0, 2**32, size=(len(rows), 8), dtype=np.uint64).astype(
            np.uint32).view(np.int32))
    return levels, rows.astype(np.int32)


@pytest.mark.parametrize("program,blocks,depth,n_rows", [
    ("source", 0, 10, 600),     # 5 blocks of 128; the grid, then block 0
    ("source", 0, 6, 1),        # one row: block 0 from the first level
    ("t32", 0, 8, 200),         # 6-7 blocks of 32, four grid levels
    ("t32", 2, 8, 200),         # two blocks grid-striding over the rows
    ("t32", 1, 8, 200),         # one block: the grid barrier of one block
    ("t32", 0, 9, 512),         # every leaf: each level's parents all dirty
])
def test_path_walk_source_on_host(walk_programs, program, blocks, depth,
                                  n_rows):
    """The one-launch walk (csrc/path_update.cu) run as a cooperative
    launch on the host, at several grid sizes, against the plain walk on
    the same levels and rows: every level equal (tolerance zero)."""
    from lighthouse_tpu_torch.ops import merkle_tree as mt
    levels, rows = _walk_case(depth, n_rows, depth * 1000 + n_rows)
    if n_rows == 512:
        rows = np.arange(1 << depth, dtype=np.int32)
    got, root = host_cuda.path_walk(walk_programs[program],
                                    [lv.numpy() for lv in levels], rows,
                                    depth, blocks)
    mt._path_walk_plain(levels, torch.from_numpy(rows))
    for g, w in zip(got, levels):
        assert np.array_equal(g, w.numpy())
    assert np.array_equal(root, levels[-1][0].numpy())


@pytest.mark.parametrize("program,blocks,depth,n_rows,limit", [
    ("source", 0, 10, 600, 40),     # the grid's levels, then block 0's
    ("source", 0, 6, 1, 6),         # block 0 from the first level; no cap
    ("t32", 0, 8, 200, 9),          # four grid levels, one cap
    ("t32", 1, 9, 512, 64),         # one block, every leaf; 55 caps
])
def test_path_walk_folds_the_caps_on_host(walk_programs, program, blocks,
                                          depth, n_rows, limit):
    """The walk with its root's zero caps folded in by the same launch:
    the levels as the plain walk's, and the capped root equal to the CPU
    tree's (``_path_walk`` on CPU levels: the plain walk and cap fold) and
    to the JAX package's ``_cap_root`` of the walked top node."""
    import jax.numpy as jnp

    from lighthouse_tpu.ops.merkle_tree import _cap_root
    from lighthouse_tpu_torch.ops import merkle_tree as mt
    levels, rows = _walk_case(depth, n_rows, depth * 7 + n_rows)
    if n_rows == 512:
        rows = np.arange(1 << depth, dtype=np.int32)
    got, root = host_cuda.path_walk(walk_programs[program],
                                    [lv.numpy() for lv in levels], rows,
                                    limit, blocks)
    want = mt._path_walk(levels, torch.from_numpy(rows), limit)
    for g, w in zip(got, levels):
        assert np.array_equal(g, w.numpy())
    assert np.array_equal(root, want.numpy())
    top = jnp.asarray(levels[-1][0].numpy().view(np.uint32))
    assert np.array_equal(root.view(np.uint32),
                          np.asarray(_cap_root(top, depth, limit)))


def test_walk_depth_limit_matches_the_source():
    import re

    from lighthouse_tpu_torch.kernels import CSRC
    from lighthouse_tpu_torch.ops import merkle_tree as mt
    text = (CSRC / "path_update.cu").read_text()
    m = re.search(r"#define LH_PATH_MAX_DEPTH (\d+)", text)
    assert m is not None and int(m.group(1)) == mt.PATH_MAX_DEPTH


@pytest.fixture(scope="module")
def seg_programs(tmp_path_factory):
    """The segment sum's source as it is (pieces of 32 or 128 lanes), and
    with pieces of 4 or 8 (a range of ~40 lanes takes five pieces, one of
    300 a fold past T^2 = 64 lanes; a block of 8 or 16 threads)."""
    if host_cuda.compiler() is None:
        pytest.skip("needs g++ to build the kernels' sources on the host")
    d = tmp_path_factory.mktemp("host_seg")
    return {"source": (host_cuda.build("g1_segment_sum", d), (32, 128)),
            "small": (host_cuda.build("g1_segment_sum", d, constants={
                "LH_SEG_T_SHORT": 4, "LH_SEG_T_LONG": 8}), (4, 8))}


def _seg_layout(name, n):
    """(starts, ends) of a named layout of n lanes."""
    starts = np.zeros(n, np.int32)
    if name == "ranges of 40":
        starts[::40] = 1
        ends = np.append(np.arange(39, n, 40), n - 1)
    elif name == "one range":
        starts[0] = 1
        ends = np.array([n - 1, 0, 0])
    elif name == "one-lane ranges":
        starts[:] = 1
        ends = np.arange(n)
    elif name == "ends mid-segment":
        starts[[0, 100, 101, 250]] = 1
        ends = np.array([37, 99, 100, 180, 101, 249, 260, n - 1, 5])
    elif name == "short pieces":            # many padding ends: the
        starts[[0, 100, 101, 250]] = 1      # short piece, long ranges
        ends = np.array([99, 100, 249, n - 1] + [0] * 80)
    else:                                   # "padding at 0"
        starts[[0, 3, 60, 200]] = 1
        ends = np.array([2, 59, 199, n - 1] + [0] * 12)
    return starts, ends.astype(np.int32)


def _seg_points(n, seed):
    """n Jacobian G1 points s_i G with random Z (scalars s_i, 0 at
    infinity): lanes 5 and 41 at infinity, lane 9 the point of lane 8
    (a doubling in a tree), lane 13 the negation of lane 12. The points
    from the reference's pure-Python curve (lighthouse_tpu.crypto)."""
    from lighthouse_tpu.crypto.bls12_381 import G1_GENERATOR
    from lighthouse_tpu.crypto.bls12_381.fields import R
    rng = np.random.default_rng(seed)
    scal = [int(v) for v in rng.integers(1, 2**62, size=n)]
    scal[9], scal[13] = scal[8], R - scal[12]
    pts = [G1_GENERATOR.mul(v).to_affine() for v in scal]
    lam = torch.from_numpy(k.fp_encode(
        [int.from_bytes(rng.bytes(48), "little") % k.P_INT
         for _ in range(n)]))
    x = torch.from_numpy(k.fp_encode([int(p[0]) for p in pts]))
    y = torch.from_numpy(k.fp_encode([int(p[1]) for p in pts]))
    l2 = k.fp_mul(lam, lam)
    x, y, z = k.fp_mul(x, l2), k.fp_mul(y, k.fp_mul(l2, lam)), lam
    for i in (5, 41)[:1 + (n > 41)]:
        z[i] = 0
        scal[i] = 0
    return (x, y, z), scal


def _assert_range_sums(sums, scal, starts, ends):
    """Each range's sum (Jacobian) is the reference curve's multiple of G
    by the sum of its lanes' scalars."""
    from lighthouse_tpu.crypto.bls12_381 import G1_GENERATOR
    from lighthouse_tpu.crypto.bls12_381.fields import R
    first, length = k.segment_ranges(starts, ends)
    ax, ay = k.jacobian_to_affine_fp(*sums)
    for g in range(len(ends)):
        s = sum(scal[first[g]:first[g] + length[g]]) % R
        if s == 0:
            assert k.fp_decode(sums[2][g]) == [0]
            continue
        w = G1_GENERATOR.mul(s).to_affine()
        assert k.fp_decode(ax[g]) + k.fp_decode(ay[g]) == [int(w[0]),
                                                           int(w[1])]


@pytest.mark.parametrize("program,resident", [("source", 3), ("small", 3),
                                              ("small", 1)])
@pytest.mark.parametrize("layout", ["ranges of 40", "one range",
                                    "one-lane ranges", "ends mid-segment",
                                    "short pieces", "padding at 0"])
def test_g1_segment_sum_source_on_host(seg_programs, monkeypatch, program,
                                       resident, layout):
    """The segment sum's cooperative launch (the ranges' phases, the
    tiles, the long ranges) at 300 lanes on a grid of at most
    ``resident`` blocks, limb for limb (canonically) against the plain
    version in the same order, and the plain version as points against
    the reference's sums of each range's scalars."""
    n = 300
    exe, pieces = seg_programs[program]
    (x, y, z), scal = _seg_points(n, 7)
    starts, ends = _seg_layout(layout, n)
    monkeypatch.setattr(k, "G1_SEGMENT_T", pieces)
    want = k._g1_segment_sum_plain(x, y, z, starts, ends)
    got = host_cuda.g1_segment_sum(exe, x.numpy(), y.numpy(), z.numpy(),
                                   starts, ends, resident)
    for g, w in zip(got, want):
        assert torch.equal(_canon(g), bi.canonical(w))
    _assert_range_sums(want, scal, starts, ends)


def test_g1_segment_sum_plain_in_pieces_matches_the_reference(monkeypatch):
    """The plain version's order with pieces of 2 or 4 lanes (ranges of
    several pieces, one folded past T^2 = 16 lanes, an end mid-segment, a
    lane at infinity) on 24 lanes: each range's sum the reference curve's
    (lighthouse_tpu.crypto) multiple of G."""
    n = 24
    (x, y, z), scal = _seg_points(n, 11)
    starts = np.zeros(n, np.int32)
    starts[[0, 2, 20, 21]] = 1
    ends = np.array([1, 19, 20, 23, 10, 0, 0], np.int32)
    monkeypatch.setattr(k, "G1_SEGMENT_T", (2, 4))
    assert k.g1_segment_t(n, len(ends)) == 4
    sums = k._g1_segment_sum_plain(x, y, z, starts, ends)
    _assert_range_sums(sums, scal, starts, ends)


def test_segment_piece_lanes_match_the_source():
    """ops/bls12_381.py G1_SEGMENT_T and g1_segment_t are aggregate.cu's
    LH_SEG_T_SHORT / LH_SEG_T_LONG and seg_piece_lanes' rule."""
    import re

    from lighthouse_tpu_torch.kernels import CSRC
    text = (CSRC / "bls" / "aggregate.cu").read_text()
    got = tuple(int(re.search(rf"#define LH_SEG_T_{w} (\d+)", text).group(1))
                for w in ("SHORT", "LONG"))
    assert got == k.G1_SEGMENT_T
    assert "return n <= (long long)LH_SEG_T_SHORT * g ? LH_SEG_T_SHORT" \
        in text
    short, long_ = got
    assert k.g1_segment_t(10240, 128) == long_        # the batch
    assert k.g1_segment_t(2560, 128) == short         # a rank at n = 4
    assert k.g1_segment_t(10240, 10000) == short      # one-lane ranges
    assert k.g1_segment_t(short * 7, 7) == short
    assert k.g1_segment_t(short * 7 + 1, 7) == long_


def test_g1_segment_sum_depth_and_count():
    """bls_cost's count (L - 1 additions a range) and critical path (the
    deepest range's tree levels, a long range's pieces, fold and partials
    tree) on the layouts the smoke drives."""
    from lighthouse_tpu_torch.ops import bls_cost as cost
    n = 10240
    starts = np.zeros(n, np.int32)
    starts[:10000:79] = 1                  # ~127 segments of 79 lanes
    starts[10000] = 1                       # the padding lanes
    seg_ends = np.append(np.flatnonzero(starts)[1:128] - 1, 0)
    assert cost.g1_segment_sum_depth(starts, seg_ends) == 7
    # a rank's 2,560 lanes: ranges of ~20 lanes in pieces of 32
    rank = np.zeros(2560, np.int32)
    rank[:2500:20] = 1
    rank[2500] = 1
    rank_ends = np.append(np.flatnonzero(rank)[1:126] - 1, [2499, 0, 0])
    assert cost.g1_segment_sum_depth(rank, rank_ends) == 5
    one = np.zeros(n, np.int32)
    one[[0, 10000]] = 1
    ends = np.array([9999] + [0] * 127)
    # 79 pieces of 128: 7 levels in a piece, 7 over the partials
    assert cost.g1_segment_sum_depth(one, ends) == 14
    assert cost.g1_segment_sum(one, ends) == 9999 * cost.ADD[1]
    lanes = np.ones(n, np.int32)
    assert cost.g1_segment_sum_depth(lanes, np.arange(10000)) == 0
    assert cost.g1_segment_sum(lanes, np.arange(10000)) == 0
    # past T^2 lanes: a fold of ceil(pieces / T) - 1 in series
    big = np.zeros(20000, np.int32)
    big[0] = 1
    assert cost.g1_segment_sum_depth(big, [19999]) == 7 + 1 + 7


@pytest.fixture(scope="module")
def cap_program(tmp_path_factory):
    if host_cuda.compiler() is None:
        pytest.skip("needs g++ to build the kernels' sources on the host")
    return host_cuda.build("cap_fold", tmp_path_factory.mktemp("host_cap"))


@pytest.mark.parametrize("dense,limit", [(20, 20), (20, 21), (20, 40),
                                         (0, 44), (19, 64)])
def test_cap_fold_source_on_host(cap_program, dense, limit):
    """The standalone cap fold (its caps from csrc/zero_hashes.cuh) at k =
    0, 1, 20, 44 and 45 caps against the plain fold of the table's rows
    and the JAX package's _fold_zero_caps."""
    import jax.numpy as jnp

    from lighthouse_tpu.ops.sha256 import _fold_zero_caps
    from lighthouse_tpu_torch.ops import sha256 as sh
    rng = np.random.default_rng(dense * 100 + limit)
    root = rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
    got = host_cuda.cap_fold(cap_program, root.view(np.int32), dense, limit)
    want = sh.cap_root(torch.from_numpy(root.view(np.int32)), dense, limit)
    assert np.array_equal(got, want.numpy())
    jax_root = np.asarray(_fold_zero_caps(
        jnp.asarray(root), jnp.asarray(sh.ZERO_HASH_WORDS[dense:limit])))
    assert np.array_equal(got.view(np.uint32), jax_root)


def _affine_inputs(n, g2, seed):
    """n Jacobian points (16 distinct k_i G tiled, every lane rescaled by
    its own random l), lanes 1, 5, 9, ... given as their representatives
    in [p, 2p) (x and z + p), lanes 0 and n // 2 at infinity (z = 0, and
    z = p: zero in [p, 2p)); with the oracle's affine coordinates of each
    lane (None at infinity)."""
    from lighthouse_tpu_torch.crypto.bls12_381 import (
        G1_GENERATOR, G2_GENERATOR,
    )
    rng = np.random.default_rng(seed)
    gen = G2_GENERATOR if g2 else G1_GENERATOR
    base = [gen.mul(int(rng.integers(1, 2**62))).to_affine()
            for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    enc = k.fp2_encode if g2 else k.fp_encode
    one = k.FP2_ONE if g2 else k.FP_ONE
    x, y = (np.ascontiguousarray(enc([p[c] for p in pts])) for c in (0, 1))
    z = np.array(np.broadcast_to(one, x.shape))
    x, y, z = _rescale(x, y, z, list(range(n)), g2, seed + 1)
    want = list(pts)
    for lane in range(1, n, 4):
        for a in (x, z):
            a[lane] = bi.ints_to_limbs(
                [v % k.P_INT + k.P_INT for v in bi.limbs_to_ints(a[lane])]
            ).reshape(a[lane].shape)
    z[0] = 0
    z[n // 2] = bi.ints_to_limbs([k.P_INT] * (2 if g2 else 1)).reshape(
        z[0].shape)                         # zero as its representative p
    want[0] = want[n // 2] = None
    return x, y, z, want


@pytest.mark.parametrize("g2,n", [(False, 128), (True, 129)])
def test_affine_source_on_host(programs, g2, n):
    """The affine conversion on the binary inverse (csrc/bls/aggregate.cu,
    fp.cuh fp_inv_binary) at the main path's lanes (128 group sums over
    Fp, 129 Q points over Fp2): canonically equal to the plain version
    (the Fermat inverse) and to the pure-Python oracle's affine points,
    infinity (z = 0) as (0, 0), inputs in [p, 2p) taken."""
    x, y, z, want = _affine_inputs(n, g2, 40 + n)
    got = host_cuda.affine(programs["affine"], 2 if g2 else 1, x, y, z)
    plain = (k._jacobian_to_affine_fp2_plain if g2
             else k._jacobian_to_affine_fp_plain)
    for g, w in zip(got, plain(*(torch.from_numpy(a) for a in (x, y, z)))):
        assert torch.equal(_canon(g), bi.canonical(w))
    gx, gy = (k.fp_decode(a) for a in got)
    d = 2 if g2 else 1
    for i, pt in enumerate(want):
        coords = gx[d * i:d * i + d] + gy[d * i:d * i + d]
        if pt is None:
            assert coords == [0] * (2 * d)
        elif g2:
            assert coords == [int(pt[0].c0), int(pt[0].c1), int(pt[1].c0),
                              int(pt[1].c1)]
        else:
            assert coords == [int(pt[0]), int(pt[1])]


def test_lane_programs_are_rendered():
    """csrc/bls/lane_prog.cuh is the generator's rendering of the lane
    programs (ops/bls_lane.py)."""
    from lighthouse_tpu_torch.kernels import CSRC
    from lighthouse_tpu_torch.ops import bls_lane
    assert (CSRC / "bls" / "lane_prog.cuh").read_text() == bls_lane.render()


def _f2(a, b, op):
    return tuple(op(x, y) % k.P_INT for x, y in zip(a, b))


def _jac_formulas(degree):
    """curve.cuh jac_dbl and jac_add (without its branches, with H and
    S2 - S1) over Python integers."""
    P = k.P_INT

    def m(a, b):
        if degree == 1:
            return (a[0] * b[0] % P,)
        return ((a[0] * b[0] - a[1] * b[1]) % P,
                (a[0] * b[1] + a[1] * b[0]) % P)

    def add(a, b):
        return _f2(a, b, lambda u, v: u + v)

    def sub(a, b):
        return _f2(a, b, lambda u, v: u - v)

    def mn(a, c):
        return tuple(u * c % P for u in a)

    def dbl(x, y, z):
        A, B, yz = m(x, x), m(y, y), m(y, z)
        E, xB = mn(A, 3), add(x, B)
        C, t, F = m(B, B), m(xB, xB), m(E, E)
        D = mn(sub(sub(t, A), C), 2)
        X3 = sub(F, mn(D, 2))
        return X3, sub(m(E, sub(D, X3)), mn(C, 8)), mn(yz, 2)

    def jadd(x1, y1, z1, x2, y2, z2):
        Z1Z1, Z2Z2, zz = m(z1, z1), m(z2, z2), m(add(z1, z2), add(z1, z2))
        U1, U2 = m(x1, Z2Z2), m(x2, Z1Z1)
        S1, S2 = m(y1, m(z2, Z2Z2)), m(y2, m(z1, Z1Z1))
        H = sub(U2, U1)
        I = m(mn(H, 2), mn(H, 2))
        dS = sub(S2, S1)
        rr = mn(dS, 2)
        J, V = m(H, I), m(U1, I)
        X3 = sub(sub(m(rr, rr), J), mn(V, 2))
        Y3 = sub(m(rr, sub(V, X3)), mn(m(S1, J), 2))
        return X3, Y3, m(sub(sub(zz, Z1Z1), Z2Z2), H), H, dS

    return dbl, jadd


@pytest.mark.parametrize("layout,degree", [("RLC1", 1), ("RLC2", 2),
                                           ("SUB", 2)])
def test_lane_programs_compute_the_formulas(layout, degree):
    """The doubling, the mixed and the general addition of each layout's
    tables, run step by step with Python integers (``bls_lane.run_step``,
    the semantics of ``lg_step``), give curve.cuh's values on random slot
    contents, H and S2 - S1 included."""
    from lighthouse_tpu_torch.ops import bls_lane
    table = bls_lane.tables()
    d = dict(table[3])
    dbl, jadd = _jac_formulas(degree)
    rng = np.random.default_rng(degree)
    P = k.P_INT

    def slot(name):
        return d[f"LG_{layout}_{name}"]

    for _ in range(2):
        V = [int.from_bytes(rng.bytes(48), "little") % P
             for _ in range(slot("NV"))]

        def get(name, V=V):
            return tuple(V[slot(name) + i] for i in range(degree))

        want = dbl(get("X"), get("Y"), get("Z"))
        for s in range(slot("P_DBL_N")):
            bls_lane.run_step(V, slot("P_DBL") + s, P, table=table)
        assert (get("X"), get("Y"), get("Z")) == want
        for prog in ("ADD", "MADD"):
            W = list(V)
            if prog == "MADD":
                W[slot("QZ"):slot("QZ") + degree] = [1] + [0] * (degree - 1)
            want = jadd(*(get(c, W) for c in ("X", "Y", "Z", "QX", "QY",
                                              "QZ")))
            for s in range(slot(f"P_{prog}_N")):
                bls_lane.run_step(W, slot(f"P_{prog}") + s, P, table=table)
            got = tuple(get(c, W) for c in ("RX", "RY", "RZ")) + tuple(
                tuple(W[slot(f"{prog}_{e}") + i] for i in range(degree))
                for e in ("H", "DY"))
            assert got == want


def test_lane_program_hazards_are_refused():
    """The generator refuses a linear output read in the stage that
    writes it, and a fixed slot overwritten while a stage still reads
    it."""
    from lighthouse_tpu_torch.ops import bls_lane as L
    lay = L.Layout("T", 1, [("A", 1), ("B", 1)])
    s = lay.program("P").step()
    v = s.lin(L.add(s.prog.elem("A"), s.prog.elem("B")))
    with pytest.raises(AssertionError):
        s.lin(v)
    s = lay.program("Q").step()
    s.lin(s.prog.elem("A"), stage=1)
    with pytest.raises(AssertionError):
        s.out("A", s.prog.elem("B"), stage=1)


def test_lane_group_counts():
    """bls_cost's lane-group counts on three scalars (zero, the top bit,
    all ones; 64 bits): from the top set bit, 16 products a G2 doubling
    (three squares and a product, then three squares, then a product), 30 a
    mixed addition, 44 a general one; the rounds a step of n products
    takes on G threads, ceil(n / G); a warp's rounds its longest group's.
    Decompression issues the one-thread count (its powers' squares and
    products are the same); the subgroup check fewer (squares, mixed
    additions, from |x|'s top bit)."""
    from lighthouse_tpu_torch.ops import bls_cost as cost
    assert cost.lane_steps("RLC2", "DBL") == (7, 6, 3)
    assert sum(cost.lane_steps("RLC2", "MADD")) == 30
    assert sum(cost.lane_steps("RLC2", "ADD")) == 44
    assert sum(cost.lane_steps("RLC1", "DBL")) == 7
    assert sum(cost.lane_steps("RLC1", "MADD")) == 11
    bits = k.scalars_to_bits([0, 2**63, 2**64 - 1], 64)
    got = cost.scalar_mul_lanes(bits, 2, z_one=[True, True, False],
                                width=4)
    assert got["products"] == 63 * 16 + 63 * 16 + 63 * 44
    # one warp of 8 lanes, in step from bit 0: every lane doubles 63
    # times and adds 63 times (the all-ones lane's bits)
    assert got["issued"] == 3 * 63 * 16 + 2 * 63 * 30 + 63 * 44
    assert got["rounds"] == 63 * (2 + 2 + 1) + 63 * sum(
        -(-n // 4) for n in cost.lane_steps("RLC2", "ADD"))
    assert got["warp_rounds"] == got["rounds"]
    n = 5
    assert cost.g2_decompress_lanes(n)["products"] == cost.g2_decompress(n)
    sub = cost.g2_subgroup_lanes([True] * n, [False] * n, [True] * n)
    old = cost.g2_subgroup([False] * n, [True] * n)
    assert sub["products"] == n * (6 + 63 * 16 + 5 * 30 + 22) < old
