"""The port's CUDA kernels against their plain versions, on the card, at
the edges of what the kernels take (odd sizes, every ``pre_levels``, rows
with duplicates, empty cap folds), and the DeviceTree on the card against
the DeviceTree on the CPU. Bit-exact: tolerance zero (field values
canonically; the G2 sum, whose tree adds in another order than the plain
version, as a point).

Needs an NVIDIA card; each test skips without one (the ``cuda_device``
fixture decides at run time). On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import kernels
from lighthouse_tpu_torch.ops import merkle_tree as mt
from lighthouse_tpu_torch.ops import sha256 as sh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    kernels.build_all()
    return torch.device("cuda")


def _words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("n", [1, 255, 257, 4097])
def test_hash64_odd_sizes(cuda_device, n):
    rng = np.random.default_rng(n)
    blocks = sh.words_to_tensor(_words(rng, n, 16), "cpu")
    before = kernels.HASH64.launches
    got = sh.hash64(blocks.to(cuda_device))
    assert kernels.HASH64.launches == before + 1
    assert torch.equal(got.cpu(), sh.hash64(blocks))


def test_launch_guard_checks_the_current_device(cuda_device):
    """A launch goes to the CUDA runtime's current device: a tensor there
    launches (hash64, equal to the plain version), and a stream asked
    for another card raises instead of mixing two cards' contexts."""
    current = torch.device("cuda", torch.cuda.current_device())
    blocks = sh.words_to_tensor(_words(np.random.default_rng(9), 33, 16),
                                "cpu")
    got = sh.hash64(blocks.to(current))
    assert got.device == current
    assert torch.equal(got.cpu(), sh.hash64(blocks))
    assert kernels.stream_ptr(current) == \
        torch.cuda.current_stream(current).cuda_stream
    other = torch.device("cuda", current.index + 1)
    with pytest.raises(ValueError, match="current device"):
        kernels.stream_ptr(other)


@pytest.mark.parametrize("pre_levels", [0, 3])
@pytest.mark.parametrize("with_pk", [False, True])
def test_fold_pre_build_and_scatter(cuda_device, pre_levels, with_pk):
    rng = np.random.default_rng(pre_levels + 10 * with_pk)
    n_live, width, unit = 37, 64, 1 << pre_levels
    chunks = sh.words_to_tensor(_words(rng, n_live * unit, 8), "cpu")
    pk = (sh.words_to_tensor(_words(rng, n_live, 16), "cpu")
          if with_pk else None)
    out_c = torch.full((width, 8), 7, dtype=torch.int32)
    out_g = out_c.to(cuda_device)
    mt.fold_pre(chunks, pk, pre_levels, n_live, out_c)
    mt.fold_pre(chunks.to(cuda_device),
                None if pk is None else pk.to(cuda_device),
                pre_levels, n_live, out_g)
    assert torch.equal(out_g.cpu(), out_c)
    rows = torch.tensor([5, 0, 5, 36], dtype=torch.int32)
    new = _words(rng, 4 * unit, 8)
    new[2 * unit:3 * unit] = new[0:unit]          # duplicate row 5
    new_c = sh.words_to_tensor(new, "cpu")
    new_pk = None
    if with_pk:
        pkw = _words(rng, 4, 16)
        pkw[2] = pkw[0]
        new_pk = sh.words_to_tensor(pkw, "cpu")
    mt.fold_pre(new_c, new_pk, pre_levels, n_live, out_c, rows=rows)
    mt.fold_pre(new_c.to(cuda_device),
                None if new_pk is None else new_pk.to(cuda_device),
                pre_levels, n_live, out_g, rows=rows.to(cuda_device))
    assert torch.equal(out_g.cpu(), out_c)


@pytest.mark.parametrize("depth,r", [(6, 6), (20, 1024), (20, 65536)])
def test_path_update_with_duplicate_rows(cuda_device, depth, r):
    """The one-launch walk on rows drawn with repeats (as DeviceTree.update
    sends them: np.unique of the rows) against the plain walk on the same
    levels, every level equal: at R = 1,024 on depth 20 (a rep) the grid
    hands the upper levels to block 0; at R = 65,536 the grid is ~500
    blocks for the lower levels."""
    rng = np.random.default_rng(depth + r)
    lv = [sh.words_to_tensor(_words(rng, 1 << depth, 8), cuda_device)]
    for _ in range(depth):
        lv.append(sh.hash64(lv[-1].reshape(-1, 16)))
    drawn = rng.integers(0, 1 << depth, size=r)
    drawn[1::7] = drawn[0::7][:len(drawn[1::7])]     # repeats
    rows = np.unique(drawn)
    lv[0][torch.from_numpy(rows).to(cuda_device)] = sh.words_to_tensor(
        _words(rng, len(rows), 8), cuda_device)
    plain = [x.clone() for x in lv]
    rows_t = torch.from_numpy(rows.astype(np.int32)).to(cuda_device)
    before = kernels.PATH_UPDATE.launches
    root = mt._path_walk(lv, rows_t, depth)
    assert kernels.PATH_UPDATE.launches == before + 1
    mt._path_walk_plain(plain, rows_t)
    for a, b in zip(lv, plain):
        assert torch.equal(a, b)
    assert torch.equal(root, plain[-1][0])


@pytest.mark.parametrize("k", [0, 1, 40])
def test_cap_root_depths(cuda_device, k):
    rng = np.random.default_rng(k)
    root = sh.words_to_tensor(_words(rng, 8), "cpu")
    want = sh.cap_root(root, 10, 10 + k)
    assert torch.equal(sh.cap_root(root.to(cuda_device), 10, 10 + k).cpu(),
                       want)


@pytest.mark.parametrize("dense,limit", [(20, 20), (20, 21), (20, 40),
                                         (0, 44), (0, 64)])
def test_cap_fold_kernel_depths(cuda_device, dense, limit):
    """One cap_fold launch (the caps from its constant table) against the
    plain fold, at 1, 20, 44 and 64 caps; at none cap_root copies the
    root without a launch."""
    rng = np.random.default_rng(dense + limit)
    root = sh.words_to_tensor(_words(rng, 8), "cpu")
    before = kernels.CAP_FOLD.launches
    got = sh.cap_root(root.to(cuda_device), dense, limit)
    assert kernels.CAP_FOLD.launches == before + (dense < limit)
    assert torch.equal(got.cpu(), sh.cap_root(root, dense, limit))


@pytest.mark.parametrize("depth,r,limit", [(6, 1, 6), (10, 600, 40),
                                           (20, 1024, 40)])
def test_path_walk_folds_the_caps(cuda_device, depth, r, limit):
    """The walk with the root's caps in the same launch: the levels as the
    plain walk's, the root as the plain cap fold of its top node, and no
    cap_fold launch."""
    rng = np.random.default_rng(depth + r)
    lv = [sh.words_to_tensor(_words(rng, 1 << depth, 8), cuda_device)]
    for _ in range(depth):
        lv.append(sh.hash64(lv[-1].reshape(-1, 16)))
    rows = np.unique(rng.integers(0, 1 << depth, size=r))
    lv[0][torch.from_numpy(rows).to(cuda_device)] = sh.words_to_tensor(
        _words(rng, len(rows), 8), cuda_device)
    plain = [x.cpu() for x in lv]
    rows_t = torch.from_numpy(rows.astype(np.int32))
    caps = kernels.CAP_FOLD.launches
    root = mt._path_walk(lv, rows_t.to(cuda_device), limit)
    assert kernels.CAP_FOLD.launches == caps
    want = mt._path_walk(plain, rows_t, limit)
    for a, b in zip(lv, plain):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(root.cpu(), want)


@pytest.mark.parametrize("n,limit,pre_levels,with_pk",
                         [(1, 16, 0, False), (100, 2**16, 0, False),
                          (300, 2**40, 3, True)])
def test_device_tree_card_equals_cpu(cuda_device, n, limit, pre_levels,
                                     with_pk):
    rng = np.random.default_rng(n)
    unit = 1 << pre_levels
    words = _words(rng, n * unit, 8)
    pk = _words(rng, n, 16) if with_pk else None
    cpu = mt.DeviceTree(n, limit, pre_levels, with_pk, device="cpu")
    gpu = mt.DeviceTree(n, limit, pre_levels, with_pk, device=cuda_device)
    cpu.build(words, pk)
    gpu.build(words, pk)
    assert gpu.root() == cpu.root()
    other = gpu.share()
    rows = np.unique([0, n - 1, n // 2])
    new = _words(rng, len(rows) * unit, 8)
    new_pk = _words(rng, len(rows), 16) if with_pk else None
    root0 = gpu.root()
    cpu.update(rows, new, new_pk)
    gpu.update(rows, new, new_pk)
    assert gpu.root() == cpu.root()
    assert other.root() == root0


@pytest.mark.parametrize("n,rows", [
    (64, [0, 1, 1, 63, 62, 17]),          # block 0 from the first level
    (5000, None),                         # 1,500 rows: grid levels first
])
def test_device_tree_update_unsorted_repeated_rows(cuda_device, n, rows):
    """DeviceTree.update with rows out of order and repeated (each repeat
    carrying the same words): the card's tree (fold_pre, then the walk on
    the distinct rows sorted) equals the CPU tree at every level."""
    rng = np.random.default_rng(n)
    words = _words(rng, n, 8)
    cpu = mt.DeviceTree(n, 2**20, device="cpu")
    gpu = mt.DeviceTree(n, 2**20, device=cuda_device)
    cpu.build(words)
    gpu.build(words)
    if rows is None:
        rows = rng.integers(0, n, size=1500)
        rows[::5] = rows[1::5][:len(rows[::5])]
    rows = np.asarray(rows)
    distinct, first = np.unique(rows, return_inverse=True)
    new = _words(rng, len(distinct), 8)[first]
    cpu.update(rows, new)
    gpu.update(rows, new)
    for a, b in zip(gpu.levels, cpu.levels):
        assert torch.equal(a.cpu(), b)
    assert gpu.root() == cpu.root()


def test_merkleize_words_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(9)
    leaves = _words(rng, 1000, 8)
    assert sh.root_bytes(sh.merkleize_words(leaves, 2**38, cuda_device)) \
        == sh.root_bytes(sh.merkleize_words(leaves, 2**38, "cpu"))


# --- BLS12-381 (csrc/bls/): each kernel against its plain version on the
# card, at odd lane counts and with infinity inputs. Field values compare
# canonically (the kernel's CIOS multiply and the plain 12-bit-limb
# multiply return different representatives in [0, 2p)); tolerance zero.

def _bls():
    from lighthouse_tpu_torch.ops import bigint as bi
    from lighthouse_tpu_torch.ops import bls12_381 as k
    return bi, k


def _canon_equal(got, want):
    bi, _ = _bls()
    if isinstance(got, (tuple, list)):
        return all(_canon_equal(g, w) for g, w in zip(got, want))
    if got.dtype == torch.bool:
        return torch.equal(got.cpu(), want.cpu())
    return torch.equal(bi.canonical(got.cpu()), bi.canonical(want.cpu()))


def _points(n, seed, g2):
    """n Jacobian points k_i * G (k_i from ``seed``), lane 0 at infinity."""
    from lighthouse_tpu_torch.crypto.bls12_381 import (
        G1_GENERATOR, G2_GENERATOR,
    )
    _, k = _bls()
    rng = np.random.default_rng(seed)
    gen = G2_GENERATOR if g2 else G1_GENERATOR
    pts = [gen.mul(int(rng.integers(1, 2**62))) for _ in range(n)]
    xs, ys = zip(*(p.to_affine() for p in pts))
    if g2:
        x, y = k.fp2_encode(xs), k.fp2_encode(ys)
        z = np.array(np.broadcast_to(k.FP2_ONE, (n, 2, 32)))
    else:
        x, y = k.fp_encode(xs), k.fp_encode(ys)
        z = np.array(np.broadcast_to(k.FP_ONE, (n, 32)))
    z[0] = 0
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, y, z))


@pytest.mark.parametrize("n", [1, 3, 130])
def test_fp_ops_kernel(cuda_device, n):
    bi, _ = _bls()
    rng = np.random.default_rng(n)
    vals = [int.from_bytes(rng.bytes(48), "little") % (2 * bi.P_INT)
            for _ in range(n)]
    vals[0] = 2 * bi.P_INT - 1
    a = torch.from_numpy(bi.ints_to_limbs(vals))
    b = torch.from_numpy(bi.ints_to_limbs(vals[::-1]))
    for op in (bi.FP_MUL, bi.FP_ADD, bi.FP_SUB):
        got = bi.fp_ops_kernel(op, a.to(cuda_device), b.to(cuda_device))
        assert _canon_equal(got, bi._PLAIN[op](a, b))
    # borrow-heavy: a - a is zero
    got = bi.fp_ops_kernel(bi.FP_SUB, a.to(cuda_device), a.to(cuda_device))
    assert bool(bi.is_zero_mod(got.cpu()).all())


@pytest.mark.parametrize("n", [1, 3, 130])
@pytest.mark.parametrize("g2", [False, True])
def test_scalar_mul_and_affine_kernels(cuda_device, n, g2):
    _, k = _bls()
    x, y, z = _points(n, n, g2)
    rng = np.random.default_rng(n + 1)
    scalars = [int(s) for s in rng.integers(0, 2**63, size=n)]
    scalars[-1] = 0
    bits = k.scalars_to_bits(scalars, 64)
    mul = k.g2_scalar_mul if g2 else k.g1_scalar_mul
    aff = k.jacobian_to_affine_fp2 if g2 else k.jacobian_to_affine_fp
    want = mul(x, y, z, bits)
    got = mul(*(t.to(cuda_device) for t in (x, y, z)), bits)
    assert _canon_equal(got, want)
    assert _canon_equal(aff(*got), aff(*want))
    # affine lanes (z one: the main path's mixed addition) beside lanes of
    # another z (x l^2, y l^3, l: the general one) in one call, and a
    # scalar of all ones
    x, y, z = _rescaled(x, y, z, range(1, n, 2), g2, n + 7)
    scalars[n // 2] = 2**64 - 1
    bits = k.scalars_to_bits(scalars, 64)
    want = mul(x, y, z, bits)
    got = mul(*(t.to(cuda_device) for t in (x, y, z)), bits)
    assert _canon_equal(got, want)


@pytest.mark.parametrize("g2,n", [(False, 128), (True, 129)])
def test_affine_kernel_at_the_main_path_lanes(cuda_device, g2, n):
    """The affine conversion on the binary inverse at the batch's lanes
    (128 group sums over Fp, the 129 Q points over Fp2 in one launch):
    every lane its own Z, lane 0 at infinity (z = 0), lane n // 2 with z
    = p (zero in [p, 2p)), lanes 3, 7, ... with x and z given in [p, 2p);
    canonically equal to the plain version (the Fermat inverse)."""
    bi, k = _bls()
    x, y, z = _points(n, 300 + n, g2)
    x, y, z = _rescaled(x, y, z, range(1, n), g2, n)
    for lane in range(3, n, 4):
        for a in (x, z):
            a[lane] = torch.from_numpy(bi.ints_to_limbs(
                [v % bi.P_INT + bi.P_INT
                 for v in bi.limbs_to_ints(a[lane])])).reshape(a[lane].shape)
    z[n // 2] = torch.from_numpy(bi.ints_to_limbs(
        [bi.P_INT] * (2 if g2 else 1))).reshape(z[0].shape)
    aff = k.jacobian_to_affine_fp2 if g2 else k.jacobian_to_affine_fp
    before = kernels.AFFINE.launches
    got = aff(*(t.to(cuda_device) for t in (x, y, z)))
    assert kernels.AFFINE.launches == before + 1
    want = aff(x, y, z)
    assert _canon_equal(got, want)
    for lane in (0, n // 2):
        assert not bi.canonical(got[0][lane].cpu()).any()
        assert not bi.canonical(got[1][lane].cpu()).any()


def _rescaled(x, y, z, lanes, g2, seed):
    """The points with the given lanes' z made a random l: (x l^2, y l^3,
    z l), the same points in other coordinates."""
    bi, k = _bls()
    lanes = list(lanes)
    if not lanes:
        return x, y, z
    rng = np.random.default_rng(seed)
    d = 2 if g2 else 1
    lam = torch.from_numpy(k.fp_encode(
        [int.from_bytes(rng.bytes(48), "little") % bi.P_INT
         for _ in range(d * len(lanes))]).reshape(
             (len(lanes),) + ((2, 32) if g2 else (32,))))
    mul = k.fp2_mul if g2 else bi.mont_mul
    x, y, z = x.clone(), y.clone(), z.clone()
    l2 = mul(lam, lam)
    x[lanes] = mul(x[lanes], l2)
    y[lanes] = mul(y[lanes], mul(l2, lam))
    z[lanes] = mul(z[lanes], lam)
    return x, y, z


@pytest.mark.parametrize("n", [1, 3, 130])
def test_aggregate_kernels(cuda_device, n):
    """The segment sums canonically; the G2 sum (a tree on the card, the
    JAX order in the plain version) as a point, and the same limbs on a
    second call (its order is fixed)."""
    from lighthouse_tpu_torch.measure import g2_projective_err
    _, k = _bls()
    x, y, z = _points(n, 100 + n, False)
    starts = np.zeros(n, np.int32)
    starts[::2] = 1                      # segments of two lanes
    ends = np.array(sorted({min(i + 1, n - 1) for i in range(0, n, 2)})
                    + [0], np.int32)     # the last one a padding group
    want = k.g1_segment_sum(x, y, z, starts, ends)
    got = k.g1_segment_sum(*(t.to(cuda_device) for t in (x, y, z)),
                           starts, ends)
    assert _canon_equal(got, want)
    x2, y2, z2 = _points(n, 200 + n, True)
    want = k.g2_sum(x2, y2, z2)
    dev2 = [t.to(cuda_device) for t in (x2, y2, z2)]
    got = k.g2_sum(*dev2)
    assert g2_projective_err(got, want) == 0
    assert all(torch.equal(a, b) for a, b in zip(got, k.g2_sum(*dev2)))


@pytest.mark.parametrize("layout", ["batch", "one segment", "one-lane"])
def test_g1_segment_sum_layouts(cuda_device, layout):
    """The segment sum at 10,240 lanes on the smoke's three layouts (the
    10k batch's 127 segments of ~79 and a padding group at lane 0, one
    10,000-lane segment, 10,000 one-lane segments), ends as host arrays
    and as tensors on the card: canonically equal to the plain version
    (the same order), one launch a call, the same limbs twice."""
    _, k = _bls()
    n = 10240
    x, y, z = _points(64, 64, False)
    x, y, z = (t[torch.arange(n) % 64].contiguous() for t in (x, y, z))
    starts = np.zeros(n, np.int32)
    starts[10000] = 1
    if layout == "batch":
        starts[:10000:79] = 1
        ends = np.append(np.flatnonzero(starts)[1:128] - 1, 0)
    elif layout == "one segment":
        starts[0] = 1
        ends = np.array([9999] + [0] * 127)
    else:
        starts[:10000] = 1
        ends = np.arange(10000)
    ends = ends.astype(np.int32)
    want = k._g1_segment_sum_plain(x, y, z, starts, ends)
    dev = [t.to(cuda_device) for t in (x, y, z)]
    before = kernels.G1_SEGMENT_SUM.launches
    got = k.g1_segment_sum(*dev, starts, ends)
    assert kernels.G1_SEGMENT_SUM.launches == before + 1
    assert _canon_equal(got, want)
    again = k.g1_segment_sum(*dev, torch.from_numpy(starts).to(cuda_device),
                             torch.from_numpy(ends).to(cuda_device))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError, match="out of range"):
        k.g1_segment_sum(*dev, starts, np.array([n], np.int32))


class _mode:
    """The multiply lowering ``mode`` in force inside the block."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        bi, _ = _bls()
        kernels.build_all(kernels.variants(self.mode))
        self.prev = bi.mxu_mode()
        bi.set_mxu_mode(self.mode)

    def __exit__(self, *exc):
        bi, _ = _bls()
        bi.set_mxu_mode(self.prev)


#: plain outputs by lane count: every lowering gives the same canonical
#: values, so each is computed once, in mode 0 (the Miller loop's plain
#: version on the card, the product and final exponentiation on the host)
_PAIRING_PLAIN: dict = {}


def _pairing_inputs(n):
    """n pairs (lane 0 repeats the last, whose mask is 0), the plain
    Miller outputs, their product, its final exponentiation and that of
    lane 0, and whether the masked product is one."""
    _, k = _bls()
    if n not in _PAIRING_PLAIN:
        px, py, _ = _points(n, 300 + n, False)
        qx, qy, _ = _points(n, 400 + n, True)
        px[0], py[0] = px[-1], py[-1]        # lane 0 was at infinity
        qx[0], qy[0] = qx[-1], qy[-1]
        mask = np.ones(n, bool)
        mask[-1] = False
        with _mode(0):
            dev = [t.to("cuda") for t in (px, py, qx, qy)]
            fs = k._mask_to_one(k._miller_loop_plain(*dev), mask).cpu()
        prod = k._fp12_product_plain(fs)
        fe = k._final_exponentiation_plain(prod)
        is_one = bool(k.fp12_eq(fe, k.fp12_one_like((), fe)))
        _PAIRING_PLAIN[n] = ((px, py, qx, qy), mask, fs, prod, fe,
                             k._final_exponentiation_plain(fs[0]), is_one)
    return _PAIRING_PLAIN[n]


def _check_pairing(cuda_device, n):
    """The Miller loop, the product (a tree over up to 64 slots, then
    folded rounds past them), the final exponentiation of one value and
    of the product, and the pairing check, each kernel against the
    plain outputs, in the multiply lowering in force."""
    _, k = _bls()
    host, mask, fs, prod, fe, fe0, is_one = _pairing_inputs(n)
    dev = [t.to(cuda_device) for t in host]
    got = k.miller_loop_batch(*dev, mask)
    assert _canon_equal(got, fs)
    assert _canon_equal(k.fp12_product(got), prod)
    assert _canon_equal(k.final_exponentiation(got[0]), fe0)
    out, flag = k._final_exp_kernel(1, got)
    assert _canon_equal(out, fe)
    assert bool(flag.item()) == is_one
    assert k.pairing_check_batch(*dev, mask) == is_one


_ML_COOP_MAX = 2561      # ops/bls_cost.py ML_COOP_MAX


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 2, 3, 64, 65, 129, 257, _ML_COOP_MAX,
                               _ML_COOP_MAX + 1, _ML_COOP_MAX + 2])
def test_pairing_kernels(cuda_device, n, mode):
    """n = 1 (the final exponentiation's own launch), 2, 3, 65 and 129
    (odd; 129 the batch's Miller pairs), 64 (a full tree) and 257 (past
    the 256 slots: a thread folds two values), one masked lane each; the
    Miller loop a block a pair up to LH_ML_COOP_MAX pairs, past it on the
    live pairs alone while they are within it (n = LH_ML_COOP_MAX + 1),
    and a thread a pair past that (+ 2)."""
    from lighthouse_tpu_torch.ops import bls_cost as cost
    assert cost.ML_COOP_MAX == _ML_COOP_MAX
    with _mode(mode):
        _check_pairing(cuda_device, n)


def test_final_exp_flags_a_valid_signature(cuda_device):
    """The pairing check of a signature and its negated generator pair
    is one on the kernels (the flag of a product that is one)."""
    from lighthouse_tpu_torch.crypto.bls12_381 import (
        G1_GENERATOR, hash_to_g2, sign, sk_to_pk,
    )
    _, k = _bls()
    msg = b"\x5a" * 32
    sig, pk, h = sign(3, msg), sk_to_pk(3), hash_to_g2(msg)
    px = torch.from_numpy(k.fp_encode(
        [int(G1_GENERATOR.neg().to_affine()[0]), int(pk.to_affine()[0])]))
    py = torch.from_numpy(k.fp_encode(
        [int(G1_GENERATOR.neg().to_affine()[1]), int(pk.to_affine()[1])]))
    qx = torch.from_numpy(k.fp2_encode([sig.to_affine()[0], h.to_affine()[0]]))
    qy = torch.from_numpy(k.fp2_encode([sig.to_affine()[1], h.to_affine()[1]]))
    for mode in (0, 1, 2):
        with _mode(mode):
            assert k.pairing_check_batch(
                *(t.to(cuda_device) for t in (px, py, qx, qy))) is True


@pytest.mark.parametrize("n", [1, 3, 130])
def test_g2_intake_kernel(cuda_device, n):
    bi, k = _bls()
    x, y, z = _points(n, 500 + n, True)
    rng = np.random.default_rng(n)
    xs = x.clone()
    xs[-1] = torch.from_numpy(k.fp_encode(
        [int(v) for v in rng.integers(0, 2**62, size=2)]))  # maybe no root
    flags = rng.integers(0, 2, size=n).astype(bool)
    want = k.g2_decompress_batch(xs, flags)
    got = k.g2_decompress_batch(xs.to(cuda_device), flags)
    assert _canon_equal(got, want)
    want = k.g2_in_subgroup_batch(x, y, z)
    got = k.g2_in_subgroup_batch(*(t.to(cuda_device) for t in (x, y, z)))
    assert _canon_equal(got, want)
    assert bool(want.all())


def _gx1_is_square(u):
    """Whether SSWU takes x1 for u (oracle Fp2): g(x1) a square."""
    from lighthouse_tpu_torch.crypto.bls12_381.hash_to_curve import (
        ISO_A, ISO_B, SSWU_Z,
    )
    from lighthouse_tpu_torch.crypto.bls12_381.fields import Fp2
    zu2 = SSWU_Z * u.square()
    tv1 = zu2.square() + zu2
    if tv1.is_zero():
        x1 = ISO_B * (SSWU_Z * ISO_A).inv()
    else:
        x1 = (-ISO_B) * ISO_A.inv() * (Fp2(1, 0) + tv1.inv())
    return (x1 * x1 * x1 + ISO_A * x1 + ISO_B).is_square()


#: plain outputs of hash-to-G2 by lane count (as _PAIRING_PLAIN)
_H2G_PLAIN: dict = {}


def _h2g_inputs(n):
    """u0, u1 of n messages: lane 0's u0 is 0 (SSWU's exceptional case,
    tv1 = 0) and its u1 one whose g(x1) is not a square; the plain
    Jacobian outputs."""
    from lighthouse_tpu_torch.crypto.bls12_381.hash_to_curve import (
        DST_POP, hash_to_field_fp2,
    )
    _, k = _bls()
    if n not in _H2G_PLAIN:
        j = 0
        while _gx1_is_square(hash_to_field_fp2(bytes([j]), 2, DST_POP)[1]):
            j += 1
        msgs = [bytes([j])] + [b"message %d" % i for i in range(1, n)]
        u0, u1 = (np.ascontiguousarray(a)
                  for a in k.hash_to_field_host(msgs, DST_POP))
        u0[0] = 0
        u0, u1 = torch.from_numpy(u0), torch.from_numpy(u1)
        with _mode(0):
            want = k._hash_to_g2_plain(u0.to("cuda"), u1.to("cuda"))
        _H2G_PLAIN[n] = (u0, u1, tuple(t.cpu() for t in want))
    return _H2G_PLAIN[n]


def _check_hash_to_g2(cuda_device, n):
    _, k = _bls()
    u0, u1, want = _h2g_inputs(n)
    got = k.hash_to_g2_batch_from_u(u0.to(cuda_device), u1.to(cuda_device))
    assert _canon_equal(got, want)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 3, 128, 1025])
def test_hash_to_g2_kernel(cuda_device, n, mode):
    """n = 1, 3 and 128 (the batch's message lanes) on the cooperative
    design, 1,025 past LH_H2G_COOP_MAX on the one-thread design; lane 0
    maps u = 0 (tv1 = 0) and a u whose g(x1) is not a square."""
    with _mode(mode):
        _check_hash_to_g2(cuda_device, n)


@pytest.mark.parametrize("mode", [1, 2])
def test_bls_kernels_under_digit_modes(cuda_device, mode):
    """Every BLS kernel's mode-n variant (the digit-space fp_mul of
    csrc/bls/fp.cuh) against the mode-n plain versions, at the sizes of
    the tests above; each variant launched, the mode-0 kernels not."""
    bi, _ = _bls()
    kernels.build_all(kernels.variants(mode))
    kernels.reset_counts()
    try:
        bi.set_mxu_mode(mode)
        test_fp_ops_kernel(cuda_device, 130)
        for g2 in (False, True):
            test_scalar_mul_and_affine_kernels(cuda_device, 3, g2)
        test_aggregate_kernels(cuda_device, 3)
        _check_pairing(cuda_device, 3)
        test_g2_intake_kernel(cuda_device, 3)
        _check_hash_to_g2(cuda_device, 3)
    finally:
        bi.set_mxu_mode(0)
    for k in kernels.BLS_KERNELS:
        assert k.variant(mode).launches > 0, k.name
        assert k.launches == 0, k.name


@pytest.mark.parametrize("n", [1, 257])
def test_sha256_messages_kernel(cuda_device, n):
    import hashlib
    rng = np.random.default_rng(n)
    for length in (0, 1, 55, 56, 64, 100, 200):
        msgs = rng.integers(0, 256, size=(n, length), dtype=np.uint8)
        words = sh.words_to_tensor(sh.pad_messages(msgs), "cpu")
        want = sh.sha256_messages(words)
        got = sh.sha256_messages(words.to(cuda_device))
        assert torch.equal(got.cpu(), want)
        assert sh.words_to_chunks(sh.tensor_to_words(got)[-1]) == \
            hashlib.sha256(msgs[-1].tobytes()).digest()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fp12_pow_kernel(cuda_device, mode):
    bi, k = _bls()
    kernels.build_all(kernels.variants(mode))
    px, py, _ = _points(3, 600, False)
    qx, qy, _ = _points(3, 700, True)
    px[0], py[0], qx[0], qy[0] = px[1], py[1], qx[1], qy[1]
    try:
        bi.set_mxu_mode(mode)
        f = k.miller_loop_batch(px, py, qx, qy)
        for e in (0, 1, 0b1011, 0xD201000000010000):
            want = k.fp12_pow_const(f, e)
            got = k.fp12_pow_const(f.to(cuda_device), e)
            assert _canon_equal(got, want)
    finally:
        bi.set_mxu_mode(0)
