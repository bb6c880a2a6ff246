"""The port's CUDA kernels against their plain versions, on the card, at
the edges of what the kernels take (odd sizes, every ``pre_levels``, rows
with duplicates, empty cap folds), and the DeviceTree on the card against
the DeviceTree on the CPU. Bit-exact: tolerance zero.

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


def test_path_update_with_duplicate_rows(cuda_device):
    rng = np.random.default_rng(3)
    depth = 6
    lv = [sh.words_to_tensor(_words(rng, 1 << depth, 8), "cpu")]
    for _ in range(depth):
        lv.append(sh.hash64(lv[-1].reshape(-1, 16)))
    rows = torch.tensor([0, 1, 1, 63, 62, 17], dtype=torch.int32)
    lv[0][rows.long()] = sh.words_to_tensor(_words(rng, 6, 8), "cpu")
    lv[0][2] = lv[0][1]
    gpu = [x.to(cuda_device) for x in lv]
    for lvl in range(depth):
        mt.path_update(lv[lvl], lv[lvl + 1], rows, lvl)
        mt.path_update(gpu[lvl], gpu[lvl + 1], rows.to(cuda_device), lvl)
    for a, b in zip(gpu, lv):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k", [0, 1, 40])
def test_cap_root_depths(cuda_device, k):
    rng = np.random.default_rng(k)
    root = sh.words_to_tensor(_words(rng, 8), "cpu")
    want = sh.cap_root(root, 10, 10 + k)
    assert torch.equal(sh.cap_root(root.to(cuda_device), 10, 10 + k).cpu(),
                       want)


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


@pytest.mark.parametrize("n", [1, 3, 130])
def test_aggregate_kernels(cuda_device, n):
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
    got = k.g2_sum(*(t.to(cuda_device) for t in (x2, y2, z2)))
    assert _canon_equal(got, want)


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


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 2, 3, 64, 65, 129, 257])
def test_pairing_kernels(cuda_device, n, mode):
    """n = 1 (the final exponentiation's own launch), 2, 3, 65 and 129
    (odd; 129 the batch's Miller pairs), 64 (a full tree) and 257 (past
    the 256 slots: a thread folds two values), one masked lane each."""
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
