"""The port's field layer (ops/bigint.py, plain versions on the CPU)
against the JAX package's ``ops/bigint`` and Python ints: the same seeded
inputs, carried across by ``convert.limbs_from_numpy``; field values equal
after ``canonical`` (tolerance zero), including the edge values 0, 1, p-1,
p, p+1 and 2p-1 and borrow-heavy subtractions."""
import numpy as np
import pytest
import torch

from lighthouse_tpu.ops import bigint as jbi
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.ops import bigint as tbi

P = tbi.P_INT
R_INV = pow(tbi.R_INT, -1, P)
EDGES = [0, 1, P - 1, P, P + 1, 2 * P - 1]
N = 16


@pytest.fixture(autouse=True)
def cpu_device():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _values(seed, n=N):
    """n values in [0, 2p): the edges, then seeded random ones."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(48), "little") % (2 * P)
            for _ in range(n - len(EDGES))]
    return EDGES + rand


def _jax_limbs(vals):
    return np.stack([jbi.to_limbs(v) for v in vals])


def _ints(t):
    return tbi.limbs_to_ints(convert.limbs_to_numpy(t))


def _same_canonical(got, want_jax):
    want = np.asarray(jbi.canonical(np.asarray(want_jax)))
    np.testing.assert_array_equal(
        convert.limbs_to_numpy(tbi.canonical(got)), want)


def test_limb_conversions_match_jax():
    vals = _values(0)
    arr = _jax_limbs(vals)
    np.testing.assert_array_equal(tbi.ints_to_limbs(vals), arr)
    assert tbi.limbs_to_ints(arr) == vals
    for v in vals:
        np.testing.assert_array_equal(tbi.to_limbs(v), jbi.to_limbs(v))
        assert tbi.from_limbs(tbi.to_limbs(v)) == v


@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod"])
def test_binary_ops_match_jax_and_ints(op):
    vals_a, vals_b = _values(1), _values(2)[::-1]
    a_np, b_np = _jax_limbs(vals_a), _jax_limbs(vals_b)
    a, b = convert.limbs_from_numpy(a_np), convert.limbs_from_numpy(b_np)
    got = getattr(tbi, op)(a, b)
    _same_canonical(got, getattr(jbi, op)(a_np, b_np))
    for x, y, v in zip(vals_a, vals_b, _ints(got)):
        assert 0 <= v < 2 * P
        want = {"mont_mul": x * y * R_INV, "add_mod": x + y,
                "sub_mod": x - y}[op]
        assert v % P == want % P


def test_borrow_heavy_subtraction_and_negation():
    vals = _values(3)
    a_np = _jax_limbs(vals)
    a = convert.limbs_from_numpy(a_np)
    zero = tbi.sub_mod(a, a)
    assert bool(tbi.is_zero_mod(zero).all())
    np.testing.assert_array_equal(convert.limbs_to_numpy(tbi.canonical(zero)),
                                  np.zeros_like(a_np))
    neg = tbi.neg_mod(a)
    _same_canonical(neg, jbi.neg_mod(a_np))
    assert bool(tbi.is_zero_mod(tbi.add_mod(a, neg)).all())


def test_normalize_matches_jax_on_signed_limbs():
    rng = np.random.default_rng(4)
    x = rng.integers(-(2**29), 2**29, size=(N, 64)).astype(np.int32)
    x[0] = -1                          # every limb borrows
    x[1] = tbi.LIMB_MASK               # every limb at the carry edge
    x[2, :] = 0
    x[2, 0] = -1
    got = tbi.normalize(convert.limbs_from_numpy(x))
    np.testing.assert_array_equal(convert.limbs_to_numpy(got),
                                  np.asarray(jbi.normalize(x)))


def test_canonical_eq_and_zero_match_jax():
    vals = _values(5)
    a_np = _jax_limbs(vals)
    b_np = _jax_limbs([(v + P) % (2 * P) for v in vals])   # same residues
    a, b = convert.limbs_from_numpy(a_np), convert.limbs_from_numpy(b_np)
    np.testing.assert_array_equal(
        convert.limbs_to_numpy(tbi.canonical(a)),
        np.asarray(jbi.canonical(a_np)))
    assert tbi.eq_mod(a, b).tolist() == np.asarray(
        jbi.eq_mod(a_np, b_np)).tolist() == [True] * N
    assert tbi.is_zero_mod(a).tolist() == np.asarray(
        jbi.is_zero_mod(a_np)).tolist()
    assert tbi.is_zero_mod(a).tolist()[:4] == [True, False, False, True]


def test_montgomery_round_trip_and_wide_reduction():
    rng = np.random.default_rng(6)
    vals = [v % P for v in _values(6)]
    x_np = _jax_limbs(vals)
    x = convert.limbs_from_numpy(x_np)
    mont = tbi.mont_from_int_limbs(x)
    _same_canonical(mont, jbi.mont_from_int_limbs(x_np))
    back = tbi.mont_to_int_limbs(mont)
    assert _ints(back) == vals
    wide_vals = [int.from_bytes(rng.bytes(96), "little") for _ in range(N)]
    wide_vals[0] = 2**768 - 1
    w_np = np.stack([jbi.to_limbs(v, 64) for v in wide_vals])
    got = tbi.reduce_wide_mod_p(convert.limbs_from_numpy(w_np))
    _same_canonical(got, jbi.reduce_wide_mod_p(w_np))
    for v, g in zip(wide_vals, _ints(got)):
        assert g % P == v * tbi.R_INT % P


def test_packed_lane_entry_matches_jax():
    """The batch's lane inputs packed as ``host_prepare`` packs them
    (``gpu_backend.split_lane_ints``: signatures' x, pubkeys' x, their y)
    enter the Montgomery domain in one call, and each part equals the JAX
    ``mont_from_int_limbs`` of that part; views, not copies."""
    from lighthouse_tpu_torch.crypto.bls.gpu_backend import split_lane_ints
    lanes = 5
    vals = [v % P for v in _values(16, 4 * lanes)]
    packed_np = _jax_limbs(vals)
    parts_np = split_lane_ints(packed_np, lanes)
    assert [p.shape for p in parts_np] == [(lanes, 2, 32), (lanes, 32),
                                           (lanes, 32)]
    assert all(np.shares_memory(p, packed_np) for p in parts_np)
    mont = tbi.mont_from_int_limbs(convert.limbs_from_numpy(packed_np))
    for got, part in zip(split_lane_ints(mont, lanes), parts_np):
        _same_canonical(got, jbi.mont_from_int_limbs(part))


def test_fp_ops_cost_counts_the_plain_products():
    """bls_cost.fp_ops: the entry one multiply an element, the wide
    reduction two, as the plain versions count them; its bytes one read
    of the inputs and one write of the output."""
    from lighthouse_tpu_torch.ops import bls_cost as cost
    x = convert.limbs_from_numpy(_jax_limbs([v % P for v in _values(17)]))
    w = torch.cat([x, x], dim=-1)
    for op, fn, arg in ((tbi.FP_TO_MONT, tbi.mont_from_int_limbs, x),
                        (tbi.FP_WIDE, tbi.reduce_wide_mod_p, w)):
        tbi.MONT_MUL_ROWS.reset()
        out = fn(arg)
        muls, n_bytes = cost.fp_ops(op, N)
        assert tbi.MONT_MUL_ROWS.rows == muls
        assert n_bytes == (arg.numel() + out.numel()) * 4


def test_plain_mont_mul_counts_rows():
    a = convert.limbs_from_numpy(_jax_limbs(_values(7)))
    tbi.MONT_MUL_ROWS.reset()
    tbi.mont_mul(a, a)
    tbi.mont_mul(a[:3], a[:3])
    assert tbi.MONT_MUL_ROWS.rows == N + 3


def test_kernel_wrapper_takes_only_card_tensors():
    a = convert.limbs_from_numpy(_jax_limbs(_values(8)))
    with pytest.raises(ValueError):
        tbi.fp_ops_kernel(tbi.FP_MUL, a, a)
    for op, args in ((tbi.FP_TO_MONT, (a,)), (tbi.FP_WIDE, (a,))):
        with pytest.raises(ValueError):
            tbi.fp_ops_kernel(op, *args)        # not on the card
    with pytest.raises(ValueError):
        tbi.fp_ops_kernel(tbi.FP_TO_MONT, a, a)  # the entry takes one
    with pytest.raises(ValueError):
        tbi.fp_ops_kernel(tbi.FP_MUL, a)         # mul takes two
    # on the CPU the public op is the plain version, with no kernel launch
    from lighthouse_tpu_torch import kernels
    before = kernels.FP_OPS.launches
    tbi.mont_mul(a, a)
    assert kernels.FP_OPS.launches == before
    assert torch.equal(tbi.mont_mul(a, a), tbi._mont_mul_plain(a, a))


# -- the multiply lowerings (LHTPU_BIGINT_MXU modes 1 and 2) ---------------
#
# The JAX side runs its unjitted mont_mul under a patched mode: its
# set_mxu_mode clears every compiled program of the process.

@pytest.fixture
def port_mode():
    """Set the port's lowering for one test; mode 0 again after it."""
    def set_mode(mode):
        tbi.set_mxu_mode(mode)
    yield set_mode
    tbi.set_mxu_mode(0)


@pytest.mark.parametrize("mode", [1, 2])
def test_mont_mul_modes_match_jax_limb_for_limb(mode, monkeypatch,
                                                port_mode):
    """The plain product takes the JAX steps of each mode: the same limbs
    (hence the same representative) as the JAX mode-n mont_mul, at the
    edge values and at random ones; the field value is a*b/R."""
    vals_a, vals_b = _values(11), _values(12)[::-1]
    a_np, b_np = _jax_limbs(vals_a), _jax_limbs(vals_b)
    monkeypatch.setattr(jbi, "_MXU_MODE", mode)
    want = np.asarray(jbi.mont_mul.__wrapped__(a_np, b_np))
    port_mode(mode)
    got = tbi.mont_mul(convert.limbs_from_numpy(a_np),
                       convert.limbs_from_numpy(b_np))
    np.testing.assert_array_equal(convert.limbs_to_numpy(got), want)
    for x, y, v in zip(vals_a, vals_b, _ints(got)):
        assert 0 <= v < 2 * P and v % P == x * y * R_INV % P


def test_digits_and_toeplitz_match_jax():
    """Digit split (loose limbs up to 2^13 - 1), merge and the constant
    Toeplitz matrices equal the JAX package's."""
    rng = np.random.default_rng(13)
    x = rng.integers(0, 1 << 13, size=(N, tbi.NLIMBS)).astype(np.int32)
    x[0] = (1 << 13) - 1
    got = tbi._plain(tbi._digits6, convert.limbs_from_numpy(x))
    want = np.asarray(jbi._digits6(x)).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    cols = rng.integers(0, 1 << 21, size=(N, 2 * tbi.NDIGITS))
    np.testing.assert_array_equal(tbi._from_digits6(cols),
                                  np.asarray(jbi._from_digits6(cols)))
    for name in ("_NPRIME_T6", "_P_T6"):
        np.testing.assert_array_equal(getattr(tbi, name),
                                      getattr(jbi, name))
    np.testing.assert_array_equal(tbi.toeplitz6(tbi.R2_LIMBS, 96),
                                  jbi.toeplitz6(jbi.R2_LIMBS, 96))
    assert (tbi.NDIGITS, tbi.DIGIT_BITS, tbi.DIGIT_MASK) == \
        (jbi.NDIGITS, jbi.DIGIT_BITS, jbi.DIGIT_MASK)


@pytest.mark.parametrize("raw", ["0", "1", "2", "", "x", "3"])
def test_mxu_env_parsing_matches_jax(raw, monkeypatch):
    monkeypatch.setenv("LHTPU_BIGINT_MXU", raw)
    outcomes = []
    for mod in (jbi, tbi):
        try:
            outcomes.append(("mode", mod._mxu_mode_from_env()))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("mode" if raw in ("0", "1", "2", "")
                              else "error")


def test_set_mxu_mode_switches_plain_and_kernel_variant(port_mode):
    from lighthouse_tpu_torch import kernels
    assert tbi.mxu_mode() == 0 and kernels.FP_OPS.current() is \
        kernels.FP_OPS
    for mode in (1, 2):
        port_mode(mode)
        assert tbi.mxu_mode() == mode
        k = kernels.FP_OPS.current()
        assert k is kernels.FP_OPS.variant(mode)
        assert k.name == f"fp_ops_mxu{mode}"
        assert f"-DLH_FP_MODE={mode}" in k.flags()
        assert k.library_path() != kernels.FP_OPS.library_path()
        assert k.build_key == f"bls/fp_ops.cu@mxu{mode}"
    with pytest.raises(ValueError):
        tbi.set_mxu_mode(3)
    assert tbi.mxu_mode() == 2
    with pytest.raises(ValueError):
        kernels.HASH64.variant(1)          # no field multiply inside


@pytest.mark.parametrize("mode", [1, 2])
def test_reduce_wide_and_round_trip_under_modes(mode, port_mode):
    rng = np.random.default_rng(14)
    wide_vals = [int.from_bytes(rng.bytes(96), "little") for _ in range(4)]
    wide_vals[0] = 2**768 - 1
    w_np = np.stack([jbi.to_limbs(v, 64) for v in wide_vals])
    port_mode(mode)
    got = tbi.reduce_wide_mod_p(convert.limbs_from_numpy(w_np))
    for v, g in zip(wide_vals, _ints(got)):
        assert 0 <= g < 2 * P and g % P == v * tbi.R_INT % P
    vals = [v % P for v in _values(15, 8)]
    x = convert.limbs_from_numpy(_jax_limbs(vals))
    assert _ints(tbi.mont_to_int_limbs(tbi.mont_from_int_limbs(x))) == vals


def test_mont_mul_modes_measure_runs_every_mode_and_restores(port_mode):
    """measure.mont_mul_modes (the port of bench.py's mxu workload) on the
    CPU at a tiny batch: all three modes, their results equal as field
    values, the mode in force before it back after it."""
    from lighthouse_tpu_torch import measure
    port_mode(2)
    got = measure.mont_mul_modes(batch=8, k=2, reps=1, check_lanes=4)
    assert tbi.mxu_mode() == 2
    assert got["modes_agree"]
    assert got["max_abs_err_vs_plain"] == {0: 0, 1: 0, 2: 0}
    assert set(got["per_sec"]) == {0, 1, 2} and got["k"] == 2
