"""Batched 384-bit modular arithmetic on the card (int32 limb tensors).

The port of ``lighthouse_tpu/ops/bigint.py``: the foundation of the
BLS12-381 stages (ops/bls12_381.py).

- representation: 32 little-endian limbs of 12 bits in int32 ``[..., 32]``,
  the JAX package's interchange layout, so limbs carry across unchanged;
- field values live in the redundant range [0, 2p) in Montgomery form
  (R = 2^384); every op returns to [0, 2p), canonicalization only at the
  edges.

``mont_mul``, ``add_mod``, ``sub_mod``, ``mont_from_int_limbs`` and
``reduce_wide_mod_p`` are the wrappers of the ``fp_ops`` CUDA kernel
(csrc/bls/fp_ops.cu; in mode 0 CIOS Montgomery over 12 32-bit words; R
is 2^384 in both layouts, so the Montgomery domain is the same), one
launch each: a CUDA tensor launches the kernel, a CPU tensor takes the
plain version. The kernel reads R^2 and R^3 mod p from tables built into
it, so the entry into the Montgomery domain and the wide reduction copy
no constant to the card. The plain versions (``_mont_mul_plain`` and friends) follow the
JAX algorithm: Toeplitz column products, two carry passes, and
``normalize``'s log-depth scan over {-1, 0, 1} carry triples. They run on
any device: the tower, curve and pairing plain versions are built on
them, and ``chip_smoke.py`` compares the kernels with them on the card.

The multiply lowering follows ``LHTPU_BIGINT_MXU`` (0, 1 or 2; read at
import as the JAX package reads it, switched by ``set_mxu_mode``): modes 1
and 2 compute the two REDC products, by the constants N' and p, in 6-bit
digit space (int8 digits, int32 sums), and mode 1 the product a*b too.
The plain multiply takes the JAX package's steps in every mode and
returns its representative; every kernel launch builds (at first use) and
runs the variant of the current mode, whose ``fp_mul`` is the digit-space
product of ``csrc/bls/fp.cuh``.

The kernels and the plain multiply return different representatives in
[0, 2p), and so do the modes: compare ``canonical`` values, never raw
limbs.

``MONT_MUL_ROWS`` counts the field products the plain ``mont_mul`` (and
the plain conversion out of the Montgomery domain, a product by 1) has
computed (rows x calls), so a stage's field-multiply count can be read off
its plain version; tests hold the kernels' own counts (ops/bls_cost.py)
to it.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..obs.roofline import tracked

LIMB_BITS = 12
NLIMBS = 32
LIMB_MASK = (1 << LIMB_BITS) - 1


# The multiply lowering, as lighthouse_tpu/ops/bigint.py reads it:
#   0 - schoolbook limb columns (CIOS over 32-bit words in the kernels);
#   1 - all three products of mont_mul in 6-bit digit space;
#   2 - the product a*b on limbs, the two REDC products (by N' and p) in
#       digit space.
# All modes give the same field values; representatives in [0, 2p) differ.
def _mxu_mode_from_env() -> int:
    raw = os.environ.get("LHTPU_BIGINT_MXU", "0") or "0"
    try:
        mode = int(raw)
    except ValueError:
        raise ValueError(
            f"LHTPU_BIGINT_MXU must be 0, 1 or 2, got {raw!r}") from None
    if mode not in (0, 1, 2):
        raise ValueError(f"LHTPU_BIGINT_MXU must be 0, 1 or 2, got {mode}")
    return mode


_MXU_MODE = _mxu_mode_from_env()


def mxu_mode() -> int:
    return _MXU_MODE


def set_mxu_mode(mode: int) -> None:
    """Switch the multiply lowering (0/1/2). Every later plain product and
    kernel launch reads it; PyTorch keeps no trace to invalidate. A
    process spawned later reads only ``LHTPU_BIGINT_MXU``:
    ``parallel.launch.run_ranks`` passes this mode to its ranks."""
    global _MXU_MODE
    mode = int(mode)
    if mode not in (0, 1, 2):
        raise ValueError(f"LHTPU_BIGINT_MXU mode must be 0/1/2, got {mode}")
    _MXU_MODE = mode


P_INT = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R_INT = 1 << (LIMB_BITS * NLIMBS)          # Montgomery radix 2^384
R_MOD_P = R_INT % P_INT
R2_MOD_P = (R_INT * R_INT) % P_INT
NPRIME = (-pow(P_INT, -1, R_INT)) % R_INT  # -p^-1 mod R


def to_limbs(v: int, n: int = NLIMBS) -> np.ndarray:
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = v & LIMB_MASK
        v >>= LIMB_BITS
    assert v == 0
    return out


def from_limbs(limbs) -> int:
    v = 0
    for i, l in enumerate(np.asarray(limbs).tolist()):
        v += int(l) << (LIMB_BITS * i)
    return v


def ints_to_limbs(vals) -> np.ndarray:
    """Python ints in [0, 2^384) -> int32 limbs [n, 32], vectorized (the
    bulk form of ``to_limbs``: 48 little-endian bytes a value, each 3
    bytes two 12-bit limbs)."""
    raw = b"".join(int(v).to_bytes(48, "little") for v in vals)
    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 16, 3).astype(
        np.int32)
    lo = b[..., 0] | ((b[..., 1] & 0xF) << 8)
    hi = (b[..., 1] >> 4) | (b[..., 2] << 4)
    return np.stack([lo, hi], axis=-1).reshape(-1, NLIMBS)


def limbs_to_ints(limbs) -> list[int]:
    """int32 limbs [..., 32] (digits may be loose) -> Python ints."""
    arr = np.asarray(limbs, dtype=np.int64).reshape(-1, NLIMBS)
    return [from_limbs(row) for row in arr]


P_LIMBS = to_limbs(P_INT)
TWO_P_LIMBS = to_limbs(2 * P_INT)
NPRIME_LIMBS = to_limbs(NPRIME)
R2_LIMBS = to_limbs(R2_MOD_P)
R3_LIMBS = to_limbs((R_INT * R_INT * R_INT) % P_INT)


class RowCounter:
    """Field products computed by the plain ``mont_mul`` (rows x calls),
    and its calls."""

    def __init__(self):
        self.rows = 0
        self.calls = 0

    def reset(self) -> None:
        self.rows = 0
        self.calls = 0


MONT_MUL_ROWS = RowCounter()


def const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A numpy limb constant as an int32 tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(arr, dtype=np.int32),
                           device=like.device)


# ---------------------------------------------------------------------------
# The plain limb arithmetic, written once over an array namespace: PyTorch
# for tensors on the card, numpy for tensors on the CPU (the same
# operations on the same int64 limbs; numpy's per-call cost on the small
# batches of the CPU tests is a fraction of PyTorch's, and these functions
# run tens of thousands of times in one pairing). Public functions take and
# return torch tensors.
# ---------------------------------------------------------------------------

class _TorchOps:
    @staticmethod
    def i64(x):
        return x.to(torch.int64)

    @staticmethod
    def i32(x):
        return x.to(torch.int32)

    @staticmethod
    def cat(xs, axis):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def copy(x):
        return x.clone()

    @staticmethod
    def const(arr, like):
        return torch.as_tensor(np.asarray(arr), device=like.device)

    @staticmethod
    def zeros(shape, like):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)

    @staticmethod
    def sum(x, axis):
        return x.sum(dim=axis)

    @staticmethod
    def all(x, axis):
        return torch.all(x, dim=axis)

    where = staticmethod(torch.where)


class _NumpyOps:
    @staticmethod
    def i64(x):
        return x.astype(np.int64)

    @staticmethod
    def i32(x):
        return x.astype(np.int32)

    @staticmethod
    def cat(xs, axis):
        return np.concatenate(xs, axis=axis)

    @staticmethod
    def copy(x):
        return x.copy()

    @staticmethod
    def const(arr, like):
        return np.asarray(arr)

    @staticmethod
    def zeros(shape, like):
        return np.zeros(shape, dtype=like.dtype)

    @staticmethod
    def sum(x, axis):
        return x.sum(axis=axis)

    @staticmethod
    def all(x, axis):
        return np.all(x, axis=axis)

    where = staticmethod(np.where)


_TORCH, _NUMPY = _TorchOps(), _NumpyOps()


def _plain(fn, *tensors):
    """Run the plain ``fn(xp, *arrays)`` on torch tensors: through numpy
    when they lie on the CPU, through PyTorch otherwise."""
    tensors = torch.broadcast_tensors(*tensors)
    if tensors[0].device.type == "cpu":
        return torch.from_numpy(np.ascontiguousarray(
            fn(_NUMPY, *(t.numpy() for t in tensors))))
    return fn(_TORCH, *tensors)


# ---------------------------------------------------------------------------
# carries
# ---------------------------------------------------------------------------

def _carry_pass(xp, x):
    """One carry pass: keep the low 12 bits of every limb, push the
    (arithmetic-shift) carry into the next limb; the top limb keeps its
    own carry (absorbs it), so the value and its sign stay observable
    there."""
    out = xp.copy(x)
    out[..., :-1] &= LIMB_MASK
    out[..., 1:] += x[..., :-1] >> LIMB_BITS
    return out


def _compose_table() -> np.ndarray:
    """COMP[g, f] = code of g . f, for carry functions {-1,0,1} -> {-1,0,1}
    coded as 9*(f(-1)+1) + 3*(f(0)+1) + (f(1)+1)."""
    vals = [(c // 9 - 1, c // 3 % 3 - 1, c % 3 - 1) for c in range(27)]
    comp = np.zeros((27, 27), dtype=np.int64)
    for g in range(27):
        for f in range(27):
            h = [vals[g][v + 1] for v in vals[f]]
            comp[g, f] = 9 * (h[0] + 1) + 3 * (h[1] + 1) + (h[2] + 1)
    return comp


_COMPOSE = _compose_table()


def _normalize(xp, x):
    """Exact signed carry propagation over the last axis (int64 out).

    Input limbs may be any integer with |limb| < 2^30; output limbs are in
    [0, 2^12) except the top limb, which absorbs the final carry (negative
    iff the value is). Two carry passes bound every other limb to
    (-2^8, 2^12 + 2^8); the residual carries are in {-1, 0, 1} and resolve
    with an inclusive log-depth scan over carry functions, each the value
    triple (f(-1), f(0), f(1)) of f(c) = (l + c) >> 12, as the JAX
    ``normalize`` does. Here a triple is a code in [0, 27) and composing two
    is one lookup in ``_COMPOSE``. The top limb's carry-out is never used,
    so the scan runs over the limbs below it."""
    x = _carry_pass(xp, _carry_pass(xp, xp.i64(x)))
    low = x[..., :-1]
    a = low >> LIMB_BITS
    r = low & LIMB_MASK
    code = (9 * (a - xp.i64(r == 0)) + 3 * a + (a + xp.i64(r == LIMB_MASK))
            + 13)
    comp = xp.const(_COMPOSE, x)
    n = code.shape[-1]
    d = 1
    while d < n:
        # Hillis-Steele step: F[i] <- F[i] . F[i-d]
        nxt = xp.copy(code)
        nxt[..., d:] = comp[code[..., d:], code[..., :-d]]
        code = nxt
        d *= 2
    s = xp.copy(x)
    s[..., 1:] += code // 3 % 3 - 1           # F_i(0): the carry into i+1
    s[..., :-1] &= LIMB_MASK
    return s


def _cond_sub(xp, x, m):
    """x - m if x >= m else x (x loose-positive, m canonical constant).
    Output limbs <= 2^12 (one cheap carry pass on the restore branch), not
    bit-canonical digits."""
    mc = xp.i64(xp.const(m, x))
    d = _normalize(xp, x - mc)
    neg = (d[..., -1] < 0)[..., None]
    return xp.where(neg, _carry_pass(xp, d + mc), d)


def _cond_sub_exact(xp, x, m):
    d = _normalize(xp, x - xp.i64(xp.const(m, x)))
    neg = (d[..., -1] < 0)[..., None]
    return xp.where(neg, _normalize(xp, x), d)


def _columns(xp, a, b, n: int):
    """Schoolbook column products of two n-entry vectors, un-carried, in
    int64: out[k] = sum_i a[i] * b[k-i], k < 2n (the JAX Toeplitz
    contraction, computed without the gather). Small CPU batches skew the
    outer product so that row i starts at column i (pad each row to 2n+1,
    view the first 2n*n entries as [n, 2n]) and sum the rows; larger ones,
    and the card, add n shifted row products."""
    a, b = xp.i64(a), xp.i64(b)
    lead = a.shape[:-1]
    rows = int(np.prod(lead)) if lead else 1
    if xp is _NUMPY and rows <= 64:
        o = np.zeros(lead + (n, 2 * n + 1), dtype=np.int64)
        np.multiply(a[..., :, None], b[..., None, :], out=o[..., :n])
        o = o.reshape(lead + (n * (2 * n + 1),))
        o = o[..., :2 * n * n].reshape(lead + (n, 2 * n))
        return xp.sum(o, -2)
    out = xp.zeros(lead + (2 * n,), a)
    for i in range(n):
        out[..., i:i + n] += a[..., i:i + 1] * b
    return out


def _mul_columns(xp, a, b, out_len: int):
    """Limb column products: out[k] = sum_i a[i] * b[k-i], un-carried."""
    return _columns(xp, a, b, NLIMBS)[..., :out_len]


def _toeplitz(limbs: np.ndarray, out_len: int) -> np.ndarray:
    """T[i, k] = c[k - i]: the column product with the constant c is the
    matrix product x @ T (float64: every sum is an integer below 2^31)."""
    t = np.zeros((NLIMBS, out_len), dtype=np.float64)
    for i in range(NLIMBS):
        hi = min(out_len, i + NLIMBS)
        t[i, i:hi] = limbs[:hi - i]
    return t


_NPRIME_T = _toeplitz(NPRIME_LIMBS, NLIMBS)       # low product, mod R
_P_T = _toeplitz(P_LIMBS, 2 * NLIMBS)             # full product


def _mul_const(xp, x, t: np.ndarray):
    """Column products of x with a shared constant (its float64 Toeplitz
    matrix)."""
    tt = xp.const(t, x)
    if xp is _NUMPY:
        return np.rint(x.astype(np.float64) @ tt).astype(np.int64)
    return torch.round(x.to(torch.float64) @ tt).to(torch.int64)


# --- 6-bit digit space (modes 1 and 2), as the JAX package's -------------
#
# Each 12-bit limb splits into two 6-bit digits, so a field element is 64
# little-endian digits; limbs up to 2^13 - 1 give int8-safe digits (lo <=
# 63, hi <= 127). Digit products summed over <= 64 columns stay < 2^21;
# merged back to limb columns (even + (odd << 6)) < 2^27.

NDIGITS = 2 * NLIMBS
DIGIT_BITS = LIMB_BITS // 2
DIGIT_MASK = (1 << DIGIT_BITS) - 1


def _digits6(xp, x):
    """[..., 32] limbs (in [0, 2^13)) -> [..., 64] digits (int64)."""
    x = xp.i64(x)
    out = xp.zeros(x.shape[:-1] + (NDIGITS,), x)
    out[..., 0::2] = x & DIGIT_MASK
    out[..., 1::2] = x >> DIGIT_BITS
    return out


def _from_digits6(cols):
    """Un-carried digit columns [..., 2L] -> limb columns [..., L]."""
    return cols[..., 0::2] + (cols[..., 1::2] << DIGIT_BITS)


def _digits6_host(limbs: np.ndarray) -> np.ndarray:
    out = np.zeros(NDIGITS, dtype=np.int64)
    for i, l in enumerate(np.asarray(limbs, dtype=np.int64)):
        out[2 * i] = l & DIGIT_MASK
        out[2 * i + 1] = l >> DIGIT_BITS
    return out


def toeplitz6(limbs: np.ndarray, out_digits: int) -> np.ndarray:
    """Constant-operand digit Toeplitz matrix T[i, k] = digit[k-i]: the
    column product with the constant c is x_digits @ T."""
    d = _digits6_host(limbs)
    assert int(d.max()) <= DIGIT_MASK  # constants are canonical
    T = np.zeros((NDIGITS, out_digits), dtype=np.int8)
    for i in range(NDIGITS):
        hi = min(out_digits, i + NDIGITS)
        T[i, i:hi] = d[:hi - i]
    return T


_NPRIME_T6 = toeplitz6(NPRIME_LIMBS, NDIGITS)           # low product, mod R
_P_T6 = toeplitz6(P_LIMBS, 2 * NDIGITS)                 # full product
#: float64 copies for the plain products (every sum is an integer < 2^21)
_T6_F64 = {id(t): t.astype(np.float64) for t in (_NPRIME_T6, _P_T6)}


def _mul_columns_digits(xp, a, b, out_len: int):
    """Bilinear schoolbook columns in digit space -> limb columns."""
    cols = _columns(xp, _digits6(xp, a), _digits6(xp, b), NDIGITS)
    return _from_digits6(cols[..., :2 * out_len])


def _mul_const_digits(xp, x, t: np.ndarray):
    """Shared-constant product: the digits times a Toeplitz constant
    (``_NPRIME_T6`` or ``_P_T6``)."""
    return _from_digits6(_mul_const(xp, _digits6(xp, x), _T6_F64[id(t)]))


def _mont_mul_limbs(xp, a, b):
    """Montgomery product a*b*R^-1 mod p, inputs/outputs in [0, 2p): the
    JAX REDC of the current mode with one exact normalize (t and m need
    only bounded limbs). The N' product is truncated at 32 limb columns in
    mode 0 and at 64 digit columns in modes 1 and 2: two values of m
    congruent mod R, hence two representatives of one field value."""
    mode = _MXU_MODE
    if mode == 1:
        t_cols = _mul_columns_digits(xp, a, b, 2 * NLIMBS)
    else:
        t_cols = _mul_columns(xp, a, b, 2 * NLIMBS)
    t = _carry_pass(xp, _carry_pass(xp, t_cols))
    if mode:
        m_cols = _mul_const_digits(xp, t[..., :NLIMBS], _NPRIME_T6)
    else:
        m_cols = _mul_const(xp, t[..., :NLIMBS], _NPRIME_T)
    m = _carry_pass(xp, _carry_pass(xp, m_cols))
    m[..., -1] &= LIMB_MASK                         # value mod R
    mp = _mul_const_digits(xp, m, _P_T6) if mode else _mul_const(xp, m, _P_T)
    return xp.i32(_normalize(xp, t + mp)[..., NLIMBS:])


def _add_limbs(xp, a, b):
    return xp.i32(_cond_sub(xp, xp.i64(a) + b, TWO_P_LIMBS))


def _sub_limbs(xp, a, b):
    x = xp.i64(a) - b + xp.i64(xp.const(TWO_P_LIMBS, a))
    return xp.i32(_cond_sub(xp, x, TWO_P_LIMBS))


def _canonical_limbs(xp, x):
    return xp.i32(_cond_sub_exact(xp, _normalize(xp, x), P_LIMBS))


def _to_int_limbs(xp, x):
    one = xp.zeros(x.shape, x)
    one[..., 0] = 1
    v = _mont_mul_limbs(xp, x, one)
    v = _cond_sub_exact(xp, xp.i64(v), P_LIMBS)
    return xp.i32(_cond_sub_exact(xp, v, P_LIMBS))


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Exact signed carry propagation (see ``_normalize``); int32 out."""
    return _plain(lambda xp, v: xp.i32(_normalize(xp, v)), x)


def cond_sub_exact(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """Like cond_sub but both branches yield exact canonical digits."""
    return _plain(lambda xp, v: xp.i32(_cond_sub_exact(xp, xp.i64(v), m)),
                  x)


def _mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain Montgomery product (any device); counts its rows."""
    MONT_MUL_ROWS.rows += max(a.numel(), b.numel()) // NLIMBS
    MONT_MUL_ROWS.calls += 1
    return _plain(_mont_mul_limbs, a, b)


def _add_mod_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _plain(_add_limbs, a, b)


def _sub_mod_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _plain(_sub_limbs, a, b)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Reduce a [0,2p) value to [0,p), exact digits."""
    return _plain(_canonical_limbs, x)


def to_int_limbs_plain(x: torch.Tensor) -> torch.Tensor:
    """Out of Montgomery domain, fully reduced to [0, p), by the plain
    multiply (counted: a product by 1)."""
    MONT_MUL_ROWS.rows += x.numel() // NLIMBS
    MONT_MUL_ROWS.calls += 1
    return _plain(_to_int_limbs, x)


def eq_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Equality of field values in [0,2p) (canonicalize then compare)."""
    return _plain(lambda xp, u, v: xp.all(
        _canonical_limbs(xp, u) == _canonical_limbs(xp, v), -1), a, b)


def is_zero_mod(a: torch.Tensor) -> torch.Tensor:
    return _plain(lambda xp, u: xp.all(_canonical_limbs(xp, u) == 0, -1), a)


def _mont_from_int_plain(x: torch.Tensor) -> torch.Tensor:
    """x R mod p, the plain Montgomery product by the integer R^2 mod p."""
    return _mont_mul_plain(x, const(R2_LIMBS, x))


def _reduce_wide_plain(wide: torch.Tensor) -> torch.Tensor:
    """mont(lo, R^2) + mont(hi, R^3) of [..., 64] limbs, by the plain
    products, as the JAX package composes its jitted ones."""
    lo, hi = wide[..., :NLIMBS], wide[..., NLIMBS:]
    return _add_mod_plain(_mont_mul_plain(lo, const(R2_LIMBS, lo)),
                          _mont_mul_plain(hi, const(R3_LIMBS, hi)))


#: the ops of the ``fp_ops`` kernel: two-operand mul, add, sub over
#: [..., 32]; one-operand entry into the Montgomery domain ([..., 32]) and
#: wide reduction ([..., 64] -> [..., 32])
FP_MUL, FP_ADD, FP_SUB, FP_TO_MONT, FP_WIDE = 0, 1, 2, 3, 4
_PLAIN = {FP_MUL: _mont_mul_plain, FP_ADD: _add_mod_plain,
          FP_SUB: _sub_mod_plain, FP_TO_MONT: _mont_from_int_plain,
          FP_WIDE: _reduce_wide_plain}


def _fp_op(op: int, a: torch.Tensor, b: torch.Tensor | None = None
           ) -> torch.Tensor:
    if a.device.type == "cpu" and (b is None or b.device.type == "cpu"):
        return _PLAIN[op](a) if b is None else _PLAIN[op](a, b)
    return fp_ops_kernel(op, a, b)


def _fp_ops_cost(out, op, a, b=None):
    """The function's least work on the output's elements
    (``bls_cost.fp_ops``): its field multiplies, each input read once and
    the output written once."""
    from .bls_cost import FP_MUL_INT_OPS, fp_ops
    muls, n_bytes = fp_ops(op, out.numel() // NLIMBS)
    return n_bytes, muls * FP_MUL_INT_OPS, {"field_muls": muls}


@tracked("fp_ops", _fp_ops_cost)
def fp_ops_kernel(op: int, a: torch.Tensor,
                  b: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``fp_ops`` on CUDA int32 limbs: ops ``FP_MUL``, ``FP_ADD``,
    ``FP_SUB`` elementwise over two [..., 32] tensors (broadcast to one
    shape), ``FP_TO_MONT`` over one [..., 32], ``FP_WIDE`` over one
    [..., 64] (out [..., 32]). Contiguous inputs of one shape go to the
    kernel as they are. Raises on anything else."""
    from .. import kernels
    unary = op in (FP_TO_MONT, FP_WIDE)
    if op not in _PLAIN or unary != (b is None):
        raise ValueError(f"fp_ops op {op} with "
                         f"{'no' if b is None else 'a'} second operand")
    ts = (a,) if unary else (a, b)
    if any(t.device.type != "cuda" for t in ts):
        raise ValueError(f"fp_ops takes CUDA tensors, got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.int32 for t in ts):
        raise TypeError(f"fp_ops takes int32 limbs, got "
                        f"{[t.dtype for t in ts]}")
    if not unary and (a.shape != b.shape or not b.is_contiguous()):
        a, b = torch.broadcast_tensors(a, b)
        b = b.contiguous()
    width = 2 * NLIMBS if op == FP_WIDE else NLIMBS
    if a.shape[-1] != width:
        raise ValueError(f"fp_ops op {op} takes [..., {width}] limbs, got "
                         f"{tuple(a.shape)}")
    a = a.contiguous()
    out = torch.empty(a.shape[:-1] + (NLIMBS,), dtype=torch.int32,
                      device=a.device)
    n = out.numel() // NLIMBS
    if n:
        kernels.FP_OPS.launch(op, a.data_ptr(),
                              None if unary else b.data_ptr(),
                              out.data_ptr(), n,
                              kernels.stream_ptr(a.device))
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p, inputs/outputs in [0, 2p)."""
    return _fp_op(FP_MUL, a, b)


def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fp_op(FP_ADD, a, b)


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fp_op(FP_SUB, a, b)


def neg_mod(a: torch.Tensor) -> torch.Tensor:
    return sub_mod(torch.zeros_like(a), a)


def mont_from_int_limbs(x: torch.Tensor) -> torch.Tensor:
    """Into Montgomery domain: x * R mod p (x < p); one launch on the card
    (the kernel's own R^2), whatever the batch's shape."""
    return _fp_op(FP_TO_MONT, x)


def mont_to_int_limbs(x: torch.Tensor) -> torch.Tensor:
    """Out of Montgomery domain and fully reduced to [0, p)."""
    one = torch.zeros_like(x)
    one[..., 0] = 1
    v = mont_mul(x, one)
    v = cond_sub_exact(v, P_LIMBS)
    return cond_sub_exact(v, P_LIMBS)


def reduce_wide_mod_p(wide: torch.Tensor) -> torch.Tensor:
    """Reduce a 64-limb (768-bit capacity) value mod p into Montgomery
    form: x*R = lo*R + hi*R^2, i.e. mont(lo, R^2) + mont(hi, R^3).
    Returns x*R mod p in [0, 2p); one launch on the card, reading the
    [..., 64] rows as they are."""
    return _fp_op(FP_WIDE, wide)
