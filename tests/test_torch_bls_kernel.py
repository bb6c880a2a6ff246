"""The port's BLS12-381 layer (ops/bls12_381.py, plain versions on the
CPU): the tower against the JAX package's eager functions, the stages
against the JAX package's pure-Python oracle (lighthouse_tpu/crypto/
bls12_381/, the oracle tests/test_bls_kernel.py holds the JAX stages to),
the port's copy of that oracle and the CUDA constants header against the
JAX package's oracle, and the kernels' field-multiply counts
(ops/bls_cost.py) against the plain versions' counter. Inputs are seeded
(numpy) and carried across by ``convert.limbs_from_numpy``; field values
compare after ``canonical`` and points as oracle integers (tolerance
zero)."""
import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import lighthouse_tpu.crypto.bls12_381 as jo
import lighthouse_tpu.ops.bls12_381 as jk
from lighthouse_tpu.crypto.bls12_381 import (
    Fp2, G1_GENERATOR, G2_GENERATOR, P, g2_compress, hash_to_g2, pairing,
    sign, sk_to_pk,
)
from lighthouse_tpu.crypto.bls12_381 import fields as jf
from lighthouse_tpu.crypto.bls12_381 import hash_to_curve as jh
from lighthouse_tpu.crypto.bls12_381.curve import B_G2, G2Point, R
from lighthouse_tpu.crypto.bls12_381.hash_to_curve import DST_POP
from lighthouse_tpu.crypto.bls12_381.pairing import miller_loop
from lighthouse_tpu.ops import bigint as jbi
from lighthouse_tpu_torch import convert
from lighthouse_tpu_torch.crypto import bls12_381 as port_oracle
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.ops import bigint as tbi
from lighthouse_tpu_torch.ops import bls12_381 as tk
from lighthouse_tpu_torch.ops import bls_consts
from lighthouse_tpu_torch.ops import bls_cost as cost
from lighthouse_tpu_torch.kernels import CSRC


@pytest.fixture(autouse=True)
def cpu_device():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _rand_mont(seed, *shape):
    """Seeded field elements, Montgomery limbs [*shape, 32] (numpy)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    return tk.fp_encode(vals).reshape(*shape, 32)


def _t(arr):
    return convert.limbs_from_numpy(arr)


def _same(got, want_jax):
    want = np.asarray(jbi.canonical(np.asarray(want_jax)))
    np.testing.assert_array_equal(
        convert.limbs_to_numpy(tbi.canonical(got)), want)


def _rows(fn, *args):
    """``fn(*args)`` and the field products its plain version computed."""
    tbi.MONT_MUL_ROWS.reset()
    out = fn(*args)
    return out, tbi.MONT_MUL_ROWS.rows


# -- tower: against the JAX package's eager functions -----------------------

def test_tower_matches_jax():
    """Each tower op equals the JAX one; its plain version computes the
    products of the kernel's formula (ops/bls_cost.py), three lanes, but
    for the Fp6 inverse's three squares, which the plain version (as the
    JAX one) takes as general Fp2 products: one more Fp product each."""
    # one batch size throughout, so the JAX side compiles each of its
    # field programs (and the inversion's scan) once
    a, b = _rand_mont(1, 3, 2), _rand_mont(2, 3, 2)
    c, d = _rand_mont(3, 3, 3, 2), _rand_mont(4, 3, 3, 2)
    e, f = _rand_mont(5, 3, 2, 3, 2), _rand_mont(6, 3, 2, 3, 2)
    g = _rand_mont(7, 3, 3, 2)
    checks = [
        (tk.fp2_mul, jk.fp2_mul, (a, b), cost.FP2_MUL),
        (tk.fp2_square, jk.fp2_square, (a,), cost.FP2_SQR),
        (tk.fp2_inv, jk.fp2_inv, (a,), cost.FP2_INV),
        (tk.fp6_mul, jk.fp6_mul, (c, d), cost.FP6_MUL),
        (tk.fp6_inv, jk.fp6_inv, (c,), cost.FP6_INV + 3),
        (tk.fp12_mul, jk.fp12_mul, (e, f), cost.FP12_MUL),
        (tk.fp12_square, jk.fp12_square, (e,), cost.FP12_SQR),
        (tk.fp12_inv, jk.fp12_inv, (e,), cost.FP12_INV + 3),
        (tk.fp12_mul_by_014, jk.fp12_mul_by_014, (e, g[0], g[1], g[2]),
         cost.FP12_MUL_BY_014),
    ] + [(lambda x, n=n: tk.fp12_frobenius(x, n),
          lambda x, n=n: jk.fp12_frobenius(x, n), (e,), cost.FP12_FROB)
         for n in (1, 2, 3)]
    for port_fn, jax_fn, args, plain_muls in checks:
        got, rows = _rows(port_fn, *(_t(v) for v in args))
        assert rows == 3 * plain_muls
        _same(got, jax_fn(*args))


# -- the oracle copy and the constants header, against the JAX package ------

def _code(path: Path) -> str:
    """A module's code with its docstrings left out."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_oracle_copy_is_the_jax_packages():
    """The port's crypto/bls12_381/ is the JAX package's oracle, module for
    module (docstrings aside), so a constant taken from the copy is the
    oracle's."""
    ours = Path(port_oracle.__file__).parent
    theirs = Path(jo.__file__).parent
    names = sorted(p.name for p in theirs.glob("*.py"))
    assert names == sorted(p.name for p in ours.glob("*.py"))
    for name in names:
        assert _code(ours / name) == _code(theirs / name), name


def _header_values(text: str) -> dict[str, list[int]]:
    """Name -> values of every constant array and #define in a header."""
    out = {}
    for m in re.finditer(r"__constant__ uint(?:32|8)_t (\w+)[^=]*=\s*"
                         r"\{(.*?)\};", text, re.S):
        out[m.group(1)] = [int(v, 0) for v in
                           re.findall(r"0x[0-9a-f]+|\b\d+\b", m.group(2))]
    for m in re.finditer(r"#define (\w+) (0x[0-9a-f]+|\d+)", text):
        out[m.group(1)] = [int(m.group(2), 0)]
    return out


def _words(v: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]


def _mont(v) -> list[int]:
    return _words(int(v) % P * 2**384 % P)


def _mont2(v) -> list[int]:
    return _mont(v.c0) + _mont(v.c1)


def _from_words(ws: list[int]) -> int:
    return sum(w << (32 * i) for i, w in enumerate(ws))


def _digit_packs(v: int) -> list[int]:
    """v's 64 six-bit digits reversed and packed for alignments 0..66:
    byte j of pack s is digit s - j (the digit-space fp_mul's constants)."""
    d = [(v >> (6 * i)) & 63 for i in range(64)]
    return [sum((d[s - j] if 0 <= s - j < 64 else 0) << (8 * j)
                for j in range(4)) for s in range(67)]


def test_cuda_constants_header_matches_oracle():
    """consts.cuh is render()'s output, and every constant in it is the
    one derived here from the JAX package's oracle (psi's by its defining
    property on the G2 generator)."""
    text = bls_consts.render()
    assert (CSRC / "bls" / "consts.cuh").read_text() == text
    got = _header_values(text)
    x = jf.X_PARAM
    xi = jf.XI
    want = {
        "LH_N0INV": [(-pow(P, -1, 2**32)) % 2**32],
        "LH_P": _words(P), "LH_2P": _words(2 * P), "LH_ONE": _mont(1),
        "LH_HALF_P_INT": _words((P - 1) // 2),
        "LH_EXP_SQRT": _words((P - 3) // 4),
        "LH_EXP_LEGENDRE": _words((P - 1) // 2),
        "LH_TWO_INV": _mont(pow(2, -1, P)),
        "LH_B_TWIST_3": _mont2(B_G2 * Fp2(3, 0)),
        "LH_B_G2": _mont2(B_G2),
        "LH_FROB": [w for n in (1, 2, 3) for k in range(6)
                    for w in _mont2(xi.pow((P**n - 1) // 6).pow(k))],
        "LH_H2C_A": _mont2(jh.ISO_A), "LH_H2C_B": _mont2(jh.ISO_B),
        "LH_H2C_Z": _mont2(jh.SSWU_Z),
        "LH_H2C_NBA": _mont2(-jh.ISO_B * jh.ISO_A.inv()),
        "LH_H2C_X1EXC": _mont2(jh.ISO_B * (jh.SSWU_Z * jh.ISO_A).inv()),
        "LH_ISO_XN": [w for v in jh.ISO_X_NUM for w in _mont2(v)],
        "LH_ISO_XD": [w for v in jh.ISO_X_DEN for w in _mont2(v)],
        "LH_ISO_YN": [w for v in jh.ISO_Y_NUM for w in _mont2(v)],
        "LH_ISO_YD": [w for v in jh.ISO_Y_DEN for w in _mont2(v)],
        "LH_R2": _mont(2**768),
        "LH_R2_MOD_P": _words(2**768 % P),
        "LH_X_ABS": [abs(x)],
        "LH_X13": [(abs(x) + 1) // 3],
        "LH_BP_K1_HI": [(x * x - x - 1) >> 64],
        "LH_BP_K1_LO": [(x * x - x - 1) & (2**64 - 1)],
        "LH_BP_K2": [abs(x - 1)],
        "LH_NPRIME_DREV": _digit_packs((-pow(P, -1, 2**384)) % 2**384),
        "LH_P_DREV": _digit_packs(P),
    }
    assert sorted(got) == sorted([*want, "LH_H2C_PSI_CX", "LH_H2C_PSI_CY"])
    for name, vals in want.items():
        assert got[name] == vals, name

    def fp2(name):
        ws = got[name]
        r_inv = pow(2**384, -1, P)
        return Fp2(_from_words(ws[:12]) * r_inv % P,
                   _from_words(ws[12:]) * r_inv % P)

    gx, gy = G2_GENERATOR.to_affine()
    px = fp2("LH_H2C_PSI_CX") * Fp2(int(gx.c0), -int(gx.c1) % P)
    py = fp2("LH_H2C_PSI_CY") * Fp2(int(gy.c0), -int(gy.c1) % P)
    ux, uy = G2_GENERATOR.mul(abs(x)).neg().to_affine()   # [x]Q, x < 0
    assert (px, py) == (ux, uy)


# -- stages: against the pure-Python oracle ---------------------------------

def _enc_g1(points):
    xs, ys = zip(*(p.to_affine() for p in points))
    return (_t(tk.fp_encode([int(v) for v in xs])),
            _t(tk.fp_encode([int(v) for v in ys])))


def _enc_g2(points):
    xs, ys = zip(*(p.to_affine() for p in points))
    return _t(tk.fp2_encode(xs)), _t(tk.fp2_encode(ys))


def _fp2_ints(v):
    return [int(v.c0), int(v.c1)]


def _f12_ints(e):
    out = []
    for c6 in (e.c0, e.c1):
        for c2 in (c6.c0, c6.c1, c6.c2):
            out += _fp2_ints(c2)
    return out


def test_scalar_muls_and_affine_match_oracle():
    scalars = [3, 7, 0, 2**63 - 25]
    n = len(scalars)
    bits = tk.scalars_to_bits(scalars, 64)
    x, y = _enc_g1([G1_GENERATOR] * n)
    z = _t(np.broadcast_to(tk.FP_ONE, (n, 32)))
    (sx, sy, sz), rows1 = _rows(tk.g1_scalar_mul, x, y, z, bits)
    (ax, ay), rows_a1 = _rows(tk.jacobian_to_affine_fp, sx, sy, sz)
    x2, y2 = _enc_g2([G2_GENERATOR] * n)
    z2 = _t(np.broadcast_to(tk.FP2_ONE, (n, 2, 32)))
    (tx, ty, tz), rows2 = _rows(tk.g2_scalar_mul, x2, y2, z2, bits)
    (bx, by), rows_a2 = _rows(tk.jacobian_to_affine_fp2, tx, ty, tz)
    # the kernel doubles every bit and adds on set bits; the plain version
    # adds (with its doubling fallback) on every bit and selects
    for d, rows in ((1, rows1), (2, rows2)):
        assert cost.scalar_mul(bits, d) == bits.size * cost.DBL[d] + \
            sum(bin(s).count("1") for s in scalars) * cost.ADD[d]
        assert rows == bits.size * (2 * cost.DBL[d] + cost.ADD[d])
    # the plain inverse is the Fermat power (the kernel's is binary), and
    # the plain G2 affine squares 1/Z with the Fp2 square (2, not 3)
    fermat = n * (cost.FP_INV - cost.FP_INV_BINARY)
    assert (rows_a1, rows_a2) == (cost.affine(n, 1) + fermat,
                                  cost.affine(n, 2) + fermat - n)
    for i, s in enumerate(scalars):
        if s == 0:                      # infinity: z = 0, affine (0, 0)
            assert tk.fp_decode(sz[i]) == [0]
            assert tk.fp_decode(ax[i]) == [0] == tk.fp_decode(ay[i])
            assert tk.fp_decode(tz[i]) == [0, 0]
            continue
        w1 = G1_GENERATOR.mul(s).to_affine()
        assert tk.fp_decode(ax[i]) + tk.fp_decode(ay[i]) == \
            [int(w1[0]), int(w1[1])]
        w2 = G2_GENERATOR.mul(s).to_affine()
        assert tk.fp_decode(bx[i]) + tk.fp_decode(by[i]) == \
            _fp2_ints(w2[0]) + _fp2_ints(w2[1])
    # the G2 aggregate of the four (one at infinity)
    (gx, gy, gz), rows = _rows(tk.g2_sum, tx, ty, tz)
    # the kernel's tree adds the n points n - 1 times; the plain version's
    # JAX layout adds one row onto infinity, then the 4 partials (2n adds,
    # each with its doubling fallback)
    assert cost.g2_sum(n) == (n - 1) * cost.ADD[2]
    assert rows == (n + n) * (cost.ADD[2] + cost.DBL[2])
    ax2, ay2 = tk.jacobian_to_affine_fp2(gx, gy, gz)
    w = G2_GENERATOR.mul(sum(scalars)).to_affine()
    assert tk.fp_decode(ax2) + tk.fp_decode(ay2) == \
        _fp2_ints(w[0]) + _fp2_ints(w[1])


@pytest.mark.parametrize("degree", [1, 2])
def test_affine_bound_counts_one_batch_inversion(degree):
    """bls_cost.affine_least counts Montgomery's batch inversion over the
    lanes whose z is not 0: run here on Python integers, counting its
    products (an Fp2 product is 3), it inverts every such lane with one
    inverse (4 products in Fp2 around the Fp one, 1 in Fp), and the
    bound's count equals the run's; the kernel's own count (an inverse a
    lane) is larger."""
    P = cost.P
    rng = np.random.default_rng(degree)
    n = 9
    vals = [int(v) for v in rng.integers(1, 2**62, size=n * degree)]
    vals[degree * 3:degree * 4] = [0] * degree            # lane 3 at infinity
    z = tk.fp_encode(vals).reshape((n, 32) if degree == 1 else (n, 2, 32))
    lanes = [tuple(vals[i * degree:(i + 1) * degree]) for i in range(n)]
    count = [0]

    def mul(a, b):
        count[0] += 1 if degree == 1 else cost.FP2_MUL
        if degree == 1:
            return (a[0] * b[0] % P,)
        return ((a[0] * b[0] - a[1] * b[1]) % P,
                (a[0] * b[1] + a[1] * b[0]) % P)

    def inv(a):
        if degree == 1:
            count[0] += cost.FP_INV_BINARY
            return (pow(a[0], -1, P),)
        count[0] += cost.FP2_INV_BINARY
        t = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
        return (a[0] * t % P, -a[1] * t % P)

    live = [a for a in lanes if any(a)]
    prefix = [live[0]]
    for a in live[1:]:
        prefix.append(mul(prefix[-1], a))
    acc, invs = inv(prefix[-1]), [None] * len(live)
    for i in range(len(live) - 1, 0, -1):
        invs[i] = mul(acc, prefix[i - 1])
        acc = mul(acc, live[i])
    invs[0] = acc
    per_lane = 4 * len(live) * (1 if degree == 1 else cost.FP2_MUL)
    products, words = cost.affine_least(z, degree)
    assert products == count[0] + per_lane
    one = (1,) if degree == 1 else (1, 0)
    assert all(mul(a, b) == one for a, b in zip(live, invs))
    norm = prefix[-1][0] if degree == 1 else \
        (prefix[-1][0] ** 2 + prefix[-1][1] ** 2) % P
    assert words == cost.binary_inverse_word_ops(norm * (1 << 384) % P) > 0
    assert products * cost.FP_MUL_INT_OPS + words \
        < cost.affine_int_ops(z, degree)


def test_segment_sum_matches_oracle():
    # segments [1G, 2G] [3G] [4G, 5G, 6G]; a padding group points at lane 0
    x, y = _enc_g1([G1_GENERATOR.mul(i + 1) for i in range(6)])
    z = _t(np.broadcast_to(tk.FP_ONE, (6, 32)))
    starts = np.array([1, 0, 1, 1, 0, 0], np.int32)
    ends = np.array([1, 2, 5, 0], np.int32)
    (ox, oy, oz), rows = _rows(tk.g1_segment_sum, x, y, z, starts, ends)
    # each range of L lanes is L - 1 additions (1 + 0 + 2 + 0), in the
    # kernel's trees and in the plain version's (which computes each
    # addition's doubling too)
    assert cost.g1_segment_sum(starts, ends) == 3 * cost.ADD[1]
    assert rows == 3 * (cost.ADD[1] + cost.DBL[1])
    assert cost.g1_segment_sum_depth(starts, ends) == 2
    ax, ay = tk.jacobian_to_affine_fp(ox, oy, oz)
    for g, s in enumerate([3, 3, 15, 1]):
        w = G1_GENERATOR.mul(s).to_affine()
        assert tk.fp_decode(ax[g]) + tk.fp_decode(ay[g]) == \
            [int(w[0]), int(w[1])]


def test_miller_loop_product_and_final_exp_match_oracle():
    pairs = [(G1_GENERATOR.mul(3), G2_GENERATOR.mul(5)),
             (G1_GENERATOR.mul(2), G2_GENERATOR.mul(9))]
    # a third lane repeats the first and is masked: it gives the identity
    px, py = _enc_g1([p for p, _ in pairs] + [pairs[0][0]])
    qx, qy = _enc_g2([q for _, q in pairs] + [pairs[0][1]])
    mask = np.array([True, True, False])
    fs, rows = _rows(tk.miller_loop_batch, px, py, qx, qy, mask)
    assert cost.miller_loop(mask) == 2 * cost.MILLER_LANE
    assert rows == 3 * cost.MILLER_LANE     # the plain loop runs every lane
    assert tk.fp_decode(fs[2]) == tk.fp_decode(tk.fp12_one_like((), fs))
    prod, rows = _rows(tk.fp12_product, fs)
    assert rows == 2 * cost.FP12_MUL
    assert cost.final_exp(3, 0) == (3 - 1) * cost.FP12_MUL
    assert tk.fp_decode(prod) == _f12_ints(miller_loop(pairs))
    out, rows = _rows(tk.final_exponentiation, fs[0])
    # + 3: the plain Fp6 inverse's squares (test_tower_matches_jax); the
    # plain Fp inverse is fp_pow by p - 2, the kernel's binary (one product)
    assert rows == cost.FINAL_EXP + 3 + cost.FP_INV - cost.FP_INV_BINARY
    assert cost.final_exp(1, 1) == 0 * cost.FP12_MUL + cost.FINAL_EXP
    assert tk.fp_decode(out) == _f12_ints(pairing(*pairs[0]))


def test_pairing_check_verifies_signature_both_polarities():
    sk = 3
    msg = b"\x5a" * 32
    sig, pk = sign(sk, msg), sk_to_pk(sk)
    px, py = _enc_g1([G1_GENERATOR.neg(), pk])
    qx, qy = _enc_g2([sig, hash_to_g2(msg)])
    assert tk.pairing_check_batch(px, py, qx, qy) is True
    qx2, qy2 = _enc_g2([sig, hash_to_g2(b"\x5b" * 32)])
    assert tk.pairing_check_batch(px, py, qx2, qy2) is False


def _compressed_x(points):
    xs, flags = [], []
    for p in points:
        cb = g2_compress(p)
        xs += [int.from_bytes(cb[48:96], "big"),
               int.from_bytes(bytes([cb[0] & 0x1f]) + cb[1:48], "big")]
        flags.append(bool(cb[0] & 0x20))
    return _t(tk.fp_encode(xs).reshape(len(points), 2, 32)), np.array(flags)


def test_decompress_and_subgroup_match_oracle():
    pts = [sign(100 + i, bytes([i]) * 32) for i in range(3)]
    x, flags = _compressed_x(pts)
    (y, ok), rows = _rows(tk.g2_decompress_batch, x, flags)
    assert rows == cost.g2_decompress(3)
    assert bool(ok.all())
    yl = tk.fp_decode(y)
    for i, p in enumerate(pts):
        assert yl[2 * i:2 * i + 2] == _fp2_ints(p.to_affine()[1])
    one2 = _t(np.broadcast_to(tk.FP2_ONE, (3, 2, 32)))
    ok, rows = _rows(tk.g2_in_subgroup_batch, x, y, one2)
    assert ok.tolist() == [True] * 3
    # the plain version's adds in [|x|]Q also compute the fallback
    assert rows == cost.g2_subgroup([False] * 3, [True] * 3) + \
        3 * bin(abs(jf.X_PARAM)).count("1") * cost.DBL[2]
    # x with no point on the curve
    def rhs(v):
        return Fp2(v, 0) * Fp2(v, 0) * Fp2(v, 0) + B_G2

    xx = 1
    while rhs(xx).sqrt() is not None:
        xx += 1
    _, bad = tk.g2_decompress_batch(_t(tk.fp2_encode([Fp2(xx, 0)])),
                                    np.array([True]))
    assert bad.tolist() == [False]
    # an on-curve point outside the subgroup is rejected
    xx = 1
    while rhs(xx).sqrt() is None:
        xx += 1
    yy = rhs(xx).sqrt()
    assert not G2Point(Fp2(xx, 0), yy).mul(R).is_infinity()
    out = tk.g2_in_subgroup_batch(_t(tk.fp2_encode([Fp2(xx, 0)])),
                                  _t(tk.fp2_encode([yy])), one2[:1])
    assert out.tolist() == [False]


def test_hash_to_g2_matches_oracle():
    msgs = [b"", b"abc"]
    u0, u1 = tk.hash_to_field_host(msgs, DST_POP)
    (x, y, z), rows = _rows(tk.hash_to_g2_batch_from_u, _t(u0), _t(u1))
    # five Jacobian adds a message, each with the fallback on the plain side
    adds = 3 + sum(bin(v).count("1") for v in (abs(jf.X_PARAM) ** 2 +
                                               abs(jf.X_PARAM) - 1,
                                               abs(jf.X_PARAM) + 1))
    # each map: the plain inverse and Legendre symbol are powers (the
    # kernel's are binary), and the plain square root checks y^2
    plain_map = (cost.FP_INV - cost.FP_INV_BINARY + cost.FP_LEGENDRE
                 + cost.FP2_SQR)
    assert rows == (cost.hash_to_g2(2) + 2 * adds * cost.DBL[2]
                    + 2 * 2 * plain_map)
    ax, ay = tk.jacobian_to_affine_fp2(x, y, z)
    axl, ayl = tk.fp_decode(ax), tk.fp_decode(ay)
    for i, m in enumerate(msgs):
        X, Y = hash_to_g2(m).to_affine()
        assert axl[2 * i:2 * i + 2] + ayl[2 * i:2 * i + 2] == \
            _fp2_ints(X) + _fp2_ints(Y)


def test_host_helpers_match_jax():
    vals = [0, 1, P - 1, 12345]
    np.testing.assert_array_equal(tk.fp_encode(vals),
                                  np.asarray(jk.fp_encode(vals)))
    assert tk.fp_decode(tk.fp_encode(vals)) == vals
    np.testing.assert_array_equal(tk.scalars_to_bits([5, 2**63], 64),
                                  jk.scalars_to_bits([5, 2**63], 64))
    for a, b in zip(tk.hash_to_field_host([b"x"], DST_POP),
                    jk.hash_to_field_host([b"x"], DST_POP)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_stage_wrappers_refuse_mixed_devices():
    x = _t(_rand_mont(8, 2, 2))
    with pytest.raises(ValueError):
        tk.g2_in_subgroup_batch(x, x, torch.zeros((2, 2, 32),
                                                  dtype=torch.int32,
                                                  device="meta"))


# -- the digit multiply lowerings (modes 1, 2) and fp12_pow_const ----------

def _rand_fp2(seed, n):
    rng = np.random.default_rng(seed)
    return [Fp2(int.from_bytes(rng.bytes(48), "little") % P,
                int.from_bytes(rng.bytes(48), "little") % P)
            for _ in range(n)]


@pytest.mark.parametrize("mode", [1, 2])
def test_digit_modes_through_curve_ops(mode):
    """The port of tests/test_bls_kernel.py's digit-mode test: under
    LHTPU_BIGINT_MXU modes 1 and 2 the tower and curve layers (Fp2
    product and inverse, a G1 scalar multiply and its affine form) equal
    the oracle, on the plain versions (four and two lanes)."""
    a, b = _rand_fp2(21, 4), _rand_fp2(22, 4)
    try:
        tbi.set_mxu_mode(mode)
        prod = tk.fp2_mul(_t(tk.fp2_encode(a)), _t(tk.fp2_encode(b)))
        inv = tk.fp2_inv(_t(tk.fp2_encode(a)))
        for i in range(4):
            want = a[i] * b[i]
            assert tk.fp_decode(prod[i]) == _fp2_ints(want)
            assert tk.fp_decode(inv[i]) == _fp2_ints(a[i].inv())
        scalars = [5, 2**61 - 1]
        x, y = _enc_g1([G1_GENERATOR] * 2)
        z = _t(np.broadcast_to(tk.FP_ONE, (2, 32)))
        sx, sy, sz = tk.g1_scalar_mul(x, y, z,
                                      tk.scalars_to_bits(scalars, 64))
        ax, ay = tk.jacobian_to_affine_fp(sx, sy, sz)
        for i, sc in enumerate(scalars):
            w = G1_GENERATOR.mul(sc).to_affine()
            assert tk.fp_decode(ax[i]) + tk.fp_decode(ay[i]) == \
                [int(w[0]), int(w[1])]
    finally:
        tbi.set_mxu_mode(0)


@pytest.mark.parametrize("exponent", [0b1011, jf.X_PARAM * -1])
def test_fp12_pow_const_matches_oracle(exponent):
    """fp12_pow_const (plain version) equals the oracle's Fp12 power on
    two lanes, at a small exponent and at |x| (the BLS parameter); its
    field products are bls_cost.fp12_pow's (the plain version, like the
    kernel, skips the product on unset bits)."""
    c = _rand_fp2(23, 12)
    vals = [jo.Fp12(jo.Fp6(*c[6 * i:6 * i + 3]), jo.Fp6(*c[6 * i + 3:6 * i + 6]))
            for i in range(2)]
    f = _t(tk.fp_encode([v for e in vals for v in _f12_ints(e)])
           .reshape(2, 2, 3, 2, 32))
    got, rows = _rows(tk.fp12_pow_const, f, exponent)
    assert rows == cost.fp12_pow(2, exponent)
    for i, e in enumerate(vals):
        assert tk.fp_decode(got[i]) == _f12_ints(e.pow(exponent))
    # exponent 0 gives f back, as the JAX scan over no bits does
    assert torch.equal(tk.fp12_pow_const(f, 0), f)


# -- the final exponentiation's x-chain (plain versions) --------------------

def _rand_f12(seed, n):
    """n seeded Fp12 values: oracle values and the [n, 2, 3, 2, 32]
    tensor."""
    c = _rand_fp2(seed, 6 * n)
    vals = [jo.Fp12(jo.Fp6(*c[6 * i:6 * i + 3]),
                    jo.Fp6(*c[6 * i + 3:6 * i + 6])) for i in range(n)]
    f = _t(tk.fp_encode([v for e in vals for v in _f12_ints(e)])
           .reshape(n, 2, 3, 2, 32))
    return vals, f


def _easy_part(f):
    """f^((p^6-1)(p^2+1)): an element of the cyclotomic subgroup."""
    g = tk.fp12_mul(tk.fp12_conj(f), tk.fp12_inv(f))
    return tk.fp12_mul(tk.fp12_frobenius(g, 2), g)


def test_cyclotomic_square_matches_square():
    """Granger-Scott squares equal fp12_square on cyclotomic elements
    (two, made by the easy part from random Fp12), with 9 Fp2 squares
    each (bls_cost.FP12_CYC_SQR); on a random Fp12 they do not."""
    _, f = _rand_f12(31, 2)
    g = _easy_part(f)
    got, rows = _rows(tk.fp12_cyclotomic_square, g)
    assert rows == 2 * cost.FP12_CYC_SQR
    _same(got, np.asarray(convert.limbs_to_numpy(tk.fp12_square(g))))
    assert not bool(torch.all(tk.fp12_eq(tk.fp12_cyclotomic_square(f),
                                         tk.fp12_square(f))))


@pytest.mark.parametrize("exponent", [tk._X_ABS, tk._X13])
def test_cyclotomic_pow_matches_fp12_pow_const(exponent):
    """The x-chain's powers (by |x| and by (|x|+1)/3, with cyclotomic
    squares) equal fp12_pow_const by the same exponent on cyclotomic
    elements; their products are the chain's count."""
    _, f = _rand_f12(32, 2)
    g = _easy_part(f)
    got, rows = _rows(tk._cyclotomic_pow_plain, g, exponent)
    assert rows == 2 * cost._pow(exponent, cost.FP12_CYC_SQR,
                                 cost.FP12_MUL)
    _same(got, np.asarray(convert.limbs_to_numpy(
        tk._fp12_pow_const_plain(g, exponent))))


def test_final_exponentiation_matches_oracle():
    """The plain final exponentiation (easy part, then the x-chain) equals
    the JAX package's oracle final exponentiation (f^((p^12-1)/r), the
    value its base-p scan computes) on two random Fp12 values; (x - 1) is
    divisible by 3 and the chain's exponent is (p^4 - p^2 + 1)/r."""
    from lighthouse_tpu.crypto.bls12_381.pairing import final_exponentiation
    x = jf.X_PARAM
    assert (x - 1) % 3 == 0
    assert ((x - 1) ** 2 // 3 * (x + P) * (x * x + P * P - 1) + 1
            == (P ** 4 - P ** 2 + 1) // R)
    vals, f = _rand_f12(33, 2)
    for i, v in enumerate(vals):
        assert tk.fp_decode(tk._final_exponentiation_plain(f[i])) == \
            _f12_ints(final_exponentiation(v))
