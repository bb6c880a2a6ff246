"""The BLS12-381 constants of the CUDA kernels, rendered from the oracle.

``csrc/bls/consts.cuh`` holds the field, tower, curve and hash-to-curve
constants as ``__constant__`` arrays of 32-bit words (little-endian,
Montgomery form with R = 2^384 where the value is a field element). It is
generated from the pure-Python oracle and the plain module's own tables,
and committed; tests/test_torch_bls_kernel.py checks that the file equals
``render()``. Regenerate with

    python -m lighthouse_tpu_torch.ops.bls_consts > \\
        lighthouse_tpu_torch/csrc/bls/consts.cuh
"""
from __future__ import annotations

from . import bigint as bi
from . import bls12_381 as k

P = bi.P_INT
R = bi.R_INT


def _words(v: int) -> list[int]:
    assert 0 <= v < 1 << 384
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]


def _mont(v: int) -> list[int]:
    return _words(v % P * R % P)


def _fp(name: str, words: list[int]) -> str:
    body = ", ".join(f"0x{w:08x}u" for w in words)
    return f"__constant__ uint32_t {name}[12] = {{{body}}};"


def _table(name: str, dims: tuple, words: list[list[int]]) -> str:
    """A constant array [*dims][12], fully braced (one row a line)."""
    rows = ["{" + ", ".join(f"0x{w:08x}u" for w in ws) + "}" for ws in words]
    for d in reversed(dims[1:]):
        rows = ["{" + ",\n     ".join(rows[i:i + d]) + "}"
                for i in range(0, len(rows), d)]
    shape = "".join(f"[{d}]" for d in dims)
    body = ",\n    ".join(rows)
    return f"__constant__ uint32_t {name}{shape}[12] = {{\n    {body}}};"


def _digits_rev(v: int) -> list[int]:
    """The 6-bit digits of v reversed and packed for each alignment s in
    0..66: byte j of word s is digit s - j (zero outside 0..63)."""
    d = [(v >> (6 * i)) & 63 for i in range(bi.NDIGITS)]
    return [sum((d[s - j] if 0 <= s - j < bi.NDIGITS else 0) << (8 * j)
                for j in range(4)) for s in range(bi.NDIGITS + 3)]


def _packs(name: str, words: list[int]) -> str:
    rows = [", ".join(f"0x{w:08x}u" for w in words[i:i + 6])
            for i in range(0, len(words), 6)]
    body = ",\n    ".join(rows)
    return f"__constant__ uint32_t {name}[{len(words)}] = {{\n    {body}}};"


def _limb_words(arr) -> list[int]:
    return _words(bi.from_limbs(arr))


def _fp2_words(arr) -> list[list[int]]:
    return [_limb_words(arr[0]), _limb_words(arr[1])]


def render() -> str:
    h = k._H2C
    lines = [
        "// Generated by lighthouse_tpu_torch/ops/bls_consts.py from the",
        "// pure-Python oracle; do not edit. Field elements are 12",
        "// little-endian 32-bit words, in Montgomery form (R = 2^384)",
        "// unless named as an integer.",
        "#pragma once",
        "#include <stdint.h>",
        "",
        "#define LH_N0INV 0x%08xu   // -p^-1 mod 2^32" % ((-pow(P, -1, 1 << 32)) % (1 << 32)),
        _fp("LH_P", _words(P)),
        _fp("LH_2P", _words(2 * P)),
        _fp("LH_ONE", _mont(1)),
        _fp("LH_HALF_P_INT", _words((P - 1) // 2)),
        "// R^2 in Montgomery form: fp_mul(y, LH_R2) = y R^2 (the binary",
        "// inversion's way back into the Montgomery domain)",
        _fp("LH_R2", _mont(R * R)),
        "// digit-space fp_mul (LH_FP_MODE 1, 2): N' = -p^-1 mod 2^384 and p",
        "// as reversed packs of their 6-bit digits, one for each alignment",
        _packs("LH_NPRIME_DREV", _digits_rev(bi.NPRIME)),
        _packs("LH_P_DREV", _digits_rev(P)),
        "// exponents (integers, read MSB first)",
        _fp("LH_EXP_SQRT", _words((P - 3) // 4)),
        _fp("LH_EXP_LEGENDRE", _words((P - 1) // 2)),
        "// Miller loop",
        _fp("LH_TWO_INV", _limb_words(k._TWO_INV)),
        _table("LH_B_TWIST_3", (2,), _fp2_words(k._B_TWIST_3)),
        "// G2 intake: b = 4(1+u)",
        _table("LH_B_G2", (2,), _fp2_words(k._B_G2_CONST)),
        "// Frobenius: gamma_n^k, n = 1..3 (row n-1), k = 0..5",
        _table("LH_FROB", (3, 6, 2),
               [w for n in (1, 2, 3) for j in range(6)
                for w in _fp2_words(k._FROB_GAMMA[n][j])]),
        "// hash-to-G2 (RFC 9380 SSWU + 3-isogeny; psi)",
    ]
    for name in ("A", "B", "Z", "NBA", "X1EXC", "PSI_CX", "PSI_CY"):
        lines.append(_table(f"LH_H2C_{name}", (2,), _fp2_words(h[name])))
    for name in ("XN", "XD", "YN", "YD"):
        arr = h[name]
        lines.append(_table(f"LH_ISO_{name}", (len(arr), 2),
                            [w for c in arr for w in _fp2_words(c)]))
    lines += [
        "// scalars: |x| (Miller loop, subgroup check, final",
        "// exponentiation), |(x-1)/3| (final exponentiation),",
        "// Budroni-Pintore",
        f"#define LH_X_ABS 0x{k._X_ABS:016x}ull",
        f"#define LH_X13 0x{k._X13:016x}ull",
        f"#define LH_BP_K1_HI 0x{k._BP_K1 >> 64:016x}ull",
        f"#define LH_BP_K1_LO 0x{k._BP_K1 & (2**64 - 1):016x}ull",
        f"#define LH_BP_K2 0x{k._BP_K2:016x}ull",
        "",
    ]
    return "\n".join(lines)


if __name__ == "__main__":
    print(render(), end="")
