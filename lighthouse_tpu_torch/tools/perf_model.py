"""Measure exact per-signature arithmetic op counts (PERF_MODEL.md §1).

Every field multiplication of the port's plain versions funnels through
one plain Montgomery product, which counts its rows and calls
(``ops.bigint.MONT_MUL_ROWS``). This runs each stage of the BLS
verification pipeline on its plain version at batch 1 on the CPU, where
the loops run their true step counts, and reads the counter after each.
The counts are in the JAX tool's units: ``fp_muls`` are column products
(a Montgomery product is three: 32x64, 32x32 and 32x64 limb columns),
``int32_muls`` their int32 multiply-adds (5,120 a Montgomery product),
``calls`` the column-product calls (three a plain ``mont_mul`` call over
its whole batch). Normalize/carry overhead is modeled separately in
PERF_MODEL.md from static analysis.

Run:  python -m lighthouse_tpu_torch.tools.perf_model
"""
from __future__ import annotations

import json

import numpy as np

#: limb columns of the three products of one Montgomery product (a x b,
#: the low half x n', the reduction x p)
_COLUMNS = (64, 32, 64)

STAGES = ["decompress", "subgroup", "hash_to_g2", "affine_msg",
          "rlc_g1", "rlc_g2", "g2_sum", "affine_misc",
          "miller_1pair", "fp12_product", "final_exp"]
PER_LANE = ["decompress", "subgroup", "hash_to_g2", "affine_msg",
            "rlc_g1", "rlc_g2", "miller_1pair"]
SHARED = ["g2_sum", "affine_misc", "fp12_product", "final_exp"]


def _count() -> dict:
    from ..ops import bigint as bi
    rows, calls = bi.MONT_MUL_ROWS.rows, bi.MONT_MUL_ROWS.calls
    return {"fp_muls": rows * len(_COLUMNS),
            "int32_muls": rows * bi.NLIMBS * sum(_COLUMNS),
            "calls": calls * len(_COLUMNS)}


def measure() -> dict:
    """{"per_stage", "per_lane_total", "shared_total"} for one signature
    set through the plain versions on the CPU."""
    import torch

    from .. import device
    from ..crypto.bls12_381 import G1_GENERATOR, g2_compress, sig as osig
    from ..crypto.bls12_381.hash_to_curve import DST_POP
    from ..ops import bigint as bi
    from ..ops import bls12_381 as k

    prev = device.set_device("cpu")
    try:
        def t(arr):
            return torch.from_numpy(np.array(arr))

        stages = {}

        def snap(name):
            stages[name] = _count()

        pt = osig.sign(7, b"\x01" * 32)
        cb = g2_compress(pt)
        c1 = int.from_bytes(bytes([cb[0] & 0x1f]) + cb[1:48], "big")
        c0 = int.from_bytes(cb[48:96], "big")
        flags = np.array([bool(cb[0] & 0x20)])

        with torch.inference_mode():
            sig_x = t(k.fp_encode([c0, c1]).reshape(1, 2, bi.NLIMBS))
            one2 = t(np.broadcast_to(k.FP2_ONE, (1, 2, bi.NLIMBS)))
            one1 = t(np.broadcast_to(k.FP_ONE, (1, bi.NLIMBS)))
            bi.MONT_MUL_ROWS.reset()
            snap("t0")

            sig_y, ok = k.g2_decompress_batch(sig_x, flags)
            assert bool(ok.all())
            snap("decompress")

            assert bool(k.g2_in_subgroup_batch(sig_x, sig_y, one2).all())
            snap("subgroup")

            u0, u1 = k.hash_to_field_host([b"\x01" * 32], DST_POP)
            mx, my, mz = k.hash_to_g2_batch_from_u(t(u0), t(u1))
            snap("hash_to_g2")

            msg_x, msg_y = k.jacobian_to_affine_fp2(mx, my, mz)
            snap("affine_msg")

            gx, gy = G1_GENERATOR.to_affine()
            pk_x = t(k.fp_encode([int(gx)]))
            pk_y = t(k.fp_encode([int(gy)]))
            bits = t(k.scalars_to_bits([(1 << 63) | 12345], 64))
            spx, spy, spz = k.g1_scalar_mul(pk_x, pk_y, one1, bits)
            snap("rlc_g1")

            ssx, ssy, ssz = k.g2_scalar_mul(sig_x, sig_y, one2, bits)
            snap("rlc_g2")

            ax, ay, az = k.g2_sum(ssx, ssy, ssz)
            snap("g2_sum")

            apx, apy = k.jacobian_to_affine_fp(spx, spy, spz)
            k.jacobian_to_affine_fp2(ax[None], ay[None], az[None])
            snap("affine_misc")

            fs = k.miller_loop_batch(apx, apy, msg_x, msg_y)
            snap("miller_1pair")

            prod = k.fp12_product(fs)
            snap("fp12_product")

            k.final_exponentiation(prod)
            snap("final_exp")
    finally:
        device.set_device(prev)

    keys = stages["t0"].keys()
    rows, prev_name = {}, "t0"
    for name in STAGES:
        rows[name] = {key: stages[name][key] - stages[prev_name][key]
                      for key in keys}
        prev_name = name
    return {"per_stage": rows,
            "per_lane_total": {key: sum(rows[n][key] for n in PER_LANE)
                               for key in keys},
            "shared_total": {key: sum(rows[n][key] for n in SHARED)
                             for key in keys}}


def main() -> int:
    print(json.dumps(measure(), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
