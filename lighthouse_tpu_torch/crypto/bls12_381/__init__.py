"""Pure-Python BLS12-381 reference implementation.

The correctness oracle for the C++ host backend and the JAX/Pallas TPU
kernels (lighthouse_tpu/ops/bls12_381.py). Replaces the reference's
`blst` dependency (crypto/bls/Cargo.toml:19, asm/C) as the *reference*
backend; perf backends live elsewhere.
"""
from .fields import P, R, Fp, Fp2, Fp6, Fp12, FP2_ONE, FP2_ZERO
from .curve import (
    G1Point, G2Point, G1_GENERATOR, G2_GENERATOR, g1_mul, g2_mul,
    H_EFF_G1, H_EFF_G2,
)
from .pairing import pairing, multi_pairing, miller_loop, final_exponentiation
from .hash_to_curve import hash_to_g2, expand_message_xmd, DST_POP
from .sig import (
    sk_to_pk, sign, verify, aggregate_signatures, aggregate_pubkeys,
    fast_aggregate_verify, aggregate_verify, verify_signature_sets_rlc,
    g1_compress, g1_decompress, g2_compress, g2_decompress,
    keygen_interop,
)
