"""Flagship-batch correctness run: n=10,000 signature sets through the
fixed-shape batch pipeline of the ``gpu`` backend, both polarities.

BASELINE.md's config 3, the 10k gossip batch, at the lane counts of
``gpu_backend.lane_options()`` (10,240 big / 128 small on the card):

  python -m lighthouse_tpu_torch.tools.bls_10k_correctness

Checks BOTH polarities — a masking bug that silently identity-masks real
lanes would pass the positive check alone: the batch verifies (cold,
then warm), and the batch with ONE mid-batch message changed is
rejected. :func:`check_batch` is the protocol, on any ``verify``
callable and any sets (``chip_smoke.py`` phase 4 runs it on its own
flagship batch).

Knobs (environment): ``LHTPU_10K_N`` (10000 sets), ``LHTPU_10K_SHARED``
(spread the sets over that many distinct messages; default all
distinct), ``LHTPU_10K_FAST`` (one pass, no negative), ``LHTPU_BLS_LANES``
/ ``LHTPU_BLS_SMALL`` (the lane counts). Prints one JSON line; writes it
to a file only where ``LHTPU_10K_OUT`` names one.
"""
from __future__ import annotations

import json
import os
import time

N = int(os.environ.get("LHTPU_10K_N", "10000"))


def spoil_one(sets):
    """The batch with its middle set's message changed: it must fail."""
    from ..crypto.bls import SignatureSet
    bad = list(sets)
    k = len(sets) // 2
    bad[k] = SignatureSet(bad[k].signature, bad[k].pubkeys, b"\xee" * 32)
    return bad


def check_batch(verify, sets, fast: bool = False) -> dict:
    """The protocol on ``sets``: ``verify(sets)`` cold, then warm, then
    ``verify(spoil_one(sets))``. Returns the verdicts and their seconds;
    ``fast`` makes one pass only (``reject_ok`` None, no warm pass)."""
    t0 = time.perf_counter()
    ok = verify(sets)
    cold_s = time.perf_counter() - t0
    if fast:
        ok_warm, warm_s = ok, cold_s
        rejected, neg_s = None, 0.0
    else:
        t0 = time.perf_counter()
        ok_warm = verify(sets)
        warm_s = time.perf_counter() - t0
        bad = spoil_one(sets)
        t0 = time.perf_counter()
        rejected = not verify(bad)
        neg_s = time.perf_counter() - t0
    return {
        "verify_ok": bool(ok) and bool(ok_warm),
        # None (json null) when ``fast`` skipped the negative pass
        "reject_ok": None if rejected is None else bool(rejected),
        "cold_seconds": cold_s,
        "warm_seconds": warm_s,
        "negative_seconds": neg_s,
        "warm_sigs_per_sec": len(sets) / warm_s,
    }


def build_sets(n: int, shared: int = 0):
    """``n`` sets signed on the C++ host backend, set i by key 1000 + i
    over message i (or i mod ``shared``)."""
    from ..crypto.bls import SignatureSet
    from ..crypto.bls.cpp_backend import CppBackend
    signer = CppBackend()
    sets = []
    for i in range(n):
        mi = (i % shared) if shared else i
        msg = mi.to_bytes(32, "little")
        sk = 1000 + i
        sets.append(SignatureSet(signer.sign(sk, msg),
                                 [signer.sk_to_pk(sk)], msg))
    return sets


def run(n: int = N) -> dict:
    """Sign ``n`` sets, then :func:`check_batch` through the ``gpu``
    backend on the port's device; the record."""
    from .. import device
    from ..crypto import bls
    from ..crypto.bls.gpu_backend import lane_options

    # LHTPU_10K_SHARED=<G>: spread the N sets over G distinct messages,
    # modelling a real gossip attestation batch (~128 distinct
    # AttestationData per 10k attestations — PERF_MODEL.md §3.1); the
    # same-message aggregation then runs the hash/Miller stages at the
    # SMALL shape.  Default: all messages distinct (worst case).
    shared = int(os.environ.get("LHTPU_10K_SHARED", "0"))
    t0 = time.perf_counter()
    sets = build_sets(n, shared)
    sign_s = time.perf_counter() - t0

    gpu = bls.set_backend("gpu")
    rec = check_batch(gpu.verify_signature_sets, sets,
                      fast=bool(os.environ.get("LHTPU_10K_FAST")))
    small, big = lane_options()
    return {
        "n_sigs": n,
        "distinct_messages": shared or n,
        "lanes": big,
        "small_lanes": small,
        "platform": device.get_device().type,
        "verify_ok": rec["verify_ok"],
        "reject_ok": rec["reject_ok"],
        "sign_seconds": round(sign_s, 1),
        "cold_seconds": round(rec["cold_seconds"], 1),
        "warm_seconds": round(rec["warm_seconds"], 1),
        "negative_seconds": round(rec["negative_seconds"], 1),
        "warm_sigs_per_sec": round(rec["warm_sigs_per_sec"], 2),
    }


def main() -> int:
    line = json.dumps(run())
    print(line)
    out = os.environ.get("LHTPU_10K_OUT")
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
