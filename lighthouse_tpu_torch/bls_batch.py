"""The flagship BLS batch: 10,000 gossip signature sets over 127 messages.

BASELINE.md config 3, as tools/bls_10k_correctness.py builds it: set i is
signed by ``sk = 1000 + i`` over ``msg = (i % 127).to_bytes(32,
"little")``, one pubkey a set. The C++ host backend signs (its ctypes calls
release the interpreter lock, so a thread pool signs in parallel), and
``warm_pubkeys`` fills a backend's pubkey cache the way a node's registry
cache is warm: the pure-Python decompression runs in a pool of spawned
worker processes, each point's subgroup check on the C++ host library
(the pure-Python check costs ~35x the decompression).
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ThreadPoolExecutor

from .crypto.bls import SignatureSet

N_SETS = 10_000
N_MESSAGES = 127
SK_BASE = 1000


def message(i: int, n_messages: int = N_MESSAGES) -> bytes:
    return (i % n_messages).to_bytes(32, "little")


def build_sets(signer, n: int = N_SETS, n_messages: int = N_MESSAGES,
               threads: int = 8) -> list[SignatureSet]:
    """n signature sets, set i by sk 1000+i over message i % n_messages."""
    def one(i):
        sk = SK_BASE + i
        msg = message(i, n_messages)
        return SignatureSet(signer.sign(sk, msg), [signer.sk_to_pk(sk)], msg)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(one, range(n)))


def _decompress_chunk(pks: list[bytes]):
    """``g1_decompress(pk)`` of each pubkey (None where it refuses one),
    its subgroup check by the C++ library's ``bls_validate_pubkey``; the
    point at infinity, which that refuses, as the pure-Python curve
    gives it."""
    from .crypto.bls.cpp_backend import get_lib
    from .crypto.bls12_381 import g1_decompress
    lib = get_lib()
    out = []
    for pk in pks:
        pt = g1_decompress(pk, subgroup_check=False)
        if pt is not None and not pt.is_infinity() and \
                lib.bls_validate_pubkey(bytes(pk)) != 1:
            pt = None
        out.append(pt)
    return out


def warm_pubkeys(backend, sets, processes: int = 8) -> int:
    """Decompress (with the subgroup check) every distinct pubkey of
    ``sets`` into ``backend._pk_cache``; returns how many were added.
    Raises if a pubkey is invalid."""
    pks = sorted({pk for s in sets for pk in s.pubkeys}
                 - set(backend._pk_cache))
    if not pks:
        return 0
    chunk = -(-len(pks) // processes)
    parts = [pks[i:i + chunk] for i in range(0, len(pks), chunk)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes=len(parts)) as pool:
        results = pool.map(_decompress_chunk, parts)
    for part, points in zip(parts, results):
        for pk, pt in zip(part, points):
            if pt is None:
                raise ValueError(f"invalid pubkey {pk.hex()}")
            backend._pk_cache[pk] = pt
    return len(pks)
