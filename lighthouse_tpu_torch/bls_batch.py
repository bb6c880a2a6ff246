"""The flagship BLS batch: 10,000 gossip signature sets over 127 messages.

BASELINE.md config 3, as tools/bls_10k_correctness.py builds it: set i is
signed by ``sk = 1000 + i`` over ``msg = (i % 127).to_bytes(32,
"little")``, one pubkey a set. The C++ host backend signs (its ctypes calls
release the interpreter lock, so a thread pool signs in parallel);
``GpuBackend.warm`` fills the ``gpu`` backend's pubkey cache the way a
node's registry cache is warm.
"""
from __future__ import annotations

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
