"""Rank functions of the tests of the sharded paths. Spawned ranks import
the function they run, so it lives in the package, not in a test module."""
from __future__ import annotations

import hashlib


def rlc_digests(mesh, sets, lanes: int) -> list[str]:
    """Every rank's digest of the RLC scalars of ``replicated_prep`` on
    ``sets``, gathered in rank order: all equal when the scalars were
    drawn once and broadcast."""
    import torch.distributed as dist

    from ..parallel.bls import replicated_prep
    prep = replicated_prep(mesh, sets, lanes)
    mine = hashlib.sha256(repr(prep["pk_rands"] + prep["sig_rands"])
                          .encode()).hexdigest()
    every = [None] * mesh.size
    dist.all_gather_object(every, mine, group=mesh.group)
    return every


def run_checks(mesh, tasks):
    """``launch.run_tasks``, with one more task kind:
    ``("rlc_digests", (sets, lanes))`` gives ``rlc_digests``."""
    from ..parallel.launch import run_tasks
    return [rlc_digests(mesh, *arg) if kind == "rlc_digests"
            else run_tasks(mesh, [(kind, arg)])[0]
            for kind, arg in tasks]
