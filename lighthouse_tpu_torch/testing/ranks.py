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


def mxu_modes(mesh) -> list[int]:
    """Every rank's multiply lowering (``ops.bigint.mxu_mode()``),
    gathered in rank order."""
    import torch.distributed as dist

    from ..ops.bigint import mxu_mode
    every = [None] * mesh.size
    dist.all_gather_object(every, mxu_mode(), group=mesh.group)
    return every


def run_checks(mesh, tasks):
    """``launch.run_tasks``, with two more task kinds:
    ``("rlc_digests", (sets, lanes))`` gives ``rlc_digests``, and
    ``("mxu_modes", None)`` gives ``mxu_modes``."""
    from ..parallel.launch import run_tasks
    probes = {"rlc_digests": lambda arg: rlc_digests(mesh, *arg),
              "mxu_modes": lambda arg: mxu_modes(mesh)}
    return [probes[kind](arg) if kind in probes
            else run_tasks(mesh, [(kind, arg)])[0]
            for kind, arg in tasks]
