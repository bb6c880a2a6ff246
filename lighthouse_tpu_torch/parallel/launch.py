"""Start a group of ranks, one process each, and run one function in all.

The JAX package needs no counterpart: one controller drives its whole
mesh. The port runs one process per card. ``run_ranks`` spawns ``n``
processes (spawn context: a child starts from a fresh import, never from
a fork of a process that holds CUDA state), joins them into a
``torch.distributed`` group through a ``file://`` store in a fresh
temporary directory (no TCP port to clash with another run), sets every
rank's multiply lowering to the caller's (``ops.bigint.mxu_mode()``: a
spawned rank would read only ``LHTPU_BIGINT_MXU``), calls
``fn(mesh, *args)`` in every rank and returns rank 0's result.

A rank that raises sends its traceback to the parent, which stops the
other ranks and raises it: no rank failure is dropped. The group timeout
turns a collective that one rank never enters into an error, so a hang
ends as a failure too.

``run_tasks`` is a rank function for the checks (the dryrun's and the CPU
tests'): it runs a list of named sharded calls on host inputs and returns
their host results. ``lighthouse_tpu_torch.testing.ranks`` adds the
tests' own probes.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

#: seconds a collective may wait for the other ranks before it fails
GROUP_TIMEOUT_S = 600


class RankFailure(RuntimeError):
    """A rank raised, or died; carries its traceback."""


def _rank_main(rank: int, n: int, backend: str, dev: str, mxu: int,
               init: str, fn, args, results) -> None:
    try:
        import torch
        import torch.distributed as dist

        from .. import device
        from ..ops.bigint import set_mxu_mode
        set_mxu_mode(mxu)
        if dev == "cuda":
            torch.cuda.set_device(rank)
        else:
            device.set_device("cpu")
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        from .mesh import batch_mesh
        out = fn(batch_mesh(n), *args)
    except BaseException:
        # report first: tearing the group down can wait on the others
        results.put((rank, traceback.format_exc(), None))
        raise
    dist.destroy_process_group()
    results.put((rank, None, out if rank == 0 else None))


def run_ranks(fn, n: int, backend: str = "nccl", device: str = "cuda",
              args: tuple = (), timeout_s: float = 1800.0):
    """Run ``fn(mesh, *args)`` in ``n`` spawned ranks and return rank 0's
    result. ``fn`` and ``args`` must pickle (a module-level function).
    ``device`` "cuda" puts rank r on card r (``torch.cuda.set_device``
    before anything is allocated); "cpu" switches each rank's port
    device to the CPU. Every rank runs the caller's multiply lowering
    (``mxu_mode()``). Raises ``RankFailure`` with the first failing
    rank's traceback, or when the run outlasts ``timeout_s``."""
    import torch.multiprocessing as mp

    from ..ops.bigint import mxu_mode
    if device == "cuda":
        import torch
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"{n} ranks need {n} cards, found "
                               f"{torch.cuda.device_count()}")
    elif device != "cpu":
        raise ValueError(f"unknown device {device!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="lh_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, backend, device, mxu_mode(), init,
                                   fn, args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, n, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()


def _collect(procs, results, n: int, timeout_s: float):
    """Rank 0's result once every rank reported success; raises on the
    first failure, on a rank that died without a report, or at the
    deadline."""
    deadline = time.monotonic() + timeout_s
    done, out = set(), None
    while len(done) < n:
        try:
            rank, tb, value = results.get(timeout=1.0)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in done and p.exitcode is not None]
            if dead:
                # a report may still be in flight from a rank that exited
                try:
                    rank, tb, value = results.get(timeout=5.0)
                except queue.Empty:
                    raise RankFailure(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} without a report"
                    ) from None
            elif time.monotonic() > deadline:
                raise RankFailure(f"the ranks did not finish in "
                                  f"{timeout_s:.0f} s") from None
            else:
                continue
        if tb is not None:
            raise RankFailure(f"rank {rank} failed:\n{tb}")
        done.add(rank)
        if rank == 0:
            out = value
    return out


def run_tasks(mesh, tasks):
    """Run named sharded calls on host inputs and return their results,
    in order (every rank returns them; ``run_ranks`` keeps rank 0's):

    - ``("merkleize", leaves)``: the sharded root of u32[N, 8] words;
    - ``("state_root", (validator_leaves, balance_leaves))``: both roots;
    - ``("pairing", (px, py, qx, qy))``: ``sharded_pairing_check`` on
      Montgomery limb arrays, the pairs row-sharded;
    - ``("verify", (sets, lanes))``: ``sharded_verify_signature_sets``.
    """
    from ..ops.sha256 import root_bytes
    from . import bls, merkle
    from .mesh import shard_batch

    out = []
    for kind, arg in tasks:
        if kind == "merkleize":
            out.append(root_bytes(merkle.sharded_merkleize(
                mesh, shard_batch(mesh, arg))))
        elif kind == "state_root":
            v, b = (shard_batch(mesh, a) for a in arg)
            out.append(tuple(root_bytes(r) for r in
                             merkle.sharded_state_root_step(mesh, v, b)))
        elif kind == "pairing":
            out.append(bls.sharded_pairing_check(
                mesh, *(shard_batch(mesh, a) for a in arg)))
        elif kind == "verify":
            sets, lanes = arg
            out.append(bls.sharded_verify_signature_sets(mesh, sets, lanes))
        else:
            raise ValueError(f"unknown task {kind!r}")
    return out
