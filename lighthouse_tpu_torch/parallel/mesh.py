"""The rank's view of a 1-D device mesh (the port of
``lighthouse_tpu/parallel/mesh.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh``; the port
runs one process per card (``launch.run_ranks``), each a rank of a
``torch.distributed`` group: NCCL on the card, gloo on the CPU. Every rank
runs the same program (SPMD). A sharded array is represented on each rank
by its local block of rows: rank ``r`` of ``size`` holds rows
``[r * local, (r + 1) * local)`` of the global array, whose row count is
``local * mesh.size``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .. import device as _device


@dataclass
class Mesh:
    """A 1-D data-parallel mesh as one rank sees it: its process group,
    its rank and the group's size, the rank's device and the axis name.
    ``gathered`` counts the bytes each labelled collective gathered on
    this rank (the output of every ``all_gather``, all ranks' blocks)."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "batch"
    gathered: dict = field(default_factory=dict)

    def rows(self, total: int) -> tuple[int, int]:
        """This rank's [lo, hi) block of ``total`` global rows."""
        if total % self.size:
            raise ValueError(f"{total} rows do not split evenly over "
                             f"{self.size} ranks")
        local = total // self.size
        return self.rank * local, (self.rank + 1) * local

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a replicated tensor's rows."""
        lo, hi = self.rows(int(t.shape[0]))
        return t[lo:hi].contiguous()

    def all_gather(self, t: torch.Tensor, label: str) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order along a new leading
        axis ([size, *t.shape]), the counterpart of
        ``jax.lax.all_gather``; adds the gathered bytes to ``label``."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        out = torch.stack(parts)
        self.gathered[label] = (self.gathered.get(label, 0)
                                + out.numel() * out.element_size())
        return out

    def barrier(self) -> None:
        """Wait until every rank got here and the device finished."""
        flag = torch.zeros(1, dtype=torch.int32, device=self.device)
        dist.all_reduce(flag, group=self.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Program:
    """One sharded program: per rank, a composition of the port's kernels
    around a collective. Holds its name, the JAX function it ports
    (``replaces``), its source, and a count of its runs on this rank."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def ran(self) -> None:
        self.launches += 1


#: name -> Program, filled by the modules that define them
PROGRAMS: dict[str, Program] = {}


def program(name: str, source: str, replaces: str) -> Program:
    PROGRAMS[name] = Program(name, source, replaces)
    return PROGRAMS[name]


def reset_counts() -> None:
    for p in PROGRAMS.values():
        p.launches = 0


def batch_mesh(n_devices: int | None = None, axis: str = "batch") -> Mesh:
    """The mesh over the default group, or over its first ``n_devices``
    ranks. Every rank of the default group must call it (forming a
    subgroup is collective); a rank outside the first ``n_devices`` gets
    None. Raises if the group has fewer than ``n_devices`` ranks."""
    if not dist.is_initialized():
        raise RuntimeError("batch_mesh needs an initialised process group "
                           "(launch.run_ranks)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n < 1 or n > world:
        raise ValueError(f"a mesh of {n} ranks from a group of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    dev = _device.get_device()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank, n, dev, axis)


def shard_batch(mesh: Mesh, arr) -> torch.Tensor:
    """This rank's contiguous row block of the host array ``arr`` on the
    rank's device. ``uint32`` words become the ``int32`` tensors of the
    same bits that the port's kernels read."""
    arr = np.asarray(arr)
    lo, hi = mesh.rows(arr.shape[0])
    block = np.ascontiguousarray(arr[lo:hi])
    if block.dtype == np.uint32:
        block = block.view(np.int32)
    if not block.flags.writeable:      # torch.from_numpy wants writable
        block = block.copy()
    t = torch.from_numpy(block)
    # the block never aliases the caller's array
    return t.clone() if mesh.device.type == "cpu" else t.to(mesh.device)
