"""Multi-card parallelism (the port of ``lighthouse_tpu/parallel/``).

The JAX package shards signature-set batches and merkle subtrees across
chips with ``shard_map`` over a ``jax.sharding.Mesh``, one controller for
all. The port runs one process per card (``launch.run_ranks``) in a
``torch.distributed`` group, NCCL on the cards and gloo on the CPU; each
rank runs the port's kernels on its block and the collectives
(``all_gather``) join the blocks.
"""
from .bls import sharded_pairing_check, sharded_verify_signature_sets
from .launch import run_ranks
from .merkle import sharded_merkleize, sharded_state_root_step
from .mesh import batch_mesh, shard_batch

__all__ = ["batch_mesh", "shard_batch", "sharded_merkleize",
           "sharded_state_root_step", "sharded_pairing_check",
           "sharded_verify_signature_sets", "run_ranks"]
