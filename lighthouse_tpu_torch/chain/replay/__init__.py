"""graftflow — epoch-pipelined block replay for range-sync and backfill.

The sequential import loop (`BeaconChain.process_chain_segment`) pays
per-block costs that are per-EPOCH costs in disguise: a post-state
merkleization per block, an atomic store batch per block, a fork-choice
head recompute per block.  graftflow restructures segment replay into an
explicit multi-stage pipeline with epoch-granular batching:

  admission -> signature verify -> state transition -> deferred
  merkleization -> one atomic commit per epoch

`engine.ReplayEngine` is the pipeline; the sequential oracle it must
match bit-for-bit is the untouched `process_chain_segment`.
"""
from .engine import ReplayEngine, replay_segment_sequential

__all__ = ["ReplayEngine", "replay_segment_sequential"]
