"""The slasher's cost on the post-merge block's aggregates at 1M validators,
in a process of its own.

    python -m lighthouse_tpu_torch.profile_slasher [--history 4096]
        [--aggregates 4] [--out PATH]

Builds the post-merge workload's state (``stf_workload.build_state`` at
``DENEB_SLOT``, 1,000,000 validators; no keys are needed) and the block's
prior-slot committees; feeds the first ``--aggregates`` of the block's 64
aggregates, as indexed attestations with the chain workload's source and
target (both the current epoch, the anchor justified there), to a
``Slasher`` with the default config but ``--history`` epochs of history,
its chunks on a ``NativeKvStore`` in a temp dir, one ``process_queued`` an
aggregate. Prints the seconds of each, the chunks written, the cache's
bytes and the whole block's 64 extrapolated from the mean. Host only: the
slasher is numpy over the KV store.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time


def profile(history: int, aggregates: int) -> dict:
    from . import stf_workload as sw
    from .slasher import Slasher, SlasherConfig
    from .specs.chain_spec import ForkName
    from .store import NativeKvStore

    t0 = time.perf_counter()
    state = sw.build_state(sw.N_VALIDATORS, sw.DENEB_SLOT, ForkName.DENEB)
    committees = sw.prior_slot_committees(state)
    setup_s = time.perf_counter() - t0
    T = state.T
    epoch = state.current_epoch()
    cfg = SlasherConfig(history_length=history)
    out = {"history_length": history, "chunk_size": cfg.chunk_size,
           "validator_chunk_size": cfg.validator_chunk_size,
           "cache_chunks": cfg.cache_chunks, "epoch": epoch,
           "validators": len(state.validators), "setup_s": setup_s,
           "aggregate_sizes": [], "seconds": []}
    with tempfile.TemporaryDirectory() as tmp:
        sl = Slasher(cfg, store=NativeKvStore(os.path.join(tmp, "kv")))
        for index, committee in enumerate(committees[:aggregates]):
            sl.accept_attestation(T.IndexedAttestation(
                attesting_indices=sorted(int(v) for v in committee),
                data=T.AttestationData(
                    slot=int(state.slot) - 1, index=index,
                    beacon_block_root=b"\x11" * 32,
                    source=T.Checkpoint(epoch=epoch, root=b"\x11" * 32),
                    target=T.Checkpoint(epoch=epoch, root=b"\x11" * 32)),
                signature=b"\x00" * 96))
            t = time.perf_counter()
            found = sl.process_queued(epoch)
            out["seconds"].append(time.perf_counter() - t)
            out["aggregate_sizes"].append(len(committee))
            if found:
                raise RuntimeError(f"the block's aggregates are slashable: "
                                   f"{found[:3]}")
        out["chunks_written"] = (len(sl.min_target._written)
                                 + len(sl.max_target._written))
        out["memory_bytes"] = sl.memory_bytes()
    out["mean_s"] = statistics.mean(out["seconds"])
    out["block_64_s"] = out["mean_s"] * len(committees)
    out["aggregates_in_block"] = len(committees)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--history", type=int, default=4096)
    ap.add_argument("--aggregates", type=int, default=4)
    ap.add_argument("--out", help="also write the report as JSON here")
    args = ap.parse_args(argv)
    rep = profile(args.history, args.aggregates)
    print(f"slasher profile: history {rep['history_length']} epochs "
          f"({rep['chunk_size']}-epoch chunks, "
          f"{rep['validator_chunk_size']}-validator chunks, a cache of "
          f"{rep['cache_chunks']}) at epoch {rep['epoch']}, "
          f"{rep['validators']} validators; {len(rep['seconds'])} "
          f"aggregates of {rep['aggregate_sizes']} validators: "
          f"process_queued {[round(s, 3) for s in rep['seconds']]} s, mean "
          f"{rep['mean_s']:.3f} s, the block's {rep['aggregates_in_block']} "
          f"~{rep['block_64_s']:.1f} s; {rep['chunks_written']} chunks "
          f"written, cache {rep['memory_bytes']} B (state built in "
          f"{rep['setup_s']:.1f} s)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
