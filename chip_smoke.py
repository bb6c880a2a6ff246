#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out REPORT.json]

Phases (each prints its lines; any failure raises and exits nonzero):

1. Card and build: ``nvidia-smi`` name and power limit; build every CUDA
   kernel of the port from ``lighthouse_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once), print the build time and each kernel's registers,
   stack and spills.
2. State-root kernels against their plain PyTorch versions, on the card,
   at the shapes the state root gives them; equality is bit-exact
   (max_abs_err 0). Each kernel's time (CUDA events, median of repeats),
   its plain version's time and its bound (the least time the card could
   take for the same work: bytes over the memory rate, or integer ops over
   the INT32 rate). ``path_update`` is one launch a walk, the root's zero
   caps folded in, timed at R = 1,024 and 65,536 dirty rows on depth 20
   with the registry's 20 caps (held against the plain walk and the
   plain cap fold); ``cap_fold`` (its caps from a built-in table) at 20
   caps, and 0, 1 and 44, with its chain's latency floor beside.
3. The state-root slice: a Deneb mainnet-preset BeaconState at 1,000,000
   validators from ``seeded_columns(N_VALIDATORS, STATE_SEED)``;
   ``hash_tree_root()`` on the card must equal ``EXPECTED_STATE_ROOT_1M``;
   ``REPS`` (5) reps of the ``bench.py`` ``bench_tree_hash`` writes, each
   followed by the state root; the last must equal
   ``EXPECTED_STATE_ROOT_1M_AFTER_REPS``; a rebuild from scratch must equal
   the incremental root; every kernel's launch count must be nonzero,
   ``path_update``'s one a tree update (10), and ``cap_fold``'s the
   build's alone (5: the updates fold their caps inside their walks).
4. The BLS slice, batched signature verification: 10,000 gossip sets over
   127 messages (``bls_batch``), signed by the C++ host backend, pubkeys
   warmed into the cache. Each BLS kernel against its plain version on the
   batch's own lane inputs (10,240 lanes, 128 message lanes), canonical
   field values equal (max_abs_err 0); ``fp_ops`` first as the main path
   launches it, the Montgomery entry of the lane inputs packed in one
   array (4 x 10,240 elements), then mul, add and sub; bound from the
   field multiplies of the kernel's own algorithm on those inputs
   (``ops/bls_cost.py``); for
   the latency-bound kernels (``final_exp``, ``hash_to_g2``,
   ``miller_loop``, ``g2_sum``, ``g1_segment_sum``) also their critical
   path in dependent field multiplies and the card's time per level of
   it, a diagnostic (``g1_segment_sum`` also in additions,
   ``bls_cost.g1_segment_sum_depth``),
   and for the two with two designs (``hash_to_g2``, ``miller_loop``) the
   design the batch's n picked; for the lane-group kernels
   (``rlc_scale``, ``g2_intake``) the products and multiply rounds their
   groups issue (``bls_cost.scalar_mul_lanes``, ``g2_subgroup_lanes``,
   ``g2_decompress_lanes``: the bound's count) and the bound the
   one-thread formulas gave, beside; the Miller loop also at 10,241 pairs (the
   129 tiled), with 128 live (run on the live pairs alone, a block a
   pair) and all live (a thread a pair). ``g2_sum`` is held as a point
   (``measure.g2_projective_err``: its tree adds in another order than
   the JAX one, so another Jacobian representative of the same point).
   ``g1_segment_sum`` also runs on one 10,000-lane segment and on 10,000
   one-lane segments of the batch's scaled pubkeys (phase 6 reruns all
   three layouts in modes 1 and 2). ``affine`` runs on the Q side (the
   128 message points and the aggregate, 129 Fp2 lanes) and on the 128
   group sums (Fp); its bound
   is the function's least work on these inputs, one inverse a call by
   batch inversion (``bls_cost.affine_least``), with the kernel's own
   count (an inverse a lane, ``bls_cost.affine_int_ops``) and the count
   with a Fermat inverse a lane beside. Then the module entry
   ``crypto.bls.verify_signature_sets`` on its default backend
   (``gpu``): True on the batch and equal to the C++ backend; five
   negative batches False on both; a 100-set batch True; every BLS kernel
   launched on that path (``affine`` twice, ``fp_ops`` once); the first
   call and the median of three warm calls, sets/s, host prep.
5. The sharded paths on every card (``n = torch.cuda.device_count()``, one
   rank a card, NCCL; ``lighthouse_tpu_torch/entry.py``): the dryrun's
   four checks (a sharded state-root step, a sharded pairing check, the
   sharded ``verify_signature_sets``, a 2^17-leaf sharded tree), then at
   full width the 1M-validator columns' sharded validator and balance
   roots (equal to the single-GPU roots; median of 3 after a warm-up) and
   the 10k batch verified sharded at 10,240 lanes (True, and False with
   set 1 corrupted, each equal to the single-GPU verdict; warm median of
   3), the bytes each ``all_gather`` moved, each sharded program
   against the single-device composition on the same inputs (roots
   byte-equal, Fp12 values canonically equal), the sharded aggregate
   signature limb for limb against one GPU's, and rank 0's kernels on the
   path against their plain versions (the Miller loop at 10,241 pairs on
   one card: its 128 live pairs, a block a pair).
6. The multiply lowerings 1 and 2 of ``ops/bigint.py`` (the JAX package's
   ``LHTPU_BIGINT_MXU`` modes), then mode 0 again: their variants of every
   BLS kernel built (``-DLH_FP_MODE``); the ``bench.py`` ``mxu`` workload
   (``measure.mont_mul_modes``: 32 dependent products over 65,536 lanes,
   mont_mul/s per mode, the modes' results equal as field values and each
   equal to its plain chain); under each mode every variant on the inputs
   phase 4 gave its kernel (the flagship shapes: 10,240 / 128 lanes, 129
   Miller pairs, and the Miller loop's two checks at 10,241 pairs, one on
   each design), held canonical-exact against phase 4's plain outputs on
   those inputs (every lowering gives the same canonical values) and
   timed, its bound the function's need (``bls_cost.FP_MUL_INT_OPS`` a
   field multiply) with its lowering's own issue count printed beside;
   and the 10k batch through
   ``verify_signature_sets`` (True; the five negatives False, as on the
   C++ backend; every variant launched); ``sha256_messages`` against
   hashlib and its plain version (2^20 messages of 200 bytes),
   ``fp12_pow_const`` (1,024 lanes, exponent |x|; five lanes at
   exponents 0, 1 and of 100 bits) and ``reduce_wide_mod_p`` (10,240
   rows, one launch) under each mode.

7. The state transition at 1,000,000 validators (``stf_workload``: the
   mainnet Altair state and block of ``bench.py``'s state-transition
   workload, the block's 64 attestations and sync aggregate really signed,
   the signers' pubkeys interop keys): the pubkeys of its 67 signature
   sets warmed into the ``gpu`` backend's cache (``os.cpu_count()``
   processes); with every launch count at 0, the pre-state root on the
   card, ``per_block_processing`` with its signatures verified as one
   batch on the ``gpu`` backend (67 sets over 67 messages at 128 lanes),
   the post-block root (``EXPECTED_BLOCK_ROOT_1M``), the epoch on a copy
   at the epoch's last slot and its root (``EXPECTED_EPOCH_ROOT_1M``); then
   every state-root and BLS kernel must have launched (``affine`` twice,
   ``fp_ops`` once). The same block on the ``cpp`` backend accepted; two
   negative blocks (attestation 0 with attestation 1's signature, the
   proposal signed over another root) raise on both. Timed: the median of
   3 warm calls with signatures on and off, the signatures-on call split
   into set construction, ``parse_sets``, ``host_prepare``, device busy
   time (one call under ``torch.profiler``) and the rest, the card's idle
   share of that call, the post-block root, and the epoch with its root.
   Each BLS kernel against its plain version on the block batch's own
   lane inputs (128 lanes, 129 Miller pairs), among the kernels' modes.
   The memory ledger at the phase's end.
8. Observability, read from what phases 1-7 left (the catalog and the
   ``obs`` layer are loaded at import, as a node loads them, and the
   graftwatch sampler ticks once a phase): every kernel that launched (15
   in mode 0, 20 mode-1/2 variants) has a roofline record on the card
   (its device ms and its utilization of the peak in (0, 1.05]); the
   memory ledger of phase 7 (platform ``cuda``, the card's kind, memory
   and bytes in use, the live merkle trees attributed within them); a
   second ``build_all`` with no build-cache miss; the catalog metrics of
   the state root, the BLS batch (``bls_batch_verify_sigs`` at 10,000)
   and the block; a flight dump the port's doctor renders with exit 0.

Every bound beside a kernel's time (phases 2, 4, 6, 7) is the roofline
record of the checked call: its wrapper's declared cost (``obs/roofline``).

The expected roots are the JAX package's, pinned by
tests/test_torch_state_root.py and tests/test_torch_stf_workload.py.
Importing this module touches no CUDA.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

# the metric catalog and the observability layer, loaded first as a node
# loads them: every phase below runs instrumented (span histograms, the
# batch size, the state copies, the roofline records, the build counts)
from lighthouse_tpu_torch.api import metrics_defs  # noqa: F401
from lighthouse_tpu_torch.measure import (
    Bounds, field_err, g2_projective_err, max_abs_err, nvidia_smi, time_cuda,
)
from lighthouse_tpu_torch.obs import (
    cuda_accounting, flight, graftwatch, roofline, timeseries, tracing,
)
from lighthouse_tpu_torch.obs import device as ledger
from lighthouse_tpu_torch.seeded_state import N_VALIDATORS, REPS, STATE_SEED

#: hash_tree_root() of the seeded 1M-validator Deneb mainnet-preset state,
#: before and after the 5 bench_tree_hash reps (the JAX package's roots).
EXPECTED_STATE_ROOT_1M = (
    "59e47648a621b500758fe08b6de5ab2739568ac9204bac064a7082abbf709b2a")
EXPECTED_STATE_ROOT_1M_AFTER_REPS = (
    "b8fa02b5aad146b8cefc2e4210cb338f476f2e884b477a89e8b0ba5043c47cdd")
#: hash_tree_root() of the 1M-validator Altair workload (stf_workload) after
#: its block, and after the epoch run at the epoch's last slot on a copy of
#: that post-block state (the JAX package's roots)
EXPECTED_BLOCK_ROOT_1M = (
    "7811448d1a1e63a5fb38269ea37349f15d755e861ec36c4b8675a884929be72a")
EXPECTED_EPOCH_ROOT_1M = (
    "8b8aecb3c16c6debb0fc65edc723ebe66ed035462806da425b8f0ccf675f2070")

REPLACES = {
    "hash64": "lighthouse_tpu/ops/sha256.py:102",
    "cap_fold": "lighthouse_tpu/ops/sha256.py:135",
    "fold_pre": "lighthouse_tpu/ops/merkle_tree.py:52",
    "path_update": "lighthouse_tpu/ops/merkle_tree.py:105",
    "fp_ops": "lighthouse_tpu/ops/bigint.py:319",
    "g2_intake": "lighthouse_tpu/ops/bls12_381.py:1140",
    "hash_to_g2": "lighthouse_tpu/ops/bls12_381.py:1069",
    "rlc_scale": "lighthouse_tpu/ops/bls12_381.py:523",
    "g1_segment_sum": "lighthouse_tpu/ops/bls12_381.py:528",
    "g2_sum": "lighthouse_tpu/ops/bls12_381.py:572",
    "affine": "lighthouse_tpu/ops/bls12_381.py:558",
    "miller_loop": "lighthouse_tpu/ops/bls12_381.py:674",
    "final_exp": "lighthouse_tpu/ops/bls12_381.py:806",
    "sha256_messages": "lighthouse_tpu/ops/sha256.py:211",
    "fp12_pow": "lighthouse_tpu/ops/bls12_381.py:337",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def kernel_phase(bounds: Bounds) -> tuple[list[dict], dict]:
    """Each kernel against its plain version at the state root's shapes:
    the JSON rows, and the further modes checked (kernel -> list)."""
    import torch

    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch.ops import merkle_tree as mt
    from lighthouse_tpu_torch.ops import sha256 as sh

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    results, modes = [], {}

    def rand_words(*shape):
        arr = rng.integers(0, 2**32, size=shape, dtype=np.uint64)
        return torch.from_numpy(arr.astype(np.uint32).view(np.int32)).to(dev)

    def record(name, fn, want, plain, mode=None, repeats=20, got=None,
               work=None):
        """Run ``fn`` (the kernel's call) once, check what it gives
        (``got(out)`` where given) against ``want`` bit-exact and time
        both. The bound is the roofline record of that call (the
        wrapper's declared cost on these inputs; ``work``, a declared
        cost's (bytes, ops), where the call has none). The first check of a
        kernel makes its row; a further ``mode`` (another shape or
        template instance the main path launches) adds its error to the
        row and its times to ``modes`` (the report's ``kernel_modes``; the
        JSON line keeps the first check's times)."""
        with roofline.capture() as calls:
            out = fn()
        got = out if got is None else got(out)
        err = max_abs_err(got, want)
        label = name if mode is None else f"{name} [{mode}]"
        check(torch.equal(got, want), f"{label}: kernel != plain "
                                      f"(max_abs_err {err})")
        ms = time_cuda(fn, repeats)
        plain_ms = time_cuda(plain, 3, warmup=0)
        if work is None:
            rec = [c for c in calls if c["kernel"] == name][-1]
            bound_ms, bound_by = rec["bound_ms"], rec["bound_by"]
        else:
            bound_ms, bound_by = bounds(*work)
        print(f"kernel {label}: ok bit-exact, {ms:.4f} ms (plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by})",
              flush=True)
        if mode is not None:
            row = next(r for r in results if r["name"] == name)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            modes.setdefault(name, []).append(
                {"mode": mode, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by})
            return
        results.append({"name": name, "route": "cuda",
                        "source": f"lighthouse_tpu_torch/csrc/{name}.cu",
                        "replaces": REPLACES[name], "launches": 0,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})

    def sorted_rows(count, high):
        """``count`` sorted distinct leaf rows in [0, high), as the state's
        dirty-row sets reach DeviceTree.update."""
        got = np.sort(rng.choice(high, size=count, replace=False))
        return torch.from_numpy(got.astype(np.int32)).to(dev)

    # hash64 on 2^20 random 64-byte blocks (one level of the registry tree)
    n = 1 << 20
    blocks = rand_words(n, 16)
    record("hash64", lambda: sh.hash64(blocks), sh._hash64_plain(blocks),
           lambda: sh._hash64_plain(blocks))
    del blocks

    # fold_pre, the registry build (<3>): 2^20 slots, 1,000,000 live
    # validators with pubkeys
    n_live, p = N_VALIDATORS, 3
    chunks = rand_words(n_live * 8, 8)
    pk = rand_words(n_live, 16)
    out_k = torch.empty((n, 8), dtype=torch.int32, device=dev)
    out_p = torch.empty_like(out_k)
    mt._fold_pre_plain(chunks, pk, None, n, n_live, p, out_p)
    record("fold_pre", lambda: mt.fold_pre(chunks, pk, p, n_live, out_k),
           out_p,
           lambda: mt._fold_pre_plain(chunks, pk, None, n, n_live, p, out_p))
    del chunks, pk

    # fold_pre, a registry update (<3>, scatter): 1,024 dirty validators
    # with pubkeys into the 2^20-slot level 0 above
    r = 1024
    rows = sorted_rows(r, n_live)
    chunks, pk = rand_words(r * 8, 8), rand_words(r, 16)
    mt._fold_pre_plain(chunks, pk, rows, r, n_live, p, out_p)
    record("fold_pre",
           lambda: mt.fold_pre(chunks, pk, p, n_live, out_k, rows=rows),
           out_p,
           lambda: mt._fold_pre_plain(chunks, pk, rows, r, n_live, p, out_p),
           mode="scatter<3>")
    del out_k, out_p

    # fold_pre, the balances column (<0>, no pubkeys): 1,000,000 u64 are
    # 250,000 chunks in a 2^18-slot level 0; a build, then a 1,024-leaf
    # update
    n_live, n0 = N_VALIDATORS * 8 // 32, 1 << 18
    chunks = rand_words(n_live, 8)
    out_k = torch.empty((n0, 8), dtype=torch.int32, device=dev)
    out_p = torch.empty_like(out_k)
    mt._fold_pre_plain(chunks, None, None, n0, n_live, 0, out_p)
    record("fold_pre", lambda: mt.fold_pre(chunks, None, 0, n_live, out_k),
           out_p,
           lambda: mt._fold_pre_plain(chunks, None, None, n0, n_live, 0,
                                      out_p),
           mode="build<0>")
    rows = sorted_rows(r, n_live)
    chunks = rand_words(r, 8)
    mt._fold_pre_plain(chunks, None, rows, r, n_live, 0, out_p)
    record("fold_pre",
           lambda: mt.fold_pre(chunks, None, 0, n_live, out_k, rows=rows),
           out_p,
           lambda: mt._fold_pre_plain(chunks, None, rows, r, n_live, 0,
                                      out_p),
           mode="scatter<0>")
    del chunks, out_k, out_p

    # path_update: the one-launch walk of an update up a depth-20 tree, at
    # R = 1,024 dirty rows (a rep's) and at R = 65,536 (a grid of ~500
    # blocks, where one block would not hold the lower levels); rows drawn
    # with repeats, walked as DeviceTree.update sends them (sorted,
    # distinct), the root's 20 zero caps folded in by the same launch (the
    # registry's 2^40 limit), held against the plain walk and the plain
    # cap fold of its top node
    depth, limit = 20, 40
    zeros = sh.words_to_tensor(sh.ZERO_HASH_WORDS, dev)
    levels = [rand_words(1 << depth, 8)]
    for _ in range(depth):
        levels.append(sh.hash64(levels[-1].reshape(-1, 16)))
    for r in (1024, 65536):
        rows_np = np.unique(rng.integers(0, 1 << depth, size=r)).astype(
            np.int32)
        rows = torch.from_numpy(rows_np).to(dev)
        levels[0][rows.long()] = rand_words(len(rows_np), 8)
        lv_k = [lv.clone() for lv in levels]
        lv_p = [lv.clone() for lv in levels]

        def walk_plain(lv_p=lv_p, rows=rows):
            mt._path_walk_plain(lv_p, rows)
            return sh._cap_fold_plain(lv_p[-1][0], zeros[depth:limit])

        root_p = walk_plain()
        # the bound counts the work this data needs: one hash per
        # distinct parent per level, then the caps
        record("path_update", lambda: mt._path_walk(lv_k, rows, limit),
               torch.cat(lv_p + [root_p[None]]), walk_plain,
               mode=None if r == 1024 else f"R={r}, one walk",
               got=lambda root, lv_k=lv_k: torch.cat(lv_k + [root[None]]))
        del lv_k, lv_p
    del levels

    # cap_fold: K = 20 zero-subtree caps (registry: 2^20 dense, 2^40
    # limit; a build's), then 0, 1 and 44; the caps from the kernel's
    # built-in table, the plain fold's from the words on the card
    root = rand_words(8)
    mhz = bounds.sm_clock_mhz

    def cap_kernel(dense, lim):
        """One cap_fold launch: cap_root's where there are caps; with none
        cap_root copies the root without the kernel, so the C entry is
        called as cap_root calls it."""
        if dense < lim:
            return sh.cap_root(root, dense, lim)
        out = torch.empty(8, dtype=torch.int32, device=dev)
        kernels.CAP_FOLD.launch(root.data_ptr(), dense, lim, out.data_ptr(),
                                kernels.stream_ptr(dev))
        return out

    for dense, lim in ((20, 40), (20, 20), (20, 21), (0, 44)):
        kk = lim - dense
        record("cap_fold", lambda dense=dense, lim=lim: cap_kernel(dense, lim),
               sh._cap_fold_plain(root, zeros[dense:lim]),
               lambda dense=dense, lim=lim: sh._cap_fold_plain(
                   root, zeros[dense:lim]),
               mode=None if kk == 20 else f"k={kk}",
               # at no caps the C entry runs outside cap_root (no record):
               # cap_root's declared cost
               work=None if kk else sh.cap_root.cost(None, root, dense,
                                                     lim))
        # the chain's floor: 2 k dependent compressions of 64 rounds, ~7
        # dependent integer operations a round at ~4 cycles each
        print(f"kernel cap_fold [k={kk}]: the chain's latency floor "
              f"{2 * kk * 64 * 7 * 4 / mhz / 1e3:.4f} ms ({2 * kk} dependent "
              f"compressions x 64 rounds x ~7 dependent integer ops of ~4 "
              f"cycles at {mhz:.0f} MHz)", flush=True)
    torch.cuda.synchronize()
    return results, modes


def reset_trees(state) -> None:
    """Drop every incremental tree so the next root rebuilds from scratch."""
    state.validators.mark_dirty()
    for name in ("balances", "inactivity_scores",
                 "previous_epoch_participation",
                 "current_epoch_participation"):
        getattr(state, name).mark_dirty()


def slice_phase(card: str) -> dict:
    """The 1M-validator Deneb state root, its reps, and the rebuild."""
    import torch

    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch.containers.state import (
        ValidatorRegistry, new_state,
    )
    from lighthouse_tpu_torch.seeded_state import (
        apply_bench_rep, bench_reps, fill_state, seeded_columns,
    )
    from lighthouse_tpu_torch.specs import ForkName, mainnet_spec

    t0 = time.perf_counter()
    state = new_state(mainnet_spec(), ForkName.DENEB)
    fill_state(state, ValidatorRegistry(),
               seeded_columns(N_VALIDATORS, STATE_SEED))
    setup_s = time.perf_counter() - t0
    print(f"slice: seeded {N_VALIDATORS} validators in {setup_s:.2f} s "
          f"(host)", flush=True)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    root = state.hash_tree_root()
    build_ms = (time.perf_counter() - t0) * 1e3
    build_caps = kernels.CAP_FOLD.launches
    check(root.hex() == EXPECTED_STATE_ROOT_1M,
          f"1M state root {root.hex()} != {EXPECTED_STATE_ROOT_1M}")
    print(f"slice: full build state root {root.hex()} ok, {build_ms:.1f} ms "
          f"[{card}]", flush=True)

    rep_ms, mutate_ms, root_ms = [], [], []
    for rows, brows in bench_reps(N_VALIDATORS, REPS):
        t0 = time.perf_counter()
        apply_bench_rep(state, rows, brows)
        t1 = time.perf_counter()
        root = state.hash_tree_root()
        t2 = time.perf_counter()
        mutate_ms.append((t1 - t0) * 1e3)
        root_ms.append((t2 - t1) * 1e3)
        rep_ms.append((t2 - t0) * 1e3)
    launches = {k.name: k.launches for k in kernels.STATE_ROOT_KERNELS}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    check(root.hex() == EXPECTED_STATE_ROOT_1M_AFTER_REPS,
          f"state root after {REPS} reps {root.hex()} != "
          f"{EXPECTED_STATE_ROOT_1M_AFTER_REPS}")
    print(f"slice: {REPS} reps ok, root {root.hex()}; ms per rep "
          f"{[round(x, 2) for x in rep_ms]} (writes "
          f"{[round(x, 2) for x in mutate_ms]}, root "
          f"{[round(x, 2) for x in root_ms]}) [{card}]", flush=True)
    print(f"slice: launches on the main path {launches}; peak device "
          f"memory {peak_mib:.0f} MiB", flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    # one walk an update: the registry and the balances, each rep; the
    # walk folds its root's caps, so cap_fold is the build's alone (one a
    # capped tree)
    check(launches["path_update"] == 2 * REPS,
          f"path_update launched {launches['path_update']} times, not "
          f"{2 * REPS} (one walk a tree update)")
    check(launches["cap_fold"] == build_caps == 5,
          f"cap_fold launched {launches['cap_fold']} times in the build and "
          f"{REPS} reps ({build_caps} in the build), not 5 and 5 (the "
          f"updates' caps fold inside their walks)")

    reset_trees(state)
    t0 = time.perf_counter()
    rebuilt = state.hash_tree_root()
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    check(rebuilt == root, f"rebuilt root {rebuilt.hex()} != incremental "
                           f"root {root.hex()}")
    print(f"slice: rebuild from scratch equals the incremental root, "
          f"{rebuild_ms:.1f} ms", flush=True)
    return {"launches": launches, "build_ms": build_ms,
            "rebuild_ms": rebuild_ms, "rep_ms": rep_ms,
            "rep_mutate_ms": mutate_ms, "rep_root_ms": root_ms,
            "peak_device_mib": peak_mib, "setup_s": setup_s}


def timed(fn):
    """(result, ms) of one call of ``fn`` between two CUDA events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def build_summary(logs: dict) -> dict:
    """Per source: the registers, stack frame and spills ptxas reported
    for each of its kernels (entry functions)."""
    return {src: cuda_accounting.ptxas_summary(log)
            for src, log in logs.items()}


class BlsKernelCheck:
    """Each BLS kernel against its plain version on the card, on the lane
    inputs of a batch, stage after stage (``bls_stage_chain``): every
    kernel reads what the kernel before it wrote, as on the main path.
    Equality is of canonical field values (max_abs_err over canonical
    limbs, 0 required) and of flags. Times: the kernel's median over
    ``repeats`` CUDA-event runs, the plain version's one run. The bound is
    the roofline record of the check's kernel call: the wrapper's declared
    cost, the larger of the bytes over the memory rate and the field
    multiplies of the kernel's own algorithm on these inputs x the integer
    ops the function needs for one (``bls_cost.FP_MUL_INT_OPS``, whatever
    the multiply lowering) over the INT32 rate. The plain version's count
    (its mont_mul counter) is printed beside it: it is branch-free, so it
    computes more.

    ``run`` keeps each check's inputs and plain output (``calls``).
    ``rerun`` holds the kernel of the current multiply lowering ``mxu``
    (rows named ``<kernel>_mxu<n>`` for n > 0) to a kept check: the same
    inputs, the same plain output. Every lowering gives the same canonical
    field values, so the plain versions need not run again. Beside a
    variant's bound it prints the bound its lowering's own issue count
    would give (``bls_cost.fp_mul_pipe_ops``), a diagnostic."""

    def __init__(self, bounds: Bounds, mxu: int = 0):
        self.bounds = bounds
        self.mxu = mxu
        self.rows: list[dict] = []
        self.modes: dict[str, list] = {}
        self.muls: dict[str, dict] = {}
        self.calls: list[dict] = []

    def run(self, kernel, kernel_fn, plain_fn, args, mode=None,
            repeats=3, depth=None, design=None, projective=False,
            issue=None, old_muls=None, kernel_ops=None):
        from lighthouse_tpu_torch.ops import bigint as bi
        got, rec = self._launch(kernel, kernel_fn, args)
        bi.MONT_MUL_ROWS.reset()
        want, plain_ms = timed(lambda: plain_fn(*args))
        call = {"kernel": kernel, "kernel_fn": kernel_fn, "args": args,
                "want": want, "plain_ms": plain_ms,
                "plain_muls": bi.MONT_MUL_ROWS.rows,
                "mode": mode, "repeats": repeats, "depth": depth,
                "design": design, "projective": projective,
                "issue": issue, "old_muls": old_muls,
                "kernel_ops": kernel_ops}
        self.calls.append(call)
        self._record(call, got, rec)
        return got

    def rerun(self, call: dict) -> None:
        from lighthouse_tpu_torch.ops import bigint as bi
        check(bi.mxu_mode() == self.mxu, f"multiply lowering {bi.mxu_mode()}"
                                         f" in force, not {self.mxu}")
        self._record(call, *self._launch(call["kernel"], call["kernel_fn"],
                                         call["args"]))

    @staticmethod
    def _launch(kernel, kernel_fn, args):
        """The kernel's output on ``args`` and the roofline record of its
        call (the last one of ``kernel``: an outer call returns after the
        calls it makes)."""
        import torch
        with roofline.capture() as calls:
            got = kernel_fn(*args)
        torch.cuda.synchronize()
        return got, [c for c in calls if c["kernel"] == kernel][-1]

    def _record(self, call: dict, got, roof: dict) -> None:
        from lighthouse_tpu_torch import kernels
        from lighthouse_tpu_torch.ops import bls_cost as cost
        kernel, args, mode = call["kernel"], call["args"], call["mode"]
        name = kernel if self.mxu == 0 else f"{kernel}_mxu{self.mxu}"
        label = name if mode is None else f"{name} [{mode}]"
        if call["projective"]:
            err = g2_projective_err(got, call["want"])
            what = "the canonical affine points"
        else:
            err = field_err(got, call["want"])
            what = "canonical values"
        check(err == 0, f"{label}: kernel != plain (max_abs_err {err} on "
                        f"{what})")
        issue, old_muls = (v(got) if callable(v) else v
                           for v in (call["issue"], call["old_muls"]))
        ms = time_cuda(lambda: call["kernel_fn"](*args), call["repeats"])
        n_bytes, muls, extra = (roof["bytes"], roof["field_muls"],
                                roof.get("word_ops", 0))
        bound_ms, bound_by = roof["bound_ms"], roof["bound_by"]
        alg_ms = self.bounds(
            n_bytes, muls * cost.fp_mul_pipe_ops(self.mxu)["issue"] + extra)[0]
        lanes = int(args[0].shape[0])
        plain_ms, plain_muls = call["plain_ms"], call["plain_muls"]
        against = ("its plain version" if self.mxu == 0 else
                   "phase 4's plain output on the same inputs")
        depth, design = call["depth"], call["design"]
        per_level = None if depth is None else ms * 1e3 / depth
        old_bound = (None if old_muls is None else self.bounds(
            n_bytes, old_muls * cost.FP_MUL_INT_OPS)[0])
        kernel_ops = call["kernel_ops"]
        kernel_bound = (None if kernel_ops is None else
                        self.bounds(n_bytes, kernel_ops)[0])
        exact = ("equal as a point (projectively)" if call["projective"]
                 else "canonical-exact")
        print(f"kernel {label} at {lanes} lanes"
              + ("" if design is None else f" ({design})")
              + f": ok {exact} against "
              f"{against} (plain {plain_ms:.1f} ms, {plain_muls} field "
              f"multiplies); {ms:.4f} ms; {muls} field multiplies"
              + (f" and {extra} word operations" if extra else "")
              + f"; bound {bound_ms:.4f} ms by {bound_by}"
              + (f" (the lowering's own issue count: {alg_ms:.4f} ms)"
                 if self.mxu else "")
              + ("" if depth is None else
                 f"; critical path {depth} dependent field multiplies, "
                 f"{per_level:.3f} us a level")
              + ("" if old_bound is None else
                 f"; bound with the earlier count ({old_muls} field "
                 f"multiplies) {old_bound:.4f} ms")
              + ("" if kernel_bound is None else
                 f"; this kernel's own algorithm {kernel_ops} integer ops, "
                 f"{kernel_bound:.4f} ms at the same rates")
              + ("" if issue is None else
                 f"; lane groups of {issue['width']} threads issue "
                 f"{issue['issued'] / max(lanes, 1):.1f} products a lane "
                 f"({issue['products'] / max(lanes, 1):.1f} its own), "
                 f"{issue['rounds']} multiply rounds the longest warp, "
                 f"{issue['warp_rounds']} over the warps"), flush=True)
        rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "algorithm_bound_ms": alg_ms,
               "field_muls": muls, "plain_field_muls": plain_muls,
               "lanes": lanes, "depth": depth, "us_per_level": per_level,
               "design": design, "issue": issue, "old_field_muls": old_muls,
               "old_bound_ms": old_bound, "kernel_bound_ms": kernel_bound}
        self.muls[label] = {"field_muls": muls, "plain_field_muls": plain_muls,
                            "algorithm_bound_ms": alg_ms, "ms": ms,
                            "depth": depth, "us_per_level": per_level,
                            "design": design, "issue": issue,
                            "old_bound_ms": old_bound,
                            "kernel_bound_ms": kernel_bound}
        if mode is not None:
            row = next(r for r in self.rows if r["name"] == name)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            self.modes.setdefault(name, []).append({"mode": mode, **rec})
        else:
            self.rows.append({
                "name": name, "route": "cuda",
                "source": "lighthouse_tpu_torch/csrc/"
                          + kernels.KERNELS[kernel].source,
                "replaces": REPLACES[kernel], "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
                **({} if design is None else {"design": design})})


def bls_setup() -> dict:
    """Sign the 10,000 sets with the C++ host backend, then warm the
    pubkey cache of the module's default backend, ``gpu`` (a node's
    registry cache)."""
    from lighthouse_tpu_torch.bls_batch import build_sets, warm_pubkeys
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls.cpp_backend import CppBackend
    from lighthouse_tpu_torch.crypto.bls.gpu_backend import GpuBackend

    t0 = time.perf_counter()
    cpp = CppBackend()
    sets = build_sets(cpp)
    sign_s = time.perf_counter() - t0
    gpu = bls.get_backend()
    check(isinstance(gpu, GpuBackend),
          f"the default BLS backend is {type(gpu).__name__}, not gpu")
    t0 = time.perf_counter()
    warmed = warm_pubkeys(gpu, sets)
    warm_s = time.perf_counter() - t0
    print(f"bls setup: {len(sets)} sets over "
          f"{len({s.message for s in sets})} messages signed in "
          f"{sign_s:.1f} s (C++ host backend, 8 threads); {warmed} pubkeys "
          f"into the cache in {warm_s:.1f} s (8 processes)", flush=True)
    return {"cpp": cpp, "gpu": gpu, "sets": sets, "sign_s": sign_s,
            "pubkey_warm_s": warm_s}


def bls_prep(setup: dict, sets, lanes: int, small: int) -> dict:
    """The lane inputs of ``sets`` at ``lanes`` / ``small`` lanes."""
    from lighthouse_tpu_torch.crypto.bls import gpu_backend as gb
    parsed = gb.parse_sets(setup["gpu"], sets)
    check(parsed is not None, "the batch did not parse")
    prep = gb.host_prepare(*parsed, lanes, small)
    n_msgs = len({s.message for s in sets})
    check(prep["msg_lanes"] == small and prep["n_groups"] == n_msgs,
          f"batch layout: {prep['n_groups']} groups on "
          f"{prep['msg_lanes']} message lanes")
    return prep


def bls_stage_chain(run, prep: dict, lanes: int, small: int,
                    flagship: bool = True) -> None:
    """The BLS stages on a batch's lane inputs (``prep`` at ``lanes`` /
    ``small`` lanes), each kernel reading what the kernel before it wrote:
    ``run(kernel, kernel_fn, plain_fn, args, ...)`` checks and times
    one (``BlsKernelCheck.run``; its bound the roofline record of the
    kernel's call). The batch must verify on the kernels.
    ``flagship`` adds the layouts of the 10k batch's paths: the segment
    sums over one 10,000-lane segment and 10,000 one-lane segments, and
    the Miller loop at ``lanes`` + 1 pairs."""
    import torch

    from lighthouse_tpu_torch.crypto.bls import gpu_backend as gb
    from lighthouse_tpu_torch.ops import bigint as bi
    from lighthouse_tpu_torch.ops import bls12_381 as k
    from lighthouse_tpu_torch.ops import bls_cost as cost

    dev = torch.device("cuda")

    def put(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    # the lane inputs' Montgomery entry, one launch on their packed array
    # (4 x lanes elements), as the main path runs it; then mul, add, sub
    entry = run("fp_ops", lambda a: bi.fp_ops_kernel(bi.FP_TO_MONT, a),
                bi._mont_from_int_plain, (put(prep["lane_ints"]),))
    sig_x, pk_x, pk_y = gb.split_lane_ints(entry, lanes)
    for mode, op, plain in (("mul", bi.FP_MUL, bi._mont_mul_plain),
                            ("add", bi.FP_ADD, bi._add_mod_plain),
                            ("sub", bi.FP_SUB, bi._sub_mod_plain)):
        run("fp_ops", lambda a, b, op=op: bi.fp_ops_kernel(op, a, b), plain,
            (sig_x, sig_x), mode=mode)
    flags = put(prep["flags"].astype(np.int32))

    sig_y, _ = run("g2_intake", k.g2_decompress_batch,
                   k._g2_decompress_plain, (sig_x, flags), repeats=2,
                   issue=cost.g2_decompress_lanes(lanes))
    one2 = put(np.broadcast_to(k.FP2_ONE, (lanes, 2, bi.NLIMBS)))
    z_one, z_zero = np.ones(lanes, bool), np.zeros(lanes, bool)

    def subgroup_issue(ok):
        return cost.g2_subgroup_lanes(z_one, z_zero, ok.cpu().numpy())

    ok = run("g2_intake", k.g2_in_subgroup_batch, k._g2_in_subgroup_plain,
             (sig_x, sig_y, one2), mode="subgroup", repeats=2,
             issue=subgroup_issue,
             old_muls=lambda ok: cost.g2_subgroup(z_zero, ok.cpu().numpy()))
    check(bool(ok.all()), "a signature of the batch failed the subgroup "
                          "check")

    u0, u1 = put(prep["u0"]), put(prep["u1"])
    mx, my, mz = run("hash_to_g2", k.hash_to_g2_batch_from_u,
                     k._hash_to_g2_plain, (u0, u1), repeats=2,
                     depth=cost.hash_to_g2_depth(small))

    one1 = put(np.broadcast_to(k.FP_ONE, (lanes, bi.NLIMBS)))
    pk_bits_np = k.scalars_to_bits(prep["pk_rands"], 64)
    sig_bits_np = k.scalars_to_bits(prep["sig_rands"], 64)
    pk_bits, sig_bits = put(pk_bits_np), put(sig_bits_np)
    g1_issue = cost.scalar_mul_lanes(pk_bits_np, 1)
    g2_issue = cost.scalar_mul_lanes(sig_bits_np, 2)
    spx, spy, spz = run("rlc_scale", k.g1_scalar_mul, k._g1_scalar_mul_plain,
                        (pk_x, pk_y, one1, pk_bits), issue=g1_issue,
                        old_muls=cost.scalar_mul(pk_bits_np, 1))
    ssx, ssy, ssz = run("rlc_scale", k.g2_scalar_mul,
                        k._g2_scalar_mul_plain, (sig_x, sig_y, one2, sig_bits),
                        mode="G2", issue=g2_issue,
                        old_muls=cost.scalar_mul(sig_bits_np, 2))
    # the segment sums on the batch's layout (its host arrays, as the
    # main path passes them), then on one segment of 10,000 lanes (every
    # signer of one message) and on 10,000 one-lane segments, held limb for
    # limb (canonically) to the plain version, which adds in the same order
    def seg_run(starts, ends, mode=None):
        adds = cost.g1_segment_sum_depth(starts, ends)
        return run("g1_segment_sum", k.g1_segment_sum,
                   k._g1_segment_sum_plain, (spx, spy, spz, starts, ends),
                   mode=mode,
                   depth=adds * cost.W_JAC_ADD_DEPTH or None,
                   design=f"one cooperative launch, trees over pieces of "
                          f"{k.g1_segment_t(len(starts), len(ends))} lanes, "
                          f"{adds} additions deep (a group of four threads "
                          f"an addition, {cost.W_JAC_ADD_DEPTH} steps)")

    gpx, gpy, gpz = seg_run(prep["starts"], prep["ends"])
    m = 10000
    if flagship:
        one = np.zeros(lanes, np.int32)
        one[[0, m]] = 1
        seg_run(one, np.array([m - 1] + [0] * (small - 1), np.int32),
                mode=f"one segment of {m} lanes")
        single = np.ones(lanes, np.int32)
        seg_run(single, np.arange(m, dtype=np.int32),
                mode=f"{m} one-lane segments")
    ax, ay, az = run("g2_sum", k.g2_sum, k._g2_sum_plain, (ssx, ssy, ssz),
                     depth=cost.g2_sum_depth(lanes),
                     design=f"a tree over {min(-(-lanes // 128), 128)} "
                            f"blocks of 128 threads, then one",
                     projective=True)
    # the Q side in one launch (the message points, then the aggregate),
    # then the group sums; the bound is the function's least work on these
    # inputs (one inverse a call: its Euclid's word operations beside the
    # products), with the kernel's own count (a binary inverse a lane) and
    # the count with a Fermat inverse a lane beside
    q = tuple(torch.cat([m, a[None]]) for m, a in ((mx, ax), (my, ay),
                                                   (mz, az)))
    fermat = cost.FP_INV - cost.FP_INV_BINARY
    qx, qy = run("affine", k.jacobian_to_affine_fp2,
                 k._jacobian_to_affine_fp2_plain, q,
                 kernel_ops=cost.affine_int_ops(q[2], 2),
                 old_muls=cost.affine(small + 1, 2) + (small + 1) * fermat)
    apx, apy = run("affine", k.jacobian_to_affine_fp,
                   k._jacobian_to_affine_fp_plain, (gpx, gpy, gpz),
                   mode="G1", kernel_ops=cost.affine_int_ops(gpz, 1),
                   old_muls=cost.affine(small, 1) + small * fermat)

    pad = gb._pad_cache()
    px = torch.cat([apx, put(pad.neg_g_x)])
    py = torch.cat([apy, put(pad.neg_g_y)])
    mask = put(prep["mask"].astype(np.int32))
    n_pairs = px.shape[0]
    fs = run("miller_loop", k.miller_loop_batch,
             lambda *a: k._mask_to_one(k._miller_loop_plain(*a[:4]), a[4]),
             (px, py, qx, qy, mask), repeats=2, depth=cost.miller_loop_depth(n_pairs),
             design=cost.miller_loop_design(n_pairs))
    # the verification past 128 messages: its pairs tiled to 10,241 lanes,
    # with the live lanes of 127 messages (the message lanes and the
    # aggregate lane, as the sharded path on one card sends: run on the
    # live pairs alone) and with every lane live (a thread a pair)
    wide = lanes + 1
    tile = torch.arange(wide, device=dev) % n_pairs
    pairs = tuple(t[tile].contiguous() for t in (px, py, qx, qy))
    live = np.zeros(wide, bool)
    live[:127] = live[-1] = True
    for label, m in (((f"{wide} pairs, {int(live.sum())} live", live),
                      (f"{wide} pairs, all live", None)) if flagship
                     else ()):
        ran = cost.miller_loop_pairs(wide, wide if m is None
                                     else int(m.sum()))
        args = pairs if m is None else pairs + (put(m.astype(np.int32)),)
        run("miller_loop", k.miller_loop_batch,
            lambda *a: (k._miller_loop_plain(*a[:4]) if len(a) == 4 else
                        k._mask_to_one(k._miller_loop_plain(*a[:4]), a[4])),
            args, mode=label, repeats=2, depth=cost.miller_loop_depth(ran),
            design=cost.miller_loop_design(ran))

    def final_plain(f):
        v = k._final_exponentiation_plain(k._fp12_product_plain(f))
        return v, k.fp12_eq(v, k.fp12_one_like((), v)).reshape(1)

    out, flag = run("final_exp", lambda f: k._final_exp_kernel(1, f),
                    final_plain, (fs,), repeats=2, depth=cost.final_exp_depth(fs.shape[0], 1))
    check(int(flag.item()) == 1, "the batch's pairing product is not one "
                                 "on the kernels")
    run("final_exp", k.fp12_product, k._fp12_product_plain, (fs,),
        mode="product",
        depth=cost.final_exp_depth(fs.shape[0], 0))
    torch.cuda.synchronize()


def bls_kernel_phase(bounds: Bounds, setup: dict) -> BlsKernelCheck:
    """The BLS kernels against their plain versions at the flagship
    batch's shapes: L = 10,240 signature and pubkey lanes, M = 128 message
    lanes, M + 1 Miller pairs."""
    c = BlsKernelCheck(bounds)
    bls_stage_chain(c.run, bls_prep(setup, setup["sets"], 10240, 128),
                    10240, 128)
    return c


def negative_batches(sets) -> dict:
    """The flagship batch with its middle set spoiled five ways, by
    label."""
    from lighthouse_tpu_torch.crypto.bls import SignatureSet
    from lighthouse_tpu_torch.crypto.bls12_381 import Fp2
    from lighthouse_tpu_torch.crypto.bls12_381.curve import B_G2, G2Point
    from lighthouse_tpu_torch.crypto.bls12_381.sig import g2_compress
    mid = len(sets) // 2
    s = sets[mid]
    xx = 1
    while True:
        yy = (Fp2(xx, 0) * Fp2(xx, 0) * Fp2(xx, 0) + B_G2).sqrt()
        if yy is not None:
            break
        xx += 1
    outside = g2_compress(G2Point(Fp2(xx, 0), yy))
    spoiled = {
        "one message changed": SignatureSet(s.signature, s.pubkeys,
                                            b"\xee" * 32),
        "signature of another message": SignatureSet(
            sets[mid + 1].signature, s.pubkeys, s.message),
        "infinity signature": SignatureSet(bytes([0xC0]) + bytes(95),
                                           s.pubkeys, s.message),
        "G2 point outside the subgroup": SignatureSet(outside, s.pubkeys,
                                                      s.message),
        "malformed bytes": SignatureSet(s.signature[:95], s.pubkeys,
                                        s.message),
    }
    out = {}
    for label, bad_set in spoiled.items():
        bad = list(sets)
        bad[mid] = bad_set
        out[label] = bad
    return out


def bls_slice_phase(setup: dict, card: str) -> dict:
    """The slice: the module entry ``crypto.bls.verify_signature_sets``
    (its default backend, ``gpu``, inside the ``bls_batch_verify`` span)
    on the 10,000-set batch (launch counts from its first call), its warm
    time, the negatives and the small batch, each verdict held to the C++
    host backend."""
    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch.bls_batch import N_SETS
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import gpu_backend
    from lighthouse_tpu_torch.profile_state_root import profiled

    cpp, gpu, sets = setup["cpp"], setup["gpu"], setup["sets"]
    check(gpu_backend.lane_options() == (128, 10240),
          f"lane options {gpu_backend.lane_options()} on the card")

    verify = bls.verify_signature_sets
    kernels.reset_counts()
    t0 = time.perf_counter()
    ok = verify(sets)
    cold_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.BLS_KERNELS}
    check(ok is True, "the 10,000-set batch did not verify on the card")
    print(f"bls slice: {N_SETS} sets verify True, first call {cold_s:.3f} "
          f"s [{card}]", flush=True)
    print(f"bls slice: launches on the main path {launches}", flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the BLS path")
    check(launches["affine"] == 2, f"affine launched {launches['affine']} "
                                   f"times, not 2 (the P side, the Q side)")
    check(launches["fp_ops"] == 1, f"fp_ops launched {launches['fp_ops']} "
                                   f"times, not once (the lane inputs' "
                                   f"Montgomery entry)")

    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        check(verify(sets) is True, "warm call failed")
        warm.append(time.perf_counter() - t0)
    warm_s = statistics.median(warm)
    # one more warm call under torch.profiler: the device's busy share and
    # its time by kernel (the profiler slows the host side of the call)
    prof = profiled(lambda: check(verify(sets) is True,
                                  "profiled call failed"))
    print(f"bls slice: under the profiler {prof['wall_ms']:.1f} ms wall, "
          f"device busy {prof['device_busy_ms']:.1f} ms "
          f"({100 * prof['device_busy_share']:.1f} %), by name "
          f"{prof['device_ms_by_name']}", flush=True)
    t0 = time.perf_counter()
    parsed = gpu_backend.parse_sets(gpu, sets)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gpu_backend.host_prepare(*parsed, 10240, 128)
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpp_ok = cpp.verify_signature_sets(sets)
    cpp_s = time.perf_counter() - t0
    check(cpp_ok is True, "the C++ backend rejects the flagship batch")
    print(f"bls slice: warm {[round(w, 4) for w in warm]} s, median "
          f"{warm_s * 1e3:.1f} ms = {N_SETS / warm_s:.0f} sets/s; host "
          f"parse {parse_s * 1e3:.1f} ms + prepare {prep_s * 1e3:.1f} ms; "
          f"C++ host backend {cpp_s:.2f} s, agrees [{card}]", flush=True)

    negatives = negative_batches(sets)
    neg_s, neg_cpp = {}, {}
    for label, bad in negatives.items():
        t0 = time.perf_counter()
        got = verify(bad)
        neg_s[label] = time.perf_counter() - t0
        neg_cpp[label] = cpp.verify_signature_sets(bad)
        check(got is False and neg_cpp[label] is False,
              f"negative batch '{label}': gpu {got}, C++ {neg_cpp[label]}")
    print(f"bls slice: the five negative batches verify False on the card "
          f"and on the C++ backend ({', '.join(f'{l} {t:.3f} s' for l, t in neg_s.items())})",
          flush=True)

    small = sets[:100]
    t0 = time.perf_counter()
    check(verify(small) is True and
          cpp.verify_signature_sets(small) is True,
          "the 100-set batch did not verify")
    small_s = time.perf_counter() - t0
    print(f"bls slice: 100-set batch (128 lanes) verifies True, "
          f"{small_s:.3f} s with the C++ check", flush=True)
    return {"launches": launches, "cold_s": cold_s, "warm_s": warm,
            "warm_median_s": warm_s, "sets_per_s": N_SETS / warm_s,
            "host_parse_s": parse_s, "host_prepare_s": prep_s,
            "cpp_verify_s": cpp_s, "negative_s": neg_s,
            "negative_cpp": neg_cpp, "profile": prof,
            "small_batch_s": small_s, "sign_s": setup["sign_s"],
            "pubkey_warm_s": setup["pubkey_warm_s"]}



def multigpu_phase(bounds: Bounds, setup: dict, card: str):
    """The sharded paths on every card of the machine (``n`` ranks, one
    process a card, NCCL): ``entry.dryrun_multigpu(n)`` (the four checks
    of the JAX dryrun against the single-device results), then the
    full-width run (the 1M-validator columns' sharded roots and the 10k
    batch's sharded verification, each against the single-GPU result,
    with the pubkey cache of phase 4), each sharded program against the
    single-device composition, and rank 0's kernel launches on the
    full-width path against their plain versions at that path's shapes.
    Returns the programs' JSON rows and their modes, the kernels' further
    modes, and the report."""
    import torch

    from lighthouse_tpu_torch import entry

    n = torch.cuda.device_count()
    print(f"multigpu: n = {n} ranks, one a card [{card}]", flush=True)
    dry = entry.dryrun_multigpu(n)
    print(f"multigpu dryrun: {dry['checks']} in {dry['seconds']:.1f} s "
          f"({dry['sets']} sets on {dry['lanes']} lanes); launches per "
          f"rank {dry['launches']['programs']}; all_gather bytes "
          f"{dry['gathered']}", flush=True)
    full = entry.multigpu_run(n, sets=setup["sets"], gpu=setup["gpu"])
    print(f"multigpu full width: {full['checks']} in {full['seconds']:.1f} "
          f"s; roots {full['roots']} equal the single-GPU roots",
          flush=True)
    print(f"multigpu full width: sharded state root (copy to the cards "
          f"included) median {full['root_ms']:.2f} ms of "
          f"{[round(x, 2) for x in full['root_ms_all']]}, the step on "
          f"resident shards {full['root_step_ms']:.2f} ms; first "
          f"{full['root_first_ms']:.1f} ms [{card}]", flush=True)
    sets_per_s = len(setup["sets"]) / full["verify_ms"] * 1e3
    print(f"multigpu full width: sharded verify of {len(setup['sets'])} "
          f"sets at {full['lanes']} lanes {full['verify']} (single GPU "
          f"{full['single_verify']}), set 1 corrupted {full['verify_bad']} "
          f"(single GPU {full['single_verify_bad']}); warm median "
          f"{full['verify_ms']:.1f} ms of "
          f"{[round(x, 1) for x in full['verify_ms_all']]} = "
          f"{sets_per_s:.0f} sets/s; first {full['verify_first_ms']:.1f} "
          f"ms; host prepare on rank 0 {full['prep_ms']:.1f} ms; single "
          f"GPU verify {full['single_verify_ms']:.1f} ms [{card}]",
          flush=True)
    print(f"multigpu full width: launches per rank "
          f"{full['launches']['programs']}; kernels on rank 0 "
          f"{full['launches']['kernels']}; all_gather bytes "
          f"{full['gathered']}", flush=True)
    on_path = ("hash64", "fp_ops", "g2_intake", "hash_to_g2", "rlc_scale",
               "g1_segment_sum", "g2_sum", "affine", "miller_loop",
               "final_exp")
    for name in on_path:
        check(full["launches"]["kernels"][name] > 0,
              f"kernel {name} was not launched on the sharded path")
    path_modes = entry.kernel_modes(full, bounds)
    for name, recs in path_modes.items():
        for m in recs:
            label = f"{name} [{m['mode']}]"
            check(m["max_abs_err"] == 0, f"{label}: kernel != plain "
                                         f"(max_abs_err {m['max_abs_err']})")
            print(f"kernel {label}: ok equal to the plain version, "
                  f"{m['ms']:.4f} ms (plain {m['plain_ms']:.1f} ms, bound "
                  f"{m['bound_ms']:.4f} ms by {m['bound_by']})", flush=True)
    parts = full["subtree_parts_ms"]
    print(f"multigpu full width: the validators' subtree program in parts "
          f"on rank 0: local subtree {parts['local_subtree']:.4f} ms, "
          f"all_gather {parts['all_gather']:.4f} ms, top tree "
          f"{parts['top_tree']:.4f} ms [{card}]", flush=True)
    rows, modes = entry.program_rows(dry, full, bounds)
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} was not launched on the "
                                   f"sharded path")
        check(row["max_abs_err"] == 0, f"{row['name']} != its single-device "
                                       f"composition")
        extra = "; ".join(f"{m['mode']} {m['ms']:.4f} ms (plain "
                          f"{m['plain_ms']:.3f}, bound {m['bound_ms']:.4f})"
                          for m in modes.get(row["name"], []))
        print(f"kernel {row['name']}: ok equal to the single-device "
              f"composition, {row['ms']:.4f} ms (plain {row['plain_ms']:.3f} "
              f"ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']}), "
              f"launches a rank {row['launches_by_path']}"
              + (f"; {extra}" if extra else ""), flush=True)
    return rows, modes, path_modes, {"dryrun": dry, "full_width": full}


def mxu_build() -> dict:
    """Build the mode-1 and mode-2 variants of every kernel that has
    them, all at once; print the time and each variant's registers, stack
    and spills."""
    from lighthouse_tpu_torch import kernels
    variants = [k.variant(m) for m in (1, 2) for k in kernels.KERNELS.values()
                if k.mxu_variants]
    build_s = kernels.build_all(variants)
    keys = {k.build_key for k in variants}
    summary = build_summary({key: log for key, log in
                             kernels.BUILD_LOGS.items() if key in keys})
    print(f"mxu build: {len(variants)} variants from {len(keys)} libraries "
          f"in {build_s:.1f} s (nvcc -DLH_FP_MODE=1,2, one process each)",
          flush=True)
    for src, entries in summary.items():
        for e in entries:
            print(f"mxu build: {src} {e['entry']}: {e.get('registers')} "
                  f"registers, {e.get('stack')} B stack, "
                  f"{e.get('spill_stores')}/{e.get('spill_loads')} B spill "
                  f"stores/loads", flush=True)
    return {"build_s": build_s, "build": summary}


def mxu_kernel_checks(bounds: Bounds, base: BlsKernelCheck,
                      mxu: int) -> BlsKernelCheck:
    """Every BLS kernel's mode-``mxu`` variant on the inputs phase 4 gave
    each kernel (the flagship batch's shapes: 10,240 signature and pubkey
    lanes, 128 message lanes, 129 Miller pairs; the Miller loop also at
    10,241 pairs on each of its designs), held canonical-exact
    against phase 4's plain outputs on those inputs, and timed."""
    c = BlsKernelCheck(bounds, mxu=mxu)
    for call in base.calls:
        c.rerun(call)
    return c


def mxu_batch(setup: dict, negative_cpp: dict, mxu: int, card: str) -> dict:
    """``crypto.bls.verify_signature_sets`` (backend ``gpu``) on the 10k
    batch under multiply lowering ``mxu``: True, every mode-``mxu``
    variant of the path launched (and no mode-0 kernel); the warm median
    of 3, sets/s, the device time by kernel for one call; the five
    negative batches False, as the C++ backend's verdicts of phase 4."""
    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch.bls_batch import N_SETS
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.profile_state_root import profiled

    sets, verify = setup["sets"], bls.verify_signature_sets
    kernels.reset_counts()
    t0 = time.perf_counter()
    ok = verify(sets)
    cold_s = time.perf_counter() - t0
    launches = {k.variant(mxu).name: k.variant(mxu).launches
                for k in kernels.BLS_KERNELS}
    mode0 = {k.name: k.launches for k in kernels.BLS_KERNELS if k.launches}
    check(ok is True, f"the 10,000-set batch did not verify under mode {mxu}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the mode-{mxu} "
                         f"BLS path")
    check(not mode0, f"mode-0 kernels launched under mode {mxu}: {mode0}")
    check(launches[f"fp_ops_mxu{mxu}"] == 1,
          f"fp_ops_mxu{mxu} launched {launches[f'fp_ops_mxu{mxu}']} times, "
          f"not once (the lane inputs' Montgomery entry)")
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        check(verify(sets) is True, f"warm call failed under mode {mxu}")
        warm.append(time.perf_counter() - t0)
    warm_s = statistics.median(warm)
    prof = profiled(lambda: check(verify(sets) is True,
                                  "profiled call failed"))
    neg_s = {}
    for label, bad in negative_batches(sets).items():
        t0 = time.perf_counter()
        got = verify(bad)
        neg_s[label] = time.perf_counter() - t0
        check(got is False and negative_cpp[label] is False,
              f"mode {mxu} negative batch '{label}': gpu {got}, C++ "
              f"{negative_cpp[label]}")
    print(f"mxu{mxu} batch: {N_SETS} sets verify True, first call "
          f"{cold_s:.3f} s, warm {[round(w, 4) for w in warm]} s, median "
          f"{warm_s * 1e3:.1f} ms = {N_SETS / warm_s:.0f} sets/s; five "
          f"negatives False as on the C++ backend [{card}]", flush=True)
    print(f"mxu{mxu} batch: launches {launches}", flush=True)
    print(f"mxu{mxu} batch: under the profiler {prof['wall_ms']:.1f} ms "
          f"wall, device busy {prof['device_busy_ms']:.1f} ms "
          f"({100 * prof['device_busy_share']:.1f} %), by name "
          f"{prof['device_ms_by_name']}", flush=True)
    return {"launches": launches, "cold_s": cold_s, "warm_s": warm,
            "warm_median_s": warm_s, "sets_per_s": N_SETS / warm_s,
            "negative_s": neg_s, "profile": prof}


def new_kernel_rows(bounds: Bounds, card: str) -> tuple[list[dict], dict]:
    """``sha256_messages`` (against hashlib at the JAX test's lengths;
    driven and timed at 2^20 messages of 200 bytes, 4 blocks) and
    ``fp12_pow_const`` (1,024 lanes, exponent |x|, and 5 lanes at
    exponents 0, 1 and of 100 bits, under each multiply lowering), each
    against its plain version on the same inputs; and
    ``reduce_wide_mod_p`` (one fp_ops launch) on 10,240 rows under each
    lowering. Counts are set to 0 before each entry point is driven and
    read after it; the checks and timings come after. (A short kernel's
    device time alone is ``compare_kernels``': late in a long process the
    profiler here lost most of its events.)"""
    import hashlib

    import torch

    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch.ops import bigint as bi
    from lighthouse_tpu_torch.ops import bls12_381 as k
    from lighthouse_tpu_torch.ops import bls_cost as cost
    from lighthouse_tpu_torch.ops import sha256 as sh

    dev = torch.device("cuda")
    rng = np.random.default_rng(404)
    rows, report = [], {}

    def row(name, source, replaces, launches, err, ms, plain_ms, bound):
        rows.append({"name": name, "route": "cuda",
                     "source": f"lighthouse_tpu_torch/csrc/{source}",
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": None})

    for length in (0, 1, 55, 56, 64, 100, 200):
        msgs = rng.integers(0, 256, size=(4, length), dtype=np.uint8)
        got = sh.tensor_to_words(sh.sha256_messages(
            sh.words_to_tensor(sh.pad_messages(msgs), dev)))
        for i in range(4):
            check(sh.words_to_chunks(got[i]) ==
                  hashlib.sha256(msgs[i].tobytes()).digest(),
                  f"sha256_messages != hashlib at {length} bytes")
    n, length = 1 << 20, 200
    msgs = rng.integers(0, 256, size=(n, length), dtype=np.uint8)
    words = sh.words_to_tensor(sh.pad_messages(msgs), dev)
    nblocks = int(words.shape[1])
    kernels.reset_counts()
    with roofline.capture() as calls:
        got = sh.sha256_messages(words)
    torch.cuda.synchronize()
    launches = kernels.SHA256_MESSAGES.launches
    want, plain_ms = timed(lambda: sh._sha256_messages_plain(words))
    err = max_abs_err(got, want)
    check(err == 0, f"sha256_messages != plain (max_abs_err {err})")
    for i in (0, n - 1):
        check(sh.words_to_chunks(sh.tensor_to_words(got[i])) ==
              hashlib.sha256(msgs[i].tobytes()).digest(),
              "sha256_messages != hashlib at 2^20 messages")
    ms = time_cuda(lambda: sh.sha256_messages(words), 10)
    bound = (calls[-1]["bound_ms"], calls[-1]["bound_by"])
    print(f"kernel sha256_messages: ok bit-exact and equal to hashlib, "
          f"{n} messages of {length} bytes ({nblocks} blocks) {ms:.4f} ms "
          f"(plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms by "
          f"{bound[1]}) [{card}]", flush=True)
    row("sha256_messages", "sha256_messages.cu",
        "lighthouse_tpu/ops/sha256.py:211", launches, err, ms, plain_ms,
        bound)
    del msgs, words, got, want

    lanes, e = 1024, k._X_ABS
    vals = [int.from_bytes(rng.bytes(48), "little") % bi.P_INT
            for _ in range(lanes * 12)]
    f = torch.from_numpy(k.fp_encode(vals).reshape(lanes, 2, 3, 2,
                                                   bi.NLIMBS)).to(dev)
    wide_vals = [int.from_bytes(rng.bytes(96), "little")
                 for _ in range(10240)]
    mask = (1 << 384) - 1
    wide = torch.from_numpy(np.concatenate(
        [bi.ints_to_limbs([v & mask for v in wide_vals]),
         bi.ints_to_limbs([v >> 384 for v in wide_vals])], axis=1)).to(dev)
    # the edges of the exponent on a few lanes: 0 (f itself), 1, 100 bits
    edges = (0, 1, (1 << 99) | 0x5A5A5A5A5A5)
    few = f[:5].contiguous()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    prev = bi.mxu_mode()
    try:
        for mxu in (0, 1, 2):
            bi.set_mxu_mode(mxu)
            kern = kernels.FP12_POW.variant(mxu)
            kernels.reset_counts()
            with roofline.capture() as calls:
                got = k.fp12_pow_const(f, e)
            torch.cuda.synchronize()
            launches = kern.launches
            want, plain_ms = timed(lambda: k._fp12_pow_const_plain(f, e))
            err = field_err(got, want)
            check(err == 0, f"{kern.name} != plain (max_abs_err {err})")
            for edge in edges:
                got_e = k.fp12_pow_const(few, edge)
                err_e = field_err(got_e, k._fp12_pow_const_plain(few, edge))
                check(err_e == 0 and (edge or torch.equal(got_e, few)),
                      f"{kern.name} at a {edge.bit_length()}-bit exponent "
                      f"!= plain (max_abs_err {err_e})")
            ms = time_cuda(lambda: k.fp12_pow_const(f, e), 3)
            roof = calls[-1]
            bound = (roof["bound_ms"], roof["bound_by"])
            alg_ms = bounds(roof["bytes"], roof["field_muls"]
                            * cost.fp_mul_pipe_ops(mxu)["issue"])[0]
            picked = cost.fp12_pow_lanes(lanes, sms)
            steps = cost.fp12_pow_depth(e)
            report[f"{kern.name}_algorithm_bound_ms"] = alg_ms
            report[f"{kern.name}_design"] = {
                "lanes_a_block": picked, "steps": steps,
                "us_per_step": ms * 1e3 / steps}
            print(f"kernel {kern.name}: ok canonical-exact, {lanes} lanes, "
                  f"exponent |x| (and 5 lanes at exponents of 0, 1 and 100 "
                  f"bits), {ms:.4f} ms (plain {plain_ms:.1f} ms, bound "
                  f"{bound[0]:.4f} ms by {bound[1]}; the lowering's own "
                  f"issue count: {alg_ms:.4f} ms); {picked} lanes a block, "
                  f"critical path {steps} dependent steps, "
                  f"{ms * 1e3 / steps:.2f} us a step [{card}]",
                  flush=True)
            row(kern.name, "bls/fp12_pow.cu",
                "lighthouse_tpu/ops/bls12_381.py:337", launches, err, ms,
                plain_ms, bound)

            kernels.reset_counts()
            with roofline.capture() as calls:
                got = bi.reduce_wide_mod_p(wide)
            torch.cuda.synchronize()
            fp_launches = kernels.FP_OPS.variant(mxu).launches
            want, plain_ms = timed(lambda: bi._reduce_wide_plain(wide))
            err = field_err(got, want)
            check(err == 0 and fp_launches == 1,
                  f"reduce_wide_mod_p under mode {mxu}: max_abs_err {err}, "
                  f"{fp_launches} fp_ops launches, not one")
            ms = time_cuda(lambda: bi.reduce_wide_mod_p(wide), 10)
            # the function's least work (fp_ops' declared cost): one read
            # of the [n, 64] rows, one write of [n, 32], two products a row
            roof = calls[-1]
            bound = (roof["bound_ms"], roof["bound_by"])
            alg_ms = bounds(roof["bytes"], roof["field_muls"]
                            * cost.fp_mul_pipe_ops(mxu)["issue"])[0]
            report[f"reduce_wide_mxu{mxu}"] = {
                "rows": len(wide_vals), "fp_ops_launches": fp_launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "algorithm_bound_ms": alg_ms}
            print(f"reduce_wide_mod_p mode {mxu}: ok canonical-exact, "
                  f"{len(wide_vals)} rows, {fp_launches} fp_ops launch, "
                  f"{ms:.4f} ms a call with the wrapper (plain "
                  f"{plain_ms:.1f} ms, bound {bound[0]:.4f} ms by "
                  f"{bound[1]}; the lowering's own issue count: "
                  f"{alg_ms:.4f} ms) [{card}]", flush=True)
    finally:
        bi.set_mxu_mode(prev)
    return rows, report


def mxu_phase(bounds: Bounds, setup: dict, base: BlsKernelCheck,
              negative_cpp: dict, card: str
              ) -> tuple[list[dict], dict, dict]:
    """Phase 6: the multiply lowerings 1 and 2 (``LHTPU_BIGINT_MXU``).
    Builds their variants; the ``mxu`` bench (``measure.mont_mul_modes``
    at B = 65,536, K = 32); under each mode every BLS kernel variant on
    the inputs phase 4 gave its kernel, against phase 4's plain outputs
    (``base``, the flagship shapes), and the 10k batch through
    ``verify_signature_sets``; then ``sha256_messages``,
    ``fp12_pow_const`` and ``reduce_wide_mod_p``. The mode is 0 again
    after it, also on a failure. Returns the JSON rows, their modes and
    the report."""
    from lighthouse_tpu_torch import measure
    from lighthouse_tpu_torch.ops import bigint as bi

    t_phase = time.perf_counter()
    rows, modes, report = [], {}, {}
    try:
        report.update(mxu_build())
        mm = measure.mont_mul_modes(batch=1 << 16, k=32)
        check(mm["modes_agree"], "the three modes' mont_mul chains differ "
                                 "as field values")
        for mode, err in mm["max_abs_err_vs_plain"].items():
            check(err == 0, f"mode {mode} mont_mul chain != its plain "
                            f"chain (max_abs_err {err})")
        print(f"mxu bench: mont_mul/s at B = {mm['batch']}, K = {mm['k']} "
              f"(best of 3): " + ", ".join(
                  f"mode {m} {v:.4g}" for m, v in mm["per_sec"].items())
              + f"; max(mode 1, mode 2) / mode 0 = "
              f"{mm['speedup_vs_mode0']:.4f}; the three modes' chains "
              f"equal as field values, each equal to its plain chain on "
              f"the first 1,024 lanes [{card}]", flush=True)
        report["mont_mul_modes"] = mm
        for mxu in (1, 2):
            bi.set_mxu_mode(mxu)
            c = mxu_kernel_checks(bounds, base, mxu)
            batch = mxu_batch(setup, negative_cpp, mxu, card)
            bi.set_mxu_mode(0)
            for row in c.rows:
                row["launches"] = batch["launches"][row["name"]]
            rows += c.rows
            modes.update(c.modes)
            report[f"batch_mxu{mxu}"] = batch
            report[f"bls_field_muls_mxu{mxu}"] = c.muls
        new_rows, new_report = new_kernel_rows(bounds, card)
        rows += new_rows
        report.update(new_report)
    finally:
        bi.set_mxu_mode(0)
    report["seconds"] = time.perf_counter() - t_phase
    print(f"mxu phase: {report['seconds']:.1f} s", flush=True)
    return rows, modes, report


def _median_ms(fn, reps: int = 3) -> tuple[float, list[float]]:
    """(median, all) host milliseconds of ``reps`` calls of ``fn``."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out), out


def stf_phase(bounds: Bounds, setup: dict,
              card: str) -> tuple[dict, BlsKernelCheck]:
    """The block on the card: the 1M-validator Altair workload of
    ``stf_workload`` (a block covering the prior slot, really signed)
    through ``per_block_processing`` with its signatures verified as one
    batch on the ``gpu`` backend, then the post-block root and the epoch
    with its root on the card, each held to the JAX package's root; the
    same block on the ``cpp`` backend; two negative blocks on both; the
    warm times with the signature call's split; the BLS kernels against
    their plain versions on the block batch's own lane inputs."""
    import os

    import torch

    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch import stf_workload as sw
    from lighthouse_tpu_torch.bls_batch import warm_pubkeys
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import gpu_backend
    from lighthouse_tpu_torch.profile_state_root import profiled
    from lighthouse_tpu_torch.state_transition import (
        BlockProcessingError, BlockSignatureVerifier, VerifySignatures,
        per_block_processing, per_epoch_processing,
    )

    cpp, gpu = setup["cpp"], setup["gpu"]
    check(bls.get_backend() is gpu, "the BLS module's backend is not gpu")
    cores = os.cpu_count() or 8
    t0 = time.perf_counter()
    w = sw.build_workload(cpp, threads=cores)
    build_s = time.perf_counter() - t0
    pre, block = w.state, w.block
    body = block.message.body

    def block_sets(state):
        v = BlockSignatureVerifier(state)
        v.include_entire_block(block)
        return v.sets

    sets = block_sets(pre)
    n_msgs = len({s.message for s in sets})
    n_keys = sum(len(s.pubkeys) for s in sets)
    check(len(body.attestations) == 64 and len(sets) == 67
          and n_msgs == 67, f"the block has {len(body.attestations)} "
                            f"attestations, {len(sets)} signature sets over "
                            f"{n_msgs} messages, not 64, 67 and 67")
    t0 = time.perf_counter()
    warmed = warm_pubkeys(gpu, sets, processes=cores)
    warm_s = time.perf_counter() - t0
    print(f"stf setup: {len(pre.validators)} validators at slot "
          f"{pre.slot}, {len(w.rows)} signer rows with interop pubkeys, "
          f"the block signed (C++ host backend, {cores} threads) in "
          f"{build_s:.1f} s; {len(sets)} signature sets over {n_msgs} "
          f"messages, {n_keys} pubkeys; {warmed} pubkeys into the gpu "
          f"backend's cache in {warm_s:.1f} s ({cores} processes) [{card}]",
          flush=True)

    # the path: the pre-state's root (its trees built on the card), the
    # block with its signatures on, the post-block root, the epoch on a
    # copy at the epoch's last slot and its root
    kernels.reset_counts()
    t0 = time.perf_counter()
    pre_root = pre.hash_tree_root()
    pre_root_ms = (time.perf_counter() - t0) * 1e3
    post = pre.copy()
    t0 = time.perf_counter()
    # per_block_processing in the stf_block span, as the chain imports a
    # block (its catalog histogram stf_block_seconds)
    with tracing.span("stf_block", slot=int(block.message.slot)):
        per_block_processing(post, block, VerifySignatures.TRUE)
    first_ms = (time.perf_counter() - t0) * 1e3
    post_root = post.hash_tree_root()
    ep = post.copy()
    ep.slot = sw.EPOCH_SLOT
    per_epoch_processing(ep)
    epoch_root = ep.hash_tree_root()
    torch.cuda.synchronize()
    launches = {k.name: k.launches
                for k in kernels.STATE_ROOT_KERNELS + kernels.BLS_KERNELS}
    check(post_root.hex() == EXPECTED_BLOCK_ROOT_1M,
          f"post-block root {post_root.hex()} != {EXPECTED_BLOCK_ROOT_1M}")
    check(epoch_root.hex() == EXPECTED_EPOCH_ROOT_1M,
          f"post-epoch root {epoch_root.hex()} != {EXPECTED_EPOCH_ROOT_1M}")
    print(f"stf block: pre-state root {pre_root.hex()} on the card "
          f"{pre_root_ms:.1f} ms; per_block_processing with signatures on "
          f"(gpu backend) accepted, first call {first_ms:.1f} ms; post-block "
          f"root {post_root.hex()} ok; the epoch at slot {sw.EPOCH_SLOT}, "
          f"root {epoch_root.hex()} ok [{card}]", flush=True)
    print(f"stf block: launches on the block path {launches}", flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the block path")
    check(launches["affine"] == 2, f"affine launched {launches['affine']} "
                                   f"times on the block path, not 2")
    check(launches["fp_ops"] == 1, f"fp_ops launched {launches['fp_ops']} "
                                   f"times on the block path, not once")

    small, big = gpu_backend.lane_options()
    parsed = gpu_backend.parse_sets(gpu, sets)
    check(parsed is not None, "the block's batch did not parse")
    lanes = small if len(sets) <= small else big
    prep = gpu_backend.host_prepare(*parsed, lanes, small)
    pairs = prep["msg_lanes"] + 1
    print(f"stf block: the batch {len(sets)} sets, {prep['n_groups']} "
          f"messages, {lanes} lanes, {prep['msg_lanes']} message lanes, "
          f"{pairs} Miller pairs ({int(prep['mask'].sum())} live)",
          flush=True)
    check(lanes == 128 and prep["n_groups"] == 67,
          f"the block's batch ran at {lanes} lanes with "
          f"{prep['n_groups']} messages, not 128 and 67")

    # the same block on the C++ host backend, and the negatives on both
    negatives = sw.negative_blocks(pre, block, cpp)

    def rejects(bad) -> bool:
        try:
            per_block_processing(pre.copy(), bad, VerifySignatures.TRUE)
        except BlockProcessingError:
            return True
        return False

    verdicts = {}
    bls.set_backend("cpp")
    try:
        t0 = time.perf_counter()
        per_block_processing(pre.copy(), block, VerifySignatures.TRUE)
        cpp_ms = (time.perf_counter() - t0) * 1e3
        verdicts["cpp"] = {label: rejects(bad)
                           for label, bad in negatives.items()}
    finally:
        bls.set_backend("gpu")
    verdicts["gpu"] = {label: rejects(bad) for label, bad in negatives.items()}
    for backend, got in verdicts.items():
        for label, raised in got.items():
            check(raised, f"negative block '{label}' accepted on {backend}")
    print(f"stf block: accepted on the cpp backend ({cpp_ms:.1f} ms); "
          f"both negative blocks ({', '.join(negatives)}) raise on gpu and "
          f"cpp [{card}]", flush=True)

    # timed: warm calls, each on a fresh copy of the pre-state (the copy
    # outside the time), the post-block root after each signatures-on call
    def one_block(verify, times=None, roots=None):
        st = pre.copy()
        t0 = time.perf_counter()
        with tracing.span("stf_block", slot=int(block.message.slot)):
            per_block_processing(st, block, verify)
        t1 = time.perf_counter()
        if times is not None:
            times.append((t1 - t0) * 1e3)
        if roots is not None:
            check(st.hash_tree_root() == post_root, "post-block root moved")
            roots.append((time.perf_counter() - t1) * 1e3)

    true_all, false_all, root_ms = [], [], []
    for _ in range(3):
        one_block(VerifySignatures.TRUE, true_all, root_ms)
        one_block(VerifySignatures.FALSE, false_all)
    true_ms = statistics.median(true_all)
    false_ms = statistics.median(false_all)
    sets_ms, _ = _median_ms(lambda: block_sets(pre))
    parse_ms, _ = _median_ms(lambda: gpu_backend.parse_sets(gpu, sets))
    prep_ms, _ = _median_ms(
        lambda: gpu_backend.host_prepare(*parsed, lanes, small))
    # the device's busy time: one call under the profiler, read only when
    # the profile holds at least the call's kernel launches (late in a
    # long process the profiler has lost events)
    prof = profiled(lambda: one_block(VerifySignatures.TRUE))
    call_launches = sum(launches[k.name] for k in kernels.BLS_KERNELS)
    profiled_ok = prof["device_events"] >= call_launches
    busy_ms = prof["device_busy_ms"] if profiled_ok else None
    rest_ms = (true_ms - sets_ms - parse_ms - prep_ms - busy_ms
               if profiled_ok else None)
    epoch_ms, epoch_root_ms = [], []
    for _ in range(3):
        e = post.copy()
        e.slot = sw.EPOCH_SLOT
        t0 = time.perf_counter()
        per_epoch_processing(e)
        t1 = time.perf_counter()
        check(e.hash_tree_root() == epoch_root, "post-epoch root moved")
        epoch_ms.append((t1 - t0) * 1e3)
        epoch_root_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"stf timed: per_block_processing median of 3 warm calls, "
          f"signatures on {true_ms:.1f} ms {[round(x, 1) for x in true_all]}"
          f", off {false_ms:.1f} ms {[round(x, 1) for x in false_all]} "
          f"[{card}]", flush=True)
    device = (f"device busy {busy_ms:.2f} ms (one profiled call, "
              f"{prof['device_events']} device events), the rest of the "
              f"block's host work {rest_ms:.1f} ms; the card idle "
              f"{100 * (1 - prof['device_busy_share']):.1f} % of that call "
              f"({prof['wall_ms']:.1f} ms wall under the profiler); device "
              f"ms by name {prof['device_ms_by_name']}" if profiled_ok else
              f"device busy not measured (the profile holds "
              f"{prof['device_events']} device events, fewer than the "
              f"call's {call_launches} kernel launches)")
    print(f"stf timed: the signatures-on call split: set construction "
          f"{sets_ms:.1f} ms, parse_sets {parse_ms:.1f} ms, host_prepare "
          f"{prep_ms:.1f} ms, {device} [{card}]", flush=True)
    print(f"stf timed: post-block root {statistics.median(root_ms):.1f} ms "
          f"{[round(x, 1) for x in root_ms]}; the epoch "
          f"{statistics.median(epoch_ms):.1f} ms "
          f"{[round(x, 1) for x in epoch_ms]} and its root "
          f"{statistics.median(epoch_root_ms):.1f} ms "
          f"{[round(x, 1) for x in epoch_root_ms]} [{card}]", flush=True)

    # the BLS kernels against their plain versions on the block batch's
    # lane inputs (its shapes: 128 lanes, 129 Miller pairs)
    c = BlsKernelCheck(bounds)
    bls_stage_chain(c.run, bls_prep(setup, sets, lanes, small), lanes, small,
                    flagship=False)
    # the memory ledger at the end of the phase, its 1M states' trees live
    torch.cuda.synchronize()
    memory = ledger.ledger_snapshot()
    return {"ledger": memory, "build_s": build_s, "pubkey_warm_s": warm_s,
            "signer_rows": len(w.rows), "sets": len(sets),
            "messages": n_msgs, "pubkeys": n_keys, "lanes": lanes,
            "miller_pairs": pairs, "live_pairs": int(prep["mask"].sum()),
            "launches": launches, "pre_root": pre_root.hex(),
            "pre_root_ms": pre_root_ms, "first_block_ms": first_ms,
            "post_root": post_root.hex(), "epoch_root": epoch_root.hex(),
            "cpp_block_ms": cpp_ms, "negatives": verdicts,
            "block_true_ms": true_ms, "block_true_ms_all": true_all,
            "block_false_ms": false_ms, "block_false_ms_all": false_all,
            "sets_ms": sets_ms, "parse_ms": parse_ms, "prepare_ms": prep_ms,
            "device_busy_ms": busy_ms, "rest_ms": rest_ms, "profile": prof,
            "post_root_ms": root_ms, "epoch_ms": epoch_ms,
            "epoch_root_ms": epoch_root_ms}, c


def _sampled(slot: int, name: str) -> float | None:
    """The graftwatch sampler's value of series ``name`` in the row of
    ``slot`` (a phase: the smoke ticks the sampler once a phase), or
    None."""
    slots, vals = timeseries.get_sampler().series(name)
    hit = np.flatnonzero(slots == slot)
    return None if not hit.size or np.isnan(vals[hit[0]]) else float(
        vals[hit[0]])


def obs_phase(card: str, stf: dict) -> dict:
    """Phase 8: what the observability layer kept of phases 1-7, read and
    checked (nothing heavy runs again): every kernel that launched (the 15
    in mode 0, the mode-1/2 variants phase 6 ran) has a roofline record on
    the card with a device ms and a utilization of the peak in (0, 1.05],
    and no record on the card reads above 1.05; the memory ledger at the
    end of phase 7 (platform ``cuda``, the card's kind and memory, bytes in
    use, the live merkle trees attributed within them); a second
    ``build_all`` of every library (no miss); the catalog metrics of the
    state root, the BLS batch and the block in the sampler's rows; a
    flight dump rendered by the port's doctor (exit 0)."""
    import os
    import subprocess
    import tempfile

    import torch

    from lighthouse_tpu_torch import kernels

    t_phase = time.perf_counter()
    report: dict = {}

    # roofline records: the best sampled call of each variant on the card
    best, n_records = {}, 0
    for recs in roofline.snapshot().values():
        for r in recs:
            if r["platform"] != "cuda" or r.get("bound_ms") is None:
                continue
            n_records += 1
            util = r["utilization_of_peak"]
            check(util is not None and util <= 1.05,
                  f"roofline {r['variant']} [{r['shapes']}]: utilization "
                  f"{util} of the peak, not at most 1.05 (the declared "
                  f"cost counts more than the call did)")
            if util > 0 and r["ms"] > 0 and util > best.get(
                    r["variant"], {}).get("utilization_of_peak", 0):
                best[r["variant"]] = r
    launched = [k.name for k in kernels.KERNELS.values()] + [
        k.variant(m).name for m in (1, 2) for k in kernels.KERNELS.values()
        if k.mxu_variants]
    for name in launched:
        check(name in best, f"kernel {name}: no roofline record on the card "
                            f"with a device ms and a utilization in (0, "
                            f"1.05]")
        r = best[name]
        print(f"roofline {name} [{r['shapes']}]: {r['ms']:.4f} ms on the "
              f"card (median of its samples {r['ms_median']:.4f}), "
              f"{r['bytes']} B, {r['ops']} int ops, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, utilization "
              f"{r['utilization_of_peak']:.4g} of the peak "
              f"({r['timed_calls']} timed of {r['calls']} calls) [{card}]",
              flush=True)
    print(f"roofline: {len(best)} kernel variants, {n_records} records on "
          f"the card; peak {next(iter(best.values()))['peak']}", flush=True)
    report["roofline"] = best
    report["roofline_records"] = roofline.snapshot()

    # the memory ledger at the end of phase 7
    mem = stf["ledger"]
    check(mem["platform"] == "cuda"
          and mem["device_kind"] == torch.cuda.get_device_name(0),
          f"ledger platform {mem['platform']} / {mem['device_kind']}")
    row = mem["hbm"][0]
    trees = mem["attribution"].get("ops.merkle_tree", {}).get(
        "levels", {}).get("live_bytes", 0)
    check(row["bytes_limit"] > 0 and row["bytes_in_use"] > 0,
          f"ledger row {row}: no bytes in use or no limit")
    check(0 < trees <= row["bytes_in_use"],
          f"the live merkle trees attribute {trees} B against "
          f"{row['bytes_in_use']} B in use")
    print(f"ledger (end of phase 7): {mem['platform']} {mem['device_kind']} "
          f"x {mem['chip_count']}: {row['bytes_in_use']} B in use (peak "
          f"{row['peak_bytes_in_use']}), {row['reserved']} B reserved, "
          f"{row['used_by_all']} B used by all of {row['bytes_limit']}; the "
          f"live merkle trees {trees} B; host RSS {mem['host']['rss_bytes']} "
          f"B [{card}]", flush=True)

    # the build accounting: phase 1's cold build and phase 6's variants,
    # then every library again, all found in _build/
    cold = cuda_accounting.snapshot()
    t0 = time.perf_counter()
    kernels.build_all(list(kernels.KERNELS.values()) + [
        k.variant(m) for m in (1, 2) for k in kernels.KERNELS.values()
        if k.mxu_variants])
    warm_s = time.perf_counter() - t0
    warm = cuda_accounting.snapshot()
    misses = warm["cache_misses"] - cold["cache_misses"]
    hits = warm["cache_hits"] - cold["cache_hits"]
    check(misses == 0 and hits > 0, f"the second build_all: {misses} "
                                    f"misses, {hits} hits")
    print(f"build accounting: {cold['builds']} nvcc builds, "
          f"{cold['build_seconds']:.1f} s summed over them (cold), "
          f"{cold['cache_hits']} cache hits before; the second build_all "
          f"{hits} hits, {misses} misses in {warm_s:.3f} s; "
          f"{warm['libraries_loaded']} libraries bound; {warm['h2d_bytes']} B "
          f"h2d, {warm['d2h_bytes']} B d2h accounted [{card}]", flush=True)
    report["build"] = {"cold": {k: v for k, v in cold.items()
                                if k != "libraries"},
                       "warm_s": warm_s, "warm_hits": hits,
                       "warm_misses": misses}

    # the catalog metrics, each in the row of the phase that fed it
    want = (("bls_batch_verify_sigs.p50", 4),
            ("bls_batch_verify_sigs.count", 4),
            ("beacon_batch_verify_seconds.count", 4),
            ("beacon_batch_verify_seconds.p50", 4),
            ("tree_hash_root_seconds.count", 3),
            ("tree_hash_root_seconds.p50", 3),
            ("state_copy_seconds.count", 7), ("state_copy_seconds.p50", 7),
            ("stf_block_seconds.count", 7), ("stf_block_seconds.p50", 7),
            ("kernel_build_total", 1), ("kernel_build_seconds_total", 1),
            ("device_hbm_bytes_in_use", 7))
    metrics = {f"{n}@{slot}": _sampled(slot, n) for n, slot in want}
    missing = [k for k, v in metrics.items() if not v]
    check(not missing, f"catalog metrics not fed: {missing}")
    check(metrics["bls_batch_verify_sigs.p50@4"] == 10000,
          f"bls_batch_verify_sigs p50 in phase 4: "
          f"{metrics['bls_batch_verify_sigs.p50@4']}, not 10,000")
    print("catalog metrics (phase: value): " + ", ".join(
        f"{k.replace('@', ' @')} {v:.6g}" for k, v in metrics.items())
          + f" [{card}]", flush=True)
    slos = graftwatch.get().engine.status()
    print("slo: " + "; ".join(f"{n} {v['last_detail']}"
                              for n, v in slos.items()
                              if n in ("hbm_headroom", "kernel_build_steady",
                                       "compile_cache_hit_ratio")),
          flush=True)
    report["metrics"] = metrics

    # a flight dump, rendered by the port's doctor
    with tempfile.TemporaryDirectory() as tmp:
        path = flight.FlightRecorder(graftwatch.get()).dump(
            reason="chip_smoke", path=os.path.join(tmp, "dump.json"))
        doc = json.loads(Path(path).read_text())
        check(doc["cuda"]["builds"] > 0 and doc["device"]["platform"] == "cuda"
              and doc["device"]["roofline"], "the flight dump lacks its cuda "
                                              "or device section")
        proc = subprocess.run(
            [sys.executable, "-m", "lighthouse_tpu_torch.obs.doctor", path],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=300)
        dump_bytes = Path(path).stat().st_size
    check(proc.returncode == 0, f"the doctor exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    for line in lines[:4]:
        print(f"doctor: {line}", flush=True)
    print(f"doctor: exit 0, {len(lines)} lines for a {dump_bytes} B dump",
          flush=True)
    report["doctor_head"] = lines[:4]
    report["seconds"] = time.perf_counter() - t_phase
    print(f"obs phase: {report['seconds']:.1f} s", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from lighthouse_tpu_torch import kernels

    # phase 1: card and build
    card_line = nvidia_smi("name,power.limit")
    print(card_line, flush=True)
    sm_clock = float(nvidia_smi("clocks.max.sm").split()[0])
    build_s = kernels.build_all()
    summary = build_summary(kernels.BUILD_LOGS)
    print(f"build: {len(kernels.KERNELS)} kernels from "
          f"{len({k.source for k in kernels.KERNELS.values()})} sources in "
          f"{build_s:.1f} s (nvcc, sm_90a, one process per source); max SM "
          f"clock {sm_clock:.0f} MHz", flush=True)
    for src, entries in summary.items():
        for e in entries:
            print(f"build: {src} {e['entry']}: {e.get('registers')} "
                  f"registers, {e.get('stack')} B stack, "
                  f"{e.get('spill_stores')}/{e.get('spill_loads')} B spill "
                  f"stores/loads", flush=True)
    bounds = Bounds(sm_clock)
    # graftwatch ticks once a phase (slot = the phase's number), as a node
    # ticks it once a slot: each phase's metrics land in a row of their own
    graftwatch.on_slot(1)

    # phase 2: state-root kernels against their plain versions
    rows, modes = kernel_phase(bounds)
    graftwatch.on_slot(2)

    # phase 3: the state-root slice
    sl = slice_phase(card_line)
    graftwatch.on_slot(3)
    for row in rows:
        row["launches"] = sl["launches"][row["name"]]

    # phase 4: the BLS slice: the batch, its kernels against their plain
    # versions at its shapes, then the main path
    setup = bls_setup()
    bls_check = bls_kernel_phase(bounds, setup)
    bls = bls_slice_phase(setup, card_line)
    for row in bls_check.rows:
        row["launches"] = bls["launches"][row["name"]]
    rows += bls_check.rows
    modes.update(bls_check.modes)
    graftwatch.on_slot(4)

    # phase 5: the sharded paths over every card (n = device_count)
    par_rows, par_modes, path_modes, multigpu = multigpu_phase(
        bounds, setup, card_line)
    for name, recs in path_modes.items():
        row = next(r for r in rows if r["name"] == name)
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [m["max_abs_err"] for m in recs])
        modes.setdefault(name, []).extend(recs)
    rows += par_rows
    modes.update(par_modes)
    graftwatch.on_slot(5)

    # phase 6: the multiply lowerings 1 and 2, and the caller-less kernels
    mxu_rows, mxu_modes, mxu = mxu_phase(bounds, setup, bls_check,
                                         bls["negative_cpp"], card_line)
    rows += mxu_rows
    modes.update(mxu_modes)
    graftwatch.on_slot(6)

    # phase 7: the block on the card (the state transition at 1M
    # validators), its launches beside each kernel's row, its BLS kernel
    # checks at the block batch's shapes among the kernels' modes
    stf, stf_check = stf_phase(bounds, setup, card_line)
    graftwatch.on_slot(7)
    for row in rows:
        if row["name"] in stf["launches"]:
            row["launches_block_path"] = stf["launches"][row["name"]]
    label = f"block batch, {stf['lanes']} lanes"
    for row in stf_check.rows:
        main_row = next(r for r in rows if r["name"] == row["name"])
        main_row["max_abs_err"] = max(main_row["max_abs_err"],
                                      row["max_abs_err"])
        modes.setdefault(row["name"], []).append(
            {"mode": label, **{k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")}})
    for name, recs in stf_check.modes.items():
        modes.setdefault(name, []).extend(
            {**m, "mode": f"{label}, {m['mode']}"} for m in recs)

    # phase 8: what the observability layer kept of phases 1-7
    obs = obs_phase(card_line, stf)

    report = {"card": card_line, "sm_clock_max_mhz": sm_clock,
              "build_s": build_s, "build": summary, "kernels": rows,
              "kernel_modes": modes, "bls_field_muls": bls_check.muls,
              "slice": sl, "bls": bls, "multigpu": multigpu, "mxu": mxu,
              "stf": stf, "stf_field_muls": stf_check.muls, "obs": obs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
