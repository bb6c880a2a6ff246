#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out REPORT.json] [--seed N]

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
8. The beacon node's gossip path at 1,000,000 validators, with every
   launch count at 0 at its start: phase 7's state with a real anchor
   block (``stf_workload.build_chain_workload``: the anchor's header the
   state's ``latest_block_header``, the anchor justified, the block built
   and signed after it, its ``state_root`` from a pass with signatures
   off); ``BeaconChain``s anchored on copies by ``BeaconChainBuilder``
   (``weak_subjectivity_anchor``, a manual slot clock at the block's
   slot, the mock execution layer, a ``HotColdDB`` on native kv stores
   in a temp dir; ``store_genesis`` timed). 10,000 unaggregated
   single-bit gossip attestations by the prior slot's committee members
   (each signed by its member on the C++ host backend, head and target
   the anchor) through ``batch_verify_unaggregated_attestations_for_gossip``
   on ``gpu`` (all verified), a 64-batch, and a negative 64-batch whose
   item 17 carries its neighbour's signature (that item alone
   ``bad_signature``, through the split fallback); the ``cpp`` backend
   on a chain of its own gives the same verdicts. The verified votes
   into fork choice, and into the op pool of the ``cpp`` chain (one
   packed aggregate a committee). A negative block (attestation 0 with
   attestation 1's signature, the proposal signed again) raises
   ``BlockError`` on both, the head and the store unchanged; the block
   imported by ``process_gossip_block`` through a two-worker
   ``BeaconProcessor`` on ``gpu`` (the head on it, fork choice and the
   store holding it, its batch on the card) and on ``cpp`` (the same
   head and post-state root). Timed: the batches with their split
   (checks, ``parse_sets``, ``host_prepare``, ``verify_signature_sets``),
   the votes into fork choice, ``recompute_head`` over the vote
   trackers, the import (on ``FRESH_CHAINS`` fresh chains, their
   median; 1 since phase 9 came, 3 before) with its critical path by
   stage (service time, queue wait), and the card's idle share
   of one import under ``torch.profiler``. Every state-root and BLS
   kernel must have launched on the path.
9. The post-merge node at 1,000,000 validators, with every launch count
   at 0 at its start: a mainnet Deneb state after the merge at
   ``stf_workload.DENEB_SLOT`` and a block on it with its execution
   payload (withdrawals swept from the registry, transactions) and six
   blobs made from ``--seed``, their commitments and proofs from
   ``Kzg(devnet_size=4096)`` on the C++ host library (the devnet setup
   stands in for mainnet's ceremony file at its 4,096 points), the
   sidecars from ``produce_sidecars``. Chains as phase 8's, each with the
   real ``ExecutionLayer`` (``EngineApiClient``, a fresh 32-byte JWT
   secret) on a ``MockEngineServer`` at 127.0.0.1, a
   ``DataAvailabilityChecker`` on that setup and a ``Slasher`` on the hot
   DB (its history cut to ``SLASHER_HISTORY`` epochs). The block through
   the beacon processor (its batch on ``gpu``, the state transition with
   its payload, ``engine_newPayloadV3`` over HTTP) held pending its
   blobs; a sidecar with one blob byte changed refused; the six sidecars
   importing it (the head on it, not optimistic, the post-state root the
   block's, ``engine_forkchoiceUpdatedV3`` over HTTP; a request with a
   wrong token answered 401 and not logged). ``produce_block`` for the
   next slot's proposer registered with a ``MockBuilder`` over HTTP: a
   winning bid gives the builder's payload, a low one the local. The
   block's 64 aggregates fed to the slasher by the phase (the chain feeds
   it from gossip only), 1,024 gossip singles verified on ``gpu`` through
   the chain, an equivocating block and a double vote refused by the
   gossip checks after they reach the slasher; ``process_queued`` finds
   exactly those two, turned by ``record_to_operation`` into slashings the
   op pool packs and a state applies with their signatures verified. On
   a fresh chain the import under ``torch.profiler`` (the idle share); on
   another the payload the engine marks invalid refused. Timed: the
   import (one fresh chain) with the block's critical path by stage and
   the ``el_new_payload``, ``kzg_verify`` and ``el_forkchoice`` spans,
   the productions, the gossip batch, ``process_queued``. The import
   alone must launch every state-root and BLS kernel.
10. The beacon node's network at 1,000,000 validators: phase 7's
   workload (kept from phase 7) with a second block one slot after phase
   8's, its signers' interop pubkeys written and warmed; three chains
   anchored as in phase 8, each with a ``NetworkService`` on 127.0.0.1
   (``NETWORK_SECURITY``, never left to the transport; a two-worker
   beacon processor; ``batch_gossip_verification``), launch counts 0 from
   their anchoring on. (a) B dials A at the anchor (the status shows no
   gap); A imports the block and gossips it; B checks it at gossip and
   imports it through its processor: B's head and post-state root A's and
   the workload's. (b) A imports the second block; C, fresh at the
   anchor, dials A, sees it ahead and range-syncs both blocks
   (``beacon_blocks_by_range`` over yamux and snappy, the replay engine,
   one signature batch for the epoch on the card): C's head, post-state
   root and stored blocks' SSZ A's, the second block by root byte-equal.
   (c) A gossips ``NETWORK_SINGLES`` single-bit attestations of the block's
   slot on their subnets and one with its neighbour's signature; B and C
   verify them in processor batches on ``gpu``, apply every valid vote
   and refuse the bad one alone (the split fallback), verdicts equal to
   the ``cpp`` backend's on A; A's score takes the reject, no ban. (d) A
   gossips ``swapped_block``: B refuses it at gossip, C refuses its
   import, heads and stores unchanged. (e) A ``BootNode`` on 127.0.0.1;
   F, on a ``FaultyTransport``, range-syncs both blocks from A; A, F and
   D (fresh at the anchor, on a ``FaultyTransport``) each get a
   ``Discovery`` holding only the bootnode's ENR; D's ``discover_once``
   finds A and F by FINDNODE and dials both, asks F for the epoch's batch
   first (F's node id sorts first), F stalls it (``PeerBehavior("stall",
   stall_secs=STALL_SECS)``), D penalises F and takes the batch from A:
   D's head and state root A's, every ENR advertising its service's TCP
   port, D's routing table through ``persist_dht`` / ``load_dht`` on its
   store. (f) C, F and D stop; B imports the second block; a validator
   client over the Beacon API (``validator_step``): ``BeaconApiServer(
   ApiBackend(A's chain))`` on 127.0.0.1, its ``publish_fn`` A's
   ``publish_block``; the client, spawned in a process of its own on the
   ``cpp`` backend with the interop keys of slot SLOT+2's proposer and two
   members of each of its 64 committees (written and warmed with the
   second block's signers), runs ``on_slot(SLOT+2)`` over HTTP: its 129
   indices and its duties (equal to the backend's direct calls), the
   block A produces, signed in the client and posted (A's and then B's
   head, the HTTP state root A's and the block's, the SSE ``head``
   event), 128 attestations (each 200, their committees' data in A's op
   pool, the verdicts of their sets on ``cpp`` A's on ``gpu``; one with
   its neighbour's signature 400), the aggregations its selection proofs
   pick (each accepted); its store refuses a second block for the slot;
   then the reads and the serving fleet (``FLEET_THREADS`` x
   ``FLEET_REQUESTS``). Timed: the dials (the handshake),
   (a) from publish to B's head with its critical path by stage, (b) from
   dial to C's head split into status, download, decode and the replay
   engine's stages, (c) from the first publish to the last verdict with
   the batch sizes drained, (e) from D's bootstrap to its dials and from
   its first dial to A's head split into the stall, the download, decode
   and the replay's stages, the bytes sent on the sockets by step (D's
   own, TCP and discv5, in (e)), D's range sync under ``torch.profiler``
   (the card's idle share), and (f)'s calls (the index lookups, each
   duties call, production with its ``block_production`` span, the
   client's signing, publish to A's and B's heads with the critical path,
   the attestation round trips and A's verify a POST, the aggregations,
   the state-root GET, the fleet's requests/s, hit ratio and
   ``api_request`` p95, the card's idle share over the client's slot).
   Every state-root and BLS kernel must launch on the path, every BLS
   kernel and ``hash64`` in (e) alone, every one but ``cap_fold`` in (f)
   alone (``launches_validator_path``): (f) builds no tree.
11. Observability, read from what phases 1-10 left (the catalog and the
   ``obs`` layer are loaded at import, as a node loads them, and the
   graftwatch sampler ticks once a phase): every kernel that launched (15
   in mode 0, 20 mode-1/2 variants) has a roofline record on the card
   (its device ms and its utilization of the peak in (0, 1.05]); the
   memory ledger of phase 7 (platform ``cuda``, the card's kind, memory
   and bytes in use, the live merkle trees attributed within them); a
   second ``build_all`` with no build-cache miss; the catalog metrics of
   the state root, the BLS batch (``bls_batch_verify_sigs`` at 10,000),
   the block, and the chain's imports (``beacon_block_imported_total``)
   and gossip batches (``beacon_attestation_processing_seconds``), and
   phase 9's KZG, engine-API and production histograms, and phase 10's
   gossip, peer and range-sync counters from the port's catalog; a flight dump
   the port's doctor renders with exit 0. The run's total time is printed
   before the kernel line.

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
              card: str) -> tuple[dict, BlsKernelCheck, object]:
    """The block on the card: the 1M-validator Altair workload of
    ``stf_workload`` (a block covering the prior slot, really signed)
    through ``per_block_processing`` with its signatures verified as one
    batch on the ``gpu`` backend, then the post-block root and the epoch
    with its root on the card, each held to the JAX package's root; the
    same block on the ``cpp`` backend; two negative blocks on both; the
    warm times with the signature call's split; the BLS kernels against
    their plain versions on the block batch's own lane inputs. Returns
    the report, the kernel checks and the workload (phase 8 reuses its
    state, signer rows and pubkeys)."""
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
            "epoch_root_ms": epoch_root_ms}, c, w


#: the gossip batch of BASELINE.md config 3, and the beacon processor's
#: attestation batch (``beacon_processor/processor.py`` ``MAX_BATCH``)
GOSSIP_BATCH = 10_000
PROCESSOR_BATCH = 64
#: the item of the negative 64-batch that carries its neighbour's signature
NEGATIVE_ITEM = 17
#: fresh chains phase 8 times the import on (3 until phase 9 came: cut so
#: that the smoke keeps inside its time limit)
FRESH_CHAINS = 1


class PathLaunches:
    """Each kernel's launches by a path's own calls, by label: the deltas
    of the launch counts around each call ``run`` makes."""

    def __init__(self):
        self.by_label: dict[str, dict[str, int]] = {}

    def run(self, label: str, fn):
        """``fn()``, its kernel launches added under ``label``."""
        from lighthouse_tpu_torch import kernels
        before = {n: k.launches for n, k in kernels.KERNELS.items()}
        try:
            return fn()
        finally:
            got = self.by_label.setdefault(label, dict.fromkeys(before, 0))
            for n, k in kernels.KERNELS.items():
                got[n] += k.launches - before[n]

    def totals(self, names) -> dict[str, int]:
        return {n: sum(c[n] for c in self.by_label.values()) for n in names}

    def by_call(self, names) -> dict[str, dict[str, int]]:
        return {label: {n: c[n] for n in names if c[n]}
                for label, c in self.by_label.items()}


def _verdicts(results) -> list[str]:
    """A gossip batch's results as kinds: ``ok`` or the error's kind."""
    from lighthouse_tpu_torch.chain.errors import AttestationError
    return [r.kind if isinstance(r, AttestationError) else "ok"
            for r in results]


def chain_phase(setup: dict, w, card: str) -> dict:
    """Phase 8: the beacon node's gossip path at 1M validators. Chains
    anchored on phase 7's state (``stf_workload.build_chain_workload``: a
    real anchor block, the block after it), their stores native kv stores
    under a temp dir; the ``GOSSIP_BATCH`` unaggregated attestations, a
    64-batch and a negative 64-batch through
    ``batch_verify_unaggregated_attestations_for_gossip`` on ``gpu`` and
    on ``cpp`` (equal verdicts), applied to fork choice and the op pool;
    a negative block raising on both; the block imported through the
    beacon processor on ``gpu`` (the head on it, the store holding it,
    the stage split) on the chain the batches warmed and on
    ``FRESH_CHAINS`` fresh chains, and on ``cpp`` (the same head and
    post-state root), once more
    under the profiler. The kernel launches of the path are the deltas
    around the gpu chains' own calls: their anchoring, the three gossip
    batches, the negative block and the imports through the processor."""
    import os
    import tempfile

    import torch

    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch import stf_workload as sw
    from lighthouse_tpu_torch.beacon_processor import (
        BeaconProcessor, Work, WorkType,
    )
    from lighthouse_tpu_torch.bls_batch import warm_pubkeys
    from lighthouse_tpu_torch.chain import BeaconChainBuilder, BlockError
    from lighthouse_tpu_torch.chain import attestation_verification as av
    from lighthouse_tpu_torch.chain.errors import BAD_SIGNATURE
    from lighthouse_tpu_torch.chain.execution import MockExecutionLayer
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import gpu_backend
    from lighthouse_tpu_torch.obs import critpath
    from lighthouse_tpu_torch.profile_state_root import profiled
    from lighthouse_tpu_torch.specs.chain_spec import mainnet_spec
    from lighthouse_tpu_torch.ssz import htr
    from lighthouse_tpu_torch.store import HotColdDB, NativeKvStore
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    t_phase = time.perf_counter()
    cpp, gpu = setup["cpp"], setup["gpu"]
    check(bls.get_backend() is gpu, "the BLS module's backend is not gpu")
    kernels.reset_counts()
    cores = os.cpu_count() or 8
    spec = mainnet_spec()
    report: dict = {}
    n_gossip = GOSSIP_BATCH
    # each kernel's launches by the chain's own calls, by call
    launches_of = PathLaunches()
    counted, path_launches = launches_of.run, launches_of.by_label

    # (a) the anchor and the block, on a copy of phase 7's state
    t0 = time.perf_counter()
    cw = sw.build_chain_workload(w, cpp)
    report["workload_s"] = time.perf_counter() - t0
    anchor_root = htr(cw.anchor.message)
    block_root = htr(cw.block.message)
    slot = int(cw.block.message.slot)
    check(bytes(cw.block.message.parent_root) == anchor_root,
          "the block's parent is not the anchor")
    t0 = time.perf_counter()
    atts = sw.gossip_attestations(cw.state, anchor_root,
                                  n_gossip + 2 * PROCESSOR_BATCH, cpp,
                                  threads=cores)
    report["sign_s"] = time.perf_counter() - t0
    main = atts[:n_gossip]
    small = atts[n_gossip:n_gossip + PROCESSOR_BATCH]
    negative = list(atts[n_gossip + PROCESSOR_BATCH:])
    bad, nxt = negative[NEGATIVE_ITEM][0], negative[NEGATIVE_ITEM + 1][0]
    negative[NEGATIVE_ITEM] = (type(bad)(
        aggregation_bits=list(bad.aggregation_bits), data=bad.data,
        signature=nxt.signature), negative[NEGATIVE_ITEM][1])
    print(f"chain setup: the anchor block {anchor_root.hex()} at slot "
          f"{slot - 1} (its header the state's, the anchor justified), the "
          f"block {block_root.hex()} at slot {slot} signed and its state "
          f"root filled in {report['workload_s']:.1f} s; {len(atts)} "
          f"single-bit gossip attestations by the anchor slot's committee "
          f"members signed (C++ host backend, {cores} threads) in "
          f"{report['sign_s']:.1f} s [{card}]", flush=True)

    def anchored(tmp: str, name: str, label: str | None = None):
        """A chain anchored on a copy of the workload's state, its hot and
        cold DBs native kv stores under ``tmp``, its head computed once (a
        node's first head: its housekeeping at the anchor's finalized
        checkpoint prunes, migrates to the freezer and persists fork
        choice); (chain, build seconds, store_genesis seconds, first
        recompute_head seconds). The launches of the build and the first
        head go to ``path_launches[label]`` where a label is given."""
        db = HotColdDB(NativeKvStore(os.path.join(tmp, name, "hot")),
                       NativeKvStore(os.path.join(tmp, name, "cold")), spec)
        genesis_s = []
        inner = db.store_genesis

        def store_genesis(*args, **kwargs):
            t = time.perf_counter()
            inner(*args, **kwargs)
            genesis_s.append(time.perf_counter() - t)

        db.store_genesis = store_genesis
        state = cw.state.copy()
        run = (lambda fn: counted(label, fn)) if label else (
            lambda fn: fn())
        t = time.perf_counter()
        chain = run(lambda: BeaconChainBuilder(spec)
                    .weak_subjectivity_anchor(state, cw.anchor)
                    .slot_clock(ManualSlotClock(0, spec.seconds_per_slot,
                                                current_slot=slot))
                    .execution_layer(MockExecutionLayer())
                    .store(db)
                    .build())
        build_s = time.perf_counter() - t
        t = time.perf_counter()
        check(run(chain.recompute_head) == anchor_root
              and len(genesis_s) == 1, f"chain {name}: not anchored")
        return chain, build_s, genesis_s[0], time.perf_counter() - t

    def through_processor(chain, signed_block) -> float:
        """Import ``signed_block`` by ``process_gossip_block`` as a
        GOSSIP_BLOCK work item of a two-worker beacon processor; the
        milliseconds from submit to idle. Raises what the import
        raised."""
        out, errors = [], []

        def run():
            try:
                out.append(chain.process_gossip_block(signed_block))
            except Exception as e:  # re-raised below, on this thread
                errors.append(e)

        proc = BeaconProcessor(num_workers=2)
        proc.start()
        try:
            t = time.perf_counter()
            proc.submit(Work(kind=WorkType.GOSSIP_BLOCK, run=run))
            check(proc.wait_idle(timeout=600), "the import did not finish "
                                               "inside 600 s")
            ms = (time.perf_counter() - t) * 1e3
        finally:
            proc.stop()
        if errors:
            raise errors[0]
        check(out == [block_root], f"the import returned {out}")
        return ms

    def imported(chain, name: str) -> None:
        head = chain.head()
        check(head.head_block_root == block_root,
              f"{name}: the head {head.head_block_root.hex()} is not the "
              f"block")
        check(chain.fork_choice.contains_block(block_root),
              f"{name}: fork choice lacks the block")
        stored = chain.store.get_block(block_root)
        check(stored is not None and htr(stored.message) == block_root,
              f"{name}: the store does not return the block")
        check(chain.store.hot_state_summary(cw.post_root) is not None,
              f"{name}: the store has no hot summary of the post-state")
        check(head.head_state.hash_tree_root() == cw.post_root,
              f"{name}: the head state's root is not the block's")

    def rejected(chain, name: str, label: str | None = None) -> None:
        """The negative block raises BlockError through the import and
        leaves the head and the store as they were; the launches of its
        import go to ``path_launches[label]`` where a label is given."""
        bad_block = sw.swapped_block(cw.state, cw.block, cpp)
        bad_root = htr(bad_block.message)
        try:
            if label:
                counted(label, lambda: chain.process_block(bad_block))
            else:
                chain.process_block(bad_block)
            raised = False
        except BlockError:
            raised = True
        check(raised, f"{name}: the negative block was accepted")
        check(chain.head().head_block_root == anchor_root,
              f"{name}: the negative block moved the head")
        check(chain.store.get_block(bad_root) is None
              and not chain.fork_choice.contains_block(bad_root),
              f"{name}: the negative block is in the store or fork choice")

    def gpu_import(chain, name: str) -> tuple[float, dict]:
        """The block through the processor on a gpu chain, its launches
        under ``import``, the import checked to have run every BLS kernel
        and to have put the head on the block; (ms, the critical path of
        its block_import trace)."""
        check(bls.get_backend() is gpu, "the BLS module's backend is not gpu")
        before = {s.span_id for s in tracing.snapshot()}
        bls_before = {k.name: k.launches for k in kernels.BLS_KERNELS}
        ms = counted("import", lambda: through_processor(chain, cw.block))
        check(all(k.launches > bls_before[k.name]
                  for k in kernels.BLS_KERNELS),
              f"{name}: the import's batch signature did not run on the gpu "
              f"backend's kernels")
        imported(chain, name)
        comp = critpath.worst_component(
            [s for s in tracing.snapshot() if s.span_id not in before],
            kinds=("block_import",))
        check(comp is not None, f"{name}: no block_import trace recorded")
        return ms, critpath.component_report(comp)

    def split(stages: dict) -> str:
        row = stages["stages"]
        return ", ".join(
            f"{k} {row[k]['service_ms']:.1f} ms (queue wait "
            f"{row[k]['queue_wait_ms']:.1f})"
            for k in ("processor_work", "block_pipeline", "gossip_verify",
                      "block_import", "batch_signature", "state_transition",
                      "state_root", "fork_choice", "db_write") if k in row)

    with tempfile.TemporaryDirectory() as tmp:
        chain_g, build_s, genesis_s, first_head_s = anchored(tmp, "gpu",
                                                             "anchor")
        report.update(anchor_s=build_s, store_genesis_s=genesis_s,
                      first_recompute_head_s=first_head_s)
        print(f"chain anchored: BeaconChainBuilder.build {build_s:.2f} s, "
              f"store_genesis {genesis_s:.2f} s of it (the state into the "
              f"freezer, its summary into the hot DB; native kv stores); "
              f"the first recompute_head {first_head_s:.2f} s (prune, "
              f"migrate, persist at the anchor's finalized checkpoint) "
              f"[{card}]", flush=True)

        # (b) the gossip batches: the checks alone and the signature sets'
        # split, timed apart (their launches are not the chain's), then
        # each batch through the chain on gpu, then on cpp
        t0 = time.perf_counter()
        prepared = [av.verify_unaggregated_checks(chain_g, a, s)
                    for a, s in main]
        checks_ms = (time.perf_counter() - t0) * 1e3
        sets = [p[2] for p in prepared]
        check(warm_pubkeys(gpu, sets, processes=cores) == 0,
              "the gossip signers' pubkeys were not in phase 7's cache")
        parse_ms, _ = _median_ms(lambda: gpu_backend.parse_sets(gpu, sets))
        parsed = gpu_backend.parse_sets(gpu, sets)
        small_lanes, big_lanes = gpu_backend.lane_options()
        lanes = small_lanes if len(sets) <= small_lanes else big_lanes
        prep_ms, _ = _median_ms(
            lambda: gpu_backend.host_prepare(*parsed, lanes, small_lanes))
        t0 = time.perf_counter()
        check(bls.verify_signature_sets(sets), "the gossip sets do not "
                                               "verify on gpu")
        verify_ms = (time.perf_counter() - t0) * 1e3

        def batches(chain, count: bool) -> tuple[dict, dict]:
            verdicts, ms = {}, {}
            for label, batch in (("64", small), ("negative 64", negative),
                                 (str(n_gossip), main)):
                def call():
                    return (chain.
                            batch_verify_unaggregated_attestations_for_gossip(
                                batch))
                t = time.perf_counter()
                verdicts[label] = _verdicts(
                    counted(f"gossip {label}", call) if count else call())
                ms[label] = (time.perf_counter() - t) * 1e3
            return verdicts, ms

        verdicts_g, batch_ms = batches(chain_g, count=True)
        want_negative = ["ok"] * PROCESSOR_BATCH
        want_negative[NEGATIVE_ITEM] = BAD_SIGNATURE
        check(verdicts_g["64"] == ["ok"] * PROCESSOR_BATCH,
              f"the 64-batch on gpu: {verdicts_g['64']}")
        check(verdicts_g["negative 64"] == want_negative,
              f"the negative 64-batch on gpu: {verdicts_g['negative 64']}")
        check(verdicts_g[str(n_gossip)] == ["ok"] * n_gossip,
              f"the {n_gossip}-batch on gpu: "
              f"{sorted(set(verdicts_g[str(n_gossip)]))}")
        big = path_launches[f"gossip {n_gossip}"]
        check(all(big[k.name] > 0 for k in kernels.BLS_KERNELS),
              f"the {n_gossip}-batch through the chain did not launch every "
              f"BLS kernel: {big}")

        chain_c = anchored(tmp, "cpp")[0]
        bls.set_backend("cpp")
        try:
            verdicts_c, batch_ms_c = batches(chain_c, count=False)
        finally:
            bls.set_backend("gpu")
        check(verdicts_c == verdicts_g, "the cpp backend's verdicts differ "
                                        "from gpu's")
        report.update(checks_ms=checks_ms, parse_ms=parse_ms,
                      prepare_ms=prep_ms, verify_ms=verify_ms,
                      lanes=lanes, batch_ms=batch_ms, batch_ms_cpp=batch_ms_c)
        print(f"chain gossip: {n_gossip} attestations all verified on gpu "
              f"({batch_ms[str(n_gossip)]:.1f} ms through the chain: the "
              f"checks alone {checks_ms:.1f} ms, parse_sets {parse_ms:.1f} "
              f"ms, host_prepare {prep_ms:.1f} ms at {lanes} lanes, "
              f"verify_signature_sets {verify_ms:.1f} ms); the 64-batch "
              f"{batch_ms['64']:.1f} ms; the negative 64-batch names item "
              f"{NEGATIVE_ITEM} alone {BAD_SIGNATURE} "
              f"({batch_ms['negative 64']:.1f} ms, the split fallback); cpp "
              f"the same verdicts ({batch_ms_c[str(n_gossip)]:.1f} / "
              f"{batch_ms_c['64']:.1f} / {batch_ms_c['negative 64']:.1f} ms) "
              f"[{card}]", flush=True)

        # the verified attestations into fork choice (both chains) and the
        # op pool of the cpp chain (the pool aggregates the signatures of
        # one committee's singles on the current backend)
        ok_g = [p for p, v in zip(prepared, verdicts_g[str(n_gossip)])
                if v == "ok"]
        t0 = time.perf_counter()
        for indexed, _base, _s in ok_g:
            chain_g.fork_choice.on_attestation(slot, indexed,
                                               is_from_block=False)
        fc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for indexed, _base, _s in ok_g:
            chain_c.fork_choice.on_attestation(slot, indexed,
                                               is_from_block=False)
        bls.set_backend("cpp")
        t1 = time.perf_counter()
        try:
            for a, _subnet in main:
                chain_c.op_pool.insert_attestation(a)
        finally:
            bls.set_backend("gpu")
        pool_ms = (time.perf_counter() - t0) * 1e3
        pool_cpp_insert_ms = (time.perf_counter() - t1) * 1e3 / n_gossip
        committees = {int(a.data.index) for a, _ in main}
        packed = chain_c.op_pool.get_attestations_for_block(
            chain_c.state_for_block_production(anchor_root, slot))
        check(len(packed) == len(committees)
              and sum(sum(bool(b) for b in p.aggregation_bits)
                      for p in packed) == n_gossip,
              f"the op pool packs {len(packed)} attestations, not one per "
              f"committee ({len(committees)}) covering {n_gossip} bits")
        # eight singles of one committee into the gpu chain's pool: the
        # first opens the committee's bucket, each later one aggregates
        # its signature on the gpu backend (the C++ host library)
        one_committee = [a for a, _ in main if int(a.data.index) == 0][:8]
        t0 = time.perf_counter()
        for a in one_committee:
            chain_g.op_pool.insert_attestation(a)
        pool_gpu_ms = (time.perf_counter() - t0) * 1e3 / 7
        # the votes' walk: get_head, compute_deltas over every tracker
        t0 = time.perf_counter()
        head_g = chain_g.fork_choice.get_head(slot)
        get_head_ms = (time.perf_counter() - t0) * 1e3
        check(head_g == chain_g.recompute_head() == anchor_root,
              "the votes moved the head off the anchor")
        report.update(fork_choice_apply_ms=fc_ms, op_pool_cpp_ms=pool_ms,
                      op_pool_cpp_insert_ms=pool_cpp_insert_ms,
                      op_pool_gpu_aggregate_ms=pool_gpu_ms,
                      get_head_votes_ms=get_head_ms,
                      votes=len(chain_g.fork_choice.votes))
        print(f"chain gossip: {len(ok_g)} verified votes into fork choice "
              f"{fc_ms:.1f} ms; fork choice and the op pool of the cpp chain "
              f"{pool_ms:.1f} ms ({len(packed)} aggregates packed, "
              f"{n_gossip} bits); an op pool insert that aggregates, on the "
              f"gpu backend (the C++ host library), {pool_gpu_ms:.2f} ms "
              f"(x {n_gossip} singles = {pool_gpu_ms * n_gossip / 1e3:.1f} s "
              f"a slot), on cpp {pool_cpp_insert_ms:.2f} ms (the mean of its "
              f"{n_gossip}); get_head over {len(chain_g.fork_choice.votes)} "
              f"vote trackers {get_head_ms:.1f} ms [{card}]", flush=True)

        # (c) the block: the negative on both, then the import through
        # the beacon processor on cpp, on the chain the gossip batches
        # warmed, and on FRESH_CHAINS fresh chains
        rejected(chain_g, "gpu", "negative block")
        bls.set_backend("cpp")
        try:
            rejected(chain_c, "cpp")
            cpp_ms = through_processor(chain_c, cw.block)
        finally:
            bls.set_backend("gpu")
        imported(chain_c, "cpp")
        warm_ms, warm_stages = gpu_import(chain_g, "gpu")
        check(chain_g.head().head_state.hash_tree_root()
              == chain_c.head().head_state.hash_tree_root(),
              "the gpu and cpp chains' post-states differ")
        t0 = time.perf_counter()
        chain_g.recompute_head()
        recompute_ms = (time.perf_counter() - t0) * 1e3
        del chain_g, chain_c
        import_ms, fresh_stages, anchor_more = [], [], []
        for name in [f"gpu {i + 2}" for i in range(FRESH_CHAINS)]:
            chain, b_s, g_s, h_s = anchored(tmp, name.replace(" ", ""),
                                            "anchor")
            anchor_more.append((b_s, g_s, h_s))
            ms, stages = gpu_import(chain, name)
            import_ms.append(ms)
            fresh_stages.append(stages)
            del chain
        median_ms = statistics.median(import_ms)
        stages = fresh_stages[import_ms.index(median_ms)]
        # the device's busy time: one import under the profiler, read only
        # when the profile holds at least the import's kernel launches
        chain = anchored(tmp, "profiled")[0]
        before = sum(k.launches for k in kernels.KERNELS.values())
        prof = profiled(lambda: chain.process_gossip_block(cw.block))
        call_launches = sum(k.launches
                            for k in kernels.KERNELS.values()) - before
        imported(chain, "profiled")
        del chain
    torch.cuda.synchronize()
    names = [k.name for k in kernels.STATE_ROOT_KERNELS + kernels.BLS_KERNELS]
    launches = launches_of.totals(names)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the chain path")
    print(f"chain import: the block through the beacon processor accepted "
          f"on gpu, the head on it, fork choice and the store holding it "
          f"(its post-state's hot summary); the same head and post-state "
          f"root on cpp ({cpp_ms:.1f} ms); the negative block (attestation "
          f"0 with attestation 1's signature, the proposal signed again) "
          f"raised BlockError on both, the head and the store unchanged "
          f"[{card}]", flush=True)
    print(f"chain import: {median_ms:.1f} ms median of {len(import_ms)} on "
          f"fresh chains {[round(x, 1) for x in import_ms]} (submit to "
          f"idle); the critical path of the median one "
          f"{stages['total_ms']:.1f} ms: {split(stages)} [{card}]",
          flush=True)
    print(f"chain import: {warm_ms:.1f} ms on the chain the gossip batches "
          f"warmed (its {len(ok_g)} votes in fork choice); its critical "
          f"path {warm_stages['total_ms']:.1f} ms: {split(warm_stages)}; "
          f"recompute_head after it {recompute_ms:.1f} ms [{card}]",
          flush=True)
    busy = (f"device busy {prof['device_busy_ms']:.2f} ms "
            f"({prof['device_events']} device events), the card idle "
            f"{100 * (1 - prof['device_busy_share']):.1f} % of the import"
            if prof["device_events"] >= call_launches else
            f"device busy not measured (the profile holds "
            f"{prof['device_events']} device events, fewer than the "
            f"import's {call_launches} kernel launches)")
    print(f"chain import: under the profiler {prof['wall_ms']:.1f} ms wall, "
          f"{busy}; fresh chains anchored in {[round(a[0], 2) for a in anchor_more]}"
          f" s (store_genesis {[round(a[1], 2) for a in anchor_more]}), "
          f"their first recompute_head {[round(a[2], 2) for a in anchor_more]}"
          f" s [{card}]", flush=True)
    by_call = launches_of.by_call(names)
    print(f"chain launches on the path (the gpu chains' own calls: "
          f"{FRESH_CHAINS + 1} anchorings, 3 gossip batches, the negative "
          f"block, {FRESH_CHAINS + 1} imports through the processor): "
          f"{launches}; by call {by_call} [{card}]", flush=True)
    report.update(verdicts=verdicts_g, cpp_import_ms=cpp_ms,
                  import_ms=import_ms, warm_import_ms=warm_ms,
                  stages=stages, warm_stages=warm_stages,
                  recompute_head_ms=recompute_ms, profile=prof,
                  anchor_more=anchor_more, launches=launches,
                  launches_by_call=by_call)
    report["seconds"] = time.perf_counter() - t_phase
    print(f"chain phase: {report['seconds']:.1f} s [{card}]", flush=True)
    return report


#: the slasher's history in epochs in phase 9, cut from the default
#: 4,096: at 1M validators the default's sweeps cost 8.6-22.3 s an
#: aggregate on the H100 machine's host (``python -m
#: lighthouse_tpu_torch.profile_slasher``), ~1,000 s for the block's 64,
#: and a history of 64 epochs 65 s in the phase; at 16 the sweeps walk
#: two epoch chunks (64: five)
SLASHER_HISTORY = 16


def postmerge_phase(setup: dict, card: str, seed: int) -> dict:
    """Phase 9: the post-merge node at 1M validators. The Deneb workload
    (``stf_workload`` at ``DENEB_SLOT``: the state after the merge, the
    block with its payload, withdrawals and six blobs made from ``seed``,
    their KZG commitments and sidecars from ``Kzg(devnet_size=4096)``, an
    equivocating block, gossip singles and a double vote); chains anchored
    as in phase 8, each with the real ``ExecutionLayer`` over an
    ``EngineApiClient`` with a fresh JWT secret to a ``MockEngineServer``
    on 127.0.0.1, the ``DataAvailabilityChecker`` on that KZG setup and a
    ``Slasher`` on the hot DB. On one chain: the block through the beacon
    processor (held pending), a tampered sidecar refused, the six sidecars
    importing it (head on it, not optimistic, both engine methods logged);
    the builder flow for the next slot's proposer (a winning bid: the
    builder's payload; a low one: local); the block's aggregates fed to
    the slasher by the phase, a gossip batch, the equivocation and the
    double vote through the chain's gossip checks, the slasher's records
    turned into operations the op pool packs and a state applies with
    their signatures verified. On a fresh chain the import under the
    profiler (the idle share); on another the payload the engine marks
    invalid refused. The kernel launches are the deltas around the
    chains' own calls."""
    import http.client
    import os
    import secrets
    import tempfile

    import torch

    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch import stf_workload as sw
    from lighthouse_tpu_torch.beacon_processor import (
        BeaconProcessor, Work, WorkType,
    )
    from lighthouse_tpu_torch.bls_batch import warm_pubkeys
    from lighthouse_tpu_torch.chain import BeaconChainBuilder, BlockError
    from lighthouse_tpu_torch.chain import attestation_verification as av
    from lighthouse_tpu_torch.chain.data_availability import (
        DataAvailabilityChecker,
    )
    from lighthouse_tpu_torch.chain.errors import (
        AVAILABILITY_PENDING, EXECUTION_INVALID, PRIOR_SEEN, REPEAT_PROPOSAL,
        AttestationError,
    )
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import SignatureSet, keygen_interop
    from lighthouse_tpu_torch.crypto.kzg import Kzg
    from lighthouse_tpu_torch.execution_layer import (
        EngineApiClient, ExecutionLayer, JwtAuth, MockEngineServer,
    )
    from lighthouse_tpu_torch.execution_layer.builder import (
        BuilderHttpClient, MockBuilder,
    )
    from lighthouse_tpu_torch.obs import critpath
    from lighthouse_tpu_torch.profile_state_root import profiled
    from lighthouse_tpu_torch.slasher import (
        Slasher, SlasherConfig, record_to_operation,
    )
    from lighthouse_tpu_torch.specs.chain_spec import (
        ForkName, compute_signing_root, mainnet_spec,
    )
    from lighthouse_tpu_torch.specs.constants import DOMAIN_RANDAO
    from lighthouse_tpu_torch.ssz import hash_tree_root, htr, uint64
    from lighthouse_tpu_torch.state_transition import VerifySignatures
    from lighthouse_tpu_torch.state_transition.block import (
        process_attester_slashing, process_proposer_slashing,
    )
    from lighthouse_tpu_torch.state_transition.helpers import (
        get_beacon_proposer_index, get_domain, get_indexed_attestation,
    )
    from lighthouse_tpu_torch.store import HotColdDB, NativeKvStore
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    t_phase = time.perf_counter()
    cpp, gpu = setup["cpp"], setup["gpu"]
    check(bls.get_backend() is gpu, "the BLS module's backend is not gpu")
    kernels.reset_counts()
    cores = os.cpu_count() or 8
    spec = mainnet_spec()
    report: dict = {"slasher_history": SLASHER_HISTORY, "fresh_chains": 1}
    launches_of = PathLaunches()

    # (a) the workload
    t0 = time.perf_counter()
    w = sw.build_workload(cpp, slot=sw.DENEB_SLOT, fork=ForkName.DENEB,
                          threads=cores)
    report["workload_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kzg = Kzg(devnet_size=4096)
    report["kzg_setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pw = sw.build_postmerge_workload(w, cpp, kzg, seed=seed, threads=cores)
    report["postmerge_workload_s"] = time.perf_counter() - t0
    report["kzg_commit_and_prove_s"] = pw.kzg_s
    cw = pw.chain
    block = cw.block
    block_root, anchor_root = htr(block.message), htr(cw.anchor.message)
    slot = int(block.message.slot)
    epoch = slot // spec.preset.slots_per_epoch
    payload = block.message.body.execution_payload
    t0 = time.perf_counter()
    warmed = warm_pubkeys(gpu, [SignatureSet(
        b"", [bytes(pk) for pk in w.pubkeys], b"")], processes=cores)
    report["pubkey_warm_s"] = time.perf_counter() - t0
    print(f"postmerge setup: {len(w.state.validators)} validators, Deneb "
          f"at slot {slot} (epoch {epoch}); the block {block_root.hex()} "
          f"with {len(block.message.body.attestations)} attestations, "
          f"{len(payload.withdrawals)} withdrawals, "
          f"{len(payload.transactions)} transactions and "
          f"{len(pw.blobs)} blobs (seed {seed}), its {len(w.rows)} signer "
          f"rows' interop keys and the block signed in "
          f"{report['workload_s']:.1f} s; Kzg(devnet_size=4096) in "
          f"{report['kzg_setup_s']:.1f} s, the commitments and proofs in "
          f"{pw.kzg_s:.1f} s ({cores} threads), the anchor, block and "
          f"sidecars in {report['postmerge_workload_s']:.1f} s; {warmed} "
          f"pubkeys into the gpu backend's cache in "
          f"{report['pubkey_warm_s']:.1f} s [{card}]", flush=True)

    secret = secrets.token_bytes(32)
    engine = MockEngineServer(secret)
    engine.start()

    def anchored(tmp: str, name: str, label: str | None = None):
        """A chain anchored on a copy of the workload's state (phase 8's
        builder, stores and first head) with the real execution layer on
        the mock engine, the checker on the KZG setup and the slasher;
        the launches of its build under ``label`` where one is given."""
        def build():
            db = HotColdDB(NativeKvStore(os.path.join(tmp, name, "hot")),
                           NativeKvStore(os.path.join(tmp, name, "cold")),
                           spec)
            el = ExecutionLayer(EngineApiClient("127.0.0.1", engine.port,
                                                JwtAuth(secret)))
            chain = (BeaconChainBuilder(spec)
                     .weak_subjectivity_anchor(cw.state.copy(), cw.anchor)
                     .slot_clock(ManualSlotClock(0, spec.seconds_per_slot,
                                                 current_slot=slot))
                     .execution_layer(el).store(db).build())
            chain.data_availability_checker = DataAvailabilityChecker(
                chain.T, kzg=kzg)
            chain.slasher = Slasher(
                SlasherConfig(history_length=SLASHER_HISTORY),
                store=chain.store.hot)
            check(chain.recompute_head() == anchor_root,
                  f"chain {name}: not anchored")
            return chain
        return launches_of.run(label, build) if label else build()

    def through_processor(chain, signed_block):
        """``process_gossip_block`` as a GOSSIP_BLOCK work item of a
        two-worker beacon processor: (ms submit to idle, what it raised or
        returned)."""
        out = []

        def run():
            try:
                out.append(chain.process_gossip_block(signed_block))
            except Exception as e:  # handed back to the caller
                out.append(e)

        proc = BeaconProcessor(num_workers=2)
        proc.start()
        try:
            t = time.perf_counter()
            proc.submit(Work(kind=WorkType.GOSSIP_BLOCK, run=run))
            check(proc.wait_idle(timeout=600), "the import did not finish "
                                               "inside 600 s")
            return (time.perf_counter() - t) * 1e3, out[0]
        finally:
            proc.stop()

    def pending(chain, name: str) -> None:
        dac = chain.data_availability_checker
        check(block_root in dac._pending
              and chain.head().head_block_root == anchor_root
              and not chain.fork_choice.contains_block(block_root),
              f"{name}: the block is not held pending its blobs")

    def tampered(sidecar):
        blob = bytearray(sidecar.blob)
        blob[-1] ^= 1                 # one byte, the element stays canonical
        return type(sidecar)(
            index=sidecar.index, blob=bytes(blob),
            kzg_commitment=sidecar.kzg_commitment,
            kzg_proof=sidecar.kzg_proof,
            signed_block_header=sidecar.signed_block_header,
            kzg_commitment_inclusion_proof=list(
                sidecar.kzg_commitment_inclusion_proof))

    def imported(chain, name: str) -> None:
        head = chain.head()
        check(head.head_block_root == block_root,
              f"{name}: the head {head.head_block_root.hex()} is not the "
              f"block")
        check(not chain.is_optimistic_head(), f"{name}: the head is "
                                              f"optimistic")
        stored = chain.store.get_block(block_root)
        check(stored is not None and htr(stored.message) == block_root,
              f"{name}: the store does not return the block")
        check(head.head_state.hash_tree_root() == cw.post_root
              == bytes(block.message.state_root),
              f"{name}: the post-state root is not the block's state_root "
              f"(the workload's signatures-off pass)")

    try:
        with tempfile.TemporaryDirectory() as tmp:
            # a request without a valid token: 401, and not logged
            conn = http.client.HTTPConnection("127.0.0.1", engine.port,
                                              timeout=10)
            conn.request("POST", "/", body=json.dumps({
                "jsonrpc": "2.0", "id": 1,
                "method": "engine_exchangeCapabilities", "params": [[]]}),
                headers={"Content-Type": "application/json",
                         "Authorization": "Bearer " + JwtAuth(
                             secrets.token_bytes(32)).generate_token()})
            unauthorized = conn.getresponse().status
            conn.close()
            check(unauthorized == 401 and not engine.requests,
                  f"the engine answered a request with a wrong token "
                  f"{unauthorized} (logged: {engine.requests})")

            # (b) the import: the block pending, a tampered sidecar
            # refused, the six sidecars completing it
            t0 = time.perf_counter()
            chain = anchored(tmp, "a", "anchor")
            report["anchor_s"] = time.perf_counter() - t0
            first = len(engine.requests)
            spans_before = {s.span_id for s in tracing.snapshot()}
            bls_before = {k.name: k.launches for k in kernels.BLS_KERNELS}
            block_ms, got = launches_of.run(
                "import", lambda: through_processor(chain, block))
            check(isinstance(got, BlockError)
                  and got.kind == AVAILABILITY_PENDING,
                  f"the block's gossip import gave {got!r}, not "
                  f"{AVAILABILITY_PENDING}")
            pending(chain, "gpu")
            check("engine_newPayloadV3" in engine.requests[first:],
                  f"no engine_newPayloadV3 over HTTP: "
                  f"{engine.requests[first:]}")
            bad = tampered(pw.sidecars[0])
            check(launches_of.run("import", lambda: chain.process_blob_sidecar(
                bad)) is None and not chain.data_availability_checker
                  .contains_sidecar(block_root, 0),
                  "the tampered sidecar was taken")
            pending(chain, "gpu, after the tampered sidecar")
            sidecar_ms, got = [], None
            for sc in pw.sidecars:
                t = time.perf_counter()
                got = launches_of.run(
                    "import", lambda sc=sc: chain.process_blob_sidecar(sc))
                sidecar_ms.append((time.perf_counter() - t) * 1e3)
            check(got == block_root, f"the last sidecar returned {got!r}")
            imported(chain, "gpu")
            methods = engine.requests[first:]
            check("engine_forkchoiceUpdatedV3" in methods,
                  f"no engine_forkchoiceUpdatedV3 over HTTP: {methods}")
            check(all(k.launches > bls_before[k.name]
                      for k in kernels.BLS_KERNELS),
                  "the import's batch did not run on the gpu backend's "
                  "kernels")
            spans = [s for s in tracing.snapshot()
                     if s.span_id not in spans_before]
            comp = critpath.worst_component(spans)
            check(comp is not None, "no block_pipeline trace recorded")
            stages = critpath.component_report(comp)
            span_ms = {}
            for s in spans:
                span_ms[s.kind] = span_ms.get(s.kind, 0.0) + s.duration * 1e3
            import_ms = block_ms + sum(sidecar_ms)
            report.update(block_ms=block_ms, sidecar_ms=sidecar_ms,
                          import_ms=import_ms, stages=stages,
                          span_ms=span_ms, engine_methods=methods)
            split = ", ".join(
                f"{k} {stages['stages'][k]['service_ms']:.1f}"
                for k in ("processor_work", "block_pipeline",
                          "gossip_verify", "block_import", "batch_signature",
                          "state_transition", "stf_block", "state_root",
                          "el_new_payload") if k in stages["stages"])
            spent = ", ".join(f"{k} {span_ms[k]:.1f}" for k in (
                "el_new_payload", "kzg_verify", "fork_choice", "db_write",
                "el_forkchoice") if k in span_ms)
            print(f"postmerge import: the block through the beacon processor "
                  f"held pending its blobs ({block_ms:.1f} ms submit to "
                  f"idle, engine_newPayloadV3 over HTTP with JWT); a sidecar "
                  f"with one blob byte changed refused (the block still "
                  f"pending); the six sidecars (header signature on gpu, "
                  f"KZG proofs on the C++ library) "
                  f"{[round(x, 1) for x in sidecar_ms]} ms, the last "
                  f"importing it: the head on it, not optimistic, its "
                  f"post-state root the block's; the engine logged "
                  f"{methods}; a request with a wrong token 401, not "
                  f"logged [{card}]", flush=True)
            print(f"postmerge import: {import_ms:.1f} ms on 1 fresh chain "
                  f"(the block submit to idle and the six sidecars); the "
                  f"block's critical path {stages['total_ms']:.1f} ms: "
                  f"{split}; spans summed over the import (ms): {spent} "
                  f"[{card}]", flush=True)

            # (c) the builder flow for the next slot's proposer
            nxt = slot + 1
            head_state = chain.head().head_state
            proposer = get_beacon_proposer_index(head_state, nxt)
            check(proposer in set(w.rows.tolist()),
                  f"the next slot's proposer {proposer} has no interop key")
            nxt_epoch = nxt // spec.preset.slots_per_epoch
            reveal = cpp.sign(keygen_interop(proposer), compute_signing_root(
                hash_tree_root(uint64, nxt_epoch),
                get_domain(head_state, DOMAIN_RANDAO, nxt_epoch)))
            chain.slot_clock.set_slot(nxt)
            mock = MockBuilder(chain,
                               bid_wei=chain.LOCAL_PAYLOAD_VALUE_WEI * 10)
            fee = b"\xbb" * 20
            try:
                chain.builder = BuilderHttpClient(mock.start_http())
                pk = bytes(head_state.validators.pubkeys[proposer])
                chain.register_validators([{"message": {
                    "fee_recipient": "0x" + fee.hex(),
                    "gas_limit": 30_000_000, "timestamp": 0,
                    "pubkey": "0x" + pk.hex()},
                    "signature": "0x" + "00" * 96}])
                produced, production_ms = {}, {}
                for source, bid in (("builder", mock.bid_wei), ("local", 1)):
                    mock.bid_wei = bid
                    t = time.perf_counter()
                    blk, post = launches_of.run(
                        "production", lambda: chain.produce_block(reveal, nxt))
                    production_ms[source] = (time.perf_counter() - t) * 1e3
                    produced[source] = blk
                    check(chain.block_production_log[-1]["source"] == source,
                          f"a bid of {bid} wei gave the "
                          f"{chain.block_production_log[-1]['source']} "
                          f"payload, not {source}")
                    check(post.hash_tree_root() == bytes(blk.state_root),
                          "the produced block's state root is not its "
                          "post-state's")
                bp = produced["builder"].body.execution_payload
                check(bytes(bp.block_hash) in mock.payloads
                      and bytes(bp.fee_recipient) == fee
                      and mock.unblind_requests
                      and bytes(produced["local"].body.execution_payload
                                .block_hash) not in mock.payloads,
                      "the builder's payload is not in the produced block")
            finally:
                mock.stop()
                chain.builder = None
            report["production_ms"] = production_ms
            print(f"postmerge builder: produce_block for slot {nxt}'s "
                  f"proposer {proposer} (registered with a MockBuilder over "
                  f"HTTP): a bid of 10x the local value gave the builder's "
                  f"payload (unblinded by submit_blinded_block, read by "
                  f"payload_from_json) in {production_ms['builder']:.1f} ms, "
                  f"a bid of 1 wei the local one in "
                  f"{production_ms['local']:.1f} ms (each with its state "
                  f"root on the card) [{card}]", flush=True)

            # (d) the slasher: the block's aggregates by the phase, the
            # gossip batch, the equivocation and the double vote by the
            # chain's gossip checks
            t0 = time.perf_counter()
            singles = sw.gossip_attestations(
                head_state, block_root, sw.GOSSIP_SINGLES, cpp,
                threads=cores, target_root=anchor_root)
            twin = sw.double_vote(head_state, singles[0][0], anchor_root, cpp)
            report["sign_s"] = time.perf_counter() - t0
            block_indexed = [get_indexed_attestation(head_state, a)
                             for a in block.message.body.attestations]
            for indexed in block_indexed:
                chain.slasher.accept_attestation(indexed)
            t0 = time.perf_counter()
            verdicts = _verdicts(launches_of.run(
                f"gossip {len(singles)}", lambda: chain.
                batch_verify_unaggregated_attestations_for_gossip(singles)))
            gossip_ms = (time.perf_counter() - t0) * 1e3
            check(verdicts == ["ok"] * len(singles),
                  f"the gossip batch: {sorted(set(verdicts))}")
            refused = {}
            try:
                launches_of.run("equivocation", lambda: chain
                                .process_gossip_block(pw.equivocation))
            except BlockError as e:
                refused["equivocation"] = e.kind
            try:
                launches_of.run("double vote", lambda: av
                                .verify_unaggregated_for_gossip(
                                    chain, twin, singles[0][1]))
            except AttestationError as e:
                refused["double vote"] = e.kind
            check(refused == {"equivocation": REPEAT_PROPOSAL,
                              "double vote": PRIOR_SEEN},
                  f"the planted offences through the gossip checks: "
                  f"{refused}")
            t0 = time.perf_counter()
            found = chain.slasher.process_queued(epoch)
            slasher_ms = (time.perf_counter() - t0) * 1e3
            proposer_recs = [r for r in found if r.kind == "double" and not
                             hasattr(r.attestation_2, "attesting_indices")]
            attester_recs = [r for r in found if r.kind == "double" and
                             hasattr(r.attestation_2, "attesting_indices")]
            check(len(found) == 2 and len(proposer_recs) == 1
                  and len(attester_recs) == 1,
                  f"the slasher found {[(r.kind, r.validator_index) for r in found]}, "
                  f"not one double proposal and one double vote")
            prec, arec = proposer_recs[0], attester_recs[0]
            check({htr(prec.attestation_1.message),
                   htr(prec.attestation_2.message)}
                  == {block_root, htr(pw.equivocation.message)},
                  "the double-proposal record lacks the two blocks")
            check(htr(arec.attestation_2.data) == htr(twin.data)
                  and htr(arec.attestation_1.data) == htr(
                      singles[0][0].data),
                  "the double-vote record lacks the two votes")
            ops = [record_to_operation(r, chain.T) for r in (prec, arec)]
            chain.op_pool.insert_proposer_slashing(ops[0])
            chain.op_pool.insert_attester_slashing(ops[1])
            packed = chain.op_pool.get_slashings_and_exits(head_state)
            check([htr(x) for x in packed[0]] == [htr(ops[0])]
                  and [htr(x) for x in packed[1]] == [htr(ops[1])],
                  "the op pool does not pack the two slashings")
            st = head_state.copy()
            launches_of.run("slashings", lambda: (
                process_proposer_slashing(st, ops[0], VerifySignatures.TRUE),
                process_attester_slashing(st, ops[1], VerifySignatures.TRUE)))
            check(st.validators.view(int(prec.validator_index)).slashed
                  and st.validators.view(int(arec.validator_index)).slashed,
                  "applying the slashings slashed no one")
            written = (len(chain.slasher.min_target._written)
                       + len(chain.slasher.max_target._written))
            report.update(gossip_ms=gossip_ms, slasher_ms=slasher_ms,
                          slasher_memory_bytes=chain.slasher.memory_bytes(),
                          slasher_chunks_written=written,
                          slasher_records=[(r.kind, r.validator_index)
                                           for r in found])
            print(f"postmerge slasher (history {SLASHER_HISTORY} epochs, the "
                  f"default 4,096 cut: PERF.md section 4): the block's "
                  f"{len(block_indexed)} aggregates "
                  f"({sum(len(a.attesting_indices) for a in block_indexed)} "
                  f"validators) fed by the phase itself (the chain feeds the "
                  f"slasher from gossip only); {len(singles)} gossip singles "
                  f"verified on gpu through the chain ({gossip_ms:.1f} ms); "
                  f"the equivocating block refused {REPEAT_PROPOSAL} and the "
                  f"double vote {PRIOR_SEEN}, each after its signature was "
                  f"checked and it was handed to the slasher; "
                  f"process_queued {slasher_ms:.1f} ms: a double proposal by "
                  f"{prec.validator_index} and a double vote by "
                  f"{arec.validator_index}, each with both signed messages, "
                  f"turned into a ProposerSlashing and an AttesterSlashing "
                  f"the op pool packs and a state applies with their "
                  f"signatures verified on gpu; cache "
                  f"{report['slasher_memory_bytes']} B, {written} chunks "
                  f"written [{card}]", flush=True)
            del chain, head_state, st

            # (e) a fresh chain's import under the profiler, and the
            # payload the engine marks invalid on another
            chain = anchored(tmp, "b")

            def full_import():
                try:
                    chain.process_gossip_block(block)
                except BlockError as e:
                    check(e.kind == AVAILABILITY_PENDING, f"profiled: {e}")
                for sc in pw.sidecars:
                    last = chain.process_blob_sidecar(sc)
                check(last == block_root, "profiled: not imported")

            before = sum(k.launches for k in kernels.KERNELS.values())
            prof = profiled(full_import)
            call_launches = sum(k.launches
                                for k in kernels.KERNELS.values()) - before
            imported(chain, "profiled")
            del chain
            chain = anchored(tmp, "c", "invalid payload")
            engine.invalid_hashes.add("0x" + bytes(payload.block_hash).hex())
            try:
                _ms, got = launches_of.run(
                    "invalid payload", lambda: through_processor(chain, block))
            finally:
                engine.invalid_hashes.clear()
            check(isinstance(got, BlockError)
                  and got.kind == EXECUTION_INVALID
                  and chain.head().head_block_root == anchor_root
                  and not chain.fork_choice.contains_block(block_root)
                  and chain.store.get_block(block_root) is None,
                  f"the payload the engine marks invalid gave {got!r}")
            del chain
    finally:
        engine.stop()
    torch.cuda.synchronize()
    busy = (f"device busy {prof['device_busy_ms']:.2f} ms "
            f"({prof['device_events']} device events), the card idle "
            f"{100 * (1 - prof['device_busy_share']):.1f} % of the import"
            if prof["device_events"] >= call_launches else
            f"device busy not measured (the profile holds "
            f"{prof['device_events']} device events, fewer than the "
            f"import's {call_launches} kernel launches)")
    print(f"postmerge import: on a fresh chain under the profiler "
          f"{prof['wall_ms']:.1f} ms wall, {busy}; on another the payload "
          f"the engine marks invalid refused {EXECUTION_INVALID} after "
          f"engine_newPayloadV3, the head on the anchor, the block in "
          f"neither fork choice nor the store [{card}]", flush=True)
    names = [k.name for k in kernels.STATE_ROOT_KERNELS + kernels.BLS_KERNELS]
    launches = launches_of.totals(names)
    by_call = launches_of.by_call(names)
    for name in names:
        check(by_call["import"].get(name, 0) > 0,
              f"kernel {name} was not launched by the import")
    print(f"postmerge launches on the path (the gpu chains' own calls: 3 "
          f"anchorings, the import with its sidecars, 2 productions, the "
          f"gossip batch, the equivocation, the double vote, the "
          f"slashings, the refused import): {launches}; by call {by_call} "
          f"[{card}]", flush=True)
    report.update(profile=prof, launches=launches, launches_by_call=by_call)
    report["seconds"] = time.perf_counter() - t_phase
    print(f"postmerge phase: {report['seconds']:.1f} s [{card}]", flush=True)
    return report


#: the libp2p security protocol of phase 10's nodes, passed to every
#: ``NetworkConfig``: never None, which would let the transport pick
#: plaintext wherever ``cryptography`` is missing. Noise XX: the H100
#: machine imports ``cryptography`` (48.0.0); without it the transport
#: raises instead of falling back
NETWORK_SECURITY = "noise"
#: every wait of phase 10 on another node's work, in seconds
NETWORK_DEADLINE = 300.0


class _WireBytes:
    """The bytes the process writes to its sockets (``socket.sendall``:
    every frame of the transport, the handshakes included; ``sendto``:
    discv5's packets) while installed, in total and by the label last
    set; while ``by_conn`` is a dict, also by (local address, remote
    address)."""

    def __init__(self):
        import threading
        self.by_label: dict[str, int] = {}
        self.label = "setup"
        self.by_conn: dict | None = None
        self._lock = threading.Lock()
        self._inner = None

    def _add(self, sock, n: int, remote=None) -> None:
        with self._lock:
            self.by_label[self.label] = self.by_label.get(self.label, 0) + n
            if self.by_conn is not None:
                try:
                    key = (sock.getsockname(), remote or sock.getpeername())
                except OSError:
                    return
                self.by_conn[key] = self.by_conn.get(key, 0) + n

    def __enter__(self):
        import socket
        self._inner = sendall, sendto = (socket.socket.sendall,
                                         socket.socket.sendto)
        counter = self

        def counted_sendall(sock, data, *args):
            counter._add(sock, len(data))
            return sendall(sock, data, *args)

        def counted_sendto(sock, data, *args):
            counter._add(sock, len(data), args[-1])
            return sendto(sock, data, *args)

        socket.socket.sendall = counted_sendall
        socket.socket.sendto = counted_sendto
        return self

    def __exit__(self, *exc) -> None:
        import socket
        socket.socket.sendall, socket.socket.sendto = self._inner


def _until(cond, what: str, timeout: float = NETWORK_DEADLINE) -> float:
    """Wait for ``cond()`` with a deadline; the seconds it took. Raises
    where the deadline passes."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout,
              f"{what}: not within {timeout:.0f} s")
        time.sleep(0.005)
    return time.perf_counter() - t0


def _mem_line() -> str:
    """The host's available memory and this process's resident set."""
    meminfo = dict(line.split(":", 1) for line in
                   Path("/proc/meminfo").read_text().splitlines())
    status = dict(line.split(":", 1) for line in
                  Path("/proc/self/status").read_text().splitlines()
                  if ":" in line)
    return (f"host MemAvailable {meminfo['MemAvailable'].strip()}, "
            f"VmRSS {status['VmRSS'].strip()}")


#: how long node F stalls node D's range request in phase 10's step (e),
#: in seconds: F reads the request, answers nothing, then resets the stream
STALL_SECS = 3.0
#: the seed of step (e)'s fault injector and of node F's libp2p key
FAULT_SEED = 16


def _identity_before(node_id: str, seed: int):
    """A libp2p identity drawn from ``seed`` whose node id sorts before
    ``node_id``: range sync hands a batch to the first fresh peer of its
    pool in node-id order, so a node with it is asked first."""
    from lighthouse_tpu_torch.network.secp256k1 import N
    from lighthouse_tpu_torch.network.transport import NodeIdentity

    rng = np.random.default_rng(seed)
    for _ in range(100_000):
        ident = NodeIdentity(int.from_bytes(rng.bytes(32), "big") % (N - 1)
                             + 1)
        if ident.node_id < node_id:
            return ident
    raise SmokeFailure(f"no identity sorts before {node_id}")


def discovery_step(chain_a, na, node, wire, card: str) -> dict:
    """Phase 10's step (e): a node found by discv5 range-syncs past a
    stalling peer. A ``BootNode`` on 127.0.0.1; ``node(name, injector,
    label, identity)`` makes a started node (a chain anchored at the
    anchor and its service on a ``FaultyTransport`` registered with
    ``injector`` under ``label``). F range-syncs A's chain over a
    transparent link; A, F and then D get a ``Discovery`` holding only the
    bootnode's ENR; F stalls every range request of D's
    (``PeerBehavior("stall")``). D's ``discover_once`` finds A and F by
    FINDNODE and dials both while D's sync manager is held (as a node busy
    with a sync holds it), so its first drive sees both peers: F's node id
    sorts first, so F is asked for the epoch's batch on every run, stalls
    it, and D takes it from A. Checks: the lookups surfaced A and F, each
    ENR advertises its service's TCP port, the stall was served and D
    penalised F for it, D's head and head state's root are A's, D's
    routing table round-trips through its store (``persist_dht``,
    ``load_dht``). The report holds the times (the lookup to the dials,
    the dial to D's head split into the stall, the download, the decode
    and the replay's stages), the bytes on D's sockets and the penalties.
    """
    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch.network.discovery import BootNode, Discovery
    from lighthouse_tpu_torch.network.faults import (
        FaultInjector, PeerBehavior,
    )
    from lighthouse_tpu_torch.network.persisted_dht import (
        load_dht, persist_dht,
    )
    from lighthouse_tpu_torch.profile_state_root import profiled

    target = chain_a.head().head_block_root
    target_state = chain_a.head().head_state.hash_tree_root()
    injector = FaultInjector(seed=FAULT_SEED)
    boot = BootNode()
    boot.start()
    discos = []
    rep: dict = {"stall_secs": STALL_SECS}
    try:
        # F: range-syncs A's two blocks over a transparent link, its key
        # one whose node id sorts before A's
        t0 = time.perf_counter()
        chain_f, nf = node("f", injector, "F",
                           _identity_before(na.transport.node_id, FAULT_SEED))
        check(nf.dial("127.0.0.1", na.port) is not None, "F to A: the dial "
                                                         "failed")
        # D, fresh at the anchor, built while F syncs
        chain_d, nd = node("d", injector, "D", None)
        _until(lambda: chain_f.head().head_block_root == target,
               "F's head by range sync")
        _until(lambda: nf.sync.ctx.imported_total == 2,
               "F's count of imported blocks")
        rep["f_sync_ms"] = (time.perf_counter() - t0) * 1e3

        # discovery: A and F register with the bootnode, then D joins
        da = Discovery(na, bootnode_enrs=[boot.enr])
        discos.append(da)
        df = Discovery(nf, bootnode_enrs=[boot.enr])
        discos.append(df)
        injector.set_behavior("F", "D", PeerBehavior(
            "stall", stall_secs=STALL_SECS))
        a_id, f_id = na.transport.node_id, nf.transport.node_id
        check(f_id < a_id, "F's node id does not sort before A's")

        found, dials, fetches, penalties = [], [], [], []
        decode_s = []
        ctx = nd.sync.ctx
        fetch, decode, penalize = (ctx._fetch_range, ctx._decode_block,
                                   ctx.penalize)
        dial = nd.dial

        def timed_dial(host, port):
            t = time.perf_counter()
            peer = dial(host, port)
            dials.append(((host, port), t, time.perf_counter(),
                          peer is not None))
            return peer

        def timed_fetch(peer_id, start, count):
            t = time.perf_counter()
            ok = False
            try:
                out = fetch(peer_id, start, count)
                ok = True
                return out
            finally:
                fetches.append((peer_id, t, time.perf_counter(), ok))

        def timed_decode(*args, **kwargs):
            t = time.perf_counter()
            try:
                return decode(*args, **kwargs)
            finally:
                decode_s.append(time.perf_counter() - t)

        def noted_penalty(peer_id, reason):
            penalties.append((peer_id, reason))
            return penalize(peer_id, reason)

        nd.dial = timed_dial
        ctx._fetch_range, ctx._decode_block = timed_fetch, timed_decode
        ctx.penalize = noted_penalty

        def connected(svc, node_id) -> bool:
            info = svc.peers.peers.get(node_id)
            return node_id in svc.transport.peers and info is not None \
                and info.status is not None

        wire.label = "e"
        wire.by_conn = {}
        rounds = []
        # D's sync manager held while it discovers and dials; released
        # inside the profiler's window, which spans D's range sync (the
        # profiler's one-time start-up taken first, outside it)
        profiled(lambda: None)
        lock = nd.sync._drive_lock
        lock.acquire()
        held = True
        try:
            t_lookup = time.perf_counter()
            dd = Discovery(nd, bootnode_enrs=[boot.enr])
            discos.append(dd)
            bootstrap_ms = (time.perf_counter() - t_lookup) * 1e3
            lookup = dd.disc.lookup

            def recorded_lookup(*args, **kwargs):
                out = lookup(*args, **kwargs)
                found.extend(e.node_id for e in out)
                return out

            dd.disc.lookup = recorded_lookup
            while not (a_id in nd.transport.peers
                       and f_id in nd.transport.peers):
                check(time.perf_counter() - t_lookup < NETWORK_DEADLINE,
                      "D's discovery did not reach A and F")
                t = time.perf_counter()
                made = dd.discover_once()
                rounds.append({"made": made,
                               "ms": (time.perf_counter() - t) * 1e3})
            t_dialed = time.perf_counter()
            _until(lambda: connected(nd, a_id) and connected(nd, f_id),
                   "D's status exchanges with A and F")
            t_status = time.perf_counter()
            t_first = min(d[1] for d in dials if d[3])
            synced = {}

            def sync_d():
                nonlocal held
                synced["release"] = time.perf_counter()
                lock.release()
                held = False
                _until(lambda: chain_d.head().head_block_root == target,
                       "D's head by range sync past F's stall")
                synced["head"] = time.perf_counter()
                _until(lambda: ctx.imported_total == 2,
                       "D's count of imported blocks")

            before = sum(k.launches for k in kernels.KERNELS.values())
            prof = profiled(sync_d)
            sync_launches = sum(k.launches for k in
                                kernels.KERNELS.values()) - before
        finally:
            if held:
                lock.release()
        t_head = synced["head"]
        engine = chain_d.replay_engine().snapshot()

        want = {da.enr.node_id, df.enr.node_id}
        check(want <= set(found), "D's lookups did not surface A and F")
        for name, disco, svc in (("A", da, na), ("F", df, nf),
                                 ("D", dd, nd)):
            check(disco.enr.tcp() == svc.port,
                  f"{name}'s ENR advertises TCP port {disco.enr.tcp()}, not "
                  f"its service's {svc.port}")
        check(injector.behaviors_served.get("stall", 0) >= 1,
              "F never stalled D's range request")
        check(fetches and fetches[0][0] == f_id and not fetches[0][3],
              "D's first range request did not go to F and fail")
        check(any(p == f_id for p, _r in penalties)
              and nd.peers.score(f_id) < 0, "D did not penalise F")
        check(any(p == a_id and ok for p, _t, _e, ok in fetches),
              "D did not download the batch from A")
        check(chain_d.head().head_block_root == target
              and chain_d.head().head_state.hash_tree_root()
              == target_state, "D's head or its state root is not A's")
        check(engine["segments_replayed"] == 1
              and engine["blocks_committed"] == 2,
              f"D's replay engine: {engine['segments_replayed']} segments, "
              f"{engine['blocks_committed']} blocks")
        persisted = persist_dht(chain_d.store, dd.disc.table.all())
        loaded = {e.node_id for e in load_dht(chain_d.store)}
        check(want <= loaded, "D's routing table did not round-trip A and "
                              "F through its store")

        # D's sockets: its connections' and its discv5 socket's addresses
        d_local = {p.sock.getsockname() for p in nd.transport.peers.values()}
        d_local.add(dd.disc.sock.getsockname())
        conns = wire.by_conn
        wire.by_conn = None
        sent = sum(n for (lo, _r), n in conns.items() if lo in d_local)
        recv = sum(n for (_l, re), n in conns.items() if re in d_local)
        udp = dd.disc.sock.getsockname()
        sent_udp = sum(n for (lo, _r), n in conns.items() if lo == udp)
        recv_udp = sum(n for (_l, re), n in conns.items() if re == udp)

        stall = [(e - t) * 1e3 for p, t, e, ok in fetches if p == f_id]
        download = [(e - t) * 1e3 for p, t, e, ok in fetches
                    if p == a_id and ok]
        busy = engine["busy_seconds"]
        split = {"status": (t_status - t_first) * 1e3,
                 "stall": sum(stall),
                 "download": sum(download) - sum(decode_s) * 1e3,
                 "decode": sum(decode_s) * 1e3,
                 **{k: busy[k] * 1e3 for k in busy}}
        rep.update(
            status_to_release_ms=(synced["release"] - t_status) * 1e3,
            found=len(set(found)), rounds=rounds, bootstrap_ms=bootstrap_ms,
            lookup_to_dialed_ms=(t_dialed - t_lookup) * 1e3,
            dial_to_head_ms=(t_head - t_first) * 1e3, split=split,
            dials=[{"ms": (e - t) * 1e3, "ok": ok} for _a, t, e, ok in dials],
            penalties=[{"peer": "F" if p == f_id else "A" if p == a_id
                        else p[:16], "reason": r} for p, r in penalties],
            score_of_f=nd.peers.score(f_id),
            stalls_served=injector.behaviors_served.get("stall", 0),
            dht_persisted=persisted, dht_loaded=len(loaded), replay=engine,
            profile=prof, sync_launches=sync_launches,
            d_bytes={"tcp_sent": sent - sent_udp, "tcp_received":
                     recv - recv_udp, "udp_sent": sent_udp,
                     "udp_received": recv_udp})
        print(f"network discovery (e): F range-synced A's two blocks in "
              f"{rep['f_sync_ms']:.1f} ms (transparent link); D bootstrapped "
              f"from the bootnode's ENR in {bootstrap_ms:.1f} ms, its "
              f"lookups surfaced {rep['found']} nodes (A and F among them) "
              f"and it dialed A and F ({nd.transport.security}) "
              f"{rep['lookup_to_dialed_ms']:.1f} ms after its first lookup "
              f"({len(rounds)} round(s) of discover_once, "
              f"{[round(r['ms'], 1) for r in rounds]} ms); every ENR "
              f"advertises its service's TCP port [{card}]", flush=True)
        print(f"network stall (e): F stalled D's batch request "
              f"{rep['stalls_served']} time(s) ({STALL_SECS:.1f} s, then a "
              f"reset), D penalised it {[r for _p, r in penalties]} (score "
              f"{rep['score_of_f']:.1f}) and took the batch from A; D's head "
              f"A's, its state root A's, {rep['dial_to_head_ms']:.1f} ms "
              f"after its first dial; split (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
              + f" [{card}]", flush=True)
        idle = (f"device busy {prof['device_busy_ms']:.2f} ms "
                f"({prof['device_events']} device events), the card idle "
                f"{100 * (1 - prof['device_busy_share']):.1f} % of it"
                if prof["device_events"] >= sync_launches else
                f"device busy not measured (the profile holds "
                f"{prof['device_events']} device events, fewer than the "
                f"sync's {sync_launches} kernel launches)")
        print(f"network range sync (e) under the profiler (D's, from the "
              f"release of its sync manager, "
              f"{rep['status_to_release_ms']:.1f} ms after both statuses, "
              f"to its imports): {prof['wall_ms']:.1f} ms wall, {idle} "
              f"[{card}]", flush=True)
        print(f"network dht (e): D persisted {persisted} ENRs into its "
              f"store and loaded {len(loaded)} back, A's and F's among them; "
              f"bytes on D's sockets: TCP {rep['d_bytes']['tcp_sent']} sent, "
              f"{rep['d_bytes']['tcp_received']} received, discv5 "
              f"{sent_udp} sent, {recv_udp} received [{card}]", flush=True)
        return rep
    finally:
        wire.by_conn = None
        for disco in discos:
            disco.stop()
        boot.stop()


#: the single-bit attestations node A gossips in phase 10's step (c), and
#: one more carrying its neighbour's signature (the post-merge workload's
#: ``GOSSIP_SINGLES`` until step (f) came: cut so that the smoke keeps
#: inside its time limit)
NETWORK_SINGLES = 512
#: the validator client's attesters in each committee of its slot (step
#: (f)): two members of each of the slot's 64 committees at 1M validators
VC_ATTESTERS_PER_COMMITTEE = 2
#: step (f)'s serving fleet: threads, and requests a thread (half proposer
#: duties, half attestation_data: ``bench.py`` ``bench_serving``'s mix)
FLEET_THREADS, FLEET_REQUESTS = 8, 250


def validator_client_process(url: str, rows: list, gvr: bytes, slot: int,
                             conn) -> None:
    """The validator client of phase 10's step (f), in a process of its
    own (spawned: it re-imports this module, so the script keeps its work
    under ``if __name__ == "__main__"``): ``_validator_client_slot``'s
    report, or the traceback of its failure, sent on ``conn``."""
    try:
        conn.send(_validator_client_slot(url, rows, gvr, slot))
    except Exception:
        import traceback
        conn.send({"error": traceback.format_exc()})
    finally:
        conn.close()


def _validator_client_slot(url: str, rows: list, gvr: bytes,
                           slot: int) -> dict:
    """A validator client with the interop keys of ``rows`` (the proposer
    of ``slot`` first) on the ``cpp`` backend, its slashing protection in
    sqlite under a temp dir, talking to the beacon node at ``url`` only
    through ``BeaconNodeFallback([BeaconNodeHttpClient(url, spec)])``; one
    ``ValidatorClient.on_slot(slot)``. Then a second block for the slot
    (the first with another graffiti) must be refused by its store, never
    sent. The report: each HTTP call (method, path, start, end, status;
    ``time.perf_counter``, the host's monotonic clock, so the caller can
    compare), each signature's seconds, the signed block's SSZ, the
    posted attestations' SSZ, the duties and indices the client holds,
    its counters."""
    import os
    import tempfile

    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import keygen_interop
    from lighthouse_tpu_torch.specs.chain_spec import mainnet_spec
    from lighthouse_tpu_torch.ssz import deserialize, serialize
    from lighthouse_tpu_torch.validator_client import (
        BeaconNodeFallback, BeaconNodeHttpClient, SlashingDatabase,
        SlashingError, ValidatorClient, ValidatorStore,
    )
    from lighthouse_tpu_torch.validator_client.http_client import (
        HttpApiError,
    )

    bls.set_backend("cpp")
    spec = mainnet_spec()
    calls, signs, posted = [], [], []
    client = BeaconNodeHttpClient(url, spec, timeout=NETWORK_DEADLINE)
    request, publish_attestation = client._req, client.publish_attestation

    def recorded_request(method, path, *args, **kwargs):
        t0, status = time.perf_counter(), 200
        try:
            return request(method, path, *args, **kwargs)
        except HttpApiError as e:
            status = e.status
            raise
        except Exception:
            status = -1
            raise
        finally:
            calls.append((method, path.split("?")[0], t0,
                          time.perf_counter(), status))

    def recorded_attestation(att):
        posted.append(serialize(type(att).ssz_type, att))
        return publish_attestation(att)

    client._req = recorded_request
    client.publish_attestation = recorded_attestation
    sign = bls.sign

    def timed_sign(sk, message):
        t0 = time.perf_counter()
        try:
            return sign(sk, message)
        finally:
            signs.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as tmp:
        store = ValidatorStore(spec, gvr, SlashingDatabase(
            os.path.join(tmp, "slashing_protection.sqlite")))
        t0 = time.perf_counter()
        pubkeys = [store.add_validator(keygen_interop(int(r))) for r in rows]
        keys_s = time.perf_counter() - t0
        signed = []
        sign_block = store.sign_block

        def recorded_sign_block(pk, block):
            sig = sign_block(pk, block)
            signed.append((pk, block, sig))
            return sig

        store.sign_block = recorded_sign_block
        vc = ValidatorClient(spec, store, BeaconNodeFallback([client]))
        bls.sign = timed_sign
        try:
            t_start = time.perf_counter()
            vc.on_slot(slot)
            t_end = time.perf_counter()
        finally:
            bls.sign = sign
        refused = block_ssz = None
        if signed:
            pk, block, sig = signed[0]
            ssz = type(block).ssz_type
            block_ssz = serialize(ssz, block), sig
            other = deserialize(ssz, block_ssz[0])
            other.body.graffiti = bytes(b ^ 0xFF for b in other.body.graffiti)
            try:
                store.sign_block(pk, other)
            except SlashingError as e:
                refused = str(e) or "SlashingError"
        spe = spec.preset.slots_per_epoch
        epochs = (slot // spe, slot // spe + 1)
        return {
            "start": t_start, "end": t_end,
            "keys_s": keys_s, "pubkeys": [pk.hex() for pk in pubkeys],
            "indices": {pk.hex(): i for pk, i in vc._indices.items()},
            "attester_duties": {e: vc._duties.get(e) for e in epochs},
            "proposer_duties": {e: vc._proposers.get(e) for e in epochs},
            "calls": calls, "signs": signs, "posted": posted,
            "block": block_ssz, "blocks_signed": len(signed),
            "second_block_refused": refused,
            "published": {"blocks": vc.published_blocks,
                          "attestations": vc.published_attestations,
                          "aggregates": vc.published_aggregates,
                          "sync_messages": vc.published_sync_messages}}


def _pcts(xs: list) -> tuple[float, float]:
    """(p50, p95) of ``xs`` (nearest rank)."""
    s = sorted(xs)
    return (s[(len(s) - 1) // 2],
            s[min(len(s) - 1, int(np.ceil(0.95 * len(s))) - 1)])


def validator_step(chain_a, na, chain_b, vc_rows: list, bad: tuple,
                   slot: int, card: str) -> dict:
    """Phase 10's step (f): a validator client over the Beacon API. On A's
    warm chain (its head the second block, B connected at the same head),
    both clocks at ``slot``: ``BeaconApiServer(ApiBackend(chain_a))`` on
    127.0.0.1 with its serving tier, the backend's ``publish_fn`` A's
    ``publish_block`` (as the simulator wires it); the attester and
    proposer duties of the slot's epoch e and of e + 1 by the backend's
    direct calls first (e + 1 advances a copy of the 1M state to the next
    epoch on every call); an SSE ``head`` stream opened; then the
    validator client in a process of its own
    (``validator_client_process``, ``vc_rows``' interop keys: ``slot``'s
    proposer and its attesters) runs ``on_slot(slot)`` once: indices,
    duties, the proposal (produced by A, signed in the client, posted,
    gossiped to B), the attestations, the aggregations; A's process under
    ``torch.profiler`` meanwhile (the card's idle share). Then, on the
    same server, the attestation of ``bad`` (a member of committee 0 the
    client does not hold, with its neighbour's signature) gets 400, the
    reads (state root, validators, finality, headers, the block in SSZ)
    and the serving fleet. Returns the step's times, counts and profile."""
    import http.client
    import multiprocessing
    import threading

    from lighthouse_tpu_torch import stf_workload as sw
    from lighthouse_tpu_torch.api import ApiBackend, BeaconApiServer
    from lighthouse_tpu_torch.chain.errors import BAD_SIGNATURE
    from lighthouse_tpu_torch.crypto.bls import SignatureSet
    from lighthouse_tpu_torch.crypto.bls.cpp_backend import CppBackend
    from lighthouse_tpu_torch.obs import critpath
    from lighthouse_tpu_torch.profile_state_root import profiled
    from lighthouse_tpu_torch.specs.chain_spec import compute_signing_root
    from lighthouse_tpu_torch.specs.constants import DOMAIN_BEACON_ATTESTER
    from lighthouse_tpu_torch.ssz import deserialize, htr, serialize
    from lighthouse_tpu_torch.state_transition.helpers import get_domain

    T = chain_a.T
    spe = chain_a.spec.preset.slots_per_epoch
    epoch = slot // spe
    rep: dict = {"slot": slot, "keys": len(vc_rows)}
    for chain in (chain_a, chain_b):
        chain.slot_clock.set_slot(slot)
    backend = ApiBackend(chain_a)
    backend.publish_fn = na.publish_block
    srv = BeaconApiServer(backend)
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"
    head0 = chain_a.head()
    listeners = []
    try:
        # the duties by the backend's direct calls, at the head the client
        # asks at
        direct, direct_ms = {}, {}
        for e in (epoch, epoch + 1):
            t0 = time.perf_counter()
            direct[("attester", e)] = backend.get_attester_duties(
                e, list(vc_rows))
            t1 = time.perf_counter()
            direct[("proposer", e)] = backend.get_proposer_duties(e)
            t2 = time.perf_counter()
            direct_ms[f"attester {e - epoch:+d}"] = (t1 - t0) * 1e3
            direct_ms[f"proposer {e - epoch:+d}"] = (t2 - t1) * 1e3
        check(direct[("proposer", epoch)][slot % spe] == (slot, vc_rows[0]),
              "the client's first key does not propose at its slot")

        # the head's arrival on A and B, and A's SSE stream
        heads = {"a": [], "b": []}
        for key, chain in (("a", chain_a), ("b", chain_b)):
            def on_head(kind, payload, key=key):
                heads[key].append((time.perf_counter(), payload.get("block")))
            chain.events.add_listener(("head",), on_head)
            listeners.append((chain, on_head))
        sse_events, sse_streams = [], []
        old_head = head0.head_block_root.hex()

        def sse_reader():
            # the server ends a stream after 30 s without an event; the
            # reader opens the next at once (``Connection: close``: the
            # server closes the socket when it ends the stream), as an
            # EventSource client does, until the head moves
            while time.perf_counter() - t_sse < NETWORK_DEADLINE:
                conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                                  timeout=NETWORK_DEADLINE)
                try:
                    conn.request("GET", "/eth/v1/events?topics=head",
                                 headers={"Connection": "close"})
                    r = conn.getresponse()
                    sse_streams.append(time.perf_counter())
                    while True:
                        line = r.fp.readline()
                        if not line:
                            break
                        if line.startswith(b"data: "):
                            event = json.loads(line[6:])
                            sse_events.append((time.perf_counter(), event))
                            if event.get("block") != old_head:
                                return
                except OSError:
                    return
                finally:
                    conn.close()

        before_subs = len(chain_a.events._subs)
        t_sse = time.perf_counter()
        sse = threading.Thread(target=sse_reader, daemon=True)
        sse.start()
        _until(lambda: len(chain_a.events._subs) > before_subs,
               "the SSE stream's subscription")

        # A's side of each attestation POST: its gossip verification
        verify_ms = []
        verify = chain_a.verify_unaggregated_attestation_for_gossip

        def timed_verify(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return verify(*args, **kwargs)
            finally:
                verify_ms.append((time.perf_counter() - t0) * 1e3)

        chain_a.verify_unaggregated_attestation_for_gossip = timed_verify
        spans_before = {s.span_id for s in tracing.snapshot()}

        # the validator client, a process of its own
        ctx = multiprocessing.get_context("spawn")
        parent, child = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=validator_client_process, args=(
            url, [int(r) for r in vc_rows],
            bytes(chain_a.genesis_validators_root), slot, child),
            daemon=True)
        got = {}

        def run_vc():
            proc.start()
            child.close()
            check(parent.poll(NETWORK_DEADLINE), "the validator client sent "
                                                 "no report")
            got.update(parent.recv())

        try:
            prof = profiled(run_vc)
        finally:
            proc.join(timeout=NETWORK_DEADLINE)
            if proc.is_alive():
                proc.kill()
                proc.join()
        chain_a.verify_unaggregated_attestation_for_gossip = verify
        check("error" not in got, f"the validator client failed:\n"
                                  f"{got.get('error')}")
        calls = got["calls"]
        by = {}
        for method, path, t0, t1, status in calls:
            by.setdefault((method, path), []).append((t0, t1, status))

        # the proposal: produced by A, signed in the client, A's head, then
        # B's by gossip
        check(got["blocks_signed"] == 1 and got["block"] is not None,
              f"the client signed {got['blocks_signed']} blocks")
        block_ssz, sig = got["block"]
        fork = chain_a.spec.fork_name_at_slot(slot)
        block = deserialize(T.BeaconBlock[fork].ssz_type, block_ssz)
        root = htr(block)
        check(int(block.slot) == slot and int(block.proposer_index)
              == vc_rows[0], "the client's block is not its slot's proposal")
        posts = by.get(("POST", "/eth/v1/beacon/blocks"), [])
        check(len(posts) == 1 and posts[0][2] == 200,
              f"the block's POSTs: {posts}")
        check(chain_a.head().head_block_root == root,
              "A's head is not the client's block")
        _until(lambda: chain_b.head().head_block_root == root,
               "B's head on the client's block by gossip")
        post_root = chain_a.head().head_state.hash_tree_root()
        check(chain_b.head().head_state.hash_tree_root() == post_root
              == bytes(block.state_root),
              "B's head state root is not A's and the block's")
        stored = chain_a.store.get_block(root)
        check(stored is not None and bytes(stored.signature) == sig,
              "A does not store the client's signed block")
        t_post = posts[0][0]
        t_a = min(t for t, r in heads["a"] if r == root)
        t_b = min(t for t, r in heads["b"] if r == root)
        sse.join(timeout=NETWORK_DEADLINE)
        check(sse_events and sse_events[-1][1].get("block") == root.hex(),
              f"the SSE stream's head events: {sse_events}")
        new_spans = [s for s in tracing.snapshot()
                     if s.span_id not in spans_before]
        production = [s.duration * 1e3 for s in new_spans
                      if s.kind == "block_production"]
        imports = [s.duration * 1e3 for s in sorted(
            new_spans, key=lambda s: s.start) if s.kind == "block_import"]
        gossip_checks = [s.duration * 1e3 for s in sorted(
            new_spans, key=lambda s: s.start) if s.kind == "gossip_verify"]
        comp = critpath.worst_component(new_spans)
        check(comp is not None, "no block trace after the publish")
        stages = critpath.component_report(comp)

        # the index lookups and the duties over HTTP
        want = {p: int(r) for p, r in zip(got["pubkeys"], vc_rows)}
        check(got["indices"] == want, "the client's indices over HTTP are "
                                      "not its keys' rows")
        for e in (epoch, epoch + 1):
            check([tuple(d) for d in got["attester_duties"][e]]
                  == direct[("attester", e)],
                  f"the attester duties of epoch {e} over HTTP differ")
            check([tuple(d) for d in got["proposer_duties"][e]]
                  == direct[("proposer", e)],
                  f"the proposer duties of epoch {e} over HTTP differ")

        # the attestations: every POST 200, the op pool holding every
        # committee's data, each set's verdict on cpp equal to A's on gpu
        att_gets = by.get(("GET", "/eth/v1/validator/attestation_data"), [])
        att_posts = by.get(("POST", "/eth/v1/beacon/pool/attestations"), [])
        n_att = len(vc_rows) - 1
        check(len(att_posts) == n_att
              and all(st == 200 for _a, _b, st in att_posts),
              f"attestation POSTs: {len(att_posts)}, statuses "
              f"{sorted({st for _a, _b, st in att_posts})}")
        atts = [deserialize(T.Attestation.ssz_type, b) for b in got["posted"]]
        committees = {int(a.data.index) for a in atts}
        with chain_a.op_pool._lock:
            pooled = {(int(a.data.slot), int(a.data.index),
                       bytes(a.data.beacon_block_root))
                      for bucket in chain_a.op_pool._attestations.values()
                      for a in bucket}
        check(all((slot, ci, root) in pooled for ci in committees)
              and len(committees) == n_att // VC_ATTESTERS_PER_COMMITTEE,
              f"the op pool holds {len(pooled)} attestation data, not the "
              f"{len(committees)} committees'")
        state = chain_a.head().head_state
        domain = get_domain(state, DOMAIN_BEACON_ATTESTER, epoch)
        members = dict(enumerate(sw.slot_committees(state, slot)))

        def signature_set(att):
            pos = list(att.aggregation_bits).index(True)
            row = int(members[int(att.data.index)][pos])
            return SignatureSet(bytes(att.signature),
                                [state.validators.pubkey(row)],
                                compute_signing_root(htr(att.data), domain))

        # the attestation of a member the client does not hold, with its
        # neighbour's signature: 400 on the same server
        row, ci, pos, size = bad
        check(ci == 0 and pos == VC_ATTESTERS_PER_COMMITTEE,
              f"the bad attester is at committee {ci}, position {pos}")
        neighbour = next(a for a in atts if int(a.data.index) == 0)
        bad_att = T.Attestation(
            aggregation_bits=[i == pos for i in range(size)],
            data=neighbour.data, signature=neighbour.signature)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=NETWORK_DEADLINE)
        try:
            conn.request("POST", "/eth/v1/beacon/pool/attestations",
                         body=serialize(T.Attestation.ssz_type, bad_att),
                         headers={"Content-Type":
                                  "application/octet-stream"})
            r = conn.getresponse()
            bad_status, bad_body = r.status, r.read()
        finally:
            conn.close()
        check(bad_status == 400 and BAD_SIGNATURE.encode() in bad_body,
              f"the bad attestation got {bad_status}: {bad_body[:120]!r}")
        cpp = CppBackend()
        cpp_verdicts = [cpp.verify_signature_sets([signature_set(a)])
                        for a in atts + [bad_att]]
        gpu_verdicts = [st == 200 for _a, _b, st in att_posts] + [False]
        check(cpp_verdicts == gpu_verdicts,
              f"cpp's verdicts differ from gpu's on A: "
              f"{sum(cpp_verdicts)} valid of {len(cpp_verdicts)}")

        # the aggregations the selection proofs picked
        agg_gets = by.get(("GET", "/eth/v1/validator/aggregate_attestation"),
                          [])
        agg_posts = by.get(("POST", "/eth/v1/validator/aggregate_and_proofs"),
                           [])
        check(len(agg_posts) == len(agg_gets)
              == got["published"]["aggregates"]
              and all(st == 200 for _a, _b, st in agg_posts),
              f"aggregators {len(agg_gets)}, aggregate POSTs "
              f"{[st for _a, _b, st in agg_posts]}")

        # slashing protection: the second block refused, never sent
        check(got["second_block_refused"] is not None and len(posts) == 1,
              "the client's store signed a second block for its slot")

        # the reads, on the same server
        def get(path, accept=None):
            c = http.client.HTTPConnection("127.0.0.1", srv.port,
                                           timeout=NETWORK_DEADLINE)
            try:
                t0 = time.perf_counter()
                c.request("GET", path, headers={"Accept": accept}
                          if accept else {})
                r = c.getresponse()
                body = r.read()
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                c.close()
            check(r.status == 200, f"GET {path}: {r.status}")
            return body, ms

        body, root_get_ms = get("/eth/v1/beacon/states/head/root")
        check(json.loads(body)["data"]["root"] == "0x" + post_root.hex(),
              "the HTTP state root is not A's head state's")
        ids = "&".join(f"id={r}" for r in vc_rows)
        body, _ = get(f"/eth/v1/beacon/states/head/validators?{ids}")
        check([v["validator"]["pubkey"][2:] for v in json.loads(body)["data"]]
              == got["pubkeys"], "the HTTP validators are not the client's "
                                 "keys")
        body, _ = get("/eth/v1/beacon/states/head/finality_checkpoints")
        fin = json.loads(body)["data"]
        check(fin["current_justified"]["root"][2:]
              == bytes(state.current_justified_checkpoint.root).hex(),
              "the HTTP finality checkpoints are not A's head state's")
        body, _ = get("/eth/v1/beacon/headers/head")
        check(json.loads(body)["data"]["root"] == "0x" + root.hex(),
              "the HTTP head header is not the client's block")
        body, _ = get("/eth/v2/beacon/blocks/head", "application/octet-stream")
        check(body == serialize(type(stored).ssz_type, stored),
              "the SSZ head block is not A's stored block")

        # the serving fleet: bench_serving's mix over HTTP
        paths = (f"/eth/v1/validator/duties/proposer/{epoch}",
                 f"/eth/v1/validator/attestation_data?slot={slot}"
                 f"&committee_index=0")
        cache = srv.serving.cache
        hits0, misses0 = cache.hits, cache.misses
        fleet_spans = {s.span_id for s in tracing.snapshot()}
        failures = []

        def fleet_thread():
            c = http.client.HTTPConnection("127.0.0.1", srv.port,
                                           timeout=NETWORK_DEADLINE)
            try:
                for i in range(FLEET_REQUESTS):
                    c.request("GET", paths[i % 2])
                    r = c.getresponse()
                    r.read()
                    if r.status != 200:
                        failures.append(r.status)
            except OSError as e:
                failures.append(repr(e))
            finally:
                c.close()

        threads = [threading.Thread(target=fleet_thread)
                   for _ in range(FLEET_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        fleet_s = time.perf_counter() - t0
        check(not failures, f"the fleet's failures: {failures[:5]}")
        hits, misses = cache.hits - hits0, cache.misses - misses0
        api_ms = [s.duration * 1e3 for s in tracing.snapshot()
                  if s.kind == "api_request"
                  and s.span_id not in fleet_spans]
        n_fleet = FLEET_THREADS * FLEET_REQUESTS
    finally:
        srv.stop()
        for chain, fn in listeners:
            chain.events.remove_listener(fn)

    # the times
    def spans_of(method, path):
        return [(b - a) * 1e3 for a, b, _s in by.get((method, path), [])]

    index_ms = spans_of("GET", "/eth/v1/validator/validator_index")
    duty_ms = {}
    for method, path in (("POST", "/eth/v1/validator/duties/attester/"),
                         ("GET", "/eth/v1/validator/duties/proposer/")):
        for e in (epoch, epoch + 1):
            duty_ms[f"{path.split('/')[-2]} {e - epoch:+d}"] = spans_of(
                method, f"{path}{e}")
    trips = [(p[1] - g[0]) * 1e3 for g, p in zip(att_gets, att_posts)]
    signs_ms = [s * 1e3 for s in got["signs"]]
    produce = spans_of("GET", f"/eth/v2/validator/blocks/{slot}")
    agg_ms = [(b - a) * 1e3 for a, b, _s in agg_gets + agg_posts]
    busy = prof["device_busy_share"]
    rep.update(
        vc_wall_ms=(got["end"] - got["start"]) * 1e3,
        vc_spawn_to_report_ms=prof["wall_ms"],
        vc_keys_s=got["keys_s"], index_ms=index_ms, duty_ms=duty_ms,
        direct_duty_ms=direct_ms, produce_ms=produce,
        production_span_ms=production, sign_ms=signs_ms,
        publish_to_a_head_ms=(t_a - t_post) * 1e3,
        publish_to_b_head_ms=(t_b - t_post) * 1e3,
        block_post_ms=(posts[0][1] - posts[0][0]) * 1e3,
        block_import_span_ms=imports, gossip_verify_span_ms=gossip_checks,
        publish_stages=stages,
        attestation_round_trip_ms=trips, attestation_verify_ms=verify_ms,
        aggregators=len(agg_gets), aggregation_ms=agg_ms,
        state_root_get_ms=root_get_ms, published=got["published"],
        second_block_refused=got["second_block_refused"],
        fleet={"requests": n_fleet, "seconds": fleet_s,
               "requests_per_s": n_fleet / fleet_s, "cache_hits": hits,
               "cache_misses": misses,
               "cache_hit_ratio": hits / max(1, hits + misses),
               "api_request_p95_ms": _pcts(api_ms)[1] if api_ms else None},
        profile=prof, sse_head_ms=(sse_events[-1][0] - t_post) * 1e3,
        sse_streams=len(sse_streams))
    trip50, trip95 = _pcts(trips)
    ver50, ver95 = _pcts(verify_ms)
    card_idle = (f"the card idle {100 * (1 - busy):.1f} % of the client's "
                 f"slot ({prof['device_busy_ms']:.2f} ms busy of "
                 f"{prof['wall_ms']:.1f}, {prof['device_events']} device "
                 f"events)")
    print(f"validator client (f): {len(vc_rows)} keys on cpp in a process "
          f"of its own over HTTP; on_slot({slot}) {rep['vc_wall_ms']:.1f} ms "
          f"(keys {got['keys_s'] * 1e3:.1f} ms); {len(index_ms)} index "
          f"lookups {sum(index_ms):.1f} ms (the first {index_ms[0]:.1f}); "
          f"duties over HTTP (ms) "
          + ", ".join(f"{k} {sum(v):.1f}" for k, v in duty_ms.items())
          + "; the backend's direct calls (ms) "
          + ", ".join(f"{k} {v:.1f}" for k, v in direct_ms.items())
          + f" (+1 advances a copy of the 1M state a call) [{card}]",
          flush=True)
    print(f"validator proposal (f): produced by A in {produce[0]:.1f} ms "
          f"(block_production {production[0] if production else 0:.1f}), "
          f"{len(signs_ms)} signatures in the client {sum(signs_ms):.1f} "
          f"ms; POSTed {rep['block_post_ms']:.1f} ms; publish to A's head "
          f"{rep['publish_to_a_head_ms']:.1f} ms, to B's by gossip "
          f"{rep['publish_to_b_head_ms']:.1f} ms (gossip_verify spans "
          f"{[round(x, 1) for x in gossip_checks]}, block_import spans "
          f"{[round(x, 1) for x in imports]}); the slowest trace "
          f"{stages['total_ms']:.1f} ms: "
          + ", ".join(f"{k} {v['service_ms']:.1f}"
                      for k, v in stages["stages"].items())
          + f"; the SSE head event {rep['sse_head_ms']:.1f} ms after the "
          f"POST (stream {len(sse_streams)}); a second block refused by "
          f"the store ({got['second_block_refused']!r}), never sent "
          f"[{card}]",
          flush=True)
    print(f"validator attestations (f): {n_att} POSTs 200 (round trip "
          f"p50 {trip50:.1f} / p95 {trip95:.1f} ms; A's verify a POST p50 "
          f"{ver50:.1f} / p95 {ver95:.1f} ms), the op pool holds their "
          f"{len(committees)} committees' data; cpp's verdicts equal A's "
          f"gpu ones; the neighbour-signed one 400; {len(agg_gets)} "
          f"aggregators, each aggregate accepted ({sum(agg_ms):.1f} ms); "
          f"{card_idle} [{card}]", flush=True)
    print(f"validator reads (f): the state root GET {root_get_ms:.1f} ms at "
          f"1M, equal to A's head state's and the block's; validators, "
          f"finality, the header, the SSZ block equal; fleet "
          f"{FLEET_THREADS} x {FLEET_REQUESTS}: "
          f"{rep['fleet']['requests_per_s']:.1f} requests/s, cache hit "
          f"ratio {rep['fleet']['cache_hit_ratio']:.4f}, api_request p95 "
          f"{rep['fleet']['api_request_p95_ms']:.3f} ms [{card}]", flush=True)
    return rep


def network_phase(setup: dict, w, card: str) -> dict:
    """Phase 10: the beacon node's network at 1M validators. On phase 7's
    workload ``w`` (its state at ``stf_workload.SLOT``): the signers of a
    second block (the committees of ``w``'s slot, the next slot's
    proposer) and step (f)'s validator client (the proposer two slots on,
    its attesters) get interop pubkeys, written into the state and warmed
    into the gpu backend's cache; phase 8's chain workload on it (the
    anchor, the block) and the second block, built and signed the same
    way one slot later, the anchor written as the epoch's boundary block
    (``stf_workload.anchor_as_boundary``). Chains anchored as in phase 8,
    each with a ``NetworkService`` on 127.0.0.1 (``NETWORK_SECURITY``, a
    two-worker beacon processor, ``batch_gossip_verification``). (a) B dials A, both
    at the anchor; A imports the block and gossips it, B imports it
    through its processor. (b) A imports the second block; C, fresh at
    the anchor, dials A and range-syncs both (``beacon_blocks_by_range``,
    the replay engine: one signature batch for the epoch), then fetches
    the second by root. (c) A gossips ``NETWORK_SINGLES`` single-bit
    attestations and one with its neighbour's signature; B and C verify
    them in processor batches on the card, accept every valid one and
    refuse the bad one alone (the split fallback), with verdicts equal to
    the ``cpp`` backend's on A. (d) A gossips ``swapped_block``: B
    refuses it at gossip (a second proposal of the slot), C, which has
    not seen it, refuses its import; heads and stores unchanged. (e)
    ``discovery_step``: D, found through a bootnode by discv5, range-syncs
    past F's stall, under ``torch.profiler`` (the card's idle share). (f)
    C, F and D stop, B imports the second block, then ``validator_step``:
    a validator client in a process of its own proposes, attests and
    aggregates over the Beacon API on A. Kernel launch counts are 0 once
    the chains are set up; every state-root and BLS kernel must launch on
    the path, every BLS kernel and ``hash64`` in (e), every one but
    ``cap_fold`` (a tree build's) in (f)."""
    import os
    import tempfile

    import torch

    from lighthouse_tpu_torch import kernels
    from lighthouse_tpu_torch import stf_workload as sw
    from lighthouse_tpu_torch.beacon_processor import BeaconProcessor
    from lighthouse_tpu_torch.bls_batch import warm_pubkeys
    from lighthouse_tpu_torch.chain import BeaconChainBuilder
    from lighthouse_tpu_torch.chain.errors import (
        BAD_SIGNATURE, AttestationError, BlockError,
    )
    from lighthouse_tpu_torch.chain.execution import MockExecutionLayer
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import SignatureSet
    from lighthouse_tpu_torch.network import (
        NetworkConfig, NetworkService, Topic,
    )
    from lighthouse_tpu_torch.network.faults import FaultyTransport
    from lighthouse_tpu_torch.network.sync import encode_block
    from lighthouse_tpu_torch.obs import critpath
    from lighthouse_tpu_torch.specs.chain_spec import mainnet_spec
    from lighthouse_tpu_torch.ssz import htr, serialize
    from lighthouse_tpu_torch.state_transition import (
        VerifySignatures, per_block_processing, process_slots,
    )
    from lighthouse_tpu_torch.state_transition.helpers import (
        get_beacon_proposer_index,
    )
    from lighthouse_tpu_torch.store import HotColdDB, NativeKvStore
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    t_phase = time.perf_counter()
    cpp, gpu = setup["cpp"], setup["gpu"]
    security = NETWORK_SECURITY
    check(bls.get_backend() is gpu, "the BLS module's backend is not gpu")
    check(security in ("noise", "plaintext"),
          f"phase 10's security protocol {security!r} is not explicit")
    cores = os.cpu_count() or 8
    spec = mainnet_spec()
    report: dict = {"security": security}
    print(f"network setup: {_mem_line()} at the phase's start [{card}]",
          flush=True)

    # the second block's signers: the committees of w's slot and the next
    # slot's proposer (the gossip singles are among those members); step
    # (f)'s validator client: the proposer two slots on and
    # VC_ATTESTERS_PER_COMMITTEE members of each of that slot's
    # committees, and one more member of committee 0 (the bad attestation)
    s1 = int(w.state.slot)
    check(s1 == sw.SLOT, f"phase 7's state is at slot {s1}, not {sw.SLOT}")
    t0 = time.perf_counter()
    members = np.concatenate(sw.slot_committees(w.state, s1))
    s3 = s1 + 2
    n_vc = VC_ATTESTERS_PER_COMMITTEE * len(sw.slot_committees(w.state, s3))
    vc_members = sw.gossip_members(w.state, s3, n_vc + 1)
    vc_rows = [int(get_beacon_proposer_index(w.state, s3))] + [
        m[0] for m in vc_members[:n_vc]]
    vc_bad = vc_members[n_vc]
    check(len(set(vc_rows)) == len(vc_rows) and vc_bad[0] not in vc_rows,
          "step (f)'s proposer is one of its attesters")
    wanted = np.unique(np.concatenate([members, [get_beacon_proposer_index(
        w.state, s1 + 1), vc_bad[0]], vc_rows]))
    rows = np.setdiff1d(wanted, w.rows)
    pubkeys = sw.signer_pubkeys(rows, cpp, threads=cores)
    sw.write_signers(w.state, rows, pubkeys)
    report["signers_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warmed = warm_pubkeys(gpu, [SignatureSet(
        b"", [bytes(pk) for pk in pubkeys], b"")], processes=cores)
    report["pubkey_warm_s"] = time.perf_counter() - t0

    # the chain workload (phase 8's) and the second block one slot later,
    # the anchor written as its epoch's boundary block (the attestation
    # target the API serves in step (f))
    t0 = time.perf_counter()
    boundary = sw.anchor_as_boundary(w.state)
    cw = sw.build_chain_workload(w, cpp)
    check(htr(cw.anchor.message) == boundary,
          "the anchor is not the epoch's boundary block")
    anchor_root, root1 = htr(cw.anchor.message), htr(cw.block.message)
    check(int(cw.block.message.slot) == s1, "the block is not at w's slot")
    post = cw.state.copy()
    process_slots(post, s1)
    per_block_processing(post, cw.block, VerifySignatures.FALSE)
    check(post.hash_tree_root() == cw.post_root,
          "the block's post-state root is not the chain workload's")
    s2 = s1 + 1
    process_slots(post, s2)
    block2 = sw.build_block(post, cpp)
    per_block_processing(post, block2, VerifySignatures.FALSE)
    post_root2 = post.hash_tree_root()
    block2.message.state_root = post_root2
    sw.sign_proposal(post, block2, cpp)
    root2 = htr(block2.message)
    del post
    report["workload_s"] = time.perf_counter() - t0
    print(f"network setup: {len(rows)} more signer rows (the committees of "
          f"slot {s1}, slot {s2}'s proposer) with interop keys in "
          f"{report['signers_s']:.1f} s, {warmed} pubkeys warmed in "
          f"{report['pubkey_warm_s']:.1f} s; the anchor {anchor_root.hex()} "
          f"at slot {s1 - 1}, the block {root1.hex()} at {s1} and the "
          f"second block {root2.hex()} at {s2} (its "
          f"{len(block2.message.body.attestations)} attestations of slot "
          f"{s1}, full sync aggregate, signed on the "
          f"C++ host backend) in {report['workload_s']:.1f} s [{card}]",
          flush=True)

    def anchored(tmp: str, name: str):
        """A chain anchored on a copy of the workload's anchor state (phase
        8's builder, stores and first head), its clock at the second
        block's slot."""
        db = HotColdDB(NativeKvStore(os.path.join(tmp, name, "hot")),
                       NativeKvStore(os.path.join(tmp, name, "cold")), spec)
        chain = (BeaconChainBuilder(spec)
                 .weak_subjectivity_anchor(cw.state.copy(), cw.anchor)
                 .slot_clock(ManualSlotClock(0, spec.seconds_per_slot,
                                             current_slot=s2))
                 .execution_layer(MockExecutionLayer())
                 .store(db)
                 .build())
        check(chain.recompute_head() == anchor_root,
              f"chain {name}: not anchored")
        return chain

    def service(chain, injector=None, label=None, identity=None):
        """The node's network: a two-worker processor, attestation
        signatures deferred to its batches, the security protocol
        named; with an ``injector``, on a ``FaultyTransport`` registered
        with it under ``label``."""
        factory = None
        if injector is not None:
            def factory(host, port):
                return FaultyTransport(host, port, identity=identity,
                                       security=security, injector=injector,
                                       label=label)
        svc = NetworkService(chain, NetworkConfig(
            security=security, batch_gossip_verification=True),
            processor=BeaconProcessor(num_workers=2),
            transport_factory=factory)
        check(svc.transport.security == security,
              f"the transport chose {svc.transport.security}")
        return svc

    def recorder(chain, got: dict, sizes: list):
        """Each attestation batch the node's processor drains, its size
        and each item's verdict by attestation root."""
        inner = chain.batch_verify_unaggregated_attestations_for_gossip

        def recorded(pairs):
            results = inner(pairs)
            sizes.append(len(pairs))
            for (att, _subnet), r in zip(pairs, results):
                got[htr(att)] = (r.kind if isinstance(r, AttestationError)
                                 else "ok")
            return results

        chain.batch_verify_unaggregated_attestations_for_gossip = recorded

    def applied_votes(chain, into: list):
        """The validators whose votes the node applied to fork choice."""
        inner = chain.apply_attestation_to_fork_choice

        def apply(verified):
            inner(verified)
            into.extend(int(i) for i in verified.indexed.attesting_indices)

        chain.apply_attestation_to_fork_choice = apply

    def imports_of(chain, into: list):
        """Each block import the node runs: (root, error kind or None)."""
        inner = chain.process_block

        def process_block(signed, *args, **kwargs):
            try:
                out = inner(signed, *args, **kwargs)
            except BlockError as e:
                into.append((htr(signed.message), e.kind))
                raise
            into.append((htr(signed.message), None))
            return out

        chain.process_block = process_block

    def dial(src, dst, name: str) -> tuple[object, float]:
        t = time.perf_counter()
        peer = src.dial("127.0.0.1", dst.port)
        ms = (time.perf_counter() - t) * 1e3
        check(peer is not None, f"{name}: the dial failed")
        return peer, ms

    def status_of(svc, peer_id: str):
        info = svc.peers.peers.get(peer_id)
        return None if info is None else info.status

    def stored_equal(chain, ref, roots) -> bool:
        for r in roots:
            a, b = chain.store.get_block(r), ref.store.get_block(r)
            if a is None or b is None or serialize(
                    type(a).ssz_type, a) != serialize(type(b).ssz_type, b):
                return False
        return True

    names = [k.name for k in kernels.STATE_ROOT_KERNELS + kernels.BLS_KERNELS]
    services, steps = [], {}
    wire = _WireBytes()
    with tempfile.TemporaryDirectory() as tmp, wire:
        try:
            # the path starts here: three nodes anchored and listening
            kernels.reset_counts()
            t0 = time.perf_counter()
            chain_a, chain_b, chain_c = (anchored(tmp, n) for n in "abc")
            report["anchor_s"] = time.perf_counter() - t0
            na, nb, nc = (service(c) for c in (chain_a, chain_b, chain_c))
            services += [na, nb, nc]
            for svc in services:
                svc.start()
            a_id = na.transport.node_id
            steps["anchor"] = {n: k.launches
                               for n, k in kernels.KERNELS.items()}

            def step_launches(label: str) -> dict:
                now = {n: k.launches for n, k in kernels.KERNELS.items()}
                before = {n: sum(c[n] for c in steps.values())
                          for n in now}
                steps[label] = {n: now[n] - before[n] for n in now}
                return steps[label]

            # (a) B dials A at the anchor; A imports the block and gossips
            # it; B imports it through its processor
            wire.label = "a"
            peer_ab, dial_ab_ms = dial(nb, na, "B to A")
            _until(lambda: status_of(nb, a_id) is not None,
                   "B's status exchange with A")
            st = status_of(nb, a_id)
            check(st.head_root == anchor_root
                  and st.head_slot == chain_b.head().head_state.slot,
                  f"B sees A at {st.head_root.hex()} slot {st.head_slot}, "
                  f"not at its own anchor")
            _until(lambda: {Topic.BLOCK} <= na.gossip.peer_topics.get(
                nb.transport.node_id, set()), "A learning B's topics")
            imports_b = []
            imports_of(chain_b, imports_b)
            t0 = time.perf_counter()
            check(chain_a.process_block(cw.block) == root1,
                  "A did not import the block")
            a_import_ms = (time.perf_counter() - t0) * 1e3
            spans_before = {s.span_id for s in tracing.snapshot()}
            t0 = time.perf_counter()
            na.publish_block(cw.block)
            _until(lambda: chain_b.head().head_block_root == root1,
                   "B's head on the gossiped block")
            gossip_ms = (time.perf_counter() - t0) * 1e3
            # the head moves inside the import; its record lands on return
            _until(lambda: imports_b, "B's import returning")
            check(imports_b == [(root1, None)],
                  f"B's imports: {imports_b}")
            check(chain_b.head().head_state.hash_tree_root()
                  == chain_a.head().head_state.hash_tree_root()
                  == cw.post_root, "B's post-state root is not A's and "
                                   "the workload's")
            comp = critpath.worst_component(
                [s for s in tracing.snapshot()
                 if s.span_id not in spans_before])
            check(comp is not None, "no block_pipeline trace on B")
            stages = critpath.component_report(comp)
            report.update(dial_ms={"b": dial_ab_ms}, a_import_ms=a_import_ms,
                          gossip_ms=gossip_ms, gossip_stages=stages)
            split = ", ".join(
                f"{k} {stages['stages'][k]['service_ms']:.1f}"
                for k in ("gossip_publish", "block_pipeline", "gossip_verify",
                          "processor_work", "block_import",
                          "batch_signature", "state_transition",
                          "state_root", "fork_choice", "db_write")
                if k in stages["stages"])
            la = step_launches("a")
            print(f"network handshake: B dialed A in {dial_ab_ms:.1f} ms "
                  f"(TCP, multistream, {security}, yamux; A's peer id "
                  f"{a_id[:16]}... authenticated); the status exchange "
                  f"shows no gap [{card}]", flush=True)
            print(f"network gossip (a): A imported the block in "
                  f"{a_import_ms:.1f} ms and published it; B's head on it "
                  f"{gossip_ms:.1f} ms after the publish (gossip check, its "
                  f"processor, the block's batch on gpu), its post-state "
                  f"root A's and the workload's; the critical path "
                  f"{stages['total_ms']:.1f} ms: {split}; launches "
                  f"{ {n: c for n, c in la.items() if c} } [{card}]",
                  flush=True)

            # (b) A imports the second block; C dials A and range-syncs
            wire.label = "b"
            check(chain_a.process_block(block2) == root2,
                  "A did not import the second block")
            check(chain_a.head().head_state.hash_tree_root() == post_root2,
                  "A's post-state root is not the second block's")
            step_launches("a, the second block")
            fetch_s, decode_s = [], []
            ctx = nc.sync.ctx
            fetch, decode = ctx._fetch_range, ctx._decode_block

            def timed_fetch(*args):
                t = time.perf_counter()
                try:
                    return fetch(*args)
                finally:
                    fetch_s.append(time.perf_counter() - t)

            def timed_decode(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return decode(*args, **kwargs)
                finally:
                    decode_s.append(time.perf_counter() - t)

            ctx._fetch_range, ctx._decode_block = timed_fetch, timed_decode
            t0 = time.perf_counter()
            peer_ca, dial_ca_ms = dial(nc, na, "C to A")
            status_s = _until(lambda: status_of(nc, a_id) is not None,
                              "C's status exchange with A")
            st = status_of(nc, a_id)
            check(st.head_root == root2 and st.head_slot == s2,
                  f"C sees A at slot {st.head_slot}, not ahead at {s2}")
            _until(lambda: chain_c.head().head_block_root == root2,
                   "C's head on the second block by range sync")
            sync_ms = (time.perf_counter() - t0) * 1e3
            # the head moves at the epoch's commit; the segment's count
            # lands when the replay returns
            _until(lambda: nc.sync.ctx.imported_total == 2,
                   "range sync's count of imported blocks")
            engine = chain_c.replay_engine().snapshot()
            check(engine["segments_replayed"] == 1
                  and engine["blocks_committed"] == 2
                  and engine["commit_seq"] == 1,
                  f"C's replay engine: {engine['segments_replayed']} "
                  f"segments, {engine['blocks_committed']} blocks, "
                  f"{engine['commit_seq']} epochs committed")
            check(chain_c.head().head_state.hash_tree_root() == post_root2,
                  "C's post-state root is not the second block's")
            check(stored_equal(chain_c, chain_a, (root1, root2)),
                  "C's stored blocks differ from A's in SSZ")
            chunks = nc.rpc.request(peer_ca, "beacon_blocks_by_root",
                                    {"roots": [root2.hex()]})
            check(chunks == [encode_block(chain_a.store.get_block(root2),
                                          chain_a)],
                  "C's beacon_blocks_by_root reply is not A's block bytes")
            lb = step_launches("b")
            check(lb["final_exp"] == 1, f"C's range sync ran "
                                        f"{lb['final_exp']} signature "
                                        f"batches, not one for the epoch")
            busy = engine["busy_seconds"]
            split_b = {"dial": dial_ca_ms, "status": status_s * 1e3,
                       "download": (sum(fetch_s) - sum(decode_s)) * 1e3,
                       "decode": sum(decode_s) * 1e3,
                       **{k: busy[k] * 1e3 for k in busy}}
            report.update(sync_ms=sync_ms, sync_split=split_b,
                          replay=engine)
            report["dial_ms"]["c"] = dial_ca_ms
            print(f"network range sync (b): C dialed A in {dial_ca_ms:.1f} "
                  f"ms, saw A ahead at slot {s2}, downloaded both blocks "
                  f"by beacon_blocks_by_range (yamux, snappy) and replayed "
                  f"them (one signature batch for the epoch on gpu): head "
                  f"on the second block {sync_ms:.1f} ms after the dial, "
                  f"its post-state root A's, both stored blocks A's SSZ; "
                  f"the block by root byte-equal; split (ms): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in split_b.items())
                  + f"; launches { {n: c for n, c in lb.items() if c} } "
                  f"[{card}]", flush=True)

            # (c) GOSSIP_SINGLES single-bit attestations of the block's
            # slot and one with its neighbour's signature, from A
            wire.label = "c"
            head1 = chain_b.head().head_state
            t0 = time.perf_counter()
            singles = sw.gossip_attestations(
                head1, root1, NETWORK_SINGLES + 1, cpp, threads=cores,
                target_root=anchor_root)
            sign_s = time.perf_counter() - t0
            bad, nxt = singles[-1][0], singles[-2][0]
            singles[-1] = (type(bad)(
                aggregation_bits=list(bad.aggregation_bits), data=bad.data,
                signature=nxt.signature), singles[-1][1])
            bad_root = htr(singles[-1][0])
            verdicts = {"b": {}, "c": {}}
            sizes = {"b": [], "c": []}
            votes = {"b": [], "c": []}
            for key, chain in (("b", chain_b), ("c", chain_c)):
                recorder(chain, verdicts[key], sizes[key])
                applied_votes(chain, votes[key])
            topics = {f"beacon_attestation_{s}" for _a, s in singles}
            for svc in (nb, nc):
                _until(lambda svc=svc: topics <= na.gossip.peer_topics.get(
                    svc.transport.node_id, set()),
                    "A learning the attestation subnets")
            score0 = {k: svc.peers.score(a_id)
                      for k, svc in (("b", nb), ("c", nc))}
            n_att = len(singles)
            t0 = time.perf_counter()
            for att, subnet in singles:
                na.publish_attestation(att, subnet)
            publish_ms = (time.perf_counter() - t0) * 1e3
            for key in ("b", "c"):
                _until(lambda key=key: len(verdicts[key]) == n_att,
                       f"node {key.upper()}'s verdicts")
            verdict_ms = (time.perf_counter() - t0) * 1e3
            for svc in (nb, nc):
                check(svc.processor.wait_idle(timeout=NETWORK_DEADLINE),
                      "a processor still busy after the verdicts")
            # the same attestations on cpp, on A (which never received them)
            verify_on_a = (chain_a.
                           batch_verify_unaggregated_attestations_for_gossip)
            bls.set_backend("cpp")
            try:
                want = _verdicts(verify_on_a(singles))
            finally:
                bls.set_backend("gpu")
            check(want == ["ok"] * (n_att - 1) + [BAD_SIGNATURE],
                  f"cpp's verdicts: {sorted(set(want))}")
            signers = [m[0] for m in sw.gossip_members(head1, s1, n_att)]
            for key, chain, svc in (("b", chain_b, nb), ("c", chain_c, nc)):
                got = [verdicts[key][htr(a)] for a, _s in singles]
                check(got == want, f"node {key.upper()}'s verdicts differ "
                                   f"from cpp's: {sorted(set(got))}")
                check(sorted(votes[key]) == sorted(signers[:-1]),
                      f"node {key.upper()} applied {len(votes[key])} votes, "
                      f"not the {n_att - 1} valid attesters'")
                delta = svc.peers.score(a_id) - score0[key]
                check(abs(delta - (n_att * 0.1 - 5.0)) < 1e-6,
                      f"node {key.upper()}'s score of A moved {delta}, not "
                      f"{n_att} accepts and one reject")
                check(not any(p.banned for p in svc.peers.peers.values()),
                      f"node {key.upper()} banned a peer")
            # B has only these votes for the slot's members: the blocks it
            # imported carry the slot before's
            fc_votes = chain_b.fork_choice.votes
            check(all(fc_votes[v].next_root == root1 for v in signers[:-1])
                  and (signers[-1] >= len(fc_votes)
                       or fc_votes[signers[-1]].next_root != root1),
                  "B's fork choice does not hold exactly the valid votes")
            lc = step_launches("c")
            report.update(sign_s=sign_s, publish_ms=publish_ms,
                          verdict_ms=verdict_ms, batch_sizes=sizes)
            print(f"network attestations (c): {n_att} single-bit "
                  f"attestations of slot {s1} ({n_att - 1} signed by their "
                  f"members, the last with its neighbour's signature) "
                  f"signed in {sign_s:.1f} s, published by A on "
                  f"{len(topics)} subnets in {publish_ms:.1f} ms; the last "
                  f"verdict {verdict_ms:.1f} ms after the first publish; B "
                  f"and C each accepted {n_att - 1} into fork choice and "
                  f"refused the bad one alone {BAD_SIGNATURE} (the split "
                  f"fallback), as cpp on A; A's score took the reject, no "
                  f"ban; batches drained: B {sizes['b']}, C {sizes['c']}; "
                  f"launches { {n: c for n, c in lc.items() if c} } "
                  f"[{card}]", flush=True)

            # (d) the swapped block: B has the slot's proposal, C has not
            # seen it
            wire.label = "d"
            bad_block = sw.swapped_block(cw.state, cw.block, cpp)
            bad_block_root = htr(bad_block.message)
            imports_c = []
            imports_of(chain_c, imports_c)
            rejects_b = nb.peers.score(a_id)
            na.publish_block(bad_block)
            _until(lambda: imports_c, "C's import of the swapped block")
            for svc in (nb, nc):
                check(svc.processor.wait_idle(timeout=NETWORK_DEADLINE),
                      "a processor still busy after the swapped block")
            check(imports_c[0][0] == bad_block_root and imports_c[0][1],
                  f"C's import of the swapped block: {imports_c}")
            check(abs(nb.peers.score(a_id) - rejects_b + 5.0) < 1e-6,
                  "B did not reject the second proposal at gossip")
            for name, chain, head in (("B", chain_b, root1),
                                      ("C", chain_c, root2)):
                check(chain.head().head_block_root == head
                      and chain.store.get_block(bad_block_root) is None
                      and not chain.fork_choice.contains_block(
                          bad_block_root),
                      f"{name}: the swapped block moved the head or is "
                      f"stored")
            ld = step_launches("d")
            print(f"network bad block (d): the swapped block (attestation 0 "
                  f"with attestation 1's signature, the proposal signed "
                  f"again) gossiped by A: B refused it at gossip (a second "
                  f"proposal of slot {s1}), C refused its import "
                  f"{imports_c[0][1]}; heads and stores unchanged; launches "
                  f"{ {n: c for n, c in ld.items() if c} } [{card}]",
                  flush=True)

            # (e) joining by discovery: F (holding both blocks) and D, fresh
            # at the anchor, on a fault-injecting transport; D finds A and F
            # through a bootnode and range-syncs past F's stall
            def node(name, injector, label, identity):
                chain = anchored(tmp, name)
                svc = service(chain, injector, label, identity)
                services.append(svc)
                svc.start()
                return chain, svc

            t0 = time.perf_counter()
            report["e"] = discovery_step(chain_a, na, node, wire, card)
            le = step_launches("e")
            report["e"]["ms"] = (time.perf_counter() - t0) * 1e3
            report["e"]["launches"] = {n: c for n, c in le.items() if c}
            for name in ["hash64"] + [k.name for k in kernels.BLS_KERNELS]:
                check(le[name] > 0, f"kernel {name} was not launched in "
                                    f"step (e)")
            print(f"network launches (e) (2 anchorings, F's and D's range "
                  f"syncs): {report['e']['launches']}; the step "
                  f"{report['e']['ms']:.1f} ms [{card}]", flush=True)
            graftwatch.on_slot(10)

            # (f) a validator client over the Beacon API, on A's warm
            # chain: C, F and D stop; B takes the second block (A never
            # gossiped it), so both stand at A's head
            for svc in services[2:]:
                svc.stop()
            del services[2:]
            wire.label = "f"
            check(chain_b.process_block(block2) == root2
                  and chain_b.head().head_block_root == root2,
                  "B did not import the second block")
            step_launches("f, B to the second block")
            t0 = time.perf_counter()
            report["f"] = validator_step(chain_a, na, chain_b, vc_rows,
                                         vc_bad, s3, card)
            lf = step_launches("f")
            report["f"]["ms"] = (time.perf_counter() - t0) * 1e3
            report["f"]["launches"] = {n: c for n, c in lf.items() if c}
            # no tree is built in (f): every state it roots is a copy of
            # one that holds its trees, and an update folds the root's caps
            # inside its walk, so cap_fold (a build's) launches on the
            # phase's path (the anchorings), not here
            for name in [k.name for k in kernels.STATE_ROOT_KERNELS
                         if k.name != "cap_fold"] + [
                             k.name for k in kernels.BLS_KERNELS]:
                check(lf[name] > 0, f"kernel {name} was not launched in "
                                    f"step (f)")
            print(f"network launches (f) (the client's slot, the reads, the "
                  f"fleet): {lf}; the step {report['f']['ms']:.1f} ms "
                  f"[{card}]", flush=True)
            launches = {n: sum(c[n] for c in steps.values()) for n in names}
        finally:
            for svc in services:
                svc.stop()
    torch.cuda.synchronize()
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the network "
                         f"path")
    prof = report["e"]["profile"]
    print(f"network wire: bytes sent on the sockets "
          f"{sum(wire.by_label.values())} in all, by step {wire.by_label} "
          f"[{card}]", flush=True)
    print(f"network launches on the path (5 anchorings, (a)-(f)): "
          f"{launches} [{card}]", flush=True)
    report.update(profile=prof, wire_bytes=wire.by_label, launches=launches,
                  launches_validator_path=lf,
                  launches_by_step={k: {n: c for n, c in v.items() if c}
                                    for k, v in steps.items()})
    report["seconds"] = time.perf_counter() - t_phase
    print(f"network phase: {report['seconds']:.1f} s; {_mem_line()} "
          f"[{card}]", flush=True)
    return report


def _sampled(slot: int, name: str) -> float | None:
    """The graftwatch sampler's value of series ``name`` in the row of
    ``slot`` (a phase: the smoke ticks the sampler once a phase), or
    None."""
    slots, vals = timeseries.get_sampler().series(name)
    hit = np.flatnonzero(slots == slot)
    return None if not hit.size or np.isnan(vals[hit[0]]) else float(
        vals[hit[0]])


def obs_phase(card: str, stf: dict) -> dict:
    """Phase 11: what the observability layer kept of phases 1-10, read and
    checked (nothing heavy runs again): every kernel that launched (the 15
    in mode 0, the mode-1/2 variants phase 6 ran) has a roofline record on
    the card with a device ms and a utilization of the peak in (0, 1.05],
    and no record on the card reads above 1.05; the memory ledger at the
    end of phase 7 (platform ``cuda``, the card's kind and memory, bytes in
    use, the live merkle trees attributed within them); a second
    ``build_all`` of every library (no miss); the catalog metrics of the
    state root, the BLS batch, the block, the chain's imports and
    attestation batches, and the network's gossip, peer and sync metrics
    in the sampler's rows (the network's feed the port's own catalog); a
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
            ("device_hbm_bytes_in_use", 7),
            ("beacon_block_imported_total", 8),
            ("beacon_attestation_processing_seconds.count", 8),
            ("beacon_attestation_processing_seconds.p50", 8),
            ("kzg_blob_verification_seconds.count", 9),
            ("execution_layer_new_payload_seconds.count", 9),
            ("execution_layer_forkchoice_seconds.count", 9),
            ("beacon_block_production_seconds.count", 9),
            ("gossipsub_messages_received_total", 10),
            ("gossipsub_messages_published_total", 10),
            ("gossipsub_validation_accept_total", 10),
            ("gossipsub_validation_reject_total", 10),
            ("libp2p_peers", 10), ("libp2p_peer_connect_total", 10),
            ("sync_range_batches_downloaded_total", 10),
            ("sync_range_blocks_imported_total", 10))
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
    ap.add_argument("--seed", type=int, default=None,
                    help="the seed phase 9's blobs and transactions are "
                         "made from (default: stf_workload.BLOB_SEED)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if args.seed is None:
        from lighthouse_tpu_torch.stf_workload import BLOB_SEED
        args.seed = BLOB_SEED

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
    stf, stf_check, workload = stf_phase(bounds, setup, card_line)
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

    # phase 8: the beacon node's gossip path (fork choice, the op pool, the
    # hot/cold store, the beacon processor, BeaconChain) on phase 7's
    # state, its launches beside each kernel's row
    chain = chain_phase(setup, workload, card_line)
    graftwatch.on_slot(8)
    for row in rows:
        if row["name"] in chain["launches"]:
            row["launches_chain_path"] = chain["launches"][row["name"]]

    # phase 9: the post-merge node (the engine API over JWT, the builder,
    # blob sidecars on KZG, the slasher) on a Deneb block at 1M validators,
    # its launches beside each kernel's row
    postmerge = postmerge_phase(setup, card_line, args.seed)
    graftwatch.on_slot(9)
    for row in rows:
        if row["name"] in postmerge["launches"]:
            row["launches_postmerge_path"] = postmerge["launches"][row["name"]]

    # phase 10: the beacon node's network (libp2p over TCP, gossipsub,
    # req/resp, range sync) between three nodes on phase 7's workload, its
    # launches beside each kernel's row; the phase ticks graftwatch itself,
    # while its nodes are still connected
    network = network_phase(setup, workload, card_line)
    del workload
    for row in rows:
        if row["name"] in network["launches"]:
            row["launches_network_path"] = network["launches"][row["name"]]
        if row["name"] in network["launches_validator_path"]:
            row["launches_validator_path"] = network[
                "launches_validator_path"][row["name"]]

    # phase 11: what the observability layer kept of phases 1-10
    obs = obs_phase(card_line, stf)
    print(f"smoke: {time.perf_counter() - t_start:.1f} s from the start to "
          f"the end of phase 11", flush=True)

    report = {"card": card_line, "sm_clock_max_mhz": sm_clock,
              "build_s": build_s, "build": summary, "kernels": rows,
              "kernel_modes": modes, "bls_field_muls": bls_check.muls,
              "slice": sl, "bls": bls, "multigpu": multigpu, "mxu": mxu,
              "stf": stf, "stf_field_muls": stf_check.muls, "chain": chain,
              "postmerge": postmerge, "network": network, "obs": obs}
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
