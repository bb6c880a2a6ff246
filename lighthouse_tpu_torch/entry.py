"""Entry points of the port (the counterpart of ``__graft_entry__.py``).

- ``entry()``: the single-card state-root step of the flagship compute — a
  1,024-validator registry build (3 pre-levels) and a 256-chunk balances
  update with 16 dirty rows, on the port's ``DeviceTree``.
- ``dryrun_multigpu(n)``: one step of each sharded path over ``n`` ranks
  (one process per card, ``parallel.launch.run_ranks``) at the shapes of
  ``dryrun_multichip``: a sharded state-root step, a sharded pairing
  check, the full ``verify_signature_sets`` sharded over the mesh, and a
  2^17-leaf sharded merkle tree, each held to the single-device result.
- ``multigpu_run(n)``: the sharded paths at full width — the 1M-validator
  Deneb columns' validator and balance trees, and the 10,000-set gossip
  batch verified at 10,240 lanes — with each sharded program held to the
  single-device composition on the same inputs and timed.

    python -m lighthouse_tpu_torch.entry --multigpu N [--modes 0,1,2] \
        [--out REPORT.json]

runs the dryrun and the full-width run on ``N`` cards under each multiply
lowering of ``--modes`` (default: the process's, ``LHTPU_BIGINT_MXU``;
the batch is signed and the pubkey cache warmed once for all of them) and
prints one JSON report, keyed by mode (``by_mode``); it exits nonzero
if any check fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

#: the full-width BLS run's lane count: the 10k batch padded to 128s
FULL_WIDTH_LANES = 10240
#: leaves of the dryrun's large sharded tree
DRYRUN_BIG_LEAVES = 2 ** 17


# -- entry(): the single-card step ---------------------------------------------

def entry(device=None):
    """(state_root_step, args): ``state_root_step(*args)`` builds the
    1,024-validator registry tree from its 8,192 chunk leaves and updates
    16 rows of a built 256-chunk balances tree (on a shared copy, so the
    step can run again), returning the two roots as u32[8] tensors."""
    from .device import resolve
    from .ops.merkle_tree import DeviceTree
    from .ops.sha256 import words_to_tensor

    dev = resolve(device)
    n_validators = 1024                  # 8 chunk-leaves each, folded

    def state_root_step(validator_leaves, balance_tree, dirty_rows,
                        dirty_words):
        v_tree = DeviceTree(n_validators, n_validators, pre_levels=3,
                            device=dev)
        v_tree.build(validator_leaves)
        b_tree = balance_tree.share()
        b_tree.update(dirty_rows, dirty_words)
        return v_tree.root_words, b_tree.root_words

    rng = np.random.default_rng(0)
    validator_leaves = words_to_tensor(_words(rng, n_validators * 8), dev)
    balance_tree = DeviceTree(256, 256, device=dev)
    balance_tree.build(_words(rng, 256))
    dirty_rows = np.arange(16, dtype=np.int32)
    dirty_words = words_to_tensor(np.zeros((16, 8), np.uint32), dev)
    return state_root_step, (validator_leaves, balance_tree, dirty_rows,
                             dirty_words)


def _words(rng, n: int) -> np.ndarray:
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(
        np.uint32)


# -- shared by the rank functions ----------------------------------------------

def _counts() -> dict:
    from . import kernels
    from .parallel import mesh as pm
    return {"programs": {p.name: p.launches for p in pm.PROGRAMS.values()},
            "kernels": {k.name: k.launches for k in kernels.KERNELS.values()}}


def _reset_counts(mesh) -> None:
    from . import kernels
    from .parallel import mesh as pm
    mesh.barrier()
    kernels.reset_counts()
    pm.reset_counts()
    mesh.gathered.clear()


def _time_ms(mesh, fn, repeats: int) -> float:
    """Median CUDA-event ms of ``fn()`` on this rank, every rank starting
    each run together."""
    import torch
    times = []
    for _ in range(repeats):
        mesh.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _wall_ms(mesh, fn, repeats: int) -> tuple[list, float]:
    """Host-clock ms of ``fn()`` (which ends in a readback) on each of
    ``repeats`` runs, every rank starting together; and the median."""
    times = []
    for _ in range(repeats):
        mesh.barrier()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, statistics.median(times)


def _program_check(mesh, prog, run, plain, canonical: bool,
                   mode: str | None = None, repeats: int = 3):
    """Hold a sharded program against its plain version — the
    single-device composition on the same inputs — and time both. Every
    rank runs ``run()`` (it holds a collective); rank 0 alone runs
    ``plain()``, compares and returns the row (other ranks None). The
    bound's work is this rank's share, the program's roofline record of
    that call (``bytes``, ``ops``, and ``link_bytes`` brought in from the
    other cards: its declared cost)."""
    import torch

    from .measure import field_err
    from .obs import roofline
    with roofline.capture() as calls:
        got = run()
    # the program's record: programs are named <module>.<program>, kernels
    # have no dot
    rec = [c for c in calls if "." in c["kernel"]][-1]
    work = {"bytes": rec["bytes"], "ops": rec["ops"],
            "link_bytes": rec.get("link_bytes", 0)}
    ms = _time_ms(mesh, run, repeats)
    row = None
    if mesh.rank == 0:
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        row = {"name": prog.name, "mode": mode, "route": "cuda",
               "source": prog.source, "replaces": prog.replaces,
               "max_abs_err": field_err(got, want, canonical), "ms": ms,
               "plain_ms": plain_ms, "library_ms": None, **work}
    mesh.barrier()
    return row


# -- dryrun_multigpu -----------------------------------------------------------

def _dryrun_lanes(n: int) -> tuple[int, int]:
    """(lanes, sets) of the dryrun's sharded verification: the JAX
    dryrun's ``lanes = n`` and ``min(max(2, n - 2), n)`` sets, except that
    one rank takes 2 lanes (the corruption check needs a second set)."""
    lanes = max(n, 2)
    return lanes, min(max(2, n - 2), lanes)


def _dryrun_sets(n: int):
    """The dryrun's signature sets (a shared message, multi-pubkey sets),
    signed by the port's Python backend, and the batch with set 1's
    message changed."""
    from .crypto.bls import PythonBackend, SignatureSet
    py = PythonBackend()
    shared_msg = b"\x77" * 32
    sets = []
    for i in range(_dryrun_lanes(n)[1]):
        msg = shared_msg if i < 2 else bytes([i]) * 32
        sks = [100 + i] if i % 2 else [100 + i, 200 + i]
        pks = [py.sk_to_pk(sk) for sk in sks]
        agg = py.aggregate_signatures([py.sign(sk, msg) for sk in sks])
        sets.append(SignatureSet(agg, pks, msg))
    bad = list(sets)
    bad[1] = SignatureSet(bad[1].signature, bad[1].pubkeys, b"\xEE" * 32)
    return py, sets, bad


def _dryrun_pairs(n: int):
    """2n pairs e(sP, Q) * e(-P, sQ), couples straddling shard boundaries
    (so the gather of the partial products is load-bearing), as
    Montgomery limb arrays (px, py, qx, qy)."""
    from .crypto.bls12_381 import G1_GENERATOR
    from .crypto.bls12_381.curve import G2_GENERATOR
    from .ops import bls12_381 as k
    pairs = []
    for i in range(n):
        s = 2 * i + 3
        pairs.append((G1_GENERATOR.mul(s), G2_GENERATOR))
        pairs.append((G1_GENERATOR.neg(), G2_GENERATOR.mul(s)))
    pairs = pairs[::2] + pairs[1::2]
    return (k.fp_encode([int(p.to_affine()[0]) for p, _ in pairs]),
            k.fp_encode([int(p.to_affine()[1]) for p, _ in pairs]),
            k.fp2_encode([q.to_affine()[0] for _, q in pairs]),
            k.fp2_encode([q.to_affine()[1] for _, q in pairs]))


def _dryrun_rank(mesh, tasks, pairs):
    """Rank function of the dryrun: the tasks (launch counts from them),
    then the sharded Miller product held to its plain version on the
    pairing check's pairs."""
    import torch

    from .ops import bls12_381 as k
    from .parallel import bls as pb
    from .parallel.launch import run_tasks
    from .parallel.mesh import shard_batch

    _reset_counts(mesh)
    results = run_tasks(mesh, tasks)
    counts, gathered = _counts(), dict(mesh.gathered)

    local = [shard_batch(mesh, a) for a in pairs]
    full = ([torch.from_numpy(a.copy()).to(mesh.device) for a in pairs]
            if mesh.rank == 0 else None)
    row = _program_check(
        mesh, pb.MILLER_PRODUCT,
        lambda: k.fp12_product(pb._local_miller_product(mesh, *local)),
        lambda: k.fp12_product(k.miller_loop_batch(*full)), True)
    return {"results": results, "launches": counts, "gathered": gathered,
            "programs": [row]}


def dryrun_multigpu(n_devices: int) -> dict:
    """One step of each sharded path over ``n_devices`` cards (one NCCL
    rank each), each held to the single-device result; raises on any
    disagreement and when fewer than ``n_devices`` cards are present.
    Returns the report: the results, each rank-0 launch count, the
    gathered bytes, the sharded Miller product's row."""
    import torch

    from . import kernels
    from .ops import bls12_381 as k
    from .ops.sha256 import merkleize_words, root_bytes
    from .parallel.launch import run_ranks

    n = int(n_devices)
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multigpu({n}) needs {n} cards, found "
                           f"{torch.cuda.device_count()}")
    kernels.build_all()           # the ranks only bind the libraries
    dev = torch.device("cuda")

    rng = np.random.default_rng(1)
    v, b = _words(rng, n * 16), _words(rng, n * 8)
    pairs = _dryrun_pairs(n)
    py, sets, bad = _dryrun_sets(n)
    lanes = _dryrun_lanes(n)[0]
    big = _words(rng, DRYRUN_BIG_LEAVES)
    tasks = [("state_root", (v, b)), ("pairing", pairs),
             ("verify", (sets, lanes)), ("verify", (bad, lanes)),
             ("merkleize", big)]
    t0 = time.perf_counter()
    rep = run_ranks(_dryrun_rank, n, "nccl", "cuda", args=(tasks, pairs))
    rep["seconds"] = time.perf_counter() - t0
    (v_root, b_root), ok_pair, ok_mesh, bad_mesh, big_root = rep["results"]

    def single_root(words):
        return root_bytes(merkleize_words(words, len(words), dev))

    checks = {}

    def check(name, cond, msg):
        checks[name] = bool(cond)
        if not cond:
            raise RuntimeError(f"dryrun_multigpu({n}): {msg}")

    check("state_root", (v_root, b_root) == (single_root(v), single_root(b)),
          "sharded state-root step != single-device roots")
    ok_single = k.pairing_check_batch(
        *(torch.from_numpy(a.copy()).to(dev) for a in pairs))
    check("pairing", ok_single and ok_pair == ok_single,
          f"sharded pairing {ok_pair}, single-device {ok_single}")
    check("verify", ok_mesh is True,
          "sharded verify_signature_sets rejected valid sets")
    check("verify_oracle",
          all(py.verify_signature_sets([s]) for s in sets),
          "the Python oracle rejected a set the mesh accepted")
    check("verify_corrupted", bad_mesh is False,
          "sharded verify accepted a corrupted set")
    check("merkle_2^17", big_root == single_root(big),
          "2^17-leaf sharded merkle root != single-device root")
    check("miller_product_equal_plain",
          all(r["max_abs_err"] == 0 for r in rep["programs"]),
          "the sharded Miller product != the single-device product")
    rep["results"] = {"state_root": [v_root.hex(), b_root.hex()],
                      "pairing": ok_pair, "verify": ok_mesh,
                      "verify_corrupted": bad_mesh,
                      "merkle_2^17": big_root.hex()}
    rep.update(n=n, lanes=lanes, sets=len(sets), checks=checks)
    return rep


# -- the full-width run ----------------------------------------------------------

def _state_leaves():
    """(validator_leaves, balance_leaves) of the seeded 1M-validator
    Deneb columns as u32 words: the 8-chunk validator leaves zero-padded
    to 2^20 validators (2^23 leaves), and the balances, four u64 a chunk
    (250,000 chunks), zero-padded to 2^18. The dense roots of these padded
    leaves are not the registry's root: SSZ zeroes whole validator roots
    past the live count."""
    from .containers.state import ValidatorRegistry
    from .seeded_state import N_VALIDATORS, STATE_SEED, seeded_columns

    cols = seeded_columns(N_VALIDATORS, STATE_SEED)
    reg = ValidatorRegistry()
    for name in reg.COLUMNS:
        setattr(reg, name, cols[name])
    chunks, _ = reg.validator_leaf_words()
    v = np.zeros((1 << 23, 8), dtype=np.uint32)
    v[:len(chunks)] = chunks
    bal = np.frombuffer(cols["balances"].astype("<u8").tobytes(),
                        dtype=">u4").reshape(-1, 8)
    b = np.zeros((1 << 18, 8), dtype=np.uint32)
    b[:len(bal)] = bal
    return v, b


def _full_width_rank(mesh, sets, bad, pk_affine, lanes):
    """Rank function of the full-width run. Every rank regenerates the
    columns and packs the leaves itself; rank 0 also computes the
    single-device references. Returns rank 0's report."""
    import torch

    from .crypto import bls as bls_mod
    from .crypto.bls import gpu_backend as gb
    from .crypto.bls12_381 import G1Point
    from .ops import bigint as bi
    from .ops import bls12_381 as k
    from .ops.sha256 import (
        hash_pairs, merkleize_dense, merkleize_words, root_bytes,
    )
    from .parallel import bls as pb
    from .parallel import merkle as pmk
    from .parallel.mesh import shard_batch

    rep = {"n": mesh.size, "lanes": lanes}
    backend = bls_mod.get_backend()
    for pk, (x, y) in pk_affine.items():
        backend._pk_cache[pk] = G1Point(x, y)
    t0 = time.perf_counter()
    v_full, b_full = _state_leaves()
    rep["leaf_setup_s"] = time.perf_counter() - t0

    # ---- the main path: one sharded state-root step, one sharded verify
    _reset_counts(mesh)
    t0 = time.perf_counter()
    roots = tuple(root_bytes(r) for r in pmk.sharded_state_root_step(
        mesh, shard_batch(mesh, v_full), shard_batch(mesh, b_full)))
    rep["root_first_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rep["verify"] = pb.sharded_verify_signature_sets(mesh, sets, lanes)
    rep["verify_first_ms"] = (time.perf_counter() - t0) * 1e3
    rep["launches"] = _counts()
    rep["gathered"] = dict(mesh.gathered)
    rep["roots"] = [r.hex() for r in roots]

    # ---- times: the state root (copy included, and the step on shards
    # already on the card), the warm verify, the corrupted batch
    def root_from_host():
        return [root_bytes(r) for r in pmk.sharded_state_root_step(
            mesh, shard_batch(mesh, v_full), shard_batch(mesh, b_full))]

    root_from_host()
    rep["root_ms_all"], rep["root_ms"] = _wall_ms(mesh, root_from_host, 3)
    v_loc, b_loc = shard_batch(mesh, v_full), shard_batch(mesh, b_full)
    rep["root_step_ms"] = _time_ms(
        mesh, lambda: pmk.sharded_state_root_step(mesh, v_loc, b_loc), 3)
    # the validators' subtree program in its parts, each on its own: the
    # rank's subtree, the gather of the subtree roots, the top tree
    depth, top_depth = pmk._depths(len(v_full), mesh.size)
    sub_root = merkleize_dense(v_loc, depth)
    every_root = mesh.all_gather(sub_root, "merkle.timing")

    def top_tree():
        nodes = every_root
        for _ in range(top_depth):
            nodes = hash_pairs(nodes)

    rep["subtree_parts_ms"] = {
        "local_subtree": _time_ms(
            mesh, lambda: merkleize_dense(v_loc, depth), 3),
        "all_gather": _time_ms(
            mesh, lambda: mesh.all_gather(sub_root, "merkle.timing"), 3),
        "top_tree": _time_ms(mesh, top_tree, 3)}
    rep["verify_ms_all"], rep["verify_ms"] = _wall_ms(
        mesh, lambda: pb.sharded_verify_signature_sets(mesh, sets, lanes),
        3)
    rep["verify_bad"] = pb.sharded_verify_signature_sets(mesh, bad, lanes)
    mesh.barrier()
    t0 = time.perf_counter()
    prep = pb.replicated_prep(mesh, sets, lanes)
    rep["prep_ms"] = (time.perf_counter() - t0) * 1e3

    # ---- single-device references (rank 0; the others wait)
    if mesh.rank == 0:
        dev = mesh.device
        rep["single_roots"] = [
            root_bytes(merkleize_words(w, len(w), dev)).hex()
            for w in (v_full, b_full)]
        verify = bls_mod.verify_signature_sets
        rep["single_verify"] = verify(sets)
        rep["single_verify_bad"] = verify(bad)
        t0 = time.perf_counter()
        verify(sets)
        rep["single_verify_ms"] = (time.perf_counter() - t0) * 1e3
    mesh.barrier()

    # ---- each sharded program against the single-device composition
    rows = []
    for label, full, loc in (("validators", v_full, v_loc),
                             ("balances", b_full, b_loc)):
        depth = (len(full) - 1).bit_length()
        full_t = (torch.from_numpy(full.view(np.int32).copy()).to(mesh.device)
                  if mesh.rank == 0 else None)
        rows.append(_program_check(
            mesh, pmk.SUBTREE_THEN_TOP,
            lambda loc=loc: pmk.sharded_merkleize(mesh, loc),
            lambda full_t=full_t, depth=depth: merkleize_dense(full_t,
                                                               depth),
            False, mode=None if label == "validators" else label))
        del full_t

    keep = {}
    pairs = pb.miller_pairs(mesh, prep, keep)
    sig_x, sig_y = keep["sig_x"], keep["sig_y"]
    g1_in, g2_in = keep["g1_in"], keep["g2_in"]
    if mesh.rank == 0:
        # every lane's pubkey, as one GPU has them (one launch)
        _, pk_x, pk_y = gb.split_lane_ints(bi.mont_from_int_limbs(
            pb._put(mesh, prep["lane_ints"])), lanes)
        one1 = pb._put(mesh, np.broadcast_to(k.FP_ONE, (lanes, bi.NLIMBS)))
        one2 = pb._put(mesh, np.broadcast_to(k.FP2_ONE,
                                             (lanes, 2, bi.NLIMBS)))
        bits_pk = pb._put(mesh, k.scalars_to_bits(prep["pk_rands"], 64))
        bits_sig = pb._put(mesh, k.scalars_to_bits(prep["sig_rands"], 64))
        # the aggregate of the signatures scaled on one GPU: the sharded
        # path's must be the same limbs (the tree's order is fixed by n)
        single_agg = k.g2_sum(*k.g2_scalar_mul(sig_x, sig_y, one2, bits_sig))
        rep["aggregate_equal_single"] = all(
            torch.equal(a, b) for a, b in zip(keep["aggregate"], single_agg))
    for degree, inputs, label in ((1, g1_in, "bls.scaled_pubkeys"),
                                  (2, g2_in, "bls.scaled_signatures")):
        if degree == 1:
            plain = (lambda: k.g1_scalar_mul(pk_x, pk_y, one1, bits_pk)) \
                if mesh.rank == 0 else None
        else:
            plain = (lambda: k.g2_scalar_mul(sig_x, sig_y, one2, bits_sig)) \
                if mesh.rank == 0 else None
        rows.append(_program_check(
            mesh, pb.SCALAR_MUL,
            lambda degree=degree, inputs=inputs, label=label:
                pb.sharded_scalar_mul(mesh, degree, *inputs, label),
            plain, True, mode=None if degree == 1 else "G2"))

    local = [mesh.local(t) for t in pairs]
    rows.append(_program_check(
        mesh, pb.MASKED_PRODUCT,
        lambda: k.fp12_product(pb._local_masked_product(mesh, *local)),
        lambda: k.fp12_product(k.miller_loop_batch(*pairs)), True))
    rep["programs"] = rows

    # ---- rank 0's kernels on this path against their plain versions
    partials = pb._local_masked_product(mesh, *local)
    if mesh.rank == 0:
        rep["kernel_checks"] = _path_kernel_checks(prep, keep, local,
                                                   partials, v_loc)
    mesh.barrier()
    rep["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return rep


def _kernel_check(name: str, mode: str, kernel_fn, plain_fn,
                  canonical: bool = True):
    """One kernel against its plain version on the same inputs (canonical
    field values, or raw words when not ``canonical``): its record (the
    error, the kernel's median CUDA-event ms of 2, the plain version's
    one run, the bytes and integer ops of its bound: the roofline record
    of the kernel's call, its declared cost) and its output."""
    import torch

    from .measure import field_err, time_cuda
    from .obs import roofline
    with roofline.capture() as calls:
        got = kernel_fn()
    torch.cuda.synchronize()
    work = [c for c in calls if c["kernel"] == name][-1]
    t0 = time.perf_counter()
    want = plain_fn()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rec = {"name": name, "mode": mode,
           "max_abs_err": field_err(got, want, canonical),
           "ms": time_cuda(kernel_fn, 2), "plain_ms": plain_ms,
           "bytes": work["bytes"], "ops": work["ops"]}
    return rec, got


def _path_kernel_checks(prep, keep, local, partials, v_loc) -> list[dict]:
    """Rank 0's kernel launches on the full-width path, each against its
    plain version on the inputs and at the shapes the path gave it
    (``keep``: the stages of ``miller_pairs``; ``local``: the rank's block
    of the padded pair batch; ``partials``: the gathered Miller products):
    the first ``hash64`` level of the rank's validator block; hash-to-G2,
    the message affine, the pubkey segment sums and their affine at the
    full lane count; the Montgomery entry of every signature's x and the
    rank's pubkeys (one launch), both RLC scalar multiplies on the rank's
    lanes; the aggregate's affine; the masked
    Miller loop on the rank's pairs, their product, the product of the
    partials and the final exponentiation. Raises nothing: the caller
    holds each record's ``max_abs_err`` to 0."""
    from .ops import bigint as bi
    from .ops import bls12_381 as k
    from .ops import bls_cost as cost
    from .ops import sha256 as sh

    lanes = len(prep["flags"])
    recs = []

    def run(name, mode, kernel_fn, plain_fn, canonical=True):
        rec, got = _kernel_check(name, mode, kernel_fn, plain_fn, canonical)
        recs.append(rec)
        return got

    blocks = v_loc.reshape(-1, 16)
    run("hash64", f"sharded level 0, {blocks.shape[0]} blocks",
        lambda: sh.hash64(blocks), lambda: sh._hash64_plain(blocks),
        canonical=False)
    del blocks

    u0, u1 = keep["u0"], keep["u1"]
    run("hash_to_g2", f"sharded, {lanes} messages",
        lambda: k.hash_to_g2_batch_from_u(u0, u1),
        lambda: k._hash_to_g2_plain(u0, u1))
    mx, my, mz = keep["msg"]
    run("affine", f"sharded, Fp2 {lanes} messages",
        lambda: k.jacobian_to_affine_fp2(mx, my, mz),
        lambda: k._jacobian_to_affine_fp2_plain(mx, my, mz))

    pk_x, pk_y, one1, bits_pk = keep["g1_in"]
    ints = keep["lane_ints"]
    run("fp_ops", f"sharded, Montgomery entry of {lanes} signature and "
                  f"{pk_x.shape[0]} pubkey lanes",
        lambda: bi.fp_ops_kernel(bi.FP_TO_MONT, ints),
        lambda: bi._mont_from_int_plain(ints))
    run("rlc_scale", f"sharded, G1 {pk_x.shape[0]} lanes",
        lambda: k.g1_scalar_mul(pk_x, pk_y, one1, bits_pk),
        lambda: k._g1_scalar_mul_plain(pk_x, pk_y, one1, bits_pk))
    sx, sy, one2, bits_sig = keep["g2_in"]
    run("rlc_scale", f"sharded, G2 {sx.shape[0]} lanes",
        lambda: k.g2_scalar_mul(sx, sy, one2, bits_sig),
        lambda: k._g2_scalar_mul_plain(sx, sy, one2, bits_sig))

    spx, spy, spz = keep["scaled_pubkeys"]
    starts, ends = keep["starts"], keep["ends"]
    run("g1_segment_sum", f"sharded, {lanes} segments",
        lambda: k.g1_segment_sum(spx, spy, spz, prep["starts"],
                                 prep["ends"]),
        lambda: k._g1_segment_sum_plain(spx, spy, spz, starts, ends))
    gpx, gpy, gpz = keep["pubkey_sums"]
    run("affine", f"sharded, Fp {lanes} pubkey sums",
        lambda: k.jacobian_to_affine_fp(gpx, gpy, gpz),
        lambda: k._jacobian_to_affine_fp_plain(gpx, gpy, gpz))
    ax, ay, az = keep["aggregate"]
    run("affine", "sharded, Fp2 aggregate",
        lambda: k.jacobian_to_affine_fp2(ax, ay, az),
        lambda: k._jacobian_to_affine_fp2_plain(ax, ay, az))

    px, py, qx, qy, mask = local
    host_mask = mask.cpu().numpy()
    ran = cost.miller_loop_pairs(px.shape[0], int(host_mask.sum()))
    fs = run("miller_loop", f"sharded, masked, {px.shape[0]} pairs, "
                            f"{int(host_mask.sum())} live, "
                            f"{cost.miller_loop_design(ran)}",
             lambda: k.miller_loop_batch(px, py, qx, qy, mask),
             lambda: k._mask_to_one(k._miller_loop_plain(px, py, qx, qy),
                                    mask))
    run("final_exp", f"sharded, product of {fs.shape[0]} pairs",
        lambda: k.fp12_product(fs), lambda: k._fp12_product_plain(fs))
    prod = run("final_exp", f"sharded, product of {partials.shape[0]} "
                            f"partials",
               lambda: k.fp12_product(partials),
               lambda: k._fp12_product_plain(partials))
    run("final_exp", "sharded, final exponentiation",
        lambda: k.final_exponentiation(prod),
        lambda: k._final_exponentiation_plain(prod))
    return recs


def _pubkey_affine(backend) -> dict:
    """A backend's decompressed pubkey cache as affine integers (what
    crosses to the ranks: no rank decompresses a pubkey again)."""
    out = {}
    for pk, pt in backend._pk_cache.items():
        x, y = pt.to_affine()
        out[pk] = (int(x), int(y))
    return out


def multigpu_run(n_devices: int, sets=None, gpu=None) -> dict:
    """The full-width sharded run over ``n_devices`` ranks. ``sets``: the
    10,000-set batch (built and signed here when None); ``gpu``: a
    backend whose pubkey cache is warm (warmed here when None). Returns
    rank 0's report with the checks it passed; raises on a failed one."""
    import torch

    from . import kernels
    from .bls_batch import build_sets
    from .crypto.bls import SignatureSet
    from .parallel.launch import run_ranks

    n = int(n_devices)
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"multigpu_run({n}) needs {n} cards, found "
                           f"{torch.cuda.device_count()}")
    kernels.build_all()
    setup = {}
    if sets is None:
        from .crypto.bls.cpp_backend import CppBackend
        t0 = time.perf_counter()
        sets = build_sets(CppBackend())
        setup["sign_s"] = time.perf_counter() - t0
    if gpu is None:
        from .crypto.bls.gpu_backend import GpuBackend
        gpu = GpuBackend()
        t0 = time.perf_counter()
        gpu.warm([pk for s in sets for pk in s.pubkeys])
        setup["pubkey_warm_s"] = time.perf_counter() - t0
    bad = list(sets)
    bad[1] = SignatureSet(bad[1].signature, bad[1].pubkeys, b"\xEE" * 32)
    t0 = time.perf_counter()
    rep = run_ranks(_full_width_rank, n, "nccl", "cuda",
                    args=(sets, bad, _pubkey_affine(gpu), FULL_WIDTH_LANES))
    rep["seconds"] = time.perf_counter() - t0
    rep["setup"] = setup
    checks = {
        "roots_equal_single": rep["roots"] == rep["single_roots"],
        "verify_true": rep["verify"] is True,
        "verify_equal_single": rep["verify"] == rep["single_verify"],
        "corrupted_false": rep["verify_bad"] is False,
        "corrupted_equal_single": (rep["verify_bad"]
                                   == rep["single_verify_bad"]),
        "programs_equal_plain": all(r["max_abs_err"] == 0
                                    for r in rep["programs"]),
        "aggregate_equal_single": rep["aggregate_equal_single"],
        "kernels_equal_plain": all(r["max_abs_err"] == 0
                                   for r in rep["kernel_checks"]),
    }
    rep["checks"] = checks
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"multigpu_run({n}): checks failed: {failed}")
    return rep


# -- the command line ----------------------------------------------------------

def program_rows(dryrun: dict, full: dict, bounds) -> tuple[list, dict]:
    """The ``kernels`` rows of the sharded programs (the first check of
    each) and the further modes, with the bound in ms. ``launches``: a
    rank's runs of the program on the path its row was measured on (the
    dryrun or the full-width main path, each counted from 0);
    ``launches_by_path`` has both counts."""
    paths = {"dryrun": dryrun, "full_width": full}
    rows, modes = [], {}
    for path, rep in paths.items():
        for r in rep["programs"]:
            bound_ms, bound_by = bounds(r["bytes"], r["ops"],
                                        r["link_bytes"])
            rec = {"ms": r["ms"], "plain_ms": r["plain_ms"],
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "max_abs_err": r["max_abs_err"]}
            if r["mode"] is not None:
                modes.setdefault(r["name"], []).append({"mode": r["mode"],
                                                        **rec})
                row = next(x for x in rows if x["name"] == r["name"])
                row["max_abs_err"] = max(row["max_abs_err"],
                                         r["max_abs_err"])
                continue
            rows.append({
                "name": r["name"], "route": r["route"],
                "source": r["source"], "replaces": r["replaces"],
                "launches": rep["launches"]["programs"][r["name"]],
                "launches_by_path": {
                    p: x["launches"]["programs"].get(r["name"], 0)
                    for p, x in paths.items()},
                **rec, "library_ms": None})
    return rows, modes


def kernel_modes(full: dict, bounds) -> dict:
    """The full-width path's kernel checks (``_path_kernel_checks``) as
    further modes of the kernels' rows: kernel name -> records with the
    bound in ms."""
    modes = {}
    for r in full["kernel_checks"]:
        bound_ms, bound_by = bounds(r["bytes"], r["ops"])
        modes.setdefault(r["name"], []).append({
            "mode": r["mode"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": r["max_abs_err"]})
    return modes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multigpu", type=int, required=True, metavar="N",
                    help="run the dryrun and the full-width run on N cards")
    ap.add_argument("--modes", help="comma-separated multiply lowerings "
                                    "(0, 1, 2) to run in turn")
    ap.add_argument("--out", help="also write the report as JSON here")
    args = ap.parse_args(argv)

    import torch

    from . import kernels
    from .measure import Bounds, nvidia_smi
    from .ops import bigint as bi
    if not torch.cuda.is_available():
        print("entry: torch.cuda.is_available() is false; the multi-card "
              "run needs NVIDIA cards", file=sys.stderr)
        return 2
    card = nvidia_smi("name,power.limit")
    bounds = Bounds(float(nvidia_smi("clocks.max.sm").split()[0]))
    mxus = ([int(m) for m in args.modes.split(",")] if args.modes
            else [bi.mxu_mode()])
    sets = gpu = None
    if len(mxus) > 1:
        from .bls_batch import build_sets
        from .crypto.bls.cpp_backend import CppBackend
        from .crypto.bls.gpu_backend import GpuBackend
        sets = build_sets(CppBackend())
        gpu = GpuBackend()
        gpu.warm([pk for s in sets for pk in s.pubkeys])
    by_mode = {}
    prev = bi.mxu_mode()
    try:
        for m in mxus:
            kernels.build_all(kernels.variants(m) if m else None)
            bi.set_mxu_mode(m)
            dry = dryrun_multigpu(args.multigpu)
            full = multigpu_run(args.multigpu, sets, gpu)
            rows, modes = program_rows(dry, full, bounds)
            modes.update(kernel_modes(full, bounds))
            by_mode[m] = {"dryrun": dry, "full_width": full, "kernels": rows,
                          "kernel_modes": modes}
    finally:
        bi.set_mxu_mode(prev)
    report = {"card": card, "n": args.multigpu, "by_mode": by_mode}
    text = json.dumps(report, indent=1, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
