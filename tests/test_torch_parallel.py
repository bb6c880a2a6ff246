"""The port's sharded paths (``lighthouse_tpu_torch/parallel/``) on the CPU:
spawned ranks in a gloo group (``run_ranks``, one spawn per group of
checks, the plain versions in every rank), held to the JAX package's
sharded programs on the conftest's virtual CPU devices and to the JAX
package's BLS oracles. Roots are byte-equal and verdicts exact booleans.
Also ``entry()``, the port's single-card step, against the JAX package's
``__graft_entry__.entry``."""
import numpy as np
import pytest
import torch

import jax

from lighthouse_tpu.crypto.bls import PythonBackend as JaxPythonBackend
from lighthouse_tpu.crypto.bls import SignatureSet as JaxSignatureSet
from lighthouse_tpu.crypto.bls12_381 import G1_GENERATOR, G2_GENERATOR
from lighthouse_tpu.crypto.bls12_381.fields import Fp12
from lighthouse_tpu.crypto.bls12_381.pairing import multi_pairing
from lighthouse_tpu.ops import sha256 as jsh
from lighthouse_tpu.parallel import (
    batch_mesh, shard_batch, sharded_merkleize, sharded_state_root_step,
)
from lighthouse_tpu_torch import convert, entry
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.ops import bls12_381 as k
from lighthouse_tpu_torch.ops.sha256 import root_bytes
from lighthouse_tpu_torch.parallel import launch, mesh as pmesh
from lighthouse_tpu_torch.testing import ranks

SIGNER = JaxPythonBackend()


@pytest.fixture(autouse=True)
def cpu_device():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _words(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(
        np.uint32)


def test_sharded_roots_equal_the_jax_mesh_at_4_ranks():
    """``sharded_merkleize`` on 256 leaves and ``sharded_state_root_step``
    at 512/64 leaves (tests/test_parallel.py's shapes) over 4 gloo ranks:
    byte-equal to the JAX package's programs on a 4-device mesh."""
    rng = np.random.default_rng(3)
    leaves, v, b = _words(rng, 256), _words(rng, 512), _words(rng, 64)
    got = launch.run_ranks(launch.run_tasks, 4, "gloo", "cpu",
                           args=([("merkleize", leaves),
                                  ("state_root", (v, b))],))
    mesh = batch_mesh(4)
    want_root = sharded_merkleize(mesh, shard_batch(mesh,
                                                    jsh.jnp_asarray(leaves)))
    want_v, want_b = sharded_state_root_step(
        mesh, shard_batch(mesh, jsh.jnp_asarray(v)),
        shard_batch(mesh, jsh.jnp_asarray(b)))
    assert got[0] == jsh.words_to_chunks(np.asarray(want_root))
    assert got[1] == (jsh.words_to_chunks(np.asarray(want_v)),
                      jsh.words_to_chunks(np.asarray(want_b)))


def _pair_arrays(pairs):
    return (k.fp_encode([int(p.to_affine()[0]) for p, _ in pairs]),
            k.fp_encode([int(p.to_affine()[1]) for p, _ in pairs]),
            k.fp2_encode([q.to_affine()[0] for _, q in pairs]),
            k.fp2_encode([q.to_affine()[1] for _, q in pairs]))


def test_sharded_pairing_check_matches_the_jax_oracle():
    """The dryrun's couples e(sP, Q) * e(-P, sQ), ordered so that each
    couple straddles the shard boundary, 4 pairs over 2 ranks: True, and
    False with one couple broken; each the verdict of the JAX oracle's
    pairing product."""
    pairs = []
    for s in (3, 5):
        pairs.append((G1_GENERATOR.mul(s), G2_GENERATOR))
        pairs.append((G1_GENERATOR.neg(), G2_GENERATOR.mul(s)))
    pairs = pairs[::2] + pairs[1::2]
    broken = list(pairs)
    broken[2] = (G1_GENERATOR.neg(), G2_GENERATOR.mul(4))
    got = launch.run_ranks(launch.run_tasks, 2, "gloo", "cpu",
                           args=([("pairing", _pair_arrays(pairs)),
                                  ("pairing", _pair_arrays(broken))],))
    want = [multi_pairing(p) == Fp12.one() for p in (pairs, broken)]
    assert want == [True, False]
    assert got == want


def _dryrun_sets():
    """Four sets in the dryrun's style (multi-pubkey sets, one message
    shared): sets 0 and 3 share the message, so message grouping puts
    set 3's pubkey lane on rank 0 of 2 while its signature lane is on
    rank 1, where per-rank scalar draws would disagree."""
    msgs = [b"\x77" * 32, bytes([1]) * 32, bytes([2]) * 32, b"\x77" * 32]
    sets = []
    for i, msg in enumerate(msgs):
        sks = [100 + i] if i % 2 else [100 + i, 200 + i]
        pks = [SIGNER.sk_to_pk(sk) for sk in sks]
        agg = SIGNER.aggregate_signatures([SIGNER.sign(sk, msg)
                                           for sk in sks])
        sets.append(JaxSignatureSet(agg, pks, msg))
    return sets


def test_sharded_verify_matches_python_backend_and_draws_once():
    """``sharded_verify_signature_sets`` at 4 lanes over 2 ranks, in one
    spawn: the valid batch, set 1's message changed and a malformed
    signature each give the JAX package's PythonBackend verdict; and every
    rank holds the same RLC scalars (drawn once, on rank 0, and
    broadcast: with a draw of its own, set 3's pubkey on rank 0 and its
    signature on rank 1 would be scaled by different scalars)."""
    sets = _dryrun_sets()
    bad = list(sets)
    bad[1] = JaxSignatureSet(bad[1].signature, bad[1].pubkeys, b"\xee" * 32)
    malformed = list(sets)
    malformed[2] = JaxSignatureSet(sets[2].signature[:95], sets[2].pubkeys,
                                   sets[2].message)
    cases = [sets, bad, malformed]
    port = [convert.signature_sets_from(c) for c in cases]
    got = launch.run_ranks(
        ranks.run_checks, 2, "gloo", "cpu",
        args=([("verify", (p, 4)) for p in port]
              + [("rlc_digests", (port[0], 4))],))
    want = [SIGNER.verify_signature_sets(c) for c in cases]
    assert want == [True, False, False]
    assert got[:3] == want
    digests = got[3]
    assert len(digests) == 2 and digests[0] == digests[1]


def test_rank_failure_is_raised_with_its_traceback():
    """A rank that raises fails the run with its traceback (here: a leaf
    count that is not a power of two, as the JAX assert demands)."""
    leaves = _words(np.random.default_rng(1), 6)
    with pytest.raises(launch.RankFailure, match="not a power of two"):
        launch.run_ranks(launch.run_tasks, 2, "gloo", "cpu",
                         args=([("merkleize", leaves)],))


def test_ranks_run_the_callers_multiply_lowering():
    """A spawned rank reads only LHTPU_BIGINT_MXU at import; ``run_ranks``
    hands it the caller's ``set_mxu_mode`` too, so the sharded programs
    launch the caller's variants."""
    from lighthouse_tpu_torch.ops import bigint as bi
    prev = bi.mxu_mode()
    try:
        bi.set_mxu_mode(2)
        got = launch.run_ranks(ranks.run_checks, 2, "gloo", "cpu",
                               args=([("mxu_modes", None)],))
    finally:
        bi.set_mxu_mode(prev)
    assert got == [[2, 2]]


def test_mesh_rows_and_sharding_checks():
    m = pmesh.Mesh(None, 1, 4, torch.device("cpu"))
    assert m.rows(16) == (4, 8)
    with pytest.raises(ValueError):
        m.rows(6)
    words = _words(np.random.default_rng(2), 8)
    block = pmesh.shard_batch(m, words)
    assert block.dtype == torch.int32
    assert np.array_equal(block.numpy().view(np.uint32), words[2:4])


def test_batch_mesh_needs_enough_ranks(tmp_path):
    """A one-rank gloo group in this process: the mesh over it is rank 0
    on the CPU, and a mesh of more ranks than the group has raises."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        m = pmesh.batch_mesh(1)
        assert (m.rank, m.size, m.device.type) == (0, 1, "cpu")
        with pytest.raises(ValueError, match="a mesh of 2 ranks"):
            pmesh.batch_mesh(2)
    finally:
        dist.destroy_process_group()


def test_dryrun_multigpu_needs_the_cards():
    with pytest.raises(RuntimeError, match="needs 64 cards"):
        entry.dryrun_multigpu(64)


def test_entry_step_equals_the_jax_entry():
    """``entry()``: the 1,024-validator build and the 16-row balances
    update give the JAX package's ``__graft_entry__.entry`` roots, and
    the step runs twice to the same roots (the balances tree is shared,
    not written)."""
    import __graft_entry__ as graft
    jstep, jargs = graft.entry()
    jv, jb = jax.jit(jstep)(*jargs)
    step, args = entry.entry()
    for _ in range(2):
        v_root, b_root = step(*args)
        assert root_bytes(v_root) == jsh.words_to_chunks(np.asarray(jv))
        assert root_bytes(b_root) == jsh.words_to_chunks(np.asarray(jb))
