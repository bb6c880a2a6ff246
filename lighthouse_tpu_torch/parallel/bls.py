"""Sharded BLS multi-pairing and batch verification (the port of
``lighthouse_tpu/parallel/bls.py``).

Each rank runs the Miller loop on its block of the (P_i, Q_i) pairs and
reduces it to one local Fp12 product; the ``size`` partial products are
all-gathered (``size`` x 1.5 KiB) and the product of the partials, the
final exponentiation and the identity check run replicated on every rank.
``sharded_verify_signature_sets`` runs the whole of
``verify_signature_sets`` this way, with the RLC scalar multiplies
sharded too. Where the JAX package regathers a sharded array implicitly
(the scaled points before the sums), this module gathers explicitly.

Every rank calls these functions with the same arguments (SPMD). The RLC
scalars are drawn once, by rank 0 (``replicated_prep``), and broadcast
with the rest of the host preparation: pubkey lanes are in message order
and signature lanes in set order, so per-rank draws would scale a set's
pubkey and its signature by different scalars and reject a valid batch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..crypto.bls import gpu_backend as gb
from ..obs import device
from ..obs.cuda_accounting import host_readback
from ..obs.roofline import tensor_bytes, tracked
from ..ops import bigint as bi
from ..ops import bls12_381 as k
from .mesh import Mesh, program

_SRC = "lighthouse_tpu_torch/parallel/bls.py"
MILLER_PRODUCT = program("parallel.bls.miller_product", _SRC,
                         "lighthouse_tpu/parallel/bls.py:40")
MASKED_PRODUCT = program("parallel.bls.masked_product", _SRC,
                         "lighthouse_tpu/parallel/bls.py:45")
SCALAR_MUL = program("parallel.bls.scalar_mul", _SRC,
                     "lighthouse_tpu/parallel/bls.py:79")

_FALLBACK_PARSE_BACKEND = None     # shared point cache for cpp/fake backends


_FP12_BYTES = 2 * 3 * 2 * 32 * 4


def _miller_product_cost(partials, mesh: Mesh, px, py, qx, qy, mask=None):
    """This rank's share of a sharded Miller product: its pairs read
    (and the mask), the loops of its live pairs and their product, the
    partials written; the other ranks' partials brought in."""
    from ..ops import bls_cost as cost
    n_local = int(px.shape[0])
    live = (np.ones(n_local, bool) if mask is None
            else host_readback(mask).numpy())
    muls = cost.miller_loop(live) + cost.final_exp(n_local, 0)
    return (tensor_bytes(px, py, qx, qy, mask) + mesh.size * _FP12_BYTES,
            muls * cost.FP_MUL_INT_OPS,
            {"field_muls": muls,
             "link_bytes": (mesh.size - 1) * _FP12_BYTES})


@tracked("bls.miller_product", _miller_product_cost)
def _local_miller_product(mesh: Mesh, px, py, qx, qy) -> torch.Tensor:
    """Miller loop over this rank's pairs, their Fp12 product, gathered:
    the partial products [size, 2, 3, 2, 32] in rank order."""
    MILLER_PRODUCT.ran()
    fs = k.miller_loop_batch(px, py, qx, qy)
    return mesh.all_gather(k.fp12_product(fs), "bls.miller_partials")


@tracked("bls.masked_product", _miller_product_cost)
def _local_masked_product(mesh: Mesh, px, py, qx, qy,
                          mask) -> torch.Tensor:
    """As ``_local_miller_product``, with lanes whose ``mask`` is False
    taken as the identity."""
    MASKED_PRODUCT.ran()
    fs = k.miller_loop_batch(px, py, qx, qy, mask)
    return mesh.all_gather(k.fp12_product(fs), "bls.miller_partials")


def _scalar_mul_program(degree: int):
    """The sharded scalar multiply of G1 (``degree`` 1) or G2 (2), under
    its program name."""
    mul = k.g1_scalar_mul if degree == 1 else k.g2_scalar_mul

    def work(out, mesh: Mesh, x, y, z, bits, label):
        """This rank's share: its lanes' inputs read, every lane's
        scaled point written, its lanes' products; the other ranks'
        scaled lanes brought in."""
        from ..ops import bls_cost as cost
        one = k.FP_ONE if degree == 1 else k.FP2_ONE
        muls = cost.scalar_mul_lanes(host_readback(bits).numpy(), degree,
                                     z_one=k._z_is(z, one))["products"]
        out_bytes = tensor_bytes(out)
        return (tensor_bytes(x, y, z, bits) + out_bytes,
                muls * cost.FP_MUL_INT_OPS,
                {"field_muls": muls,
                 "link_bytes": out_bytes * (mesh.size - 1) // mesh.size})

    def run(mesh: Mesh, x, y, z, bits, label: str):
        SCALAR_MUL.ran()
        local = torch.stack(mul(x, y, z, bits))            # [3, lanes/n, ..]
        every = mesh.all_gather(local, label)              # [n, 3, lanes/n, ..]
        every = every.transpose(0, 1).reshape((3, -1)
                                              + tuple(local.shape[2:]))
        return tuple(c.contiguous() for c in every)

    return tracked(f"bls.g{degree}_scalar_mul", work)(run)


_SCALAR_MUL_PROGRAMS = {1: _scalar_mul_program(1), 2: _scalar_mul_program(2)}


def sharded_scalar_mul(mesh: Mesh, degree: int, x, y, z, bits,
                       label: str):
    """[b_i]P_i on this rank's lanes (G1 for ``degree`` 1, G2 for 2),
    then the scaled lanes of every rank gathered in rank order: the
    Jacobian (x, y, z) of all lanes on every rank."""
    return _SCALAR_MUL_PROGRAMS[degree](mesh, x, y, z, bits, label)


def _is_one_after_final_exp(partials: torch.Tensor) -> bool:
    out = k.final_exponentiation(k.fp12_product(partials))
    return bool(host_readback(k.fp12_eq(out, k.fp12_one_like((), out))))


def sharded_pairing_check(mesh: Mesh, px, py, qx, qy) -> bool:
    """prod_i e(P_i, Q_i) == 1 with the pair batch row-sharded over the
    mesh (this rank's blocks: px, py [n/size, 32], qx, qy [n/size, 2, 32],
    Montgomery limbs). The same verdict on every rank."""
    with device.hbm_watermark("parallel.bls"):
        device.attribute("parallel.bls", "pairing_inputs", px, py, qx, qy)
        return _is_one_after_final_exp(
            _local_miller_product(mesh, px, py, qx, qy))


def _parse_backend(backend):
    """The backend whose pubkey point cache the parse uses: the given
    one, else the registered one, else (a backend without a point cache)
    one module-cached PythonBackend."""
    global _FALLBACK_PARSE_BACKEND
    if backend is None:
        from ..crypto.bls import get_backend
        backend = get_backend()
    if not hasattr(backend, "_pk"):
        if _FALLBACK_PARSE_BACKEND is None:
            from ..crypto.bls import PythonBackend
            _FALLBACK_PARSE_BACKEND = PythonBackend()
        backend = _FALLBACK_PARSE_BACKEND
    return backend


def replicated_prep(mesh: Mesh, sets, lanes: int, backend=None):
    """The host preparation of ``sets`` at ``lanes`` lanes, made once on
    rank 0 (parse, grouping, the RLC scalar draw) and broadcast: every
    rank gets the same dict, or None when a set is malformed."""
    prep = None
    if mesh.rank == 0:
        parsed = gb.parse_sets(_parse_backend(backend), sets)
        if parsed is not None:
            # the sharded Miller loop runs at full ``lanes`` (the shard
            # split must stay even), so no small message shape here
            prep = gb.host_prepare(*parsed, lanes, small=lanes)
    box = [prep]
    dist.broadcast_object_list(box, src=0, group=mesh.group,
                               device=mesh.device)
    return box[0]


def _put(mesh: Mesh, arr) -> torch.Tensor:
    """A host array as a tensor of its own on the rank's device."""
    return torch.from_numpy(np.array(arr)).to(mesh.device)


def rlc_inputs(mesh: Mesh, prep: dict, sig_x, sig_y, pk_x, pk_y):
    """This rank's blocks of the scalar multiplies' inputs: (pk_x, pk_y,
    one, bits) for G1 and (sig_x, sig_y, one, bits) for G2 (``pk_x``,
    ``pk_y``: the rank's block already; ``sig_x``, ``sig_y``: all
    lanes)."""
    lo, hi = mesh.rows(len(prep["flags"]))
    one1 = _put(mesh, np.broadcast_to(k.FP_ONE, (hi - lo, bi.NLIMBS)))
    one2 = _put(mesh, np.broadcast_to(k.FP2_ONE, (hi - lo, 2, bi.NLIMBS)))
    bits_pk = _put(mesh, k.scalars_to_bits(prep["pk_rands"][lo:hi],
                                           gb.RAND_BITS))
    bits_sig = _put(mesh, k.scalars_to_bits(prep["sig_rands"][lo:hi],
                                            gb.RAND_BITS))
    return ((pk_x, pk_y, one1, bits_pk),
            (sig_x[lo:hi].contiguous(), sig_y[lo:hi].contiguous(), one2,
             bits_sig))


def miller_pairs(mesh: Mesh, prep: dict, keep: dict | None = None):
    """The device stages of the verification up to the Miller loop, as
    ``sharded_verify_signature_sets`` runs them: the replicated signature
    decompression and subgroup check, hash-to-G2 at the full lane count,
    the sharded RLC scalar multiplies, then (on the gathered scaled
    points) the signature aggregate and the per-message pubkey sums.
    Returns the replicated pair batch (px, py, qx, qy, mask), padded to a
    multiple of the mesh size with masked lanes, or None when a
    signature fails a check (every rank alike: the checks run
    replicated on the same inputs). ``keep``, when given, receives each
    stage's inputs and outputs by name (to hold the kernels against their
    plain versions on this path's shapes)."""
    lanes = len(prep["flags"])
    # ---- device: the lane inputs into the Montgomery domain (one copy,
    # one launch: all signatures' x, the rank's pubkeys) ------------------
    ints = _put(mesh, gb.rank_lane_ints(prep["lane_ints"], lanes,
                                        *mesh.rows(lanes)))
    sig_x, pk_x, pk_y = gb.split_lane_ints(bi.mont_from_int_limbs(ints),
                                           lanes)
    # ---- device: replicated validity checks + hash map -----------------
    sig_y, on_curve = k.g2_decompress_batch(sig_x, prep["flags"])
    # the two validity gates read the flags back (accounted bytes)
    if not bool(host_readback(on_curve).all()):
        return None
    one2 = _put(mesh, np.broadcast_to(k.FP2_ONE, (lanes, 2, bi.NLIMBS)))
    if not bool(host_readback(k.g2_in_subgroup_batch(sig_x, sig_y,
                                                     one2)).all()):
        return None
    u0, u1 = _put(mesh, prep["u0"]), _put(mesh, prep["u1"])
    mx, my, mz = k.hash_to_g2_batch_from_u(u0, u1)
    msg_x, msg_y = k.jacobian_to_affine_fp2(mx, my, mz)

    # ---- device: SHARDED RLC scalar muls, gathered ---------------------
    g1_in, g2_in = rlc_inputs(mesh, prep, sig_x, sig_y, pk_x, pk_y)
    with device.hbm_watermark("parallel.bls"):
        spx, spy, spz = sharded_scalar_mul(mesh, 1, *g1_in,
                                           "bls.scaled_pubkeys")
        ssx, ssy, ssz = sharded_scalar_mul(mesh, 2, *g2_in,
                                           "bls.scaled_signatures")
        device.attribute("parallel.bls", "rlc_scaled_points",
                         spx, spy, spz, ssx, ssy, ssz)
    # the aggregate sums all lanes in the kernel's tree, whose order n
    # alone fixes, as the single-device path does: the two aggregates are
    # equal limb for limb
    ax, ay, az = k.g2_sum(ssx, ssy, ssz)
    # the layout's host arrays: checked there, each up in one copy
    gpx, gpy, gpz = k.g1_segment_sum(spx, spy, spz, prep["starts"],
                                     prep["ends"])
    apx, apy = k.jacobian_to_affine_fp(gpx, gpy, gpz)
    aax, aay = k.jacobian_to_affine_fp2(ax, ay, az)

    if keep is not None:
        keep.update(lane_ints=ints, sig_x=sig_x, sig_y=sig_y, u0=u0, u1=u1,
                    msg=(mx, my, mz), msg_affine=(msg_x, msg_y),
                    g1_in=g1_in, g2_in=g2_in,
                    scaled_pubkeys=(spx, spy, spz),
                    starts=_put(mesh, prep["starts"]),
                    ends=_put(mesh, prep["ends"]),
                    pubkey_sums=(gpx, gpy, gpz),
                    aggregate=(ax, ay, az))
    # pad the (+1 aggregate) pair batch to a mesh multiple with masked
    # lanes so the shard split stays even
    msg_lanes = prep["msg_lanes"]
    total = msg_lanes + 1
    extra = 1 + (-total) % mesh.size
    pad = gb._pad_cache()
    px = torch.cat([apx, _put(mesh, pad.tile(pad.neg_g_x, extra))])
    py = torch.cat([apy, _put(mesh, pad.tile(pad.neg_g_y, extra))])
    qx = torch.cat([msg_x, aax[None].expand((extra,) + aax.shape)])
    qy = torch.cat([msg_y, aay[None].expand((extra,) + aay.shape)])
    mask = np.zeros(msg_lanes + extra, dtype=bool)
    mask[:msg_lanes] = prep["mask"][:-1]
    mask[msg_lanes] = True                # the one real aggregate lane
    return px, py, qx, qy, _put(mesh, mask.astype(np.int32))


def sharded_verify_signature_sets(mesh: Mesh, sets, lanes: int,
                                  backend=None) -> bool:
    """The full ``verify_signature_sets`` semantics over the mesh: per-set
    pubkey aggregation (host, cached registry points), signature parsing
    and flag handling, same-message grouping, the RLC scalars (drawn once
    on rank 0), device decompression and subgroup checks, the RLC scalar
    multiplies sharded, the sums on the gathered scaled points, and the
    sharded Miller loop with one replicated final exponentiation.

    ``lanes`` must be a multiple of the mesh size and at least the number
    of sets. Returns the verdict, the same on every rank.
    """
    if not sets:
        return False
    if lanes % mesh.size:
        raise ValueError(f"{lanes} lanes do not split over {mesh.size} "
                         f"ranks")
    if len(sets) > lanes:
        raise ValueError(f"{len(sets)} sets do not fit {lanes} lanes")
    prep = replicated_prep(mesh, sets, lanes, backend)
    if prep is None:
        return False                  # malformed input: reject, not raise
    pairs = miller_pairs(mesh, prep)
    if pairs is None:
        return False
    with device.hbm_watermark("parallel.bls"):
        device.attribute("parallel.bls", "miller_pairs", *pairs[:4])
        partials = _local_masked_product(mesh,
                                         *(mesh.local(t) for t in pairs))
        return _is_one_after_final_exp(partials)
