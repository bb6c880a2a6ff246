"""GPU BLS backend: `verify_signature_sets` on the card's CUDA kernels.

The `gpu` entry in the backend registry, the port of the JAX package's
`tpu` backend (lighthouse_tpu/crypto/bls/tpu_backend.py), line for line.
Pipeline for a batch of sets:

  host:   parse+range-check compressed bytes, aggregate cached pubkeys,
          expand_message_xmd (a few SHA-256 calls per message)
  device: lane inputs into the Montgomery domain (fp_ops), batched G2
          signature decompression (sqrt + sign select) and psi subgroup
          checks (g2_intake), SSWU+isogeny+cofactor hash-to-G2
          (hash_to_g2), RLC 64-bit scalar muls (rlc_scale), per-message
          pubkey sums and the signature aggregate (g1_segment_sum,
          g2_sum), affine conversion (affine), n+1 Miller loops
          (miller_loop) and ONE final exponentiation (final_exp).

Every device stage runs at one of TWO lane counts (`lane_options()`):

  - big   = the flagship batch: 10240 on the card (BASELINE.md's 10k
            gossip batch padded to a multiple of 128), 64 on the CPU
            (the plain versions); LHTPU_BLS_LANES overrides;
  - small = 128 (at most big): the hash and Miller stages run here when
            the distinct messages fit, and so does a whole batch of at
            most 128 sets; LHTPU_BLS_SMALL overrides.

Batches pad up to the smallest fitting shape with *generator* lanes
(valid points, so on-curve/subgroup checks stay uniform) whose RLC scalar
is 0 and whose Miller output is masked to the identity; batches larger
than `big` verify in fixed-shape chunks. The padding inputs are process
constants, built once. RLC scalars come from `secrets`: unpredictable
scalars are what makes the batch check sound.

Sign/keygen stay on the Python reference backend (cold path).
"""
from __future__ import annotations

import os
import secrets

import numpy as np
import torch

from . import PythonBackend, SignatureSet

RAND_BITS = 64


def _env_int(name):
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be an integer lane count, got {raw!r}") from None


def lane_options() -> tuple[int, int]:
    """(small, big) batch shapes for the port's device (read per call:
    the tests switch the device)."""
    from ... import device
    env = _env_int("LHTPU_BLS_LANES")
    if env is not None:
        big = max(1, env)
    else:
        big = 10240 if device.get_device().type == "cuda" else 64
    senv = _env_int("LHTPU_BLS_SMALL")
    small = min(max(1, senv) if senv is not None else min(128, big), big)
    return small, big


class _PadCache:
    """Constant inputs for padding lanes: the generator signature's x
    (integer limbs) and flag, the generator pubkey (integer limbs), and
    the hash-to-field outputs for the empty padding message."""

    def __init__(self):
        from ...ops import bigint as bi
        from ...ops import bls12_381 as k
        from ..bls12_381 import G1_GENERATOR, g2_compress
        from ..bls12_381.curve import G2_GENERATOR
        from ..bls12_381.hash_to_curve import DST_POP
        cb = g2_compress(G2_GENERATOR)
        c1 = int.from_bytes(bytes([cb[0] & 0x1f]) + cb[1:48], "big")
        c0 = int.from_bytes(cb[48:96], "big")
        self.sig_x = bi.ints_to_limbs([c0, c1]).reshape(1, 2, bi.NLIMBS)
        self.flag = bool(cb[0] & 0x20)
        gx, gy = G1_GENERATOR.to_affine()
        self.pk_x = bi.ints_to_limbs([int(gx)])
        self.pk_y = bi.ints_to_limbs([int(gy)])
        self.u0, self.u1 = k.hash_to_field_host([b""], DST_POP)
        neg_g = G1_GENERATOR.neg().to_affine()
        self.neg_g_x = k.fp_encode([int(neg_g[0])])
        self.neg_g_y = k.fp_encode([int(neg_g[1])])

    @staticmethod
    def tile(arr: np.ndarray, pad: int) -> np.ndarray:
        return np.broadcast_to(arr, (pad,) + arr.shape[1:])


_PAD: _PadCache | None = None


def _pad_cache() -> _PadCache:
    global _PAD
    if _PAD is None:
        _PAD = _PadCache()
    return _PAD


def parse_sets(backend, sets):
    """Host parse: per-set pubkey aggregation (cached registry points) +
    compressed-signature x/flag extraction with range checks. Returns
    (pks, sig_xs, flags, msgs) or None when any set is malformed (the
    batch must verify False, not raise)."""
    from ..bls12_381.fields import P as P_INT
    pks, sig_xs, flags, msgs = [], [], [], []
    try:
        for s in sets:
            if not s.pubkeys:
                return None
            pts = [backend._pk(p) for p in s.pubkeys]
            agg = pts[0]
            for p in pts[1:]:
                agg = agg.add(p)
            if agg.is_infinity():
                return None
            pks.append(agg)
            cb = s.signature
            if len(cb) != 96 or not (cb[0] & 0x80) or (cb[0] & 0x40):
                return None           # malformed or infinity signature
            c1 = int.from_bytes(bytes([cb[0] & 0x1f]) + cb[1:48], "big")
            c0 = int.from_bytes(cb[48:96], "big")
            if c0 >= P_INT or c1 >= P_INT:
                return None
            sig_xs.append((c0, c1))
            flags.append(bool(cb[0] & 0x20))
            msgs.append(s.message)
    except ValueError:
        return None
    return pks, sig_xs, flags, msgs


def host_prepare(pks, sig_xs, sig_flags, msgs, lanes: int, small: int):
    """Pad/group host prep: same-message grouping (segment layout for
    `g1_segment_sum`), RLC scalars, and the padded lane inputs. Signature
    x and pubkey coordinates stay integer limbs (the device converts them
    into the Montgomery domain); the hash-to-field outputs are Montgomery
    limbs. Returns a dict of arrays + layout."""
    from ...ops import bigint as bi
    from ...ops import bls12_381 as k
    from ..bls12_381.hash_to_curve import DST_POP

    pad_c = _pad_cache()
    m = len(pks)
    pad = lanes - m
    groups: dict[bytes, int] = {}
    gid = [groups.setdefault(msg, len(groups)) for msg in msgs]
    n_groups = len(groups)
    msg_lanes = small if n_groups <= small else lanes
    order = sorted(range(m), key=lambda i: gid[i])
    starts = np.zeros(lanes, dtype=np.int32)
    ends = np.zeros(msg_lanes, dtype=np.int32)
    prev = None
    for pos, i in enumerate(order):
        if gid[i] != prev:
            starts[pos] = 1
            prev = gid[i]
        ends[gid[i]] = pos
    if pad:
        starts[m] = 1                  # padding lanes: one junk segment
    rands = [1] if m == 1 else [secrets.randbits(RAND_BITS) | 1
                                for _ in range(m)]

    sig_x_ints: list[int] = []
    for c0, c1 in sig_xs:
        sig_x_ints += [c0, c1]
    sig_x_real = bi.ints_to_limbs(sig_x_ints).reshape(m, 2, bi.NLIMBS)
    cat = np.concatenate
    sig_x = cat([sig_x_real, pad_c.tile(pad_c.sig_x, pad)]) if pad \
        else sig_x_real
    flags = np.asarray(list(sig_flags) + [pad_c.flag] * pad, dtype=bool)
    pkx_l, pky_l = [], []
    for p in (pks[i] for i in order):
        x, y = p.to_affine()
        pkx_l.append(int(x))
        pky_l.append(int(y))
    pk_x_real, pk_y_real = bi.ints_to_limbs(pkx_l), bi.ints_to_limbs(pky_l)
    pk_x = cat([pk_x_real, pad_c.tile(pad_c.pk_x, pad)]) if pad \
        else pk_x_real
    pk_y = cat([pk_y_real, pad_c.tile(pad_c.pk_y, pad)]) if pad \
        else pk_y_real
    umsgs = [None] * n_groups
    for msg, g in groups.items():
        umsgs[g] = msg
    u0_real, u1_real = k.hash_to_field_host(umsgs, DST_POP)
    upad = msg_lanes - n_groups
    u0 = cat([u0_real, pad_c.tile(pad_c.u0, upad)]) if upad else u0_real
    u1 = cat([u1_real, pad_c.tile(pad_c.u1, upad)]) if upad else u1_real
    mask = np.zeros(msg_lanes + 1, dtype=bool)
    mask[:n_groups] = True
    mask[-1] = True                   # the aggregate/-G1 lane is real
    return {
        "sig_x": sig_x, "flags": flags, "pk_x": pk_x, "pk_y": pk_y,
        "u0": u0, "u1": u1, "starts": starts, "ends": ends, "mask": mask,
        "pk_rands": [rands[i] for i in order] + [0] * pad,
        "sig_rands": list(rands) + [0] * pad,
        "n_groups": n_groups, "msg_lanes": msg_lanes,
    }


class GpuBackend(PythonBackend):
    name = "gpu"

    def verify_signature_sets(self, sets: list[SignatureSet]) -> bool:
        if not sets:
            return False
        parsed = parse_sets(self, sets)
        if parsed is None:
            return False
        pks, sig_xs, sig_flags, msgs = parsed
        small, big = lane_options()
        n = len(sets)
        for i in range(0, n, big):
            m = min(big, n - i)
            lanes = small if m <= small else big
            if not self._verify_chunk(pks[i:i + m], sig_xs[i:i + m],
                                      sig_flags[i:i + m],
                                      msgs[i:i + m], lanes):
                return False
        return True

    def _verify_chunk(self, pks, sig_xs, sig_flags, msgs,
                      lanes: int) -> bool:
        """One fixed-shape device pass over m<=lanes real sets, padded to
        `lanes` with the cached generator lanes (scalar 0, output masked).

        Same-message aggregation: sets sharing a message fold into one
        pairing pair via sum_i r_i e(P_i, H(m)) = e(sum_i r_i P_i, H(m)),
        so a 10k gossip batch over ~128 messages runs the hash and Miller
        stages at the small shape."""
        from ... import device
        from ...ops import bigint as bi
        from ...ops import bls12_381 as k

        dev = device.get_device()
        prep = host_prepare(pks, sig_xs, sig_flags, msgs, lanes,
                            lane_options()[0])
        pad_c = _pad_cache()

        def put(arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

        # device: lane inputs into the Montgomery domain
        sig_x = bi.mont_from_int_limbs(put(prep["sig_x"]))
        pk_x = bi.mont_from_int_limbs(put(prep["pk_x"]))
        pk_y = bi.mont_from_int_limbs(put(prep["pk_y"]))

        # device: signature decompression + subgroup check (generator
        # padding keeps both checks uniformly True on padded lanes)
        sig_y, on_curve = k.g2_decompress_batch(sig_x, prep["flags"])
        if not bool(on_curve.all()):
            return False
        one2 = put(np.broadcast_to(k.FP2_ONE, (lanes, 2, bi.NLIMBS)))
        if not bool(k.g2_in_subgroup_batch(sig_x, sig_y, one2).all()):
            return False

        # device: hash unique messages to G2 (host did expand_message_xmd)
        mx, my, mz = k.hash_to_g2_batch_from_u(put(prep["u0"]),
                                               put(prep["u1"]))

        one1 = put(np.broadcast_to(k.FP_ONE, (lanes, bi.NLIMBS)))

        # RLC scaling (padded lanes scale to infinity)
        spx, spy, spz = k.g1_scalar_mul(
            pk_x, pk_y, one1,
            put(k.scalars_to_bits(prep["pk_rands"], RAND_BITS)))
        ssx, ssy, ssz = k.g2_scalar_mul(
            sig_x, sig_y, one2,
            put(k.scalars_to_bits(prep["sig_rands"], RAND_BITS)))
        # per-message pubkey sums; group g's sum lands in lane g
        # (the layout's host arrays: checked there, each up in one copy,
        # nothing read back)
        gpx, gpy, gpz = k.g1_segment_sum(spx, spy, spz, prep["starts"],
                                         prep["ends"])
        # aggregate of the scaled signatures
        ax, ay, az = k.g2_sum(ssx, ssy, ssz)

        # affine for the Miller loop; non-group lanes come out as junk
        # finite coordinates (z=0 inverts to 0) and are masked below. The
        # Q side (the message points, then the aggregate) in one launch
        apx, apy = k.jacobian_to_affine_fp(gpx, gpy, gpz)
        qx, qy = k.jacobian_to_affine_fp2(
            *(torch.cat([m, a[None]], dim=0)
              for m, a in ((mx, ax), (my, ay), (mz, az))))

        px = torch.cat([apx, put(pad_c.neg_g_x)], dim=0)
        py = torch.cat([apy, put(pad_c.neg_g_y)], dim=0)
        return k.pairing_check_batch(px, py, qx, qy, mask=prep["mask"])
