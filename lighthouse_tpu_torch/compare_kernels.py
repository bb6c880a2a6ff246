"""The port's redesigned kernels against another tree's, on one card, in
one process.

    git archive <commit> lighthouse_tpu_torch/csrc | tar -x -C BASE
    python -m lighthouse_tpu_torch.compare_kernels --base BASE \\
        [--kernels g1_segment_sum,cap_fold,path_update,affine,rlc_scale,\\
                   g2_intake,g2_sum,miller_loop] --out compare_kernels.json

Builds both trees' sources of the chosen kernels (default: all eight; the
BLS ones in each multiply lowering, modes 0, 1, 2) with the flags of
``kernels.py``, and prints this tree's ``-Xptxas -v`` report of each
(registers, stack, spills). On seeded inputs (``default_rng(5)``: 64 G2
and 64 G1 points, tiled and scaled by random 64-bit scalars on the card,
so every lane is its own Jacobian point; random tree levels and leaf
rows) it times, by CUDA events (the median of 5 runs after a warm-up,
each run as many back-to-back calls as fill ~1 ms, at most 20, over
their count), in the order base, this, this, base, holding every pair of
outputs equal:

- ``g1_segment_sum`` (``lh_g1_segment_sum``) on the scaled G1 points at
  10,240 lanes (the 10k batch) and 2,560 (a rank at n = 4), m = 10,000 /
  2,500 of them live, in three layouts: the batch's (m sets over 127
  messages, a padding group at lane 0), one segment of m lanes, m
  one-lane segments; in modes 0-2, then this tree's ``aggregate.cu`` with
  ``LH_SEG_T_SHORT`` and ``LH_SEG_T_LONG`` both set to 32, 64, 128 (mode
  0: the piece forced at every layout). Sums as points
  (``measure.g1_projective_err``: the base walks each segment in lane
  order, this tree adds in trees);
- ``cap_fold`` (``lh_cap_fold``) at k = 0, 1, 20, 44 caps: the base
  tree's entry on the caps' words on the card against this tree's on its
  built-in table; then this tree's with the table in the constant bank
  (``LHSHA_ZERO_SPACE`` set to ``__constant__``);
- ``path_update``: the dirty-path walk of an update up a depth-20 tree,
  R = 1,024 and 65,536 rows (drawn with repeats, walked sorted and
  distinct): the base tree's walk (``lh_path_walk`` without caps) against
  this tree's with none (its limit the tree's depth), and the base
  tree's walk then its cap fold of the registry's 20 caps (two launches)
  against this tree's one launch with the caps; then this tree's source
  with ``LH_PATH_THREADS`` set to 64-512;
- ``affine`` (``lh_affine``): 128 Fp lanes (the group sums), 129 Fp2 (the
  Q side: messages and aggregate) and 1 Fp2; then this tree's
  ``aggregate.cu`` with ``LH_AFFINE_THREADS`` set to 32, 64, 128 against
  the source as it is, at those lanes and at 10,240 Fp2 (the sharded
  path's messages);
- ``rlc_scale`` (``lh_rlc_scale``): G1 and G2 at 10,240 lanes (the 10k
  batch) and 2,560 (a rank of the four-card sharded path), affine inputs
  (z one) as on the main path, random 64-bit scalars; then the lane-group
  widths: this tree's ``rlc_scale.cu`` with ``LH_RLC_G1_WIDTH`` and
  ``LH_RLC_G2_WIDTH`` set to w (mode 0), against the source as it is;
- ``g2_intake`` (``lh_g2_intake``): decompression (the points' x with
  random sign flags, every 97th lane an x with no root) and the subgroup
  check (z one) at the same lane counts, then the widths of
  ``LH_G2I_WIDTH``;
- ``g2_sum`` (``lh_g2_sum``) of 10,240 points, then at 128-10,240 points
  (sums as points, ``measure.g2_projective_err``: the trees add in
  different orders);
- ``miller_loop`` (``lh_miller_loop``) of 129 pairs, one masked; then the
  two Miller designs (``-DLH_ML_COOP_MAX``) on the verification's pairs
  past 128 messages: 10,241 pairs of which L are live (the first L - 1
  and the last), a thread a pair on all against a block a pair on the L
  live pairs gathered, their outputs scattered back among identities, as
  ``miller_loop_batch`` does.

Field values are held canonically, flags and tree levels exactly. Prints
a line a measurement, with the card's name and power limit, and writes
them as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from . import kernels
from .measure import (
    field_err, g1_projective_err, g2_projective_err, nvidia_smi,
)

_MILLER_PAIRS = 10241
_MILLER_LIVE = (129, 257, 513, 1025, 1537, 2049, 2561, 3073, 5121, 10241)
_SUM_SWEEP = (128, 256, 1024, 4096, 10240)
#: the batch's lanes and a rank's on the four-card sharded path
_LANES = (10240, 2560)
#: lane-group widths swept (threads a lane)
_RLC_WIDTHS = (1, 2, 3, 4, 5, 6, 8, 16)
_G2I_WIDTHS = (2, 3, 4, 5, 6, 8, 16)
#: the walk's tree and its leaf rows; the block sizes swept
_WALK_DEPTH = 20
_WALK_ROWS = (1024, 65536)
_WALK_THREADS = (64, 128, 256, 512)
#: the segment sums' lanes (the batch's and a rank's at n = 4) and the
#: piece sizes swept
_SEG_LANES = (10240, 2560)
_SEG_T = (32, 64, 128)
#: the caps folded, and the walk's limit depth (the registry's 2^40)
_CAPS = (0, 1, 20, 44)
_WALK_LIMIT = 40
#: the affine lanes: (field, lanes), and the block sizes swept
_AFFINE_LANES = ((1, 128), (2, 129), (2, 1))
_AFFINE_THREADS = (32, 64, 128)
_P, _I32, _I64 = kernels._P, kernels._I32, kernels._I64
#: this tree's C entries -> their argument types
_ARGTYPES = {"lh_g1_segment_sum": kernels.G1_SEGMENT_SUM.argtypes,
             "lh_cap_fold": kernels.CAP_FOLD.argtypes,
             "lh_g2_sum": kernels.G2_SUM.argtypes,
             "lh_miller_loop": kernels.MILLER_LOOP.argtypes,
             "lh_rlc_scale": kernels.RLC_SCALE.argtypes,
             "lh_g2_intake": kernels.G2_INTAKE.argtypes,
             "lh_affine": kernels.AFFINE.argtypes,
             "lh_path_walk": kernels.PATH_UPDATE.argtypes}
#: the base tree (the commit before the segment sum's trees and the
#: caps in the walk, 1deed2d) where its entries differ: the segment walk
#: without scratch, the cap fold of the caps' words, the walk without caps
_BASE_ARGTYPES = {**_ARGTYPES,
                  "lh_g1_segment_sum": [_P, _P, _P, _P, _I64, _P, _I64, _P,
                                        _P, _P, _P],
                  "lh_cap_fold": [_P, _P, _I32, _P, _P],
                  "lh_path_walk": [_P, _I32, _P, _I64, _P]}
#: kernel -> (source under csrc/, this tree's entry, a base tree's entry)
_SOURCES = {"g1_segment_sum": ("bls/aggregate.cu", "lh_g1_segment_sum",
                               "lh_g1_segment_sum"),
            "cap_fold": ("cap_fold.cu", "lh_cap_fold", "lh_cap_fold"),
            "path_update": ("path_update.cu", "lh_path_walk",
                            "lh_path_walk"),
            "affine": ("bls/aggregate.cu", "lh_affine", "lh_affine"),
            "rlc_scale": ("bls/rlc_scale.cu", "lh_rlc_scale", "lh_rlc_scale"),
            "g2_intake": ("bls/g2_intake.cu", "lh_g2_intake", "lh_g2_intake"),
            "g2_sum": ("bls/aggregate.cu", "lh_g2_sum", "lh_g2_sum"),
            "miller_loop": ("bls/pairing.cu", "lh_miller_loop",
                            "lh_miller_loop")}


def _build(jobs: dict, out_dir: Path) -> tuple[dict, dict]:
    """{tag: (source, defines, symbol)} -> ({tag: bound C entry}, {tag:
    compiler report}), all nvcc processes at once; a tag ``base_...`` is
    the base tree's (``_BASE_ARGTYPES``)."""
    procs = {}
    for tag, (src, defines, _) in jobs.items():
        lib = out_dir / f"{tag}.so"
        procs[tag] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns, logs = {}, {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        logs[tag] = log
        symbol = jobs[tag][2]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = (_BASE_ARGTYPES if tag.startswith("base_")
                       else _ARGTYPES)[symbol]
        fn.restype = ctypes.c_int
        fns[tag] = fn
    return fns, logs


def _ptxas(log: str) -> list[str]:
    """The kernels' lines of a ``-Xptxas -v`` report: each entry's
    registers, then its stack and spills."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("registers" in line or "stack frame" in line):
            out.append(f"{entry}: {line.split('info    :')[-1].strip()}")
    return out


def _width_source(tmp: Path, source: str, macros: tuple, w: int) -> Path:
    """A copy of this tree's csrc with ``source``'s (a path under csrc/)
    width macros set to w (``host_cuda.set_define``)."""
    from .testing.host_cuda import set_define
    d = tmp / f"w{w}_{Path(source).stem}"
    shutil.copytree(kernels.CSRC, d)
    text = (d / source).read_text()
    for macro in macros:
        text = set_define(text, macro, w)
    (d / source).write_text(text)
    return d / source


def _inputs(n_max: int):
    """``n_max`` Jacobian G2 points, ``n_max`` affine pairs, and the affine
    G2 and G1 points with their scalars' bits, on the card (see the
    module docstring)."""
    import torch

    from .crypto.bls12_381 import G1_GENERATOR, G2_GENERATOR
    from .ops import bls12_381 as k

    rng = np.random.default_rng(5)
    base = 64

    def tiled(arr, shape):
        return torch.from_numpy(np.ascontiguousarray(
            np.resize(arr, (n_max,) + shape))).cuda()

    def bits():
        return torch.from_numpy(k.scalars_to_bits(
            [int(s) for s in rng.integers(1, 2**63, size=n_max)],
            64)).cuda()

    g2 = [G2_GENERATOR.mul(int(rng.integers(1, 2**62))).to_affine()
          for _ in range(base)]
    g1 = [G1_GENERATOR.mul(int(rng.integers(1, 2**62))).to_affine()
          for _ in range(base)]
    one2 = tiled(k.FP2_ONE, (2, 32))
    one1 = tiled(k.FP_ONE, (32,))
    a2 = (tiled(k.fp2_encode([p[0] for p in g2]), (2, 32)),
          tiled(k.fp2_encode([p[1] for p in g2]), (2, 32)), one2)
    a1 = (tiled(k.fp_encode([p[0] for p in g1]), (32,)),
          tiled(k.fp_encode([p[1] for p in g1]), (32,)), one1)
    b2, b1 = bits(), bits()
    sig = k.g2_scalar_mul(*a2, b2)
    pk = k.g1_scalar_mul(*a1, b1)
    qx, qy = k.jacobian_to_affine_fp2(*sig)
    px, py = k.jacobian_to_affine_fp(*pk)
    # decompression's input: the points' x, every 97th an x with no root
    dx = a2[0].clone()
    dx[::97] = torch.from_numpy(k.fp_encode([5, 7]).reshape(2, 32)).cuda()
    flags = torch.from_numpy(rng.integers(0, 2, size=n_max).astype(
        np.int32)).cuda()
    return sig, (px, py, qx, qy), {"g2": a2, "g1": a1, "b2": b2, "b1": b1,
                                   "dx": dx, "flags": flags, "pk": pk}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="a directory holding another tree's "
                         "lighthouse_tpu_torch/csrc")
    ap.add_argument("--kernels", default=",".join(_SOURCES),
                    help="comma-separated: " + ", ".join(_SOURCES))
    ap.add_argument("--out", help="also write the measurements as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels needs an NVIDIA card")
    chosen = args.kernels.split(",")
    for name in chosen:
        if name not in _SOURCES:
            raise SystemExit(f"no kernel {name}")

    card = nvidia_smi("name,power.limit")
    trees = {"base": args.base / "lighthouse_tpu_torch" / "csrc",
             "this": kernels.CSRC}
    from .ops import bls12_381 as k
    kernels.build_all([kernels.RLC_SCALE, kernels.AFFINE])
    report = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        jobs = {}
        # the walk's comparison with caps takes the base tree's cap fold
        built = chosen + (["cap_fold"] if "path_update" in chosen
                          and "cap_fold" not in chosen else [])
        for tree, d in trees.items():
            for name in built:
                src, this_symbol, base_symbol = _SOURCES[name]
                symbol = this_symbol if tree == "this" else base_symbol
                state_root = name in ("path_update", "cap_fold")
                for m in ((0,) if state_root else (0, 1, 2)):
                    jobs[f"{tree}_{name}{m}"] = (
                        d / src, (f"-DLH_FP_MODE={m}",), symbol)
        if "miller_loop" in chosen:
            for tag, cap in (("one_thread", 0), ("cooperative", 1 << 30)):
                jobs[tag] = (trees["this"] / "bls" / "pairing.cu",
                             (f"-DLH_ML_COOP_MAX={cap}",), "lh_miller_loop")
        widths = {"rlc_scale": (_RLC_WIDTHS, ("LH_RLC_G1_WIDTH",
                                              "LH_RLC_G2_WIDTH")),
                  "g2_intake": (_G2I_WIDTHS, ("LH_G2I_WIDTH",)),
                  "affine": (_AFFINE_THREADS, ("LH_AFFINE_THREADS",)),
                  "g1_segment_sum": (_SEG_T, ("LH_SEG_T_SHORT",
                                              "LH_SEG_T_LONG")),
                  "path_update": (_WALK_THREADS, ("LH_PATH_THREADS",))}
        for name, (ws, macros) in widths.items():
            if name in chosen:
                src, symbol, _ = _SOURCES[name]
                for w in ws:
                    jobs[f"w{w}_{name}"] = (
                        _width_source(tmp, src, macros, w), (), symbol)
        if "cap_fold" in chosen:        # the zero-hash table in the
            jobs["constant_cap_fold"] = (   # constant bank
                _width_source(tmp, "zero_hashes.cuh", ("LHSHA_ZERO_SPACE",),
                              "__constant__").parent / "cap_fold.cu", (),
                "lh_cap_fold")
        fns, logs = _build(jobs, tmp)
        for tag in sorted(logs):
            if tag.startswith(("this_", "w")):
                for line in _ptxas(logs[tag]):
                    print(f"ptxas {tag} {line}", flush=True)
                    report.append({"ptxas": tag, "line": line})
        stream = torch.cuda.current_stream().cuda_stream
        n_max = max(_MILLER_PAIRS, max(_SUM_SWEEP))
        sig, pairs, lane = _inputs(n_max)

        def g2_sum(fn, n, partials):
            """The base tree's entry allocates its partials (partials
            False), this tree's takes them."""
            x, y, z = (c[:n].contiguous() for c in sig)
            out = [torch.empty(2, 32, dtype=torch.int32, device="cuda")
                   for _ in range(3)]
            part = torch.empty(3 * 128 * 2 * 32, dtype=torch.int32,
                               device="cuda")
            assert fn(x.data_ptr(), y.data_ptr(), z.data_ptr(), n,
                      *((part.data_ptr(),) if partials else ()),
                      *(o.data_ptr() for o in out), stream) == 0
            return tuple(out)

        def rlc(fn, field, n):
            pts = lane["g2" if field == 2 else "g1"]
            bits = lane["b2" if field == 2 else "b1"]
            out = [torch.empty_like(pts[0][:n]) for _ in range(3)]
            assert fn(field, *(c.data_ptr() for c in pts), bits.data_ptr(),
                      64, *(o.data_ptr() for o in out), n, stream) == 0
            return tuple(out)

        def intake(fn, mode, n):
            ok = torch.empty(n, dtype=torch.int32, device="cuda")
            if mode == 0:
                y = torch.empty_like(lane["dx"][:n])
                assert fn(0, lane["dx"].data_ptr(), lane["flags"].data_ptr(),
                          y.data_ptr(), None, ok.data_ptr(), n, stream) == 0
                return y, ok.to(torch.bool)
            x, y, z = lane["g2"]
            assert fn(1, x.data_ptr(), None, y.data_ptr(), z.data_ptr(),
                      ok.data_ptr(), n, stream) == 0
            return ok.to(torch.bool)

        def miller(fn, args, mask):
            n = args[0].shape[0]
            px, py, qx, qy = (c.contiguous() for c in args)
            out = torch.empty(n, 2, 3, 2, 32, dtype=torch.int32,
                              device="cuda")
            assert fn(px.data_ptr(), py.data_ptr(), qx.data_ptr(),
                      qy.data_ptr(), mask.data_ptr(), out.data_ptr(), n,
                      stream) == 0
            return out

        def miller_live(fn, n, live):
            """``fn`` on the pairs at lanes ``live`` of the first n alone,
            scattered back among identities (``miller_loop_batch``)."""
            ones = torch.ones(live.size, dtype=torch.int32, device="cuda")
            return k._on_live_lanes(lambda *a: miller(fn, a, ones), live,
                                    *(c[:n] for c in pairs))

        def affine(fn, field, n):
            src = sig if field == 2 else lane["pk"]
            x, y, z = (c[:n].contiguous() for c in src)
            ox, oy = torch.empty_like(x), torch.empty_like(x)
            assert fn(field, x.data_ptr(), y.data_ptr(), z.data_ptr(),
                      ox.data_ptr(), oy.data_ptr(), n, stream) == 0
            return ox, oy

        def walk_levels():
            """A depth-20 tree's levels, and for each R its sorted distinct
            rows (drawn with repeats), their leaves written."""
            from .ops import sha256 as sh
            g = np.random.default_rng(5)
            lv = [torch.from_numpy(g.integers(
                0, 2**32, size=(1 << _WALK_DEPTH, 8), dtype=np.uint64
            ).astype(np.uint32).view(np.int32)).cuda()]
            for _ in range(_WALK_DEPTH):
                lv.append(sh.hash64(lv[-1].reshape(-1, 16)))
            rows = {}
            for r in _WALK_ROWS:
                rows[r] = torch.from_numpy(np.unique(g.integers(
                    0, 1 << _WALK_DEPTH, size=r)).astype(np.int32)).cuda()
                lv[0][rows[r].long()] = -1 - r
            return lv, rows

        from .ops import sha256 as sh
        zeros = torch.from_numpy(sh.ZERO_HASH_WORDS.view(np.int32)).cuda()

        def cap(fn, base, root, dense, limit):
            """One cap fold: the base tree's entry on the caps' words on
            the card, this tree's on its constant table."""
            out = torch.empty(8, dtype=torch.int32, device="cuda")
            args = ((zeros[dense:].data_ptr(), limit - dense) if base
                    else (dense, limit))
            assert fn(root.data_ptr(), *args, out.data_ptr(), stream) == 0
            return out

        def walk(fn, this, lv, rows, caps):
            """``fn`` up all levels ``lv``, in place (a walk again on its
            own output gives the same levels): the base tree's walk
            (``caps``: then its cap fold, a second launch), or this tree's
            (``this``: its root in the same launch, capped with ``caps``,
            the top node itself without). The levels, and the capped root
            with ``caps``."""
            r = int(rows.shape[0])
            ptrs = (ctypes.c_void_p * (_WALK_DEPTH + 1))(
                *(t.data_ptr() for t in lv))
            if this:
                root = torch.empty(8, dtype=torch.int32, device="cuda")
                assert fn(ptrs, _WALK_DEPTH, rows.data_ptr(), r,
                          _WALK_LIMIT if caps else _WALK_DEPTH,
                          root.data_ptr(), stream) == 0
                return lv + [root] if caps else lv
            assert fn(ptrs, _WALK_DEPTH, rows.data_ptr(), r, stream) == 0
            if not caps:
                return lv
            return lv + [cap(fns["base_cap_fold0"], True, lv[-1][0],
                             _WALK_DEPTH, _WALK_LIMIT)]

        def level_err(a, b):
            return int(not all(torch.equal(x, y) for x, y in zip(a, b)))

        def walk_pair(label, levels, rows, first, second, caps):
            """Two walks (each (entry, this tree's)), each on its own copy
            of the stale levels."""
            a = [t.clone() for t in levels]
            b = [t.clone() for t in levels]
            pair(label, lambda: walk(*first, a, rows, caps),
                 lambda: walk(*second, b, rows, caps), level_err)

        def seg_layouts(n):
            """(label, starts, ends) of the three layouts at n lanes, m =
            n * 10,000 / 10,240 of them live (the batch's padding at m)."""
            m = n * 10000 // 10240
            sizes = np.array([m // 127 + (g < m % 127) for g in range(127)])
            firsts = np.cumsum(sizes) - sizes
            batch = np.zeros(n, np.int32)
            batch[firsts] = 1
            batch[m] = 1
            one = np.zeros(n, np.int32)
            one[[0, m]] = 1
            return [("the batch's 127 segments", batch,
                     np.append(firsts + sizes - 1, 0)),
                    (f"one segment of {m} lanes", one,
                     np.array([m - 1] + [0] * 127)),
                    (f"{m} one-lane segments", np.ones(n, np.int32),
                     np.arange(m))]

        def seg(fn, n, starts, ends, work):
            """``fn`` on the first n scaled G1 points; ``work``: this
            tree's scratch (None: the base tree's entry, which has
            none)."""
            x, y, z = (c[:n].contiguous() for c in lane["pk"])
            g = int(ends.shape[0])
            out = [torch.empty(g, 32, dtype=torch.int32, device="cuda")
                   for _ in range(3)]
            extra = () if work is None else (work.data_ptr(),
                                              work.numel())
            assert fn(x.data_ptr(), y.data_ptr(), z.data_ptr(),
                      starts.data_ptr(), n, ends.data_ptr(), g, *extra,
                      *(o.data_ptr() for o in out), stream) == 0
            return tuple(out)

        one_masked = np.ones(129, np.int32)
        one_masked[127] = 0                  # the batch's padding lane
        one_masked = torch.from_numpy(one_masked).cuda()

        def ms(call):
            """A call's ms: the median of 5 runs of back-to-back calls
            between two CUDA events, over the calls (as many as fill ~1 ms,
            at most 20, so a short kernel's time is the card's and not
            the host's launch rate), after a warm-up call."""
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            b.synchronize()
            reps = max(1, min(20, int(1.0 / max(a.elapsed_time(b), 0.05))))
            times = []
            for _ in range(5):
                a.record()
                for _ in range(reps):
                    call()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) / reps)
            return statistics.median(times)

        def pair(label, first, second, err):
            """first(), second(), second(), first(); outputs equal by
            ``err``."""
            e = err(first(), second())
            if e != 0:
                raise SystemExit(f"{label}: the two differ "
                                 f"(max_abs_err {e})")
            t = [ms(first), ms(second), ms(second), ms(first)]
            rec = {"label": label, "first_ms": [t[0], t[3]],
                   "second_ms": [t[1], t[2]], "card": card}
            print(f"{label}: outputs equal; {t[0]:.4f} / {t[3]:.4f} ms "
                  f"against {t[1]:.4f} / {t[2]:.4f} ms [{card}]",
                  flush=True)
            report.append(rec)

        calls = {
            "rlc_scale": [(f"rlc_scale G{f}", lambda fn, n, f=f: rlc(fn, f, n))
                          for f in (1, 2)],
            "g2_intake": [(f"g2_intake {what}",
                           lambda fn, n, m=m: intake(fn, m, n))
                          for m, what in ((0, "decompress"),
                                          (1, "subgroup"))]}
        for name in ("rlc_scale", "g2_intake"):
            if name not in chosen:
                continue
            for label, call in calls[name]:
                for n in _LANES:
                    for m in (0, 1, 2):
                        pair(f"mode {m} {label}, {n} lanes: base against "
                             f"this",
                             lambda m=m, n=n, call=call:
                                 call(fns[f"base_{name}{m}"], n),
                             lambda m=m, n=n, call=call:
                                 call(fns[f"this_{name}{m}"], n), field_err)
                    for w in widths[name][0]:
                        pair(f"mode 0 {label}, {n} lanes: this against "
                             f"width {w}",
                             lambda n=n, call=call:
                                 call(fns[f"this_{name}0"], n),
                             lambda n=n, w=w, call=call:
                                 call(fns[f"w{w}_{name}"], n), field_err)
        if "g1_segment_sum" in chosen:
            for n in _SEG_LANES:
                for what, starts, ends in seg_layouts(n):
                    st = torch.from_numpy(starts.astype(np.int32)).cuda()
                    en = torch.from_numpy(ends.astype(np.int32)).cuda()
                    work = torch.empty(
                        k._seg_work_words(n, int(en.shape[0])),
                        dtype=torch.int32, device="cuda")
                    label = f"g1_segment_sum, {n} lanes, {what}"
                    for m in (0, 1, 2):
                        pair(f"mode {m} {label}: base against this",
                             lambda m=m, n=n, st=st, en=en: seg(
                                 fns[f"base_g1_segment_sum{m}"], n, st, en,
                                 None),
                             lambda m=m, n=n, st=st, en=en, work=work: seg(
                                 fns[f"this_g1_segment_sum{m}"], n, st, en,
                                 work), g1_projective_err)
                    for t in _SEG_T:
                        pair(f"mode 0 {label}: this against T = {t}",
                             lambda n=n, st=st, en=en, work=work: seg(
                                 fns["this_g1_segment_sum0"], n, st, en,
                                 work),
                             lambda n=n, st=st, en=en, work=work, t=t: seg(
                                 fns[f"w{t}_g1_segment_sum"], n, st, en,
                                 work), g1_projective_err)
        if "cap_fold" in chosen:
            root = torch.from_numpy(np.random.default_rng(5).integers(
                0, 2**32, size=8, dtype=np.uint64).astype(np.uint32).view(
                    np.int32)).cuda()
            for kk in _CAPS:
                dense = 20 if kk < 44 else 0
                pair(f"cap_fold, k = {kk}: base against this",
                     lambda dense=dense, kk=kk: cap(
                         fns["base_cap_fold0"], True, root, dense,
                         dense + kk),
                     lambda dense=dense, kk=kk: cap(
                         fns["this_cap_fold0"], False, root, dense,
                         dense + kk), level_err)
                pair(f"cap_fold, k = {kk}: this against its table in the "
                     f"constant bank",
                     lambda dense=dense, kk=kk: cap(
                         fns["this_cap_fold0"], False, root, dense,
                         dense + kk),
                     lambda dense=dense, kk=kk: cap(
                         fns["constant_cap_fold"], False, root, dense,
                         dense + kk), level_err)
        if "path_update" in chosen:
            levels, walk_rows = walk_levels()
            base_walk = (fns["base_path_update0"], False)
            this_walk = (fns["this_path_update0"], True)
            for r, rows in walk_rows.items():
                label = (f"path_update, depth {_WALK_DEPTH}, R = {r} "
                         f"({int(rows.shape[0])} distinct)")
                walk_pair(f"{label}: base against this, no caps", levels,
                          rows, base_walk, this_walk, False)
                walk_pair(f"{label}: base walk and cap_fold of "
                          f"{_WALK_LIMIT - _WALK_DEPTH} caps against this "
                          f"walk with them", levels, rows, base_walk,
                          this_walk, True)
                for w in _WALK_THREADS:
                    walk_pair(f"{label}: this against {w} threads a block, "
                              f"caps", levels, rows, this_walk,
                              (fns[f"w{w}_path_update"], True), True)
            del levels, walk_rows
        if "affine" in chosen:
            for field, n in _AFFINE_LANES:
                what = f"affine {'Fp' if field == 1 else 'Fp2'}, {n} lanes"
                for m in (0, 1, 2):
                    pair(f"mode {m} {what}: base against this",
                         lambda m=m, field=field, n=n: affine(
                             fns[f"base_affine{m}"], field, n),
                         lambda m=m, field=field, n=n: affine(
                             fns[f"this_affine{m}"], field, n), field_err)
            for field, n in _AFFINE_LANES + ((2, 10240),):
                what = f"affine {'Fp' if field == 1 else 'Fp2'}, {n} lanes"
                for w in _AFFINE_THREADS:
                    pair(f"mode 0 {what}: this against {w} threads a block",
                         lambda field=field, n=n: affine(
                             fns["this_affine0"], field, n),
                         lambda field=field, n=n, w=w: affine(
                             fns[f"w{w}_affine"], field, n), field_err)
        if "g2_sum" in chosen:
            for m in (0, 1, 2):
                pair(f"mode {m} g2_sum, 10240 points: base against this",
                     lambda m=m: g2_sum(fns[f"base_g2_sum{m}"], 10240,
                                        False),
                     lambda m=m: g2_sum(fns[f"this_g2_sum{m}"], 10240,
                                        True),
                     g2_projective_err)
            for n in _SUM_SWEEP:
                pair(f"mode 0 g2_sum, {n} points: base against this",
                     lambda n=n: g2_sum(fns["base_g2_sum0"], n,
                                        False),
                     lambda n=n: g2_sum(fns["this_g2_sum0"], n,
                                        True),
                     g2_projective_err)
        if "miller_loop" in chosen:
            p129 = [c[:129] for c in pairs]
            for m in (0, 1, 2):
                pair(f"mode {m} miller_loop, 129 pairs (one masked): base "
                     f"against this",
                     lambda m=m: miller(fns[f"base_miller_loop{m}"], p129,
                                        one_masked),
                     lambda m=m: miller(fns[f"this_miller_loop{m}"], p129,
                                        one_masked),
                     field_err)
            n = _MILLER_PAIRS
            for n_live in _MILLER_LIVE:
                mask = np.zeros(n, np.int32)
                mask[:n_live - 1] = mask[-1] = 1
                live = np.flatnonzero(mask)
                mask = torch.from_numpy(mask).cuda()
                pair(f"mode 0 miller_loop, {n} pairs, {n_live} live: a "
                     f"thread a pair on all against a block a pair on the "
                     f"live",
                     lambda mask=mask: miller(fns["one_thread"],
                                              [c[:n] for c in pairs], mask),
                     lambda live=live: miller_live(fns["cooperative"], n,
                                                   live),
                     field_err)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
