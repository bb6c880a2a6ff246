"""KZG polynomial commitments for EIP-4844 blobs and EIP-7594 cells.

Equivalent of the reference's crypto/kzg (wrapper over c-kzg): blob ->
commitment, opening proofs, single + batch verification — implemented on our
own BLS12-381 (pairing check e(proof, [tau - z]_2) == e(C - [y]_1, g_2)) —
plus the PeerDAS cells surface (compute_cells_and_kzg_proofs /
verify_cell_kzg_proof_batch / recover_cells_and_kzg_proofs): the blob's
polynomial is Reed-Solomon extended to a 2n-point evaluation domain split
into cosets ("cells"), each cell carrying a KZG multi-point opening proof,
and any half of the cells recovers the rest (c-kzg `Cell`,
crypto/kzg/src/lib.rs:31 CELLS_PER_EXT_BLOB).

Group arithmetic rides the native C++ host library (native/bls12_381.cpp
`kzg_g1_msm` / `kzg_pairing_check` / `kzg_g1_mul`, the c-kzg equivalent),
the one `crypto.bls.cpp_backend.get_lib()` builds. A library that does
not build or lacks the KZG exports raises: nothing falls back to the
pure-Python curve. The pure-Python group arithmetic stays as the plain
versions (`_msm_plain`, `_pairing_is_one_plain`, `devnet_setup_plain`)
that the tests hold the native path against.

Trusted setup: the real ceremony file is not bundled (zero-egress image); a
deterministic DEVNET setup derived from a public seed is generated on first
use and is clearly INSECURE-FOR-PRODUCTION (anyone can recover tau). Load a
real setup by constructing `Kzg(g1_points, tau_g2, g2_powers=...)`.
"""
from __future__ import annotations

import hashlib

from .bls12_381 import (
    G1_GENERATOR, G2_GENERATOR, g1_compress, g1_decompress, g2_compress,
    multi_pairing,
)
from .bls12_381.curve import B_G1, Point
from .bls12_381.fields import R
from ..specs.constants import BYTES_PER_FIELD_ELEMENT  # single source of truth

FIELD_ELEMENTS_PER_BLOB = 4096
#: spec cell count over the 2x-extended blob (CELLS_PER_EXT_BLOB); clamped
#: to the extended domain size for small devnet setups
CELLS_PER_EXT_BLOB = 128

#: primitive root of unity of order 4096 in the scalar field
_ROOT_OF_UNITY = pow(7, (R - 1) // FIELD_ELEMENTS_PER_BLOB, R)

_G1_GEN_COMP = g1_compress(G1_GENERATOR)


class KzgError(Exception):
    pass


_NATIVE = None

#: the devnet setup's secret: INSECURE, derived from a fixed public seed
_DEVNET_TAU = int.from_bytes(hashlib.sha256(
    b"lighthouse-tpu-devnet-kzg-setup").digest(), "big") % R


def _native():
    """The C++ host library with its KZG exports. Raises where it does
    not build or lacks them (no pure-Python fallback)."""
    global _NATIVE
    if _NATIVE is None:
        from .bls.cpp_backend import get_lib
        lib = get_lib()
        for name in ("kzg_g1_msm", "kzg_pairing_check", "kzg_g1_mul"):
            if not hasattr(lib, name):
                raise RuntimeError(
                    f"the bls12_381 host library lacks {name}")
        _NATIVE = lib
    return _NATIVE


def _msm(scalars: list[int], points_comp: list[bytes]) -> Point:
    """sum scalars[i] * decompress(points_comp[i]) on the C++ library.
    A point that does not decode, or a sum off the subgroup, raises
    KzgError, as the plain version does on such a point."""
    import ctypes
    pairs = [(s % R, p) for s, p in zip(scalars, points_comp) if s % R]
    if not pairs:
        return Point.infinity(B_G1)
    sc = b"".join(s.to_bytes(32, "big") for s, _ in pairs)
    pts = b"".join(bytes(p) for _, p in pairs)
    out = ctypes.create_string_buffer(48)
    if _native().kzg_g1_msm(len(pairs), sc, pts, out) != 0:
        raise KzgError("bad point in MSM")
    res = g1_decompress(out.raw)
    if res is None:
        raise KzgError("bad point in MSM")
    return res


def _msm_plain(scalars: list[int], points_comp: list[bytes]) -> Point:
    """The plain version of `_msm` on the pure-Python curve."""
    acc = Point.infinity(B_G1)
    for s, p in zip(scalars, points_comp):
        if s % R == 0:
            continue
        pt = g1_decompress(p)
        if pt is None:
            raise KzgError("bad point in MSM")
        acc = acc.add(pt.mul(s % R))
    return acc


def _pairing_is_one(pairs: list[tuple[Point, Point]]) -> bool:
    """prod e(a_i, b_i) == 1 on the C++ library's multi-pairing. A point
    off its subgroup fails the check."""
    g1s = b"".join(g1_compress(a) for a, _ in pairs)
    g2s = b"".join(g2_compress(b) for _, b in pairs)
    return _native().kzg_pairing_check(len(pairs), g1s, g2s) == 1


def _pairing_is_one_plain(pairs: list[tuple[Point, Point]]) -> bool:
    """The plain version of `_pairing_is_one` on the pure-Python curve."""
    return multi_pairing(pairs).is_one()


def _devnet_g1_comp(size: int, threads: int = 8) -> list[bytes]:
    """[tau^i]_1 compressed, i < size, on the C++ library (a scalar
    multiplication of the generator each; ranges of i on ``threads``
    threads, the library's calls release the lock)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    lib = _native()

    def points(lo: int, hi: int) -> list[bytes]:
        out = ctypes.create_string_buffer(48)
        pts, t = [], pow(_DEVNET_TAU, lo, R)
        for _ in range(lo, hi):
            if lib.kzg_g1_mul(t.to_bytes(32, "big"), _G1_GEN_COMP,
                              out) != 0:
                raise KzgError("devnet setup: scalar multiplication failed")
            pts.append(out.raw)
            t = t * _DEVNET_TAU % R
        return pts

    step = max(1, -(-size // threads))
    with ThreadPoolExecutor(max_workers=threads) as pool:
        parts = pool.map(lambda lo: points(lo, min(size, lo + step)),
                         range(0, size, step))
        return [pt for part in parts for pt in part]


def devnet_setup_plain(size: int) -> list[Point]:
    """The plain version of the devnet setup's G1 points, on the
    pure-Python curve (the reference's construction)."""
    return [G1_GENERATOR.mul(pow(_DEVNET_TAU, i, R)) for i in range(size)]


class Kzg:
    """One instance per trusted setup (kzg::Kzg, crypto/kzg/src/lib.rs:55)."""

    def __init__(self, g1_points: list | None = None, tau_g2=None,
                 devnet_size: int = 64, g2_powers: list | None = None,
                 cells_per_ext_blob: int = CELLS_PER_EXT_BLOB):
        if g1_points is None:
            # INSECURE devnet setup: tau derived from a fixed public seed;
            # the points come compressed from the C++ library
            self.size = devnet_size
            self._g1 = None
            self._g1_comp = _devnet_g1_comp(self.size)
            self.tau_g2 = G2_GENERATOR.mul(_DEVNET_TAU)
            self.insecure = True
            self._tau = _DEVNET_TAU
        else:
            self._g1 = list(g1_points)
            self._g1_comp = None
            self.size = len(g1_points)
            self.tau_g2 = tau_g2
            self.insecure = False
            self._tau = None
        #: [tau^i]_2 for the cells multi-point check (real ceremony files
        #: carry 65 G2 points); devnet derives what it needs from tau
        self.g2_powers = g2_powers
        self._cells_req = cells_per_ext_blob
        self._cells_cfg_cache = None
        self.domain = [pow(_ROOT_OF_UNITY, _brp(i, FIELD_ELEMENTS_PER_BLOB),
                           R) for i in range(self.size)]

    @property
    def g1(self) -> list[Point]:
        """The setup points, decompressed once on first use (the devnet
        setup's are multiples of the generator: no subgroup check)."""
        if self._g1 is None:
            self._g1 = [g1_decompress(p, subgroup_check=False)
                        for p in self._g1_comp]
        return self._g1

    @property
    def g1_comp(self) -> list[bytes]:
        """Compressed setup points (native-MSM operand), built once."""
        if self._g1_comp is None:
            self._g1_comp = [g1_compress(p) for p in self._g1]
        return self._g1_comp

    # -- polynomial helpers (evaluation form over the bit-reversed domain) ---

    def _evals_from_blob(self, blob: bytes) -> list[int]:
        n = len(blob) // BYTES_PER_FIELD_ELEMENT
        if n > self.size:
            raise KzgError(f"blob larger than setup ({n} > {self.size})")
        out = []
        for i in range(n):
            v = int.from_bytes(
                blob[i * 32:(i + 1) * 32], "big")
            if v >= R:
                raise KzgError("blob element not canonical")
            out.append(v)
        # pad to setup size with zeros
        out += [0] * (self.size - n)
        return out

    def _root(self) -> int:
        """Primitive root of order self.size (the domain subgroup)."""
        return pow(_ROOT_OF_UNITY, FIELD_ELEMENTS_PER_BLOB // self.size, R)

    def _ntt(self, vals: list[int], invert: bool) -> list[int]:
        return _ntt_with_root(vals, self._root(), invert)

    def _coeffs(self, evals: list[int]) -> list[int]:
        """Monomial coefficients from evaluations over the bit-reversed
        domain: un-permute (brp is an involution) then inverse NTT."""
        n = self.size
        std = [0] * n
        for i, v in enumerate(evals):
            std[_brp(i, n)] = v
        return self._ntt(std, invert=True)

    def _eval_barycentric(self, evals: list[int], z: int) -> int:
        """p(z) from evaluation form without interpolation (the spec's
        evaluate_polynomial_in_evaluation_form):
        p(z) = (z^n - 1)/n * sum_i evals_i * d_i / (z - d_i)."""
        n = self.size
        for i, d in enumerate(self.domain):
            if d == z % R:
                return evals[i]
        diffs = [(z - d) % R for d in self.domain]
        invs = _batch_inverse(diffs)
        acc = 0
        for e, d, inv in zip(evals, self.domain, invs):
            if e:
                acc = (acc + e * d % R * inv) % R
        zn = (pow(z, n, R) - 1) % R
        return acc * zn % R * pow(n, R - 2, R) % R

    def _commit_coeffs(self, coeffs: list[int]) -> Point:
        return _msm(list(coeffs), self.g1_comp[:len(coeffs)])

    # -- public API (c-kzg surface) ------------------------------------------

    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        return g1_compress(self._commit_coeffs(
            self._coeffs(self._evals_from_blob(blob))))

    def compute_kzg_proof(self, blob: bytes, z: int) -> tuple[bytes, int]:
        """Proof that p(z) == y; returns (proof, y)."""
        coeffs = self._coeffs(self._evals_from_blob(blob))
        y = _poly_eval(coeffs, z)
        # q(x) = (p(x) - y) / (x - z)
        q = _poly_div_linear(coeffs, y, z)
        return g1_compress(self._commit_coeffs(q)), y

    def verify_kzg_proof(self, commitment: bytes, z: int, y: int,
                         proof: bytes) -> bool:
        c = g1_decompress(commitment)
        w = g1_decompress(proof)
        if c is None or w is None:
            return False
        # e(W, [tau]_2 - [z]_2) == e(C - [y]_1, g2), rearranged so all the
        # per-proof arithmetic stays in G1:
        #   e(W, [tau]_2) * e(-z*W - C + y*G, g2) == 1
        x = _msm([(-z) % R, R - 1, y % R],
                 [bytes(proof), bytes(commitment), _G1_GEN_COMP])
        return _pairing_is_one([(w, self.tau_g2), (x, G2_GENERATOR)])

    def compute_blob_kzg_proof(self, blob: bytes,
                               commitment: bytes) -> bytes:
        z = _challenge(blob, commitment)
        proof, _y = self.compute_kzg_proof(blob, z)
        return proof

    def verify_blob_kzg_proof(self, blob: bytes, commitment: bytes,
                              proof: bytes) -> bool:
        z = _challenge(blob, commitment)
        y = self._eval_barycentric(self._evals_from_blob(blob), z)
        return self.verify_kzg_proof(commitment, z, y, proof)

    def verify_blob_kzg_proof_batch(self, blobs: list[bytes],
                                    commitments: list[bytes],
                                    proofs: list[bytes]) -> bool:
        """ONE 2-pairing check for the whole batch via a random linear
        combination (c-kzg verify_blob_kzg_proof_batch):
          e(sum r_i pi_i, [tau]_2) * e(-sum r_i (C_i - y_i G + z_i pi_i),
            g_2) == 1
        The deneb 6-blob sidecar batch costs the same two pairings as one
        blob."""
        import secrets
        if not (len(blobs) == len(commitments) == len(proofs)):
            return False
        if not blobs:
            return True
        # aggregate everything into two MSMs and one 2-pairing check
        scalars, points = [], []      # -> agg_rest = -sum r(C - yG + zW)
        pscalars, ppoints = [], []    # -> agg_proof = sum r*W
        y_gen = 0
        for blob, comm, prf in zip(blobs, commitments, proofs):
            # on-curve pre-check; the RLC aggregate is subgroup-checked
            # inside the pairing check
            if (g1_decompress(comm, subgroup_check=False) is None
                    or g1_decompress(prf, subgroup_check=False) is None):
                return False
            z = _challenge(blob, comm)
            y = self._eval_barycentric(self._evals_from_blob(blob), z)
            r = 1 if len(blobs) == 1 else secrets.randbits(128) | 1
            pscalars.append(r)
            ppoints.append(bytes(prf))
            scalars += [(-r) % R, (-r * z) % R]
            points += [bytes(comm), bytes(prf)]
            y_gen = (y_gen + r * y) % R
        scalars.append(y_gen)
        points.append(_G1_GEN_COMP)
        agg_proof = _msm(pscalars, ppoints)
        agg_rest = _msm(scalars, points)
        return _pairing_is_one([
            (agg_proof, self.tau_g2),
            (agg_rest, G2_GENERATOR),
        ])

    # -- EIP-7594 cells (PeerDAS; c-kzg compute/verify/recover_cells) --------

    def _cells_cfg(self):
        """Lazily derived extended-domain/coset structure.

        The polynomial (degree < n) is evaluated over the 2n-point
        extension domain, split in bit-reversal order into `cells` cosets
        of l = 2n/cells points each: cell i holds p on h_i*H where
        H = <w^cells> (order l) and h_i = w^brp(i, cells).
        """
        if self._cells_cfg_cache is not None:
            return self._cells_cfg_cache
        n = self.size
        ext = 2 * n
        cells = min(self._cells_req, ext)
        ell = ext // cells
        w = pow(7, (R - 1) // ext, R)        # root of order 2n
        h = [pow(w, _brp(i, cells), R) for i in range(cells)]
        # [tau^l]_2 for the multi-point check
        if self.g2_powers is not None:
            if len(self.g2_powers) <= ell:
                raise KzgError("trusted setup lacks [tau^l]_2")
            tau_l_g2 = self.g2_powers[ell]
        elif self._tau is not None:
            tau_l_g2 = G2_GENERATOR.mul(pow(self._tau, ell, R))
        else:
            raise KzgError("setup has no G2 powers for cell proofs")
        cfg = (ext, cells, ell, w, h, tau_l_g2)
        self._cells_cfg_cache = cfg
        return cfg

    @property
    def cells_per_ext_blob(self) -> int:
        return self._cells_cfg()[1]

    def _ext_evals_std(self, coeffs: list[int]) -> list[int]:
        ext, _, _, w, _, _ = self._cells_cfg()
        return _ntt_with_root(list(coeffs) + [0] * (ext - len(coeffs)),
                              w, invert=False)

    def _cells_from_coeffs(self, coeffs: list[int]) -> list[bytes]:
        _, cells, ell, _, _, _ = self._cells_cfg()
        ev = self._ext_evals_std(coeffs)
        out = []
        for i in range(cells):
            vals = [ev[_brp(j, ell) * cells + _brp(i, cells)]
                    for j in range(ell)]
            out.append(b"".join(v.to_bytes(32, "big") for v in vals))
        return out

    def _cell_values(self, cell: bytes) -> list[int]:
        _, _, ell, _, _, _ = self._cells_cfg()
        if len(cell) != 32 * ell:
            raise KzgError("bad cell size")
        vals = [int.from_bytes(cell[32 * j:32 * (j + 1)], "big")
                for j in range(ell)]
        if any(v >= R for v in vals):
            raise KzgError("cell element not canonical")
        return vals

    def _cell_interpolant(self, index: int, vals: list[int]) -> list[int]:
        """Coefficients (degree < l) of the cell's interpolant r_i:
        r_i(h_i * y) over H is a size-l inverse NTT, then unscale by
        h_i^-m."""
        _, cells, ell, w, h, _ = self._cells_cfg()
        if ell == 1:
            return [vals[0]]
        wl = pow(w, cells, R)                 # root of order l
        std = [0] * ell
        for k in range(ell):
            std[k] = vals[_brp(k, ell)]
        sc = _ntt_with_root(std, wl, invert=True)
        hinv = pow(h[index], R - 2, R)
        out, f = [], 1
        for m in range(ell):
            out.append(sc[m] * f % R)
            f = f * hinv % R
        return out

    def _cell_proof(self, coeffs: list[int], index: int,
                    r_coeffs: list[int]) -> bytes:
        """pi_i = [q_i(tau)]_1, q_i = (p - r_i) / (x^l - h_i^l)."""
        n, (_, _, ell, _, h, _) = self.size, self._cells_cfg()
        a = pow(h[index], ell, R)
        d = list(coeffs) + [0] * (n - len(coeffs))
        for m, rm in enumerate(r_coeffs):
            d[m] = (d[m] - rm) % R
        q = [0] * (n - ell)
        for k in range(n - ell - 1, -1, -1):
            t = d[k + ell]
            if k + ell < n - ell:
                t += a * q[k + ell]
            q[k] = t % R
        return g1_compress(self._commit_coeffs(q))

    def compute_cells(self, blob: bytes) -> list[bytes]:
        return self._cells_from_coeffs(
            self._coeffs(self._evals_from_blob(blob)))

    def compute_cells_and_kzg_proofs(
            self, blob: bytes) -> tuple[list[bytes], list[bytes]]:
        coeffs = self._coeffs(self._evals_from_blob(blob))
        return self._cells_and_proofs_from_coeffs(coeffs)

    def _cells_and_proofs_from_coeffs(self, coeffs):
        _, cells, ell, _, _, _ = self._cells_cfg()
        out_cells = self._cells_from_coeffs(coeffs)
        proofs = []
        for i in range(cells):
            r = self._cell_interpolant(i, self._cell_values(out_cells[i]))
            proofs.append(self._cell_proof(coeffs, i, r))
        return out_cells, proofs

    def verify_cell_kzg_proof_batch(self, commitments: list[bytes],
                                    cell_indices: list[int],
                                    cells: list[bytes],
                                    proofs: list[bytes]) -> bool:
        """ONE 2-pairing check for any mix of (commitment, cell) pairs via
        a random linear combination:
          e(sum r_i pi_i, [tau^l]_2)
            * e(sum r_i (-h_i^l pi_i + [interp_i(tau)]_1 - C_i), g2) == 1
        (per-cell: e(pi, [tau^l - h^l]_2) == e(C - [interp(tau)]_1, g2),
        rearranged so the aggregation stays in G1)."""
        import secrets
        if not (len(commitments) == len(cell_indices) == len(cells)
                == len(proofs)):
            return False
        if not cells:
            return True
        try:
            _, n_cells, ell, _, h, tau_l_g2 = self._cells_cfg()
            pscalars, ppoints = [], []     # sum r*pi
            scalars, points = [], []       # G1 side of the g2 pairing
            agg_interp = [0] * ell         # sum r * interp_i coefficients
            for comm, idx, cell, prf in zip(commitments, cell_indices,
                                            cells, proofs):
                if not (0 <= idx < n_cells):
                    return False
                # on-curve/format pre-check only: rogue-subgroup components
                # are caught w.h.p. by the subgroup check on the random
                # linear combination inside the pairing check
                if (g1_decompress(comm, subgroup_check=False) is None
                        or g1_decompress(prf, subgroup_check=False) is None):
                    return False
                vals = self._cell_values(bytes(cell))
                r_coeffs = self._cell_interpolant(idx, vals)
                rho = 1 if len(cells) == 1 else secrets.randbits(128) | 1
                a = pow(h[idx], ell, R)
                pscalars.append(rho)
                ppoints.append(bytes(prf))
                scalars += [(-rho * a) % R, (-rho) % R]
                points += [bytes(prf), bytes(comm)]
                for m in range(ell):
                    agg_interp[m] = (agg_interp[m] + rho * r_coeffs[m]) % R
            scalars += agg_interp
            points += self.g1_comp[:ell]
            return _pairing_is_one([
                (_msm(pscalars, ppoints), tau_l_g2),
                (_msm(scalars, points), G2_GENERATOR),
            ])
        except KzgError:
            return False

    def recover_cells_and_kzg_proofs(
            self, cell_indices: list[int],
            cells: list[bytes]) -> tuple[list[bytes], list[bytes]]:
        """Erasure-recover the full cell set (plus proofs) from any >= 50%
        of cells (spec recover_cells_and_kzg_proofs): multiply by the
        vanishing polynomial of the missing cosets, inverse-NTT, divide on
        a shifted domain, and re-extend."""
        coeffs = self.recover_polynomial_coeffs(cell_indices, cells)
        return self._cells_and_proofs_from_coeffs(coeffs)

    def recover_polynomial_coeffs(self, cell_indices: list[int],
                                  cells: list[bytes]) -> list[int]:
        ext, n_cells, ell, w, h, _ = self._cells_cfg()
        n = self.size
        known: dict[int, list[int]] = {}
        for idx, cell in zip(cell_indices, cells):
            if not (0 <= idx < n_cells):
                raise KzgError("cell index out of range")
            known[int(idx)] = self._cell_values(bytes(cell))
        if len(known) * ell < n:
            raise KzgError(
                f"need >= {n // ell} cells to recover, have {len(known)}")
        missing = [i for i in range(n_cells) if i not in known]
        if not missing:
            ev = [0] * ext
            for i, vals in known.items():
                for j in range(ell):
                    ev[_brp(j, ell) * n_cells + _brp(i, n_cells)] = vals[j]
            coeffs = _ntt_with_root(ev, w, invert=True)
        else:
            # vanishing polynomial of the missing cosets, as a polynomial
            # in u = x^l: Z(x) = prod (x^l - h_m^l)
            zu = [1]
            for m in missing:
                zu = _poly_mul_linear(zu, (-pow(h[m], ell, R)) % R)
            z_coeffs = [0] * ext
            for k, v in enumerate(zu):
                z_coeffs[k * ell] = v
            z_ev = _ntt_with_root(z_coeffs, w, invert=False)
            # (E*Z) over the extension domain: 0 on missing cosets
            ez = [0] * ext
            for i, vals in known.items():
                for j in range(ell):
                    k = _brp(j, ell) * n_cells + _brp(i, n_cells)
                    ez[k] = vals[j] * z_ev[k] % R
            ez_coeffs = _ntt_with_root(ez, w, invert=True)
            # divide (E*Z)/Z on a shifted domain (Z has no roots there)
            shift = 7
            sh_pow, f = [], 1
            for _ in range(ext):
                sh_pow.append(f)
                f = f * shift % R
            num = _ntt_with_root(
                [c * s % R for c, s in zip(ez_coeffs, sh_pow)], w, False)
            den = _ntt_with_root(
                [c * s % R for c, s in zip(z_coeffs, sh_pow)], w, False)
            quo = [a * b % R
                   for a, b in zip(num, _batch_inverse(den))]
            q_shift = _ntt_with_root(quo, w, invert=True)
            sinv = pow(shift, R - 2, R)
            coeffs, f = [], 1
            for c in q_shift:
                coeffs.append(c * f % R)
                f = f * sinv % R
        if any(coeffs[n:]):
            raise KzgError("inconsistent cells (recovered degree >= n)")
        return coeffs[:n]

    def cells_to_blob(self, cells: list[bytes]) -> bytes:
        """The original blob is exactly the first half of the extension in
        bit-reversal order."""
        _, n_cells, _, _, _, _ = self._cells_cfg()
        if len(cells) < n_cells // 2:
            raise KzgError("need the first half of the cells")
        return b"".join(bytes(c) for c in cells[:n_cells // 2])

    def recover_blob(self, cell_indices: list[int],
                     cells: list[bytes]) -> bytes:
        """Blob bytes from any >= 50% of cells WITHOUT recomputing the
        per-cell proofs (the cheap path for column reconstruction)."""
        coeffs = self.recover_polynomial_coeffs(cell_indices, cells)
        return self.cells_to_blob(self._cells_from_coeffs(coeffs))


def _ntt_with_root(vals: list[int], root: int, invert: bool) -> list[int]:
    """Iterative radix-2 NTT over standard order, root of order len(vals)
    (O(n log n))."""
    n = len(vals)
    a = list(vals)
    # bit-reversal permutation to start the butterflies
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    if invert:
        root = pow(root, R - 2, R)
    length = 2
    while length <= n:
        wlen = pow(root, n // length, R)
        for i in range(0, n, length):
            w = 1
            half = length // 2
            for k in range(i, i + half):
                u, v = a[k], a[k + half] * w % R
                a[k] = (u + v) % R
                a[k + half] = (u - v) % R
                w = w * wlen % R
        length <<= 1
    if invert:
        ninv = pow(n, R - 2, R)
        a = [x * ninv % R for x in a]
    return a


def _batch_inverse(vals: list[int]) -> list[int]:
    """Montgomery batch inversion: one field inversion for the lot."""
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % R
    inv = pow(prefix[-1], R - 2, R)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv % R
        inv = inv * vals[i] % R
    return out


def _brp(i: int, n: int) -> int:
    bits = n.bit_length() - 1
    return int(bin(i)[2:].zfill(bits)[::-1], 2)


def _poly_mul_linear(poly: list[int], c: int) -> list[int]:
    """poly(x) * (x + c) mod R."""
    out = [0] * (len(poly) + 1)
    for i, a in enumerate(poly):
        out[i] = (out[i] + a * c) % R
        out[i + 1] = (out[i + 1] + a) % R
    return out


def _poly_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def _poly_div_linear(coeffs: list[int], y: int, z: int) -> list[int]:
    """(p(x) - y) / (x - z) via synthetic division (exact when p(z) == y)."""
    n = len(coeffs)
    q = [0] * (n - 1)
    acc = 0
    for i in range(n - 1, 0, -1):
        acc = (coeffs[i] + z * acc) % R
        q[i - 1] = acc
    return q


def _challenge(blob: bytes, commitment: bytes) -> int:
    """Fiat-Shamir evaluation challenge (spec compute_challenge shape)."""
    h = hashlib.sha256(b"LHTPU_KZG_CHALLENGE" + len(blob).to_bytes(8, "little")
                       + blob + commitment).digest()
    return int.from_bytes(h, "big") % R
