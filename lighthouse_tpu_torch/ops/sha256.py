"""Batched SHA-256 and merkle hashing on the card.

The port of the JAX package's ``lighthouse_tpu/ops/sha256.py``, with the
same public names and layouts: a batch of hash states is ``u32[N, 8]``, a
batch of 64-byte message blocks ``u32[N, 16]``, both as big-endian words
(``chunks_to_words``). On the device the words are ``torch.int32`` tensors
holding the bit patterns of the ``u32`` words (PyTorch's CPU build has no
``add`` or ``>>`` for ``torch.uint32``); the CUDA kernels read the same
memory as ``uint32_t``. At the host boundary, ``words_to_tensor`` and
``tensor_to_words`` convert with ``.view(np.int32)``/``.view(np.uint32)``.

Kernels (csrc/, bound in kernels.py), each with its plain PyTorch version
beside it:

- ``hash64``: SHA-256 of 64-byte blocks (``hash64.cu``).
- ``cap_fold`` (under ``cap_root``): the serial zero-subtree cap fold
  (``cap_fold.cu``), its caps from the table built into the library,
  ``csrc/zero_hashes.cuh`` (``render_zero_hashes``); ``DeviceTree.update``
  folds them inside its walk instead (``path_update.cu``). The function
  ``cap_fold`` is the JAX-shaped fold of explicit caps, on the CPU.
- ``sha256_messages``: SHA-256 of pre-padded equal-length messages
  (``sha256_messages.cu``); ``pad_messages`` pads on the host, as in JAX.

A wrapper launches its CUDA kernel for a CUDA tensor, takes the plain version
for a CPU tensor, and raises on anything else: it never falls back.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..device import resolve
from ..obs.roofline import tracked

_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

_IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

#: Padding block for a 64-byte message: 0x80 then zeros then bit-length 512.
_PAD64 = (0x80000000,) + (0,) * 14 + (512,)

_M32 = 0xFFFFFFFF

#: 32-bit integer operations of SHA-256 as csrc/sha256.cuh issues them on
#: Hopper, counted for a lower bound at the INT32 rate (64 lanes/SM/clock):
#: only the ops that issue on the integer ALU pipe alone, the funnel-shift
#: rotates and shifts (SHF) and three-input logic (LOP3). A round has 10
#: (Sigma1 and Sigma0: three SHF and one LOP3 each; ch and maj one LOP3
#: each), a schedule word 8 (sigma0 and sigma1: two rotates, a shift and a
#: LOP3 each). The adds (four IADD3 a round, two a schedule word, eight in
#: the feed-forward; 360 a compression with its schedule, 264 without)
#: may issue as IMAD on the FMA pipe beside them, and all the ops together
#: (2,288 a hash64) over the SM's issue rate (four schedulers x 32 lanes a
#: clock) take less than the ALU-only ops over 64 lanes: so the ALU-only
#: count is the bound. A compression with its schedule: 64 x 10 + 48 x 8 =
#: 1,024; the second of hash64 (constant padding block, schedule folded
#: away): 640.
SHA256_COMPRESS_INT_OPS = 64 * 10 + 48 * 8
HASH64_INT_OPS = SHA256_COMPRESS_INT_OPS + 64 * 10


# -- host <-> device words ----------------------------------------------------

def chunks_to_words(data: bytes | np.ndarray) -> np.ndarray:
    """32-byte chunks -> u32[N, 8] big-endian words."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(data, dtype=">u4")
    else:
        arr = data.view(">u4")
    return arr.astype(np.uint32).reshape(-1, 8)


def words_to_chunks(words: np.ndarray) -> bytes:
    return np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()


def words_to_tensor(words, device=None) -> torch.Tensor:
    """u32 words (numpy, or an int32 tensor) -> int32 tensor on ``device``
    (None: the port's default device). Numpy words are always copied, so
    the tensor never aliases the caller's array."""
    dev = resolve(device)
    if isinstance(words, torch.Tensor):
        if words.dtype != torch.int32:
            raise TypeError(f"word tensors are int32, got {words.dtype}")
        return words.to(dev).contiguous()
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    if not arr.flags.writeable:        # torch.from_numpy wants writable
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.clone() if dev.type == "cpu" else t.to(dev)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> u32 numpy words (one device-to-host read)."""
    return t.detach().cpu().numpy().view(np.uint32)


def root_bytes(root_words: torch.Tensor) -> bytes:
    """The 32-byte root of a u32[8] word tensor: the one readback a root
    takes."""
    return words_to_chunks(tensor_to_words(root_words))


def _zero_hash_words(max_depth: int = 64) -> np.ndarray:
    from ..utils.hash import ZERO_HASHES
    return np.stack([chunks_to_words(z)[0] for z in ZERO_HASHES[:max_depth]])


ZERO_HASH_WORDS = _zero_hash_words()


def render_zero_hashes() -> str:
    """``csrc/zero_hashes.cuh``: ``ZERO_HASH_WORDS`` as a table built into
    the kernels' libraries, and the cap fold that reads it
    (tests/test_torch_sha256.py holds the file to this). Regenerate with

        python -m lighthouse_tpu_torch.ops.sha256 > \\
            lighthouse_tpu_torch/csrc/zero_hashes.cuh
    """
    rows = ",\n".join("    {" + ", ".join(f"0x{int(w):08x}u" for w in row)
                      + "}" for row in ZERO_HASH_WORDS)
    return f"""// Generated by lighthouse_tpu_torch/ops/sha256.py render_zero_hashes();
// do not edit. The roots of the all-zero subtrees of depth 0..63 as
// big-endian u32 words (ops/sha256.py ZERO_HASH_WORDS), a table built
// into the library, and the zero-subtree cap fold that reads it.
#pragma once
#include "sha256.cuh"

#define LHSHA_ZERO_DEPTHS {ZERO_HASH_WORDS.shape[0]}
// where the table lives: global memory, read through the cache (in the
// constant bank the chain ran ~10 % slower on an H100: compare_kernels)
#define LHSHA_ZERO_SPACE __device__ const

LHSHA_ZERO_SPACE uint32_t LHSHA_ZERO_HASHES[LHSHA_ZERO_DEPTHS][8] = {{
{rows}}};

namespace lhsha {{

// r = hash64(r || zero_hash[d]) for d = from .. to - 1, in order: one
// thread's serial chain, each cap's 8 words from the table, the next
// cap's loaded while the current one hashes
__device__ __forceinline__ void fold_zero_caps(uint32_t r[8], int from,
                                               int to) {{
  uint32_t z[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    z[j] = from < to ? LHSHA_ZERO_HASHES[from][j] : 0u;
#pragma unroll 1
  for (int d = from; d < to; ++d) {{
    uint32_t m[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {{
      m[j] = r[j];
      m[8 + j] = z[j];
    }}
    const int nx = d + 1 < to ? d + 1 : d;
#pragma unroll
    for (int j = 0; j < 8; ++j) z[j] = LHSHA_ZERO_HASHES[nx][j];
    hash64(m, r);
  }}
}}

// out = root with the caps from .. to - 1 folded in (one thread): the cap
// fold of cap_fold.cu and of the walk's root (path_update.cu), out of
// line, so a kernel's own loops keep their code
__device__ __noinline__ void cap_root(const uint32_t* root, int from,
                                      int to, uint32_t* out) {{
  uint32_t r[8];
  load8(root, r);
  fold_zero_caps(r, from, to);
  store8(out, r);
}}

}}  // namespace lhsha
"""


# -- plain versions (int64 arithmetic masked to 32 bits) -----------------------

def _u64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """Values in [0, 2^32) -> the int32 tensor of the same bit patterns."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _big_sigma(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3) for x in [0, 2^32): the
    rotations are shifts of x doubled into 64 bits."""
    d = x | (x << 32)
    return ((d >> r1) ^ (d >> r2) ^ (d >> r3)) & _M32


def _small_sigma(x: torch.Tensor, r1: int, r2: int, s: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> s) for x in [0, 2^32)."""
    d = x | (x << 32)
    return (((d >> r1) ^ (d >> r2)) & _M32) ^ (x >> s)


def _schedule(w: list) -> list:
    """The 64 message-schedule words of a block (16 column tensors)."""
    w = list(w)
    for t in range(16, 64):
        w.append((w[t - 16] + _small_sigma(w[t - 15], 7, 18, 3) + w[t - 7]
                  + _small_sigma(w[t - 2], 17, 19, 10)) & _M32)
    return w


def _compress_plain(state: list, kw: list) -> list:
    """One compression over a list of 8 int64 column tensors; ``kw[t]`` is
    K[t] + W[t] (a tensor, or an int for a constant block)."""
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        ch = g ^ (e & (f ^ g))
        t1 = h + _big_sigma(e, 6, 11, 25) + ch + kw[t]
        maj = (a & b) | (c & (a | b))
        a, b, c, d, e, f, g, h = (
            (t1 + _big_sigma(a, 2, 13, 22) + maj) & _M32, a, b, c,
            (d + t1) & _M32, e, f, g)
    return [(x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _pad_kw() -> list:
    """K[t] + W[t] of the constant padding block, as Python ints."""
    w = list(_PAD64)
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        s0 = ((x >> 7 | x << 25) ^ (x >> 18 | x << 14) ^ (x >> 3)) & _M32
        s1 = ((y >> 17 | y << 15) ^ (y >> 19 | y << 13) ^ (y >> 10)) & _M32
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    return [(k + x) & _M32 for k, x in zip(_K, w)]


_PAD_KW = _pad_kw()


#: at most this many blocks on the CPU run the formulas on Python integers,
#: a row at a time: a tensor op costs microseconds whatever its length,
#: and a block is ~6,000 of them (PyTorch: ~14 ms a call at any size up
#: to ~64 rows; Python integers: ~0.35 ms a row)
_INT_ROWS = 32


@functools.lru_cache(maxsize=1 << 14)
def _hash64_row_int(row: tuple) -> tuple:
    """One block's digest words by the formulas of ``_hash64_rounds`` on
    Python integers, remembered: the CPU runs (the tests) hash the same
    blocks over and over (a two-epoch harness chain's small trees: ~85 %
    of their rows repeat)."""
    w = _schedule([v & _M32 for v in row])
    state = _compress_plain(list(_IV), [wt + k for wt, k in zip(w, _K)])
    return tuple(_compress_plain(state, _PAD_KW))


def _hash64_rows_int(x: torch.Tensor) -> torch.Tensor:
    """``_hash64_rounds`` of the int32 [R, 16] rows of a few blocks on the
    CPU, a row at a time on Python integers."""
    out = [_hash64_row_int(tuple(row)) for row in x.tolist()]
    return _i32(torch.tensor(out, dtype=torch.int64).reshape(-1, 8))


def _hash64_rounds(blocks: torch.Tensor) -> torch.Tensor:
    lead = blocks.shape[:-1]
    if blocks.device.type == "cpu" and blocks.numel() <= 16 * _INT_ROWS:
        return _hash64_rows_int(blocks.reshape(-1, 16)).reshape(*lead, 8)
    x = _u64(blocks.reshape(-1, 16))
    w = _schedule([x[:, i] for i in range(16)])
    state = [torch.full((x.shape[0],), v, dtype=torch.int64, device=x.device)
             for v in _IV]
    state = _compress_plain(state, [wt + k for wt, k in zip(w, _K)])
    state = _compress_plain(state, _PAD_KW)
    return _i32(torch.stack(state, dim=-1)).reshape(*lead, 8)


# The plain versions run their thousands of small tensor ops under
# inference_mode, which skips the autograd dispatch (a third of each op's
# cost on the CPU), and clone the result out of it: a caller may write the
# result in place (DeviceTree levels), which an inference tensor refuses.

def _hash64_plain(blocks: torch.Tensor) -> torch.Tensor:
    """Plain version of the hash64 kernel: int32 [..., 16] -> [..., 8]."""
    with torch.inference_mode():
        out = _hash64_rounds(blocks)
    return out.clone()


def _sha256_messages_plain(msgs: torch.Tensor) -> torch.Tensor:
    """Plain version of the sha256_messages kernel: int32 [N, B, 16] ->
    [N, 8], B compressions from the IV."""
    with torch.inference_mode():
        x = _u64(msgs)
        state = [torch.full((x.shape[0],), v, dtype=torch.int64,
                            device=x.device) for v in _IV]
        for b in range(x.shape[1]):
            w = _schedule([x[:, b, i] for i in range(16)])
            state = _compress_plain(state, [wt + k for wt, k in zip(w, _K)])
        out = _i32(torch.stack(state, dim=-1).reshape(x.shape[0], 8))
    return out.clone()


def _cap_fold_plain(root: torch.Tensor, zeros: torch.Tensor) -> torch.Tensor:
    """Plain version of the cap_fold kernel."""
    with torch.inference_mode():
        r = root
        for d in range(zeros.shape[0]):
            r = _hash64_rounds(torch.cat([r, zeros[d]])[None])[0]
    return r.clone()


@functools.lru_cache(maxsize=1024)
def _cap_fold_cpu(root: bytes, zeros: bytes) -> bytes:
    """The plain cap fold, remembered: a CPU run (the tests) folds the same
    roots with the same caps many times over (equal columns, equal states
    across presets), and each fold is tens of serial plain hashes."""
    words = torch.frombuffer(bytearray(root + zeros), dtype=torch.int32)
    out = _cap_fold_plain(words[:8], words[8:].reshape(-1, 8))
    return out.numpy().tobytes()


# -- wrappers ------------------------------------------------------------------

def _check_words(t: torch.Tensor, last: int, name: str) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name}: expected an int32 word tensor")
    if t.ndim < 1 or t.shape[-1] != last:
        raise ValueError(f"{name}: expected shape [..., {last}], "
                         f"got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.type == "cuda":
        if not t.is_contiguous():
            raise ValueError(f"{name}: CUDA input must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: CUDA input must be 16-byte aligned")


def _hash64_cost(out, blocks):
    """Each 64-byte block read, each 32-byte digest written; two
    compressions a block."""
    n = blocks.numel() // 16
    return n * (64 + 32), n * HASH64_INT_OPS


@tracked("hash64", _hash64_cost)
def hash64(blocks: torch.Tensor) -> torch.Tensor:
    """SHA-256 of 64-byte messages: int32 words [..., 16] -> [..., 8].

    Two compressions: data block, then the constant length-padding block.
    This is the merkle node combiner hash(left || right)."""
    _check_words(blocks, 16, "hash64")
    if blocks.device.type == "cpu":
        return _hash64_plain(blocks)
    out = torch.empty(blocks.shape[:-1] + (8,), dtype=torch.int32,
                      device=blocks.device)
    n = blocks.numel() // 16
    if n:
        kernels.HASH64.launch(blocks.data_ptr(), out.data_ptr(), n,
                              kernels.stream_ptr(blocks.device))
    return out


def cap_fold(root: torch.Tensor, zeros: torch.Tensor) -> torch.Tensor:
    """Fold ``root`` (u32[8]) with zero-subtree roots ``zeros`` (u32[K, 8]):
    r = hash64(r || zeros[i]) for i in order. The JAX-shaped fold of
    explicit caps, CPU tensors only: on the card the caps come from the
    kernel's built-in table (``cap_root``)."""
    _check_words(root, 8, "cap_fold")
    _check_words(zeros, 8, "cap_fold")
    if root.shape != (8,) or zeros.ndim != 2:
        raise ValueError("cap_fold: expected root [8] and zeros [K, 8]")
    if root.device.type != "cpu" or zeros.device.type != "cpu":
        raise ValueError("cap_fold: takes CPU tensors; on the card "
                         "cap_root folds the caps from the kernel's table")
    got = _cap_fold_cpu(root.numpy().tobytes(), zeros.numpy().tobytes())
    return torch.frombuffer(bytearray(got), dtype=torch.int32)


def _sha256_messages_cost(out, msgs):
    """Each padded block read, each digest written; a compression a
    block."""
    n, nblocks = int(msgs.shape[0]), int(msgs.shape[1])
    return n * (nblocks * 64 + 32), n * nblocks * SHA256_COMPRESS_INT_OPS


@tracked("sha256_messages", _sha256_messages_cost)
def sha256_messages(msgs: torch.Tensor) -> torch.Tensor:
    """SHA-256 of a batch of equal-length padded messages: int32 words
    [N, B, 16] (``pad_messages``) -> [N, 8]."""
    _check_words(msgs, 16, "sha256_messages")
    if msgs.ndim != 3:
        raise ValueError(f"sha256_messages: expected [N, B, 16], got "
                         f"{tuple(msgs.shape)}")
    if msgs.device.type == "cpu":
        return _sha256_messages_plain(msgs)
    n, nblocks = int(msgs.shape[0]), int(msgs.shape[1])
    out = torch.empty((n, 8), dtype=torch.int32, device=msgs.device)
    if n:
        kernels.SHA256_MESSAGES.launch(msgs.data_ptr(), out.data_ptr(), n,
                                       nblocks,
                                       kernels.stream_ptr(msgs.device))
    return out


def pad_messages(msgs: np.ndarray) -> np.ndarray:
    """Pad a batch of equal-length byte messages u8[N, L] to u32[N, B, 16]
    (FIPS 180-4: 0x80, zeros, the 64-bit big-endian bit length)."""
    n, length = msgs.shape
    bit_len = length * 8
    total = ((length + 9 + 63) // 64) * 64
    out = np.zeros((n, total), dtype=np.uint8)
    out[:, :length] = msgs
    out[:, length] = 0x80
    out[:, -8:] = np.frombuffer(
        np.uint64(bit_len).byteswap().tobytes(), dtype=np.uint8)
    words = out.reshape(n, total // 64, 16, 4).view(">u4")[..., 0]
    return words.astype(np.uint32)


def hash_pairs(nodes: torch.Tensor) -> torch.Tensor:
    """Merkle level step: u32[2N, 8] -> u32[N, 8] (hash of adjacent pairs)."""
    return hash64(nodes.reshape(nodes.shape[0] // 2, 16))


def merkleize_dense(leaves: torch.Tensor, depth: int) -> torch.Tensor:
    """Merkleize u32[2**depth, 8] chunk leaves into a root u32[8]: one
    hash64 launch per level."""
    nodes = leaves
    for _ in range(depth):
        nodes = hash_pairs(nodes)
    return nodes[0]


def _cap_root_cost(out, root, dense_depth, limit_depth):
    """The root and its caps read, the capped root written; a hash a
    cap."""
    caps = limit_depth - dense_depth
    return (1 + caps) * 32 + 32, caps * HASH64_INT_OPS


@tracked("cap_fold", _cap_root_cost)
def cap_root(root: torch.Tensor, dense_depth: int,
             limit_depth: int) -> torch.Tensor:
    """``root`` (u32[8]) with the zero-subtree caps dense_depth ..
    limit_depth - 1 folded in, into a new tensor (a copy of the root when
    there are none). On the card one ``cap_fold`` launch reads the caps
    from its built-in table (nothing is copied to the card); on the CPU
    the plain fold."""
    _check_words(root, 8, "cap_root")
    if root.shape != (8,):
        raise ValueError("cap_root: expected a root [8]")
    if not 0 <= dense_depth <= limit_depth <= ZERO_HASH_WORDS.shape[0]:
        raise ValueError(f"cap_root: depths {dense_depth}, {limit_depth} "
                         f"out of range")
    if root.device.type == "cpu":
        return cap_fold(root.contiguous(), torch.from_numpy(
            ZERO_HASH_WORDS[dense_depth:limit_depth].view(np.int32)))
    if dense_depth == limit_depth:
        return root.clone()
    out = torch.empty(8, dtype=torch.int32, device=root.device)
    kernels.CAP_FOLD.launch(root.data_ptr(), dense_depth, limit_depth,
                            out.data_ptr(), kernels.stream_ptr(root.device))
    return out


def merkleize_words(leaf_words, limit: int, device=None) -> torch.Tensor:
    """Merkleize N chunk-leaves (u32[N,8]: numpy words or an int32 tensor)
    under a virtual tree of ``limit`` leaves: dense-hash the padded live
    subtree, then fold in zero-subtree caps. Returns the root as an int32
    u32[8] tensor on the device (``device``, else the tensor's own, else
    the port's default)."""
    if device is None and isinstance(leaf_words, torch.Tensor):
        device = leaf_words.device
    dev = resolve(device)
    n = int(leaf_words.shape[0])
    limit_depth = max(0, (limit - 1).bit_length())
    if n == 0:
        return words_to_tensor(ZERO_HASH_WORDS[limit_depth], dev)
    dense = 1 if n <= 1 else 1 << (n - 1).bit_length()
    dense_depth = (dense - 1).bit_length()
    leaves = words_to_tensor(leaf_words, dev)
    if dense != n:
        pad = torch.zeros((dense - n, 8), dtype=torch.int32, device=dev)
        leaves = torch.cat([leaves, pad])
    return cap_root(merkleize_dense(leaves, dense_depth), dense_depth,
                    limit_depth)


def mix_in_length_words(root: torch.Tensor, length: int) -> torch.Tensor:
    """hash(root || length as a little-endian 32-byte chunk), on device."""
    length_words = chunks_to_words(int(length).to_bytes(32, "little"))[0]
    block = torch.cat([root, words_to_tensor(length_words, root.device)])
    return hash64(block[None])[0]


if __name__ == "__main__":
    print(render_zero_hashes(), end="")
