"""SSZ merkleization: hash_tree_root (tree_hash crate equivalent).

The host path uses hashlib; the bulk path for large arrays lives in
lighthouse_tpu_torch.ops.sha256 (CUDA hash-tree kernels) and is selected by
the array-backed BeaconState (see consensus/types/src/beacon_state.rs:2031
`update_tree_hash_cache` in the reference for the cached-tree-hash design).
"""
from __future__ import annotations

from typing import Any

from ..utils.hash import ZERO_HASHES, hash_concat, sha256
from .codec import serialize
from .types import (
    SSZType, Boolean, UInt, ByteVector, ByteList, Bitvector, Bitlist,
    Vector, List, Container, Union, UnionValue,
)

BYTES_PER_CHUNK = 32


def next_pow_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pack_bytes(data: bytes) -> list[bytes]:
    """Right-pad to a multiple of 32 and split into chunks."""
    if not data:
        return []
    pad = (-len(data)) % BYTES_PER_CHUNK
    data = data + b"\x00" * pad
    return [data[i:i + 32] for i in range(0, len(data), 32)]


def merkleize_chunks(chunks: list[bytes], limit: int | None = None) -> bytes:
    """Merkleize chunks into a single root, padding with zero subtrees.

    ``limit`` is the maximum chunk count (defines tree depth for Lists).
    Host-side (hashlib); the big state columns go to the device kernels
    (ops/merkle_tree) instead.
    """
    count = len(chunks)
    if limit is None:
        limit = next_pow_of_two(count)
    if count > limit:
        raise ValueError("chunk count exceeds limit")
    depth = max(0, (limit - 1).bit_length())
    if count == 0:
        return ZERO_HASHES[depth]
    nodes = list(chunks)
    for d in range(depth):
        if len(nodes) % 2:
            nodes.append(ZERO_HASHES[d])
        nodes = [hash_concat(nodes[i], nodes[i + 1])
                 for i in range(0, len(nodes), 2)]
    return nodes[0]


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_concat(root, length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash_concat(root, selector.to_bytes(32, "little"))


def chunk_count(typ: SSZType) -> int:
    if isinstance(typ, (Boolean, UInt)):
        return 1
    if isinstance(typ, ByteVector):
        return (typ.length + 31) // 32
    if isinstance(typ, ByteList):
        return (typ.limit + 31) // 32
    if isinstance(typ, Bitvector):
        return (typ.length + 255) // 256
    if isinstance(typ, Bitlist):
        return (typ.limit + 255) // 256
    if isinstance(typ, Vector):
        if isinstance(typ.elem, (Boolean, UInt)):
            from .codec import fixed_size
            return (typ.length * fixed_size(typ.elem) + 31) // 32
        return typ.length
    if isinstance(typ, List):
        if isinstance(typ.elem, (Boolean, UInt)):
            from .codec import fixed_size
            return (typ.limit * fixed_size(typ.elem) + 31) // 32
        return typ.limit
    if isinstance(typ, Container):
        return len(typ.fields)
    raise TypeError(f"no chunk count for {typ!r}")


def _bits_to_chunk_bytes(bits) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def hash_tree_root(typ: SSZType, value: Any) -> bytes:
    if isinstance(typ, (Boolean, UInt)):
        return serialize(typ, value).ljust(32, b"\x00")
    if isinstance(typ, ByteVector):
        return merkleize_chunks(pack_bytes(bytes(value)), chunk_count(typ))
    if isinstance(typ, ByteList):
        root = merkleize_chunks(pack_bytes(bytes(value)), chunk_count(typ))
        return mix_in_length(root, len(value))
    if isinstance(typ, Bitvector):
        return merkleize_chunks(
            pack_bytes(_bits_to_chunk_bytes(value)), chunk_count(typ))
    if isinstance(typ, Bitlist):
        root = merkleize_chunks(
            pack_bytes(_bits_to_chunk_bytes(value)), chunk_count(typ))
        return mix_in_length(root, len(value))
    if isinstance(typ, Vector):
        if isinstance(typ.elem, (Boolean, UInt)):
            data = b"".join(serialize(typ.elem, v) for v in value)
            return merkleize_chunks(pack_bytes(data), chunk_count(typ))
        roots = [hash_tree_root(typ.elem, v) for v in value]
        return merkleize_chunks(roots, typ.length)
    if isinstance(typ, List):
        if isinstance(typ.elem, (Boolean, UInt)):
            data = b"".join(serialize(typ.elem, v) for v in value)
            root = merkleize_chunks(pack_bytes(data), chunk_count(typ))
        else:
            roots = [hash_tree_root(typ.elem, v) for v in value]
            root = merkleize_chunks(roots, typ.limit)
        return mix_in_length(root, len(value))
    if isinstance(typ, Container):
        # Array-backed containers (e.g. the SoA BeaconState) can provide
        # their own accelerated root.
        custom = getattr(value, "__custom_hash_tree_root__", None)
        if custom is not None:
            return custom()
        roots = [hash_tree_root(t, getattr(value, n)) for n, t in typ.fields]
        return merkleize_chunks(roots, next_pow_of_two(len(roots)))
    if isinstance(typ, Union):
        assert isinstance(value, UnionValue)
        opt = typ.options[value.selector]
        root = b"\x00" * 32 if opt is None else hash_tree_root(opt, value.value)
        return mix_in_selector(root, value.selector)
    raise TypeError(f"cannot hash {typ!r}")


def htr(value: Any) -> bytes:
    """hash_tree_root of a @container dataclass instance."""
    return hash_tree_root(type(value).ssz_type, value)
