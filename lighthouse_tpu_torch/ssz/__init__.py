"""SSZ: SimpleSerialize codec + merkleization.

Equivalent of the external `ethereum_ssz` + `tree_hash` crates used by the
reference (Cargo.toml:121-181 and consensus/types). Types are
first-class *objects* (not Python classes): ``uint64``, ``Vector(uint8, 32)``,
``List(Validator, 2**40)`` — a deliberately functional design so the
array-oriented BeaconState (containers/state.py) can map SSZ schemas onto
device arrays.
"""
from .types import (
    SSZType, Boolean, UInt, ByteVector, ByteList, Bitvector, Bitlist,
    Vector, List, Container, Union, container, field_types,
    boolean, uint8, uint16, uint32, uint64, uint128, uint256,
    Bytes4, Bytes8, Bytes20, Bytes32, Bytes48, Bytes96, Root,
    default_value,
)
from .codec import serialize, deserialize, is_fixed_size, fixed_size
from .merkle import (
    hash_tree_root, htr, merkleize_chunks, mix_in_length, mix_in_selector,
    pack_bytes, next_pow_of_two, chunk_count,
)
