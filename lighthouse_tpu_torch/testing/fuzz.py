"""Randomized SSZ fuzzing + field-level state diffing.

Analogs of two reference facilities:
- the `arbitrary` derives on all consensus types (workspace
  Cargo.toml:110, consensus/types `arbitrary` feature): `arbitrary(typ)`
  builds a random value of ANY SSZ type by walking its type structure,
  for round-trip properties (serialize -> deserialize -> identical bytes
  and root) and malformed-decode fuzzing (`mutate`);
- `compare_fields` (common/compare_fields): `compare_containers` walks
  two container values and returns the paths that differ; `state_diff`
  does the same for BeaconState via its per-field serializations.

Decode-fuzz contract: `deserialize(typ, mutate(valid_bytes))` must
either raise DeserializeError or return a value that re-serializes
canonically — any other exception type, crash, or non-canonical accept
is a codec bug.
"""
from __future__ import annotations

import random

from ..ssz.codec import DeserializeError, deserialize, serialize
from ..ssz.types import (
    Bitlist, Bitvector, Boolean, ByteList, ByteVector, Container, List,
    SSZType, UInt, Union, UnionValue, Vector, default_value,
)

MAX_LIST_FUZZ = 4       # keep generated lists small: shape, not volume


def arbitrary(typ: SSZType, rng: random.Random, depth: int = 0):
    """A random value of any SSZ type (bounded recursion)."""
    if isinstance(typ, Boolean):
        return rng.random() < 0.5
    if isinstance(typ, UInt):
        # bias to edge values: 0, max, small, random
        roll = rng.random()
        top = (1 << (8 * typ.byte_len)) - 1
        if roll < 0.25:
            return 0
        if roll < 0.5:
            return top
        if roll < 0.75:
            return rng.randrange(0, 256)
        return rng.randrange(0, top + 1)
    if isinstance(typ, ByteVector):
        return bytes(rng.getrandbits(8) for _ in range(typ.length))
    if isinstance(typ, ByteList):
        n = rng.randrange(0, min(typ.limit, 2 * MAX_LIST_FUZZ) + 1)
        return bytes(rng.getrandbits(8) for _ in range(n))
    if isinstance(typ, Bitvector):
        return [rng.random() < 0.5 for _ in range(typ.length)]
    if isinstance(typ, Bitlist):
        n = rng.randrange(0, min(typ.limit, 8 * MAX_LIST_FUZZ) + 1)
        return [rng.random() < 0.5 for _ in range(n)]
    if isinstance(typ, Vector):
        return [arbitrary(typ.elem, rng, depth + 1)
                for _ in range(typ.length)]
    if isinstance(typ, List):
        if depth > 6:
            return []
        n = rng.randrange(0, min(typ.limit, MAX_LIST_FUZZ) + 1)
        return [arbitrary(typ.elem, rng, depth + 1) for _ in range(n)]
    if isinstance(typ, Container):
        kwargs = {}
        for name, ftyp in typ.fields:
            kwargs[name] = (arbitrary(ftyp, rng, depth + 1)
                            if depth <= 8 else default_value(ftyp))
        return typ.cls(**kwargs)
    if isinstance(typ, Union):
        sel = rng.randrange(len(typ.options))
        opt = typ.options[sel]
        val = None if opt is None else arbitrary(opt, rng, depth + 1)
        return UnionValue(sel, val)
    raise TypeError(f"arbitrary: unhandled SSZ type {typ!r}")


def mutate(data: bytes, rng: random.Random) -> bytes:
    """One random structural corruption of a serialization."""
    if not data:
        return bytes([rng.getrandbits(8)])
    op = rng.randrange(5)
    buf = bytearray(data)
    i = rng.randrange(len(buf))
    if op == 0:                          # bit flip
        buf[i] ^= 1 << rng.randrange(8)
    elif op == 1:                        # truncate
        del buf[rng.randrange(len(buf)):]
    elif op == 2:                        # extend with junk
        buf += bytes(rng.getrandbits(8)
                     for _ in range(1 + rng.randrange(8)))
    elif op == 3:                        # byte splice (offset confusion)
        j = rng.randrange(len(buf))
        buf[i], buf[j] = buf[j], buf[i]
        buf[i] = rng.getrandbits(8)
    else:                                # zero a 4-byte window (offsets)
        buf[i:i + 4] = b"\x00" * min(4, len(buf) - i)
    return bytes(buf)


def fuzz_decode_one(typ: SSZType, data: bytes) -> str:
    """-> 'rejected' | 'accepted' (canonically) — raises on codec bugs."""
    try:
        val = deserialize(typ, data)
    except DeserializeError:
        return "rejected"
    # accepted: must re-serialize to EXACTLY the accepted bytes
    # (SSZ decoding is bijective on valid encodings; a non-canonical
    # accept means two wire forms map to one value)
    out = serialize(typ, val)
    if out != data:
        raise AssertionError(
            f"non-canonical accept: {data.hex()} != {out.hex()}")
    return "accepted"


# ---------------------------------------------------------------------------
# field-level diffing (common/compare_fields analog)
# ---------------------------------------------------------------------------

def compare_containers(a, b, typ: SSZType, path: str = "") -> list[str]:
    """Paths at which two values of `typ` differ (leaf-level)."""
    diffs: list[str] = []
    if isinstance(typ, Container):
        for name, ftyp in typ.fields:
            diffs += compare_containers(getattr(a, name),
                                        getattr(b, name), ftyp,
                                        f"{path}.{name}" if path else name)
        return diffs
    if isinstance(typ, (Vector, List)):
        la, lb = list(a), list(b)
        if len(la) != len(lb):
            return [f"{path}.len({len(la)}!={len(lb)})"]
        for i, (xa, xb) in enumerate(zip(la, lb)):
            diffs += compare_containers(xa, xb, typ.elem,
                                        f"{path}[{i}]")
        return diffs
    if isinstance(a, (bytes, bytearray)) or not isinstance(typ, Union):
        if (bytes(a) if isinstance(a, (bytes, bytearray)) else a) != \
                (bytes(b) if isinstance(b, (bytes, bytearray)) else b):
            return [path]
        return []
    if a.selector != b.selector or a.value != b.value:
        return [path]
    return []


def state_diff(a, b) -> list[str]:
    """Differing BeaconState field names via per-field serializations
    (the compare_fields debugging workflow for the SoA state)."""
    from ..containers.state import active_field_specs
    if a.fork_name != b.fork_name:
        return [f"fork({a.fork_name}!={b.fork_name})"]
    out = []
    for f in active_field_specs(a.T, a.fork_name):
        pa, _ = a._field_serialize(f)
        pb, _ = b._field_serialize(f)
        if pa != pb:
            out.append(f.name)
    return out
