"""Canonical CBOR subset codec shared by the control plane's wire formats.

Copy of the reference package's `utils/cbor.py`, on the port's own
`kvblock/hashing.py` primitives: index snapshots and region digests are
byte-equal to the reference's for equal values.

This is the repo's ONE hand-rolled CBOR implementation. It started life
inside `cluster/snapshot.py` (the index-snapshot file format) and moved
here verbatim when the federation tier needed the same encoding for
`RegionDigest` shipping — per-module CBOR copies are exactly the drift
vector the block-hash payloads already avoid by sharing
`kvblock/hashing.py`'s primitives.

Scope: the canonical (shortest-form) subset the snapshot and digest
documents need — unsigned/negative ints, float64, text strings, arrays,
booleans, and null. Encoder primitives come from `kvblock/hashing.py`
(the same shortest-form uint heads and text strings the block-hash
payloads use), so every producer in the repo emits bit-identical bytes
for equal values:

- deterministic: equal Python values encode to equal bytes (no maps, no
  float shortening, arrays preserve order),
- self-delimiting: `decode` returns (value, next_pos) so callers can
  enforce their own trailing-bytes policy,
- loud on malformed input: `CborDecodeError` (a ValueError) on anything
  truncated or outside the subset — wire documents are inputs to routing
  decisions and benchmark headlines, and silently skipping bytes would
  quietly change both.

Format owners (`cluster/snapshot.py`, `federation/digest.py`) keep their
own magic/version framing and error types on top of this codec.
"""

from __future__ import annotations

import struct

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.hashing import (
    _cbor_text,
    _cbor_uint_head,
)


class CborDecodeError(ValueError):
    """Truncated or out-of-subset CBOR in a wire document."""


def encode_into(obj, out: bytearray) -> None:
    """Append the canonical encoding of `obj` to `out`."""
    if obj is None:
        out.append(0xF6)
    elif isinstance(obj, bool):  # before int: bool is an int subtype
        out.append(0xF5 if obj else 0xF4)
    elif isinstance(obj, int):
        if obj >= 0:
            _cbor_uint_head(0, obj, out)
        else:
            _cbor_uint_head(1, -1 - obj, out)
    elif isinstance(obj, float):
        out.append(0xFB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        out += _cbor_text(obj)
    elif isinstance(obj, (list, tuple)):
        _cbor_uint_head(4, len(obj), out)
        for item in obj:
            encode_into(item, out)
    else:
        raise TypeError(f"unencodable CBOR value: {type(obj).__name__}")


def encode(obj) -> bytes:
    out = bytearray()
    encode_into(obj, out)
    return bytes(out)


def decode(data: bytes, pos: int = 0):
    """(value, next_pos) for the subset `encode_into` emits."""
    try:
        head = data[pos]
    except IndexError:
        raise CborDecodeError("truncated CBOR document") from None
    major, info = head >> 5, head & 0x1F
    pos += 1
    if major == 7:
        if head == 0xF6:
            return None, pos
        if head == 0xF5:
            return True, pos
        if head == 0xF4:
            return False, pos
        if head == 0xFB:
            if pos + 8 > len(data):
                raise CborDecodeError("truncated float64")
            return struct.unpack(">d", data[pos:pos + 8])[0], pos + 8
        raise CborDecodeError(f"unsupported simple value 0x{head:02x}")
    if info < 24:
        arg = info
    elif info in (24, 25, 26, 27):
        width = 1 << (info - 24)
        if pos + width > len(data):
            raise CborDecodeError("truncated integer argument")
        arg = int.from_bytes(data[pos:pos + width], "big")
        pos += width
    else:
        raise CborDecodeError(f"unsupported CBOR info value {info}")
    if major == 0:
        return arg, pos
    if major == 1:
        return -1 - arg, pos
    if major == 3:
        if pos + arg > len(data):
            raise CborDecodeError("truncated text string")
        return data[pos:pos + arg].decode("utf-8"), pos + arg
    if major == 4:
        items = []
        for _ in range(arg):
            item, pos = decode(data, pos)
            items.append(item)
        return items, pos
    raise CborDecodeError(f"unsupported CBOR major type {major}")
