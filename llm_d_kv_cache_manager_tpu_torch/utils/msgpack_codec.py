"""A msgpack codec in plain Python, for the KVEvents wire.

The port's event plane must run where the `msgpack` package is not
installed, so it carries the subset of the format that the wire uses:

- nil, bool, int (uint64 and int64 ranges), float32 and float64;
- str (fixstr, str8, str16, str32) and bin (bin8, bin16, bin32);
- array and map (fix, 16 and 32-bit lengths).

`packb(obj)` gives the bytes of `msgpack.packb(obj, use_bin_type=True)`:
the shortest integer form, float64 for every float, str8 for short strings,
tuples as arrays. `unpackb(data)` gives what `msgpack.unpackb(data,
raw=False, strict_map_key=False)` gives: lists for arrays, dicts for maps,
str for str, bytes for bin. Ext types are refused both ways, and any
malformed input raises ValueError (a truncated buffer, trailing bytes, a
reserved type byte, invalid UTF-8) or TypeError (an unhashable map key).
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

__all__ = ["packb", "unpackb"]

_MAX_DEPTH = 512  # nesting bound: deeper input is refused, never a RecursionError

_pack_B = struct.Struct(">B").pack
_pack_BB = struct.Struct(">BB").pack
_pack_Bb = struct.Struct(">Bb").pack
_pack_BH = struct.Struct(">BH").pack
_pack_Bh = struct.Struct(">Bh").pack
_pack_BI = struct.Struct(">BI").pack
_pack_Bi = struct.Struct(">Bi").pack
_pack_BQ = struct.Struct(">BQ").pack
_pack_Bq = struct.Struct(">Bq").pack
_pack_Bd = struct.Struct(">Bd").pack

_unpack_H = struct.Struct(">H").unpack_from
_unpack_I = struct.Struct(">I").unpack_from
_unpack_Q = struct.Struct(">Q").unpack_from
_unpack_b = struct.Struct(">b").unpack_from
_unpack_h = struct.Struct(">h").unpack_from
_unpack_i = struct.Struct(">i").unpack_from
_unpack_q = struct.Struct(">q").unpack_from
_unpack_f = struct.Struct(">f").unpack_from
_unpack_d = struct.Struct(">d").unpack_from


def _int_bytes(v: int) -> bytes:
    if 0 <= v < 0x80:
        return _pack_B(v)
    if -0x20 <= v < 0:
        return _pack_B(v & 0xFF)
    if 0x80 <= v <= 0xFF:
        return _pack_BB(0xCC, v)
    if -0x80 <= v < 0:
        return _pack_Bb(0xD0, v)
    if 0xFF < v <= 0xFFFF:
        return _pack_BH(0xCD, v)
    if -0x8000 <= v < -0x80:
        return _pack_Bh(0xD1, v)
    if 0xFFFF < v <= 0xFFFFFFFF:
        return _pack_BI(0xCE, v)
    if -0x80000000 <= v < -0x8000:
        return _pack_Bi(0xD2, v)
    if 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        return _pack_BQ(0xCF, v)
    if -0x8000000000000000 <= v < -0x80000000:
        return _pack_Bq(0xD3, v)
    raise OverflowError("Integer value out of range")


# Encodings of 0..65535, the range token ids live in: a list of token ids
# packs as one join over table lookups.
_SMALL_INTS = [_int_bytes(v) for v in range(0x10000)]


def _head(n: int, fix_base: int, fix_limit: int, b8, b16: int, b32: int) -> bytes:
    if n < fix_limit:
        return _pack_B(fix_base | n)
    if b8 is not None and n <= 0xFF:
        return _pack_BB(b8, n)
    if n <= 0xFFFF:
        return _pack_BH(b16, n)
    if n <= 0xFFFFFFFF:
        return _pack_BI(b32, n)
    raise ValueError("object too large for msgpack")


def _pack(obj: Any, out: List[bytes], depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("recursion limit exceeded")
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        if isinstance(obj, bool):  # a bool subclass instance
            out.append(b"\xc3" if obj else b"\xc2")
        elif 0 <= obj < 0x10000:
            out.append(_SMALL_INTS[obj])
        else:
            out.append(_int_bytes(obj))
    elif isinstance(obj, (list, tuple)):
        if type(obj).__name__ == "ExtType":  # msgpack's ext wrapper
            raise TypeError("msgpack ext types are not supported")
        out.append(_head(len(obj), 0x90, 16, None, 0xDC, 0xDD))
        table = _SMALL_INTS
        if obj and all(type(x) is int for x in obj) and 0 <= min(obj) and max(obj) < 0x10000:
            out.append(b"".join([table[x] for x in obj]))
            return
        for item in obj:
            if type(item) is int and 0 <= item < 0x10000:
                out.append(table[item])
            else:
                _pack(item, out, depth + 1)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_head(len(data), 0xA0, 32, 0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_head(len(data), 0, 0, 0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, float):
        out.append(_pack_Bd(0xCB, obj))
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 16, None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out, depth + 1)
            _pack(v, out, depth + 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """msgpack bytes of `obj`, as `msgpack.packb(obj, use_bin_type=True)`."""
    out: List[bytes] = []
    _pack(obj, out, 0)
    return b"".join(out)


class _Reader:
    __slots__ = ("data", "n")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)

    def need(self, pos: int, k: int) -> None:
        if pos + k > self.n:
            raise ValueError("Unpack failed: incomplete input")

    def raw(self, pos: int, k: int) -> Tuple[bytes, int]:
        self.need(pos, k)
        return self.data[pos:pos + k], pos + k

    def string(self, pos: int, k: int) -> Tuple[str, int]:
        raw, pos = self.raw(pos, k)
        return raw.decode("utf-8"), pos  # UnicodeDecodeError is a ValueError

    def array(self, pos: int, k: int, depth: int) -> Tuple[list, int]:
        if k > self.n - pos:  # each element takes at least one byte
            raise ValueError("Unpack failed: incomplete input")
        data = self.data
        items: list = []
        append = items.append
        for _ in range(k):
            if pos >= self.n:
                raise ValueError("Unpack failed: incomplete input")
            b = data[pos]
            if b < 0x80:  # positive fixint: the common token id of a small vocab
                append(b)
                pos += 1
            elif b == 0xCD and pos + 3 <= self.n:  # uint16: a token id
                append((data[pos + 1] << 8) | data[pos + 2])
                pos += 3
            else:
                v, pos = self.value(pos, depth + 1)
                append(v)
        return items, pos

    def mapping(self, pos: int, k: int, depth: int) -> Tuple[dict, int]:
        if 2 * k > self.n - pos:
            raise ValueError("Unpack failed: incomplete input")
        out: dict = {}
        for _ in range(k):
            key, pos = self.value(pos, depth + 1)
            val, pos = self.value(pos, depth + 1)
            out[key] = val  # an unhashable key raises TypeError, as msgpack does
        return out, pos

    def value(self, pos: int, depth: int) -> Tuple[Any, int]:
        if depth > _MAX_DEPTH:
            raise ValueError("Unpack failed: nesting too deep")
        if pos >= self.n:
            raise ValueError("Unpack failed: incomplete input")
        data = self.data
        b = data[pos]
        pos += 1
        if b < 0x80:
            return b, pos
        if b >= 0xE0:
            return b - 0x100, pos
        if b < 0x90:
            return self.mapping(pos, b & 0x0F, depth)
        if b < 0xA0:
            return self.array(pos, b & 0x0F, depth)
        if b < 0xC0:
            return self.string(pos, b & 0x1F)
        if b == 0xC0:
            return None, pos
        if b == 0xC2:
            return False, pos
        if b == 0xC3:
            return True, pos
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            k, pos = self.length(pos, b - 0xC4)
            return self.raw(pos, k)
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            k, pos = self.length(pos, b - 0xD9)
            return self.string(pos, k)
        if b in (0xDC, 0xDD):  # array 16/32
            k, pos = self.length(pos, b - 0xDC + 1)
            return self.array(pos, k, depth)
        if b in (0xDE, 0xDF):  # map 16/32
            k, pos = self.length(pos, b - 0xDE + 1)
            return self.mapping(pos, k, depth)
        fixed = _FIXED.get(b)
        if fixed is not None:
            size, reader = fixed
            self.need(pos, size)
            return reader(data, pos)[0], pos + size
        if b in _EXT:
            raise ValueError(f"Unpack failed: ext type 0x{b:02x} is not supported")
        raise ValueError(f"Unpack failed: reserved type byte 0x{b:02x}")

    def length(self, pos: int, width: int) -> Tuple[int, int]:
        """A 1-, 2- or 4-byte length (width 0, 1, 2)."""
        size = 1 << width
        self.need(pos, size)
        if width == 0:
            return self.data[pos], pos + 1
        if width == 1:
            return _unpack_H(self.data, pos)[0], pos + 2
        return _unpack_I(self.data, pos)[0], pos + 4


_FIXED = {
    0xCA: (4, _unpack_f), 0xCB: (8, _unpack_d),
    0xCC: (1, lambda d, p: (d[p],)), 0xCD: (2, _unpack_H),
    0xCE: (4, _unpack_I), 0xCF: (8, _unpack_Q),
    0xD0: (1, _unpack_b), 0xD1: (2, _unpack_h),
    0xD2: (4, _unpack_i), 0xD3: (8, _unpack_q),
}
_EXT = frozenset((0xC7, 0xC8, 0xC9, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8))


def unpackb(data) -> Any:
    """Decode one msgpack object, as `msgpack.unpackb(data, raw=False,
    strict_map_key=False)`; trailing bytes are an error."""
    data = bytes(data)
    reader = _Reader(data)
    obj, pos = reader.value(0, 0)
    if pos != len(data):
        raise ValueError("Unpack failed: extra data")
    return obj
