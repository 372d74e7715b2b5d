"""XXH64 in plain Python (the public algorithm, seed 0 by default).

The prefix store keys its text chunks and fingerprints its token lists
with XXH64, and the port must run where the `xxhash` package is not
installed. `intdigest(data)` equals `xxhash.xxh64(data).intdigest()`.
"""

from __future__ import annotations

import struct

__all__ = ["intdigest"]

_M = 0xFFFFFFFFFFFFFFFF
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5

_u64 = struct.Struct("<Q").unpack_from
_u32 = struct.Struct("<I").unpack_from


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M
    acc = ((acc << 31) | (acc >> 33)) & _M
    return (acc * _P1) & _M


def _merge(acc: int, v: int) -> int:
    acc ^= _round(0, v)
    return (acc * _P1 + _P4) & _M


def intdigest(data: bytes, seed: int = 0) -> int:
    """The 64-bit XXH64 hash of `data`."""
    n = len(data)
    n_stripes = n // 32
    pos = 32 * n_stripes
    if n_stripes:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        lanes = struct.unpack_from(f"<{4 * n_stripes}Q", data)
        for i in range(0, 4 * n_stripes, 4):
            v1 = (v1 + lanes[i] * _P2) & _M
            v1 = (((v1 << 31) | (v1 >> 33)) * _P1) & _M
            v2 = (v2 + lanes[i + 1] * _P2) & _M
            v2 = (((v2 << 31) | (v2 >> 33)) * _P1) & _M
            v3 = (v3 + lanes[i + 2] * _P2) & _M
            v3 = (((v3 << 31) | (v3 >> 33)) * _P1) & _M
            v4 = (v4 + lanes[i + 3] * _P2) & _M
            v4 = (((v4 << 31) | (v4 >> 33)) * _P1) & _M
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57))
             + ((v3 << 12) | (v3 >> 52)) + ((v4 << 18) | (v4 >> 46))) & _M
        h = _merge(h, v1)
        h = _merge(h, v2)
        h = _merge(h, v3)
        h = _merge(h, v4)
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while pos + 8 <= n:
        h ^= _round(0, _u64(data, pos)[0])
        h = ((((h << 27) | (h >> 37)) & _M) * _P1 + _P4) & _M
        pos += 8
    if pos + 4 <= n:
        h ^= (_u32(data, pos)[0] * _P1) & _M
        h = ((((h << 23) | (h >> 41)) & _M) * _P2 + _P3) & _M
        pos += 4
    while pos < n:
        h ^= (data[pos] * _P5) & _M
        h = ((((h << 11) | (h >> 53)) & _M) * _P1) & _M
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h
