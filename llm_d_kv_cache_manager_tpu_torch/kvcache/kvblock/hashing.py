"""FNV hashing + canonical CBOR encoding for block-key derivation.

Pure-Python copy of the reference package's `kvcache/kvblock/hashing.py`
(the C fast path stays with the reference package). A block's request key is
`FNV-64a(canonical_CBOR([parent_u64, [token_u32...], extra|null]))`,
chained block to block, with the root hash `FNV-64a(hash_seed_bytes)`. The
`sha256_cbor_64bit` variant hashes the same payload with sha256 and keeps the
low 64 bits (vLLM's `--prefix-caching-hash-algo=sha256_cbor_64bit`).
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List, Optional, Sequence

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv64a(data: bytes, h: int = _FNV64_OFFSET) -> int:
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & _MASK64
    return h


def _cbor_uint_head(major: int, value: int, out: bytearray) -> None:
    """Shortest-form CBOR head byte(s) for the given major type and value."""
    mt = major << 5
    if value < 24:
        out.append(mt | value)
    elif value <= 0xFF:
        out.append(mt | 24)
        out.append(value)
    elif value <= 0xFFFF:
        out.append(mt | 25)
        out += value.to_bytes(2, "big")
    elif value <= 0xFFFFFFFF:
        out.append(mt | 26)
        out += value.to_bytes(4, "big")
    else:
        out.append(mt | 27)
        out += value.to_bytes(8, "big")


def cbor_hash_payload(
    parent: int, tokens: Sequence[int], extra: Optional[Sequence[int]] = None
) -> bytes:
    """Canonical CBOR for the 3-element payload [parent, tokens, extra].

    None encodes as CBOR null (the base scheme); a sequence (e.g. a LoRA
    adapter id) encodes as an array of uints.
    """
    out = bytearray()
    out.append(0x83)  # array(3)
    _cbor_uint_head(0, parent, out)
    _cbor_uint_head(4, len(tokens), out)
    for t in tokens:
        _cbor_uint_head(0, int(t), out)
    if extra is None:
        out.append(0xF6)  # null
    else:
        _cbor_uint_head(4, len(extra), out)
        for e in extra:
            _cbor_uint_head(0, int(e), out)
    return bytes(out)


def init_hash(seed: str) -> int:
    """Root parent hash: FNV-64a over the seed string bytes."""
    return fnv64a(seed.encode("utf-8"))


def chunk_hash(
    parent: int, tokens: Sequence[int], extra: Optional[Sequence[int]] = None
) -> int:
    """One link of the chain: FNV-64a over the canonical-CBOR payload."""
    return fnv64a(cbor_hash_payload(parent, tokens, extra))


def _cbor_text(s: str) -> bytes:
    """Canonical CBOR text string (major type 3, shortest-form length)."""
    data = s.encode("utf-8")
    out = bytearray()
    _cbor_uint_head(3, len(data), out)
    return bytes(out) + data


def _sha256_low64(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest(), "big") & _MASK64


def sha256_cbor_init_hash(seed: str) -> int:
    """Root parent hash under `sha256_cbor_64bit`: the low 64 bits of sha256
    over the canonical-CBOR text encoding of the seed. An empty seed is an
    error: an unseeded vLLM fleet draws its root hash from os.urandom, so no
    fixed derivation can match it."""
    if seed == "":
        raise ValueError(
            "hash_algo='sha256_cbor_64bit' requires a non-empty hash_seed: "
            "an unseeded vLLM fleet derives NONE_HASH from per-process "
            "os.urandom, so no fixed seed can ever match it"
        )
    return _sha256_low64(_cbor_text(seed))


def sha256_cbor_chunk_hash(
    parent: int, tokens: Sequence[int], extra: Optional[Sequence[int]] = None
) -> int:
    """One chain link under `sha256_cbor_64bit`."""
    return _sha256_low64(cbor_hash_payload(parent, tokens, extra))


def prefix_hashes(
    parent: int,
    token_chunks: Iterable[Sequence[int]],
    extra: Optional[Sequence[int]] = None,
    algo: str = "fnv64_cbor",
) -> List[int]:
    """Chained hashes for consecutive token chunks."""
    if algo == "fnv64_cbor":
        link = chunk_hash
    elif algo == "sha256_cbor_64bit":
        link = sha256_cbor_chunk_hash
    else:
        raise ValueError(f"unknown hash algo: {algo!r}")
    hashes: List[int] = []
    h = parent
    for chunk in token_chunks:
        h = link(h, chunk, extra)
        hashes.append(h)
    return hashes


def fold64(h: int, v: int) -> int:
    """One step of a 64-bit fold: FNV-1a's xor-multiply applied to a whole
    64-bit value. Not the block-key hash: the host tier's rendezvous ranking
    of peer holders uses it (engine/tiering.IndexBackedPeerResolver)."""
    return ((h ^ (v & _MASK64)) * _FNV64_PRIME) & _MASK64
