"""FNV hashing + canonical CBOR encoding for block-key derivation.

Copy of the reference package's `kvcache/kvblock/hashing.py`. The batch fast
paths (`prefix_hashes_fast`, `prefix_hashes_fast_many`, `token_fingerprints`)
run on the C hash core, `native/fnvcbor.c`, which the port builds on first
use (`ops/_build.py`; a failed build raises). The pure-Python functions
(`prefix_hashes`, `token_fingerprints_plain`) define the keys: the C core is
bit-identical to them, and tokens its conversion rejects (floats, negatives)
take them. A block's request key is
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
_FNV32_OFFSET = 0x811C9DC5
_FNV32_PRIME = 0x01000193
_MASK64 = 0xFFFFFFFFFFFFFFFF
_MASK32 = 0xFFFFFFFF


def fnv64a(data: bytes, h: int = _FNV64_OFFSET) -> int:
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & _MASK64
    return h


def fnv32a(data: bytes) -> int:
    """FNV-1a 32: the event pool shards messages by it (kvevents/pool.py)."""
    h = _FNV32_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV32_PRIME) & _MASK32
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


def _core():
    """The C hash core (`native/fnvcbor.c`), built and loaded on first use."""
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    return _build.extension("_kvtpu_native")


def have_native() -> bool:
    """True once the C hash core is loaded; it is built on first use, and a
    failed build raises with the compiler's log."""
    _core()
    return True


def fold64(h: int, v: int) -> int:
    """One step of a 64-bit fold: FNV-1a's xor-multiply applied to a whole
    64-bit value. Not the block-key hash: chain-memo fingerprints
    (kvblock/chain_memo.py), the prefix store's state chain and the host
    tier's rendezvous ranking of peer holders use it."""
    return ((h ^ (v & _MASK64)) * _FNV64_PRIME) & _MASK64


def token_fingerprints(
    fp0: int, tokens: Sequence[int], seg_tokens: int
) -> List[int]:
    """Chained fingerprints of `tokens` at every full `seg_tokens` boundary
    (trailing partial segment dropped), on the C hash core."""
    if seg_tokens <= 0:
        raise ValueError("seg_tokens must be positive")
    try:
        return list(_core().token_fingerprints(fp0, tokens, seg_tokens))
    except (TypeError, OverflowError):
        pass  # exotic token types: the plain loop defines the behavior
    return token_fingerprints_plain(fp0, tokens, seg_tokens)


def token_fingerprints_plain(
    fp0: int, tokens: Sequence[int], seg_tokens: int
) -> List[int]:
    """`token_fingerprints` in pure Python."""
    if seg_tokens <= 0:
        raise ValueError("seg_tokens must be positive")
    n = (len(tokens) // seg_tokens) * seg_tokens
    h = fp0
    out: List[int] = []
    for i in range(n):
        h = ((h ^ (int(tokens[i]) & _MASK64)) * _FNV64_PRIME) & _MASK64
        if (i + 1) % seg_tokens == 0:
            out.append(h)
    return out


def prefix_hashes_fast(
    parent: int,
    tokens: Sequence[int],
    block_size: int,
    extra: Optional[Sequence[int]] = None,
    algo: str = "fnv64_cbor",
) -> List[int]:
    """Chunk `tokens` into full blocks of `block_size` and chain-hash them
    under `algo` ("fnv64_cbor" or "sha256_cbor_64bit"). fnv64_cbor runs on
    the C hash core in one crossing with the GIL released."""
    n_full = len(tokens) // block_size
    if n_full == 0:
        return []
    if algo == "fnv64_cbor":
        try:
            return list(_core().batch_prefix_hashes(
                int(parent), tokens, block_size,
                None if extra is None else list(extra),
            ))
        except (TypeError, OverflowError):
            # Tokens the C conversion rejects (e.g. floats, negatives):
            # the pure-Python path defines the behavior.
            pass
    chunks = [tokens[i * block_size:(i + 1) * block_size] for i in range(n_full)]
    return prefix_hashes(parent, chunks, extra, algo=algo)


def prefix_hashes_fast_many(tasks: Sequence[tuple]) -> List[List[int]]:
    """Batched `prefix_hashes_fast`: `tasks` holds (parent, tokens,
    block_size, extra, algo) tuples, one hash list comes back per task.
    When every task is fnv64_cbor the whole batch derives in one C crossing
    (`batch_prefix_hashes_many`); otherwise each task runs on its own."""
    if not tasks:
        return []
    if all(t[4] == "fnv64_cbor" for t in tasks):
        try:
            return [
                list(hashes)
                for hashes in _core().batch_prefix_hashes_many([
                    (
                        int(parent), tokens, block_size,
                        None if extra is None else list(extra),
                    )
                    for parent, tokens, block_size, extra, _ in tasks
                ])
            ]
        except (TypeError, OverflowError):
            pass  # fall through: pure Python defines the behavior
    return [
        prefix_hashes_fast(parent, tokens, block_size, extra, algo=algo)
        for parent, tokens, block_size, extra, algo in tasks
    ]
