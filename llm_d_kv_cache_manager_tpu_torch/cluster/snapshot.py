"""Index snapshot / warm-restart: serialize the published read view.

Copy of the reference package's `cluster/snapshot.py`.

A restarted indexer replica is useless until it re-learns the fleet's
placement, which without help takes as long as the engines take to re-store
their chains (minutes of degraded routing — the exact failure mode the
ROADMAP's "scale out the indexer itself" item names). This module makes a
restart a two-step warm-up measured in seconds:

1. **Snapshot.** `write_snapshot` serializes any backend's
   `Index.export_view` projection plus the per-(pod, topic) wire-seq
   watermarks the fleet-health tracker already maintains
   (`FleetHealthTracker.seq_snapshot`) into a versioned file. The encoding
   is the repo's canonical CBOR subset (kvblock/hashing.py — the same
   shortest-form rules the block-hash payloads use), so the snapshot needs
   no serialization dependency and round-trips bit-exactly.
2. **Warm restart.** `read_snapshot` + `Index.import_view` rebuild the
   read state; the seq watermarks become the event pool's replay floors
   (`EventPool.set_seq_floors`), so replaying the retained event tail is
   idempotent — anything at-or-below its floor is already inside the
   imported view and drops as a no-op, anything newer applies normally.

The file is self-describing: magic + version up front, hard error on
mismatch (`SnapshotFormatError`). Writes are atomic (tmp + rename) so a
crash mid-snapshot can never leave a torn file for the next restart.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.hashing import fnv64a
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index, IndexView
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import base_pod_identifier
from llm_d_kv_cache_manager_tpu_torch.utils import cbor
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("cluster.snapshot")

SNAPSHOT_MAGIC = b"KVTPUSNAP"
# Version 2 appends a little-endian FNV-1a 64 checksum of the CBOR body
# after the document, so a torn write or bit-flipped file fails LOUDLY as
# SnapshotFormatError instead of warm-restarting a silently corrupt index.
# Version-1 files (no checksum) still load.
SNAPSHOT_VERSION = 2


class SnapshotFormatError(ValueError):
    """Bad magic, unknown version, or malformed CBOR in a snapshot file."""


@dataclass
class Snapshot:
    version: int
    created_ts: float
    # (bare pod identifier, topic) -> last wire seq applied to the view.
    seq_counters: Dict[Tuple[str, str], int]
    view: IndexView

    def seq_floors(self) -> Dict[Tuple[str, str], int]:
        """The counters in `EventPool.set_seq_floors` form (same shape —
        named for the consumer)."""
        return dict(self.seq_counters)


# -- canonical CBOR subset codec ---------------------------------------------
# The codec itself lives in utils/cbor.py (shared with federation/digest.py);
# the snapshot owns only its magic/version framing and error type. Byte
# output is unchanged by the extraction — pinned by the round-trip tests.


# -- document shape -----------------------------------------------------------
# [version, created_ts,
#  [[pod, topic, seq], ...],
#  [[model, chunk_hash, [[pod, tier], ...]], ...],
#  [[engine_model, engine_hash, request_model, request_hash], ...]]
# Version 2 appends u64-LE FNV-1a 64 of the CBOR document bytes (the bytes
# between the magic and the checksum) after the document.


def encode_snapshot(
    view: IndexView,
    seq_counters: Dict[Tuple[str, str], int],
    created_ts: Optional[float] = None,
) -> bytes:
    if created_ts is None:
        created_ts = time.time()
    doc = [
        SNAPSHOT_VERSION,
        float(created_ts),
        [[pod, topic, seq] for (pod, topic), seq in sorted(seq_counters.items())],
        [[model, h, [[p, t] for p, t in pods]] for model, h, pods in view.entries],
        [list(row) for row in view.engine_map],
    ]
    body = bytearray()
    cbor.encode_into(doc, body)
    out = bytearray(SNAPSHOT_MAGIC)
    out += body
    out += fnv64a(bytes(body)).to_bytes(8, "little")
    return bytes(out)


def decode_snapshot(data: bytes) -> Snapshot:
    if not data.startswith(SNAPSHOT_MAGIC):
        raise SnapshotFormatError("not a KVTPU index snapshot (bad magic)")
    try:
        doc, end = cbor.decode(data, len(SNAPSHOT_MAGIC))
    except cbor.CborDecodeError as e:
        raise SnapshotFormatError(str(e)) from None
    if not isinstance(doc, list) or len(doc) != 5:
        raise SnapshotFormatError("malformed snapshot document")
    version = doc[0]
    if version == 1:
        # Pre-integrity snapshots carry no checksum; the document must
        # consume the whole file.
        if end != len(data):
            raise SnapshotFormatError(f"{len(data) - end} trailing byte(s)")
    elif version == SNAPSHOT_VERSION:
        trailing = len(data) - end
        if trailing != 8:
            raise SnapshotFormatError(
                "missing or malformed snapshot checksum "
                f"({trailing} trailing byte(s), expected 8)"
            )
        expected = int.from_bytes(data[end:], "little")
        actual = fnv64a(bytes(data[len(SNAPSHOT_MAGIC):end]))
        if actual != expected:
            raise SnapshotFormatError(
                "snapshot checksum mismatch (torn or bit-flipped file) — "
                "refusing to warm-restart from a corrupt index view"
            )
    else:
        raise SnapshotFormatError(
            f"unsupported snapshot version {version} "
            f"(this build reads versions 1..{SNAPSHOT_VERSION})"
        )
    seq_counters = {(pod, topic): seq for pod, topic, seq in doc[2]}
    view = IndexView(
        entries=[
            (model, h, tuple((p, t) for p, t in pods))
            for model, h, pods in doc[3]
        ],
        engine_map=[tuple(row) for row in doc[4]],
    )
    return Snapshot(
        version=version, created_ts=doc[1], seq_counters=seq_counters, view=view
    )


# -- file + tracker plumbing --------------------------------------------------


def seq_counters_from_tracker(tracker) -> Dict[Tuple[str, str], int]:
    """Flatten `FleetHealthTracker.seq_snapshot()` into snapshot form.

    The tracker keys records by DP-rank-qualified identity ("pod@dp0"),
    but the wire seq is per PUBLISHER TOPIC — all ranks of a pod interleave
    one counter — so the floor for (bare pod, topic) is the max across its
    rank records: everything at-or-below it reached the view through some
    rank's batch.
    """
    floors: Dict[Tuple[str, str], int] = {}
    for pod, topics in tracker.seq_snapshot().items():
        base = base_pod_identifier(pod)
        for topic, seq in topics.items():
            key = (base, topic)
            if seq > floors.get(key, -1):
                floors[key] = seq
    return floors


def write_snapshot(
    path: str,
    index: Index,
    seq_counters: Optional[Dict[Tuple[str, str], int]] = None,
    created_ts: Optional[float] = None,
) -> dict:
    """Export `index` and write the snapshot atomically. Returns a small
    stats dict (the /cluster/snapshot response body)."""
    view = index.export_view()
    data = encode_snapshot(view, seq_counters or {}, created_ts=created_ts)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    stats = {
        "path": path,
        "bytes": len(data),
        "keys": len(view.entries),
        "pod_entries": view.entry_count(),
        "engine_mappings": len(view.engine_map),
        "seq_counters": len(seq_counters or {}),
        "version": SNAPSHOT_VERSION,
    }
    logger.info(
        "snapshot written: %s (%d keys, %d pod entries, %d bytes)",
        path, stats["keys"], stats["pod_entries"], stats["bytes"],
    )
    return stats


def read_snapshot(path: str) -> Snapshot:
    with open(path, "rb") as f:
        return decode_snapshot(f.read())


def restore_index(index: Index, snapshot: Snapshot) -> int:
    """Import a snapshot's view into a (fresh) index. Returns pod entries
    imported. The caller owns the rest of the warm restart — seq floors,
    tail replay, readiness state (`cluster/replica.py`)."""
    return index.import_view(snapshot.view)


SNAPSHOT_FIELDS: List[str] = [
    "version", "created_ts", "seq_counters", "entries", "engine_map",
]
