"""KV-block key model (copy of the reference package's `kvblock/key.py`).

The index is dual-keyed: an *engine key* carries the block hash reported by
the engine's KVEvents verbatim, while a *request key* is recomputed on the
indexer side from the event's token IDs, so that read-path lookups (which
only ever see tokens) land on the same keys.
"""

from __future__ import annotations

import re
from typing import Container, NamedTuple

_DP_SUFFIX_RE = re.compile(r"@dp\d+$")


def base_pod_identifier(pod_identifier: str) -> str:
    """Strip a DP-rank qualifier ("pod@dp3" -> "pod")."""
    return _DP_SUFFIX_RE.sub("", pod_identifier)


def pod_matches(pod_identifier: str, pod_identifier_set: Container[str]) -> bool:
    """Membership test for lookup filters: a ranked identity matches both
    its exact form and its bare pod name."""
    return (
        pod_identifier in pod_identifier_set
        or base_pod_identifier(pod_identifier) in pod_identifier_set
    )


class Key(NamedTuple):
    model_name: str
    chunk_hash: int  # uint64

    def __str__(self) -> str:
        return f"{self.model_name}@{self.chunk_hash:x}"


class PodEntry(NamedTuple):
    pod_identifier: str
    device_tier: str  # e.g. "gpu" | "cpu"

    def __str__(self) -> str:
        return f"{self.pod_identifier}@{self.device_tier}"
