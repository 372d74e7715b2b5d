"""Synthetic-workload text: the `synthetic` backend of the workload engine.

Both the modeled fleet bench (bench.py) and the real-compute mini-fleet
bench (benchmarking/fleet_device_bench.py) default to the same multi-turn
shared-system-prompt synthetic workload shape; their TTFT/hit-rate numbers
are meant to be read against each other, so the text machinery lives here
once — tuning it in one bench without the other silently breaking the
comparison is exactly the drift this module prevents. The ShareGPT-shaped
generator (workloads.sharegpt) draws its turn/response text from the same
vocabulary, so synthetic vs sharegpt comparisons differ only in
*distribution*, never in token inventory.

Historically this lived at utils/workload.py; that module remains as a
re-export shim so existing imports keep working.
"""

from __future__ import annotations

import random

WORDS = (
    "the quick brown fox jumps over lazy dog system user assistant tool "
    "response message conversation template routing cache block prefix "
    "token mesh shard kernel attention page table fleet score index event"
).split()


def text(rng: random.Random, n_words: int) -> str:
    return " ".join(rng.choice(WORDS) for _ in range(n_words))


def shared_prefix_conversations(
    rng: random.Random, n_groups: int, users_per_group: int, system_words: int
) -> dict:
    """{conv_id: history}: each group's users share one system prompt —
    the prefix-reuse structure of the reference's capacity benchmarks."""
    system_prompts = [
        f"[group {g}] " + text(rng, system_words) for g in range(n_groups)
    ]
    return {
        f"g{g}-u{u}": system_prompts[g]
        for g in range(n_groups)
        for u in range(users_per_group)
    }
