"""Vendored ShareGPT length/turn distribution tables.

The BASELINE north-star metric is defined over a **ShareGPT replay**
(prefix-cache hit rate + p50 TTFT on a vLLM-TPU fleet), so the workload
engine needs the ShareGPT *shape* without any network egress. These tables
are a committed reconstruction of the ShareGPT_V3_unfiltered_cleaned_split
summary statistics as reported by the vLLM serving benchmarks (the dataset
vLLM's benchmark_serving.py samples: per-turn user prompts with a ~28-token
median and a long tail past 1k tokens; assistant outputs with a ~170-token
median, both truncated near the 2048-token context of the original
captures; most conversations short, with a tail of 10-30+ turn chats).
They are approximations of published aggregates — NOT a verbatim dump of
the dataset (which is not redistributable here) — and are versioned so a
regenerated table can be told apart from this one.

Length unit: "length units" — the generator emits that many synthetic
WORDS (workloads.synthetic.text). The test fixture's BPE maps one word to
a few tokens, which inflates absolute token counts by a roughly constant
factor but preserves the distribution *shape* — and every consumer of
these numbers (bench.py's TTFT model, the device bench's prefill) works in
the same unit on both sides of a comparison, so the shape is what matters.

The shared-system-prefix mix is the one deliberate departure from raw
ShareGPT: the raw captures carry almost no standing system prompts, but
the production fleets the reference benchmarks (37-capacity/73-capacity:
8k/6k-token shared prefixes) are dominated by them. `SYSTEM_PREFIX_SHARE`
and `SYSTEM_PREFIX_LEN_QUANTILES` graft that reference-benchmark prefix
structure onto the ShareGPT turn/length shape; set the share to 0.0 for a
prefix-free raw-ShareGPT workload.

Quantile tables are (quantile, value) pairs defining a piecewise-linear
inverse CDF (workloads.stats interpolates between them); the turn count is
a small-integer pmf instead, because a handful of discrete values carries
the mass.
"""

from __future__ import annotations

TABLES_VERSION = "sharegpt-v1"

# Per-turn USER message length (length units ≈ tokens). Median ~28, long
# tail to the 2048-token truncation of the source captures.
USER_LEN_QUANTILES: tuple = (
    (0.00, 1),
    (0.10, 6),
    (0.25, 12),
    (0.50, 28),
    (0.75, 80),
    (0.90, 240),
    (0.95, 480),
    (0.99, 1300),
    (1.00, 2048),
)

# Per-turn ASSISTANT output length (length units ≈ tokens). Median ~170,
# mean ~230 — ShareGPT outputs run much longer than its prompts.
OUTPUT_LEN_QUANTILES: tuple = (
    (0.00, 1),
    (0.10, 20),
    (0.25, 62),
    (0.50, 170),
    (0.75, 350),
    (0.90, 580),
    (0.95, 750),
    (0.99, 1100),
    (1.00, 2048),
)

# USER turns per conversation: pmf over the discrete counts that carry the
# mass. Mean ≈ 4.0 turns; ~10% of chats run 10 turns or longer — the
# multi-turn tail is what makes prefix reuse compound.
TURNS_PER_SESSION_PMF: tuple = (
    (1, 0.32),
    (2, 0.17),
    (3, 0.12),
    (4, 0.09),
    (5, 0.07),
    (6, 0.055),
    (7, 0.04),
    (8, 0.035),
    (10, 0.045),
    (12, 0.02),
    (16, 0.015),
    (20, 0.01),
    (24, 0.005),
    (32, 0.005),
)

# Shared-system-prefix mix (reference-benchmark graft, see module
# docstring): fraction of sessions that belong to a prefix group, and the
# length distribution of the group prefixes (up to the reference's
# 8k-token shared prefixes).
SYSTEM_PREFIX_SHARE = 0.55
SYSTEM_PREFIX_LEN_QUANTILES: tuple = (
    (0.00, 130),
    (0.25, 700),
    (0.50, 1600),
    (0.75, 3200),
    (0.90, 6000),
    (1.00, 8192),
)


def pmf_total(pmf) -> float:
    return sum(p for _v, p in pmf)


assert abs(pmf_total(TURNS_PER_SESSION_PMF) - 1.0) < 1e-9, (
    "TURNS_PER_SESSION_PMF must sum to 1"
)
