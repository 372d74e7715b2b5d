"""Distribution sampling + fidelity validation against the committed tables.

Two jobs, deliberately in one module so they can never drift apart:

1. **Sampling** — inverse-transform draws from the piecewise-linear CDF a
   quantile table defines (`sample_quantile`) and from a discrete pmf
   (`sample_pmf`). The sharegpt generator samples through these.
2. **Validation** — KS-style distance between an empirical sample and the
   same piecewise-linear CDF (`ks_distance`), total-variation distance for
   the discrete turn pmf (`tv_distance`), and `validate_trace`, which
   checks a generated trace's prompt-length / output-length /
   turns-per-session distributions against the committed tables within
   tolerance. Used as a library self-check (bench.py --workload sharegpt
   validates its trace before serving it) and by tests/test_workloads.py.

Tolerances are sampling-noise aware: the KS critical value scales as
1/sqrt(n), and integer rounding of interpolated draws adds a small
constant distortion, so `ks_tolerance` is `slack * 1.36/sqrt(n) + eps`.
A generator bug (wrong table, uniform sampling, truncation) lands an
order of magnitude above these thresholds.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.workloads import tables as _tables
from llm_d_kv_cache_manager_tpu_torch.workloads.spec import WorkloadTrace

QuantileTable = Sequence[Tuple[float, float]]
Pmf = Sequence[Tuple[int, float]]


# -- sampling ----------------------------------------------------------------


def sample_quantile(table: QuantileTable, u: float) -> float:
    """Inverse-CDF draw: piecewise-linear interpolation of the table at
    quantile `u` in [0, 1]."""
    if not 0.0 <= u <= 1.0:
        raise ValueError(f"quantile u must be in [0,1], got {u}")
    (q0, v0) = table[0]
    if u <= q0:
        return float(v0)
    for (q1, v1) in table[1:]:
        if u <= q1:
            frac = (u - q0) / (q1 - q0)
            return v0 + frac * (v1 - v0)
        q0, v0 = q1, v1
    return float(table[-1][1])


def sample_length(
    rng: random.Random, table: QuantileTable, scale: float = 1.0
) -> int:
    """Integer length draw from a quantile table, scaled (device-bench
    smoke configs shrink lengths without changing the shape), floor 1."""
    return max(1, int(round(sample_quantile(table, rng.random()) * scale)))


def sample_pmf(rng: random.Random, pmf: Pmf) -> int:
    u = rng.random()
    acc = 0.0
    for value, p in pmf:
        acc += p
        if u < acc:
            return value
    return pmf[-1][0]


# -- distances ---------------------------------------------------------------


def table_cdf(table: QuantileTable, x: float, scale: float = 1.0) -> float:
    """CDF implied by the piecewise-linear quantile table, at `x`."""
    if scale != 1.0:
        x = x / scale
    (q0, v0) = table[0]
    if x <= v0:
        return q0 if x >= v0 else 0.0
    for (q1, v1) in table[1:]:
        if x <= v1:
            if v1 == v0:
                return q1
            return q0 + (q1 - q0) * (x - v0) / (v1 - v0)
        q0, v0 = q1, v1
    return 1.0


def ks_distance(
    samples: Sequence[float], table: QuantileTable, scale: float = 1.0
) -> float:
    """sup_x |F_empirical(x) - F_table(x)|, evaluated at the sample points
    (both one-sided gaps, as in the classical KS statistic)."""
    if not samples:
        raise ValueError("ks_distance needs a non-empty sample")
    xs = sorted(samples)
    n = len(xs)
    d = 0.0
    for i, x in enumerate(xs):
        f = table_cdf(table, x, scale=scale)
        d = max(d, abs((i + 1) / n - f), abs(i / n - f))
    return d


def ks_tolerance(n: int, slack: float = 2.0, eps: float = 0.02) -> float:
    """Sampling-noise-aware KS bound: slack × the 5% critical value plus a
    constant allowance for integer rounding of interpolated draws."""
    return slack * 1.36 / math.sqrt(max(n, 1)) + eps


def tv_distance(samples: Sequence[int], pmf: Pmf) -> float:
    """Total-variation distance between the empirical pmf of `samples` and
    the committed pmf (support = union of both)."""
    if not samples:
        raise ValueError("tv_distance needs a non-empty sample")
    n = len(samples)
    emp: Dict[int, float] = {}
    for s in samples:
        emp[int(s)] = emp.get(int(s), 0.0) + 1.0 / n
    ref = {int(v): p for v, p in pmf}
    support = set(emp) | set(ref)
    return 0.5 * sum(abs(emp.get(v, 0.0) - ref.get(v, 0.0)) for v in support)


def tv_tolerance(n: int, n_categories: int, slack: float = 1.5) -> float:
    """Expected TV of an n-sample from a K-category pmf is O(sqrt(K/n));
    the floor keeps tiny smoke traces from tripping on noise."""
    return max(0.12, slack * math.sqrt(n_categories / max(n, 1)))


# -- trace validation --------------------------------------------------------


@dataclass
class Check:
    name: str
    statistic: float
    tolerance: float
    n: int

    @property
    def ok(self) -> bool:
        return self.statistic <= self.tolerance

    def as_dict(self) -> Dict:
        return {
            "statistic": round(self.statistic, 4),
            "tolerance": round(self.tolerance, 4),
            "n": self.n,
            "ok": self.ok,
        }


@dataclass
class FidelityReport:
    checks: List[Check] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    def as_dict(self) -> Dict:
        out = {c.name: c.as_dict() for c in self.checks}
        out["ok"] = self.ok
        return out

    def raise_if_failed(self) -> None:
        bad = [c for c in self.checks if not c.ok]
        if bad:
            raise ValueError(
                "workload trace failed distribution fidelity: "
                + ", ".join(
                    f"{c.name} KS/TV={c.statistic:.4f} > tol={c.tolerance:.4f}"
                    f" (n={c.n})"
                    for c in bad
                )
            )


def validate_trace(trace: WorkloadTrace) -> FidelityReport:
    """Check a sharegpt trace's empirical distributions against the
    committed tables. Honors the generator's recorded config: lengths are
    compared against tables scaled by `length_scale`, and a `max_turns`
    cap excuses the truncated tail of the turn pmf (the capped mass is
    subtracted from the expected-vs-observed gap before comparison).
    """
    if trace.workload != "sharegpt":
        raise ValueError(
            f"validate_trace checks sharegpt traces, got {trace.workload!r}"
        )
    if trace.tables_version != _tables.TABLES_VERSION:
        raise ValueError(
            f"trace was generated against tables {trace.tables_version!r}; "
            f"this build commits {_tables.TABLES_VERSION!r}"
        )
    scale = float(trace.config.get("length_scale", 1.0))
    max_turns = trace.config.get("max_turns")

    user_lens = [t.user_len for t in trace.turns]
    out_lens = [t.output_len for t in trace.turns]
    turn_counts = list(trace.turn_counts().values())

    report = FidelityReport()
    report.checks.append(Check(
        "user_len", ks_distance(user_lens, _tables.USER_LEN_QUANTILES,
                                scale=scale),
        ks_tolerance(len(user_lens)), len(user_lens),
    ))
    report.checks.append(Check(
        "output_len", ks_distance(out_lens, _tables.OUTPUT_LEN_QUANTILES,
                                  scale=scale),
        ks_tolerance(len(out_lens)), len(out_lens),
    ))

    pmf = list(_tables.TURNS_PER_SESSION_PMF)
    if max_turns is not None:
        # The generator clamps sessions at max_turns: fold the pmf's tail
        # mass onto the cap so truncation isn't misread as infidelity.
        cap = int(max_turns)
        folded: Dict[int, float] = {}
        for v, p in pmf:
            folded[min(v, cap)] = folded.get(min(v, cap), 0.0) + p
        pmf = sorted(folded.items())
    report.checks.append(Check(
        "turns_per_session", tv_distance(turn_counts, pmf),
        tv_tolerance(len(turn_counts), len(pmf)), len(turn_counts),
    ))
    return report
