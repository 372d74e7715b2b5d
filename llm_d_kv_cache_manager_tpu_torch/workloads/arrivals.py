"""Open-loop arrival processes for the workload engine.

Open-loop means the arrival stream is scripted up-front and never depends
on measured service times — the regime where routing quality compounds
through queueing (the reference's headline runs; a closed-loop driver can
never overload a pod). Two session-arrival processes:

- "poisson": memoryless arrivals at a constant rate — the steady-traffic
  baseline every queueing result assumes.
- "bursty": an ON-OFF modulated Poisson process (interrupted Poisson):
  arrivals at an elevated rate during ON windows, silence during OFF.
  The ON rate is scaled so the long-run mean rate equals `rate`, which
  makes poisson-vs-bursty comparisons at equal offered load meaningful.

Per-session think time (the gap between a response and the same user's
next message) is exponential around a mean, plus a read-time term
proportional to the response length — a user who received 800 tokens
replies later than one who received 20.
"""

from __future__ import annotations

import random
from typing import Iterator


def poisson_arrivals(rng: random.Random, rate_per_s: float) -> Iterator[float]:
    """Infinite stream of absolute arrival times at `rate_per_s`."""
    if rate_per_s <= 0:
        raise ValueError(f"rate_per_s must be > 0, got {rate_per_s}")
    t = 0.0
    while True:
        t += rng.expovariate(rate_per_s)
        yield t


def on_off_arrivals(
    rng: random.Random,
    rate_per_s: float,
    on_s: float = 10.0,
    off_s: float = 20.0,
) -> Iterator[float]:
    """Interrupted-Poisson arrivals: Poisson bursts during ON windows of
    `on_s` seconds, nothing during OFF windows of `off_s` seconds. The
    burst rate is `rate * (on+off)/on`, so the long-run mean equals the
    plain Poisson process at the same `rate_per_s`."""
    if rate_per_s <= 0:
        raise ValueError(f"rate_per_s must be > 0, got {rate_per_s}")
    if on_s <= 0 or off_s < 0:
        raise ValueError(f"invalid ON/OFF durations: on={on_s} off={off_s}")
    burst_rate = rate_per_s * (on_s + off_s) / on_s
    window_start = 0.0
    t = 0.0
    while True:
        window_end = window_start + on_s
        t = max(t, window_start)
        while True:
            t += rng.expovariate(burst_rate)
            if t >= window_end:
                break
            yield t
        window_start = window_end + off_s


def arrival_process(
    name: str,
    rng: random.Random,
    rate_per_s: float,
    on_s: float = 10.0,
    off_s: float = 20.0,
) -> Iterator[float]:
    if name == "poisson":
        return poisson_arrivals(rng, rate_per_s)
    if name == "bursty":
        return on_off_arrivals(rng, rate_per_s, on_s=on_s, off_s=off_s)
    raise ValueError(f"unknown arrival process: {name!r}")


def think_time_s(
    rng: random.Random,
    mean_s: float,
    response_len: int,
    read_s_per_unit: float,
) -> float:
    """Gap between receiving a response and sending the next message."""
    gap = rng.expovariate(1.0 / mean_s) if mean_s > 0 else 0.0
    return gap + read_s_per_unit * max(int(response_len), 0)
