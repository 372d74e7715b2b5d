"""obs: the SLO monitor (`slo.py`).

The reference package's tracing spine (spans, the flight recorder, score
explain surfaces) and its metrics-backed objectives come with the port's
metrics collector and service surfaces (ROADMAP.md queue 1 item 7).
"""
