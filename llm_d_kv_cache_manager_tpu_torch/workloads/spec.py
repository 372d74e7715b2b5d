"""Canonical in-memory trace model for the workload engine.

A workload — generated (workloads.sharegpt) or replayed from JSONL
(workloads.trace) — is a `WorkloadTrace`: per-session shared system
prefixes plus a time-ordered stream of `TraceTurn`s. Turns carry DELTA
text (the new user message and the scripted assistant response), never the
full grown prompt: the grown prompt for turn t of a session is derived
deterministically by `materialize()`, which concatenates the session's
prior turns exactly the way both benches do ("... [user] q" then
"... [assistant] r"). Storing deltas keeps the JSONL linear in
conversation length instead of quadratic, and makes record→replay
bit-identical by construction: the prompt stream is a pure function of the
trace content.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple


@dataclass(frozen=True)
class TraceTurn:
    """One request of the workload, in arrival order.

    `user_len` / `output_len` are the sampled lengths (length units — the
    word counts of `user_text` / `response_text`); they are recorded
    explicitly so distribution validation (workloads.stats) never has to
    re-derive them from text.
    """

    arrival_s: float
    session: str
    turn: int
    user_len: int
    output_len: int
    user_text: str
    response_text: str


@dataclass(frozen=True)
class MaterializedRequest:
    """A served request: the fully grown prompt for one trace turn.

    `region` is the session's home region when the trace pins one
    (workloads.geo), else None — trailing default, so every pre-geo
    construction site is untouched.
    """

    arrival_s: float
    session: str
    turn: int
    prompt: str
    output_len: int
    region: Optional[str] = None


@dataclass
class WorkloadTrace:
    workload: str  # "sharegpt" | "synthetic" | ...
    seed: int
    config: Dict  # JSON-serializable generator config (provenance)
    tables_version: str
    # session id -> shared system prefix text ("" when the session has none)
    sessions: Dict[str, str] = field(default_factory=dict)
    turns: List[TraceTurn] = field(default_factory=list)
    # session id -> home region (workloads.geo). Sparse and strictly
    # optional: traces recorded before the geo workload carry no regions,
    # read back with this empty, and re-serialize byte-identically.
    session_regions: Dict[str, str] = field(default_factory=dict)

    def materialize(self) -> Iterator[MaterializedRequest]:
        """Yield the full-prompt request stream in arrival order.

        Deterministic: prompts are a pure function of the trace, so two
        materializations of equal traces are identical — the property the
        record/replay round-trip test pins.
        """
        history: Dict[str, str] = dict(self.sessions)
        for t in self.turns:
            prompt = history[t.session] + " [user] " + t.user_text
            yield MaterializedRequest(
                arrival_s=t.arrival_s,
                session=t.session,
                turn=t.turn,
                prompt=prompt,
                output_len=t.output_len,
                region=self.session_regions.get(t.session),
            )
            history[t.session] = prompt + " [assistant] " + t.response_text

    def requests(self) -> List[MaterializedRequest]:
        return list(self.materialize())

    def turn_counts(self) -> Dict[str, int]:
        """Turns per session, for distribution validation."""
        counts: Dict[str, int] = {}
        for t in self.turns:
            counts[t.session] = max(counts.get(t.session, 0), t.turn + 1)
        return counts

    def sorted_key(self) -> List[Tuple[float, str, int]]:
        return [(t.arrival_s, t.session, t.turn) for t in self.turns]
