"""Canonical JSONL trace format: record/replay for workload traces.

One trace file = one header line + one line per session + one line per
turn, each a single JSON object tagged by "kind":

    {"kind": "header", "schema": "kvtpu-workload-trace/v1",
     "workload": "sharegpt", "seed": 42, "tables_version": "sharegpt-v1",
     "config": {...}}
    {"kind": "session", "id": "s0", "system_prefix": "..."}
    {"kind": "session", "id": "s1", "system_prefix": "...",
     "region": "region-2"}   # optional home-region pin (workloads.geo)
    {"kind": "turn", "arrival_s": 0.71, "session": "s0", "turn": 0,
     "user_len": 28, "output_len": 170, "user_text": "...",
     "response_text": "..."}

Turns store DELTA text (see workloads.spec): the grown prompts are derived
by `WorkloadTrace.materialize()`, so a recorded trace replays
bit-identically — `read_trace(write_trace(t)) == t`, and both benches
serve the exact same prompt stream from the same file. Sessions and turns
are written in deterministic order (session id; arrival order), so equal
traces produce byte-identical files.

Unknown "kind" lines error loudly: a trace is an input to a benchmark
headline, and silently skipping records would quietly change the measured
workload.
"""

from __future__ import annotations

import json
from typing import IO, Iterable, List, Union

from llm_d_kv_cache_manager_tpu_torch.workloads.spec import TraceTurn, WorkloadTrace

SCHEMA = "kvtpu-workload-trace/v1"


def _dump(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True, ensure_ascii=False)


def trace_lines(trace: WorkloadTrace) -> Iterable[str]:
    yield _dump({
        "kind": "header",
        "schema": SCHEMA,
        "workload": trace.workload,
        "seed": trace.seed,
        "tables_version": trace.tables_version,
        "config": trace.config,
    })
    for session_id in sorted(trace.sessions):
        rec = {
            "kind": "session",
            "id": session_id,
            "system_prefix": trace.sessions[session_id],
        }
        # Optional home region (workloads.geo). Emitted ONLY when the
        # session is pinned, so a region-free trace serializes exactly as
        # it did before the field existed — strict back-compat both ways
        # (old readers never see the key; old files round-trip byte-
        # identically through new writers).
        region = trace.session_regions.get(session_id)
        if region is not None:
            rec["region"] = region
        yield _dump(rec)
    for t in trace.turns:
        yield _dump({
            "kind": "turn",
            "arrival_s": t.arrival_s,
            "session": t.session,
            "turn": t.turn,
            "user_len": t.user_len,
            "output_len": t.output_len,
            "user_text": t.user_text,
            "response_text": t.response_text,
        })


def write_trace(trace: WorkloadTrace, path_or_file: Union[str, IO[str]]) -> None:
    if isinstance(path_or_file, str):
        with open(path_or_file, "w", encoding="utf-8") as f:
            write_trace(trace, f)
        return
    for line in trace_lines(trace):
        path_or_file.write(line + "\n")


def read_trace(path_or_file: Union[str, IO[str]]) -> WorkloadTrace:
    if isinstance(path_or_file, str):
        with open(path_or_file, encoding="utf-8") as f:
            return read_trace(f)

    header = None
    sessions = {}
    session_regions = {}
    turns: List[TraceTurn] = []
    for lineno, line in enumerate(path_or_file, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            raise ValueError(f"trace line {lineno}: bad JSON: {e}") from e
        kind = rec.get("kind")
        if kind == "header":
            if header is not None:
                raise ValueError(f"trace line {lineno}: duplicate header")
            if rec.get("schema") != SCHEMA:
                raise ValueError(
                    f"trace line {lineno}: schema {rec.get('schema')!r} "
                    f"is not {SCHEMA!r}"
                )
            header = rec
        elif kind == "session":
            if header is None:
                raise ValueError(f"trace line {lineno}: session before header")
            sessions[rec["id"]] = rec["system_prefix"]
            if "region" in rec:
                session_regions[rec["id"]] = rec["region"]
        elif kind == "turn":
            if header is None:
                raise ValueError(f"trace line {lineno}: turn before header")
            turns.append(TraceTurn(
                arrival_s=float(rec["arrival_s"]),
                session=rec["session"],
                turn=int(rec["turn"]),
                user_len=int(rec["user_len"]),
                output_len=int(rec["output_len"]),
                user_text=rec["user_text"],
                response_text=rec["response_text"],
            ))
        else:
            raise ValueError(f"trace line {lineno}: unknown kind {kind!r}")
    if header is None:
        raise ValueError("trace has no header line")
    return WorkloadTrace(
        workload=header["workload"],
        seed=int(header["seed"]),
        config=header.get("config", {}),
        tables_version=header["tables_version"],
        sessions=sessions,
        turns=turns,
        session_regions=session_regions,
    )
