"""Trace-driven workload engine for the fleet benches.

The BASELINE metric is defined over a **ShareGPT replay**; this package
makes that measurable without network egress:

- `tables`    — committed ShareGPT length/turn quantile tables (vendored
                data, versioned, provenance documented).
- `sharegpt`  — deterministic multi-turn session generator matching those
                tables; conversations grow by concatenating prior turns
                (the mechanism that creates prefix-cache hits).
- `arrivals`  — open-loop Poisson / bursty ON-OFF arrival processes with
                per-session think time.
- `spec`      — the in-memory trace model (`WorkloadTrace`, delta-text
                turns, deterministic `materialize()` into full prompts).
- `trace`     — canonical JSONL record/replay (bit-identical round-trip,
                shared by bench.py and the device harness).
- `stats`     — sampling helpers + KS/TV fidelity validation of generated
                traces against the committed tables.
- `synthetic` — the historical word-salad backend (both benches' default,
                kept for artifact continuity; formerly utils/workload.py).
- `multitenant`/`geo`/`agentic` — scenario generators over the same trace
                model: Zipf tenant mixes, home-pinned diurnal regions,
                and fan-out/fan-in sub-agent sessions branching off a
                shared tool prefix (the anticipatory-prefetch bench's
                best-case replay).
- `adversarial` — the resource governor's stress diet: unique-prompt
                floods, session explosions, and churn storms with a
                deterministic pod join/leave schedule.
"""

from llm_d_kv_cache_manager_tpu_torch.workloads.adversarial import (  # noqa: F401
    ChurnStormConfig,
    FloodConfig,
    SessionExplosionConfig,
    churn_schedule,
    generate_churn_storm,
    generate_flood,
    generate_session_explosion,
    transient_pod_name,
)
from llm_d_kv_cache_manager_tpu_torch.workloads.agentic import (  # noqa: F401
    AgenticConfig,
    is_root,
    task_of,
)
from llm_d_kv_cache_manager_tpu_torch.workloads.agentic import (  # noqa: F401
    generate as generate_agentic,
)
from llm_d_kv_cache_manager_tpu_torch.workloads.geo import (  # noqa: F401
    GeoConfig,
    diurnal_weights,
    region_name,
)
from llm_d_kv_cache_manager_tpu_torch.workloads.geo import (  # noqa: F401
    generate as generate_geo,
)
from llm_d_kv_cache_manager_tpu_torch.workloads.multitenant import (  # noqa: F401
    MultiTenantConfig,
    tenant_of,
    tenant_weights,
)
from llm_d_kv_cache_manager_tpu_torch.workloads.multitenant import (  # noqa: F401
    generate as generate_multitenant,
)
from llm_d_kv_cache_manager_tpu_torch.workloads.sharegpt import (  # noqa: F401
    ShareGPTConfig,
    generate,
    uniform_control,
)
from llm_d_kv_cache_manager_tpu_torch.workloads.spec import (  # noqa: F401
    MaterializedRequest,
    TraceTurn,
    WorkloadTrace,
)
from llm_d_kv_cache_manager_tpu_torch.workloads.trace import (  # noqa: F401
    read_trace,
    write_trace,
)

__all__ = [
    "AgenticConfig",
    "ChurnStormConfig",
    "FloodConfig",
    "GeoConfig",
    "SessionExplosionConfig",
    "churn_schedule",
    "generate_churn_storm",
    "generate_flood",
    "generate_session_explosion",
    "transient_pod_name",
    "MultiTenantConfig",
    "ShareGPTConfig",
    "diurnal_weights",
    "generate",
    "generate_agentic",
    "generate_geo",
    "generate_multitenant",
    "is_root",
    "region_name",
    "task_of",
    "tenant_of",
    "tenant_weights",
    "uniform_control",
    "MaterializedRequest",
    "TraceTurn",
    "WorkloadTrace",
    "read_trace",
    "write_trace",
]
