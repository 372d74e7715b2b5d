"""Compatibility shim — the workload machinery moved to
llm_d_kv_cache_manager_tpu_torch.workloads (synthetic backend:
workloads/synthetic.py; ShareGPT-shaped trace engine: workloads/sharegpt.py).

Kept so existing imports (`from llm_d_kv_cache_manager_tpu_torch.utils.workload
import text, shared_prefix_conversations`) keep working unchanged.
"""

from __future__ import annotations

from llm_d_kv_cache_manager_tpu_torch.workloads.synthetic import (  # noqa: F401
    WORDS,
    shared_prefix_conversations,
    text,
)

__all__ = ["WORDS", "text", "shared_prefix_conversations"]
