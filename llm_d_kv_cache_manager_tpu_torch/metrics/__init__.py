from llm_d_kv_cache_manager_tpu_torch.metrics.collector import (
    register_metrics,
    start_metrics_logging,
)

__all__ = ["register_metrics", "start_metrics_logging"]
