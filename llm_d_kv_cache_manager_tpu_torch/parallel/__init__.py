"""Tensor, data, sequence and pipeline parallelism over torch.distributed.

The reference package's exports, resolved on first use: the model code
imports `parallel.collectives`, and `parallel.pipeline` imports the model
code, so the package itself imports neither eagerly.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh",
    "param_shardings": "mesh",
    "shard_params": "mesh",
    "ring_attention": "ring_attention",
    "pipeline_forward": "pipeline",
    "initialize_distributed": "multihost",
    "make_hybrid_mesh": "multihost",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
