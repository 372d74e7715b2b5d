"""JSON config loading for the whole module tree.

Copy of the reference package's `config.py`, after the Go reference's
JSON-serializable nested config structs (docs/configuration.md,
indexer.go): every module has
a dataclass config with working defaults; this module round-trips the whole
IndexerConfig tree to/from JSON so deployments can ship one config file.

Keys are the dataclass field names; unknown keys error loudly (config typos
must not silently fall back to defaults — the hash_seed/block_size
invariants make silent fallback dangerous).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")


def _from_dict(cls: Type[T], data: Dict[str, Any], path: str = "") -> T:
    if not dataclasses.is_dataclass(cls):
        return data  # leaf passthrough (e.g. plain values)
    fields = {f.name for f in dataclasses.fields(cls)}
    # get_type_hints resolves string/Optional annotations against the class's
    # module; forward references to classes the module deliberately does not
    # import (index.py avoids circular imports) resolve via localns.
    hints = typing.get_type_hints(cls, localns=_forward_refs())
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise ValueError(f"unknown config key {path + key!r} for {cls.__name__}")
        resolved = _unwrap(hints.get(key))
        if dataclasses.is_dataclass(resolved) and isinstance(value, dict):
            kwargs[key] = _from_dict(resolved, value, path=f"{path}{key}.")
        elif isinstance(value, list):
            item_type = _list_item_type(hints.get(key))
            if dataclasses.is_dataclass(item_type):
                kwargs[key] = [
                    _from_dict(item_type, v, path=f"{path}{key}[].") for v in value
                ]
            else:
                kwargs[key] = value
        else:
            kwargs[key] = value
    return cls(**kwargs)


def _unwrap(annotation):
    """Unwrap Optional[X] / Union[X, None] to X (unions only, not List etc.)."""
    if annotation is None:
        return None
    if typing.get_origin(annotation) is typing.Union:
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if args:
            return args[0]
    return annotation


def _list_item_type(annotation):
    resolved = _unwrap(annotation)
    if typing.get_origin(resolved) in (list, tuple):
        args = typing.get_args(resolved)
        return args[0] if args else None
    return None


def _forward_refs() -> Dict[str, type]:
    """Classes referenced by string annotations across the config tree."""
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.cost_aware import (
        CostAwareIndexConfig,
    )
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import (
        InMemoryIndexConfig,
    )
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.redis_index import (
        RedisIndexConfig,
    )

    return {
        "InMemoryIndexConfig": InMemoryIndexConfig,
        "CostAwareIndexConfig": CostAwareIndexConfig,
        "RedisIndexConfig": RedisIndexConfig,
    }


def indexer_config_from_json(payload: str):
    """Build an IndexerConfig from a JSON document."""
    from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import IndexerConfig

    return _from_dict(IndexerConfig, json.loads(payload))


def config_to_json(config) -> str:
    """Serialize any config dataclass tree to JSON."""
    def encode(obj):
        if dataclasses.is_dataclass(obj):
            return {
                f.name: encode(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
            }
        if isinstance(obj, (list, tuple)):
            return [encode(x) for x in obj]
        return obj

    return json.dumps(encode(config), indent=2, default=str)
