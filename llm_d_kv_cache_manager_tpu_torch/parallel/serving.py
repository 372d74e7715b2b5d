"""Tensor-parallel sharding for the serving path (paged prefill and decode).

Port of the reference package's `parallel/serving.py`. A tp pod runs one
model replica over the ranks of a "tp" group and is still ONE pod to the
control plane (one pod id, one event stream, one index entry):

- Weights: the training path's Megatron specs (parallel/mesh.param_specs),
  so the two cannot diverge. Each rank keeps its own slice.
- KV pages: split over the KV-HEAD axis. Every cache component is
  [n_layers, n_kv_heads, n_pages, page_size, ...], so each rank holds its
  heads' rows of EVERY page id. The block table stays host state, the same
  on every rank: page allocation (engine/block_manager.py) is
  tp-invariant, and a block is resident iff every rank holds its head
  shard of the page.
- The paged paths (models/llama.py, `group=`) project onto the rank's
  heads, run the attention kernels on them, all-reduce after wo and
  w_down and gather the vocab-parallel logits.

tp must divide n_kv_heads (and n_q_heads): the head-major page layout makes
the kv-head axis the natural split.
"""

from __future__ import annotations

from typing import Tuple

from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import (
    MeshLike,
    placement,
    mesh_coords,
    shard_params,
    shard_tensor,
)
from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device

# Every cache component, [n_layers, n_kv_heads, n_pages, page_size, ...],
# splits its head axis.
KV_SPEC = (None, "tp", None, None, None)


def tp_mesh(tp: int, device="cuda"):
    """A 1-D ("tp",) DeviceMesh over the tp ranks of the default group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < tp:
        raise ValueError(f"need {tp} devices for tp={tp}, have {have}")
    return init_device_mesh(device.type, (tp,), mesh_dim_names=("tp",))


def kv_cache_shardings(mesh: MeshLike, n_components: int) -> Tuple[tuple, ...]:
    """This rank's (dim, chunk index, chunks) of each component of a paged
    KV cache tuple, bf16 (k, v) or int8 (k_q, k_scale, v_q, v_scale)."""
    at = mesh_coords(mesh)
    return tuple(placement(KV_SPEC, at) for _ in range(n_components))


def shard_serving_params(params: dict, mesh: MeshLike) -> dict:
    """This rank's weights under the Megatron specs (parallel/mesh.py)."""
    return shard_params(params, mesh)


def shard_kv_cache(kv_cache: tuple, mesh: MeshLike) -> tuple:
    """This rank's head shard of a paged KV cache (either format)."""
    return tuple(shard_tensor(c, KV_SPEC, mesh) for c in kv_cache)


def validate_tp(tp: int, n_q_heads: int, n_kv_heads: int) -> None:
    if n_kv_heads % tp or n_q_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={n_kv_heads} and "
            f"n_q_heads={n_q_heads} (head-sharded KV pages)"
        )
