"""Multi-process mesh construction: fast axes inside a node, slow across.

Port of the reference package's `parallel/multihost.py`. The reference
scales the fleet with N independent pods (SURVEY.md §2.6); this module
scales ONE engine over processes: a hybrid mesh whose fast axes (tp, sp)
stay inside a node and whose outer axis (dp, or pp stages) crosses nodes.

Torch names the processes itself: `initialize_distributed` starts the
default process group once, and `make_hybrid_mesh` lays a DeviceMesh over
its ranks with the cross-node axes outermost, so consecutive ranks (one
node's) share the inner axes.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device

_initialized = False


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: Optional[timedelta] = None,
):
    """Start the default process group (idempotent); returns it, or None in
    a single process.

    Three modes:
    - explicit: `init_method` (e.g. "tcp://host:port" or "file:///path")
      with `world_size` and `rank`;
    - env: a launcher (torchrun) set MASTER_ADDR, RANK and WORLD_SIZE, and
      the group starts from `init_method="env://"`;
    - neither: a single-process run, a no-op.
    `backend` defaults to nccl with a GPU and gloo without (two ranks on
    one card need gloo: NCCL refuses two ranks on one device); `timeout`
    bounds each collective (torch's default otherwise).

    The guard is a module flag, as in the reference, so a second call
    returns the running group instead of starting another."""
    global _initialized
    if _initialized:
        return dist.group.WORLD
    backend = backend or _default_backend()
    extra = {} if timeout is None else {"timeout": timeout}
    if init_method is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE")):
            return None  # single-process run
        dist.init_process_group(backend, init_method="env://", **extra)
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, **extra)
    _initialized = True
    return dist.group.WORLD


def make_hybrid_mesh(
    ici_axes: dict,
    dcn_axes: Optional[dict] = None,
    device="cuda",
):
    """A DeviceMesh with `dcn_axes` outermost and `ici_axes` inside, e.g.
    make_hybrid_mesh({"tp": 4, "sp": 2}, {"dp": 2}) over 16 ranks. Axes of
    size 1 are kept, so specs that name them work unchanged."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    dcn_axes = dict(dcn_axes or {})
    ici_axes = dict(ici_axes)
    axis_names = tuple(dcn_axes) + tuple(ici_axes)
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    n_needed = int(np.prod(shape)) if shape else 1
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n_needed:
        raise ValueError(
            f"hybrid mesh {dict(zip(axis_names, shape))} needs {n_needed} "
            f"devices, have {have}"
        )
    return init_device_mesh(device.type, shape or (1,),
                            mesh_dim_names=axis_names or ("dp",))
