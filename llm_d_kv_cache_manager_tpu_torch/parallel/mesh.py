"""Device mesh and sharding rules for the flagship model.

Port of the reference package's `parallel/mesh.py`. Axes:

- "dp": data parallel, the batch dimension of activations.
- "tp": tensor parallel, attention heads and the MLP hidden dimension
  (Megatron: column-parallel wq/wk/wv/w_gate/w_up, row-parallel wo/w_down,
  a vocab-parallel output projection). Per layer the forward needs two
  all-reduces (after wo and after w_down), which the model code calls
  itself (parallel/collectives.py): torch inserts no collective.
- "sp": sequence parallel for long context, in parallel/ring_attention.py.

A spec is the reference's PartitionSpec as a plain tuple: one entry per
tensor dim, the mesh axis that dim is split over or None. `shard_params`
returns THIS rank's slice of every tensor, so each process keeps its own
shard; a `MeshCoords` names a mesh position without any process group
(the slices any rank of a mesh would hold).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch

from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device

Spec = Tuple[object, ...]


@dataclass(frozen=True)
class MeshCoords:
    """One position on a named mesh: each axis's size and this position's
    coordinate on it."""

    sizes: Dict[str, int]
    coords: Dict[str, int]


def mesh_coords(mesh) -> MeshCoords:
    """This rank's MeshCoords on a DeviceMesh (a MeshCoords passes through)."""
    if isinstance(mesh, MeshCoords):
        return mesh
    names = mesh.mesh_dim_names
    return MeshCoords(
        sizes={n: mesh.size(i) for i, n in enumerate(names)},
        coords={n: mesh.get_local_rank(n) for n in names},
    )


MeshLike = Union[MeshCoords, object]  # a MeshCoords or a DeviceMesh


def make_mesh(dp: int = 1, tp: int = 1, device="cuda"):
    """A ("dp", "tp") DeviceMesh over the dp * tp ranks of the default
    process group (parallel/multihost.initialize_distributed starts it)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    need = dp * tp
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise ValueError(f"need {need} devices for dp={dp} x tp={tp}, have {have}")
    return init_device_mesh(device.type, (dp, tp), mesh_dim_names=("dp", "tp"))


# Specs of one decoder layer's stacked params ([n_layers, ...]).
_LAYER_SPECS: Dict[str, Spec] = {
    "attn_norm": (None, None),
    "wq": (None, None, "tp"),
    "wk": (None, None, "tp"),
    "wv": (None, None, "tp"),
    "wo": (None, "tp", None),
    "mlp_norm": (None, None),
    "w_gate": (None, None, "tp"),
    "w_up": (None, None, "tp"),
    "w_down": (None, "tp", None),
}


def param_specs(attn_bias: bool = False) -> Dict:
    """Spec tree matching models.llama.init_params. `attn_bias` adds the
    Qwen2-family bq/bk/bv rows: each bias lives on its projection's output
    dim, so it splits over "tp" as the column-parallel weight it adds onto
    ([n_layers, q_dim / kv_dim])."""
    layers = dict(_LAYER_SPECS)
    if attn_bias:
        layers.update({"bq": (None, "tp"), "bk": (None, "tp"), "bv": (None, "tp")})
    return {
        "embed": (None, None),  # replicated; activations gather from it
        "layers": layers,
        "final_norm": (None,),
        "out": (None, "tp"),  # vocab-parallel logits
    }


def param_shardings(mesh: MeshLike, attn_bias: bool = False) -> Dict:
    """For each param, this rank's (dim, chunk index, chunks) per split dim:
    the slices `shard_params` takes."""
    at = mesh_coords(mesh)
    return _map_specs(param_specs(attn_bias), lambda spec: placement(spec, at))


def _map_specs(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_specs(v, fn) for k, v in tree.items()}
    return fn(tree)


def placement(spec: Spec, at: MeshCoords) -> Tuple[Tuple[int, int, int], ...]:
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in at.sizes:
            raise ValueError(f"spec {spec} names mesh axis {axis!r}; the mesh has {tuple(at.sizes)}")
        out.append((dim, at.coords[axis], at.sizes[axis]))
    return tuple(out)


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: MeshLike) -> torch.Tensor:
    """This rank's slice of `t` under `spec` (contiguous; the full tensor
    when nothing splits)."""
    for dim, index, chunks in placement(spec, mesh_coords(mesh)):
        if t.shape[dim] % chunks:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split {chunks} ways")
        t = t.chunk(chunks, dim=dim)[index]
    return t.contiguous()


def shard_tree(params: Dict, specs: Dict, mesh: MeshLike) -> Dict:
    """`shard_tensor` over a param tree and its spec tree."""
    at = mesh_coords(mesh)
    return {k: shard_tree(v, specs[k], at) if isinstance(v, dict) else shard_tensor(v, specs[k], at)
            for k, v in params.items()}


def shard_params(params: Dict, mesh: MeshLike) -> Dict:
    """This rank's shard of a param tree. The bias rows' presence is read
    off the tree itself, so callers never pass a flag the params encode."""
    return shard_tree(params, param_specs(attn_bias="bq" in params["layers"]), mesh)


def batch_sharding(batch: torch.Tensor, mesh: MeshLike) -> torch.Tensor:
    """This rank's rows of a batch (split over "dp", replicated over "tp")."""
    return shard_tensor(batch, ("dp", None), mesh)
