"""Flash prefill: causal blockwise attention for the serving prefill path.

Port of the reference package's `ops/flash_prefill.py`.

- `dense_attention`: the plain torch version, a port of the reference
  `models/llama._dense_attention` (the TPU kernel's own oracle). Operands
  are upcast to f32 (exact for bf16, so the products equal bf16 x bf16 -> f32
  accumulation), the softmax runs in f32, and the weights are cast to the V
  dtype before the second product, as on the TPU.
- `flash_prefill`: the wrapper. On CUDA tensors it launches the hand-written
  kernel `csrc/flash_prefill.cu`; on CPU tensors it runs `dense_attention`.
- `wide_plan`: the launch shape of the bf16 kernel above head_dim 256 (a
  cluster of panels x key splits per query tile up to 2,048; above it one
  CTA per slab), from the shapes alone.

Semantics: q position i (of batch b) attends k positions
<= causal_offset[b] + i, optionally windowed to
(causal_offset[b] + i - window, causal_offset[b] + i]. A row with no valid
key yields zeros.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

launches = 0  # flash_prefill kernel launches (CUDA path only)

# The bf16 (wgmma) and the f32 (CUDA-core) kernels take every head_dim (up
# to 256 built at the padded widths 64, 128 and 256; above it in panels of
# 256) and any GQA group (a group above a tile's rows splits over CTAs).
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PANEL = 256  # a wide head's panel (csrc/row_copy.cuh)
_ROWS = 64  # tile rows of the wide bf16 kernel's CTA (one computing warpgroup)
_MAX_CLUSTER = 8  # the portable cluster size

Offset = Union[int, torch.Tensor]


def _check_grouping(n_q: int, n_kv: int) -> int:
    group = n_q // n_kv
    if group * n_kv != n_q:
        raise ValueError(f"n_q {n_q} not divisible by n_kv {n_kv}")
    return group


def _offsets(causal_offset: Offset, batch: int, device) -> torch.Tensor:
    if isinstance(causal_offset, int):  # filled on the device: no host copy
        return torch.full((batch,), causal_offset, dtype=torch.int32, device=device)
    return torch.as_tensor(causal_offset, device=device).to(torch.int32).expand(batch)


def dense_attention(
    q: torch.Tensor,  # [B, L, n_q, hd]
    k: torch.Tensor,  # [B, S, n_kv, hd]
    v: torch.Tensor,
    causal_offset: Offset,  # scalar or [B]
    window: Optional[int] = None,
) -> torch.Tensor:
    b, l, n_q, hd = q.shape
    n_kv = k.shape[2]
    group = _check_grouping(n_q, n_kv)
    qg = q.reshape(b, l, n_kv, group, hd)
    scores = torch.einsum("blhgd,bshd->bhgls", qg.float(), k.float()) / (hd**0.5)
    q_pos = torch.arange(l, device=q.device)[None, :, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    offset = _offsets(causal_offset, b, q.device).long()[:, None, None]
    mask = k_pos <= q_pos + offset  # [B, L, S]
    if window is not None:
        mask = mask & (k_pos > q_pos + offset - window)
    mask = mask[:, None, None]
    weights = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    # A row with no valid key (softmax of all -inf is NaN) yields zeros, as
    # the kernel's l == 0 guard does.
    weights = torch.where(mask.any(dim=-1, keepdim=True), weights, 0.0)
    out = torch.einsum(
        "bhgls,bshd->blhgd", weights.to(v.dtype).float(), v.float()
    )
    return out.reshape(b, l, n_q, hd).to(q.dtype)


def head_chunk(group: int, rows: int) -> int:
    """Query heads a CTA of `rows` tile rows takes of a GQA group: the whole
    group up to `rows`, else an even share of ceil(group / rows) chunks
    (`head_chunk` in csrc/flash_prefill.cu)."""
    if group <= rows:
        return group
    n = -(-group // rows)
    return -(-group // n)


def wide_plan(batch: int, q_len: int, n_q: int, n_kv: int, head_dim: int,
              n_sms: int) -> tuple:
    """(n_panels, key_splits) of the bf16 kernel above head_dim 256: each
    query tile of 64 rows is a cluster of n_panels x key_splits CTAs, one a
    panel of 256 columns and split of the tile's key blocks. The splits are
    the most that keep the grid within one CTA per SM and the cluster within
    the portable 8 (at least 1): the serving chunk of 4/2 heads of 512 (32
    tiles x 2 panels) takes 2 on 132 SMs, a 2,048-token chunk 1. Above
    head_dim 2,048 (more than 8 panels) no cluster holds the panels: the
    kernel walks them in one CTA per slab, key_splits 1."""
    n_pan = -(-head_dim // _PANEL)
    if n_pan > _MAX_CLUSTER:
        return n_pan, 1
    group = n_q // n_kv
    gc = head_chunk(group, _ROWS)
    tiles = batch * n_kv * -(-group // gc) * -(-q_len // (_ROWS // gc))
    return n_pan, max(1, min(_MAX_CLUSTER // n_pan, n_sms // (tiles * n_pan)))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C signature of csrc/flash_prefill.cu's entry point.
_ARGTYPES = {"kvt_flash_prefill": [_P] * 4 + [_I, _P] + [_I] * 8 + [ctypes.c_float, _I, _P]}


def _kernel() -> ctypes.CDLL:
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    lib = _build.library("flash_prefill")
    fn = lib.kvt_flash_prefill
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES["kvt_flash_prefill"]
        fn.restype = _I
    return lib


def _launch(q, k, v, causal_offset, window) -> torch.Tensor:
    global launches
    b, l, n_q, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    group = n_q // n_kv
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_prefill: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_prefill kernel takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if k.shape != (b, s, n_kv, hd) or v.shape != k.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("flash_prefill kernel needs contiguous, 16-byte aligned q/k/v")
    out = torch.empty_like(q)
    # A shared offset rides as a kernel argument (no host-to-device copy);
    # per-batch offsets are read from the device.
    offs, shared = None, 0
    if isinstance(causal_offset, int):
        shared = causal_offset
    else:
        offs = _offsets(causal_offset, b, q.device).contiguous()
    lib = _kernel()
    key_splits = 1
    if q.dtype == torch.bfloat16 and hd > _PANEL:
        key_splits = wide_plan(b, l, n_q, n_kv, hd, _sm_count(q.device))[1]
    err = lib.kvt_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if offs is None else offs.data_ptr(),
        shared, out.data_ptr(), b, l, s, n_q, n_kv, hd, -1 if window is None else int(window),
        key_splits, 1.0 / (hd**0.5), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def flash_prefill(
    q: torch.Tensor,  # [B, L, n_q, hd]
    k: torch.Tensor,  # [B, S, n_kv, hd]
    v: torch.Tensor,  # [B, S, n_kv, hd]
    causal_offset: Offset,  # scalar or [B] int32
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal attention with per-batch offsets: the CUDA kernel for CUDA
    tensors, `dense_attention` for CPU tensors."""
    _check_grouping(q.shape[2], k.shape[2])
    if q.is_cuda:
        return _launch(q, k, v, causal_offset, window)
    return dense_attention(q, k, v, causal_offset, window=window)
