"""Flash prefill: causal blockwise attention for the serving prefill path.

Port of the reference package's `ops/flash_prefill.py`.

- `dense_attention`: the plain torch version, a port of the reference
  `models/llama._dense_attention` (the TPU kernel's own oracle). Operands
  are upcast to f32 (exact for bf16, so the products equal bf16 x bf16 -> f32
  accumulation), the softmax runs in f32, and the weights are cast to the V
  dtype before the second product, as on the TPU.
- `flash_prefill`: the wrapper. On CUDA tensors it launches the hand-written
  kernel `csrc/flash_prefill.cu`; on CPU tensors it runs `dense_attention`.

Semantics: q position i (of batch b) attends k positions
<= causal_offset[b] + i, optionally windowed to
(causal_offset[b] + i - window, causal_offset[b] + i]. A row with no valid
key yields zeros.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

launches = 0  # flash_prefill kernel launches (CUDA path only)

# The bf16 (wgmma) and the f32 (CUDA-core) kernels take every head_dim (up
# to 256 built at the padded widths 64, 128 and 256; above it in column
# slabs of 256 over panels of 256) and any GQA group (a group above a tile's
# rows splits over CTAs).
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

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


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C signature of csrc/flash_prefill.cu's entry point.
_ARGTYPES = {"kvt_flash_prefill": [_P] * 4 + [_I, _P] + [_I] * 7 + [ctypes.c_float, _I, _P]}


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
    err = _kernel().kvt_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if offs is None else offs.data_ptr(),
        shared, out.data_ptr(), b, l, s, n_q, n_kv, hd, -1 if window is None else int(window),
        1.0 / (hd**0.5), _DTYPE_CODE[q.dtype],
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
