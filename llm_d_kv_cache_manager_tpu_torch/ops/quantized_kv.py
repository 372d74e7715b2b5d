"""Int8-quantized KV pages: half the device memory per cached token.

Port of the reference package's `ops/quantized_kv.py`. Storing pages as int8
with per-row scales halves the bytes per token against bf16, so a pod keeps
twice the prefixes resident (more prefix hits to route to) and the decode
kernels read half the bytes.

Scheme: symmetric per-row quantization. For each cached row (one token's K or
V vector of one kv head), scale = amax/127 and q = round(x/scale) in
[-127, 127]. Pools keep the reference layout: int8 values
`[n_kv, n_pages, page, hd]` and f32 scales `[n_kv, n_pages, page, 1]`.

- `paged_attention_quantized_reference`: the plain version (dequantize,
  round to q's dtype as the reference does, then `paged_attention_reference`).
- `paged_attention_quantized`: the wrapper. On CUDA tensors it launches the
  int8 instantiation of `csrc/paged_decode.cu` (`pipelined=True`: for bf16
  q one thread-block cluster launch) or of the split-KV
  `csrc/paged_decode_tiled.cu` (False: split and combine), which dequantize
  in f32 inside the kernel; for bf16 q both run the Hopper body of
  `csrc/paged_decode_sm90.cuh`, the bf16 pages' body, with the launch shape
  of `ops/paged_attention.py::decode_plan` (f32 q, a checking path, keeps
  the first port's body). On CPU tensors it runs the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from llm_d_kv_cache_manager_tpu_torch.ops.paged_attention import (
    launch_decode,
    paged_attention_reference,
)
from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device

# Kernel launches on int8 pages, counted by the wrapper (CUDA path only).
launches = 0  # csrc/paged_decode.cu
tiled_launches = 0  # csrc/paged_decode_tiled.cu


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization over the last axis, in f32 with
    round-half-to-even, bit for bit the reference's.

    x: [..., hd] -> (q int8 [..., hd], scale f32 [...])."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def make_quantized_kv_pages(n_kv_heads: int, n_pages: int, page_size: int,
                            head_dim: int, device="cuda"):
    """Returns (k_q, k_scale, v_q, v_scale) zero-initialized pools."""
    dev = resolve_device(device)
    q_shape = (n_kv_heads, n_pages, page_size, head_dim)
    s_shape = (n_kv_heads, n_pages, page_size, 1)
    return (
        torch.zeros(q_shape, dtype=torch.int8, device=dev),
        torch.zeros(s_shape, dtype=torch.float32, device=dev),
        torch.zeros(q_shape, dtype=torch.int8, device=dev),
        torch.zeros(s_shape, dtype=torch.float32, device=dev),
    )


def write_kv_pages_quantized(
    k_q, k_scale, v_q, v_scale,
    block_table: torch.Tensor,  # [pages_per_seq] int32
    k_new: torch.Tensor,  # [seq, n_kv, hd]
    v_new: torch.Tensor,
    start_pos: int,
):
    """Quantize new rows and scatter values and scales into their pages, IN
    PLACE (the reference returns new arrays). Position `start_pos + i` maps
    to page `block_table[pos // page_size]`, slot `pos % page_size`. Returns
    the (updated) pools."""
    page_size = k_q.shape[2]
    pos = start_pos + torch.arange(k_new.shape[0], device=k_q.device)
    page_ids = block_table.to(k_q.device).long()[pos // page_size]
    slots = pos % page_size
    kq_rows, ks_rows = quantize_rows(k_new)  # [seq, n_kv, hd], [seq, n_kv]
    vq_rows, vs_rows = quantize_rows(v_new)
    # [n_kv, n_pages, page, hd] viewed as [n_pages, page, n_kv, hd]: the
    # indexed rows are then [seq, n_kv, hd], the new rows' layout.
    k_q.permute(1, 2, 0, 3).index_put_((page_ids, slots), kq_rows)
    v_q.permute(1, 2, 0, 3).index_put_((page_ids, slots), vq_rows)
    k_scale[..., 0].permute(1, 2, 0).index_put_((page_ids, slots), ks_rows)
    v_scale[..., 0].permute(1, 2, 0).index_put_((page_ids, slots), vs_rows)
    return k_q, k_scale, v_q, v_scale


def dequantize_gathered(pages: torch.Tensor, scales: torch.Tensor, ids: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """The pages `ids` (any shape of page ids) of one int8 pool, gathered
    first and only then dequantized and rounded to `dtype`:
    [n_kv, *ids.shape, page, hd]."""
    ids = ids.long()
    return (pages[:, ids].float() * scales[:, ids]).to(dtype)


def paged_attention_quantized_reference(
    q, k_q, k_scale, v_q, v_scale, block_tables, seq_lens, window=None
):
    """The plain version: dequantize the referenced pages in f32, round them
    to q's dtype as the reference does, then run the plain gather attention.
    A `seq_len == 0` slot yields zeros."""
    batch, pps = block_tables.shape
    n_kv, _, page_size, head_dim = k_q.shape

    def compact(pages, scales):  # [n_kv, batch * pps, page, hd]
        deq = dequantize_gathered(pages, scales, block_tables, q.dtype)
        return deq.reshape(n_kv, batch * pps, page_size, head_dim)

    tables = torch.arange(batch * pps, device=block_tables.device, dtype=torch.int32)
    return paged_attention_reference(
        q, compact(k_q, k_scale), compact(v_q, v_scale),
        tables.reshape(batch, pps), seq_lens, window=window,
    )


def paged_attention_quantized(
    q: torch.Tensor,  # [batch, n_q_heads, head_dim]
    k_q: torch.Tensor,  # [n_kv, n_pages, page, hd] int8
    k_scale: torch.Tensor,  # [n_kv, n_pages, page, 1] f32
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, pages_per_seq] int32
    seq_lens: torch.Tensor,  # [batch] int32
    *,
    pipelined: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash-decoding over int8 pages: on CUDA tensors the int8 instantiation
    of the chosen kernel (dequantizing in f32 inside it), on CPU tensors the
    plain version."""
    global launches, tiled_launches
    if q.is_cuda:
        out = launch_decode(q, k_q, v_q, block_tables, seq_lens, window,
                            pipelined=pipelined, scales=(k_scale, v_scale))
        if pipelined:
            launches += 1
        else:
            tiled_launches += 1
        return out
    return paged_attention_quantized_reference(
        q, k_q, k_scale, v_q, v_scale, block_tables, seq_lens, window=window
    )
