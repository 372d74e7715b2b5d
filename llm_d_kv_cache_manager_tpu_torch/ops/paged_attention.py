"""Paged attention: flash-decoding over a block table.

Port of the reference package's `ops/paged_attention.py`. The engine's KV
cache lives in fixed-size pages, laid out head-major
`[n_kv_heads, n_pages, page_size, head_dim]` per layer and indexed by a
per-sequence block table — the same pages whose BlockStored/BlockRemoved
events the control plane ingests.

- `paged_attention_reference`: the plain torch version (gather, masked
  softmax in f32). A `seq_len == 0` slot yields zeros, as the kernel does.
- `paged_attention`: the wrapper. On CUDA tensors it launches the
  hand-written kernel `csrc/paged_decode.cu`; on CPU tensors it runs the
  plain version. It never falls back from CUDA to the plain version.
- `write_kv_pages`: scatter of new K/V rows into their pages.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

launches = 0  # paged_decode kernel launches (CUDA path only)

_KERNEL_HEAD_DIMS = (128,)
_KERNEL_GROUPS = (1, 2, 4, 8)
_KERNEL_CHUNK = 64  # tokens staged per pipeline step; page_size must divide it
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_grouping(n_q_heads: int, n_kv_heads: int) -> int:
    group = n_q_heads // n_kv_heads
    if group * n_kv_heads != n_q_heads:
        raise ValueError(
            f"n_q_heads {n_q_heads} not divisible by n_kv_heads {n_kv_heads}"
        )
    return group


def paged_attention_reference(
    q: torch.Tensor,  # [batch, n_q_heads, head_dim]
    k_pages: torch.Tensor,  # [n_kv_heads, n_pages, page_size, head_dim]
    v_pages: torch.Tensor,  # [n_kv_heads, n_pages, page_size, head_dim]
    block_tables: torch.Tensor,  # [batch, pages_per_seq] int32
    seq_lens: torch.Tensor,  # [batch] int32
    window: Optional[int] = None,  # sliding window: attend [len-window, len)
) -> torch.Tensor:
    """Gather-based paged attention; the plain version of the kernel."""
    n_kv_heads, _, page_size, head_dim = k_pages.shape
    batch, n_q_heads, _ = q.shape
    group = _check_grouping(n_q_heads, n_kv_heads)
    scale = 1.0 / (head_dim**0.5)

    tables = block_tables.long()
    k = k_pages[:, tables].movedim(1, 0).reshape(batch, n_kv_heads, -1, head_dim)
    v = v_pages[:, tables].movedim(1, 0).reshape(batch, n_kv_heads, -1, head_dim)

    qg = q.reshape(batch, n_kv_heads, group, head_dim)
    scores = torch.einsum("bhgd,bhld->bhgl", qg.float(), k.float()) * scale
    pos = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    lens = seq_lens.long()[:, None, None, None]
    mask = pos < lens
    if window is not None:
        # The decode query sits at position seq_len-1; HF sliding-window
        # semantics attend [seq_len - window, seq_len).
        mask = mask & (pos >= lens - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    # seq_len == 0 masks every position (softmax gives NaN); the kernel
    # writes zeros for such padded slots, and so does this version.
    weights = torch.where(mask.any(dim=-1, keepdim=True), weights, 0.0)
    out = torch.einsum("bhgl,bhld->bhgd", weights, v.float())
    return out.reshape(batch, n_q_heads, head_dim).to(q.dtype)


def _kernel() -> ctypes.CDLL:
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    lib = _build.library("paged_decode")
    fn = lib.kvt_paged_decode
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 6 + [i32] * 8 + [ctypes.c_float, i32, ptr]
        fn.restype = i32
    return lib


def _launch(q, k_pages, v_pages, block_tables, seq_lens, window) -> torch.Tensor:
    global launches
    n_kv, n_pages, page_size, head_dim = k_pages.shape
    batch, n_q, hd_q = q.shape
    group = n_q // n_kv
    tensors = (q, k_pages, v_pages, block_tables, seq_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all tensors must be on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"paged_attention kernel takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    if v_pages.shape != k_pages.shape or hd_q != head_dim:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
            f"v {tuple(v_pages.shape)}"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != batch or seq_lens.shape != (batch,):
        raise ValueError("block_tables must be [batch, pages] and seq_lens [batch]")
    if head_dim not in _KERNEL_HEAD_DIMS or group not in _KERNEL_GROUPS:
        raise ValueError(
            f"paged_decode kernel takes head_dim in {_KERNEL_HEAD_DIMS} and "
            f"GQA group in {_KERNEL_GROUPS}, got {head_dim} and {group}"
        )
    if _KERNEL_CHUNK % page_size:
        raise ValueError(f"page_size {page_size} must divide {_KERNEL_CHUNK}")
    if not all(t.is_contiguous() for t in tensors) or any(
        t.data_ptr() % 16 for t in (k_pages, v_pages)
    ):
        raise ValueError(
            "paged_attention kernel needs contiguous tensors and 16-byte aligned pages"
        )
    out = torch.empty_like(q)
    err = _kernel().kvt_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        batch, n_q, n_kv, n_pages, page_size, head_dim, block_tables.shape[1],
        -1 if window is None else int(window),
        1.0 / (head_dim**0.5), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def paged_attention(
    q: torch.Tensor,  # [batch, n_q_heads, head_dim]
    k_pages: torch.Tensor,  # [n_kv_heads, n_pages, page_size, head_dim]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, pages_per_seq] int32
    seq_lens: torch.Tensor,  # [batch] int32
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash-decoding paged attention: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Entries of a block table past
    ceil(seq_len / page_size) are never read."""
    _check_grouping(q.shape[1], k_pages.shape[0])
    if q.is_cuda:
        return _launch(q, k_pages, v_pages, block_tables, seq_lens, window)
    return paged_attention_reference(
        q, k_pages, v_pages, block_tables, seq_lens, window=window
    )


def write_kv_pages(
    k_pages: torch.Tensor,  # [n_kv_heads, n_pages, page_size, head_dim]
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [pages_per_seq] int32
    k_new: torch.Tensor,  # [seq, n_kv_heads, head_dim]
    v_new: torch.Tensor,
    start_pos: int,  # sequence position of k_new[0]
):
    """Scatter new K/V rows into their pages via the block table, IN PLACE
    (an `index_put_` on a permuted view of each pool; the reference package
    returns new arrays instead). Position `start_pos + i` maps to page
    `block_table[pos // page_size]`, slot `pos % page_size`. Returns the
    (updated) pools."""
    page_size = k_pages.shape[2]
    pos = start_pos + torch.arange(k_new.shape[0], device=k_pages.device)
    page_ids = block_table.to(k_pages.device).long()[pos // page_size]
    slots = pos % page_size
    # [n_kv, n_pages, page, hd] viewed as [n_pages, page, n_kv, hd]: the
    # indexed rows are then [seq, n_kv, hd], exactly k_new's layout.
    k_pages.permute(1, 2, 0, 3).index_put_((page_ids, slots), k_new.to(k_pages.dtype))
    v_pages.permute(1, 2, 0, 3).index_put_((page_ids, slots), v_new.to(v_pages.dtype))
    return k_pages, v_pages
