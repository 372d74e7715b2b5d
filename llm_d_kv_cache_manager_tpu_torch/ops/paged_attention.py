"""Paged attention: flash-decoding over a block table.

Port of the reference package's `ops/paged_attention.py`. The engine's KV
cache lives in fixed-size pages, laid out head-major
`[n_kv_heads, n_pages, page_size, head_dim]` per layer and indexed by a
per-sequence block table — the same pages whose BlockStored/BlockRemoved
events the control plane ingests.

- `paged_attention_reference`: the plain torch version (gather, masked
  softmax in f32). A `seq_len == 0` slot yields zeros, as the kernel does.
- `paged_attention`: the wrapper, with the reference's `pipelined` switch
  (default False). On CUDA tensors it launches a hand-written kernel,
  `csrc/paged_decode.cu` (pipelined: for bf16 q one cluster launch) or
  the split-KV `csrc/paged_decode_tiled.cu` (tiled); on CPU tensors it runs
  the plain version. It never falls back from CUDA to the plain version.
  `ops/quantized_kv.py` launches the same two kernels on int8 pages.
- `decode_plan`: the launch shape of both kernels for bf16 q (on bf16 or
  int8 pages), from the shapes alone; `old_body_splits` for f32 q.
- `write_kv_pages`: scatter of new K/V rows into their pages.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

# Kernel launches, counted by the wrappers (CUDA path only).
launches = 0  # csrc/paged_decode.cu, bf16/f32 pages
tiled_launches = 0  # csrc/paged_decode_tiled.cu, bf16/f32 pages

_KERNEL_HEAD_DIMS = (128,)
_KERNEL_GROUPS = (1, 2, 4, 8)
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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: pointers, then int shape arguments, then scale, dtype,
# kv_int8 and the stream (csrc/paged_decode.cu, csrc/paged_decode_tiled.cu).
_ARGTYPES = {
    "kvt_paged_decode": [_P] * 8 + [_I] * 9 + [_F, _I, _I, _P],
    "kvt_paged_decode_tiled": [_P] * 11 + [_I] * 9 + [_F, _I, _I, _P],
}

_STAGE_TOKENS = 64  # tokens per ring stage of either decode kernel, on both page formats
_MAX_CLUSTER = 8  # the portable cluster size: every Hopper launch may ask for it


def decode_plan(batch: int, n_kv: int, table_width: int, page_size: int,
                n_sms: int) -> tuple:
    """(cluster, n_splits): the CTAs per (sequence, kv head) of the
    pipelined kernel for bf16 q (one thread-block cluster) and of the tiled
    kernel (a grid-level split), on bf16 and on int8 pages, from the shapes
    alone (no read of seq_lens).

    Both split each (sequence, kv head) as far as one CTA per SM allows
    (more CTAs read slower on an H100: each extra CTA adds its start-up,
    its merge and, in the tiled kernel, a partial for the combine pass),
    never into more parts than the table has pages or 64-token stages. The
    cluster is that count rounded down to a power of two, at most 8."""
    pairs = batch * n_kv
    cap = max(1, min(table_width, table_width * page_size // _STAGE_TOKENS))
    n_splits = max(1, min(n_sms // pairs, cap))
    cluster = 1
    while 2 * cluster <= min(_MAX_CLUSTER, n_splits):
        cluster *= 2
    return cluster, n_splits


def old_body_splits(batch: int, n_kv: int, table_width: int, n_sms: int) -> int:
    """The tiled kernel's split count for f32 q (on f32 or int8 pages, the
    checking paths), which keeps the body of csrc/paged_decode_common.cuh
    (128-thread CTAs, several to an SM): about two CTAs per SM, never more
    splits than the table has pages."""
    return max(1, min(-(-2 * n_sms // (batch * n_kv)), table_width))


def _kernel_fn(source: str, fn_name: str):
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    fn = getattr(_build.library(source), fn_name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[fn_name]
        fn.restype = _I
    return fn


def _check_kernel_args(q, k_pages, v_pages, block_tables, seq_lens, scales):
    """Raise on what the decode kernels do not take. `scales` is None for
    pages in q's dtype, or (k_scale, v_scale) for int8 pages."""
    n_kv, n_pages, page_size, head_dim = k_pages.shape
    batch, n_q, hd_q = q.shape
    group = _check_grouping(n_q, n_kv)
    tensors = (q, k_pages, v_pages, block_tables, seq_lens) + tuple(scales or ())
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged decode: all tensors must be on one CUDA device")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged decode kernels take bf16 or f32 q, got {q.dtype}")
    page_dtype = q.dtype if scales is None else torch.int8
    if k_pages.dtype != page_dtype or v_pages.dtype != page_dtype:
        raise TypeError(
            f"paged decode kernel takes {page_dtype} pages with q {q.dtype}, got "
            f"{k_pages.dtype}/{v_pages.dtype}"
        )
    if scales is not None and any(
        s.dtype != torch.float32 or s.shape != (n_kv, n_pages, page_size, 1)
        for s in scales
    ):
        raise ValueError("int8 page scales must be f32 [n_kv, n_pages, page, 1]")
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
            f"paged decode kernels take head_dim in {_KERNEL_HEAD_DIMS} and "
            f"GQA group in {_KERNEL_GROUPS}, got {head_dim} and {group}"
        )
    if not all(t.is_contiguous() for t in tensors) or any(
        t.data_ptr() % 16 for t in (k_pages, v_pages)
    ):
        raise ValueError(
            "paged decode kernels need contiguous tensors and 16-byte aligned pages"
        )


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan(n_sms: int, q_dtype: torch.dtype, batch: int, n_kv: int, table_width: int,
          page_size: int) -> tuple:
    """(cluster, n_splits) for a launch on a card of `n_sms` SMs: bf16 q, on
    either page format, runs the body of csrc/paged_decode_sm90.cuh and
    takes decode_plan; f32 q keeps the old body, old_body_splits and no
    cluster."""
    if q_dtype != torch.bfloat16:
        return 1, old_body_splits(batch, n_kv, table_width, n_sms)
    return decode_plan(batch, n_kv, table_width, page_size, n_sms)


def launch_decode(q, k_pages, v_pages, block_tables, seq_lens, window, *,
                  pipelined: bool, scales=None) -> torch.Tensor:
    """Launch `csrc/paged_decode.cu` (pipelined) or
    `csrc/paged_decode_tiled.cu` on CUDA tensors; `scales` = (k_scale,
    v_scale) for int8 pages. Counting the launch is the caller's."""
    _check_kernel_args(q, k_pages, v_pages, block_tables, seq_lens, scales)
    n_kv, n_pages, page_size, head_dim = k_pages.shape
    batch, n_q, _ = q.shape
    table_width = block_tables.shape[1]
    k_scale, v_scale = scales if scales is not None else (None, None)
    out = torch.empty_like(q)
    common = (
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scale), _ptr(v_scale),
        _ptr(block_tables), _ptr(seq_lens),
    )
    window_arg = -1 if window is None else int(window)
    tail = (
        1.0 / (head_dim**0.5), _DTYPE_CODE[q.dtype], int(scales is not None),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cluster, n_splits = _plan(_sm_count(q.device), q.dtype, batch, n_kv, table_width,
                              page_size)
    if pipelined:
        name = "paged_decode"
        err = _kernel_fn(name, "kvt_paged_decode")(
            *common, _ptr(out), batch, n_q, n_kv, n_pages, page_size, head_dim,
            table_width, window_arg, cluster, *tail,
        )
    else:
        name = "paged_decode_tiled"
        # One f32 workspace: m and l [batch, n_kv, n_splits, group], then acc
        # [..., group, head_dim].
        n = batch * n_kv * n_splits * (n_q // n_kv)
        ws = torch.empty(n * (head_dim + 2), dtype=torch.float32, device=q.device)
        m_ws, l_ws, acc_ws = ws[:n], ws[n:2 * n], ws[2 * n:]
        err = _kernel_fn(name, "kvt_paged_decode_tiled")(
            *common, _ptr(m_ws), _ptr(l_ws), _ptr(acc_ws), _ptr(out), batch, n_q,
            n_kv, n_pages, page_size, head_dim, table_width, window_arg,
            n_splits, *tail,
        )
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def paged_attention(
    q: torch.Tensor,  # [batch, n_q_heads, head_dim]
    k_pages: torch.Tensor,  # [n_kv_heads, n_pages, page_size, head_dim]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, pages_per_seq] int32
    seq_lens: torch.Tensor,  # [batch] int32
    *,
    pipelined: bool = False,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash-decoding paged attention: on CUDA tensors the kernel of the
    chosen variant (`pipelined=True`: `csrc/paged_decode.cu`, one launch, for
    bf16 q a thread-block cluster per sequence and kv head; False: the
    split-KV `csrc/paged_decode_tiled.cu` and its combine pass),
    on CPU tensors the plain version. Entries of a block table past
    ceil(seq_len / page_size) are never read."""
    global launches, tiled_launches
    _check_grouping(q.shape[1], k_pages.shape[0])
    if q.is_cuda:
        out = launch_decode(q, k_pages, v_pages, block_tables, seq_lens, window,
                            pipelined=pipelined)
        if pipelined:
            launches += 1
        else:
            tiled_launches += 1
        return out
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
