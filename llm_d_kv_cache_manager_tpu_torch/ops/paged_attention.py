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
  `csrc/paged_decode.cu` (pipelined: one cluster launch) or
  the split-KV `csrc/paged_decode_tiled.cu` (tiled), or above head_dim 256
  the same two variants of `csrc/paged_decode_wide.cu`; on CPU tensors it
  runs the plain version. It never falls back from CUDA to the plain version.
  `ops/quantized_kv.py` launches the same two kernels on int8 pages.
- `decode_plan`: the launch shape of both kernels, from the shapes alone
  (its cap on the splits from `stage_tokens`, the ring stage of the
  page format); `old_body_splits` for f32 q above head_dim 256 (the first
  wide body's slabs); `group_chunks`: how a GQA group above
  `max_rows(head_dim)` splits over CTAs; `n_slabs`: the column slabs of a
  head dim above 256 in the first wide body.
- The kernels take every head_dim (up to 256 built at the padded widths 64,
  128 and 256; above it, for bf16 q up to 1,024, one CTA holding every
  column; for f32 q, and bf16 q above 1,024, column slabs of 256, the
  scores summed over panels of 256; the pools' rows unpadded) and any GQA
  group, in bf16 and f32 q, on pages of q's dtype and on int8 pages.
- The tiled kernel's second pass on its own: `decode_workspace` (the f32
  workspace of m, l and acc that its split pass writes), `combine_splits`
  (on CUDA tensors the combine kernel, `kvt_paged_decode_combine` in
  `csrc/paged_decode_tiled.cu` over `csrc/paged_decode_combine.cuh`; on CPU
  tensors its plain version `combine_reference`) and
  `split_partials_reference`, the split pass's plain version.
- `write_kv_pages`: scatter of new K/V rows into their pages.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

# Kernel launches, counted by the wrappers (CUDA path only).
launches = 0  # csrc/paged_decode.cu, bf16/f32 pages
tiled_launches = 0  # csrc/paged_decode_tiled.cu, bf16/f32 pages
# The combine pass (csrc/paged_decode_combine.cuh): one a tiled launch on
# either page format (launch_decode), and one a combine_splits call.
combine_launches = 0

_MAX_ROWS = 8  # query heads one decode CTA holds (csrc/paged_decode_common.cuh)
_PANEL = 256  # the widest built head_dim, and a wider head's slab (csrc/row_copy.cuh)
# bf16 q up to this head_dim runs csrc/paged_decode_wide.cu's Hopper body,
# one CTA for every column (`hw::kMaxChunks` panels); above it the first
# wide body's slabs.
_HOPPER_WIDE = 4 * _PANEL
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
# kv_int8 and the stream (csrc/paged_decode.cu, csrc/paged_decode_tiled.cu;
# csrc/paged_decode_wide.cu's two entry points take the same).
_ARGTYPES = {
    "kvt_paged_decode": [_P] * 8 + [_I] * 9 + [_F, _I, _I, _P],
    "kvt_paged_decode_tiled": [_P] * 11 + [_I] * 9 + [_F, _I, _I, _P],
}
_ARGTYPES["kvt_paged_decode_wide"] = _ARGTYPES["kvt_paged_decode"]
_ARGTYPES["kvt_paged_decode_wide_tiled"] = _ARGTYPES["kvt_paged_decode_tiled"]
# head_dim, group, kv_int8, cluster -> clusters resident at once
_ARGTYPES["kvt_paged_decode_wide_resident"] = [_I] * 4
# m, l, acc, out, batch, n_q, n_kv, head_dim, n_splits, rows, dtype, stream
_ARGTYPES["kvt_paged_decode_combine"] = [_P] * 4 + [_I] * 7 + [_P]

# Tokens a ring stage of the Hopper decode body holds, by page dtype and
# padded head_dim: csrc/paged_decode_sm90.cuh's kStageTokens (a tier-1 test
# holds the two equal). Above head_dim 256 the plans cap the splits at 64-token
# stages (`_WIDE_STAGE_TOKENS`).
STAGE_TOKENS = {
    torch.int8: {64: 64, 128: 64, 256: 64},
    torch.bfloat16: {64: 64, 128: 64, 256: 64},
    torch.float32: {64: 64, 128: 32, 256: 32},
}
_WIDE_STAGE_TOKENS = 64
_MAX_CLUSTER = 8  # the portable cluster size: every Hopper launch may ask for it
# The wide Hopper body's clusters go to the non-portable 16 (its kernels set
# cudaFuncAttributeNonPortableClusterSizeAllowed), so that batch 1 spreads
# over more SMs.
_MAX_WIDE_CLUSTER = 16


def max_rows(head_dim: int = 128, bf16_q: bool = True) -> int:
    """Query heads one decode CTA holds: 8 up to head_dim 128, else 4 (the
    Hopper bodies keep 16 columns of q and acc a lane; `max_rows_of` in
    csrc/paged_decode_common.cuh); but in the wide Hopper body (bf16 q,
    head_dim 257 to 1,024) 3 up to 768 and 2 above (24 and 32 columns a
    lane; `hw::max_rows` in csrc/paged_decode_wide.cu)."""
    if head_dim <= 128:
        return _MAX_ROWS
    if bf16_q and 512 < head_dim <= _HOPPER_WIDE:
        return 3 if head_dim <= 768 else 2
    return _MAX_ROWS // 2


def n_slabs(head_dim: int) -> int:
    """Column slabs of 256 a head_dim's output is cut into in the first wide
    body (f32 q; bf16 q above 1,024), one CTA (or cluster) each: 1 up to 256
    (`n_panels` in csrc/row_copy.cuh)."""
    return -(-head_dim // _PANEL)


def hopper_slabs(head_dim: int) -> int:
    """Column slabs of a bf16-q launch: one CTA holds every column up to
    head_dim 1,024 (the Hopper bodies), `n_slabs` above."""
    return 1 if head_dim <= _HOPPER_WIDE else n_slabs(head_dim)


def max_cluster(head_dim: int) -> int:
    """The largest cluster of a bf16-q pipelined launch: 16 for the wide
    Hopper body (head_dim 257 to 1,024), else the portable 8."""
    return _MAX_WIDE_CLUSTER if _PANEL < head_dim <= _HOPPER_WIDE else _MAX_CLUSTER


def group_chunks(group: int, head_dim: int = 128, bf16_q: bool = True) -> tuple:
    """(n_chunks, rows): a GQA group of at most max_rows(head_dim, bf16_q)
    query heads runs as one chunk of `group` rows; a larger one as
    ceil(group / max_rows) chunks of equal rows over the same kv head, the
    last chunk's spare rows unused (12 -> 2 x 6, 16 -> 2 x 8, 13 -> 2 x 7,
    71 -> 9 x 8; above head_dim 128, 8 -> 2 x 4; at 576 for bf16 q, 16 ->
    6 x 3). The kernels' `n_chunks_of` and `rows_of`
    (csrc/paged_decode_common.cuh) and `hw::n_chunks` and `hw::rows`
    (csrc/paged_decode_wide.cu) follow the same rule."""
    n_chunks = -(-group // max_rows(head_dim, bf16_q))
    return n_chunks, -(-group // n_chunks)


def stage_tokens(head_dim: int = 128, page_dtype: torch.dtype = torch.bfloat16) -> int:
    """Tokens a ring stage of the decode body holds on pages of `page_dtype`
    (int8, bf16 or f32): STAGE_TOKENS at head_dim's padded width up to 256,
    else `_WIDE_STAGE_TOKENS`."""
    if head_dim > _PANEL:
        return _WIDE_STAGE_TOKENS
    return STAGE_TOKENS[page_dtype][64 if head_dim <= 64 else 128 if head_dim <= 128 else 256]


def decode_plan(batch: int, n_kv: int, table_width: int, page_size: int,
                n_sms: int, group: int = 1, head_dim: int = 128,
                resident: Optional[dict] = None,
                page_dtype: torch.dtype = torch.bfloat16) -> tuple:
    """(cluster, n_splits): the CTAs per (sequence, kv head, group chunk)
    of the pipelined kernel (one thread-block cluster) and of the tiled
    kernel (a grid-level split), for bf16 q on bf16 or int8 pages and for
    f32 q on f32 or int8 pages (`page_dtype`; f32 q above head_dim 256
    takes `old_body_splits`), from the shapes alone (no read of seq_lens).

    Both split each (sequence, kv head) as far as one CTA per SM allows
    (more CTAs read slower on an H100: each extra CTA adds its start-up,
    its merge and, in the tiled kernel, a partial for the combine pass),
    never into more parts than the table has pages or ring stages
    (`stage_tokens(head_dim, page_dtype)` tokens each). A CTA
    holds every column up to head_dim 1,024; above it each column slab is a
    pair of its own (`hopper_slabs`). The cluster is that count rounded down
    to a power of two, at most `max_cluster(head_dim)` (8, or 16 for head
    dims 257 to 1,024), so it divides the padded widths 64, 128 and 256, the
    wide body's 512, 768 and 1,024 columns and a slab's 256 (each rank
    merges padded / cluster columns and writes those below head_dim).
    `resident` ({cluster: clusters the card holds at once}, the wide
    body's, from the card) also keeps every cluster of the launch resident
    at once: a second wave of clusters costs more than smaller ones (at 4/2
    heads of 512 and batch 8, 16 clusters of 8 run in two waves on an H100
    and 16 of 4 in one)."""
    pairs = batch * n_kv * group_chunks(group, head_dim)[0] * hopper_slabs(head_dim)
    cap = max(1, min(table_width,
                     table_width * page_size // stage_tokens(head_dim, page_dtype)))
    n_splits = max(1, min(n_sms // pairs, cap))
    cluster = 1
    while 2 * cluster <= min(max_cluster(head_dim), n_splits) and (
            resident is None or pairs <= resident.get(2 * cluster, 0)):
        cluster *= 2
    return cluster, n_splits


def old_body_splits(batch: int, n_kv: int, table_width: int, n_sms: int,
                    group: int = 1, head_dim: int = 128) -> int:
    """The tiled kernel's split count for f32 q above head_dim 256 (on f32
    or int8 pages), which runs the first wide body of
    csrc/paged_decode_wide.cu (a CTA per column slab of 256, several to an
    SM): about two CTAs per SM over the (sequence, kv head, group chunk,
    slab) tuples, never more splits than the table has pages. Up to 256 f32
    q takes decode_plan."""
    triples = batch * n_kv * group_chunks(group, head_dim, False)[0] * n_slabs(head_dim)
    return max(1, min(-(-2 * n_sms // triples), table_width))


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
          page_size: int, group: int = 1, head_dim: int = 128,
          resident: Optional[dict] = None, int8: bool = False) -> tuple:
    """(cluster, n_splits) for a launch on a card of `n_sms` SMs, on pages
    in q's dtype or (`int8`) int8: a Hopper body (csrc/paged_decode_sm90.cuh
    up to head_dim 256, both q dtypes; above it, for bf16 q,
    csrc/paged_decode_wide.cu's) takes decode_plan at its page format's
    stage; f32 q above 256 runs the first wide body, old_body_splits and no
    cluster."""
    if q_dtype != torch.bfloat16 and head_dim > _PANEL:
        return 1, old_body_splits(batch, n_kv, table_width, n_sms, group, head_dim)
    return decode_plan(batch, n_kv, table_width, page_size, n_sms, group, head_dim, resident,
                       torch.int8 if int8 else q_dtype)


@functools.lru_cache(maxsize=None)
def _resident(device: torch.device, head_dim: int, group: int, int8: bool) -> dict:
    """{cluster: clusters of that many CTAs the card holds at once} of the
    wide Hopper body's pipelined kernel at this shape (the C query)."""
    fn = _kernel_fn("paged_decode_wide", "kvt_paged_decode_wide_resident")
    with torch.cuda.device(device):
        counts = {c: fn(head_dim, group, int(int8), c) for c in (2, 4, 8, 16)}
    if counts[2] < 1:
        raise RuntimeError(f"paged_decode_wide: the cluster residency query failed: {counts}")
    return counts


def workspace_shape(q, k_pages, block_tables) -> tuple:
    """(batch, n_kv * n_chunks, n_splits, rows): the shape of m and l in the
    tiled kernel's workspace for these inputs on their card (acc adds
    head_dim). Its n_splits is `_plan`'s, which no residency changes."""
    n_kv, _, page_size, head_dim = k_pages.shape
    batch, n_q, _ = q.shape
    group = _check_grouping(n_q, n_kv)
    _, n_splits = _plan(_sm_count(q.device), q.dtype, batch, n_kv, block_tables.shape[1],
                        page_size, group, head_dim, int8=k_pages.dtype == torch.int8)
    n_chunks, rows = group_chunks(group, head_dim, q.dtype == torch.bfloat16)
    return batch, n_kv * n_chunks, n_splits, rows


def _new_workspace(shape: tuple, head_dim: int, device) -> tuple:
    n = math.prod(shape)
    ws = torch.empty(n * (head_dim + 2), dtype=torch.float32, device=device)
    return (ws[n * head_dim:n * (head_dim + 1)].view(shape),
            ws[n * (head_dim + 1):].view(shape), ws[:n * head_dim].view(*shape, head_dim))


def decode_workspace(q, k_pages, block_tables) -> tuple:
    """(m, l, acc): the tiled kernel's f32 workspace for these inputs, m and
    l `workspace_shape(...)`, acc that and head_dim; views of one
    allocation, acc first so that its rows start 16-byte aligned."""
    return _new_workspace(workspace_shape(q, k_pages, block_tables), k_pages.shape[3],
                          q.device)


def _check_workspace(m_ws, l_ws, acc_ws) -> None:
    """Raise on what the combine kernel does not take."""
    if acc_ws.dim() != 5 or m_ws.shape != acc_ws.shape[:4] or l_ws.shape != m_ws.shape:
        raise ValueError(
            f"workspace: m and l [batch, pairs, n_splits, rows], acc [..., head_dim]; got "
            f"{tuple(m_ws.shape)}, {tuple(l_ws.shape)}, {tuple(acc_ws.shape)}"
        )
    tensors = (m_ws, l_ws, acc_ws)
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise TypeError("workspace tensors must be contiguous f32")
    if any(t.device != acc_ws.device for t in tensors):
        raise ValueError("workspace tensors must be on one device")


def launch_decode(q, k_pages, v_pages, block_tables, seq_lens, window, *,
                  pipelined: bool, scales=None, workspace=None) -> torch.Tensor:
    """Launch `csrc/paged_decode.cu` (pipelined) or
    `csrc/paged_decode_tiled.cu` on CUDA tensors, above head_dim 256 the
    same variant of `csrc/paged_decode_wide.cu`; `scales` = (k_scale,
    v_scale) for int8 pages. The tiled kernel writes its partials to
    `workspace` ((m, l, acc) of `workspace_shape`; by default a new
    `decode_workspace`). Counting the launch is the caller's; the combine
    pass of a tiled launch is counted here (`combine_launches`)."""
    global combine_launches
    _check_kernel_args(q, k_pages, v_pages, block_tables, seq_lens, scales)
    if not pipelined:
        shape = workspace_shape(q, k_pages, block_tables)
        if workspace is None:
            workspace = _new_workspace(shape, k_pages.shape[3], q.device)
        _check_workspace(*workspace)
        m_ws, l_ws, acc_ws = workspace
        if m_ws.shape != shape or acc_ws.shape[4] != k_pages.shape[3] or (
                acc_ws.device != q.device):
            raise ValueError(f"workspace {tuple(acc_ws.shape)} on {acc_ws.device}: these "
                             f"inputs take {shape + (k_pages.shape[3],)} on {q.device}")
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
    name = "paged_decode" if pipelined else "paged_decode_tiled"
    fn_name = "kvt_" + name
    if head_dim > _PANEL:  # both variants in one source, built apart
        name, fn_name = "paged_decode_wide", fn_name.replace("decode", "decode_wide")
    if pipelined:
        group = n_q // n_kv
        resident = None
        if q.dtype == torch.bfloat16 and _PANEL < head_dim <= _HOPPER_WIDE:
            resident = _resident(q.device, head_dim, group, scales is not None)
        cluster, _ = _plan(_sm_count(q.device), q.dtype, batch, n_kv, table_width,
                           page_size, group, head_dim, resident, int8=scales is not None)
        err = _kernel_fn(name, fn_name)(
            *common, _ptr(out), batch, n_q, n_kv, n_pages, page_size, head_dim,
            table_width, window_arg, cluster, *tail,
        )
    else:
        err = _kernel_fn(name, fn_name)(
            *common, _ptr(m_ws), _ptr(l_ws), _ptr(acc_ws), _ptr(out), batch, n_q,
            n_kv, n_pages, page_size, head_dim, table_width, window_arg,
            shape[2], *tail,
        )
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if not pipelined:
        combine_launches += 1
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
    chosen variant (`pipelined=True`: `csrc/paged_decode.cu`, one launch, a
    thread-block cluster per sequence and kv head; False: the
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


def split_partials_reference(q, k_pages, v_pages, block_tables, seq_lens, n_splits: int,
                             window: Optional[int] = None, bf16_q: Optional[bool] = None):
    """The tiled kernel's split pass, plainly, in f32: for each (sequence,
    kv head, group chunk) and split s, the unnormalized softmax state over
    the split's pages, as the kernel writes its workspace. The live pages
    are [first_page, n_seq_pages): first_page the window's first page (else
    0), n_seq_pages = ceil(min(seq_len, table positions) / page_size); split
    s takes `per_split` = ceil((n_seq_pages - first_page) / n_splits) of
    them from first_page + s * per_split on, clipped to n_seq_pages, and
    attends its positions below seq_len and, windowed, at or past seq_len -
    window. m is the largest score (natural log, scale 1/sqrt(head_dim)), l
    = sum exp(score - m), acc = sum exp(score - m) v; a split with no live
    position (and a spare row of the last chunk) m = -inf, l = 0, acc = 0.
    Rows a chunk as `group_chunks(group, head_dim, bf16_q)`, bf16_q by
    default q's dtype. Returns (m, l, acc): [batch, n_kv * n_chunks,
    n_splits, rows] and [..., rows, head_dim]."""
    n_kv, _, page_size, head_dim = k_pages.shape
    batch, n_q, _ = q.shape
    group = _check_grouping(n_q, n_kv)
    if bf16_q is None:
        bf16_q = q.dtype == torch.bfloat16
    n_chunks, rows = group_chunks(group, head_dim, bf16_q)
    width = block_tables.shape[1]
    tables = block_tables.long()
    k = k_pages[:, tables].movedim(1, 0).reshape(batch, n_kv, -1, head_dim).float()
    v = v_pages[:, tables].movedim(1, 0).reshape(batch, n_kv, -1, head_dim).float()
    qg = q.reshape(batch, n_kv, group, head_dim).float()
    scores = torch.einsum("bhgd,bhld->bhgl", qg, k) / math.sqrt(head_dim)

    lens = seq_lens.long().to(q.device)
    kv_len = lens.clamp(max=width * page_size)
    if window is None:
        first_page, win_lo = torch.zeros_like(lens), torch.zeros_like(lens)
    else:
        first_page, win_lo = (lens - window).clamp(min=0) // page_size, lens - window
    n_seq_pages = (kv_len + page_size - 1) // page_size
    per_split = ((n_seq_pages - first_page).clamp(min=0) + n_splits - 1) // n_splits
    pos = torch.arange(width * page_size, device=q.device)
    page = pos // page_size
    live = (pos < kv_len[:, None]) & (pos >= win_lo[:, None]) & (page >= first_page[:, None])
    split_of = (page - first_page[:, None]) // per_split.clamp(min=1)[:, None]
    ms, ls, accs = [], [], []
    for s in range(n_splits):
        mask = (live & (split_of == s))[:, None, None, :]
        sc = scores.masked_fill(~mask, float("-inf"))
        m = sc.amax(dim=-1)
        p = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgl,bhld->bhgd", p, v))

    def by_chunk(parts, fill):  # [batch, n_kv, group, S(, hd)] -> workspace layout
        x = torch.stack(parts, dim=3)
        pad = n_chunks * rows - group
        if pad:
            x = torch.cat([x, x.new_full((batch, n_kv, pad, *x.shape[3:]), fill)], dim=2)
        x = x.reshape(batch, n_kv, n_chunks, rows, *x.shape[3:]).transpose(3, 4)
        return x.reshape(batch, n_kv * n_chunks, n_splits, rows, *x.shape[5:]).contiguous()

    return by_chunk(ms, float("-inf")), by_chunk(ls, 0.0), by_chunk(accs, 0.0)


def combine_reference(m_ws, l_ws, acc_ws, group: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The combine pass, plainly, in f32: for each query row of a workspace
    of the tiled kernel's layout ((m, l) [batch, n_kv * n_chunks, n_splits,
    rows], acc [..., head_dim], n_chunks = ceil(group / rows)), M = the
    largest m over the splits, w_s = exp(m_s - M) (0 for a split with m =
    -inf), out = sum w_s acc_s / sum w_s l_s; a row whose splits are all
    empty gives zeros. Returns [batch, n_q, head_dim] in `dtype`."""
    batch, pairs, _, rows, head_dim = acc_ws.shape
    n_chunks = -(-group // rows)
    n_kv = pairs // n_chunks
    if n_kv * n_chunks != pairs:
        raise ValueError(f"{pairs} workspace pairs are no whole number of kv heads of "
                         f"{n_chunks} chunks")
    m, l, acc = m_ws.float(), l_ws.float(), acc_ws.float()
    empty = m == float("-inf")
    m_max = m.amax(dim=2, keepdim=True)
    w = torch.where(empty, 0.0, torch.exp(m - torch.where(torch.isinf(m_max), 0.0, m_max)))
    total = (w * l).sum(dim=2)
    o = (w[..., None] * torch.where(empty[..., None], 0.0, acc)).sum(dim=2)
    out = torch.where(total[..., None] > 0, o / total[..., None], 0.0)
    out = out.reshape(batch, n_kv, n_chunks * rows, head_dim)[:, :, :group]
    return out.reshape(batch, n_kv * group, head_dim).to(dtype)


def combine_splits(m_ws, l_ws, acc_ws, group: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The tiled kernel's second pass on its own: on CUDA tensors the
    combine kernel (`kvt_paged_decode_combine`, csrc/paged_decode_tiled.cu),
    on CPU tensors `combine_reference`. `dtype`: the output's, f32 or bf16.
    Returns [batch, n_q, head_dim]."""
    global combine_launches
    _check_workspace(m_ws, l_ws, acc_ws)
    if not acc_ws.is_cuda:
        return combine_reference(m_ws, l_ws, acc_ws, group, dtype)
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"the combine kernel writes bf16 or f32, not {dtype}")
    batch, pairs, n_splits, rows, head_dim = acc_ws.shape
    n_chunks = -(-group // rows)
    n_kv = pairs // n_chunks
    if n_kv * n_chunks != pairs or rows > group:
        raise ValueError(f"a workspace of {pairs} pairs of {rows} rows does not hold group "
                         f"{group}")
    out = torch.empty(batch, n_kv * group, head_dim, dtype=dtype, device=acc_ws.device)
    err = _kernel_fn("paged_decode_tiled", "kvt_paged_decode_combine")(
        _ptr(m_ws), _ptr(l_ws), _ptr(acc_ws), _ptr(out), batch, n_kv * group, n_kv, head_dim,
        n_splits, rows, _DTYPE_CODE[dtype], torch.cuda.current_stream(acc_ws.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"paged_decode_combine kernel launch failed: CUDA error {err}")
    combine_launches += 1
    return out


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
