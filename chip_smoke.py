#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card
    python3 chip_smoke.py --phases 3,9  # a development run of some phases
                                        # (no kernels or ok line)

Phases, in order (any failure raises and the script exits non-zero):
  1. device lines: torch's device name and nvidia-smi's name + power limit;
  2. build: the three kernel sources in llm_d_kv_cache_manager_tpu_torch/csrc
     with nvcc for sm_90a and the host tier's transfer library
     (kv_connectors/cpp/kv_transfer.cpp) with the C++ compiler, all at once
     (build seconds, ptxas register/spill lines);
  3. kernel vs plain: each of the five kernels (paged decode pipelined and
     tiled, each on bf16/f32 and on int8 pages, and flash prefill) against
     its plain torch version in bf16 and f32 over edge cases (zero/one-token
     sequences, page boundaries, pages of 16/64/128 and 17 (not a multiple
     of 4), windows, GQA groups 1-8, sequences short enough to leave splits
     and cluster ranks empty, a window inside one split's share or inside a
     page's second stage, prefix-hit offsets, padded chunks, per-batch
     offsets, both flash tile plans, bf16 flash at head_dim 64 too, the
     speculative verify's shape: 8 rows of 2, 5 or 9 new tokens at offsets
     that are no multiple of a tile, one offset 0, a window), the
     tiled decode against the pipelined one at f32 on both page formats, and
     two calls of each decode kernel for bf16 q (both page formats) bit for
     bit;
  4. times at the main path's shapes: kernel, plain version, the card's
     bound, and SDPA as a library yardstick that the port itself never calls
     (none exists for int8 pages), each the median of 10 replays of a CUDA
     graph of 10 calls, so that the host's launch cost, longer than the
     kernel, stays out of the span. Decode at batch 8 x 2,048, at the
     serving shape (batch 1 x 1,536 over a 128-page table) and at batch 1 x
     4,096, each call cold in L2 (a 128 MB rewrite before each call in the
     graph, whose own time is subtracted); prefill at the 2,048-token chunk
     and at the serving chunk (512 new tokens after 1,024 cached), and at
     the speculative verify's shape (batch 8 x 5 new tokens after 1,503
     cached, over the 2,048-position table);
  5. serving at the flagship width (1.14B Llama, bf16, random weights from a
     seeded generator): two bf16 pods and one int8-KV pod whose KV events are
     digested into one index; prefix reuse, pod ranking and kernel launch
     counts are asserted; then packed prefill (4 jobs in one batched pass)
     against the same jobs one by one on twin pods, on both page formats;
  5b. a small f32 pod on the card against the same pod on the CPU, on both
     page formats;
  5c. a prefix-hit prefill (1,024 cached tokens, then 512 new) at the
     flagship width through the flash kernel path and through the plain
     path, both against an f32 truth;
  6. batched decode at batch 8 x 2048 context for every (page format, decode
     kernel) pair, kernel path vs plain path vs an f32 truth, with the
     launches of each kernel counted; then 8-step multi-step decode against 8
     single steps on a twin cache, on both page formats;
  7a. the continuous-batching scheduler on a small f32 pod on the card
     against the same run on the CPU, both page formats: greedy and sampled
     requests, a shared prefix, a pool that forces preemption; the same
     tokens and event stream, and decode_steps 1 and 4 the same tokens;
  7b. the flagship through the scheduler, 16 requests at once (12 sharing a
     1,024-token prefix, 8 sampled, one stopping at EOS) on a bf16 pod at
     decode_steps 1 and 4 and an int8 pod at 4: prefix hits, the pod's index
     score, kernel launches per layer pass, and a teacher-forced bar on
     every generated token against an f32 truth; tick walls, tokens/s, time
     to first token and one decode tick's device share are logged;
  8a. the host tier on small f32 pods on the card against the same pods on
     the CPU, both page formats: offload on reclaim, the host capacity bound,
     restore on a miss, eager staging with an overwrite before the admit, and
     a two-pod onboard over loopback TCP through the index; the same tokens,
     event streams (media included) and tier-store stats;
  8b-8d. the flagship through the host tier, bf16 and int8 pages: on a pod
     of 132 pages an unrelated 1,536-token request reclaims P's 1,024-token
     prefix (64 blocks offloaded to the host store, medium "cpu"); P' (the
     prefix and 512 other tokens) restores it; a fresh pod onboards it from a
     reference pod over the transfer wire, found through the index; P' on
     both must be bit-identical (suffix logits, 32 greedy tokens) to the
     reference pod, which never evicts; launches are 16 per layer pass. The
     codec's and the wire's rates, four times to first token of P'
     (resident, restore, onboard, recompute) and the cost model's verdict
     at those rates are logged;
  9a. multi-LoRA on small f32 pods on the card against the same pods on the
     CPU (2 adapters of rank 8; 6 requests mixing the base and both
     adapters through the Scheduler, a pool that preempts, decode_steps 1
     and 4, both page formats): the same tokens and event streams;
  9b. the flagship with 3 adapters (rank 16 on wq/wv) on a bf16 pod and an
     int8 pod: 12 requests at once (the base and each adapter 3 times, a
     shared 1,024-token prefix, 6 sampled): every token against a dense f32
     truth of its adapter's merged weights, each adapter's truth apart from
     the base's by more than the bar, adapter-scoped prefix hits and index
     scores, 16 launches per layer pass; tokens/s against the same traffic
     on the base model and one decode tick's device share are logged;
  10a. speculative decoding on small f32 pods on the card against the CPU:
     SpeculativeDecoder (greedy and sampled, k = 4) and SpeculativeScheduler
     (6 mixed requests, two on adapters, a pool that preempts, k = 3): the
     same tokens, stats and event streams;
  10b. the flagship through SpeculativeScheduler (k = 4, 8 requests, 4
     sampled) with the target as its own draft and with a 2-layer draft, on
     a bf16 pod and an int8 pod, and SpeculativeDecoder on one request:
     every token against the f32 truth, every rejected greedy proposal of
     the perfect draft a near-tie of the truth, only accepted tokens
     advertised, every page released, launches per layer pass; acceptance,
     tokens/s against the plain Scheduler on the same traffic, the verify
     call's and the draft step's wall and device time, launches and read
     backs per tick are logged;
  11a. the MoE family (models/mixtral.py) on small f32 pods (4 experts,
     top-2) on the card against the same pods on the CPU, both page formats:
     the Scheduler over phase 7a's requests at decode_steps 1 and 4, packed
     prefill, and SpeculativeScheduler with a dense 1-layer draft over the
     MoE target; the same tokens, stats and event streams;
  11b. Mixtral-8x7B at its published widths, cut to 4 layers (bf16, seeded
     weights; phase 4 also times rows 1, 2 and 5 at its attention shape):
     phase 5c's prefill-logits and phase 6's batch-8 decode-logits checks
     (every page format and decode kernel) with the routing flips counted,
     then 8 requests (1,024 shared + 512 unique tokens, 32 new, 4 sampled)
     through the Scheduler on a bf16 pod and an int8 pod: prefix hits, each
     pod ranked first for its own prefix, launches per layer pass, phase
     7b's teacher-forced bar on every token, and the greedy tokens off the
     truth's argmax at most twice as often as the plain bf16 path's plus
     0.05 (routing flips widen the bar's delta); tokens/s, tick walls, and one
     decode tick's and one prefill chunk's device profile are logged;
  then a JSON line of details, one JSON line describing every kernel, and
  last: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.engine.costs import (
    ALWAYS_TRANSFER,
    PEER,
    READY,
    STAGED,
    TransferCostModel,
    flops_per_token,
)
from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
from llm_d_kv_cache_manager_tpu_torch.engine import speculative
from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler
from llm_d_kv_cache_manager_tpu_torch.engine.speculative import (
    SpeculativeDecoder,
    SpeculativeScheduler,
)
from llm_d_kv_cache_manager_tpu_torch.engine.tiering import IndexBackedPeerResolver
from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import Indexer
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import InMemoryIndex
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import PodEntry
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.digest import digest_batch
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import BlockRemoved, BlockStored
from llm_d_kv_cache_manager_tpu_torch.models import llama, lora, mixtral
from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.ops import flash_prefill as fp
from llm_d_kv_cache_manager_tpu_torch.ops import paged_attention as pa
from llm_d_kv_cache_manager_tpu_torch.ops import quantized_kv as qkv
from llm_d_kv_cache_manager_tpu_torch.ops.sampling import (
    SamplingParams,
    filter_logits,
    position_keys,
    prng_key,
    sample_tokens,
)

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Kernel-vs-plain bars. f32, elementwise: |kernel - plain| <= 1e-4 +
# 1e-4 |plain| (both sides accumulate in f32, in different orders). bf16, per
# output row (one query head's head_dim vector): |kernel - plain| / |plain| in
# the 2-norm. Both sides round an f32 result to bf16, and the flash kernel
# rounds its unnormalized probabilities where the plain version rounds
# normalized ones, so an elementwise bar would have to scale with each row's
# size rather than with the element's. On int8 pages the plain version rounds
# the dequantized K/V to bf16 as the reference does, where the kernels keep
# them in f32. Each limit is a few times the largest row error the kernel
# showed on an H100 and far below what a kernel that skips one 64-token
# chunk or stage, page or k-block of keys shows (chip_fault_check.py); the
# int8 limits, set on the first port's body, hold unchanged for the Hopper
# body that bf16 q now runs on int8 pages too. Rows whose plain output is
# all zeros (seq_len 0) must be exactly zero.
F32_TOL = (1e-4, 1e-4)
BF16_ROW_REL = {
    "paged_decode": 4e-3,
    "paged_decode_int8": 1.5e-2,
    "paged_decode_tiled": 4e-3,
    "paged_decode_tiled_int8": 1.5e-2,
    "flash_prefill": 1.5e-2,
}
# Packed prefill against the same jobs one by one (bf16, 16 layers): the
# largest |logit| difference allowed, four bf16 ulps at |logit| in [2, 4).
# An H100 read 0: each row's products and attention run in the same order in
# both shapes.
PACKED_LOGITS_TOL = 0.0625

FLAGSHIP = dict(
    vocab_size=32768, d_model=2048, n_layers=16, n_q_heads=16, n_kv_heads=8,
    head_dim=128, d_ff=8192,
)
PAGE = 16
N_Q, N_KV, HD = FLAGSHIP["n_q_heads"], FLAGSHIP["n_kv_heads"], FLAGSHIP["head_dim"]

# The paged-decode kernels (TPU rows 1-4): decode variant and page format.
DECODE_ROWS = {
    "paged_decode": dict(pipelined=True, int8=False),
    "paged_decode_int8": dict(pipelined=True, int8=True),
    "paged_decode_tiled": dict(pipelined=False, int8=False),
    "paged_decode_tiled_int8": dict(pipelined=False, int8=True),
}
KERNELS = (*DECODE_ROWS, "flash_prefill")
SOURCE = {  # the csrc/ source of each kernel
    "paged_decode": "paged_decode", "paged_decode_int8": "paged_decode",
    "paged_decode_tiled": "paged_decode_tiled",
    "paged_decode_tiled_int8": "paged_decode_tiled", "flash_prefill": "flash_prefill",
}
REPLACES = {
    "paged_decode": "llm_d_kv_cache_manager_tpu/ops/paged_attention.py:157",
    "paged_decode_int8": "llm_d_kv_cache_manager_tpu/ops/paged_attention.py:157",
    "paged_decode_tiled": "llm_d_kv_cache_manager_tpu/ops/paged_attention.py:78",
    "paged_decode_tiled_int8": "llm_d_kv_cache_manager_tpu/ops/paged_attention.py:78",
    "flash_prefill": "llm_d_kv_cache_manager_tpu/ops/flash_prefill.py:47",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip()


def launch_counts() -> dict:
    return {
        "paged_decode": pa.launches, "paged_decode_int8": qkv.launches,
        "paged_decode_tiled": pa.tiled_launches,
        "paged_decode_tiled_int8": qkv.tiled_launches, "flash_prefill": fp.launches,
    }


def reset_launch_counts() -> None:
    pa.launches = pa.tiled_launches = qkv.launches = qkv.tiled_launches = 0
    fp.launches = 0


def compare(kernel: str, got: torch.Tensor, ref: torch.Tensor, dtype) -> dict:
    """The kernel's output against its plain version's, under the bar for
    `kernel` and `dtype`: max abs error, max row relative error, and ok."""
    hd = got.shape[-1]
    got, ref = got.float().reshape(-1, hd), ref.float().reshape(-1, hd)
    err = got - ref
    ref_norm = ref.norm(dim=1)
    live = ref_norm > 0
    row_rel = float((err.norm(dim=1)[live] / ref_norm[live]).max()) if live.any() else 0.0
    ok = bool(torch.isfinite(got).all()) and bool((got[~live] == 0).all())
    if dtype == torch.float32:
        atol, rtol = F32_TOL
        ok = ok and bool((err.abs() <= atol + rtol * ref.abs()).all())
        bar = f"|err| <= {atol:g} + {rtol:g}|ref|"
    else:
        ok = ok and row_rel <= BF16_ROW_REL[kernel]
        bar = f"row rel <= {BF16_ROW_REL[kernel]:g}"
    max_abs = float(err.abs().max()) if err.numel() else 0.0
    return dict(max_abs_err=max_abs, row_rel_err=row_rel, bar=bar, ok=ok)


def check_close(kernel: str, name: str, got, ref, dtype) -> float:
    m = compare(kernel, got, ref, dtype)
    log(f"  {name}: max_abs_err={m['max_abs_err']:.3e} row_rel_err="
        f"{m['row_rel_err']:.3e} ({m['bar']}) {'ok' if m['ok'] else 'FAIL'}")
    if not m["ok"]:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return m["max_abs_err"]


def sdpa_gqa(q, k, v, **kwargs):
    """SDPA over grouped K/V (the library yardstick; the port never calls
    it), as a zero-argument callable."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, enable_gqa=True, **kwargs)


def profile_device_share(label: str, fn, runs: int = 3) -> dict:
    """Device kernel time per call (torch.profiler, device-side kernel rows
    only) against the call's unprofiled wall time (CUDA events): the
    device's busy share, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_ms = time_ms(fn, runs=5, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = [
        (e.self_device_time_total / 1e3 / runs, e.count // runs, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    device_ms = sum(r[0] for r in rows)
    if device_ms == 0:
        log(f"  profile {label}: wall {wall_ms:.3f} ms/call; no device time "
            "recorded (busy share not measured)")
        return dict(wall_ms=wall_ms)
    launches = sum(r[1] for r in rows)
    log(f"  profile {label}: wall {wall_ms:.3f} ms/call, device kernels "
        f"{device_ms:.3f} ms/call in {launches} launches "
        f"({100 * device_ms / wall_ms:.1f}% busy)")
    top = sorted(rows, reverse=True)[:6]
    for ms, count, key in top:
        log(f"    {ms:8.3f} ms/call {count:5d} launches/call  {key[:80]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, launches=launches,
                largest=dict(ms=top[0][0], launches=top[0][1], name=top[0][2][:80]),
                top=[dict(ms=ms, launches=count, name=key[:80]) for ms, count, key in top])


def _graph_ms(fn, calls: int, runs: int) -> float:
    """Median per-call device time, in ms, of `calls` back-to-back calls
    captured in one CUDA graph and replayed `runs` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


_L2_FLUSH = None


def time_graph_ms(fn, calls: int = 10, runs: int = 10, cold: bool = False) -> float:
    """Per-call device time of `fn`, in ms, through a CUDA graph (_graph_ms).
    `cold`: each call in the graph follows a rewrite of a 128 MB buffer, so
    it finds its inputs out of the 50 MB L2, as a decode step finds each
    layer's pages; the rewrite's own graph time, taken alone, is
    subtracted."""
    global _L2_FLUSH
    if not cold:
        return _graph_ms(fn, calls, runs)
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = _L2_FLUSH.zero_
    return (_graph_ms(lambda: (flush(), fn()), calls, runs)
            - _graph_ms(flush, calls, runs))


def time_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median of `runs` CUDA-event-timed calls, in ms (host launch cost
    included: the wall time of a call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 3/4 inputs -----------------------------------------------------------


def decode_inputs(gen, dtype, batch, seq_lens, page, n_q=N_Q, n_kv=N_KV, hd=HD,
                  max_ctx=2048, int8=False):
    """(q, pages, tables, lens): pages (k, v) in `dtype`, or int8 (k_q,
    k_scale, v_q, v_scale) quantized from the same draw."""
    pps = max_ctx // page
    n_pages = batch * pps + 3
    dev = "cuda"
    q = torch.randn(batch, n_q, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(n_kv, n_pages, page, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(n_kv, n_pages, page, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device=dev)[: batch * pps]
    tables = perm.reshape(batch, pps).to(torch.int32)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    # Slots past ceil(seq_len / page) are padding, 0 as the engine pads them.
    live = (torch.arange(pps, device=dev)[None] * page < lens[:, None].long())
    tables = torch.where(live, tables, torch.zeros_like(tables)).contiguous()
    pages = (k, v)
    if int8:
        (kq, ks), (vq, vs) = qkv.quantize_rows(k), qkv.quantize_rows(v)
        pages = (kq, ks[..., None], vq, vs[..., None])
    return q, pages, tables, lens


def run_decode(row, q, pages, tables, lens, window=None, plain=False):
    """Row `row`'s kernel (or, `plain`, its plain version) on these inputs."""
    pipelined = DECODE_ROWS[row]["pipelined"]
    if len(pages) == 2:
        if plain:
            return pa.paged_attention_reference(q, *pages, tables, lens, window=window)
        return pa.paged_attention(q, *pages, tables, lens, pipelined=pipelined,
                                  window=window)
    if plain:
        return qkv.paged_attention_quantized_reference(q, *pages, tables, lens,
                                                       window=window)
    return qkv.paged_attention_quantized(q, *pages, tables, lens, pipelined=pipelined,
                                         window=window)


def flash_inputs(gen, dtype, b, l, s, n_q=N_Q, n_kv=N_KV, hd=HD):
    dev = "cuda"
    q = torch.randn(b, l, n_q, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s, n_kv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, n_kv, hd, generator=gen, device=dev).to(dtype)
    return q, k, v


def causal_pairs(l: int, s: int, offsets, window) -> int:
    """(query, key) pairs the causal/windowed mask keeps, summed over batch."""
    total = 0
    for off in offsets:
        for i in range(l):
            hi = min(off + i + 1, s)
            lo = 0 if window is None else max(off + i - window + 1, 0)
            total += max(hi - lo, 0)
    return total


# Lengths that leave splits and cluster ranks empty: a 2,048-token sequence
# splits over every rank, the short ones over the first rank or none.
SPLIT_LENS = [0, 1, 17, 300, 2048]
# (name, lens, page, window): cases for the splits and the clusters.
SPLIT_CASES = (
    ("lens 0/1/17/300/2048", SPLIT_LENS, PAGE, None),
    # A window of 100 tokens, smaller than one split's or rank's share.
    ("window=100 inside one split", [2048, 1500, 90], PAGE, 100),
    # Page 128 holds two 64-token stages; the window starts in the second
    # (2,047 - 50 = 1,997 > 1,920 + 64), so the first stage is all masked.
    ("page=128 window=50 in a page's second stage", [2047, 1000, 130], 128, 50),
    # A page size that is not a multiple of 4 (the table holds 120 pages of
    # 17, 2,040 positions): page pieces and int8 scale runs start at any row.
    ("page=17", [0, 1, 16, 17, 18, 35, 1000, 2040], 17, None),
    ("page=17 window=100", [2040, 1500, 90, 17], 17, 100),
)

# The case of each kernel at the main path's shape (bf16, batch 8 x 2048
# context at page 16; one 2048-token causal chunk).
MAIN_CASES = {
    **{row: f"{row} bf16 page=16 window=None B=8" for row in DECODE_ROWS},
    "flash_prefill": "flash_prefill bf16 L=S=2048 off=0",
}


def verify_offsets(l: int) -> list:
    """Cached tokens of 8 speculating sequences near 1,500-2,000: no
    multiple of 64, the last at the 2,048-position table's end."""
    return [1501, 1537, 1601, 1663, 1729, 1800, 1950, 2048 - l]


def kernel_cases(gen):
    """Yields (kernel, dtype, case name, kernel output, plain output) over
    the edge cases, bf16 first, then f32. At f32 the tiled kernels are also
    held against the pipelined ones (then "plain output" is the pipelined
    kernel's)."""
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for row, spec in DECODE_ROWS.items():
            for page in (16, 64, 128):
                for window in (None, 512):
                    for batch, lens in (
                        (1, [2048]),
                        (8, [0, 1, page, page + 1, 2 * page, 1000, 2047, 2048]),
                    ):
                        q, pages, tables, lens_t = decode_inputs(
                            gen, dtype, batch, lens, page, int8=spec["int8"])
                        yield (row, dtype,
                               f"{row} {tag} page={page} window={window} B={batch}",
                               run_decode(row, q, pages, tables, lens_t, window),
                               run_decode(row, q, pages, tables, lens_t, window, plain=True))
            for n_q in (8, 32, 64):  # the other GQA groups the kernels take: 1, 4, 8
                q, pages, tables, lens_t = decode_inputs(
                    gen, dtype, 5, SPLIT_LENS, PAGE, n_q=n_q, int8=spec["int8"])
                yield (row, dtype, f"{row} {tag} group={n_q // N_KV}",
                       run_decode(row, q, pages, tables, lens_t),
                       run_decode(row, q, pages, tables, lens_t, plain=True))
            for name, lens, page, window in SPLIT_CASES:
                q, pages, tables, lens_t = decode_inputs(
                    gen, dtype, len(lens), lens, page, int8=spec["int8"])
                yield (row, dtype, f"{row} {tag} {name}",
                       run_decode(row, q, pages, tables, lens_t, window),
                       run_decode(row, q, pages, tables, lens_t, window, plain=True))
        if dtype == torch.float32:
            for tiled, piped in (("paged_decode_tiled", "paged_decode"),
                                 ("paged_decode_tiled_int8", "paged_decode_int8")):
                for page, window in ((16, None), (128, 512)):
                    q, pages, tables, lens_t = decode_inputs(
                        gen, dtype, 8, [0, 1, 37, 290, 1000, 1500, 2047, 2048], page,
                        int8=DECODE_ROWS[tiled]["int8"])
                    yield (tiled, dtype,
                           f"{tiled} {tag} vs {piped} page={page} window={window}",
                           run_decode(tiled, q, pages, tables, lens_t, window),
                           run_decode(piped, q, pages, tables, lens_t, window))
        for n_q in (8, 32):  # flash groups 1 and 4
            q, k, v = flash_inputs(gen, dtype, 1, 300, 700, n_q=n_q)
            yield ("flash_prefill", dtype,
                   f"flash_prefill {tag} group={n_q // N_KV} L=300 S=700 off=400",
                   fp.flash_prefill(q, k, v, 400), fp.dense_attention(q, k, v, 400))
        # (name, batch, L, S, offsets, window, rows kept, n_q, head_dim). The
        # bf16 kernel takes 128-row CTAs where that grid covers the card (the
        # 2,048-token chunks, the 4 x 1,000 and group-8 cases), else 64-row.
        cases = [
            ("L=S=2048 off=0", 1, 2048, 2048, 0, None, None, N_Q, HD),
            ("L=512 S=2048 off=1536", 1, 512, 2048, 1536, None, None, N_Q, HD),
            ("L=512 S=2048 off=1024", 1, 512, 2048, 1024, None, None, N_Q, HD),
            ("L=8 chunk n_valid=5 S=64 off=40", 1, 8, 64, 40, None, 5, N_Q, HD),
            ("per-batch offsets", 3, 64, 256, [0, 100, 192], None, None, N_Q, HD),
            ("L=S=2048 window=512", 1, 2048, 2048, 0, 512, None, N_Q, HD),
            ("B=4 L=1000 S=1500 per-batch offsets window=300", 4, 1000, 1500,
             [0, 100, 300, 500], 300, None, N_Q, HD),
            ("group=8 L=S=1024", 1, 1024, 1024, 0, None, None, 64, HD),
        ]
        # The speculative verify (verify_step_cache, k = 2, 4, 8): 8 rows of
        # L = k + 1 new tokens at per-batch offsets that are no multiple of
        # a tile, so most rows of a tile are padding and the diagonal lands
        # mid-tile; one offset of 0; a window.
        cases += [(f"verify B=8 L={l} S=2048 per-batch offsets", 8, l, 2048, verify_offsets(l),
                   None, None, N_Q, HD) for l in (2, 5, 9)]
        cases += [
            ("verify B=8 L=5 S=2048 offsets with 0", 8, 5, 2048, [0] + verify_offsets(5)[1:],
             None, None, N_Q, HD),
            ("verify B=8 L=5 S=2048 window=300", 8, 5, 2048, verify_offsets(5), 300, None,
             N_Q, HD),
        ]
        if dtype == torch.bfloat16:  # the f32 kernel is built for head_dim 128 only
            cases += [
                ("hd=64 L=S=2048 off=0", 1, 2048, 2048, 0, None, None, N_Q, 64),
                ("hd=64 L=300 S=700 off=400 window=200", 1, 300, 700, 400, 200, None, N_Q, 64),
            ]
        for name, b, l, s, off, window, n_valid, n_q, hd in cases:
            q, k, v = flash_inputs(gen, dtype, b, l, s, n_q=n_q, hd=hd)
            offs = off if isinstance(off, int) else torch.tensor(off, dtype=torch.int32, device="cuda")
            got = fp.flash_prefill(q, k, v, offs, window=window)
            ref = fp.dense_attention(q, k, v, offs, window=window)
            if n_valid is not None:
                got, ref = got[:, :n_valid], ref[:, :n_valid]
            yield "flash_prefill", dtype, f"flash_prefill {tag} {name}", got, ref


def determinism_checks(gen) -> int:
    """Two calls of each decode kernel for bf16 q (cluster merge, split and
    combine; bf16 and int8 pages) on the same inputs give the same bits (no
    atomics; phase 6's multi-step check relies on it)."""
    n = 0
    for row, spec in DECODE_ROWS.items():
        for lens in (SPLIT_LENS, [0, 1, PAGE, PAGE + 1, 2 * PAGE, 1000, 2047, 2048]):
            q, pages, tables, lens_t = decode_inputs(gen, torch.bfloat16, len(lens), lens, PAGE,
                                                     int8=spec["int8"])
            first = run_decode(row, q, pages, tables, lens_t)
            second = run_decode(row, q, pages, tables, lens_t)
            torch.cuda.synchronize()
            same = torch.equal(first, second)
            log(f"  {row} bf16 B={len(lens)}: two calls bit-identical: {same}")
            if not same:
                raise AssertionError(f"{row}: two calls on the same inputs differ")
            n += 1
    return n


def phase_kernel_checks(gen) -> dict:
    log("== phase 3: kernels vs plain versions")
    errs, n = {}, 0
    for kernel, dtype, name, got, ref in kernel_cases(gen):
        torch.cuda.synchronize()
        err = check_close(kernel, name, got, ref, dtype)
        n += 1
        if name == MAIN_CASES[kernel]:
            errs[kernel] = err
    n += determinism_checks(gen)
    log(f"  {n} checks passed")
    return errs


def _bound(nbytes: int, flops: int) -> dict:
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


# Decode timing shapes: (batch, context, table positions). The serving shape
# is a pod's one request at a time, 1,536 tokens into its 128-page table.
DECODE_SHAPES = {
    "B=8 ctx=2048": (8, 2048, 2048),
    "B=1 ctx=1536 table=2048": (1, 1536, 2048),
    "B=1 ctx=4096": (1, 4096, 4096),
}


def time_decode(gen, row: str, shape: str, plain: bool = True, n_q: int = N_Q) -> dict:
    """Row `row` at a DECODE_SHAPES shape (bf16 q, page 16, n_q query heads
    over the flagship's 8 KV heads), each call cold in L2: kernel, plain
    version (`plain`), SDPA over pre-gathered K/V of the live positions (bf16
    pages only; no PyTorch call attends over int8 pages), and the bound. On
    the timed inputs the kernel is also held against its plain version
    (max_abs_err, under phase 3's bar)."""
    batch, ctx, table_ctx = DECODE_SHAPES[shape]
    int8 = DECODE_ROWS[row]["int8"]
    q, pages, tables, lens = decode_inputs(gen, torch.bfloat16, batch, [ctx] * batch,
                                           PAGE, max_ctx=table_ctx, int8=int8, n_q=n_q)
    err = check_close(row, f"{row} {shape} n_q={n_q}", run_decode(row, q, pages, tables, lens),
                      run_decode(row, q, pages, tables, lens, plain=True), torch.bfloat16)
    kernel_ms = time_graph_ms(lambda: run_decode(row, q, pages, tables, lens), cold=True)
    plain_ms = None
    if plain:
        plain_ms = time_graph_ms(lambda: run_decode(row, q, pages, tables, lens, plain=True),
                                 cold=True)
    library_ms = None
    if not int8:
        k, v = pages
        kd, vd = (p[:, tables.long()].movedim(1, 0).reshape(batch, N_KV, -1, HD)[:, :, :ctx]
                  .contiguous() for p in (k, v))
        library_ms = time_graph_ms(sdpa_gqa(q[:, :, None], kd, vd), cold=True)
    live = int(lens.sum())
    kv_row_bytes = HD * (1 if int8 else 2) + (4 if int8 else 0)  # values (+ scale)
    live_pages = batch * -(-ctx // PAGE)
    nbytes = 2 * live * N_KV * kv_row_bytes + 2 * batch * n_q * HD * 2 + live_pages * 4
    out = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               **_bound(nbytes, 4 * live * n_q * HD), mbytes=nbytes / 1e6, max_abs_err=err)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    plain_txt = "" if plain_ms is None else f", plain {plain_ms:.4f} ms"
    log(f"  {row} {shape} page={PAGE} n_q={n_q}: kernel {kernel_ms:.4f} ms "
        f"({nbytes / kernel_ms / 1e6:.1f} GB/s){plain_txt}, SDPA {lib}, bound "
        f"{out['bound_ms']:.4f} ms ({nbytes / 1e6:.2f} MB)")
    return out


def phase_times(gen) -> tuple:
    log("== phase 4: times at the main path's shapes (bf16)")
    decode = {shape: {row: time_decode(gen, row, shape) for row in DECODE_ROWS}
              for shape in DECODE_SHAPES}
    main = dict(decode["B=8 ctx=2048"])

    # Prefill: one 2048-token causal chunk at offset 0 (the row's main shape),
    # and the serving chunk.
    main["flash_prefill"] = time_prefill(gen, 2048, 2048, 0)
    serving = time_prefill(gen, *PREFILL_SERVING_SHAPE)
    verify = time_verify(gen)
    # Phase 11's model (Mixtral-8x7B) at its attention shape: 32 query heads
    # over the same 8 KV heads, a GQA group of 4 (the flagship's is 2).
    n_q = MIXTRAL["n_q_heads"]
    log(f"  at the Mixtral attention shape (n_q {n_q}, n_kv {MIXTRAL['n_kv_heads']})")
    mixtral_shape = {shape: {row: time_decode(gen, row, shape, n_q=n_q)
                             for row in ("paged_decode", "paged_decode_int8")}
                     for shape in ("B=8 ctx=2048", "B=1 ctx=1536 table=2048")}
    mixtral_shape["flash_prefill serving"] = time_prefill(gen, *PREFILL_SERVING_SHAPE, n_q=n_q)
    return main, decode, serving, verify, mixtral_shape


# The prefill call of a prefix-hit request in phase 5: 512 new tokens after
# 1,024 cached, against the pod's padded table (1,536 tokens need 96 pages of
# 16, padded to a power of two: 128 pages, 2,048 positions).
PREFILL_SERVING_SHAPE = (512, 2048, 1024)


def time_prefill(gen, l: int, s: int, off: int, n_q: int = N_Q) -> dict:
    """Row 5 at L new tokens after `off` cached, S positions of K/V (bf16,
    n_q query heads over the flagship's 8 KV heads): kernel, plain version,
    SDPA (is_causal where off == 0 and L == S, else a lower-right causal bias
    over the first off + L keys, the same function), and the bound over the
    keys the mask keeps. On the timed inputs the kernel is also held against
    its plain version."""
    q, k, v = flash_inputs(gen, torch.bfloat16, 1, l, s, n_q=n_q)
    err = check_close("flash_prefill", f"flash_prefill L={l} S={s} off={off} n_q={n_q}",
                      fp.flash_prefill(q, k, v, off), fp.dense_attention(q, k, v, off),
                      torch.bfloat16)
    kernel_ms = time_graph_ms(lambda: fp.flash_prefill(q, k, v, off))
    plain_ms = time_graph_ms(lambda: fp.dense_attention(q, k, v, off))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms, library_note = None, "SDPA is_causal"
    if off == 0 and l == s:
        library_ms = time_graph_ms(sdpa_gqa(qt, kt, vt, is_causal=True))
    else:
        from torch.nn.attention.bias import causal_lower_right

        library_note = f"SDPA causal_lower_right({l}, {off + l}) on the first {off + l} keys"
        kt, vt = kt[:, :, : off + l], vt[:, :, : off + l]
        sdpa = sdpa_gqa(qt, kt, vt, attn_mask=causal_lower_right(l, off + l))
        try:  # eagerly first: a failed call must not end inside a graph capture
            sdpa()
            torch.cuda.synchronize()
        except RuntimeError as exc:  # no SDPA backend takes this bias with GQA
            library_note += f": none ({type(exc).__name__}: {str(exc)[:120]})"
        else:
            library_ms = time_graph_ms(sdpa)
    keys = min(s, off + l)
    flops = 4 * causal_pairs(l, s, [off], None) * n_q * HD
    nbytes = (2 * l * n_q * HD + 2 * keys * N_KV * HD) * 2
    out = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, **_bound(nbytes, flops),
               gflop=flops / 1e9, max_abs_err=err)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"  flash_prefill L={l} S={s} off={off} n_q={n_q}: kernel {kernel_ms:.4f} ms "
        f"({flops / kernel_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, {library_note} "
        f"{lib}, bound {out['bound_ms']:.4f} ms ({flops / 1e9:.2f} GFLOP)")
    return out


# The verify call of the speculative scheduler at k = 4: 8 sequences of 5
# new tokens after about 1,500 cached, over the padded 128-page table.
VERIFY_SHAPE = (8, 5, 2048, 1503)  # batch, L, S, cached tokens of every row


def time_verify(gen) -> dict:
    """Row 5 at VERIFY_SHAPE (per-batch offsets, all equal): kernel, plain
    version, SDPA with a lower-right causal mask over the first off + L keys
    (one mask fits every row), and the bound over the keys the mask keeps."""
    from torch.nn.attention.bias import causal_lower_right

    b, l, s, off = VERIFY_SHAPE
    q, k, v = flash_inputs(gen, torch.bfloat16, b, l, s)
    offs = torch.full((b,), off, dtype=torch.int32, device="cuda")
    kernel_ms = time_graph_ms(lambda: fp.flash_prefill(q, k, v, offs))
    plain_ms = time_graph_ms(lambda: fp.dense_attention(q, k, v, offs))
    keys = off + l
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t[:, :keys].transpose(1, 2).contiguous() for t in (k, v))
    sdpa = sdpa_gqa(qt, kt, vt, attn_mask=causal_lower_right(l, keys))
    library_ms, note = None, f"SDPA causal_lower_right({l}, {keys}) on the first {keys} keys"
    try:
        sdpa()
        torch.cuda.synchronize()
    except RuntimeError as exc:
        note += f": none ({type(exc).__name__}: {str(exc)[:120]})"
    else:
        library_ms = time_graph_ms(sdpa)
    flops = 4 * causal_pairs(l, s, [off] * b, None) * N_Q * HD
    nbytes = (2 * b * l * N_Q * HD + 2 * b * keys * N_KV * HD) * 2
    table_mbytes = 2 * b * s * N_KV * HD * 2 / 1e6
    out = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, **_bound(nbytes, flops),
               gflop=flops / 1e9, mbytes=nbytes / 1e6, table_mbytes=table_mbytes)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"  flash_prefill verify B={b} L={l} S={s} off={off}: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, {note} {lib}, bound {out['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB "
        f"of the kept keys, {table_mbytes:.1f} MB over the whole table; {flops / 1e9:.3f} GFLOP)")
    return out


# -- phase 5: serving -------------------------------------------------------------


def event_rows(batches) -> list:
    return [
        (type(e).__name__, list(e.block_hashes),
         getattr(e, "parent_block_hash", None), list(getattr(e, "token_ids", [])), e.medium)
        for batch in batches for e in batch.events
        if isinstance(e, (BlockStored, BlockRemoved))
    ]


def phase_serving(params, cfg) -> dict:
    log("== phase 5: serving two bf16 flagship pods (4096 pages of 16 each) and "
        "one int8-KV pod (8192 pages of 16)")
    model = "llama-flagship-1.14b"
    index = InMemoryIndex()
    tp_cfg = TokenProcessorConfig(block_size=PAGE)
    indexer = Indexer(tp_cfg, kv_block_index=index)

    def sink_for(pod_id):
        return lambda batch: digest_batch(
            index, indexer.token_processor, pod_id, model, batch
        )

    layout = {"pod-a": (4096, False), "pod-b": (4096, False), "pod-q": (8192, True)}
    pods = {
        pid: EnginePod(
            EnginePodConfig(
                pod_id=pid, model_name=model, n_pages=n_pages, page_size=PAGE,
                device_tier="gpu", max_pages_per_seq=256, model_config=cfg,
                device="cuda", use_quantized_kv=int8,
            ),
            event_sink=sink_for(pid), params=params,
        )
        for pid, (n_pages, int8) in layout.items()
    }
    rng = np.random.default_rng(1234)
    prefixes = {pid: rng.integers(0, cfg.vocab_size, 1024).tolist() for pid in pods}

    reset_launch_counts()
    ttfts = {pid: [] for pid in pods}
    decode = {pid: [0, 0.0] for pid in pods}  # tokens, seconds
    for pid, n_requests in (("pod-a", 4), ("pod-b", 2), ("pod-q", 4)):
        pod = pods[pid]
        for r in range(n_requests):
            tokens = prefixes[pid] + rng.integers(0, cfg.vocab_size, 512).tolist()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, cached = pod.prefill(tokens)
            first = int(torch.argmax(pod.last_logits))
            ttft = time.perf_counter() - t0
            if not torch.isfinite(pod.last_logits).all():
                raise AssertionError(f"{pid} request {r}: non-finite prefill logits")
            pod.decode_append(state, first)
            t1 = time.perf_counter()
            generated = [pod.decode_step(state) for _ in range(31)]
            decode[pid][1] += time.perf_counter() - t1
            decode[pid][0] += len(generated)
            if not all(0 <= t < cfg.vocab_size for t in [first] + generated):
                raise AssertionError(f"{pid} request {r}: token out of vocabulary")
            want = 0 if r == 0 else 1024
            if cached != want:
                raise AssertionError(f"{pid} request {r}: cached {cached}, expected {want}")
            ttfts[pid].append(ttft)
            log(f"  {pid} request {r}: cached {cached} tokens, TTFT {ttft * 1e3:.2f} ms")
            pod.free(state)
    torch.cuda.synchronize()
    launches = launch_counts()
    tokens_per_s = {pid: n / s for pid, (n, s) in decode.items()}
    for pid in pods:
        log(f"  {pid} ({'int8' if layout[pid][1] else 'bf16'} KV): decode "
            f"{decode[pid][0]} tokens at batch 1, {tokens_per_s[pid]:.2f} tokens/s; "
            f"prefix-hit TTFT {min(ttfts[pid][1:]) * 1e3:.2f}-"
            f"{max(ttfts[pid][1:]) * 1e3:.2f} ms")
    log(f"  kernel launches on the serving path: {launches}")
    for name in ("paged_decode", "paged_decode_int8", "flash_prefill"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel was never launched on the serving path")
    # 16 layers x 31 decode steps x 4 requests on the int8 pod.
    if launches["paged_decode_int8"] != 16 * 31 * 4:
        raise AssertionError(f"int8 decode launches {launches['paged_decode_int8']}")

    for pid in pods:
        probe = prefixes[pid] + rng.integers(0, cfg.vocab_size, 256).tolist()
        scores = indexer.get_pod_scores(probe, model, list(pods))
        best = max(scores, key=scores.get) if scores else None
        log(f"  scores for a {pid}-prefix prompt: {scores}")
        if best != pid:
            raise AssertionError(f"{pid}-prefix prompt ranked {best} first")

    # Where a prefix-hit prefill's time goes (outside the counted window).
    pod = pods["pod-a"]
    tokens = prefixes["pod-a"] + rng.integers(0, cfg.vocab_size, 512).tolist()
    state, start = pod.begin_prefill(tokens)
    prefill_profile = profile_device_share(
        f"prefill chunk of {len(tokens) - start} tokens after {start} cached",
        lambda: pod.prefill_chunk(state, start, len(tokens)),
    )
    pod.finish_prefill(state)
    pod.free(state)
    del pods, pod
    torch.cuda.empty_cache()
    return dict(launches=launches, ttft_ms={p: [t * 1e3 for t in v] for p, v in ttfts.items()},
                decode_tokens_per_s=tokens_per_s, prefill_profile=prefill_profile)


def phase_packed_prefill(params, cfg) -> dict:
    log("== phase 5 (packed prefill): 4 jobs in one batched pass vs one by one")
    rng = np.random.default_rng(99)
    shared = rng.integers(0, cfg.vocab_size, 256).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, 200).tolist(),
               rng.integers(0, cfg.vocab_size, 400).tolist(),
               shared + rng.integers(0, cfg.vocab_size, 300).tolist(),
               rng.integers(0, cfg.vocab_size, 350).tolist()]
    out = {}
    for int8 in (False, True):
        runs = []
        for packed in (True, False):
            events = []
            pod = EnginePod(
                EnginePodConfig(n_pages=1024, page_size=PAGE, device_tier="gpu",
                                max_pages_per_seq=64, model_config=cfg, device="cuda",
                                use_quantized_kv=int8),
                event_sink=events.append, params=params,
            )
            state, _ = pod.prefill(shared)
            pod.free(state)
            jobs = []
            for prompt in prompts:
                state, start = pod.begin_prefill(prompt)
                jobs.append((state, start, len(prompt)))
            before = fp.launches
            if packed:
                logits = pod.prefill_chunk_batch(jobs)
            else:
                logits = []
                for state, start, end in jobs:
                    pod.prefill_chunk(state, start, end)
                    logits.append(pod.last_logits)
            n_flash = fp.launches - before
            for state, _, _ in jobs:
                pod.finish_prefill(state)
            runs.append(dict(starts=[s for _, s, _ in jobs], n_flash=n_flash,
                             logits=torch.stack(logits).float(), events=event_rows(events)))
            for state, _, _ in jobs:
                pod.free(state)
            del pod
        tag = "int8" if int8 else "bf16"
        a, b = runs
        err = float((a["logits"] - b["logits"]).abs().max())
        finite = bool(torch.isfinite(a["logits"]).all())
        same_events = a["events"] == b["events"]
        log(f"  {tag}: starts {a['starts']}; flash launches {a['n_flash']} packed vs "
            f"{b['n_flash']} one by one; logits max_abs_diff={err:.4e} (tol "
            f"{PACKED_LOGITS_TOL:g}), max |logit| {float(b['logits'].abs().max()):.4f}; "
            f"event streams equal: {same_events} ({len(a['events'])} events)")
        if not finite or err > PACKED_LOGITS_TOL or not same_events or a["n_flash"] != 16:
            raise AssertionError(f"packed prefill ({tag}) disagrees with one-by-one prefill")
        out[tag] = dict(max_abs_diff=err, events=len(a["events"]))
    torch.cuda.empty_cache()
    return out


# Phases 5b and 7a: a small f32 model at the kernels' head_dim, cheap on the CPU.
SMALL_MODEL = dict(vocab_size=512, d_model=256, n_layers=2, n_q_heads=4, n_kv_heads=2,
                   head_dim=128, d_ff=512)


def small_model(device, seed: int = 7, **over):
    """The small f32 model (fields of SMALL_MODEL replaced by `over`) on
    `device`, the same seeded weights on every device: (params, config)."""
    cfg = llama.LlamaConfig(**{**SMALL_MODEL, **over}, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return to_device(params, device), cfg


def to_device(tree, device):
    """A parameter or adapter tree (tensors, or dicts of them) on `device`."""
    return {k: (v.to(device) if torch.is_tensor(v) else to_device(v, device))
            for k, v in tree.items()}


def phase_small_pod_vs_cpu() -> None:
    log("== phase 5b: small f32 pod on the card vs the same pod on the CPU")
    for int8 in (False, True):
        runs = {}
        for device in ("cuda", "cpu"):
            events = []
            params, cfg = small_model(device)
            pod = EnginePod(
                EnginePodConfig(n_pages=8, page_size=PAGE, device_tier="gpu",
                                max_pages_per_seq=8, model_config=cfg, device=device,
                                use_quantized_kv=int8),
                event_sink=events.append, params=params,
            )
            tokens_out, logits = [], []
            for prompt in (list(range(40)), list(range(40)) + [5, 6, 7], list(range(100, 190))):
                state, _ = pod.prefill(prompt)
                logits.append(pod.last_logits.float().cpu())
                tok = int(torch.argmax(pod.last_logits))
                pod.decode_append(state, tok)
                tokens_out.append([tok] + [pod.decode_step(state) for _ in range(12)])
                pod.free(state)
            runs[device] = (tokens_out, logits, event_rows(events))
        gpu, cpu = runs["cuda"], runs["cpu"]
        err = max(float((a - b).abs().max()) for a, b in zip(gpu[1], cpu[1]))
        log(f"  {'int8' if int8 else 'f32'} pages: prefill logits max_abs_err={err:.3e} "
            f"(tol 1e-3); tokens equal: {gpu[0] == cpu[0]}; event streams equal: "
            f"{gpu[2] == cpu[2]} ({len(gpu[2])} events, "
            f"{sum(e[0] == 'BlockRemoved' for e in gpu[2])} removals)")
        if err > 1e-3 or gpu[0] != cpu[0] or gpu[2] != cpu[2]:
            raise AssertionError("small pod on the card disagrees with the CPU pod")


# -- phase 5c: prefill logits ------------------------------------------------------


def f32_twin(params, cfg):
    """The same weights in f32, and their config."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: (v.float() if torch.is_tensor(v) else {n: w.float() for n, w in v.items()})
                for k, v in params.items()}
    return params32, cfg32


def prefill_logits_check(params, cfg, params32, cfg32, seed: int = 3) -> dict:
    """A prefix-hit prefill through the flash kernel path against the plain
    path, both against an f32 truth (the plain path with f32 weights and an
    f32 cache): the 1,024-token prefix, then the serving chunk of 512 at
    offset 1,024, over a table padded to 128 pages as the pod pads it."""
    l_new, s, off = PREFILL_SERVING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (off + l_new,), generator=gen, device="cuda",
                           dtype=torch.int32)
    table = torch.randperm(s // PAGE, generator=gen, device="cuda").to(torch.int32)
    logits, launches = {}, 0
    for name, c, p, plain in (("truth", cfg32, params32, True), ("kernel", cfg, params, False),
                              ("plain", cfg, params, True)):
        cache = llama.make_kv_pages(c, s // PAGE, PAGE, "cuda")
        before = fp.launches
        llama.prefill_cache(c, p, cache, tokens[:off], table, 0, plain=plain)
        _, out = llama.prefill_cache(c, p, cache, tokens[off:], table, off, plain=plain)
        torch.cuda.synchronize()
        if name == "kernel":
            launches = fp.launches - before
        logits[name] = out.float()
        del cache
    err = float((logits["kernel"] - logits["plain"]).abs().max())
    err_kernel = float((logits["kernel"] - logits["truth"]).abs().max())
    err_plain = float((logits["plain"] - logits["truth"]).abs().max())
    # As for decode: bf16 through 16 layers moves both bf16 paths off the
    # f32 truth; the kernel path may not stray further than twice the plain
    # path's own error (plus 1e-2 absolute).
    tol = 2 * err_plain + 1e-2
    ok = (bool(torch.isfinite(logits["kernel"]).all())
          and logits["kernel"].shape == (cfg.vocab_size,)
          and err_kernel <= tol and launches == 2 * cfg.n_layers)
    log(f"  prefill {l_new} after {off} cached: kernel vs plain max_abs_err={err:.4e}; vs f32 "
        f"truth: kernel {err_kernel:.4e}, plain {err_plain:.4e} (tol {tol:.4e}); max |logit| "
        f"{float(logits['truth'].abs().max()):.4f}; argmax agrees: "
        f"{int(logits['kernel'].argmax()) == int(logits['plain'].argmax())}; flash launches "
        f"{launches} {'ok' if ok else 'FAIL'}")
    return dict(ok=ok, launches=launches, max_abs_err=err, err_kernel_vs_f32=err_kernel,
                err_plain_vs_f32=err_plain)


def phase_prefill_logits(params, cfg) -> dict:
    log("== phase 5c: prefill logits, kernel path vs plain path vs f32 truth")
    params32, cfg32 = f32_twin(params, cfg)
    r = prefill_logits_check(params, cfg, params32, cfg32)
    del params32
    torch.cuda.empty_cache()
    if not r["ok"]:
        raise AssertionError("prefill logits (flash_prefill) fail their bar")
    return r


# -- phase 6: batched decode --------------------------------------------------------

DECODE_BATCH, DECODE_CTX = 8, 2048


def decode_setup(cfg, int8: bool, seed: int):
    """A batch-8 decode state at 2,047 cached tokens per sequence, the same
    for the same seed: (cache, tables, lens, tokens, trash_page). Tables
    cover 16 positions more than the context; page `trash_page` is in none."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pps = DECODE_CTX // PAGE + 1
    trash = DECODE_BATCH * pps
    make = llama.make_kv_pages_quantized if int8 else llama.make_kv_pages
    cache = make(cfg, trash + 1, PAGE, "cuda")
    for i in range(cfg.n_layers):
        for j in (0, 1):
            rows = torch.randn(cache[0].shape[1:], generator=gen, device="cuda")
            if int8:
                values, scales = qkv.quantize_rows(rows)
                cache[2 * j][i] = values
                cache[2 * j + 1][i] = scales[..., None]
            else:
                cache[j][i] = rows.to(cache[j].dtype)
    tables = torch.randperm(trash, generator=gen, device="cuda")
    tables = tables.reshape(DECODE_BATCH, pps).to(torch.int32).contiguous()
    lens = torch.full((DECODE_BATCH,), DECODE_CTX - 1, dtype=torch.int32, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (DECODE_BATCH,), generator=gen,
                           device="cuda", dtype=torch.int32)
    return cache, tables, lens, tokens, trash


def batched_decode_check(params, cfg, params32, cfg32, int8: bool, pipelined: bool,
                         seed: int = 5) -> dict:
    """One batch-8 decode step through the kernel path against the plain path,
    both against an f32 truth (the plain path with f32 weights on the same
    pools, made before the bf16 steps write their new rows)."""
    label = f"{'int8' if int8 else 'bf16'} pages, {'pipelined' if pipelined else 'tiled'}"
    cache, tables, lens, tokens, _ = decode_setup(cfg, int8, seed)
    page_ids = torch.gather(tables, 1, (lens // PAGE).long()[:, None])[:, 0]
    cache32 = tuple(p.float() if p.dtype == torch.bfloat16 else p.clone() for p in cache)
    _, truth = llama._decode_once(cfg32, params32, cache32, tokens, tables, lens,
                                  page_ids, lens % PAGE, plain=True)
    del cache32
    reset_launch_counts()
    _, logits = llama.decode_step_cache(cfg, params, cache, tokens, tables, lens,
                                        pipelined=pipelined)
    torch.cuda.synchronize()
    launches = launch_counts()
    _, plain = llama._decode_once(cfg, params, cache, tokens, tables, lens, page_ids,
                                  lens % PAGE, plain=True)
    torch.cuda.synchronize()
    err = float((logits.float() - plain.float()).abs().max())
    err_kernel = float((logits.float() - truth).abs().max())
    err_plain = float((plain.float() - truth).abs().max())
    agree = int((logits.argmax(-1) == plain.argmax(-1)).sum())
    # bf16 rounding through 16 layers moves both bf16 paths off the f32
    # truth; the kernel path may not stray further than twice the plain
    # path's own bf16 error (plus 1e-2 absolute).
    tol = 2 * err_plain + 1e-2
    row = ("paged_decode_tiled" if not pipelined else "paged_decode") + ("_int8" if int8 else "")
    ok = (bool(torch.isfinite(logits).all()) and logits.shape == (DECODE_BATCH, cfg.vocab_size)
          and err_kernel <= tol and launches[row] == cfg.n_layers)
    log(f"  {label}: kernel vs plain max_abs_err={err:.4e}; vs f32 truth: kernel "
        f"{err_kernel:.4e}, plain {err_plain:.4e} (tol {tol:.4e}); max |logit| "
        f"{float(truth.abs().max()):.4f}; argmax agrees on {agree}/{DECODE_BATCH}; "
        f"{row} launches {launches[row]} {'ok' if ok else 'FAIL'}")
    return dict(ok=ok, row=row, launches=launches[row], max_abs_err=err,
                err_kernel_vs_f32=err_kernel, err_plain_vs_f32=err_plain,
                argmax_agree=agree, cache=cache, inputs=(tokens, tables, lens))


def multi_step_check(params, cfg, int8: bool, n_steps: int = 8) -> bool:
    """decode_multi_step_cache against n_steps single decode_step_cache calls
    on a twin cache: the same greedy tokens."""
    cache, tables, lens, tokens, trash = decode_setup(cfg, int8, seed=11)
    _, multi = llama.decode_multi_step_cache(cfg, params, cache, tokens, tables, lens,
                                             lens + n_steps, trash, n_steps)
    del cache
    twin, _, _, _, _ = decode_setup(cfg, int8, seed=11)
    tok, pos, single = tokens, lens, []
    for _ in range(n_steps):
        _, logits = llama.decode_step_cache(cfg, params, twin, tok, tables, pos,
                                            pipelined=True)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        single.append(tok)
        pos = pos + 1
    same = torch.equal(multi, torch.stack(single, dim=1))
    log(f"  multi-step ({'int8' if int8 else 'bf16'} pages, {n_steps} steps, batch "
        f"{DECODE_BATCH}): tokens equal to single steps: {same}")
    return same


def phase_batched_decode(params, cfg) -> dict:
    log(f"== phase 6: batched decode, batch {DECODE_BATCH} x context {DECODE_CTX}, "
        "kernel vs plain path, every page format and decode kernel")
    params32, cfg32 = f32_twin(params, cfg)
    results, profiles = {}, {}
    for int8 in (False, True):
        for pipelined in (True, False):
            r = batched_decode_check(params, cfg, params32, cfg32, int8, pipelined)
            cache, (tokens, tables, lens) = r.pop("cache"), r.pop("inputs")
            if not r["ok"]:
                raise AssertionError(f"batched decode ({r['row']}) fails its bar")
            results[r["row"]] = r
            if pipelined:
                profiles[r["row"]] = profile_device_share(
                    f"decode step, batch {DECODE_BATCH}, {'int8' if int8 else 'bf16'} pages",
                    lambda: llama.decode_step_cache(cfg, params, cache, tokens, tables, lens,
                                                    pipelined=True),
                )
            del cache
    del params32
    torch.cuda.empty_cache()
    for int8 in (False, True):
        if not multi_step_check(params, cfg, int8):
            raise AssertionError("multi-step decode tokens differ from single steps")
    for row, prof in profiles.items():
        ms = prof["wall_ms"]
        log(f"  decode step ({row}, 16 layers, batch {DECODE_BATCH}): {ms:.3f} ms, "
            f"{DECODE_BATCH / ms * 1e3:.1f} tokens/s")
    return dict(checks=results, step_profiles=profiles)


# -- phase 7: the scheduler -------------------------------------------------------

# The llama entry points the pod and the scheduler call, with the layer
# passes each call makes (decode_multi_step_cache: one per step).
MODEL_CALLS = ("prefill_cache", "verify_step_cache", "decode_step_cache",
               "decode_multi_step_cache")


class CallCounter:
    """Counts the layer passes of the llama entry points the pod and the
    scheduler call (they look them up on the module at call time), and keeps
    the arguments of the first decode call at the largest batch."""

    def __init__(self):
        self.passes = dict.fromkeys(MODEL_CALLS, 0)
        self.kernels = dict.fromkeys(KERNELS, 0)  # launches the calls must make
        self.decode_call = None
        self.first_call = {}  # (name, tokens' shape) -> (args, kwargs) of its first call
        self._originals = {}

    def __enter__(self):
        for name in MODEL_CALLS:
            self._originals[name] = getattr(llama, name)
            setattr(llama, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self._originals.items():
            setattr(llama, name, fn)

    def _wrap(self, name):
        fn = self._originals[name]

        def counted(*args, **kwargs):
            passes = args[8] if name == "decode_multi_step_cache" else 1
            self.passes[name] += passes
            # One attention launch per layer pass: flash for a prefill or a
            # verify, the pipelined decode kernel of the cache's format.
            if name in ("prefill_cache", "verify_step_cache"):
                row = "flash_prefill"
            else:
                row = "paged_decode_int8" if len(args[2]) == 4 else "paged_decode"
            self.kernels[row] += args[0].n_layers * passes
            self.first_call.setdefault((name, tuple(args[3].shape)), (args, kwargs))
            if name.startswith("decode") and (
                    self.decode_call is None or args[3].shape[0] > self.decode_call[1][3].shape[0]):
                self.decode_call = (name, args, kwargs)
            return fn(*args, **kwargs)
        return counted

    def layer_passes(self) -> dict:
        p = self.passes
        return dict(prefill=p["prefill_cache"] + p["verify_step_cache"],
                    decode=p["decode_step_cache"] + p["decode_multi_step_cache"])


def run_scheduler(pod, traffic, decode_steps, max_batch, budget, scheduler=Scheduler) -> dict:
    """Submit every request of `traffic` at once to a `scheduler` and step it
    until it drains: tokens, requests, each tick's wall time, each request's
    time from submit to its first token, preemptions."""
    sched = scheduler(pod, max_batch=max_batch, prefill_token_budget=budget,
                      decode_steps=decode_steps)
    core = getattr(sched, "inner", sched)  # a SpeculativeScheduler's Scheduler
    if pod.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [sched.submit(**req) for req in traffic]
    ticks, first_token_s, done = [], {}, {}
    while sched.has_work:
        t = time.perf_counter()
        finished = sched.step()  # reads the tick's tokens back: the tick is over
        now = time.perf_counter()
        ticks.append(now - t)
        done.update({r.req_id: r for r in finished})
        for r in [*core._running, *core._waiting, *finished]:
            if r.generated and r.req_id not in first_token_s:
                first_token_s[r.req_id] = now - t0
    wall = time.perf_counter() - t0
    return dict(tokens=[done[i].generated for i in ids], requests=[done[i] for i in ids],
                tick_s=ticks, wall_s=wall, first_token_s=[first_token_s[i] for i in ids],
                preemptions=core.preemptions, scheduler=sched)


def small_traffic() -> list:
    """Phase 7a's six requests: three greedy, three sampled (explicit seeds,
    top_p 0.9), two sharing a two-page prefix, 24 new tokens each."""
    rng = np.random.default_rng(71)
    vocab = SMALL_MODEL["vocab_size"]
    prefix = rng.integers(0, vocab, 2 * PAGE).tolist()
    prompts = [prefix + rng.integers(0, vocab, 20).tolist(),
               prefix + rng.integers(0, vocab, 28).tolist()]
    prompts += [rng.integers(0, vocab, n).tolist() for n in (40, 24, 56, 18)]
    samplings = [None, SamplingParams(0.8, 20, 0.9, seed=11), None,
                 SamplingParams(1.5, 0, 0.9, seed=12), None, SamplingParams(1.1, 20, 0.9, seed=13)]
    return [dict(prompt_tokens=p, max_new_tokens=24, sampling=sp)
            for p, sp in zip(prompts, samplings)]


# Phase 7a's pod: pages for about three of the six sequences at full length,
# so decodes preempt.
SMALL_SCHED_PAGES = 12


def phase_scheduler_small() -> dict:
    log("== phase 7a: the scheduler, small f32 pod on the card vs the CPU (6 mixed "
        "requests, a preempting pool, decode_steps 1 and 4)")
    traffic, out = small_traffic(), {}
    for int8 in (False, True):
        tag = "int8" if int8 else "f32"
        runs = {}
        for device in ("cuda", "cpu"):
            params, cfg = small_model(device)
            for steps in (1, 4):
                events = []
                pod = EnginePod(
                    EnginePodConfig(n_pages=SMALL_SCHED_PAGES, page_size=PAGE, device_tier="gpu",
                                    max_pages_per_seq=8, model_config=cfg, device=device,
                                    use_quantized_kv=int8),
                    event_sink=events.append, params=params,
                )
                r = run_scheduler(pod, traffic, steps, max_batch=4, budget=3 * PAGE)
                runs[device, steps] = (r["tokens"], event_rows(events), r["preemptions"])
        for steps in (1, 4):
            gpu, cpu = runs["cuda", steps], runs["cpu", steps]
            log(f"  {tag} pages, decode_steps {steps}: tokens equal to the CPU's: "
                f"{gpu[0] == cpu[0]}; event streams equal: {gpu[1] == cpu[1]} ({len(gpu[1])} "
                f"events, {sum(e[0] == 'BlockRemoved' for e in gpu[1])} removals); preemptions "
                f"{gpu[2]} (CPU {cpu[2]})")
            if gpu[0] != cpu[0] or gpu[1] != cpu[1] or gpu[2] < 1 or cpu[2] < 1:
                raise AssertionError(f"scheduler on the card disagrees with the CPU ({tag}, "
                                     f"decode_steps {steps}) or nothing was preempted")
        for device in ("cuda", "cpu"):
            same = runs[device, 1][0] == runs[device, 4][0]
            log(f"  {tag} pages on {device}: decode_steps 1 and 4 give the same tokens: {same}")
            if not same:
                raise AssertionError(f"decode_steps 1 and 4 differ ({tag}, {device})")
        out[tag] = dict(events=len(runs["cuda", 1][1]), preemptions=runs["cuda", 1][2],
                        tokens=runs["cuda", 1][0])
    return out


def flagship_traffic(vocab: int, eos_token=None) -> tuple:
    """Phase 7b's 16 requests, submitted at once: 12 of 1,024 shared + 512
    unique tokens, 4 unique prompts of 64-256 tokens, interleaved at the
    head of the queue; max_new_tokens staggered from 16 to 48; 8 greedy and
    8 sampled (temperature 0.8, top_k 50, top_p 0.95, seeds 0-7). Request 3,
    greedy, stops at `eos_token`. Returns (traffic, the shared prefix)."""
    rng = np.random.default_rng(77)
    prefix = rng.integers(0, vocab, 1024).tolist()
    shared = [prefix + rng.integers(0, vocab, 512).tolist() for _ in range(12)]
    unique = [rng.integers(0, vocab, n).tolist() for n in (64, 128, 192, 256)]
    prompts = [p for pair in zip(shared[:4], unique) for p in pair] + shared[4:]
    budgets = np.linspace(16, 48, 16).round().astype(int).tolist()
    traffic, seed = [], 0
    for i, prompt in enumerate(prompts):
        sampling = None
        if i % 4 in (1, 2):
            sampling, seed = SamplingParams(0.8, 50, 0.95, seed=seed), seed + 1
        traffic.append(dict(prompt_tokens=prompt, max_new_tokens=budgets[i], sampling=sampling,
                            eos_token=eos_token if i == EOS_REQUEST else None))
    return traffic, prefix


EOS_REQUEST = 3  # the greedy unique prompt of 128 tokens
SHARED_IDS = [0, 2, 4, 6] + list(range(8, 16))  # requests of the 1,024-token prefix
FLAGSHIP_RUNS = (("bf16", False, 1), ("bf16", False, 4), ("int8", True, 4))


def dense_logits(cfg, params, tokens, first: int) -> torch.Tensor:
    """A plain causal forward over one whole sequence, with no cache and no
    pages (the teacher-forced truth, at f32), of either model family
    (`forward_dense`, the tests' oracle): logits at positions first.."""
    forward = mixtral.forward_dense if llama.is_moe_config(cfg) else llama.forward_dense
    return forward(cfg, params, tokens[None])[0, first:]


def teacher_forced_bar(params32, cfg32, traffic, requests, delta: float,
                       truth_params=None) -> dict:
    """Each finished request's prompt plus generated tokens through the f32
    truth in one pass (`truth_params(i)`: request i's f32 weights, default
    params32). A greedy token's truth logit must be within `delta`
    of its row's maximum; a sampled token must lie in the kept set of
    filter_logits of the truth row (its request's temperature, top_k and
    top_p), widened by `delta` in logit units. Readings are the largest
    shortfalls (<= delta passes; negative: inside the set)."""
    worst = dict(greedy=-float("inf"), sampled=-float("inf"))
    counts = dict(greedy=0, sampled=0)
    dev = params32["embed"].device
    for i, (spec, req) in enumerate(zip(traffic, requests)):
        prompt, gen = spec["prompt_tokens"], req.generated
        seq = torch.tensor(prompt + gen, dtype=torch.int32, device=dev)
        weights = params32 if truth_params is None else truth_params(i)
        truth = dense_logits(cfg32, weights, seq, len(prompt) - 1)[: len(gen)]
        tok = torch.tensor(gen, device=dev)[:, None]
        picked = torch.gather(truth, 1, tok)[:, 0]
        sp = spec["sampling"]
        if sp is None:
            kind, short = "greedy", truth.max(dim=-1).values - picked
        else:
            n = len(gen)
            kept = filter_logits(truth, torch.full((n,), sp.temperature, device=dev),
                                 torch.full((n,), sp.top_k, device=dev, dtype=torch.int32),
                                 torch.full((n,), sp.top_p, device=dev))
            min_kept = torch.where(torch.isfinite(kept), kept, float("inf")).amin(dim=-1)
            kind, short = "sampled", (min_kept - picked / sp.temperature) * sp.temperature
        worst[kind] = max(worst[kind], float(short.max()))
        counts[kind] += len(gen)
    ok = max(worst.values()) <= delta
    return dict(ok=ok, delta=delta, worst=worst, tokens_checked=counts)


def flagship_run(params, cfg, int8: bool, decode_steps: int, eos_token, model: str,
                 scheduler=Scheduler):
    """One phase 7b run on a fresh pod: (result of run_scheduler, traffic,
    prefix, indexer, pod, counted layer passes, launches)."""
    index = InMemoryIndex()
    indexer = Indexer(TokenProcessorConfig(block_size=PAGE), kv_block_index=index)
    pod_id = "pod-sched-" + ("int8" if int8 else "bf16")
    pod = EnginePod(
        EnginePodConfig(pod_id=pod_id, model_name=model, n_pages=8192 if int8 else 4096,
                        page_size=PAGE, device_tier="gpu", max_pages_per_seq=256,
                        model_config=cfg, device=params["embed"].device,
                        use_quantized_kv=int8),
        event_sink=lambda b: digest_batch(index, indexer.token_processor, pod_id, model, b),
        params=params,
    )
    traffic, prefix = flagship_traffic(cfg.vocab_size, eos_token)
    reset_launch_counts()
    with CallCounter() as counter:
        r = run_scheduler(pod, traffic, decode_steps, max_batch=8, budget=512,
                          scheduler=scheduler)
    return r, traffic, prefix, indexer, pod, counter, launch_counts()


def flagship_scheduler_check(params, cfg, params32, cfg32, int8: bool, decode_steps: int,
                             delta: float) -> dict:
    """Phase 7b on one pod: a probe run finds a token the EOS request
    reaches (the first after its third that it has not emitted before; the
    pods are deterministic), then the recorded run with that EOS on a fresh
    pod, its checks and the teacher-forced bar."""
    tag = f"{'int8' if int8 else 'bf16'} pages, decode_steps {decode_steps}"
    model = "llama-flagship-1.14b"
    probe = flagship_run(params, cfg, int8, decode_steps, None, model)
    out = probe[0]["tokens"][EOS_REQUEST]
    eos = next((t for j, t in enumerate(out) if j >= 3 and t not in out[:j]), None)
    del probe
    if eos is None:
        raise AssertionError(f"phase 7b ({tag}): no new token after the third in {out}")
    torch.cuda.empty_cache()
    r, traffic, prefix, indexer, pod, counter, launches = flagship_run(
        params, cfg, int8, decode_steps, eos, model)
    failures = []
    gen = r["tokens"]
    eos_out = gen[EOS_REQUEST]
    if not (eos_out[-1] == eos and eos not in eos_out[:-1]
            and len(eos_out) < traffic[EOS_REQUEST]["max_new_tokens"]):
        failures.append(f"request {EOS_REQUEST} did not stop at its EOS {eos}: {eos_out}")
    for i, (spec, out) in enumerate(zip(traffic, gen)):
        if i != EOS_REQUEST and len(out) != spec["max_new_tokens"]:
            failures.append(f"request {i}: {len(out)} tokens, asked {spec['max_new_tokens']}")
        if not all(0 <= t < cfg.vocab_size for t in out):
            failures.append(f"request {i}: token out of vocabulary")
    cached = [r["requests"][i].num_cached_tokens for i in SHARED_IDS]
    if cached[0] != 0 or any(c != 1024 for c in cached[1:]):
        failures.append(f"prefix group cached tokens {cached}")
    probe_prompt = prefix + np.random.default_rng(5).integers(0, cfg.vocab_size, 256).tolist()
    scores = indexer.get_pod_scores(probe_prompt, model, [])
    if scores.get(pod.config.pod_id) != 1024 // PAGE:
        failures.append(f"index scores for the prefix: {scores}")
    passes = counter.layer_passes()
    row = "paged_decode_int8" if int8 else "paged_decode"
    want = {name: 0 for name in KERNELS}
    want[row] = cfg.n_layers * passes["decode"]
    want["flash_prefill"] = cfg.n_layers * passes["prefill"]
    if launches != want or not passes["decode"] or not passes["prefill"]:
        failures.append(f"launches {launches}, expected {want} from {counter.passes}")
    bar = teacher_forced_bar(params32, cfg32, traffic, r["requests"], delta)
    if not bar["ok"]:
        failures.append(f"teacher-forced bar: {bar}")

    ticks_ms = [t * 1e3 for t in r["tick_s"]]
    n_tokens = sum(len(g) for g in gen)
    card = card_line()
    log(f"  {tag} ({card}): {len(ticks_ms)} ticks, {n_tokens} tokens in {r['wall_s']:.3f} s "
        f"({n_tokens / r['wall_s']:.1f} tokens/s); tick wall ms min/median/max "
        f"{min(ticks_ms):.2f}/{statistics.median(ticks_ms):.2f}/{max(ticks_ms):.2f}")
    log(f"    tick wall ms: {' '.join(f'{t:.1f}' for t in ticks_ms)}")
    log(f"    submit to first token, ms: "
        f"{' '.join(f'{t * 1e3:.1f}' for t in r['first_token_s'])}")
    log(f"    EOS {eos} stopped request {EOS_REQUEST} after {len(eos_out)} tokens; prefix group "
        f"cached tokens {cached}; index score for the prefix {scores}; preemptions "
        f"{r['preemptions']}")
    log(f"    layer passes {passes}; launches {{{row}: {launches[row]}, flash_prefill: "
        f"{launches['flash_prefill']}}} (16 per pass)")
    log(f"    teacher-forced bar: greedy worst {bar['worst']['greedy']:.4f}, sampled worst "
        f"{bar['worst']['sampled']:.4f} (delta {delta:.4f}; {bar['tokens_checked']} tokens) "
        f"{'ok' if bar['ok'] else 'FAIL'}")
    out = dict(ok=not failures, failures=failures, card=card, ticks=len(ticks_ms),
               tick_ms=ticks_ms, tokens=n_tokens, wall_s=r["wall_s"],
               tokens_per_s=n_tokens / r["wall_s"],
               first_token_ms=[t * 1e3 for t in r["first_token_s"]], launches=launches,
               layer_passes=passes, bar=bar, eos=eos, cached=cached)
    if not failures:
        name, args, kwargs = counter.decode_call
        out["tick_profile"] = profile_device_share(
            f"decode tick of the scheduler ({tag}, batch {args[3].shape[0]}, sampled rows)",
            decode_tick(name, args, kwargs, traffic))
    del pod
    torch.cuda.empty_cache()
    return out


def decode_tick(name, args, kwargs, traffic):
    """The device work of one scheduler decode tick, replayed from a recorded
    decode call (the same rows rewritten at the same positions): the model
    step, token selection with the sampling arrays of the first requests of
    `traffic`, and the read back."""
    if name == "decode_multi_step_cache":
        return lambda: getattr(llama, name)(*args, **kwargs)[1].tolist()
    b = args[3].shape[0]
    sps = [t["sampling"] or SamplingParams() for t in traffic[:b]]
    temps = torch.tensor([sp.temperature for sp in sps], device="cuda")
    top_ks = torch.tensor([sp.top_k for sp in sps], dtype=torch.int32, device="cuda")
    top_ps = torch.tensor([sp.top_p for sp in sps], device="cuda")
    keys = torch.stack([prng_key(sp.seed or 0) for sp in sps])

    def tick():
        _, logits = llama.decode_step_cache(*args, **kwargs)
        return sample_tokens(logits, temps, top_ks, top_ps, position_keys(keys, args[5])).tolist()
    return tick


def teacher_forced_delta(params, cfg, params32, cfg32, int8: bool) -> tuple:
    """(delta, e): e is the bf16 plain path's largest logit error against
    the f32 truth on this page format, read on four of phase 7b's sequences
    (prompt plus 32 tokens, prefilled from position 0 through
    `prefill_cache(plain=True)` on a fresh cache, last position); delta =
    2 x (2e + 1e-2), twice phase 6's bar, since a served token's logit and
    its row's maximum may each sit that far from the truth."""
    traffic, _ = flagship_traffic(cfg.vocab_size)
    rng = np.random.default_rng(9)
    e, dev = 0.0, params["embed"].device
    make = llama.make_kv_pages_quantized if int8 else llama.make_kv_pages
    for i in (0, 1, 3, 8):
        seq = traffic[i]["prompt_tokens"] + rng.integers(0, cfg.vocab_size, 32).tolist()
        tokens = torch.tensor(seq, dtype=torch.int32, device=dev)
        n_pages = -(-len(seq) // PAGE)
        cache = make(cfg, n_pages, PAGE, dev)
        table = torch.arange(n_pages, dtype=torch.int32, device=dev)
        _, got = llama.prefill_cache(cfg, params, cache, tokens, table, 0, plain=True)
        truth = dense_logits(cfg32, params32, tokens, len(seq) - 1)[0]
        e = max(e, float((got.float() - truth).abs().max()))
        del cache
    return 2 * (2 * e + 1e-2), e


def phase_scheduler_flagship(params, cfg) -> dict:
    log("== phase 7b: the flagship through the scheduler (16 requests at once, 12 sharing a "
        "1,024-token prefix; 8 greedy, 8 sampled; max_batch 8, prefill budget 512)")
    params32, cfg32 = f32_twin(params, cfg)
    tf = dense_logits(cfg32, params32, torch.arange(300, device="cuda", dtype=torch.int32), 299)
    cache = llama.make_kv_pages(cfg32, 19, PAGE, "cuda")
    _, pc = llama.prefill_cache(cfg32, params32, cache, torch.arange(300, device="cuda",
                                dtype=torch.int32), torch.arange(19, dtype=torch.int32,
                                device="cuda"), 0, plain=True)
    truth_err = float((tf[0] - pc).abs().max())
    log(f"  the truth's dense forward vs prefill_cache(plain=True), f32, 300 tokens: "
        f"max_abs_err={truth_err:.3e} (tol 1e-3)")
    del cache
    if truth_err > 1e-3:
        raise AssertionError("the teacher-forced truth disagrees with the plain prefill path")
    out = {}
    for fmt, int8, steps in FLAGSHIP_RUNS:
        if fmt not in out:
            delta, e = teacher_forced_delta(params, cfg, params32, cfg32, int8)
            log(f"  {fmt} pages: bf16 plain path vs f32 truth {e:.4f}; delta {delta:.4f}")
            out[fmt] = dict(plain_err=e, delta=delta)
        r = flagship_scheduler_check(params, cfg, params32, cfg32, int8, steps,
                                     out[fmt]["delta"])
        out[f"{fmt} steps{steps}"] = r
        if not r["ok"]:
            raise AssertionError(f"phase 7b ({fmt}, decode_steps {steps}): {r['failures']}")
    del params32
    torch.cuda.empty_cache()
    return out


# -- phase 8: the host tier -------------------------------------------------------

# Phase 8a's sequences, after the reference package's host-tier tests, at
# page 16 on the small f32 model: (name, pod options, steps). A step is
# (prompt, greedy tokens after the first, free the sequence after).
def tier_sequences() -> list:
    a, b = list(range(64)), [300 + i for i in range(128)]
    return [
        ("offload_on_reclaim", dict(n_pages=4), [(a, 0, True), (b[:32], 0, True)]),
        ("host_capacity_bound", dict(n_pages=4, host_capacity_blocks=2),
         [(a, 0, True), (b[:64], 0, True)]),
        ("restore_on_miss", dict(n_pages=6),
         [(a + [50, 51], 0, True), (b[:80], 0, True), (a + [50, 51], 5, True)]),
    ]


def tier_pod(device, int8, pod_id="pod-t", sink=None, **over):
    params, cfg = small_model(device)
    opts = dict(n_pages=8, page_size=PAGE, device_tier="gpu", max_pages_per_seq=8,
                model_config=cfg, device=device, use_quantized_kv=int8,
                enable_host_tier=True, transfer_cost_model=ALWAYS_TRANSFER)
    opts.update(over)
    return EnginePod(EnginePodConfig(pod_id=pod_id, model_name="m", **opts),
                     event_sink=sink, params=params)


def serve_steps(pod, steps) -> list:
    out = []
    for prompt, n_decode, free in steps:
        state, cached = pod.prefill(prompt)
        tokens = [int(torch.argmax(pod.last_logits))]
        if n_decode:
            pod.decode_append(state, tokens[0])
            tokens += [pod.decode_step(state) for _ in range(n_decode)]
        if free:
            pod.free(state)
        out.append((cached, tokens))
    return out


def tier_run(device: str, int8: bool) -> dict:
    """Phase 8a's sequences on `device`: per sequence the tokens, the event
    stream (media included) and the tier store's stats."""
    runs = {}
    for name, opts, steps in tier_sequences():
        events = []
        pod = tier_pod(device, int8, sink=events.append, **opts)
        try:
            runs[name] = (serve_steps(pod, steps), event_rows(events),
                          dict(pod.tier_store.stats))
        finally:
            pod.close()

    # Eager staging: free() snapshots A's pages, B overwrites them before
    # the background admit, and the host store still gets A's bytes.
    events = []
    pod = tier_pod(device, int8, sink=events.append, eager_stage=True)
    try:
        prompt_a, prompt_b = list(range(64)), [200 + i for i in range(128)]
        state, _ = pod.prefill(prompt_a)
        blocks = list(pod.block_manager.committed_blocks(state))
        truth = pod.tier_store.codec.extract_many([blk[3] for blk in blocks])
        pod.free(state)
        extracts = []
        real = pod.tier_store.codec.extract_many
        pod.tier_store.codec.extract_many = lambda ids: extracts.append(len(ids)) or real(ids)
        state_b, _ = pod.prefill(prompt_b)
        pod.tier_store.codec.extract_many = real
        pod.tier_store.drain_async_stages()
        staged = [pod.connector.fetch_staged(blk[0], len(t)) for blk, t in zip(blocks, truth)]
        pod.free(state_b)
        pod.tier_store.drain_async_stages()
        runs["eager_stage"] = ((extracts, staged == truth, len(blocks)), event_rows(events),
                               dict(pod.tier_store.stats))
    finally:
        pod.close()

    # Two pods: A exports a prompt, B onboards it through the index.
    index = InMemoryIndex()
    tp = ChunkedTokenDatabase(TokenProcessorConfig(block_size=PAGE))
    events = {"pod-a": [], "pod-b": []}

    def sink(pid):
        def f(batch):
            events[pid].append(batch)
            digest_batch(index, tp, pid, "m", batch)
        return f

    pod_a = tier_pod(device, int8, "pod-a", sink("pod-a"), n_pages=16)
    pod_b = tier_pod(device, int8, "pod-b", sink("pod-b"), n_pages=16)
    try:
        prompt = list(range(7, 83))  # 4 full pages and a partial one
        state, _ = pod_a.prefill(prompt)
        exported = pod_a.export_sequence(state)
        pod_b.set_peer_resolver(IndexBackedPeerResolver(
            index, "m", {"pod-a": pod_a.transfer_address}, "pod-b"))
        served = serve_steps(pod_b, [(prompt, 4, True)])
        keys = tp.tokens_to_kv_block_keys(None, prompt, "m")
        hits = index.lookup(keys, set())
        indexed = all(PodEntry("pod-b", "gpu") in hits.get(k, []) for k in keys)
        runs["two_pod_onboard"] = ((exported, served, indexed),
                                   event_rows(events["pod-a"] + events["pod-b"]),
                                   dict(pod_b.tier_store.stats))
    finally:
        pod_a.close()
        pod_b.close()
    return runs


def phase_host_tier_small() -> dict:
    log("== phase 8a: the host tier, small f32 pods on the card vs the CPU (offload on "
        "reclaim, host capacity, restore on a miss, eager staging, two-pod onboard)")
    out = {}
    for int8 in (False, True):
        fmt = "int8" if int8 else "f32"
        gpu, cpu = tier_run("cuda", int8), tier_run("cpu", int8)
        for name in gpu:
            same = gpu[name] == cpu[name]
            log(f"  {fmt} pages, {name}: tokens/results {gpu[name][0]}; "
                f"{len(gpu[name][1])} events; stats {gpu[name][2]}; card == CPU: {same}")
            if not same:
                raise AssertionError(f"phase 8a ({fmt}, {name}): the card disagrees with the CPU")
        eager, onboard = gpu["eager_stage"][0], gpu["two_pod_onboard"][0]
        checks = dict(
            offloads=gpu["offload_on_reclaim"][2]["offloads"] == 2,
            host_evictions=gpu["host_capacity_bound"][2]["host_evictions"] == 2,
            restores=gpu["restore_on_miss"][0][2][0] == 64
            and gpu["restore_on_miss"][2]["restores"] >= 4,
            eager=eager[0] == [] and eager[1] and eager[2] == 4,
            onboard=onboard[0] == 4 and onboard[1][0][0] == 64 and onboard[2]
            and gpu["two_pod_onboard"][2]["onboards"] == 4,
        )
        if not all(checks.values()):
            raise AssertionError(f"phase 8a ({fmt}): {checks}")
        out[fmt] = {name: r[2] for name, r in gpu.items()}
    return out


# Phase 8b-8d: the flagship through the host tier. P is a 1,024-token prefix
# and 512 unique tokens; P' the same prefix and 512 other tokens.
PREFIX_TOKENS, SUFFIX_TOKENS, HOST_TIER_DECODE = 1024, 512, 32
# The tight pod's pool: the 128 pages of a 1,536-token prompt's 2,048-token
# prefill bucket, and 4 more. An unrelated 1,536-token request (128 pages
# with its bucket) then leaves 4 pages besides the ones it takes, so it
# reclaims every page of P's prefix.
TIGHT_PAGES = 132
TTFT_REPS = 3


def ttft_serve(pod, tokens, n_decode=0, keep=False) -> dict:
    """Prefill `tokens` and read the first token back (the time to first
    token), then `n_decode` - 1 greedy decode steps: cached tokens, the
    prefill logits, the tokens, the time."""
    sync()
    t0 = time.perf_counter()
    state, cached = pod.prefill(tokens)
    first = int(torch.argmax(pod.last_logits))
    ttft = time.perf_counter() - t0
    logits = pod.last_logits.clone()
    out = [first]
    if n_decode:
        pod.decode_append(state, first)
        out += [pod.decode_step(state) for _ in range(n_decode - 1)]
    if not keep:
        pod.free(state)
    if not torch.isfinite(logits.float()).all():
        raise AssertionError("non-finite prefill logits")
    return dict(state=state, cached=cached, logits=logits, tokens=out, ttft=ttft)


def sync() -> None:
    """Wait for the card (a no-op where there is none: a CPU rehearsal)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def median_s(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def host_tier_restore_check(params, cfg, int8: bool, reps: int = 1) -> dict:
    """Phase 8b (8d on int8 pages) and 8c: P on a reference pod large
    enough never to evict (which exports P and serves P' from resident
    pages) and on the tight pod; an unrelated request reclaims P's prefix on
    the tight pod, whose P' restores it from the host store; a fresh pod C
    onboards it from the reference pod through the index. P' on either must
    be bit-identical to the reference (suffix logits and 32 greedy tokens).
    With reps > 1, P' is served again with other suffixes (the prefix is
    evicted again on the tight pod) for the times to first token."""
    fmt = "int8" if int8 else "bf16"
    model = "llama-flagship-1.14b"
    vocab = cfg.vocab_size
    rng = np.random.default_rng(88)
    prefix = rng.integers(0, vocab, PREFIX_TOKENS).tolist()
    prompt_p = prefix + rng.integers(0, vocab, SUFFIX_TOKENS).tolist()
    primes = [prefix + rng.integers(0, vocab, SUFFIX_TOKENS).tolist() for _ in range(reps)]
    others = [rng.integers(0, vocab, PREFIX_TOKENS + SUFFIX_TOKENS).tolist()
              for _ in range(reps)]
    index = InMemoryIndex()
    tp = ChunkedTokenDatabase(TokenProcessorConfig(block_size=PAGE))
    events = {}

    def pod(pid, n_pages, host_tier=True):
        events[pid] = []

        def sink(batch):
            events[pid].append(batch)
            digest_batch(index, tp, pid, model, batch)

        return EnginePod(EnginePodConfig(
            pod_id=pid, model_name=model, n_pages=n_pages, page_size=PAGE, device_tier="gpu",
            max_pages_per_seq=256, model_config=cfg, device=params["embed"].device,
            use_quantized_kv=int8, enable_host_tier=host_tier,
            transfer_cost_model=ALWAYS_TRANSFER),
            event_sink=sink, params=params)

    pods = []
    try:
        ref = pod("pod-a", 4096)
        tight = pod("pod-tight", TIGHT_PAGES)
        pods += [ref, tight]
        p_ref = ttft_serve(ref, prompt_p, HOST_TIER_DECODE, keep=True)
        exported = ref.export_sequence(p_ref["state"])
        ref.free(p_ref["state"])
        ttft_serve(tight, prompt_p, HOST_TIER_DECODE)
        committed_p = (len(prompt_p) + HOST_TIER_DECODE - 1) // PAGE
        ttft_serve(tight, others[0])
        # The unrelated request's 128 pages: the pages P left free, then the
        # oldest of P's committed pages.
        want_offloads = 128 - (TIGHT_PAGES - committed_p)
        offloads = tight.tier_store.stats["offloads"]

        ttfts = {"resident": [], "restore": [], "onboard": [], "recompute": []}
        results = {}
        for k, prime in enumerate(primes):
            n_decode = HOST_TIER_DECODE if k == 0 else 0
            if k:
                ttft_serve(tight, others[k])  # evicts the prefix again
            restores = tight.tier_store.stats["restores"]
            pod_c = pod(f"pod-c{k}", 256)
            pod_c.set_peer_resolver(IndexBackedPeerResolver(
                index, model, {"pod-a": ref.transfer_address}, pod_c.config.pod_id))
            fresh = pod(f"pod-fresh{k}", 256, host_tier=False)
            pods += [pod_c, fresh]
            runs = dict(resident=ttft_serve(ref, prime, n_decode),
                        restore=ttft_serve(tight, prime, n_decode),
                        onboard=ttft_serve(pod_c, prime, n_decode),
                        recompute=ttft_serve(fresh, prime))
            for key, r in runs.items():
                ttfts[key].append(r["ttft"])
            if k == 0:
                results = runs
                results["restores"] = tight.tier_store.stats["restores"] - restores
                results["onboards"] = pod_c.tier_store.stats["onboards"]
                keys = tp.tokens_to_kv_block_keys(None, prefix, model)
                hits = index.lookup(keys, set())
                results["indexed_c"] = sum(
                    PodEntry(pod_c.config.pod_id, "gpu") in hits.get(key, []) for key in keys)
            pod_c.close()
            fresh.close()

        prefix_hashes = [key.chunk_hash for key in tp.tokens_to_kv_block_keys(None, prefix, "")]
        rows = event_rows(events["pod-tight"])
        stored_cpu = {h for r in rows if r[0] == "BlockStored" and r[-1] == "cpu" for h in r[1]}
        removed_gpu = {h for r in rows if r[0] == "BlockRemoved" and r[-1] == "gpu" for h in r[1]}
        res, rst, onb = results["resident"], results["restore"], results["onboard"]
        checks = dict(
            exported=exported == committed_p,
            offloads=offloads == want_offloads,
            restore_cached=rst["cached"] == PREFIX_TOKENS,
            restores=results["restores"] == len(prefix_hashes),
            offloaded_to_cpu=set(prefix_hashes) <= stored_cpu,
            removed_from_gpu=set(prefix_hashes) <= removed_gpu,
            restore_logits_bits=torch.equal(rst["logits"], res["logits"]),
            restore_tokens=rst["tokens"] == res["tokens"],
            onboard_cached=onb["cached"] == PREFIX_TOKENS,
            onboards=results["onboards"] == len(prefix_hashes),
            onboard_logits_bits=torch.equal(onb["logits"], res["logits"]),
            onboard_tokens=onb["tokens"] == res["tokens"],
            indexed_c=results["indexed_c"] == len(prefix_hashes),
            resident_cached=res["cached"] == PREFIX_TOKENS,
        )
        readings = dict(
            restore_max_abs_logit_diff=float((rst["logits"].float() - res["logits"].float())
                                             .abs().max()),
            onboard_max_abs_logit_diff=float((onb["logits"].float() - res["logits"].float())
                                             .abs().max()),
            tokens=res["tokens"], restore_tokens=rst["tokens"], onboard_tokens=onb["tokens"],
            offloads_after_unrelated=offloads, expected_offloads=want_offloads,
            tight_pages=TIGHT_PAGES, tier_stats=dict(tight.tier_store.stats))
        log(f"  {fmt}: tight pod of {TIGHT_PAGES} pages: {offloads} offloads after the "
            f"unrelated request (expected {want_offloads}); P' restored {results['restores']} "
            f"blocks, cached {rst['cached']}; pod C onboarded {results['onboards']}, cached "
            f"{onb['cached']}; logits diff restore {readings['restore_max_abs_logit_diff']}, "
            f"onboard {readings['onboard_max_abs_logit_diff']}; checks {checks}")
        return dict(ok=all(checks.values()), checks=checks, readings=readings,
                    ttft_s=ttfts, ref=ref, pods=pods, prefix_hashes=prefix_hashes)
    except BaseException:
        for p in pods:
            p.close()
        raise


def transfer_rates(ref, scratch, prefix_hashes) -> dict:
    """The codec's gather + device-to-host copy and its host-to-device
    insert at 64 blocks, the loopback host store's and the wire's fetch of
    the same 64 blocks (medians of 5 calls): seconds and bytes/s."""
    codec = ref.tier_store.codec
    n = len(prefix_hashes)
    ids = list(range(n))
    nbytes = n * codec.page_nbytes
    payloads = codec.extract_many(ids)
    items = list(zip(ids, payloads))
    cap = codec.page_nbytes
    peer = ref.connector.port
    sec = dict(
        extract=median_s(lambda: codec.extract_many(ids)),
        insert=median_s(lambda: scratch.tier_store.codec.insert_many(items)),
        store=median_s(lambda: ref.connector.fetch_staged_many(prefix_hashes, cap)),
        wire=median_s(lambda: scratch.connector.onboard_payloads(
            "127.0.0.1", peer, prefix_hashes, cap)),
    )
    if any(p is None for p in ref.connector.fetch_staged_many(prefix_hashes, cap)):
        raise AssertionError("the host store lost a prefix block")
    return dict(blocks=n, payload_bytes_per_block=codec.page_nbytes, seconds=sec,
                bytes_per_s={k: nbytes / v for k, v in sec.items()})


def phase_host_tier_flagship(params, cfg) -> dict:
    log("== phase 8b-8d: the flagship through the host tier (reclaim -> offload -> restore "
        "on a tight pod, a peer onboard through the index; bf16 and int8 pages)")
    out = {}
    launches = dict.fromkeys(("paged_decode", "paged_decode_int8", "flash_prefill"), 0)
    for int8 in (False, True):
        fmt = "int8" if int8 else "bf16"
        reset_launch_counts()
        with CallCounter() as counter:
            r = host_tier_restore_check(params, cfg, int8, reps=TTFT_REPS)
        sync()
        got = launch_counts()
        passes = counter.layer_passes()
        decode_row = "paged_decode_int8" if int8 else "paged_decode"
        want = {"flash_prefill": 16 * passes["prefill"], decode_row: 16 * passes["decode"]}
        for name, n in want.items():
            launches[name] += got[name]
            if got[name] != n or n <= 0:
                raise AssertionError(f"phase 8 ({fmt}): {name} launched {got[name]} times, "
                                     f"16 per layer pass is {n}")
        try:
            if not r["ok"]:
                raise AssertionError(f"phase 8 ({fmt}): {r['checks']} {r['readings']}")
            scratch = next(p for p in r["pods"] if p.config.pod_id == "pod-tight")
            rates = transfer_rates(r["ref"], scratch, r["prefix_hashes"])
        finally:
            for p in r["pods"]:
                p.close()
        ttft_ms = {k: statistics.median(v) * 1e3 for k, v in r["ttft_s"].items()}
        sec = rates["seconds"]
        nbytes = rates["blocks"] * rates["payload_bytes_per_block"]
        measured = dict(
            staged_bytes_per_s=nbytes / (sec["store"] + sec["insert"]),
            peer_bytes_per_s=nbytes / (sec["wire"] + sec["insert"]),
            insert_bytes_per_s=nbytes / sec["insert"],
            compute_flops_per_s=flops_per_token(cfg) * (PREFIX_TOKENS + SUFFIX_TOKENS)
            / statistics.median(r["ttft_s"]["recompute"]),
            source=f"chip_smoke.py phase 8 ({fmt} pages) on {card_line()}")
        gate = TransferCostModel.for_model(cfg, quantized=int8, rates=measured)
        n = len(r["prefix_hashes"])
        verdict = {src: gate.admit_prefix([src] * n, PAGE) for src in (READY, STAGED, PEER)}
        log(f"  {fmt}: {rates['payload_bytes_per_block']} payload bytes per block; 64-block "
            f"seconds {sec}; bytes/s {rates['bytes_per_s']}")
        log(f"  {fmt}: TTFT of P' (median of {TTFT_REPS}, ms): {ttft_ms}; all: "
            f"{ {k: [t * 1e3 for t in v] for k, v in r['ttft_s'].items()} }")
        log(f"  {fmt}: cost model from this run's rates {measured}: blocks of {n} admitted "
            f"{verdict}; layer passes {passes}; launches {got}")
        out[fmt] = dict(checks=r["checks"], readings=r["readings"], ttft_ms=ttft_ms,
                        ttft_s=r["ttft_s"], rates=rates, measured_rates=measured,
                        verdict=verdict, passes=passes, launches=got)
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


# -- phase 9: multi-LoRA -----------------------------------------------------------

SMALL_LORA_IDS = (1, 2)


def small_adapters(device) -> dict:
    """Phase 9a's two rank-8 adapters of the small model, seeded on the CPU
    and moved to `device`: {lora_id: adapter}."""
    cfg = llama.LlamaConfig(**SMALL_MODEL, dtype=torch.float32)
    gen = torch.Generator().manual_seed(91)
    return {lid: to_device(lora.make_test_adapter(cfg, 8, gen, device="cpu"), device)
            for lid in SMALL_LORA_IDS}


def small_lora_traffic(lora_ids) -> list:
    """Phase 7a's six requests, request i under lora_ids[i]."""
    return [dict(req, lora_id=lid) for req, lid in zip(small_traffic(), lora_ids)]


def small_pod(device, int8, params, cfg, n_pages=SMALL_SCHED_PAGES, adapters=None, sink=None):
    return EnginePod(
        EnginePodConfig(n_pages=n_pages, page_size=PAGE, device_tier="gpu", max_pages_per_seq=8,
                        model_config=cfg, device=device, use_quantized_kv=int8),
        event_sink=sink, params=params, lora_adapters=adapters)


def phase_lora_small() -> dict:
    log("== phase 9a: multi-LoRA, small f32 pods on the card vs the CPU (2 adapters of rank 8; "
        "6 requests mixing the base and both adapters, a preempting pool, decode_steps 1 and 4)")
    # Requests 0 and 1 share a two-page prefix under one adapter.
    traffic, out = small_lora_traffic((1, 1, None, 2, None, 2)), {}
    for int8 in (False, True):
        tag = "int8" if int8 else "f32"
        runs = {}
        for device in ("cuda", "cpu"):
            params, cfg = small_model(device)
            adapters = small_adapters(device)
            for steps in (1, 4):
                events = []
                pod = small_pod(device, int8, params, cfg, adapters=adapters, sink=events.append)
                r = run_scheduler(pod, traffic, steps, max_batch=4, budget=3 * PAGE)
                runs[device, steps] = (r["tokens"], event_rows(events), r["preemptions"],
                                       [q.num_cached_tokens for q in r["requests"]])
        for steps in (1, 4):
            gpu, cpu = runs["cuda", steps], runs["cpu", steps]
            log(f"  {tag} pages, decode_steps {steps}: tokens equal to the CPU's: "
                f"{gpu[0] == cpu[0]}; event streams equal: {gpu[1] == cpu[1]} ({len(gpu[1])} "
                f"events); preemptions {gpu[2]} (CPU {cpu[2]}); cached tokens {gpu[3]}")
            if gpu[0] != cpu[0] or gpu[1] != cpu[1] or gpu[3] != cpu[3] or gpu[2] < 1:
                raise AssertionError(f"phase 9a ({tag}, decode_steps {steps}): the card disagrees "
                                     "with the CPU or nothing was preempted")
        if runs["cuda", 1][0] != runs["cuda", 4][0]:
            raise AssertionError(f"phase 9a ({tag}): decode_steps 1 and 4 differ")
        out[tag] = dict(events=len(runs["cuda", 1][1]), preemptions=runs["cuda", 1][2],
                        tokens=runs["cuda", 1][0])
    return out


# Phase 9b: the base and three adapters of rank 16 on wq/wv (alpha 16).
LORA_IDS = (None, 11, 12, 13)
LORA_RANK, LORA_ALPHA = 16, 16.0


def flagship_adapters(cfg) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(90)
    return {lid: lora.make_test_adapter(cfg, LORA_RANK, gen, alpha=LORA_ALPHA, device="cuda")
            for lid in LORA_IDS[1:]}


def lora_traffic(vocab: int, adapters: bool = True) -> tuple:
    """Phase 9b's 12 requests, submitted at once: 1,024 shared + 512 unique
    tokens and 32 new tokens each, request i under LORA_IDS[i % 4] (each id
    3 times; all base with `adapters=False`); 6 sampled as phase 7b's
    (temperature 0.8, top_k 50, top_p 0.95, seed i), every id both greedy
    and sampled. Returns (traffic, the shared prefix)."""
    rng = np.random.default_rng(79)
    prefix = rng.integers(0, vocab, 1024).tolist()
    traffic = []
    for i in range(12):
        sampled = (i % 4 + i // 4) % 2 == 1
        traffic.append(dict(
            prompt_tokens=prefix + rng.integers(0, vocab, 512).tolist(), max_new_tokens=32,
            sampling=SamplingParams(0.8, 50, 0.95, seed=i) if sampled else None,
            lora_id=LORA_IDS[i % 4] if adapters else None))
    return traffic, prefix


def indexed_pod(params, cfg, int8: bool, pod_id: str, model: str, adapters=None, events=None,
                pod_class=EnginePod):
    """A flagship pod (4,096 bf16 or 8,192 int8 pages) whose events a fresh
    index digests (and `events` keeps): (pod, indexer)."""
    index = InMemoryIndex()
    indexer = Indexer(TokenProcessorConfig(block_size=PAGE), kv_block_index=index)

    def sink(batch):
        digest_batch(index, indexer.token_processor, pod_id, model, batch)
        if events is not None:
            events.append(batch)
    pod = pod_class(
        EnginePodConfig(pod_id=pod_id, model_name=model, n_pages=8192 if int8 else 4096,
                        page_size=PAGE, device_tier="gpu", max_pages_per_seq=256,
                        model_config=cfg, device="cuda", use_quantized_kv=int8),
        event_sink=sink, params=params, lora_adapters=adapters)
    return pod, indexer


def adapter_gaps(cfg32, params32, merged, traffic, requests) -> dict:
    """For each adapter, the largest |logit of its merged f32 truth - logit
    of the base truth| over the generated rows of its requests."""
    gaps, dev = {}, params32["embed"].device
    for spec, req in zip(traffic, requests):
        lid = spec["lora_id"]
        if lid is None:
            continue
        prompt = spec["prompt_tokens"]
        seq = torch.tensor(prompt + req.generated, dtype=torch.int32, device=dev)
        diff = (dense_logits(cfg32, merged[lid], seq, len(prompt) - 1)
                - dense_logits(cfg32, params32, seq, len(prompt) - 1))
        gaps[lid] = max(gaps.get(lid, 0.0), float(diff.abs().max()))
    return gaps


def lora_flagship_run(params, cfg, int8: bool, adapters, model: str, pod_class=EnginePod):
    """Phase 9b's traffic on a fresh pod serving `adapters`: (result of
    run_scheduler, traffic, indexer, pod, counted calls, launches)."""
    traffic, _ = lora_traffic(cfg.vocab_size)
    pod, indexer = indexed_pod(params, cfg, int8, f"pod-lora-{'int8' if int8 else 'bf16'}",
                               model, adapters, pod_class=pod_class)
    reset_launch_counts()
    with CallCounter() as counter:
        r = run_scheduler(pod, traffic, 1, max_batch=8, budget=512)
    return r, traffic, indexer, pod, counter, launch_counts()


def lora_truth(merged, params32, traffic):
    """teacher_forced_bar's truth_params: request i's adapter merged into
    the f32 weights, or the base."""
    return lambda i: merged.get(traffic[i]["lora_id"], params32)


def lora_flagship_check(params, cfg, params32, cfg32, adapters, merged, int8: bool,
                        delta: float) -> dict:
    fmt = "int8" if int8 else "bf16"
    model = "llama-flagship-1.14b"
    r, traffic, indexer, pod, counter, launches = lora_flagship_run(params, cfg, int8, adapters,
                                                                    model)
    failures, gen = [], r["tokens"]
    for i, out in enumerate(gen):
        if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
            failures.append(f"request {i}: {len(out)} tokens or one out of vocabulary")
    # Adapter-scoped prefix hits: the first request under each id computes
    # the shared prefix, the later ones under the same id hit it.
    cached = [q.num_cached_tokens for q in r["requests"]]
    if cached != [0] * 4 + [1024] * 8:
        failures.append(f"cached tokens {cached}")
    # The index scores request 1's prompt (adapter 11) by its whole prompt
    # under adapter 11, by the shared prefix under the base and adapter 12,
    # and not at all under an adapter the pod never served.
    probe, pid = traffic[1]["prompt_tokens"], pod.config.pod_id
    scores = {str(lid): indexer.get_pod_scores(probe, model, [], lora_id=lid).get(pid, 0)
              for lid in (11, None, 12, 99)}
    if scores != {"11": 1536 // PAGE, "None": 1024 // PAGE, "12": 1024 // PAGE, "99": 0}:
        failures.append(f"index scores {scores}")
    passes = counter.layer_passes()
    if launches != counter.kernels or not passes["decode"] or not passes["prefill"]:
        failures.append(f"launches {launches}, expected {counter.kernels}")
    bar = teacher_forced_bar(params32, cfg32, traffic, r["requests"], delta,
                             truth_params=lora_truth(merged, params32, traffic))
    if not bar["ok"]:
        failures.append(f"teacher-forced bar: {bar}")
    gaps = adapter_gaps(cfg32, params32, merged, traffic, r["requests"])
    if min(gaps.values()) <= delta:
        failures.append(f"an adapter's truth is within the bar's delta {delta:.4f} of the "
                        f"base's: {gaps} (raise LORA_ALPHA)")
    n_tokens = sum(len(g) for g in gen)
    ticks_ms = [t * 1e3 for t in r["tick_s"]]
    log(f"  {fmt} ({card_line()}): {len(ticks_ms)} ticks, {n_tokens} tokens in "
        f"{r['wall_s']:.3f} s ({n_tokens / r['wall_s']:.1f} tokens/s); tick wall ms median "
        f"{statistics.median(ticks_ms):.2f}; cached {cached}; index scores {scores}")
    log(f"    layer passes {passes}; launches {launches} (expected {counter.kernels})")
    log(f"    teacher-forced bar (each request's adapter merged into the f32 truth): greedy worst "
        f"{bar['worst']['greedy']:.4f}, sampled worst {bar['worst']['sampled']:.4f} (delta "
        f"{delta:.4f}; {bar['tokens_checked']} tokens) {'ok' if bar['ok'] else 'FAIL'}; "
        f"adapter vs base truth, largest |diff|: {gaps}")
    out = dict(ok=not failures, failures=failures, tokens=n_tokens, wall_s=r["wall_s"],
               tokens_per_s=n_tokens / r["wall_s"], ticks=len(ticks_ms), tick_ms=ticks_ms,
               cached=cached, scores=scores, launches=launches, layer_passes=passes, bar=bar,
               adapter_gaps=gaps)
    if not failures:
        name, args, kwargs = counter.decode_call
        out["tick_profile"] = profile_device_share(
            f"decode tick with adapters ({fmt}, batch {args[3].shape[0]}, sampled rows)",
            decode_tick(name, args, kwargs, traffic))
    del pod, counter
    torch.cuda.empty_cache()
    return out


def phase_lora_flagship(params, cfg, deltas) -> dict:
    log("== phase 9b: the flagship with 3 LoRA adapters (rank 16 on wq/wv, alpha 16) through "
        "the scheduler: 12 requests at once, the base and each adapter 3 times, 6 sampled")
    params32, cfg32 = f32_twin(params, cfg)
    adapters = flagship_adapters(cfg)
    merged = {lid: lora.merge_adapter(params32, a) for lid, a in adapters.items()}
    out = {fmt: lora_flagship_check(params, cfg, params32, cfg32, adapters, merged, int8,
                                    deltas[fmt])
           for fmt, int8 in (("bf16", False), ("int8", True))}
    for fmt in ("bf16", "int8"):
        if not out[fmt]["ok"]:
            raise AssertionError(f"phase 9b ({fmt}): {out[fmt]['failures']}")
    # The same traffic on the base model, same pod shape, same call.
    traffic, _ = lora_traffic(cfg.vocab_size, adapters=False)
    pod, _ = indexed_pod(params, cfg, False, "pod-lora-base", "llama-flagship-1.14b")
    r = run_scheduler(pod, traffic, 1, max_batch=8, budget=512)
    n = sum(len(g) for g in r["tokens"])
    out["base_only_bf16"] = dict(tokens=n, wall_s=r["wall_s"], tokens_per_s=n / r["wall_s"])
    log(f"  base-only run of the same traffic (bf16): {n} tokens in {r['wall_s']:.3f} s "
        f"({n / r['wall_s']:.1f} tokens/s) against {out['bf16']['tokens_per_s']:.1f} with "
        "adapters")
    out["launches"] = {name: out["bf16"]["launches"][name] + out["int8"]["launches"][name]
                       for name in KERNELS}
    del pod, params32, merged
    torch.cuda.empty_cache()
    return out


# -- phase 10: speculative decoding -------------------------------------------------


class SpecRecorder(SpeculativeScheduler):
    """A SpeculativeScheduler that keeps each greedy row's rejected proposal
    (request, index into its generated tokens, proposal, the target's
    correction), read from the tick's one read-back (no device work of its
    own), and counts its speculative ticks."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rejections = []
        self.spec_ticks = 0

    def _spec_decode(self):
        running = list(self.inner._running)
        before = {r.req_id: (len(r.state.tokens), len(r.generated)) for r in running}
        seen = []
        real = speculative._read_back

        def capture(parts):
            host = real(parts)
            seen.append((tuple(parts[0].shape), host))
            return host
        speculative._read_back = capture
        try:
            finished = super()._spec_decode()
        finally:
            speculative._read_back = real
        if not running:
            return finished
        self.spec_ticks += 1
        (b_pad, k), host = seen[0]
        props = np.asarray(host[: b_pad * k]).reshape(b_pad, k)
        argm = np.asarray(host[b_pad * k: b_pad * (2 * k + 1)]).reshape(b_pad, k + 1)
        ps = self.pod.config.page_size
        for i, r in enumerate(running):
            if r.sampling is not None and not r.sampling.is_greedy:
                continue
            n_tokens, n_gen = before[r.req_id]
            allowed = max(0, min(self.k, self._stripe_pages * ps - n_tokens,
                                 r.max_new_tokens - n_gen - 1))
            n_accept = len(r.generated) - n_gen - 1
            if n_accept < allowed:
                self.rejections.append((r.req_id, n_gen + n_accept, int(props[i, n_accept]),
                                        int(argm[i, n_accept])))
        return finished


def spec_scheduler(draft_cfg, draft_params, k: int, cls=SpecRecorder):
    """A run_scheduler factory of `cls` (a SpecRecorder) with this draft."""
    return lambda pod, max_batch, prefill_token_budget, decode_steps: cls(
        pod, draft_cfg, draft_params, k=k, max_batch=max_batch,
        prefill_token_budget=prefill_token_budget)


def phase_spec_small() -> dict:
    log("== phase 10a: speculative decoding, small f32 pods on the card vs the CPU "
        "(SpeculativeDecoder greedy and sampled at k 4; SpeculativeScheduler at k 3 over 6 "
        "mixed requests, two on adapters, a preempting pool)")
    traffic = small_lora_traffic((None, None, 1, None, 2, None))
    out = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "f32"
        runs = {}
        for device in ("cuda", "cpu"):
            params, cfg = small_model(device)
            draft_params, draft_cfg = small_model(device, seed=8, n_layers=1)
            events = []
            pod = small_pod(device, int8, params, cfg, n_pages=64, sink=events.append)
            dec = SpeculativeDecoder(pod, draft_cfg, draft_params, k=4)
            prompt = traffic[2]["prompt_tokens"]
            greedy = dec.generate(prompt, 24)
            sampled = dec.generate(prompt, 24, sampling=SamplingParams(1.0, 20, 0.9, seed=5))
            dec_stats = dataclasses.astuple(dec.stats)
            spec_events = []
            spec_pod = small_pod(device, int8, params, cfg, adapters=small_adapters(device),
                                 sink=spec_events.append)
            r = run_scheduler(spec_pod, traffic, 1, max_batch=4, budget=3 * PAGE,
                              scheduler=spec_scheduler(draft_cfg, draft_params, 3))
            runs[device] = dict(
                decoder=(greedy, sampled, dec_stats, event_rows(events)),
                scheduler=(r["tokens"], dataclasses.astuple(r["scheduler"].stats),
                           event_rows(spec_events)),
                preemptions=r["preemptions"])
        gpu, cpu = runs["cuda"], runs["cpu"]
        log(f"  {tag} pages: decoder tokens, stats {gpu['decoder'][2]} and events equal to the "
            f"CPU's: {gpu['decoder'] == cpu['decoder']}; scheduler tokens, stats "
            f"{gpu['scheduler'][1]} and events ({len(gpu['scheduler'][2])}) equal: "
            f"{gpu['scheduler'] == cpu['scheduler']}; preemptions {gpu['preemptions']} "
            f"(CPU {cpu['preemptions']})")
        if gpu != cpu or gpu["preemptions"] < 1:
            raise AssertionError(f"phase 10a ({tag}): the card disagrees with the CPU or "
                                 "nothing was preempted")
        out[tag] = dict(decoder_stats=gpu["decoder"][2], scheduler_stats=gpu["scheduler"][1],
                        preemptions=gpu["preemptions"])
    return out


SPEC_K = 4
# The weak draft: the flagship's family and widths at 2 layers, another seed.
WEAK_DRAFT = dict(FLAGSHIP, n_layers=2)


def weak_draft() -> tuple:
    """(config, params) of the weak draft, seeded init (seed 1) on the card."""
    cfg = llama.LlamaConfig(**WEAK_DRAFT)
    return cfg, llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")


def spec_traffic(vocab: int) -> tuple:
    """Phase 10b's 8 requests, submitted at once: 1,024 shared + 512 unique
    tokens, 32 new tokens each; the odd ones sampled as phase 7b's
    (temperature 0.8, top_k 50, top_p 0.95, seed i). Returns (traffic, the
    shared prefix)."""
    rng = np.random.default_rng(83)
    prefix = rng.integers(0, vocab, 1024).tolist()
    traffic = [dict(prompt_tokens=prefix + rng.integers(0, vocab, 512).tolist(),
                    max_new_tokens=32,
                    sampling=SamplingParams(0.8, 50, 0.95, seed=i) if i % 2 else None)
               for i in range(8)]
    return traffic, prefix


def advertised_blocks(batches, traffic, requests) -> dict:
    """The BlockStored blocks as token prefixes against the full pages of
    every request's accepted sequence (the prompt and every generated token
    but the last, which never gets KV): equal, and nothing removed."""
    prefix_of, stored, removed = {}, set(), 0
    for batch in batches:
        for e in batch.events:
            if isinstance(e, BlockRemoved):
                removed += 1
            if not isinstance(e, BlockStored):
                continue
            prefix = prefix_of.get(e.parent_block_hash, ())
            for j, h in enumerate(e.block_hashes):
                prefix = prefix + tuple(e.token_ids[j * PAGE:(j + 1) * PAGE])
                prefix_of[h] = prefix
                stored.add(prefix)
    expected = set()
    for spec, req in zip(traffic, requests):
        seq = tuple(spec["prompt_tokens"] + req.generated[:-1])
        expected.update(seq[: j * PAGE] for j in range(1, len(seq) // PAGE + 1))
    return dict(ok=stored == expected and removed == 0, stored=len(stored),
                expected=len(expected), unexpected=len(stored - expected),
                missing=len(expected - stored), removed=removed)


def near_ties(params32, cfg32, traffic, requests, rejections, delta: float) -> dict:
    """Each rejected greedy proposal against the f32 truth of its request's
    final sequence: (max - truth logit of the proposal) at the rejected
    position must be <= delta (a near-tie that bf16 rounding decides)."""
    worst, dev = -float("inf"), params32["embed"].device
    by_req = {}
    for req_id, g, proposal, correction in rejections:
        by_req.setdefault(req_id, []).append((g, proposal, correction))
    ids = [r.req_id for r in requests]
    for req_id, rows in by_req.items():
        i = ids.index(req_id)
        prompt, gen = traffic[i]["prompt_tokens"], requests[i].generated
        seq = torch.tensor(prompt + gen, dtype=torch.int32, device=dev)
        truth = dense_logits(cfg32, params32, seq, len(prompt) - 1)
        for g, proposal, correction in rows:
            if gen[g] != correction:
                raise AssertionError(f"request {req_id}: token {g} is {gen[g]}, the recorded "
                                     f"correction {correction}")
            worst = max(worst, float(truth[g].max() - truth[g, proposal]))
    return dict(ok=worst <= delta, rejections=len(rejections), worst=worst, delta=delta)


def spec_flagship_run(params, cfg, int8: bool, draft_cfg, draft_params, cls=SpecRecorder):
    """Phase 10b's traffic through a `cls` scheduler on a fresh pod: (result
    of run_scheduler, traffic, the pod's event batches, pod, counted calls,
    launches, read backs)."""
    traffic, _ = spec_traffic(cfg.vocab_size)
    events = []
    pod, _ = indexed_pod(params, cfg, int8, f"pod-spec-{'int8' if int8 else 'bf16'}", "m",
                         events=events)
    reset_launch_counts()
    read_backs = speculative.read_backs
    with CallCounter() as counter:
        r = run_scheduler(pod, traffic, 1, max_batch=8, budget=512,
                          scheduler=spec_scheduler(draft_cfg, draft_params, SPEC_K, cls))
    return (r, traffic, events, pod, counter, launch_counts(),
            speculative.read_backs - read_backs)


def spec_flagship_check(params, cfg, params32, cfg32, int8: bool, draft: str, draft_cfg,
                        draft_params, delta: float) -> dict:
    fmt = "int8" if int8 else "bf16"
    tag = f"{fmt} pages, {draft} draft"
    r, traffic, events, pod, counter, launches, read_backs = spec_flagship_run(
        params, cfg, int8, draft_cfg, draft_params)
    sched = r["scheduler"]
    failures = []
    for i, out in enumerate(r["tokens"]):
        if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
            failures.append(f"request {i}: {len(out)} tokens or one out of vocabulary")
    bar = teacher_forced_bar(params32, cfg32, traffic, r["requests"], delta)
    if not bar["ok"]:
        failures.append(f"teacher-forced bar: {bar}")
    ties = None
    if draft == "perfect":
        ties = near_ties(params32, cfg32, traffic, r["requests"], sched.rejections, delta)
        if not ties["ok"]:
            failures.append(f"a rejected proposal of the perfect draft is no near-tie: {ties}")
    adv = advertised_blocks(events, traffic, r["requests"])
    if not adv["ok"]:
        failures.append(f"advertised blocks {adv}")
    free = pod.block_manager.num_free_pages
    if free != pod.config.n_pages:
        failures.append(f"{free} of {pod.config.n_pages} pages free at the end")
    if launches != counter.kernels or not counter.kernels["paged_decode"]:
        failures.append(f"launches {launches}, expected {counter.kernels}")
    if read_backs != sched.spec_ticks:
        failures.append(f"{read_backs} read backs in {sched.spec_ticks} speculative ticks")
    n_tokens = sum(len(g) for g in r["tokens"])
    stats = sched.stats
    log(f"  {tag} ({card_line()}): {len(r['tick_s'])} ticks ({sched.spec_ticks} speculative), "
        f"{n_tokens} tokens in {r['wall_s']:.3f} s ({n_tokens / r['wall_s']:.1f} tokens/s); "
        f"acceptance {stats.acceptance_rate:.3f} ({stats.accepted}/{stats.proposed} in "
        f"{stats.rounds} rounds); read backs per speculative tick "
        f"{read_backs / max(sched.spec_ticks, 1):.2f}")
    log(f"    launches {launches} (expected {counter.kernels}; "
        f"{sum(launches.values()) / len(r['tick_s']):.1f} per tick); layer passes "
        f"{counter.passes}; advertised {adv}; pages free {free}")
    log(f"    teacher-forced bar: greedy worst {bar['worst']['greedy']:.4f}, sampled worst "
        f"{bar['worst']['sampled']:.4f} (delta {delta:.4f}) {'ok' if bar['ok'] else 'FAIL'}"
        + ("" if ties is None else f"; rejected greedy proposals {ties['rejections']}, worst "
           f"truth shortfall {ties['worst']:.4f} {'ok' if ties['ok'] else 'FAIL'}"))
    out = dict(ok=not failures, failures=failures, tokens=n_tokens, wall_s=r["wall_s"],
               tokens_per_s=n_tokens / r["wall_s"], ticks=len(r["tick_s"]),
               spec_ticks=sched.spec_ticks, tick_ms=[t * 1e3 for t in r["tick_s"]],
               stats=dataclasses.asdict(stats), acceptance=stats.acceptance_rate,
               read_backs=read_backs, launches=launches, layer_passes=counter.passes,
               bar=bar, near_ties=ties, advertised=adv)
    if not failures:
        verify = counter.first_call.get(("verify_step_cache", (8, SPEC_K + 1)))
        if verify is not None and draft == "perfect":
            out["verify_profile"] = profile_device_share(
                f"verify call ({fmt}, batch 8 x {SPEC_K + 1} positions)",
                lambda: llama.verify_step_cache(*verify[0], **verify[1]))
        step = counter.first_call.get(("decode_step_cache", (8,)))
        if step is not None:
            out["draft_step_profile"] = profile_device_share(
                f"draft step ({draft}, {draft_cfg.n_layers} layers, batch 8)",
                lambda: llama.decode_step_cache(*step[0], **step[1]))
    del pod, counter, sched, r
    torch.cuda.empty_cache()
    return out


def decoder_rejections(hosts, k_of_round) -> list:
    """A greedy SpeculativeDecoder run's rejected proposals from its rounds'
    read-backs ([chunk, argmaxes], chunk = [t0] + proposals): (index into
    the generated tokens, proposal, correction)."""
    out, g = [], 0
    for host, k in zip(hosts, k_of_round):
        n = k + 1
        chunk, argm = host[:n], host[n:]
        n_accept = 0
        while n_accept < k and argm[n_accept] == chunk[1 + n_accept]:
            n_accept += 1
        if n_accept < k:
            out.append((g + 1 + n_accept, chunk[1 + n_accept], argm[n_accept]))
        g += 1 + n_accept
    return out


def spec_decoder_check(params, cfg, params32, cfg32, draft: str, draft_cfg, draft_params,
                       delta: float) -> dict:
    """SpeculativeDecoder on phase 10b's request 0 (greedy) on a bf16 pod."""
    traffic, _ = spec_traffic(cfg.vocab_size)
    events = []
    pod, _ = indexed_pod(params, cfg, False, "pod-spec-decoder", "m", events=events)
    dec = SpeculativeDecoder(pod, draft_cfg, draft_params, k=SPEC_K)
    hosts = []
    real = speculative._read_back

    def capture(parts):
        host = real(parts)
        hosts.append((parts[0].numel() - 1, host))
        return host
    speculative._read_back = capture
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dec.generate(traffic[0]["prompt_tokens"], 32)
        wall = time.perf_counter() - t0
    finally:
        speculative._read_back = real

    class Done:  # the finished request as teacher_forced_bar reads it
        generated = out
        req_id = 0
    bar = teacher_forced_bar(params32, cfg32, traffic[:1], [Done], delta)
    failures = [] if bar["ok"] else [f"teacher-forced bar: {bar}"]
    ties = None
    if draft == "perfect":
        rejected = decoder_rejections([h for _, h in hosts], [k for k, _ in hosts])
        ties = near_ties(params32, cfg32, traffic[:1], [Done],
                         [(0, g, p, c) for g, p, c in rejected], delta)
        if not ties["ok"]:
            failures.append(f"a rejected proposal of the perfect draft is no near-tie: {ties}")
    adv = advertised_blocks(events, traffic[:1], [Done])
    if not adv["ok"]:
        failures.append(f"advertised blocks {adv}")
    if pod.block_manager.num_free_pages != pod.config.n_pages or len(out) != 32:
        failures.append(f"{len(out)} tokens; {pod.block_manager.num_free_pages} pages free")
    stats = dec.stats
    log(f"  SpeculativeDecoder, {draft} draft, bf16: 32 tokens in {wall:.3f} s "
        f"({32 / wall:.1f} tokens/s); acceptance {stats.acceptance_rate:.3f} "
        f"({stats.accepted}/{stats.proposed} in {stats.rounds} rounds, {len(hosts)} read backs); "
        f"bar greedy worst {bar['worst']['greedy']:.4f}"
        + ("" if ties is None else f"; rejections {ties['rejections']}, worst {ties['worst']:.4f}")
        + f" {'ok' if not failures else 'FAIL'}")
    del pod, dec
    torch.cuda.empty_cache()
    return dict(ok=not failures, failures=failures, wall_s=wall, tokens_per_s=32 / wall,
                stats=dataclasses.asdict(stats), read_backs=len(hosts), bar=bar, near_ties=ties,
                advertised=adv)


def phase_spec_flagship(params, cfg, deltas) -> dict:
    log(f"== phase 10b: the flagship through SpeculativeScheduler (k {SPEC_K}, max_batch 8, 8 "
        "requests of 1,024 shared + 512 unique tokens, 32 new, 4 sampled): the target as its "
        "own draft and a 2-layer draft, bf16 and int8 pods; SpeculativeDecoder on one request")
    params32, cfg32 = f32_twin(params, cfg)
    weak_cfg, weak = weak_draft()
    drafts = {"perfect": (cfg, params), "weak": (weak_cfg, weak)}
    out = {}
    traffic, _ = spec_traffic(cfg.vocab_size)
    pod, _ = indexed_pod(params, cfg, False, "pod-plain", "m")
    r = run_scheduler(pod, traffic, 1, max_batch=8, budget=512)
    n = sum(len(g) for g in r["tokens"])
    out["plain_bf16"] = dict(tokens=n, wall_s=r["wall_s"], tokens_per_s=n / r["wall_s"],
                             ticks=len(r["tick_s"]))
    log(f"  plain Scheduler, bf16, the same traffic: {n} tokens in {r['wall_s']:.3f} s "
        f"({n / r['wall_s']:.1f} tokens/s, {len(r['tick_s'])} ticks)")
    del pod, r
    launches = dict.fromkeys(KERNELS, 0)
    for fmt, int8, draft in (("bf16", False, "perfect"), ("bf16", False, "weak"),
                             ("int8", True, "weak")):
        res = spec_flagship_check(params, cfg, params32, cfg32, int8, draft, *drafts[draft],
                                  deltas[fmt])
        out[f"{fmt} {draft}"] = res
        if not res["ok"]:
            raise AssertionError(f"phase 10b ({fmt}, {draft} draft): {res['failures']}")
        launches = {name: launches[name] + res["launches"][name] for name in KERNELS}
    for draft in ("perfect", "weak"):
        res = spec_decoder_check(params, cfg, params32, cfg32, draft, *drafts[draft],
                                 deltas["bf16"])
        out[f"decoder {draft}"] = res
        if not res["ok"]:
            raise AssertionError(f"phase 10b (decoder, {draft} draft): {res['failures']}")
    out["launches"] = launches
    del params32, weak, drafts
    torch.cuda.empty_cache()
    return out


# -- phase 11: the MoE family (Mixtral) ---------------------------------------------

# Mixtral-8x7B-v0.1 at its published widths (the HF config.json of
# mistralai/Mixtral-8x7B-v0.1: hidden 4,096, intermediate 14,336, 32 heads
# over 8 KV heads of 128, 8 experts, top-2, vocab 32,000, rope_theta 1e6,
# rms_norm_eps 1e-5, no sliding window), depth cut from 32 layers to 4: the
# whole model is 46.7 B parameters, 93.4 GB in bf16, more than one card
# holds; 4 layers are 6.07 B (12.1 GB, and 24.3 GB for the f32 truth).
MIXTRAL = dict(vocab_size=32000, d_model=4096, n_layers=4, n_q_heads=32, n_kv_heads=8,
               head_dim=128, d_ff=14336, n_experts=8, top_k=2, rope_theta=1e6, rms_eps=1e-5)
MOE_MODEL = "mixtral-8x7b-4-layers"
# Phase 11a's small f32 MoE model: phase 7a's widths with 4 experts, top-2.
SMALL_MOE = dict(SMALL_MODEL, n_experts=4, top_k=2)


def small_moe(device, seed: int = 7):
    """The small f32 MoE model on `device`, the same seeded weights on every
    device: (params, config)."""
    cfg = mixtral.MixtralConfig(**SMALL_MOE, dtype=torch.float32)
    params = mixtral.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return to_device(params, device), cfg


def small_packed_prefill(pod) -> tuple:
    """Phase 5's packed prefill at the small model's size: 3 jobs of 20-28
    new tokens (two on a cached two-page prefix; lengths close enough that
    the pod packs them, a pad row beside them) in one batched pass: (logits
    [3, vocab] on the host, flash launches)."""
    rng = np.random.default_rng(41)
    vocab = SMALL_MOE["vocab_size"]
    shared = rng.integers(0, vocab, 2 * PAGE).tolist()
    state, _ = pod.prefill(shared)
    pod.free(state)
    prompts = [shared + rng.integers(0, vocab, 20).tolist(), rng.integers(0, vocab, 24).tolist(),
               shared + rng.integers(0, vocab, 28).tolist()]
    jobs = []
    for prompt in prompts:
        state, start = pod.begin_prefill(prompt)
        jobs.append((state, start, len(prompt)))
    before = fp.launches
    logits = torch.stack(pod.prefill_chunk_batch(jobs)).float().cpu()
    n_flash = fp.launches - before
    for state, _, _ in jobs:
        pod.finish_prefill(state)
        pod.free(state)
    return logits, n_flash


def phase_moe_small() -> dict:
    log("== phase 11a: the MoE family, small f32 pods on the card vs the CPU (4 experts, "
        "top-2): the Scheduler over 6 mixed requests with a preempting pool at decode_steps 1 "
        "and 4, packed prefill, a dense 1-layer draft under SpeculativeScheduler")
    traffic, out = small_traffic(), {}
    for int8 in (False, True):
        tag = "int8" if int8 else "f32"
        runs = {}
        for device in ("cuda", "cpu"):
            params, cfg = small_moe(device)
            draft_params, draft_cfg = small_model(device, seed=8, n_layers=1)
            for steps in (1, 4):
                events = []
                pod = small_pod(device, int8, params, cfg, sink=events.append)
                r = run_scheduler(pod, traffic, steps, max_batch=4, budget=3 * PAGE)
                runs[device, steps] = (r["tokens"], event_rows(events), r["preemptions"],
                                       [q.num_cached_tokens for q in r["requests"]])
            events = []
            logits, n_flash = small_packed_prefill(
                small_pod(device, int8, params, cfg, n_pages=64, sink=events.append))
            runs[device, "packed"] = (logits, n_flash, event_rows(events))
            events = []
            r = run_scheduler(small_pod(device, int8, params, cfg, n_pages=64,
                                        sink=events.append),
                              traffic, 1, max_batch=4, budget=3 * PAGE,
                              scheduler=spec_scheduler(draft_cfg, draft_params, 3))
            runs[device, "spec"] = (r["tokens"], dataclasses.astuple(r["scheduler"].stats),
                                    event_rows(events))
        failures = []
        for steps in (1, 4):
            gpu, cpu = runs["cuda", steps], runs["cpu", steps]
            log(f"  {tag} pages, decode_steps {steps}: tokens equal to the CPU's: "
                f"{gpu[0] == cpu[0]}; event streams equal: {gpu[1] == cpu[1]} ({len(gpu[1])} "
                f"events); preemptions {gpu[2]} (CPU {cpu[2]}); cached tokens {gpu[3]}")
            if gpu != cpu or gpu[2] < 1:
                failures.append(f"decode_steps {steps}: the card disagrees with the CPU or "
                                "nothing was preempted")
        if runs["cuda", 1][0] != runs["cuda", 4][0]:
            failures.append("decode_steps 1 and 4 differ")
        (g_logits, g_flash, g_events), (c_logits, _, c_events) = (
            runs["cuda", "packed"], runs["cpu", "packed"])
        packed_err = float((g_logits - c_logits).abs().max())
        log(f"  {tag} pages, packed prefill of 3 jobs: logits vs the CPU's max_abs_diff="
            f"{packed_err:.3e} (tol 1e-3); flash launches {g_flash}; event streams equal: "
            f"{g_events == c_events}")
        if packed_err > 1e-3 or g_events != c_events or g_flash != SMALL_MOE["n_layers"]:
            failures.append(f"packed prefill: max_abs_diff {packed_err}, {g_flash} launches")
        spec_gpu, spec_cpu = runs["cuda", "spec"], runs["cpu", "spec"]
        log(f"  {tag} pages, SpeculativeScheduler (k 3, dense 1-layer draft): tokens, stats "
            f"{spec_gpu[1]} and events ({len(spec_gpu[2])}) equal to the CPU's: "
            f"{spec_gpu == spec_cpu}")
        if spec_gpu != spec_cpu:
            failures.append("speculative scheduler: the card disagrees with the CPU")
        if failures:
            raise AssertionError(f"phase 11a ({tag}): {failures}")
        out[tag] = dict(events=len(runs["cuda", 1][1]), preemptions=runs["cuda", 1][2],
                        packed_max_abs_diff=packed_err, spec_stats=spec_gpu[1])
    return out


class RoutingRecorder:
    """While entered, keeps each MoE layer call's routed expert sets
    ([tokens, top_k], sorted, on the host), read off the same router product
    and top-k the dispatch computes (checks only: one read back a layer)."""

    def __enter__(self):
        self.calls = []
        self._real = mixtral._moe_mlp_dense

        def recorded(config, layer, x):
            logits = (x.reshape(-1, x.shape[-1]) @ layer["router"]).float()
            self.calls.append(mixtral.top_k(logits, config.top_k)[1].sort(-1).values.cpu())
            return self._real(config, layer, x)
        mixtral._moe_mlp_dense = recorded
        return self

    def __exit__(self, *exc):
        mixtral._moe_mlp_dense = self._real

    def flips(self) -> dict:
        """The calls as three runs of one computation (the f32 truth, the
        kernel path, the plain path, the order of phases 5c's and 6's
        checks): the (token, layer) rows whose routed set differs, plain path
        against the truth and kernel path against the plain path."""
        per = len(self.calls) // 3
        truth, kernel, plain = (self.calls[i * per:(i + 1) * per] for i in range(3))

        def count(a, b):
            return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))
        return dict(flips_plain_vs_truth=count(plain, truth),
                    flips_kernel_vs_plain=count(kernel, plain),
                    routed_rows=sum(x.shape[0] for x in truth))


def moe_logits_checks(params, cfg, params32, cfg32) -> dict:
    """Phase 5c's prefill-logits check and phase 6's batch-8 decode-logits
    check of every (page format, decode kernel) pair on the Mixtral model,
    each with its routing flips."""
    out = {}
    with RoutingRecorder() as rec:
        out["prefill"] = dict(prefill_logits_check(params, cfg, params32, cfg32), **rec.flips())
    for int8 in (False, True):
        for pipelined in (True, False):
            with RoutingRecorder() as rec:
                r = batched_decode_check(params, cfg, params32, cfg32, int8, pipelined)
            del r["cache"], r["inputs"]
            out[r["row"]] = dict(r, **rec.flips())
    torch.cuda.empty_cache()
    for name, r in out.items():
        log(f"  {name}: routing flips, plain vs truth {r['flips_plain_vs_truth']}, kernel vs "
            f"plain {r['flips_kernel_vs_plain']} of {r['routed_rows']} (token, layer) rows")
    return out


def moe_traffic(vocab: int, seed: int) -> tuple:
    """Phase 11b's 8 requests, submitted at once: 1,024 shared + 512 unique
    tokens (ids below `vocab`), 32 new each; the odd ones sampled as phase
    7b's (temperature 0.8, top_k 50, top_p 0.95, seed i). Returns (traffic,
    the shared prefix)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 1024).tolist()
    traffic = [dict(prompt_tokens=prefix + rng.integers(0, vocab, 512).tolist(),
                    max_new_tokens=32,
                    sampling=SamplingParams(0.8, 50, 0.95, seed=i) if i % 2 else None)
               for i in range(8)]
    return traffic, prefix


MOE_TRAFFIC_SEEDS = {"bf16": 87, "int8": 89}  # a prefix of its own for each pod


def moe_indexer() -> tuple:
    index = InMemoryIndex()
    return index, Indexer(TokenProcessorConfig(block_size=PAGE), kv_block_index=index)


def moe_run(params, cfg, int8: bool, index_parts=None):
    """Phase 11b's traffic through the Scheduler on a fresh Mixtral pod
    (2,048 pages of 16) whose events `index_parts` (an index and its
    indexer) digest: (result of run_scheduler, traffic, prefix, pod, counted
    calls, launches)."""
    fmt = "int8" if int8 else "bf16"
    pod_id = f"pod-moe-{fmt}"
    index, indexer = index_parts or moe_indexer()
    pod = EnginePod(
        EnginePodConfig(pod_id=pod_id, model_name=MOE_MODEL, n_pages=2048, page_size=PAGE,
                        device_tier="gpu", max_pages_per_seq=256, model_config=cfg,
                        device="cuda", use_quantized_kv=int8),
        event_sink=lambda b: digest_batch(index, indexer.token_processor, pod_id, MOE_MODEL, b),
        params=params)
    traffic, prefix = moe_traffic(cfg.vocab_size, MOE_TRAFFIC_SEEDS[fmt])
    reset_launch_counts()
    with CallCounter() as counter:
        r = run_scheduler(pod, traffic, 1, max_batch=8, budget=512)
    return r, traffic, prefix, pod, counter, launch_counts()


def moe_step_bytes(cfg, batch: int, ctx: int, int8: bool) -> int:
    """Bytes a MoE decode step must move at least: every weight once (at
    batch 8 a layer's 16 picks reach nearly every expert, and the dense
    dispatch reads them all), the batch's embedding rows, and each
    sequence's K/V once."""
    c = cfg
    per_layer = (2 * c.d_model * c.q_dim + 2 * c.d_model * c.kv_dim + 2 * c.d_model
                 + c.d_model * c.n_experts + 3 * c.n_experts * c.d_model * c.d_ff)
    weights = (c.n_layers * per_layer + c.d_model + c.d_model * c.vocab_size) * 2
    kv_row = c.head_dim + 4 if int8 else 2 * c.head_dim
    return weights + batch * c.d_model * 2 + 2 * c.n_layers * batch * ctx * c.n_kv_heads * kv_row


def greedy_agreement(params, cfg, params32, cfg32, traffic, requests, int8: bool) -> dict:
    """How often a greedy token is the f32 truth's argmax at its position:
    the served run's tokens, and on the same sequences the bf16 plain path
    (`prefill_cache(plain=True, all_logits=True)` on a fresh cache of the
    pod's page format). A routing flip moves a bf16 row's logits by a whole
    expert, so the teacher-forced bar's delta, read where flips land, is
    wide; this reads how often the served path strays, against how often the
    plain path does: the served disagreement may be at most twice the plain
    path's plus 0.05 (the form of phases 5c's and 6's bars)."""
    agree = dict(served=0, plain=0, tokens=0)
    dev = params["embed"].device
    make = llama.make_kv_pages_quantized if int8 else llama.make_kv_pages
    for spec, req in zip(traffic, requests):
        if spec["sampling"] is not None:
            continue
        prompt, gen = spec["prompt_tokens"], req.generated
        seq = torch.tensor(prompt + gen, dtype=torch.int32, device=dev)
        rows = slice(len(prompt) - 1, len(prompt) - 1 + len(gen))
        truth = dense_logits(cfg32, params32, seq, 0)[rows].argmax(-1)
        n_pages = -(-len(seq) // PAGE)
        cache = make(cfg, n_pages, PAGE, dev)
        _, plain = llama.prefill_cache(cfg, params, cache, seq,
                                       torch.arange(n_pages, dtype=torch.int32, device=dev), 0,
                                       plain=True, all_logits=True)
        agree["served"] += int((torch.tensor(gen, device=dev) == truth).sum())
        agree["plain"] += int((plain[rows].argmax(-1) == truth).sum())
        agree["tokens"] += len(gen)
        del cache
    n = agree["tokens"]
    d_served, d_plain = 1 - agree["served"] / n, 1 - agree["plain"] / n
    limit = 2 * d_plain + 0.05
    return dict(ok=d_served <= limit, disagree_served=d_served, disagree_plain=d_plain,
                limit=limit, tokens=n)


def moe_check(params, cfg, params32, cfg32, int8: bool, delta: float, index_parts) -> dict:
    """Phase 11b on one pod: the run, its checks, the teacher-forced bar,
    and the profiles of one decode tick and one prefill chunk."""
    fmt = "int8" if int8 else "bf16"
    r, traffic, prefix, pod, counter, launches = moe_run(params, cfg, int8, index_parts)
    failures, gen = [], r["tokens"]
    for i, out in enumerate(gen):
        if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
            failures.append(f"request {i}: {len(out)} tokens or one out of vocabulary")
    cached = [q.num_cached_tokens for q in r["requests"]]
    if cached != [0] + [1024] * 7:
        failures.append(f"cached tokens {cached}")
    passes = counter.layer_passes()
    if launches != counter.kernels or not passes["decode"] or not passes["prefill"]:
        failures.append(f"launches {launches}, expected {counter.kernels}")
    bar = teacher_forced_bar(params32, cfg32, traffic, r["requests"], delta)
    if not bar["ok"]:
        failures.append(f"teacher-forced bar: {bar}")
    agree = greedy_agreement(params, cfg, params32, cfg32, traffic, r["requests"], int8)
    if not agree["ok"]:
        failures.append(f"greedy agreement with the truth: {agree}")
    n_tokens = sum(len(g) for g in gen)
    ticks_ms = [t * 1e3 for t in r["tick_s"]]
    log(f"  {fmt} ({card_line()}): {len(ticks_ms)} ticks, {n_tokens} tokens in "
        f"{r['wall_s']:.3f} s ({n_tokens / r['wall_s']:.1f} tokens/s); tick wall ms "
        f"min/median/max {min(ticks_ms):.2f}/{statistics.median(ticks_ms):.2f}/"
        f"{max(ticks_ms):.2f}")
    log(f"    tick wall ms: {' '.join(f'{t:.1f}' for t in ticks_ms)}")
    log(f"    submit to first token, ms: "
        f"{' '.join(f'{t * 1e3:.1f}' for t in r['first_token_s'])}")
    log(f"    cached {cached}; layer passes {passes}; launches {launches} (expected "
        f"{counter.kernels})")
    log(f"    teacher-forced bar: greedy worst {bar['worst']['greedy']:.4f}, sampled worst "
        f"{bar['worst']['sampled']:.4f} (delta {delta:.4f}; {bar['tokens_checked']} tokens) "
        f"{'ok' if bar['ok'] else 'FAIL'}")
    log(f"    greedy tokens off the truth's argmax: served {agree['disagree_served']:.4f}, plain "
        f"path {agree['disagree_plain']:.4f} (limit {agree['limit']:.4f}; {agree['tokens']} "
        f"tokens) {'ok' if agree['ok'] else 'FAIL'}")
    out = dict(ok=not failures, failures=failures, tokens=n_tokens, wall_s=r["wall_s"],
               tokens_per_s=n_tokens / r["wall_s"], ticks=len(ticks_ms), tick_ms=ticks_ms,
               first_token_ms=[t * 1e3 for t in r["first_token_s"]], cached=cached,
               launches=launches, layer_passes=passes, bar=bar, agreement=agree, prefix=prefix)
    if not failures:
        name, args, kwargs = counter.decode_call
        batch = args[3].shape[0]
        tick = decode_tick(name, args, kwargs, traffic)
        tick()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tick()
        extra_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
        prof = profile_device_share(f"MoE decode tick ({fmt}, batch {batch}, sampled rows)", tick)
        ctx = int(args[5].max()) + 1
        bound = moe_step_bytes(cfg, batch, ctx, int8) / PEAK_BYTES_PER_S * 1e3
        out["tick_profile"] = dict(prof, bound_ms=bound, peak_extra_mb=extra_mb)
        log(f"    decode tick bound {bound:.3f} ms (every weight once, {ctx} positions of K/V); "
            f"allocated above the resident set during a tick: {extra_mb:.1f} MB (one copied "
            f"expert tensor of a layer would be "
            f"{cfg.n_experts * cfg.d_model * cfg.d_ff * 2 / 1e6:.0f} MB)")
        chunk = counter.first_call.get(("prefill_cache", (512,)))
        if chunk is not None:
            out["prefill_profile"] = profile_device_share(
                f"MoE prefill chunk of 512 tokens ({fmt}, start {chunk[0][5]})",
                lambda: llama.prefill_cache(*chunk[0], **chunk[1]))
    del pod, counter
    torch.cuda.empty_cache()
    return out


def mixtral_model() -> tuple:
    """(config, params) of phase 11b's model, seeded init on the card."""
    cfg = mixtral.MixtralConfig(**MIXTRAL)
    return cfg, mixtral.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")


def phase_moe_flagship() -> dict:
    log("== phase 11b: Mixtral-8x7B widths at 4 layers (bf16, seeded weights) through the "
        "Scheduler, bf16 and int8 pages: 8 requests of 1,024 shared + 512 unique tokens, 32 "
        "new, 4 sampled")
    cfg, params = mixtral_model()
    n_params = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "out"))
    log(f"  Mixtral params at {cfg.n_layers} layers: {n_params / 1e9:.3f} B "
        f"({n_params * 2 / 1e9:.2f} GB bf16)")
    params32, cfg32 = f32_twin(params, cfg)
    out = dict(n_params=n_params, logits=moe_logits_checks(params, cfg, params32, cfg32))
    for name, r in out["logits"].items():
        if not r["ok"]:
            raise AssertionError(f"phase 11b ({name} logits) fails its bar: {r}")
    index_parts = moe_indexer()
    for fmt, int8 in (("bf16", False), ("int8", True)):
        delta, e = teacher_forced_delta(params, cfg, params32, cfg32, int8)
        log(f"  {fmt} pages: bf16 plain path vs f32 truth {e:.4f}; delta {delta:.4f}")
        r = moe_check(params, cfg, params32, cfg32, int8, delta, index_parts)
        out[fmt] = dict(r, plain_err=e, delta=delta)
        if not r["ok"]:
            raise AssertionError(f"phase 11b ({fmt}): {r['failures']}")
    # The index ranks each pod first for a prompt on its own prefix.
    scores = {}
    for fmt in ("bf16", "int8"):
        probe = out[fmt].pop("prefix") + np.random.default_rng(5).integers(
            0, cfg.vocab_size, 256).tolist()
        scores[fmt] = index_parts[1].get_pod_scores(probe, MOE_MODEL, [])
        best = max(scores[fmt], key=scores[fmt].get)
        log(f"  index scores for the {fmt} pod's prefix: {scores[fmt]}")
        if best != f"pod-moe-{fmt}" or scores[fmt][best] != 1024 // PAGE:
            raise AssertionError(f"phase 11b: the {fmt} prefix ranks {best} first: {scores}")
    out["scores"] = scores
    out["launches"] = {name: out["bf16"]["launches"][name] + out["int8"]["launches"][name]
                       for name in KERNELS}
    del params, params32
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=None,
                        help="comma-separated phases to run after the build (3 4 5 5b 5c 6 7a "
                        "7b 8a 8 9a 9b 10a 10b 11a 11b; 9b and 10b run 7b's deltas first); a "
                        "partial run prints no kernels or ok line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("== phase 1: device")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device: "
        f"{torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    log(card_line())

    log("== phase 2: build")
    build_s = _build.build((*_build.KERNELS, _build.TRANSFER))
    log(f"  built {_build.KERNELS} and the {_build.TRANSFER} library in {build_s:.2f} s")
    for name in _build.KERNELS:
        text = _build.build_log(name)
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", text))
        log(f"  {name}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers/thread, {spills} bytes of spill stores in all")

    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = llama.LlamaConfig(**FLAGSHIP)
    if args.phases is not None:
        return partial_run(args.phases.split(","), gen, cfg)
    errs = phase_kernel_checks(gen)
    times, decode_times, prefill_serving, verify_time, mixtral_times = phase_times(gen)

    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "out"))
    log(f"flagship params: {n_params / 1e9:.3f} B ({n_params * 2 / 1e9:.2f} GB bf16)")
    serving = phase_serving(params, cfg)
    packed = phase_packed_prefill(params, cfg)
    phase_small_pod_vs_cpu()
    prefill_logits = phase_prefill_logits(params, cfg)
    batched = phase_batched_decode(params, cfg)
    sched_small = phase_scheduler_small()
    sched = phase_scheduler_flagship(params, cfg)
    tier_small = phase_host_tier_small()
    tier = phase_host_tier_flagship(params, cfg)
    deltas = {fmt: sched[fmt]["delta"] for fmt in ("bf16", "int8")}
    lora_small = phase_lora_small()
    lora_flagship = phase_lora_flagship(params, cfg, deltas)
    spec_small = phase_spec_small()
    spec = phase_spec_flagship(params, cfg, deltas)
    del params  # phase 11b holds 36 GB of Mixtral weights and their f32 twin
    torch.cuda.empty_cache()
    moe_small = phase_moe_small()
    moe = phase_moe_flagship()

    # Rows 1, 2 and 5 are counted on the serving path (phase 5), on the
    # scheduler's path (phase 7b's recorded runs, summed), on the host
    # tier's (phase 8b-8d), on multi-LoRA's (phase 9b), on speculative
    # decoding's (phase 10b's scheduler runs) and on the MoE family's
    # (phase 11b's scheduler runs); rows 3 and 4 (the tiled decode entry) on
    # phase 6's and phase 11b's tiled decode steps.
    runs = [sched[f"{fmt} steps{steps}"] for fmt, _, steps in FLAGSHIP_RUNS]
    by_path = {name: {"serving": serving["launches"][name],
                      "scheduler": sum(r["launches"][name] for r in runs),
                      "host_tier": tier["launches"][name],
                      "lora": lora_flagship["launches"][name],
                      "speculative": spec["launches"][name],
                      "moe": moe["launches"][name]}
               for name in ("paged_decode", "paged_decode_int8", "flash_prefill")}
    for row in ("paged_decode_tiled", "paged_decode_tiled_int8"):
        by_path[row] = {"batched_decode": batched["checks"][row]["launches"],
                        "moe_batched_decode": moe["logits"][row]["launches"]}
    kernels = [
        dict(
            name=name, route="cuda",
            source=f"llm_d_kv_cache_manager_tpu_torch/csrc/{SOURCE[name]}.cu",
            replaces=REPLACES[name], launches=next(iter(by_path[name].values())),
            launches_by_path=by_path[name], max_abs_err=errs[name],
            **{k: times[name][k] for k in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        )
        for name in KERNELS
    ]
    log(json.dumps({"decode_shapes": decode_times,
                    "prefill_serving_shape": prefill_serving, "verify_shape": verify_time,
                    "serving": serving, "prefill_logits": prefill_logits,
                    "packed_prefill": packed, "batched_decode": batched,
                    "scheduler_small": sched_small, "scheduler": sched,
                    "host_tier_small": tier_small, "host_tier": tier,
                    "lora_small": lora_small, "lora": lora_flagship,
                    "speculative_small": spec_small, "speculative": spec,
                    "mixtral_attention_shape": mixtral_times, "moe_small": moe_small, "moe": moe,
                    "build_s": build_s, "run_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def partial_run(phases, gen, cfg) -> int:
    """A development run of some phases (no kernels or ok line); exits 0
    when each of them passes."""
    t_start = time.perf_counter()
    out = {}
    if "3" in phases:
        out["kernel_errs"] = phase_kernel_checks(gen)
    if "4" in phases:
        out["times"] = phase_times(gen)
    params = None
    if any(p not in ("3", "4", "5b", "7a", "8a", "9a", "10a", "11a", "11b") for p in phases):
        params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    steps = {
        "5": lambda: phase_serving(params, cfg), "5b": phase_small_pod_vs_cpu,
        "5c": lambda: phase_prefill_logits(params, cfg),
        "6": lambda: phase_batched_decode(params, cfg), "7a": phase_scheduler_small,
        "7b": lambda: phase_scheduler_flagship(params, cfg), "8a": phase_host_tier_small,
        "8": lambda: phase_host_tier_flagship(params, cfg), "9a": phase_lora_small,
        "10a": phase_spec_small, "11a": phase_moe_small,
    }
    for phase in phases:
        if phase in steps:
            out[phase] = steps[phase]()
    if "9b" in phases or "10b" in phases:
        params32, cfg32 = f32_twin(params, cfg)
        deltas = {fmt: teacher_forced_delta(params, cfg, params32, cfg32, int8)[0]
                  for fmt, int8 in (("bf16", False), ("int8", True))}
        del params32
        torch.cuda.empty_cache()
        log(f"  teacher-forced deltas {deltas}")
        if "9b" in phases:
            out["9b"] = phase_lora_flagship(params, cfg, deltas)
        if "10b" in phases:
            out["10b"] = phase_spec_flagship(params, cfg, deltas)
    if "11b" in phases:
        del params
        torch.cuda.empty_cache()
        out["11b"] = phase_moe_flagship()
    log(json.dumps(out, default=str))
    log(f"partial run of phases {phases}: {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
