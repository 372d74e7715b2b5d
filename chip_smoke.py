#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card

Phases, in order (any failure raises and the script exits non-zero):
  1. device lines: torch's device name and nvidia-smi's name + power limit;
  2. build: both kernels from llm_d_kv_cache_manager_tpu_torch/csrc with nvcc
     for sm_90a (build seconds, ptxas register/spill lines);
  3. kernel vs plain: each kernel against its plain torch version in bf16 and
     f32 over edge cases (zero/one-token sequences, page boundaries, windows,
     prefix-hit offsets, padded chunks, per-batch offsets);
  4. times at the main path's shapes (CUDA events, median of 30 runs):
     kernel, plain version, the card's bound, and SDPA as a library yardstick
     that the port itself never calls;
  5. serving: two EnginePods at the flagship width (1.14B Llama, bf16, random
     weights from a seeded generator) whose KV events are digested into one
     index; prefix reuse, pod ranking and kernel launch counts are asserted,
     then a small f32 pod on the card is held against the same pod on the CPU;
  6. batched decode at batch 8 x 2048 context, kernel path vs plain path;
  7. one JSON line describing every kernel;
  8. last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import Indexer
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import InMemoryIndex
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.digest import digest_batch
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import BlockRemoved, BlockStored
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.ops import flash_prefill as fp
from llm_d_kv_cache_manager_tpu_torch.ops import paged_attention as pa

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Kernel-vs-plain bars. f32, elementwise: |kernel - plain| <= 1e-4 +
# 1e-4 |plain| (both sides accumulate in f32, in different orders). bf16, per
# output row (one query head's head_dim vector): |kernel - plain| / |plain| in
# the 2-norm. Both sides round an f32 result to bf16, and the flash kernel
# rounds its unnormalized probabilities where the plain version rounds
# normalized ones, so an elementwise bar would have to scale with each row's
# size rather than with the element's. Each limit is a few times the largest
# row error the kernel showed on an H100 and far below what a kernel that
# skips one 64-token chunk or k-block of keys shows (chip_fault_check.py).
# Rows whose plain output is all zeros (seq_len 0) must be exactly zero.
F32_TOL = (1e-4, 1e-4)
BF16_ROW_REL = {"paged_decode": 4e-3, "flash_prefill": 1.5e-2}

FLAGSHIP = dict(
    vocab_size=32768, d_model=2048, n_layers=16, n_q_heads=16, n_kv_heads=8,
    head_dim=128, d_ff=8192,
)
PAGE = 16
N_Q, N_KV, HD = FLAGSHIP["n_q_heads"], FLAGSHIP["n_kv_heads"], FLAGSHIP["head_dim"]


def log(msg: str) -> None:
    print(msg, flush=True)


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
    for ms, count, key in sorted(rows, reverse=True)[:6]:
        log(f"    {ms:8.3f} ms/call {count:5d} launches/call  {key[:80]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, launches=launches)


def time_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median of `runs` CUDA-event-timed calls, in ms."""
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
                  max_ctx=2048):
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
    return q, k, v, tables, lens


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


# The case of each kernel at the main path's shape (bf16, batch 8 x 2048
# context at page 16; one 2048-token causal chunk).
MAIN_CASES = {
    "paged_decode": "paged_decode bf16 page=16 window=None B=8",
    "flash_prefill": "flash_prefill bf16 L=S=2048 off=0",
}


def kernel_cases(gen):
    """Yields (kernel, dtype, case name, kernel output, plain output) over
    the edge cases, bf16 first, then f32."""
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for page in (16, 64):
            for window in (None, 512):
                for batch, lens in (
                    (1, [2048]),
                    (8, [0, 1, page, page + 1, 2 * page, 1000, 2047, 2048]),
                ):
                    args = decode_inputs(gen, dtype, batch, lens, page)
                    yield ("paged_decode", dtype,
                           f"paged_decode {tag} page={page} window={window} B={batch}",
                           pa.paged_attention(*args, window=window),
                           pa.paged_attention_reference(*args, window=window))
        for n_q in (8, 32, 64):  # the other GQA groups the kernel takes: 1, 4, 8
            args = decode_inputs(gen, dtype, 4, [0, 17, 300, 2048], PAGE, n_q=n_q)
            yield ("paged_decode", dtype, f"paged_decode {tag} group={n_q // N_KV}",
                   pa.paged_attention(*args), pa.paged_attention_reference(*args))
        for n_q in (8, 32):  # flash groups 1 and 4
            q, k, v = flash_inputs(gen, dtype, 1, 300, 700, n_q=n_q)
            yield ("flash_prefill", dtype,
                   f"flash_prefill {tag} group={n_q // N_KV} L=300 S=700 off=400",
                   fp.flash_prefill(q, k, v, 400), fp.dense_attention(q, k, v, 400))
        cases = (
            ("L=S=2048 off=0", 1, 2048, 2048, 0, None, None),
            ("L=512 S=2048 off=1536", 1, 512, 2048, 1536, None, None),
            ("L=8 chunk n_valid=5 S=64 off=40", 1, 8, 64, 40, None, 5),
            ("per-batch offsets", 3, 64, 256, [0, 100, 192], None, None),
            ("L=S=2048 window=512", 1, 2048, 2048, 0, 512, None),
        )
        for name, b, l, s, off, window, n_valid in cases:
            q, k, v = flash_inputs(gen, dtype, b, l, s)
            offs = off if isinstance(off, int) else torch.tensor(off, dtype=torch.int32, device="cuda")
            got = fp.flash_prefill(q, k, v, offs, window=window)
            ref = fp.dense_attention(q, k, v, offs, window=window)
            if n_valid is not None:
                got, ref = got[:, :n_valid], ref[:, :n_valid]
            yield "flash_prefill", dtype, f"flash_prefill {tag} {name}", got, ref


def phase_kernel_checks(gen) -> dict:
    log("== phase 3: kernels vs plain versions")
    errs = {}
    for kernel, dtype, name, got, ref in kernel_cases(gen):
        torch.cuda.synchronize()
        err = check_close(kernel, name, got, ref, dtype)
        if name == MAIN_CASES[kernel]:
            errs[kernel] = err
    return errs


def phase_times(gen) -> dict:
    log("== phase 4: times at the main path's shapes (bf16, median of 30)")
    dtype = torch.bfloat16
    out = {}
    itemsize = 2

    # Decode: batch 8, context 2048, page 16, flagship heads.
    batch, ctx = 8, 2048
    q, k, v, tables, lens = decode_inputs(gen, dtype, batch, [ctx] * batch, PAGE)
    kernel_ms = time_ms(lambda: pa.paged_attention(q, k, v, tables, lens))
    plain_ms = time_ms(lambda: pa.paged_attention_reference(q, k, v, tables, lens))
    # Library yardstick: SDPA over the same K/V already gathered dense.
    kd = k[:, tables.long()].movedim(1, 0).reshape(batch, N_KV, -1, HD).contiguous()
    vd = v[:, tables.long()].movedim(1, 0).reshape(batch, N_KV, -1, HD).contiguous()
    library_ms = time_ms(sdpa_gqa(q[:, :, None], kd, vd))
    live = int(lens.sum())
    nbytes = (2 * live * N_KV * HD + 2 * batch * N_Q * HD) * itemsize + tables.numel() * 4
    flops = 4 * live * N_Q * HD
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    out["paged_decode"] = dict(
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    log(f"  paged_decode B={batch} ctx={ctx} page={PAGE}: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
        f"{out['paged_decode']['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB)")

    # Prefill: one 2048-token causal chunk, offset 0.
    l = s = 2048
    q, k, v = flash_inputs(gen, dtype, 1, l, s)
    kernel_ms = time_ms(lambda: fp.flash_prefill(q, k, v, 0))
    plain_ms = time_ms(lambda: fp.dense_attention(q, k, v, 0))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = time_ms(sdpa_gqa(qt, kt, vt, is_causal=True))
    flops = 4 * causal_pairs(l, s, [0], None) * N_Q * HD
    nbytes = (2 * l * N_Q * HD + 2 * s * N_KV * HD) * itemsize
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    out["flash_prefill"] = dict(
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    log(f"  flash_prefill L=S={l}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA {library_ms:.4f} ms, bound {out['flash_prefill']['bound_ms']:.4f} ms "
        f"({flops / 1e9:.2f} GFLOP)")
    return out


# -- phase 5: serving -------------------------------------------------------------


def phase_serving(params, cfg) -> dict:
    log("== phase 5: serving two flagship pods (bf16, page 16, 4096 pages each)")
    model = "llama-flagship-1.14b"
    index = InMemoryIndex()
    tp_cfg = TokenProcessorConfig(block_size=PAGE)
    indexer = Indexer(tp_cfg, kv_block_index=index)

    def sink_for(pod_id):
        return lambda batch: digest_batch(
            index, indexer.token_processor, pod_id, model, batch
        )

    pods = {
        pid: EnginePod(
            EnginePodConfig(
                pod_id=pid, model_name=model, n_pages=4096, page_size=PAGE,
                device_tier="gpu", max_pages_per_seq=256, model_config=cfg,
                device="cuda",
            ),
            event_sink=sink_for(pid), params=params,
        )
        for pid in ("pod-a", "pod-b")
    }
    rng = np.random.default_rng(1234)
    prefixes = {pid: rng.integers(0, cfg.vocab_size, 1024).tolist() for pid in pods}

    pa.launches = 0
    fp.launches = 0
    ttfts, decode_tokens, decode_s = [], 0, 0.0
    for pid, n_requests in (("pod-a", 4), ("pod-b", 2)):
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
            decode_s += time.perf_counter() - t1
            decode_tokens += len(generated)
            if not all(0 <= t < cfg.vocab_size for t in [first] + generated):
                raise AssertionError(f"{pid} request {r}: token out of vocabulary")
            want = 0 if r == 0 else 1024
            if cached != want:
                raise AssertionError(f"{pid} request {r}: cached {cached}, expected {want}")
            ttfts.append(ttft)
            log(f"  {pid} request {r}: cached {cached} tokens, TTFT {ttft * 1e3:.2f} ms")
            pod.free(state)
    torch.cuda.synchronize()
    launches = {"paged_decode": pa.launches, "flash_prefill": fp.launches}
    log(f"  decode {decode_tokens} tokens at batch 1: {decode_tokens / decode_s:.2f} tokens/s")
    log(f"  kernel launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} kernel was never launched on the main path")

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
    return dict(launches=launches, ttft_ms=[t * 1e3 for t in ttfts],
                decode_tokens_per_s=decode_tokens / decode_s,
                prefill_profile=prefill_profile)


def phase_small_pod_vs_cpu() -> None:
    log("== phase 5b: small f32 pod on the card vs the same pod on the CPU")
    cfg = llama.LlamaConfig(
        vocab_size=512, d_model=256, n_layers=2, n_q_heads=4, n_kv_heads=2,
        head_dim=128, d_ff=512, dtype=torch.float32,
    )
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    runs = {}
    for device in ("cuda", "cpu"):
        events = []
        params = {k: (v.to(device) if torch.is_tensor(v) else
                      {n: w.to(device) for n, w in v.items()})
                  for k, v in params_cpu.items()}
        pod = EnginePod(
            EnginePodConfig(n_pages=8, page_size=PAGE, device_tier="gpu",
                            max_pages_per_seq=8, model_config=cfg, device=device),
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
        stream = [
            (type(e).__name__, list(e.block_hashes),
             getattr(e, "parent_block_hash", None), list(getattr(e, "token_ids", [])), e.medium)
            for batch in events for e in batch.events
            if isinstance(e, (BlockStored, BlockRemoved))
        ]
        runs[device] = (tokens_out, logits, stream)
    gpu, cpu = runs["cuda"], runs["cpu"]
    err = max(float((a - b).abs().max()) for a, b in zip(gpu[1], cpu[1]))
    log(f"  prefill logits max_abs_err={err:.3e} (tol 1e-3); tokens equal: "
        f"{gpu[0] == cpu[0]}; event streams equal: {gpu[2] == cpu[2]} "
        f"({len(gpu[2])} events, {sum(e[0] == 'BlockRemoved' for e in gpu[2])} removals)")
    if err > 1e-3 or gpu[0] != cpu[0] or gpu[2] != cpu[2]:
        raise AssertionError("small pod on the card disagrees with the CPU pod")


def phase_batched_decode(params, cfg, gen) -> dict:
    log("== phase 6: batched decode, batch 8 x context 2048, kernel vs plain path")
    batch, ctx = 8, 2048
    pps = ctx // PAGE + 1
    n_pages = batch * pps + 1
    cache = llama.make_kv_pages(cfg, n_pages, PAGE, "cuda")
    for pool in cache:
        pool.normal_(0.0, 1.0, generator=gen)
    tables = torch.randperm(n_pages, generator=gen, device="cuda")[: batch * pps]
    tables = tables.reshape(batch, pps).to(torch.int32).contiguous()
    lens = torch.full((batch,), ctx - 1, dtype=torch.int32, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (batch,), generator=gen, device="cuda",
                           dtype=torch.int32)
    page_ids = torch.gather(tables, 1, (lens // PAGE).long()[:, None])[:, 0]
    # Truth: the plain path with f32 weights and cache (made before the bf16
    # steps write their new rows).
    cfg32 = llama.LlamaConfig(**{**FLAGSHIP, "dtype": torch.float32})
    params32 = {k: (v.float() if torch.is_tensor(v) else {n: w.float() for n, w in v.items()})
                for k, v in params.items()}
    cache32 = tuple(pool.float() for pool in cache)
    _, truth = llama._decode_once(
        cfg32, params32, cache32, tokens, tables, lens, page_ids, lens % PAGE,
        attend=pa.paged_attention_reference,
    )
    del params32, cache32
    _, logits = llama.decode_step_cache(cfg, params, cache, tokens, tables, lens)
    _, plain = llama._decode_once(
        cfg, params, cache, tokens, tables, lens, page_ids, lens % PAGE,
        attend=pa.paged_attention_reference,
    )
    torch.cuda.synchronize()
    if not torch.isfinite(logits).all() or logits.shape != (batch, cfg.vocab_size):
        raise AssertionError("batched decode logits are not finite or misshapen")
    err = float((logits.float() - plain.float()).abs().max())
    err_kernel = float((logits.float() - truth).abs().max())
    err_plain = float((plain.float() - truth).abs().max())
    agree = int((logits.argmax(-1) == plain.argmax(-1)).sum())
    # bf16 rounding through 16 layers moves both bf16 paths off the f32
    # truth; the kernel path may not stray further than twice the plain
    # path's own bf16 error (plus 1e-2 absolute).
    tol = 2 * err_plain + 1e-2
    log(f"  logits: kernel vs plain max_abs_err={err:.4e}; vs f32 truth: kernel "
        f"{err_kernel:.4e}, plain {err_plain:.4e} (tol {tol:.4e}); max |logit| "
        f"{float(truth.abs().max()):.4f}; argmax agrees on {agree}/{batch}")
    if err_kernel > tol:
        raise AssertionError("batched decode kernel path strays from the f32 truth")
    prof = profile_device_share(
        "decode step, batch 8",
        lambda: llama.decode_step_cache(cfg, params, cache, tokens, tables, lens),
    )
    step_ms = prof["wall_ms"]
    log(f"  decode step (16 layers, batch 8): {step_ms:.3f} ms, "
        f"{batch / step_ms * 1e3:.1f} tokens/s")
    return dict(max_abs_err=err, err_kernel_vs_f32=err_kernel,
                err_plain_vs_f32=err_plain, argmax_agree=agree, step_profile=prof)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 1: device")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device: "
        f"{torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        log(line)

    log("== phase 2: build")
    build_s = _build.build()
    log(f"  built {_build.KERNELS} in {build_s:.2f} s")
    for name in _build.KERNELS:
        text = _build.build_log(name)
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", text))
        log(f"  {name}: {len(regs)} instantiations, max {max(regs, default=0)} "
            f"registers/thread, {spills} bytes of spill stores in all")

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = phase_kernel_checks(gen)
    times = phase_times(gen)

    cfg = llama.LlamaConfig(**FLAGSHIP)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "out"))
    log(f"flagship params: {n_params / 1e9:.3f} B ({n_params * 2 / 1e9:.2f} GB bf16)")
    serving = phase_serving(params, cfg)
    phase_small_pod_vs_cpu()
    batched = phase_batched_decode(params, cfg, gen)

    replaces = {
        "paged_decode": "llm_d_kv_cache_manager_tpu/ops/paged_attention.py:157",
        "flash_prefill": "llm_d_kv_cache_manager_tpu/ops/flash_prefill.py:47",
    }
    kernels = [
        dict(
            name=name, route="cuda",
            source=f"llm_d_kv_cache_manager_tpu_torch/csrc/{name}.cu",
            replaces=replaces[name], launches=serving["launches"][name],
            max_abs_err=errs[name], **times[name],
        )
        for name in _build.KERNELS
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"serving": serving, "batched_decode": batched,
                    "build_s": build_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
