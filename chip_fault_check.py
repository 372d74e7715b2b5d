#!/usr/bin/env python3
"""Planted-fault check of chip_smoke.py's bars, on one CUDA card.

    python3 chip_fault_check.py

Shows that the kernel-vs-plain bars of chip_smoke.py catch a kernel that
drops or leaks work. Each planted fault is built from a mutated copy of its
kernel sources, written only under the package's build/planted/ directory:

  - decode_sm90_stage (both decode sources, every q dtype and page format:
    the body of paged_decode_sm90.cuh): the second stage of every CTA's
    range is skipped;
  - decode_cluster_rank (pipelined decode, every q dtype and page format):
    cluster rank 0's partial is left out of the merge through distributed
    shared memory;
  - decode_combine_split (split-KV decode, both page formats and both
    tiled sources, and the combine alone: paged_decode_combine.cuh): the
    combine pass gives the last split no weight, dropping it;
  - decode_combine_wide_last_block (the same builds): above head dim 256
    the combine's last column block writes zeros, as if it left the last
    slab out. Its main-shape cases (rows 3 and 4 and the combine alone) are
    at phase 21's attention shape (4/2 heads of 512) and its logits bar
    phase 21b's decode-logits check;
  - paged_decode (pipelined decode for f32 q, on f32 and int8 pages: the
    f32 instantiation of paged_decode_sm90.cuh's body): the second stage of
    every CTA's range is skipped;
  - paged_decode_tiled (split-KV decode for f32 q, the same instantiation):
    the second page of every split is dropped (both planted in the body the
    two sources share, for f32 q only, each in its own source's build only;
    decode_sm90_stage, decode_sm90_hd64_cols and decode_sm90_hd100_cols now
    reach f32 q too);
  - flash_prefill: the second live 128-key block of every q-block is skipped
    by the bf16 (wgmma) kernel;
  - flash_prefill_diagonal: the k-block on each q-block's causal diagonal
    takes the unmasked interior path, so rows see future keys;
  - flash_prefill_f32 (the f32 flash kernel up to head dim 256,
    `flash_prefill_f32_kernel`): every key of each q-block's second live
    key block is masked, as if the block were skipped. It must fail the f32
    flash cases and no bf16 case;
  - decode_sm90_hd64_cols (both decode sources for bf16 q, both page
    formats): at head_dim 64 the last lane of each half-warp leaves its 4
    columns out of P @ V, so columns 60-63 of every output row stay 0.
    Its main-shape case is at Qwen2.5-0.5B's attention shape (14/2 heads of
    64) and its logits bar is phase 13b's decode-logits check on that model;
  - decode_sm90_hd100_cols (both decode sources for bf16 q, both page
    formats): at head_dim 100 (run at the padded width 128) columns 96-99
    are left out of P @ V, so the last 4 true columns of every output row
    stay 0;
  - decode_sm90_hd100_rounded_rows (the same builds): at head_dim 100 the
    range a CTA copies and attends is rounded out to whole 4-row (400-byte,
    16-byte aligned) spans at its end and the extra rows are left unmasked,
    so a sequence or a split whose end is no multiple of 4 attends up to 3
    rows past it. Both have their main-shape case at OpenLLaMA-3B's
    attention shape (32/32 heads of 100) and phase 20b's decode-logits
    check (ragged lengths) as their logits bar;
  - flash_prefill_group71_chunk (the bf16 flash kernel): the last chunk of
    a GQA group split over CTAs (group 71 over 64-row tiles: 36 + 35 heads)
    is dropped, so its heads' outputs are never written. Its main-shape case
    is the verify at Falcon-7B's attention shape (71 heads of 64 over one;
    8 rows of 5 tokens take one-warpgroup CTAs, so the group splits; at 128
    rows a CTA it fits whole); it has no logits bar: no model of
    chip_smoke.py has a group above 64, and phase 20b's (group 1) runs one
    chunk a kv head;
  - decode_wide_last_panel (both decode variants of paged_decode_wide.cu's
    Hopper body, bf16 q on both page formats, head dims 257 to 1,024): each
    lane's dot leaves out its last 8-column chunk, the head dim's last panel
    of 256 columns, so every score leaves out that panel's share of q K^T;
  - flash_wide_last_panel (the bf16 flash kernel above head dim 256): the
    cluster's last panel CTA never loads its panel of K (zero-filled), so
    every score leaves out that panel's share of Q K^T. Both have their main-shape case
    at phase 21's attention shape (4/2 heads of 512) and phase 21b's
    logits bars (decode at ragged lengths; the prefix-hit prefill) on its
    model.

Phase 7b's teacher-forced bar (the flagship served through the scheduler on
a bf16 pod, every generated token held against an f32 truth) is held to
the real tree, to the decode_sm90_stage mutant and to a planted scheduler
fault, OffByOneScheduler (every decode row one position early); both
faults must fail it.

Phase 9b's teacher-forced bar (the flagship with three LoRA adapters on a
bf16 pod, every token against the f32 truth of its adapter's merged
weights) is held to the real pod and to a planted fault, AdapterDroppedPod,
whose decode batches gather the base (index 0) for every row; phase 10b's
bar (a bf16 pod through the speculative scheduler with the 2-layer draft)
is held to the real scheduler and to OverAcceptScheduler, which keeps one
proposal more than matched. Both faults must fail their bars.

Phase 11b's checks of the served tokens (Mixtral-8x7B's widths at 4
layers through the scheduler on a bf16 pod: the teacher-forced bar against
the f32 truth held to the served path's expert choice at every (token,
layer), its delta read with the truth held to the plain path's, and the
greedy tokens' agreement with the truth's argmax against the plain bf16
path's) are held to the real MoE dispatch and to a planted MoE fault,
top-1 serving: every token keeps only its first routed expert, at gate 1;
the fault must fail the teacher-forced bar, and fails the agreement check
too (each one's reading is printed).

Phase 14a's index equality (12a's fleet stream, here at 4 pods, through the
EventPool into the native index: the index must hold the plain replay's
(key, pod) pairs) is held to the real native digest and to a planted digest
fault, RemovalBlindDigest, which drops every BlockRemoved of one pod before
the arena applies the batch; phase 14b's prefetch bar (the chosen pod must
fetch exactly the peer-held head of its missing tail, on a load-blend run
of 14b's traffic, batched) is held to the real RoutePrefetcher and to
PrefixPrefetcher, which hands the pod its matched prefix instead of the
missing tail. Both faults must fail their bars.

Phase 15a's resilience bars (the fault plan on four flagship pods with the
plane wired) are held to the real FleetHealthTracker and ResidencyAuditor
and to two planted faults: PassStaleTracker, whose filter_scores detects and
purges but passes stale pods' scores through (it must fail the bar against
scoring and routing to a stale pod), and NoReadmitAuditor, which purges
phantoms but never re-admits a resident block the index missed (it must
fail the bar that every pod's indexed set equals its committed pages after
an audit).

Phase 16's bars are held to the real proactive planes and to three
planted faults: second_best_route, a router that takes the second-best
scored pod (it must fail 16a's bar that each precise request's cached
tokens equal 16 x the top pod's match_blocks); SilentReplicator, whose
tick submits nothing (it must fail 16b's bar that placement lands
replicated blocks); and EtaBlindTable, a session table that never
predicts a next-turn ETA (it must fail 16c's bar that anticipation leaves
more of s0's prefix resident than reactive serving).

Phase 17's bars are held to the real fleet planes and to five planted
faults: WrongOwnerScorer, a ClusterScorer whose merge takes each pod's
score from the replica after its owner (it must fail 17a's bar that the
replicated answer is the Indexer's, over 16a's first 24 requests);
drop_last_entry_encoder, a snapshot encoder that leaves the view's last
entry out (it must fail 17a's warm-restart bar); NeverDemoteTracker, a
region failover tracker that never demotes a silent region (it must fail
17b's detection bar); AdmittingTransport, a FaultyTransport that delivers
damaged blocks with integrity on (it must fail 17c's integrity bar on bf16
pages); and PastCeilingController, an autopilot that steps around a knob's
clamp past its ceiling (it must fail 17d's bounds bar on 15a's faulted
arm).

Phase 18a's bars (the HTTP service routing 16a's precise arm, the whole
trace) are held to the real service and to three planted faults: DroppingPoolService,
a service whose event pool drops every 50th message (it must fail the bar
that every answer equals the Indexer's); SkippingCounter, the lookup
counter skipping every 7th increment (it must fail the /metrics counts the
CPU rehearsal predicts); and every_other_trace, a flight recorder that
drops every other completed trace (it must fail the read-trace count).

Phase 19's bars are held to the real tp pod and train step and to four
planted faults: skip_wo_all_reduce, rank 1 keeping its partial sum after
wo (its collectives fall out of step with rank 0's: it must fail the bar
that a rank that fails or hangs fails the phase, or the logits bars);
rank1_gets_rank0_heads, the KV pages sharded with rank 1 given rank 0's
heads (it must fail the decode-logits bar on the pre-filled cache);
rank1_publishes, rank 1 publishing its events too (it must fail the bar
that rank 1 publishes nothing); rank_bytes_payload, a tp pod's block
payload assembled as the ranks' byte strings end to end instead of their
heads joined inside each layer (it must fail the bar that the tp pod stages
a block it onboarded byte for byte as the tp = 1 pod's payload);
rank1_skips_lora_delta, rank 1 leaving its adapter deltas out of q and v
(it must fail the LoRA leg's logits or teacher-forced bar);
rank1_own_acceptance, rank 1 taking part in the speculative read back's
broadcast but committing its own acceptance, whose sampled draws only rank
0 makes (it must fail the bar that both ranks accept the same tokens); and
drop_one_layer_grad, a train step whose gradients of one layer
(DROPPED_LAYER, inside the flagship's cut depth) are dropped (swapped in as
llama.loss_and_grads: it must fail 19b's gradient bar).

Phase 8b's bit-identical check (P' restored from the host store on a tight
bf16 pod against the same prompt on a pod that never evicts: suffix logits
and 32 greedy tokens) is held to the real tree and to a planted codec fault,
the host tier's insert landing every block one page off (the page after the
one the block manager took for it); the fault must fail it.

The real kernels and each mutant in turn are swapped in behind the wrappers
and run through chip_smoke's kernel cases (bf16 and f32, the same seeded
inputs) of the kernels built from the mutated sources, its batch-8 flagship
decode-logits check of each decode kernel the fault targets, and its
flagship prefill-logits check for the flash faults. Every case's errors are
printed beside its bar, then one JSON summary line. Exits non-zero unless
the real kernels pass every case and every logits bar, and each mutant
fails the main-shape case (batch 8, page 16, no window) and the logits bar
of every kernel it targets. The main-shape case is the bf16 one, except for
the faults planted in f32-only code, which bf16 never reaches: the two in
the f32-q instantiation of the decode body and the f32 flash fault. They
are held to the f32 case of each row they target ("paged_decode f32
page=16 window=None B=8" and its three siblings; "flash_prefill f32 L=S=2048
off=0") and to no logits bar (the flagship logits run in bf16), and must
fail no bf16 case.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import json
import math
import subprocess
import sys

import torch

import chip_smoke
from llm_d_kv_cache_manager_tpu_torch import obs
from llm_d_kv_cache_manager_tpu_torch.api import http_service
from llm_d_kv_cache_manager_tpu_torch.engine import engine as engine_mod
from llm_d_kv_cache_manager_tpu_torch.engine import speculative
from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod
from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler
from llm_d_kv_cache_manager_tpu_torch.antientropy import ResidencyAuditor
from llm_d_kv_cache_manager_tpu_torch.autopilot import AutopilotController
from llm_d_kv_cache_manager_tpu_torch.cluster import ClusterScorer
from llm_d_kv_cache_manager_tpu_torch.cluster import snapshot as snapshot_mod
from llm_d_kv_cache_manager_tpu_torch.federation import RegionFailoverTracker
from llm_d_kv_cache_manager_tpu_torch.fleethealth.tracker import (
    HEALTHY,
    SUSPECT,
    FleetHealthTracker,
)
from llm_d_kv_cache_manager_tpu_torch.kv_connectors.prefetch import RoutePrefetcher
from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import PodScores
from llm_d_kv_cache_manager_tpu_torch.kvevents import pool as pool_mod
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import BlockRemoved, EventBatch
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics_collector
from llm_d_kv_cache_manager_tpu_torch.models import llama, mixtral
from llm_d_kv_cache_manager_tpu_torch.obs import spans as spans_mod
from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.parallel import serving as tp_serving
from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import MeshCoords
from llm_d_kv_cache_manager_tpu_torch.placement import HotPrefixReplicator
from llm_d_kv_cache_manager_tpu_torch.prediction import SessionTable

# Planted fault -> (kernel sources it is built into, file of csrc/ holding
# the line, line, faulty line, the chip_smoke kernels it must fail, the dtype
# of the main-shape case it must fail them in).
MUTANTS = {
    "decode_sm90_stage": (
        ("paged_decode", "paged_decode_tiled"), "paged_decode_sm90.cuh",
        "const int n_valid = min(kStage, pos_end - s_start);",
        "const int n_valid = c == 1 ? 0 : min(kStage, pos_end - s_start);",
        ("paged_decode", "paged_decode_int8", "paged_decode_tiled", "paged_decode_tiled_int8"),
        "bf16",
    ),
    "decode_cluster_rank": (
        ("paged_decode",), "paged_decode.cu",
        "const float* pr = cluster.map_shared_rank(part, r);",
        "if (r == 0 && n_ranks > 1) continue;\n        "
        "const float* pr = cluster.map_shared_rank(part, r);",
        ("paged_decode", "paged_decode_int8"), "bf16",
    ),
    "decode_combine_split": (
        ("paged_decode_tiled", "paged_decode_wide"), "paged_decode_combine.cuh",
        "const float ws = m == -INFINITY ? 0.f : expf(m - m_max);",
        "const float ws = m == -INFINITY || s == n_splits - 1 ? 0.f : expf(m - m_max);",
        ("paged_decode_tiled", "paged_decode_tiled_int8", "paged_decode_combine"), "bf16",
    ),
    "decode_combine_wide_last_block": (
        ("paged_decode_tiled", "paged_decode_wide"), "paged_decode_combine.cuh",
        "const float scale = inv_l[0];  // 1 / L, or 0 for an all-empty row",
        "const float scale = hd > kPanel && blockIdx.z == gridDim.z - 1 ? 0.f : inv_l[0];",
        ("paged_decode_tiled", "paged_decode_tiled_int8", "paged_decode_combine"), "bf16",
    ),
    "paged_decode": (
        ("paged_decode",), "paged_decode_sm90.cuh",
        "const int n_valid = min(kStage, pos_end - s_start);",
        "const int n_valid =\n"
        "          std::is_same<TQ, float>::value && c == 1 ? 0 : min(kStage, pos_end - s_start);",
        ("paged_decode", "paged_decode_int8"), "f32",
    ),
    "paged_decode_tiled": (
        ("paged_decode_tiled",), "paged_decode_sm90.cuh",
        "live[j] = !masked || (t < n_valid && s_start + t >= win_lo);",
        "live[j] = (!masked || (t < n_valid && s_start + t >= win_lo)) &&\n"
        "                    !(std::is_same<TQ, float>::value &&\n"
        "                      (s_start + t) / page_size == pos0 / page_size + 1);",
        ("paged_decode_tiled", "paged_decode_tiled_int8"), "f32",
    ),
    "flash_prefill": (
        ("flash_prefill",), "flash_prefill.cu",
        "const int k0 = j * kBK;",
        "const int k0 = j * kBK;\n    if (j == first_blk + 1) continue;",
        ("flash_prefill",), "bf16",
    ),
    "flash_prefill_f32": (
        ("flash_prefill",), "flash_prefill.cu",
        "const int kw0 = k0 + kh * kKW;",
        "const int kw0 = k0 + kh * kKW + (it == 1 ? 1 << 28 : 0);",
        ("flash_prefill",), "f32",
    ),
    "flash_prefill_diagonal": (
        ("flash_prefill",), "flash_prefill.cu",
        "const bool interior = k0 + kBK - 1 <= hi_all && k0 >= lo_all;",
        "const bool interior = k0 <= hi_all && k0 >= lo_all;",
        ("flash_prefill",), "bf16",
    ),
    "decode_sm90_hd64_cols": (
        ("paged_decode", "paged_decode_tiled"), "paged_decode_sm90.cuh",
        "for (int e = 0; e < kCols; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);",
        "for (int e = 0; e < kCols; ++e) {\n"
        "              if (HD != 64 || hl < 15) acc[g][e] = fmaf(p, v[e], acc[g][e]);\n"
        "            }",
        ("paged_decode", "paged_decode_int8", "paged_decode_tiled", "paged_decode_tiled_int8"),
        "bf16",
    ),
    "decode_sm90_hd100_cols": (
        ("paged_decode", "paged_decode_tiled"), "paged_decode_sm90.cuh",
        "for (int e = 0; e < kCols; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);",
        "for (int e = 0; e < kCols; ++e) {\n"
        "              if (hd != 100 || kCols * hl + e < 96) acc[g][e] = fmaf(p, v[e], acc[g][e]);\n"
        "            }",
        ("paged_decode", "paged_decode_int8", "paged_decode_tiled", "paged_decode_tiled_int8"),
        "bf16",
    ),
    "decode_sm90_hd100_rounded_rows": (
        ("paged_decode", "paged_decode_tiled"), "paged_decode_sm90.cuh",
        "const int n_stages = pos_end > pos0 ? (pos_end - pos0 + kStage - 1) / kStage : 0;",
        "if (hd == 100) pos_end = (pos_end + 3) & ~3;\n"
        "  const int n_stages = pos_end > pos0 ? (pos_end - pos0 + kStage - 1) / kStage : 0;",
        ("paged_decode", "paged_decode_int8", "paged_decode_tiled", "paged_decode_tiled_int8"),
        "bf16",
    ),
    "decode_wide_last_panel": (
        ("paged_decode_wide",), "paged_decode_wide.cu",
        "for (int e = 0; e < kCols; ++e) d = fmaf(q[g][e], k[e], d);",
        "for (int e = 0; e < kCols - 8; ++e) d = fmaf(q[g][e], k[e], d);",
        ("paged_decode", "paged_decode_int8", "paged_decode_tiled", "paged_decode_tiled_int8"),
        "bf16",
    ),
    "flash_wide_last_panel": (
        ("flash_prefill",), "flash_prefill.cu",
        "copy_piece<G>(d, reinterpret_cast<const unsigned char*>(k) + g, ok);",
        "copy_piece<G>(d, reinterpret_cast<const unsigned char*>(k) + g, ok && pan != n_pan - 1);",
        ("flash_prefill",), "bf16",
    ),
    "flash_prefill_group71_chunk": (
        ("flash_prefill",), "flash_prefill.cu",
        "const int head0 = h * group + (blockIdx.x % n_gc) * gc;\n"
        "  const int hc = min(gc, (h + 1) * group - head0);",
        "const int head0 = h * group + (blockIdx.x % n_gc) * gc;\n"
        "  const int hc = n_gc > 1 && blockIdx.x % n_gc == n_gc - 1 ? 0\n"
        "                 : min(gc, (h + 1) * group - head0);",
        ("flash_prefill",), "bf16",
    ),
}


# The kernel faults also held to phase 7b's teacher-forced bar (a bf16 pod
# through the scheduler), beside the planted scheduler fault.
SCHEDULER_BAR_MUTANTS = ("decode_sm90_stage",)
# Faults at a phase 13, 20 or 21 model's attention shape: their main-shape
# case and logits bar are that model's (chip_smoke.QWEN_MAIN_CASES and
# WIDE_MAIN_CASES; phase 13b, phases 20b and 21b at ragged lengths).
MUTANT_MODEL = {"decode_sm90_hd64_cols": "qwen2.5-0.5b",
                "decode_sm90_hd100_cols": chip_smoke.OPENLLAMA_MODEL,
                "decode_sm90_hd100_rounded_rows": chip_smoke.OPENLLAMA_MODEL,
                "decode_wide_last_panel": chip_smoke.WIDE_HEAD_MODEL,
                "decode_combine_wide_last_block": chip_smoke.WIDE_HEAD_MODEL,
                "flash_wide_last_panel": chip_smoke.WIDE_HEAD_MODEL}
# The models whose decode-logits check runs at ragged lengths (phases 20b
# and 21b), by head dim.
RAGGED_HEAD_DIMS = (chip_smoke.OPENLLAMA_SHAPE[2], chip_smoke.WIDE_HEAD_SHAPE[2])
# Faults at a shape no model of chip_smoke.py serves: their main-shape case
# (of each kernel they target) and no logits bar.
MUTANT_SHAPE = {"flash_prefill_group71_chunk": {
    "flash_prefill": "flash_prefill bf16 falcon-7b group=71 verify B=8 L=5 S=2048 per-batch "
                     "offsets"}}
MAIN_CASES = {**chip_smoke.QWEN_MAIN_CASES, **chip_smoke.WIDE_MAIN_CASES}


def main_case(kernel: str, dtype: str, mutant: str = "") -> str:
    """chip_smoke's case of `kernel` at the main path's shape, in `dtype`
    ("bf16" or "f32"): the flagship's, or for a fault of MUTANT_MODEL that
    model's, or of MUTANT_SHAPE its own."""
    if mutant in MUTANT_SHAPE:
        cases = MUTANT_SHAPE[mutant]
    elif mutant in MUTANT_MODEL:
        cases = MAIN_CASES[MUTANT_MODEL[mutant]]
    else:
        cases = chip_smoke.MAIN_CASES
    return cases[kernel].replace(" bf16 ", f" {dtype} ")


def mutant_model(name: str) -> tuple:
    """(params, cfg, params32, cfg32) of a MUTANT_MODEL model."""
    if name == chip_smoke.OPENLLAMA_MODEL:
        cfg, params = chip_smoke.openllama_model()
    elif name == chip_smoke.WIDE_HEAD_MODEL:
        cfg, params = chip_smoke.wide_head_model()
    else:
        cfg, params = chip_smoke.qwen_model(name)
    return (params, cfg, *chip_smoke.f32_twin(params, cfg))


def build_mutants() -> dict:
    """Build each fault of MUTANTS into a copy of each of its kernel sources
    and the headers under build/planted/<name>/ (a shared header's fault
    reaches only these builds), one nvcc per (fault, source), all started
    together: {name: {source: library}}."""
    procs = []
    for name, (sources, target, old, new, _, _) in MUTANTS.items():
        out_dir = _build.BUILD_DIR / "planted" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for path in [*_build.CSRC_DIR.glob("*.cu"), *_build.CSRC_DIR.glob("*.cuh")]:
            text = path.read_text()
            if path.name == target:
                if text.count(old) != 1:
                    raise RuntimeError(f"{target}: the line to mutate is not there once")
                text = text.replace(old, new)
            (out_dir / path.name).write_text(text)
        for source in sources:
            so = out_dir / f"lib{source}_mutant.so"
            procs.append((name, source, so, subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                 str(out_dir / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {name: {} for name in MUTANTS}
    for name, source, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"mutant {name} ({source}) failed to build:\n{log}")
        libs[name][source] = ctypes.CDLL(str(so))
    return libs


def run_cases(label: str, sources=None) -> list:
    """chip_smoke's kernel cases, or only those run by the kernels built from
    `sources`."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kernel, dtype, name, got, ref in chip_smoke.kernel_cases(gen):
        if sources is not None and chip_smoke.kernel_source(kernel, got.shape[-1]) not in sources:
            continue
        torch.cuda.synchronize()
        m = chip_smoke.compare(kernel, got, ref, dtype)
        rows.append(dict(variant=label, kernel=kernel, case=name, **m))
        chip_smoke.log(f"  [{label}] {name}: max_abs_err={m['max_abs_err']:.3e} "
                       f"row_rel_err={m['row_rel_err']:.3e} ({m['bar']}) "
                       f"{'ok' if m['ok'] else 'FAIL'}")
    return rows


def run_decode_logits(label: str, rows, params, cfg, params32, cfg32) -> dict:
    """chip_smoke's batch-8 decode-logits check of each decode kernel in
    `rows` (at phases 20b's and 21b's ragged lengths on their models; the
    combine rides on rows 3 and 4): {row: passed}."""
    out = {}
    for row in (r for r in rows if r in chip_smoke.DECODE_ROWS):
        spec = chip_smoke.DECODE_ROWS[row]
        r = chip_smoke.batched_decode_check(
            params, cfg, params32, cfg32, spec["int8"], spec["pipelined"],
            ragged=cfg.head_dim in RAGGED_HEAD_DIMS)
        out[row] = r["ok"]
        chip_smoke.log(f"  [{label}] batched decode {row}: {'ok' if r['ok'] else 'FAIL'}")
    return out


def run_prefill_logits(label: str, params, cfg, params32, cfg32) -> dict:
    """chip_smoke's flagship prefill-logits check: {"flash_prefill": passed}."""
    ok = chip_smoke.prefill_logits_check(params, cfg, params32, cfg32)["ok"]
    chip_smoke.log(f"  [{label}] prefill logits: {'ok' if ok else 'FAIL'}")
    return {"flash_prefill": ok}


class OffByOneScheduler(Scheduler):
    """A planted scheduler fault: every real row of a decode batch is
    decoded one position early (its KV row overwrites the previous token's,
    and RoPE and the attended length are one short)."""

    def _assemble_batch(self, running):
        tables, tokens, positions = super()._assemble_batch(running)
        positions[: len(running)] -= 1
        return tables, tokens, positions


def run_scheduler_bar(label: str, params, cfg, params32, cfg32, delta: float,
                      scheduler=Scheduler) -> dict:
    """chip_smoke's phase 7b traffic on a bf16 pod at decode_steps 1 (no
    EOS), held to its teacher-forced bar: the bar's reading."""
    r, traffic, *_ = chip_smoke.flagship_run(params, cfg, False, 1, None, "m",
                                             scheduler=scheduler)
    bar = chip_smoke.teacher_forced_bar(params32, cfg32, traffic, r["requests"], delta)
    chip_smoke.log(f"  [{label}] teacher-forced bar: greedy worst {bar['worst']['greedy']:.4f}, "
                   f"sampled worst {bar['worst']['sampled']:.4f} (delta {delta:.4f}) "
                   f"{'ok' if bar['ok'] else 'FAIL'}")
    torch.cuda.empty_cache()
    return bar


class AdapterDroppedPod(EnginePod):
    """A planted LoRA fault: every batched call (decode, packed prefill)
    gathers the base (index 0) for every row, so an adapter applies only in
    a single sequence's prefill."""

    def lora_for_decode(self, lora_ids):
        return super().lora_for_decode([None] * len(lora_ids))


class OverAcceptScheduler(chip_smoke.SpecRecorder):
    """A planted speculation fault: a greedy row keeps one proposal more than
    matched the target's argmax chain (within its allowance)."""

    @staticmethod
    def _greedy_accepted(argmaxes, proposals, allowed: int) -> int:
        n = chip_smoke.SpecRecorder._greedy_accepted(argmaxes, proposals, allowed)
        return min(n + 1, allowed)


def run_lora_bar(label: str, params, cfg, params32, cfg32, delta: float,
                 pod_class=EnginePod) -> dict:
    """chip_smoke's phase 9b traffic on a bf16 pod of `pod_class`, held to
    its teacher-forced bar: the bar's reading."""
    adapters = chip_smoke.flagship_adapters(cfg)
    merged = {lid: chip_smoke.lora.merge_adapter(params32, a) for lid, a in adapters.items()}
    r, traffic, *_ = chip_smoke.lora_flagship_run(params, cfg, False, adapters, "m",
                                                  pod_class=pod_class)
    bar = chip_smoke.teacher_forced_bar(params32, cfg32, traffic, r["requests"], delta,
                                        truth_params=chip_smoke.lora_truth(merged, params32,
                                                                           traffic))
    chip_smoke.log(f"  [{label}] LoRA teacher-forced bar: greedy worst "
                   f"{bar['worst']['greedy']:.4f}, sampled worst {bar['worst']['sampled']:.4f} "
                   f"(delta {delta:.4f}) {'ok' if bar['ok'] else 'FAIL'}")
    del r, merged, adapters
    torch.cuda.empty_cache()
    return bar


def run_spec_bar(label: str, params, cfg, params32, cfg32, delta: float,
                 cls=chip_smoke.SpecRecorder) -> dict:
    """chip_smoke's phase 10b traffic through a `cls` scheduler with the
    2-layer draft on a bf16 pod, held to its teacher-forced bar: the bar's
    reading."""
    draft_cfg, draft_params = chip_smoke.weak_draft()
    r, traffic, *_ = chip_smoke.spec_flagship_run(params, cfg, False, draft_cfg, draft_params,
                                                  cls)
    bar = chip_smoke.teacher_forced_bar(params32, cfg32, traffic, r["requests"], delta)
    chip_smoke.log(f"  [{label}] speculative teacher-forced bar: greedy worst "
                   f"{bar['worst']['greedy']:.4f}, sampled worst {bar['worst']['sampled']:.4f} "
                   f"(delta {delta:.4f}) {'ok' if bar['ok'] else 'FAIL'}")
    del r, draft_params
    torch.cuda.empty_cache()
    return bar


def scatter_one_page_off(cache, page_ids, blocks):
    """A planted codec fault: each block lands in the page after its own
    (wrapping inside the pool, trash page included, so no index leaves it)."""
    real_scatter(cache, (page_ids + 1) % cache[0].shape[2], blocks)


real_scatter = engine_mod._scatter_pages


def run_host_tier_bar(label: str, params, cfg, scatter=None) -> dict:
    """Phase 8b's bit-identical check on bf16 pages, with `scatter` as the
    codec's page scatter: whether P' restored from the host store matched
    the resident reference bit for bit (logits and tokens), and the
    readings."""
    engine_mod._scatter_pages = scatter or real_scatter
    try:
        r = chip_smoke.host_tier_restore_check(params, cfg, False)
    finally:
        engine_mod._scatter_pages = real_scatter
    for pod in r["pods"]:
        pod.close()
    torch.cuda.empty_cache()
    c = r["checks"]
    bits = c["restore_logits_bits"] and c["restore_tokens"]
    diff = r["readings"]["restore_max_abs_logit_diff"]
    chip_smoke.log(f"  [{label}] host-tier restore: logits max |diff| {diff}, tokens equal "
                   f"{c['restore_tokens']}: {'ok' if bits else 'FAIL'} (all checks {r['ok']})")
    return dict(ok=bits, all_checks=r["ok"], max_abs_logit_diff=diff,
                tokens_equal=c["restore_tokens"])


real_moe = mixtral._moe_mlp_dense


def top1_moe(config, layer, x):
    """A planted MoE fault: every token keeps only its first routed expert,
    at gate 1 (softmax over one logit)."""
    return real_moe(dataclasses.replace(config, top_k=1), layer, x)


def run_moe_bar(label: str, params, cfg, params32, cfg32, delta: float, moe=None) -> dict:
    """chip_smoke's phase 11b traffic on a bf16 Mixtral pod serving through
    `moe` as its MoE dispatch (the truth keeps the real one), held to its
    teacher-forced bar: the bar's reading."""
    mixtral._moe_mlp_dense = moe or real_moe
    try:
        r, traffic, *_, routes = chip_smoke.moe_run(params, cfg, False)
    finally:
        mixtral._moe_mlp_dense = real_moe
    bar = chip_smoke.teacher_forced_bar(
        params32, cfg32, traffic, r["requests"], delta,
        truth_routes=chip_smoke.served_routes(routes, traffic, r["requests"], cfg))
    agree = chip_smoke.greedy_agreement(params, cfg, params32, cfg32, traffic, r["requests"],
                                        False)
    chip_smoke.log(f"  [{label}] MoE teacher-forced bar: greedy worst "
                   f"{bar['worst']['greedy']:.4f}, sampled worst {bar['worst']['sampled']:.4f} "
                   f"(delta {delta:.4f}) {'ok' if bar['ok'] else 'FAIL'}; greedy tokens off "
                   f"the truth's argmax {agree['disagree_served']:.4f} (plain path "
                   f"{agree['disagree_plain']:.4f}, limit {agree['limit']:.4f}) "
                   f"{'ok' if agree['ok'] else 'FAIL'}")
    del r
    torch.cuda.empty_cache()
    return dict(bar, ok=bar["ok"] and agree["ok"], bar_ok=bar["ok"], agreement=agree)


real_native_digest = pool_mod.native_digest
BLIND_POD = "pod-01"


def removal_blind_digest(index, token_processor, pod_identifier, model_name, batch, *args):
    """A planted digest fault: one pod's BlockRemoved events never reach the
    arena (the rest of its batches apply as usual)."""
    if pod_identifier == BLIND_POD:
        batch = EventBatch(ts=batch.ts, events=[e for e in batch.events
                                                if not isinstance(e, BlockRemoved)],
                           data_parallel_rank=batch.data_parallel_rank)
    return real_native_digest(index, token_processor, pod_identifier, model_name, batch, *args)


def run_native_index_bar(label: str, digest=None) -> dict:
    """Phase 14a's index equality at 4 pods with `digest` as the event
    pool's native digest: whether the arena held the plain replay."""
    pool_mod.native_digest = digest or real_native_digest
    try:
        chip_smoke.native_control_plane_run(0, 4, cost_aware=False)
        ok, reason = True, ""
    except AssertionError as e:
        ok, reason = False, str(e)
    finally:
        pool_mod.native_digest = real_native_digest
    chip_smoke.log(f"  [{label}] native index equality: {'ok' if ok else 'FAIL'} {reason}")
    return dict(ok=ok, reason=reason)


class PrefixPrefetcher(RoutePrefetcher):
    """A planted prefetch fault: the chosen pod is handed the prefix it
    already holds instead of the tail it misses."""

    def submit_route(self, pod_identifier, pod_scores):
        return self.submit(pod_identifier,
                           pod_scores.block_hashes[:pod_scores.match_blocks.get(pod_identifier, 0)])


def run_prefetch_bar(label: str, params, cfg, prefetcher_cls=RoutePrefetcher) -> dict:
    """Phase 14b's traffic under load blend, batched, with `prefetcher_cls`:
    whether every request's prefetch matched the index's peer-held head of
    its missing tail (and every other bar of the run held)."""
    template, _ = chip_smoke.chat_fixture()
    tok = chip_smoke.WordTokenizer(chip_smoke.ChatTemplatingProcessor())
    waves = chip_smoke.chat_traffic(0, cfg.vocab_size, template, tok)
    r = chip_smoke.read_plane_run(params, cfg, waves, "load_blend", 8,
                                  prefetcher_cls=prefetcher_cls)
    torch.cuda.empty_cache()
    prefetch = [f for f in r["failures"] if "the prefetcher fetched" in f]
    ok = not r["failures"]
    chip_smoke.log(f"  [{label}] prefetch bar: prefetched {r['prefetched_blocks']} of "
                   f"{r['peer_head_blocks']} peer-held blocks, landed {r['landed_blocks']}, "
                   f"{len(prefetch)} prefetch failures, {len(r['failures'])} in all: "
                   f"{'ok' if ok else 'FAIL'} {r['failures'][:2]}")
    return dict(ok=ok, prefetch_failures=len(prefetch), prefetched=r["prefetched_blocks"],
                peer_head=r["peer_head_blocks"], landed=r["landed_blocks"])


class PassStaleTracker(FleetHealthTracker):
    """A planted health fault: stale pods are detected and purged, but their
    scores pass through (suspect pods are still demoted)."""

    def filter_scores(self, scores):
        if not scores:
            return scores
        self.refresh()
        factor = self.config.suspect_demotion_factor
        return {pod: s * factor if self.state_of(pod) == SUSPECT else s
                for pod, s in scores.items()}


class NoReadmitAuditor(ResidencyAuditor):
    """A planted anti-entropy fault: phantoms are purged, resident blocks the
    index missed are never re-admitted."""

    def _readmit(self, pod, resident, advertised, tier):
        return 0


def run_resilience_bar(label: str, params, cfg, **classes) -> dict:
    """Phase 15a's faulted, wired arm with the given tracker or auditor
    class: whether its bars held, and which of them failed."""
    waves = chip_smoke.multitenant_traffic(0, cfg.vocab_size, chip_smoke.RESILIENCE_WAVES)
    r = chip_smoke.resilience_arm(params, cfg, waves, chip_smoke.RESILIENCE_PLAN, True, **classes)
    torch.cuda.empty_cache()
    stale = [f for f in r["failures"] if "stale" in f and ("names" in f or "by score" in f)]
    repair = [f for f in r["failures"] if "after the audit" in f]
    ok = not r["failures"]
    chip_smoke.log(f"  [{label}] resilience bars: {len(stale)} stale-routing failures, "
                   f"{len(repair)} index-vs-pages failures, {len(r['failures'])} in all: "
                   f"{'ok' if ok else 'FAIL'} {r['failures'][:2]}")
    return dict(ok=ok, stale_failures=len(stale), repair_failures=len(repair),
                phantom_routes=r["phantom_routes"])


def second_best_route(scores: dict, rr: int) -> tuple:
    """A planted routing fault: the pod ranked second by score (pods without
    a score rank after every scored one, in pod order); the real rule where
    no pod scores."""
    if not scores:
        return chip_smoke.trace_route(scores, rr)
    pods = chip_smoke.FLEET_POD_IDS
    ranked = sorted(pods, key=lambda p: (-scores.get(p, 0.0), pods.index(p)))
    return ranked[1], rr


class SilentReplicator(HotPrefixReplicator):
    """A planted placement fault: the policy loop ticks but submits nothing."""

    def tick(self, now=None):
        self.stats["ticks"] += 1
        return 0


class EtaBlindTable(SessionTable):
    """A planted prediction fault: sessions are tracked, but no next-turn ETA
    is ever predicted, so no session is ever due."""

    def _eta_locked(self, rec):
        return math.inf


def run_proactive_bars(params, cfg) -> dict:
    """Phase 16's bars, each on the real plane and on its planted fault:
    16a's prediction bar (a precise request's cached tokens = 16 x the top
    pod's match_blocks) under the real router and `second_best_route`; 16b's
    landed bar with the real HotPrefixReplicator and SilentReplicator; 16c's
    residency bar with the real SessionTable and EtaBlindTable."""
    out = {}
    requests = chip_smoke.sharegpt_requests()
    for label, route in (("sharegpt_real", chip_smoke.trace_route),
                         ("second_best_router", second_best_route)):
        arm = chip_smoke.trace_arm(params, cfg, requests, "precise", route=route)
        missed = [f for f in arm["failures"] if "the index predicted" in f]
        out[label] = dict(ok=not arm["failures"], match_failures=len(missed),
                          hit_rate=arm["summary"]["hit_rate"])
    requests = chip_smoke.placement_requests()
    base = {name: chip_smoke.placement_arm(params, cfg, requests, chip_smoke.PLACEMENT_ARMS[name])
            for name in ("off", "observe")}
    for label, cls in (("placement_real", HotPrefixReplicator),
                       ("silent_replicator", SilentReplicator)):
        on = chip_smoke.placement_arm(params, cfg, requests, chip_smoke.PLACEMENT_ARMS["on"],
                                      replicator_cls=cls)
        fails = on["failures"] + chip_smoke.placement_bars({**base, "on": on})
        out[label] = dict(ok=not fails, landed_failures=sum("placement on landed" in f
                                                            for f in fails),
                          replicated=on["replicated_blocks"])
    requests = chip_smoke.prediction_requests()
    tok = chip_smoke.TextTokenizer(cfg.vocab_size)
    want = chip_smoke.never_evicting_tokens(params, cfg, [
        tok.encode(r.prompt, "").tokens for r in requests
        if r.session == chip_smoke.PREDICTION_SESSION], [1])[0]
    base = {name: chip_smoke.prediction_arm(params, cfg, requests,
                                            chip_smoke.PREDICTION_ARMS[name])
            for name in ("off", "observe")}
    for label, cls in (("prediction_real", SessionTable), ("eta_blind_table", EtaBlindTable)):
        on = chip_smoke.prediction_arm(params, cfg, requests, chip_smoke.PREDICTION_ARMS["on"],
                                       table_cls=cls)
        fails = on["failures"] + chip_smoke.prediction_bars({**base, "on": on}, want)
        out[label] = dict(ok=not fails, residency_failures=sum(f.startswith("on: resident")
                                                               for f in fails),
                          resident=on["audit"]["resident"],
                          resident_off=base["off"]["audit"]["resident"])
    torch.cuda.empty_cache()
    for label, r in out.items():
        chip_smoke.log(f"  [{label}] {'ok' if r['ok'] else 'FAIL'} {r}")
    return out


class WrongOwnerScorer(ClusterScorer):
    """A planted fault: each pod's score and match length are taken from the
    replica after its owner, which digested none of its stream."""

    def _merge(self, replies):
        merged = PodScores()
        n = len(self.transports)
        for rid, ps in replies:
            if not merged.block_hashes and ps.block_hashes:
                merged.block_hashes = ps.block_hashes
        by_rid = dict(replies)
        pods = {p for _, ps in replies for p in ps.scores}
        for pod in sorted(pods):
            other = by_rid.get((self.partitioner.replica_for(pod) + 1) % n)
            if other is not None and pod in other.scores:
                merged.scores[pod] = other.scores[pod]
                merged.match_blocks[pod] = other.match_blocks.get(pod, 0)
        return merged


def drop_last_entry_encoder(view, seq_counters, created_ts=None):
    """A planted snapshot fault: the encoder leaves the view's last entry
    out of the file."""
    return REAL_ENCODE(dataclasses.replace(view, entries=list(view.entries)[:-1]), seq_counters,
                       created_ts=created_ts)


REAL_ENCODE = snapshot_mod.encode_snapshot


class NeverDemoteTracker(RegionFailoverTracker):
    """A planted failover fault: a silent region is never demoted (its
    digests still count when they come)."""

    def state_of(self, region_id: str) -> str:
        super().state_of(region_id)
        return HEALTHY


class AdmittingTransport(chip_smoke.RecordingTransport):
    """A planted chaos fault: with integrity on, damaged blocks are counted as
    detected but delivered, as with integrity off."""

    def fetch_many(self, host, port, block_hashes, max_size):
        verify, self.verify_integrity = self.verify_integrity, False
        try:
            out = super().fetch_many(host, port, block_hashes, max_size)
        finally:
            self.verify_integrity = verify
        return out


class PastCeilingController(AutopilotController):
    """A planted autopilot fault: each nudge is applied upward by eight
    max_steps, around the knob's clamp, so it steps past the ceiling."""

    def _apply(self, now, rule_name, knob_name, frac):
        knob = self.registry.get(knob_name)
        if knob is None:
            return None
        before = knob.position()
        knob._set(before + 8 * abs(frac) * knob.spec.max_step)
        entry = (round(now, 3), rule_name, knob_name, "up", round(knob.position() - before, 6),
                 knob.position())
        self.journal.append(entry)
        self.stats["actuations"] += 1
        return entry


FLEET_PLANE_REQUESTS = 24  # 16a's first requests for the 17a faults (restart at 12)


def run_fleet_plane_bars(params, cfg) -> dict:
    """Phase 17's bars, each on the real plane and on its planted fault:
    17a's replicated scoring (WrongOwnerScorer) and warm restart
    (drop_last_entry_encoder) over 16a's first FLEET_PLANE_REQUESTS
    requests; 17b's detection (NeverDemoteTracker); 17c's integrity bar on
    bf16 pages (AdmittingTransport); 17d's bounds (PastCeilingController)
    on 15a's faulted arm."""
    out = {}
    requests = chip_smoke.sharegpt_requests()[:FLEET_PLANE_REQUESTS]
    for label, scorer in (("cluster_real", ClusterScorer), ("wrong_owner_merge",
                                                              WrongOwnerScorer)):
        arm = chip_smoke.cluster_arm(params, cfg, requests, scorer_cls=scorer)
        fails = arm["failures"] + arm["cluster"]["failures"]
        out[label] = dict(ok=not fails, merge_failures=sum("the cluster scored" in f
                                                           for f in fails))
    snapshot_mod.encode_snapshot = drop_last_entry_encoder
    try:
        arm = chip_smoke.cluster_arm(params, cfg, requests)
    finally:
        snapshot_mod.encode_snapshot = REAL_ENCODE
    fails = arm["failures"] + arm["cluster"]["failures"]
    out["snapshot_drops_last_entry"] = dict(ok=not fails, restart_failures=sum(
        f.startswith("warm restart") for f in fails))
    requests, _ = chip_smoke.geo_requests()
    for label, tracker in (("federation_real", RegionFailoverTracker),
                           ("never_demote_tracker", NeverDemoteTracker)):
        arm = chip_smoke.geo_arm(params, cfg, requests, tracker_cls=tracker)
        out[label] = dict(ok=not arm["failures"], detection_failures=sum(
            "detected at" in f or "not suspect" in f or "not stale" in f
            for f in arm["failures"]))
    for label, cls in (("chaos_real", chip_smoke.RecordingTransport),
                       ("admitting_transport", AdmittingTransport)):
        r = chip_smoke.chaos_check(params, cfg, False, transport_cls=cls)
        out[label] = dict(ok=not r["failures"], integrity_failures=sum(
            f.startswith("corrupt:") for f in r["failures"]))
    waves = chip_smoke.multitenant_traffic(0, cfg.vocab_size, chip_smoke.RESILIENCE_WAVES)
    for label, cls in (("autopilot_real", AutopilotController),
                       ("past_ceiling_controller", PastCeilingController)):
        r = chip_smoke.resilience_arm(params, cfg, waves, chip_smoke.RESILIENCE_PLAN, True,
                                      autopilot=cls)
        out[label] = dict(ok=not r["failures"] and r["autopilot"]["actuations"] > 0,
                          bound_failures=sum("bounds" in f or "outside" in f
                                             for f in r["failures"]),
                          actuations=r["autopilot"]["actuations"])
    torch.cuda.empty_cache()
    for label, r in out.items():
        chip_smoke.log(f"  [{label}] {'ok' if r['ok'] else 'FAIL'} {r}")
    return out


FLEET_PLANE_FAULTS = {  # planted fault -> the count of its bar's failures that must be > 0
    "wrong_owner_merge": "merge_failures",
    "snapshot_drops_last_entry": "restart_failures",
    "never_demote_tracker": "detection_failures",
    "admitting_transport": "integrity_failures",
    "past_ceiling_controller": "bound_failures",
}
FLEET_PLANE_REAL = ("cluster_real", "federation_real", "chaos_real", "autopilot_real")


SERVICE_DROP_EVERY = 50
SERVICE_SKIP_EVERY = 7


class DroppingPoolService(http_service.ScoringService):
    """A planted service fault: its event pool drops every 50th message."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        add, count = self.event_pool.add_task, itertools.count(1)

        def add_task(msg):
            if next(count) % SERVICE_DROP_EVERY:
                add(msg)

        self.event_pool.add_task = add_task


class SkippingCounter:
    """A planted collector fault: a counter that skips every 7th increment
    (swapped in for the lookup counter the instrumented index bumps)."""

    def __init__(self, counter):
        self.counter = counter
        self.count = itertools.count(1)

    def inc(self, amount: float = 1) -> None:
        if next(self.count) % SERVICE_SKIP_EVERY:
            self.counter.inc(amount)

    def __getattr__(self, name):
        return getattr(self.counter, name)


def every_other_trace(submit):
    """A planted recorder fault: the flight recorder keeps every other
    completed trace."""
    count = itertools.count()

    def dropping(trace):
        if next(count) % 2 == 0:
            submit(trace)

    return dropping


def run_service_bars(params, cfg) -> dict:
    """Phase 18a's bars on the real service and on its three planted faults,
    each over 16a's whole trace (its 145 messages: a pool that drops every
    50th loses two)."""
    requests = chip_smoke.sharegpt_requests()
    out = {}

    def run(label, **kw):
        arm = chip_smoke.service_arm(params, cfg, requests, **kw)
        fails = arm["failures"] + arm["service"]["failures"]
        out[label] = dict(ok=not fails,
                          score_failures=sum("the service scored" in f for f in fails),
                          metric_failures=sum(f.startswith("18a: metrics:") for f in fails),
                          trace_failures=sum(f.startswith("18a: read_traces:") for f in fails))

    run("service_real")
    run("pool_drops_every_50th", service_cls=DroppingPoolService)
    metrics_collector.register_metrics()
    real_counter = metrics_collector.index_lookup_requests
    metrics_collector.index_lookup_requests = SkippingCounter(real_counter)
    try:
        run("lookup_counter_skips")
    finally:
        metrics_collector.index_lookup_requests = real_counter
    real_submit = obs.get_recorder().submit
    spans_mod._submit = every_other_trace(real_submit)
    try:
        run("recorder_drops_every_other_trace")
    finally:
        spans_mod._submit = real_submit
    for label, r in out.items():
        chip_smoke.log(f"  [{label}] {'ok' if r['ok'] else 'FAIL'} {r}")
    return out


SERVICE_FAULTS = {  # planted fault -> the count of its bar's failures that must be > 0
    "pool_drops_every_50th": "score_failures",
    "lookup_counter_skips": "metric_failures",
    "recorder_drops_every_other_trace": "trace_failures",
}


# -- phase 19's planted faults: each installed in a tp rank's process before it
# serves (the first three), or around the train step (the last) --------------


def skip_wo_all_reduce(rank: int) -> None:
    """Rank 1 skips the all-reduce after wo: the first reduce_from_tp of
    each layer pass (w_down's is the second)."""
    if rank != 1:
        return
    real, calls = llama.reduce_from_tp, itertools.count()
    llama.reduce_from_tp = lambda x, group: x if next(calls) % 2 == 0 else real(x, group)


def rank1_gets_rank0_heads(rank: int) -> None:
    """The KV pages sharded with rank 1 given rank 0's heads."""
    if rank != 1:
        return
    real = tp_serving.shard_kv_cache
    tp_serving.shard_kv_cache = lambda cache, mesh: real(
        cache, MeshCoords({"tp": chip_smoke.TP}, {"tp": 0}))


def rank1_publishes(rank: int) -> None:
    """Rank 1 publishes its pod's events too."""
    if rank != 1:
        return
    real = EnginePod.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self._publishes = True
    EnginePod.__init__ = init


def rank_bytes_payload(rank: int) -> None:
    """A tp pod's whole block assembled from the ranks' byte strings end to
    end, not from their heads joined on the head axis of each layer."""
    def extract_heads(self, ids):
        local = engine_mod._gather_pages(self.pod.kv_cache, self._page_ids(ids))[:len(ids)].cpu()
        parts = [torch.empty_like(local) for _ in range(self._tp)]
        torch.distributed.all_gather(parts, local, group=self.pod.group)
        return torch.cat(parts, dim=1)
    engine_mod._DevicePageCodec.extract_heads = extract_heads


def rank1_skips_lora_delta(rank: int) -> None:
    """Rank 1 leaves its adapter deltas out of its q and v heads."""
    if rank != 1:
        return
    for name in ("apply_prefill_delta", "apply_decode_delta"):
        real = getattr(llama, name)
        setattr(llama, name, lambda h, lo, real=real: tuple(torch.zeros_like(d)
                                                             for d in real(h, lo)))


def rank1_own_acceptance(rank: int) -> None:
    """Rank 1 takes part in the speculative read back's broadcast, then
    commits its own read back (its sampled draws are zeros: only rank 0
    draws) instead of rank 0's."""
    if rank != 1:
        return
    real = speculative._read_back

    def own(parts, group=None):
        real(parts, group)
        return torch.cat([p.reshape(-1).long() for p in parts]).tolist()
    speculative._read_back = own


# A layer of the flagship as chip_smoke.py serves it (FLAGSHIP_LAYERS deep).
DROPPED_LAYER = chip_smoke.FLAGSHIP_LAYERS // 2
REAL_LOSS_AND_GRADS = llama.loss_and_grads


def drop_one_layer_grad(loss_of, params, dp_group=None):
    """The gradients of layer DROPPED_LAYER dropped from every stacked weight."""
    loss, grads = REAL_LOSS_AND_GRADS(loss_of, params, dp_group)
    for g in grads["layers"].values():
        g[DROPPED_LAYER].zero_()
    return loss, grads


TP_FAULTS = {"skip_wo_all_reduce": skip_wo_all_reduce,
             "rank1_gets_rank0_heads": rank1_gets_rank0_heads,
             "rank1_publishes": rank1_publishes,
             "rank_bytes_payload": rank_bytes_payload,
             "rank1_skips_lora_delta": rank1_skips_lora_delta,
             "rank1_own_acceptance": rank1_own_acceptance}


def run_tp_bars(params, cfg, params32, cfg32, deltas: dict) -> dict:
    """Phase 19a's bars on the real tp pod and on each rank fault, phase
    19b's on the real train step and on drop_one_layer_grad: each run's
    failures (a raise counts as one)."""
    out = {}

    def run(label, fn):
        try:
            failures = fn()["failures"]
        except AssertionError as e:  # a rank failed or hung
            failures = [f"raised: {str(e)[:400]}"]
        out[label] = dict(ok=not failures, failures=failures)
        chip_smoke.log(f"  [{label}] {'ok' if not failures else 'FAIL'} {failures}")

    run("tp_real", lambda: chip_smoke.tp_check(params, cfg, params32, cfg32, deltas))
    for label, fault in TP_FAULTS.items():
        run(label, lambda: chip_smoke.tp_check(params, cfg, params32, cfg32, deltas, fault))
    run("train_real", lambda: chip_smoke.train_check(params, cfg, params32, cfg32))
    llama.loss_and_grads = drop_one_layer_grad
    try:
        run("drop_one_layer_grad", lambda: chip_smoke.train_check(params, cfg, params32, cfg32))
    finally:
        llama.loss_and_grads = REAL_LOSS_AND_GRADS
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    real = {name: _build.library(name) for name in _build.KERNELS}
    mutants = build_mutants()
    cfg = llama.LlamaConfig(**chip_smoke.FLAGSHIP)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    params32, cfg32 = chip_smoke.f32_twin(params, cfg)
    # Phase 13b's or 20b's model of each MUTANT_MODEL fault: (params, cfg,
    # params32, cfg32).
    models = {model: mutant_model(model) for model in set(MUTANT_MODEL.values())}

    chip_smoke.log("== real kernels")
    rows = run_cases("real")
    logits_ok = {"real": {
        **run_decode_logits("real", chip_smoke.DECODE_ROWS, params, cfg, params32, cfg32),
        **run_prefill_logits("real", params, cfg, params32, cfg32)}}
    for model, weights in models.items():
        logits_ok["real"].update({
            f"{model}/{row}": ok for row, ok in run_decode_logits(
                f"real {model}", chip_smoke.DECODE_ROWS, *weights).items()})
        if any(MUTANT_MODEL[m] == model and MUTANTS[m][4] == ("flash_prefill",)
               for m in MUTANT_MODEL):
            logits_ok["real"][f"{model}/flash_prefill"] = run_prefill_logits(
                f"real {model}", *weights)["flash_prefill"]
    delta, plain_err = chip_smoke.teacher_forced_delta(params, cfg, params32, cfg32, False)
    chip_smoke.log(f"  phase 7b's delta on bf16 pages: {delta:.4f} (plain path {plain_err:.4f})")
    bars = {"real": run_scheduler_bar("real", params, cfg, params32, cfg32, delta)}
    for name, libs in mutants.items():
        *_, targets, dtype = MUTANTS[name]
        label = f"{name}-mutant"
        chip_smoke.log(f"== {label}")
        _build._libs.update(libs)
        rows += run_cases(label, sources=tuple(libs))
        if name in MUTANT_MODEL and targets == ("flash_prefill",):
            logits_ok[label] = run_prefill_logits(label, *models[MUTANT_MODEL[name]])
        elif name in MUTANT_MODEL:
            logits_ok[label] = run_decode_logits(label, targets, *models[MUTANT_MODEL[name]])
        elif name in MUTANT_SHAPE:
            pass  # no logits bar (MUTANT_SHAPE)
        elif targets == ("flash_prefill",) and dtype == "bf16":
            logits_ok[label] = run_prefill_logits(label, params, cfg, params32, cfg32)
        elif dtype == "bf16":
            logits_ok[label] = run_decode_logits(label, targets, params, cfg, params32, cfg32)
        if name in SCHEDULER_BAR_MUTANTS:
            bars[label] = run_scheduler_bar(label, params, cfg, params32, cfg32, delta)
        _build._libs.update({source: real[source] for source in libs})
    chip_smoke.log("== host-tier restore: the real codec, and the codec fault one page off")
    host_tier = {"real": run_host_tier_bar("real", params, cfg),
                 "insert_one_page_off": run_host_tier_bar(
                     "insert_one_page_off", params, cfg, scatter_one_page_off)}
    chip_smoke.log("== scheduler fault: decode positions off by one")
    bars["decode_position_off_by_one"] = run_scheduler_bar(
        "decode_position_off_by_one", params, cfg, params32, cfg32, delta,
        scheduler=OffByOneScheduler)
    chip_smoke.log("== LoRA fault: the adapter dropped in decode")
    serving_bars = {
        "lora_real": run_lora_bar("lora_real", params, cfg, params32, cfg32, delta),
        "lora_adapter_dropped_in_decode": run_lora_bar(
            "lora_adapter_dropped_in_decode", params, cfg, params32, cfg32, delta,
            pod_class=AdapterDroppedPod),
    }
    chip_smoke.log("== speculation fault: one proposal accepted more than matched")
    serving_bars["spec_real"] = run_spec_bar("spec_real", params, cfg, params32, cfg32, delta)
    serving_bars["spec_over_accept"] = run_spec_bar(
        "spec_over_accept", params, cfg, params32, cfg32, delta, cls=OverAcceptScheduler)
    chip_smoke.log("== read-plane faults: a native digest blind to one pod's removals, and a "
                   "prefetcher that hands over the matched prefix")
    read_plane = {"native_real": run_native_index_bar("native_real"),
                  "native_removal_blind": run_native_index_bar("native_removal_blind",
                                                               removal_blind_digest),
                  "prefetch_real": run_prefetch_bar("prefetch_real", params, cfg),
                  "prefetch_matched_prefix": run_prefetch_bar(
                      "prefetch_matched_prefix", params, cfg, PrefixPrefetcher)}
    chip_smoke.log("== resilience faults: a tracker that scores stale pods, and an auditor "
                   "that never re-admits")
    resilience = {"real": run_resilience_bar("real", params, cfg),
                  "pass_stale_tracker": run_resilience_bar(
                      "pass_stale_tracker", params, cfg, tracker_cls=PassStaleTracker),
                  "no_readmit_auditor": run_resilience_bar(
                      "no_readmit_auditor", params, cfg, auditor_cls=NoReadmitAuditor)}
    chip_smoke.log("== proactive faults: a router that takes the second-best pod, a replicator "
                   "that submits nothing, a session table that never predicts an ETA")
    proactive = run_proactive_bars(params, cfg)
    chip_smoke.log("== fleet-plane faults: a merge that takes a pod's score from a replica "
                   "that does not own it, a snapshot encoder that drops the last entry, a "
                   "failover tracker that never demotes a silent region, a transport that "
                   "admits damaged blocks with integrity on, a controller that steps past a "
                   "knob's ceiling")
    fleet_plane = run_fleet_plane_bars(params, cfg)
    chip_smoke.log("== service faults: a pool that drops every 50th message, a lookup counter "
                   "that skips every 7th increment, a recorder that drops every other trace")
    service = run_service_bars(params, cfg)
    chip_smoke.log("== tp and training faults: rank 1 skipping the all-reduce after wo, rank 1 "
                   "given rank 0's KV heads, rank 1 publishing events, a block payload of the "
                   "ranks' bytes end to end, rank 1 without its LoRA deltas, rank 1 committing "
                   "its own speculative acceptance, a train step dropping one layer's "
                   "gradients")
    int8_delta, _ = chip_smoke.teacher_forced_delta(params, cfg, params32, cfg32, True)
    tp_bars = run_tp_bars(params, cfg, params32, cfg32, {"bf16": delta, "int8": int8_delta})

    chip_smoke.log("== MoE fault: top-1 serving (the first routed expert only, at gate 1)")
    del params, params32, models
    torch.cuda.empty_cache()
    mcfg, mparams = chip_smoke.mixtral_model()
    mparams32, mcfg32 = chip_smoke.f32_twin(mparams, mcfg)
    moe_delta, moe_plain_err = chip_smoke.teacher_forced_delta(mparams, mcfg, mparams32, mcfg32,
                                                               False)
    chip_smoke.log(f"  phase 11b's delta on bf16 pages: {moe_delta:.4f} (plain path "
                   f"{moe_plain_err:.4f})")
    serving_bars["moe_real"] = run_moe_bar("moe_real", mparams, mcfg, mparams32, mcfg32,
                                           moe_delta)
    serving_bars["moe_top1"] = run_moe_bar("moe_top1", mparams, mcfg, mparams32, mcfg32,
                                           moe_delta, moe=top1_moe)
    del mparams, mparams32

    real_ok = all(r["ok"] for r in rows if r["variant"] == "real") and all(
        logits_ok["real"].values()) and bars["real"]["ok"] and host_tier["real"]["all_checks"] \
        and serving_bars["lora_real"]["ok"] and serving_bars["spec_real"]["ok"] \
        and serving_bars["moe_real"]["ok"] and read_plane["native_real"]["ok"] \
        and read_plane["prefetch_real"]["ok"] and resilience["real"]["ok"] \
        and all(proactive[label]["ok"]
                for label in ("sharegpt_real", "placement_real", "prediction_real")) \
        and all(fleet_plane[label]["ok"] for label in FLEET_PLANE_REAL) \
        and service["service_real"]["ok"] \
        and tp_bars["tp_real"]["ok"] and tp_bars["train_real"]["ok"]
    tp_caught = {label: not tp_bars[label]["ok"]
                 for label in (*TP_FAULTS, "drop_one_layer_grad")}
    fleet_plane_caught = {label: not fleet_plane[label]["ok"] and fleet_plane[label][key] > 0
                          for label, key in FLEET_PLANE_FAULTS.items()}
    service_caught = {label: not service[label]["ok"] and service[label][key] > 0
                      for label, key in SERVICE_FAULTS.items()}
    read_plane_caught = {label: not read_plane[label]["ok"]
                         for label in ("native_removal_blind", "prefetch_matched_prefix")}
    read_plane_caught["prefetch_matched_prefix"] &= \
        read_plane["prefetch_matched_prefix"]["prefetch_failures"] > 0
    resilience_caught = {
        "pass_stale_tracker": resilience["pass_stale_tracker"]["stale_failures"] > 0,
        "no_readmit_auditor": resilience["no_readmit_auditor"]["repair_failures"] > 0}
    proactive_caught = {
        "second_best_router": proactive["second_best_router"]["match_failures"] > 0,
        "silent_replicator": proactive["silent_replicator"]["landed_failures"] > 0,
        "eta_blind_table": proactive["eta_blind_table"]["residency_failures"] > 0}
    serving_caught = {label: not serving_bars[label]["ok"]
                      for label in ("lora_adapter_dropped_in_decode", "spec_over_accept",
                                    "moe_top1")}
    # Held to the served routes, the teacher-forced bar alone fails top-1
    # serving (its delta no longer spans a whole expert's flip).
    serving_caught["moe_top1_teacher_forced_bar"] = not serving_bars["moe_top1"]["bar_ok"]
    host_tier_caught = not host_tier["insert_one_page_off"]["ok"]
    bar_caught = {label: not bar["ok"] for label, bar in bars.items() if label != "real"}
    main_rows = {
        f"{name}/{kernel}": next(r for r in rows if r["variant"] == f"{name}-mutant"
                                 and r["case"] == main_case(kernel, dtype, name))
        for name, (*_, targets, dtype) in MUTANTS.items() for kernel in targets
    }
    caught = {key: not r["ok"] for key, r in main_rows.items()}
    # A fault planted in f32-only code must leave every bf16 case passing.
    f32_faults_spare_bf16 = {
        name: all(r["ok"] for r in rows
                  if r["variant"] == f"{name}-mutant" and r["case"].split()[1] == "bf16")
        for name, (*_, dtype) in MUTANTS.items() if dtype == "f32"}
    logits_caught = {label: not any(ok.values())
                     for label, ok in logits_ok.items() if label != "real"}
    worst = {}
    for r in rows:
        if r["case"].split()[1] == "bf16":
            key = f"{r['variant']}/{r['kernel']}"
            worst[key] = max(worst.get(key, 0.0), r["row_rel_err"])
    chip_smoke.log(json.dumps({
        "real_ok": real_ok, "mutant_caught_at_main_shape": caught,
        "f32_faults_spare_bf16": f32_faults_spare_bf16,
        "mutant_row_rel_err_at_main_shape": {
            kernel: r["row_rel_err"] for kernel, r in main_rows.items()},
        "mutant_caught_by_logits": logits_caught,
        "caught_by_scheduler_bar": bar_caught,
        "caught_by_lora_speculative_and_moe_bars": serving_caught,
        "lora_speculative_and_moe_bar_readings": {label: dict(bar["worst"], delta=bar["delta"])
                                              for label, bar in serving_bars.items()},
        "host_tier_fault_caught": host_tier_caught, "host_tier_readings": host_tier,
        "read_plane_faults_caught": read_plane_caught, "read_plane_readings": read_plane,
        "resilience_faults_caught": resilience_caught, "resilience_readings": resilience,
        "proactive_faults_caught": proactive_caught, "proactive_readings": proactive,
        "fleet_plane_faults_caught": fleet_plane_caught, "fleet_plane_readings": fleet_plane,
        "service_faults_caught": service_caught, "service_readings": service,
        "tp_and_training_faults_caught": tp_caught, "tp_and_training_readings": tp_bars,
        "scheduler_bar_readings": {label: dict(bar["worst"], delta=bar["delta"])
                                   for label, bar in bars.items()},
        "logits_ok": logits_ok, "bf16_max_row_rel_err": worst,
        "bf16_row_rel_limits": chip_smoke.BF16_ROW_REL,
    }))
    return 0 if (real_ok and all(caught.values()) and all(logits_caught.values())
                 and all(f32_faults_spare_bf16.values())
                 and all(bar_caught.values()) and host_tier_caught
                 and all(serving_caught.values()) and all(read_plane_caught.values())
                 and all(resilience_caught.values()) and all(proactive_caught.values())
                 and all(fleet_plane_caught.values())
                 and all(service_caught.values())
                 and all(tp_caught.values())) else 1


if __name__ == "__main__":
    sys.exit(main())
