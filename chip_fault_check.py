#!/usr/bin/env python3
"""Planted-fault check of chip_smoke.py's bars, on one CUDA card.

    python3 chip_fault_check.py

Shows that the kernel-vs-plain bars of chip_smoke.py catch a kernel that
drops or leaks work. Each planted fault is built from a mutated copy of its
kernel sources, written only under the package's build/planted/ directory:

  - decode_sm90_stage (both decode sources for bf16 q, on bf16 and int8
    pages: the body of paged_decode_sm90.cuh): the second 64-token stage of
    every CTA's range is skipped;
  - decode_cluster_rank (pipelined decode for bf16 q, both page formats):
    cluster rank 0's partial is left out of the merge through distributed
    shared memory;
  - decode_combine_split (split-KV decode, both page formats): the combine
    pass drops split 1;
  - paged_decode (pipelined decode for f32 q, on f32 and int8 pages: the
    first port's body, paged_decode_common.cuh): the second 64-token chunk
    of every sequence is skipped;
  - paged_decode_tiled (split-KV decode for f32 q, the same body): the
    second page of every split is dropped (both planted in the body the two
    sources share, each in its own source's build only);
  - flash_prefill: the second live 128-key block of every q-block is skipped
    by the bf16 (wgmma) kernel;
  - flash_prefill_diagonal: the k-block on each q-block's causal diagonal
    takes the unmasked interior path, so rows see future keys.

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
the f32 truth, and the greedy tokens' agreement with the truth's argmax
against the plain bf16 path's) are held to the real MoE dispatch and to a
planted MoE fault, top-1 serving: every token keeps only its first routed
expert, at gate 1; the fault must fail them (either check fails phase 11b;
each one's reading is printed).

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
the two faults of the first port's body, which bf16 q no longer reaches:
they are held to the f32 case of each row they target ("paged_decode f32
page=16 window=None B=8" and its three siblings) and to no logits bar (the
flagship logits run in bf16).
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys

import torch

import chip_smoke
from llm_d_kv_cache_manager_tpu_torch.engine import engine as engine_mod
from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod
from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler
from llm_d_kv_cache_manager_tpu_torch.models import llama, mixtral
from llm_d_kv_cache_manager_tpu_torch.ops import _build

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
        ("paged_decode_tiled",), "paged_decode_tiled.cu",
        "if (m == -INFINITY) continue;  // a split with no live position",
        "if (m == -INFINITY || s == 1) continue;",
        ("paged_decode_tiled", "paged_decode_tiled_int8"), "bf16",
    ),
    "paged_decode": (
        ("paged_decode",), "paged_decode_common.cuh",
        "const int t_end = min(kChunk, pos_end - c_start);",
        "const int t_end = c == 1 ? 0 : min(kChunk, pos_end - c_start);",
        ("paged_decode", "paged_decode_int8"), "f32",
    ),
    "paged_decode_tiled": (
        ("paged_decode_tiled",), "paged_decode_common.cuh",
        "const bool live = t < t_end && pos >= win_lo;",
        "const bool live = t < t_end && pos >= win_lo && pos / page_size != pos0 / page_size + 1;",
        ("paged_decode_tiled", "paged_decode_tiled_int8"), "f32",
    ),
    "flash_prefill": (
        ("flash_prefill",), "flash_prefill.cu",
        "const int k0 = j * kBK;",
        "const int k0 = j * kBK;\n    if (j == first_blk + 1) continue;",
        ("flash_prefill",), "bf16",
    ),
    "flash_prefill_diagonal": (
        ("flash_prefill",), "flash_prefill.cu",
        "const bool interior = k0 + kBK - 1 <= hi_all && k0 >= lo_all;",
        "const bool interior = k0 <= hi_all && k0 >= lo_all;",
        ("flash_prefill",), "bf16",
    ),
}


# The kernel faults also held to phase 7b's teacher-forced bar (a bf16 pod
# through the scheduler), beside the planted scheduler fault.
SCHEDULER_BAR_MUTANTS = ("decode_sm90_stage",)


def main_case(kernel: str, dtype: str) -> str:
    """chip_smoke's case of `kernel` at the main path's shape, in `dtype`
    ("bf16" or "f32")."""
    return chip_smoke.MAIN_CASES[kernel].replace(" bf16 ", f" {dtype} ")


def build_mutant(name: str) -> dict:
    """Build fault `name` into a copy of each of its kernel sources and the
    headers under build/planted/<name>/ (a shared header's fault reaches only
    these builds): {source: library}."""
    sources, target, old, new, _, _ = MUTANTS[name]
    out_dir = _build.BUILD_DIR / "planted" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    for path in [*_build.CSRC_DIR.glob("*.cu"), *_build.CSRC_DIR.glob("*.cuh")]:
        text = path.read_text()
        if path.name == target:
            if text.count(old) != 1:
                raise RuntimeError(f"{target}: the line to mutate is not there once")
            text = text.replace(old, new)
        (out_dir / path.name).write_text(text)
    libs = {}
    for source in sources:
        so = out_dir / f"lib{source}_mutant.so"
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(out_dir / f"{source}.cu")], check=True, capture_output=True)
        libs[source] = ctypes.CDLL(str(so))
    return libs


def run_cases(label: str, sources=None) -> list:
    """chip_smoke's kernel cases, or only those of the kernels built from
    `sources`."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kernel, dtype, name, got, ref in chip_smoke.kernel_cases(gen):
        if sources is not None and chip_smoke.SOURCE[kernel] not in sources:
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
    `rows`: {row: passed}."""
    out = {}
    for row in rows:
        spec = chip_smoke.DECODE_ROWS[row]
        r = chip_smoke.batched_decode_check(
            params, cfg, params32, cfg32, spec["int8"], spec["pipelined"])
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
        r, traffic, *_ = chip_smoke.moe_run(params, cfg, False)
    finally:
        mixtral._moe_mlp_dense = real_moe
    bar = chip_smoke.teacher_forced_bar(params32, cfg32, traffic, r["requests"], delta)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    real = {name: _build.library(name) for name in _build.KERNELS}
    mutants = {name: build_mutant(name) for name in MUTANTS}
    cfg = llama.LlamaConfig(**chip_smoke.FLAGSHIP)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    params32, cfg32 = chip_smoke.f32_twin(params, cfg)

    chip_smoke.log("== real kernels")
    rows = run_cases("real")
    logits_ok = {"real": {
        **run_decode_logits("real", chip_smoke.DECODE_ROWS, params, cfg, params32, cfg32),
        **run_prefill_logits("real", params, cfg, params32, cfg32)}}
    delta, plain_err = chip_smoke.teacher_forced_delta(params, cfg, params32, cfg32, False)
    chip_smoke.log(f"  phase 7b's delta on bf16 pages: {delta:.4f} (plain path {plain_err:.4f})")
    bars = {"real": run_scheduler_bar("real", params, cfg, params32, cfg32, delta)}
    for name, libs in mutants.items():
        *_, targets, dtype = MUTANTS[name]
        label = f"{name}-mutant"
        chip_smoke.log(f"== {label}")
        _build._libs.update(libs)
        rows += run_cases(label, sources=tuple(libs))
        if targets == ("flash_prefill",):
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

    chip_smoke.log("== MoE fault: top-1 serving (the first routed expert only, at gate 1)")
    del params, params32
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
        and serving_bars["moe_real"]["ok"]
    serving_caught = {label: not serving_bars[label]["ok"]
                      for label in ("lora_adapter_dropped_in_decode", "spec_over_accept",
                                    "moe_top1")}
    host_tier_caught = not host_tier["insert_one_page_off"]["ok"]
    bar_caught = {label: not bar["ok"] for label, bar in bars.items() if label != "real"}
    main_rows = {
        f"{name}/{kernel}": next(r for r in rows if r["variant"] == f"{name}-mutant"
                                 and r["case"] == main_case(kernel, dtype))
        for name, (*_, targets, dtype) in MUTANTS.items() for kernel in targets
    }
    caught = {key: not r["ok"] for key, r in main_rows.items()}
    logits_caught = {label: not any(ok.values())
                     for label, ok in logits_ok.items() if label != "real"}
    worst = {}
    for r in rows:
        if r["case"].split()[1] == "bf16":
            key = f"{r['variant']}/{r['kernel']}"
            worst[key] = max(worst.get(key, 0.0), r["row_rel_err"])
    chip_smoke.log(json.dumps({
        "real_ok": real_ok, "mutant_caught_at_main_shape": caught,
        "mutant_row_rel_err_at_main_shape": {
            kernel: r["row_rel_err"] for kernel, r in main_rows.items()},
        "mutant_caught_by_logits": logits_caught,
        "caught_by_scheduler_bar": bar_caught,
        "caught_by_lora_speculative_and_moe_bars": serving_caught,
        "lora_speculative_and_moe_bar_readings": {label: dict(bar["worst"], delta=bar["delta"])
                                              for label, bar in serving_bars.items()},
        "host_tier_fault_caught": host_tier_caught, "host_tier_readings": host_tier,
        "scheduler_bar_readings": {label: dict(bar["worst"], delta=bar["delta"])
                                   for label, bar in bars.items()},
        "logits_ok": logits_ok, "bf16_max_row_rel_err": worst,
        "bf16_row_rel_limits": chip_smoke.BF16_ROW_REL,
    }))
    return 0 if (real_ok and all(caught.values()) and all(logits_caught.values())
                 and all(bar_caught.values()) and host_tier_caught
                 and all(serving_caught.values())) else 1


if __name__ == "__main__":
    sys.exit(main())
