#!/usr/bin/env python3
"""Planted-fault check of chip_smoke.py's bars, on one CUDA card.

    python3 chip_fault_check.py

Shows that the kernel-vs-plain bars of chip_smoke.py catch a kernel that
drops or leaks work. Each planted fault is built from a mutated copy of its
kernel source, written only under the package's build/planted/ directory:

  - paged_decode (pipelined decode, bf16/f32 and int8 pages): the second
    64-token chunk of every sequence is skipped;
  - paged_decode_tiled (split-KV decode, bf16/f32 and int8 pages): the second
    page of every split is dropped (both decode faults are planted in the
    body the two sources share, each in its own source's build only);
  - flash_prefill: the second live 128-key block of every q-block is skipped
    by the bf16 (wgmma) kernel;
  - flash_prefill_diagonal: the k-block on each q-block's causal diagonal
    takes the unmasked interior path, so rows see future keys.

The real kernels and each mutant in turn are swapped in behind the wrappers
and run through chip_smoke's kernel cases (bf16 and f32, the same seeded
inputs), its batch-8 flagship decode-logits check of each decode kernel the
source holds, and its flagship prefill-logits check for the flash source.
Every case's errors are printed beside its bar, then one JSON summary line.
Exits non-zero unless the real kernels pass every case and each mutant fails
the main-shape bf16 case of every kernel it holds.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

import chip_smoke
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops import _build

# Planted fault -> (kernel source it is built into, file of csrc/ holding the
# line, line, faulty line).
MUTANTS = {
    "paged_decode": (
        "paged_decode", "paged_decode_common.cuh",
        "const int t_end = min(kChunk, pos_end - c_start);",
        "const int t_end = c == 1 ? 0 : min(kChunk, pos_end - c_start);",
    ),
    "paged_decode_tiled": (
        "paged_decode_tiled", "paged_decode_common.cuh",
        "const bool live = t < t_end && pos >= win_lo;",
        "const bool live = t < t_end && pos >= win_lo && pos / page_size != pos0 / page_size + 1;",
    ),
    "flash_prefill": (
        "flash_prefill", "flash_prefill.cu",
        "const int k0 = j * kBK;",
        "const int k0 = j * kBK;\n    if (j == first_blk + 1) continue;",
    ),
    "flash_prefill_diagonal": (
        "flash_prefill", "flash_prefill.cu",
        "const bool interior = k0 + kBK - 1 <= hi_all && k0 >= lo_all;",
        "const bool interior = k0 <= hi_all && k0 >= lo_all;",
    ),
}


def build_mutant(name: str) -> ctypes.CDLL:
    """Build fault `name` into a copy of its kernel source and the headers
    under build/planted/<name>/ (a shared header's fault reaches only this
    build)."""
    source, target, old, new = MUTANTS[name]
    out_dir = _build.BUILD_DIR / "planted" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    for path in [_build.CSRC_DIR / f"{source}.cu", *_build.CSRC_DIR.glob("*.cuh")]:
        text = path.read_text()
        if path.name == target:
            if text.count(old) != 1:
                raise RuntimeError(f"{target}: the line to mutate is not there once")
            text = text.replace(old, new)
        (out_dir / path.name).write_text(text)
    so = out_dir / f"lib{name}_mutant.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(out_dir / f"{source}.cu")], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def run_cases(label: str, source=None) -> list:
    """chip_smoke's kernel cases, or only those of the kernels in `source`."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kernel, dtype, name, got, ref in chip_smoke.kernel_cases(gen):
        if source is not None and chip_smoke.SOURCE[kernel] != source:
            continue
        torch.cuda.synchronize()
        m = chip_smoke.compare(kernel, got, ref, dtype)
        rows.append(dict(variant=label, kernel=kernel, case=name, **m))
        chip_smoke.log(f"  [{label}] {name}: max_abs_err={m['max_abs_err']:.3e} "
                       f"row_rel_err={m['row_rel_err']:.3e} ({m['bar']}) "
                       f"{'ok' if m['ok'] else 'FAIL'}")
    return rows


def run_decode_logits(label: str, source, params, cfg, params32, cfg32) -> dict:
    """chip_smoke's batch-8 decode-logits check of each decode kernel in
    `source` (all four for None): {row: passed}."""
    out = {}
    for row, spec in chip_smoke.DECODE_ROWS.items():
        if source is not None and chip_smoke.SOURCE[row] != source:
            continue
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
    logits_ok = {"real": {**run_decode_logits("real", None, params, cfg, params32, cfg32),
                          **run_prefill_logits("real", params, cfg, params32, cfg32)}}
    for name, lib in mutants.items():
        source = MUTANTS[name][0]
        label = f"{name}-mutant"
        chip_smoke.log(f"== {label}")
        _build._libs[source] = lib
        rows += run_cases(label, source=source)
        if source == "flash_prefill":
            logits_ok[label] = run_prefill_logits(label, params, cfg, params32, cfg32)
        else:
            logits_ok[label] = run_decode_logits(label, source, params, cfg, params32, cfg32)
        _build._libs[source] = real[source]

    real_ok = all(r["ok"] for r in rows if r["variant"] == "real") and all(
        logits_ok["real"].values())
    main_rows = {
        f"{name}/{kernel}": next(r for r in rows if r["variant"] == f"{name}-mutant"
                                 and r["case"] == chip_smoke.MAIN_CASES[kernel])
        for name, (source, *_) in MUTANTS.items()
        for kernel in chip_smoke.KERNELS if chip_smoke.SOURCE[kernel] == source
    }
    caught = {key: not r["ok"] for key, r in main_rows.items()}
    worst = {}
    for r in rows:
        if r["case"].split()[1] == "bf16":
            key = f"{r['variant']}/{r['kernel']}"
            worst[key] = max(worst.get(key, 0.0), r["row_rel_err"])
    chip_smoke.log(json.dumps({
        "real_ok": real_ok, "mutant_caught_at_main_shape": caught,
        "mutant_row_rel_err_at_main_shape": {
            kernel: r["row_rel_err"] for kernel, r in main_rows.items()},
        "logits_ok": logits_ok, "bf16_max_row_rel_err": worst,
        "bf16_row_rel_limits": chip_smoke.BF16_ROW_REL,
    }))
    return 0 if real_ok and all(caught.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
