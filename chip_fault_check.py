#!/usr/bin/env python3
"""Planted-fault check of chip_smoke.py's bars, on one CUDA card.

    python3 chip_fault_check.py

Shows that the kernel-vs-plain bars of chip_smoke.py catch a kernel that
drops work. Each kernel is built once more from a mutated copy of its
source, written only under the package's build/ directory:

  - paged_decode: the second 64-token chunk of every sequence is skipped;
  - flash_prefill: the second live k-block of every q-block is skipped.

The real kernels and each mutant in turn are swapped in behind the wrappers
and run through chip_smoke's kernel cases (bf16 and f32, the same seeded
inputs) and its batch-8 flagship decode-logits check. Every case's errors
are printed beside its bar, then one JSON summary line. Exits non-zero
unless the real kernels pass every case and each mutant fails its kernel's
main-shape bf16 case.
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

MUTANTS = {
    "paged_decode": (
        "const int t_end = min(kChunk, seq_len - c_start);",
        "const int t_end = c == 1 ? 0 : min(kChunk, seq_len - c_start);",
    ),
    "flash_prefill": (
        "const int k0 = j * kBlockK;",
        "const int k0 = j * kBlockK;\n    if (j == first_blk + 1) continue;",
    ),
}


def build_mutant(name: str) -> ctypes.CDLL:
    old, new = MUTANTS[name]
    src = (_build.CSRC_DIR / f"{name}.cu").read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"{name}.cu: the line to mutate is not there once")
    out_dir = _build.BUILD_DIR / "planted"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}_mutant.cu"
    cu.write_text(src.replace(old, new))
    so = out_dir / f"lib{name}_mutant.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def run_cases(label: str) -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kernel, dtype, name, got, ref in chip_smoke.kernel_cases(gen):
        torch.cuda.synchronize()
        m = chip_smoke.compare(kernel, got, ref, dtype)
        rows.append(dict(variant=label, kernel=kernel, case=name, **m))
        chip_smoke.log(f"  [{label}] {name}: max_abs_err={m['max_abs_err']:.3e} "
                       f"row_rel_err={m['row_rel_err']:.3e} ({m['bar']}) "
                       f"{'ok' if m['ok'] else 'FAIL'}")
    return rows


def run_decode_logits(label: str, params, cfg) -> bool:
    gen = torch.Generator(device="cuda").manual_seed(1)
    try:
        chip_smoke.phase_batched_decode(params, cfg, gen)
    except AssertionError as e:
        chip_smoke.log(f"  [{label}] batched decode: FAIL ({e})")
        return False
    chip_smoke.log(f"  [{label}] batched decode: ok")
    return True


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    real = {name: _build.library(name) for name in _build.KERNELS}
    mutants = {name: build_mutant(name) for name in _build.KERNELS}
    cfg = llama.LlamaConfig(**chip_smoke.FLAGSHIP)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")

    chip_smoke.log("== real kernels")
    rows = run_cases("real")
    logits_ok = {"real": run_decode_logits("real", params, cfg)}
    for name, lib in mutants.items():
        label = f"{name}-mutant"
        chip_smoke.log(f"== {label}")
        _build._libs[name] = lib
        rows += [r for r in run_cases(label) if r["kernel"] == name]
        if name == "paged_decode":
            logits_ok[label] = run_decode_logits(label, params, cfg)
        _build._libs[name] = real[name]

    real_ok = all(r["ok"] for r in rows if r["variant"] == "real") and logits_ok["real"]
    main_rows = {
        name: next(r for r in rows if r["variant"] == f"{name}-mutant"
                   and r["case"] == chip_smoke.MAIN_CASES[name])
        for name in _build.KERNELS
    }
    caught = {name: not r["ok"] for name, r in main_rows.items()}
    worst = {}
    for r in rows:
        if r["case"].split()[1] == "bf16":
            key = f"{r['variant']}/{r['kernel']}"
            worst[key] = max(worst.get(key, 0.0), r["row_rel_err"])
    chip_smoke.log(json.dumps({
        "real_ok": real_ok, "mutant_caught_at_main_shape": caught,
        "mutant_row_rel_err_at_main_shape": {
            name: r["row_rel_err"] for name, r in main_rows.items()},
        "decode_logits_ok": logits_ok, "bf16_max_row_rel_err": worst,
        "bf16_row_rel_limits": chip_smoke.BF16_ROW_REL,
    }))
    return 0 if real_ok and all(caught.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
