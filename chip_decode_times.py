#!/usr/bin/env python3
"""Paged-decode times on one CUDA card, for comparing two trees in one call.

    python3 chip_decode_times.py                      # this checkout's package
    python3 chip_decode_times.py --package-root DIR   # the port package of another
                                                      # checkout (e.g. an unpacked
                                                      # older commit), same timing

Three readings:
  - kernels: the four decode rows at the three decode shapes (batch 8 x
    2,048, the serving shape batch 1 x 1,536 over a 128-page table, batch 1 x
    4,096), each call cold in L2 and graph-timed, with SDPA over pre-gathered
    K/V as the yardstick (no plain versions: chip_smoke.py times those);
  - steps: phase 6's batch-8 x 2,048 flagship decode step (pipelined, bf16
    pages and int8 pages): wall time (median of 30 CUDA-event-timed calls),
    device kernel time and launches (torch.profiler);
  - host: the host time of one wrapper call of each decode row at the
    serving shape (the launch's Python and C cost; the kernels run behind
    it), the median of 5 rounds of 100 calls.

The kernels of the timed package are built into this checkout's
llm_d_kv_cache_manager_tpu_torch/build/ (another tree's into
build/variants/<hash of its csrc/>/): the script writes nothing outside its
own checkout. Compare two trees only inside one call, in turns (old, new,
new, old). Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PKG = "llm_d_kv_cache_manager_tpu_torch"


def csrc_digest(root: Path) -> str:
    digest = hashlib.sha256()
    for path in sorted((root / PKG / "csrc").iterdir()):
        digest.update(path.name.encode() + path.read_bytes())
    return digest.hexdigest()[:16]


def time_step(smoke, cfg, params, int8: bool) -> dict:
    """Phase 6's decode step on the pipelined kernel: wall, device, launches."""
    cache, tables, lens, tokens, _ = smoke.decode_setup(cfg, int8, seed=5)
    label = f"decode step, batch {smoke.DECODE_BATCH}, {'int8' if int8 else 'bf16'} pages"

    def step():
        return smoke.llama.decode_step_cache(cfg, params, cache, tokens, tables, lens,
                                             pipelined=True)

    wall_ms = smoke.time_ms(step, runs=30, warmup=3)
    prof = smoke.profile_device_share(label, step)
    smoke.log(f"  {label}: wall {wall_ms:.3f} ms (median of 30)")
    return dict(wall_ms=wall_ms, **{k: prof.get(k) for k in ("device_ms", "launches")})


def wrapper_host_us(smoke, gen, row: str, calls: int = 100, rounds: int = 5) -> float:
    """Host microseconds of one wrapper call of `row` at the serving shape."""
    import torch

    batch, ctx, table_ctx = smoke.DECODE_SHAPES["B=1 ctx=1536 table=2048"]
    q, pages, tables, lens = smoke.decode_inputs(
        gen, torch.bfloat16, batch, [ctx] * batch, smoke.PAGE, max_ctx=table_ctx,
        int8=smoke.DECODE_ROWS[row]["int8"])
    smoke.run_decode(row, q, pages, tables, lens)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            smoke.run_decode(row, q, pages, tables, lens)
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package-root", type=Path, default=None,
                        help=f"directory holding the {PKG} to time")
    args = parser.parse_args()
    root = (args.package_root or HERE).resolve()
    sys.path.insert(0, str(root))
    # This checkout's chip_smoke.py (its timing), over the package under `root`.
    spec = importlib.util.spec_from_file_location("chip_smoke_timing", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("chip_decode_times: no CUDA device", file=sys.stderr)
        return 2
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"the port package did not load from {root}")
    if root != HERE:
        _build.BUILD_DIR = HERE / PKG / "build" / "variants" / csrc_digest(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    smoke.log(f"{smi}; package from {root}; kernels built into {_build.BUILD_DIR}")
    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {shape: {row: smoke.time_decode(gen, row, shape, plain=False)
                     for row in smoke.DECODE_ROWS}
             for shape in smoke.DECODE_SHAPES}
    host_us = {row: wrapper_host_us(smoke, gen, row) for row in smoke.DECODE_ROWS}
    smoke.log(f"  wrapper host time per call, us: {host_us}")
    cfg = smoke.llama.LlamaConfig(**smoke.FLAGSHIP)
    params = smoke.llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    steps = {("int8" if int8 else "bf16"): time_step(smoke, cfg, params, int8)
             for int8 in (False, True)}
    print(json.dumps({"device": smi, "package_root": str(root),
                      "ms": {shape: {row: t["ms"] for row, t in rows.items()}
                             for shape, rows in times.items()},
                      "sdpa_ms": {shape: rows["paged_decode"]["library_ms"]
                                  for shape, rows in times.items()},
                      "wrapper_host_us": host_us, "decode_step": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
