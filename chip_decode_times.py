#!/usr/bin/env python3
"""Paged-decode times on one CUDA card, for comparing two trees in one call.

    python3 chip_decode_times.py                      # this checkout's package
    python3 chip_decode_times.py --package-root DIR   # the port package of another
                                                      # checkout (e.g. an unpacked
                                                      # older commit), same timing

    python3 chip_decode_times.py --sass-against DIR   # also: the SASS of the kernels
                                                      # up to head_dim 256, this tree's
                                                      # against DIR's, function by function
    python3 chip_decode_times.py --readings narrow_flash,beyond  # some readings only
    python3 chip_decode_times.py --readings f32       # the f32-q decode and flash
    python3 chip_decode_times.py --build-only         # build, to time later

Nine readings (all by default):
  - kernels: the four decode rows at the three decode shapes (batch 8 x
    2,048, the serving shape batch 1 x 1,536 over a 128-page table, batch 1 x
    4,096), each call cold in L2 and graph-timed, with SDPA over pre-gathered
    K/V as the yardstick (no plain versions: chip_smoke.py times those);
  - flash: row 5 at the flagship's heads, a 2,048-token chunk and the
    serving chunk (kernel, plain version, SDPA, bound);
  - wide: rows 1 and 2 (the pipelined kernel on bf16 and int8 pages) at the
    two batch-8 and serving decode shapes and row 5 at the serving prefill
    chunk (512 new tokens after 1,024 cached), at phase 21's attention shape
    (4/2 heads of 512) and at head_dim 576 with group 16 (WIDE_SHAPES), with
    the plain version, SDPA (its MATH path at these head dims) and the bound
    beside each;
  - steps: phase 6's batch-8 x 2,048 flagship decode step (pipelined, bf16
    pages and int8 pages): wall time (median of 30 CUDA-event-timed calls),
    device kernel time and launches (torch.profiler);
  - host: the host time of one wrapper call of each decode row at the
    serving shape (the launch's Python and C cost; the kernels run behind
    it), the median of 5 rounds of 100 calls;
  - narrow_flash: row 5 at Qwen2.5-0.5B's 14/2 heads of 64 and Gemma-7B's
    16/16 heads of 256, the serving chunk and a 2,048-token chunk (kernel,
    SDPA, bound);
  - beyond: at chip_smoke.py's BEYOND_SHAPES (head dims 1,280 at group 8 and
    2,304), rows 1 and 2 at batch 8 x 2,048 and row 5 at the serving chunk
    (kernel, plain version, SDPA, bound);
  - combine: the four decode rows at the batch-8 x 2,048 and serving decode
    shapes at the Qwen2.5-7B, Qwen2.5-0.5B, OpenLLaMA-3B and 4/2 x 512
    attention shapes (`COMBINE_TIMED`; the flagship's are the kernels
    reading's), graph-timed cold as there; and at those shapes and the
    flagship's three, each tiled row's call split into its two launches by
    torch.profiler over 20 warm calls: the split pass and the combine pass
    (the kernel whose name holds "combine"), device microseconds per call.
    It reads any tree's package alike, the combine inside the tiled entry;
  - f32: the four decode rows with f32 q, on f32 pages (rows 1 and 3) and
    on int8 pages (rows 2 and 4), at the three decode shapes of the
    flagship's heads, at Qwen2.5-7B's and -0.5B's heads at batch 8 x 2,048
    and the serving shape, at OpenLLaMA-3B's at batch 8, and at phase 21's
    4/2 heads of 512 at batch 8 x 2,048 and the serving shape (`F32_TIMED`),
    cold in L2 and graph-timed: kernel, plain version, SDPA over the K/V
    gathered in f32 (the backend named), and the bound; then row 5 in f32
    at a 2,048-token chunk and the serving chunk of the flagship's heads and
    at the serving chunk of 4/2 heads of 512 (kernel, plain, SDPA, the
    bound at the card's f32 rate outside the tensor cores).

The kernels of the timed package are built into this checkout's
llm_d_kv_cache_manager_tpu_torch/build/ (another tree's into
build/variants/<hash of its csrc/>/): the script writes nothing outside its
own checkout. Compare two trees only inside one call, in turns (old, new,
new, old). Prints the card's name and power limit, the kernels' build
time (0 where they were already built), then one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import re
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


# The attention shapes above head_dim 256 that the wide reading times.
WIDE_TIMED = ("flagship-heads-512", "hd=576 group=16")
# The sources whose kernels up to head_dim 256 the SASS reading compares.
SASS_SOURCES = ("paged_decode", "paged_decode_tiled", "flash_prefill")


def time_wide(smoke, gen) -> dict:
    """Rows 1, 2 and 5 at WIDE_TIMED: kernel, plain version, SDPA, bound
    (chip_smoke's)."""
    out = {}
    for shape in WIDE_TIMED:
        n_q, n_kv, hd = smoke.WIDE_SHAPES[shape]
        rows = {dshape: {row: smoke.time_decode(gen, row, dshape, n_q=n_q,
                                                n_kv=n_kv, hd=hd, combine=False)
                         for row in ("paged_decode", "paged_decode_int8")}
                for dshape in ("B=8 ctx=2048", "B=1 ctx=1536 table=2048")}
        rows["flash_prefill serving"] = smoke.time_prefill(gen, *smoke.PREFILL_SERVING_SHAPE,
                                                           n_q=n_q, n_kv=n_kv, hd=hd)
        out[shape] = {
            case: {row: {k: t[k] for k in ("ms", "plain_ms", "library_ms", "library_backend",
                                           "bound_ms", "max_abs_err")}
                   for row, t in rows[case].items()} if case != "flash_prefill serving"
            else {k: rows[case][k] for k in ("ms", "plain_ms", "library_ms", "library_backend",
                                             "bound_ms", "gflop", "max_abs_err")}
            for case in rows}
    return out


def time_narrow_flash(smoke, gen) -> dict:
    """Row 5 at the narrow bf16 head dims 64 and 256 (kernel, SDPA, bound)."""
    shapes = {**smoke.QWEN_SHAPES, **smoke.WIDE_SHAPES}
    out = {}
    for model in ("qwen2.5-0.5b", "gemma-7b"):
        n_q, n_kv, hd = shapes[model]
        for name, (l, s, off) in (("serving", smoke.PREFILL_SERVING_SHAPE),
                                  ("L=S=2048", (2048, 2048, 0))):
            t = smoke.time_prefill(gen, l, s, off, n_q=n_q, n_kv=n_kv, hd=hd)
            out[f"{model} {name}"] = {k: t[k] for k in ("ms", "library_ms", "bound_ms")}
    return out


def time_beyond(smoke, gen) -> dict:
    """Rows 1, 2 (batch 8 x 2,048) and 5 (the serving chunk) at BEYOND_SHAPES:
    kernel, plain version, SDPA, bound."""
    out = {}
    for shape, (n_q, n_kv, hd) in smoke.BEYOND_SHAPES.items():
        rows = {row: smoke.time_decode(gen, row, "B=8 ctx=2048", n_q=n_q,
                                       n_kv=n_kv, hd=hd, combine=False)
                for row in ("paged_decode", "paged_decode_int8")}
        rows["flash_prefill serving"] = smoke.time_prefill(gen, *smoke.PREFILL_SERVING_SHAPE,
                                                           n_q=n_q, n_kv=n_kv, hd=hd)
        out[shape] = {row: {k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                      for row, t in rows.items()}
    return out


# The attention shapes beside the flagship's at which the combine reading
# times the four decode rows (chip_smoke.py's QWEN_SHAPES and WIDE_SHAPES).
COMBINE_TIMED = ("qwen2.5-7b", "qwen2.5-0.5b", "openllama-3b", "flagship-heads-512")


def tiled_launches_us(smoke, gen, row: str, shape: str, n_q: int, n_kv: int, hd: int,
                      calls: int = 20) -> dict:
    """A tiled row's call at a DECODE_SHAPES shape, split into its launches by
    torch.profiler over `calls` warm calls: device microseconds per call of
    the split pass and of the combine pass (kernel names holding
    "combine"), and the combine's launches per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch, ctx, table_ctx = smoke.DECODE_SHAPES[shape]
    q, pages, tables, lens = smoke.decode_inputs(
        gen, torch.bfloat16, batch, [ctx] * batch, smoke.PAGE, max_ctx=table_ctx,
        int8=smoke.DECODE_ROWS[row]["int8"], n_q=n_q, n_kv=n_kv, hd=hd)
    for _ in range(3):
        smoke.run_decode(row, q, pages, tables, lens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            smoke.run_decode(row, q, pages, tables, lens)
        torch.cuda.synchronize()
    out = dict(split_us=0.0, combine_us=0.0, combine_launches=0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        part = "combine" if "combine" in e.key else "split"
        out[f"{part}_us"] += e.self_device_time_total / calls
        if part == "combine":
            out["combine_launches"] += e.count / calls
    if out["split_us"] == 0.0:
        raise RuntimeError(f"{row} {shape}: the profiler recorded no device time")
    return out


def time_combine(smoke, gen) -> dict:
    """The combine reading (see the module's docstring)."""
    shapes = {"flagship": (smoke.N_Q, smoke.N_KV, smoke.HD), **smoke.QWEN_SHAPES,
              **smoke.WIDE_SHAPES}
    out = {}
    for model in ("flagship", *COMBINE_TIMED):
        n_q, n_kv, hd = shapes[model]
        dshapes = (tuple(smoke.DECODE_SHAPES) if model == "flagship"
                   else ("B=8 ctx=2048", "B=1 ctx=1536 table=2048"))
        for dshape in dshapes:
            r = {}
            if model != "flagship":
                r["ms"] = {row: smoke.time_decode(gen, row, dshape, plain=False, n_q=n_q,
                                                  n_kv=n_kv, hd=hd, combine=False)["ms"]
                           for row in smoke.DECODE_ROWS}
            r["launches_us"] = {row: tiled_launches_us(smoke, gen, row, dshape, n_q, n_kv, hd)
                                for row, spec in smoke.DECODE_ROWS.items()
                                if not spec["pipelined"]}
            smoke.log(f"  {model} {dshape}: {r}")
            out[f"{model} {dshape}"] = r
    return out


# The f32 reading's attention shapes (chip_smoke.py's QWEN_SHAPES and
# WIDE_SHAPES beside the flagship's) and the decode shapes each is timed at.
F32_TIMED = {
    "flagship": ("B=8 ctx=2048", "B=1 ctx=1536 table=2048", "B=1 ctx=4096"),
    "qwen2.5-7b": ("B=8 ctx=2048", "B=1 ctx=1536 table=2048"),
    "qwen2.5-0.5b": ("B=8 ctx=2048", "B=1 ctx=1536 table=2048"),
    "openllama-3b": ("B=8 ctx=2048",),
    "flagship-heads-512": ("B=8 ctx=2048", "B=1 ctx=1536 table=2048"),
}
F32_KEYS = ("ms", "plain_ms", "library_ms", "library_backend", "bound_ms", "mbytes",
            "max_abs_err")


def time_f32(smoke, gen) -> dict:
    """The f32 reading (see the module's docstring)."""
    import torch

    shapes = {"flagship": (smoke.N_Q, smoke.N_KV, smoke.HD), **smoke.QWEN_SHAPES,
              **smoke.WIDE_SHAPES}
    out = {}
    for model, dshapes in F32_TIMED.items():
        n_q, n_kv, hd = shapes[model]
        for dshape in dshapes:
            rows = out[f"{model} {dshape}"] = {}
            for row in smoke.DECODE_ROWS:
                t = smoke.time_decode(gen, row, dshape, n_q=n_q, n_kv=n_kv, hd=hd, combine=False,
                                      dtype=torch.float32)
                rows[row] = {k: t[k] for k in F32_KEYS}
    flash = (("L=S=2048", (2048, 2048, 0), "flagship"),
             ("serving", smoke.PREFILL_SERVING_SHAPE, "flagship"),
             (f"{smoke.WIDE_HEAD_MODEL} serving", smoke.PREFILL_SERVING_SHAPE,
              smoke.WIDE_HEAD_MODEL))
    for name, shape, model in flash:
        n_q, n_kv, hd = shapes[model]
        t = smoke.time_prefill(gen, *shape, n_q=n_q, n_kv=n_kv, hd=hd, dtype=torch.float32)
        out[f"flash_prefill {name}"] = {k: t[k] for k in (*F32_KEYS, "gflop") if k != "mbytes"}
    return out


READINGS = ("kernels", "flash", "wide", "host", "steps", "narrow_flash", "beyond", "combine",
            "f32")


def sass_functions(cuobjdump: str, lib: Path) -> dict:
    """{function: its SASS instructions} of a built library, with the
    anonymous-namespace tag (a hash of the source's path) dropped from the
    names and from the local labels that calls name, so that two checkouts'
    functions pair up, and each line's runs of spaces (cuobjdump pads to the
    longest label) made one."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    text = re.sub(r"_GLOBAL__N__\w+?_\d+\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_", text)
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and line.strip().startswith("/*"):
            funcs[name].append(" ".join(line.split()))
    return {name: "\n".join(lines) for name, lines in funcs.items()}


def sass_against(build, other: Path) -> dict:
    """The kernels of SASS_SOURCES up to head_dim 256 (no `wide` in the
    name), this tree's against those of the package under `other` (built
    here with this tree's flags into build/variants/<hash>/sass/): the
    functions alike, and those that differ or stand in one tree only."""
    nvcc = build.find_nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    out_dir = build.BUILD_DIR / "variants" / csrc_digest(other) / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
         str(other / PKG / "csrc" / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in SASS_SOURCES}
    report = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} of {other} failed to build:\n{log}")
        mine = {f: t for f, t in sass_functions(cuobjdump, build.library_path(name)).items()
                if "wide" not in f}
        theirs = {f: t for f, t in sass_functions(cuobjdump, out_dir / f"lib{name}.so").items()
                  if "wide" not in f}
        differ = sorted(f for f in mine.keys() & theirs.keys() if mine[f] != theirs[f])
        first = [(a, b) for a, b in zip(mine[differ[0]].splitlines(),
                                        theirs[differ[0]].splitlines()) if a != b][:8] if differ else []
        report[name] = dict(
            same=sum(mine[f] == theirs[f] for f in mine.keys() & theirs.keys()),
            differ=differ, first_differing_lines=first,
            only_here=sorted(mine.keys() - theirs.keys()),
            only_there=sorted(theirs.keys() - mine.keys()))
    return report


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package-root", type=Path, default=None,
                        help=f"directory holding the {PKG} to time")
    parser.add_argument("--sass-against", type=Path, default=None,
                        help=f"directory holding another {PKG}: compare the SASS of the "
                        "kernels up to head_dim 256 with its own")
    parser.add_argument("--build-only", action="store_true",
                        help="build the kernels of the package and take no reading")
    parser.add_argument("--readings", default=",".join(READINGS),
                        help=f"comma-separated readings to take, of {', '.join(READINGS)}")
    args = parser.parse_args()
    readings = args.readings.split(",")
    if not set(readings) <= set(READINGS):
        parser.error(f"unknown readings {sorted(set(readings) - set(READINGS))}")
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
    build_s = _build.build()
    smoke.log(f"  kernels built in {build_s:.2f} s (0: already built)")
    if args.build_only:
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": smi, "package_root": str(root), "build_s": build_s}
    if "kernels" in readings:
        times = {shape: {row: smoke.time_decode(gen, row, shape, plain=False, combine=False)
                         for row in smoke.DECODE_ROWS}
                 for shape in smoke.DECODE_SHAPES}
        out["ms"] = {shape: {row: t["ms"] for row, t in rows.items()}
                     for shape, rows in times.items()}
        out["sdpa_ms"] = {shape: rows["paged_decode"]["library_ms"]
                          for shape, rows in times.items()}
    if "flash" in readings:
        out["flash"] = {
            name: {k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            for name, t in (("L=S=2048", smoke.time_prefill(gen, 2048, 2048, 0)),
                            ("serving", smoke.time_prefill(gen, *smoke.PREFILL_SERVING_SHAPE)))}
    if "wide" in readings:
        out["wide"] = time_wide(smoke, gen)
    if "narrow_flash" in readings:
        out["narrow_flash"] = time_narrow_flash(smoke, gen)
    if "beyond" in readings:
        out["beyond"] = time_beyond(smoke, gen)
    if "combine" in readings:
        out["combine"] = time_combine(smoke, gen)
    if "f32" in readings:
        out["f32"] = time_f32(smoke, gen)
    if "host" in readings:
        out["wrapper_host_us"] = {row: wrapper_host_us(smoke, gen, row)
                                  for row in smoke.DECODE_ROWS}
        smoke.log(f"  wrapper host time per call, us: {out['wrapper_host_us']}")
    if "steps" in readings:
        cfg = smoke.llama.LlamaConfig(**smoke.FLAGSHIP)
        params = smoke.llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                         "cuda")
        out["decode_step"] = {("int8" if int8 else "bf16"): time_step(smoke, cfg, params, int8)
                              for int8 in (False, True)}
    out["sass"] = (None if args.sass_against is None
                   else sass_against(_build, args.sass_against.resolve()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
