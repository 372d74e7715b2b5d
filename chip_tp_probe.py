#!/usr/bin/env python3
"""Probe what one CUDA card offers two torch.distributed ranks.

    python3 chip_tp_probe.py     # needs one CUDA card

Spawns two processes on cuda:0 twice. First over gloo: all_reduce,
broadcast and all_gather of CUDA tensors, a send/recv of a CUDA tensor, and
the time of an all_reduce of one decode tick's row-parallel sum (batch 8 x
2,048 bf16). Then over nccl: an all_reduce, which NCCL is expected to refuse
with both ranks on one device. Each child is joined under a time limit and
killed past it. Each rank prints its own JSON line as it goes; then one JSON
object per backend and the card's name and power limit. Exits non-zero when
gloo's all_reduce or broadcast of CUDA tensors fails.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

JOIN_S = 120.0


def _try(fn):
    try:
        return {"ok": True, "value": fn()}
    except Exception as e:  # noqa: BLE001 - the probe reports every failure
        return {"ok": False, "error": f"{type(e).__name__}: {e}"[:600]}


def _gloo(rank: int, store_path: str, out) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store_path}", rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    res = {}

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        return t.tolist()

    def broadcast():
        t = torch.full((4,), float(rank + 7), device=dev)
        dist.broadcast(t, src=0)
        torch.cuda.synchronize()
        return t.tolist()

    def all_gather():
        t = torch.full((2,), float(rank), device=dev)
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        torch.cuda.synchronize()
        return torch.cat(parts).tolist()

    def send_recv():
        t = torch.full((2,), float(rank), device=dev)
        if rank == 0:
            dist.send(t, 1)
        else:
            dist.recv(t, 0)
        torch.cuda.synchronize()
        return t.tolist()

    def tick_all_reduce_ms():
        t = torch.randn(8, 2048, device=dev).to(torch.bfloat16)
        for _ in range(3):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather), ("tick_all_reduce_ms", tick_all_reduce_ms)):
        res[name] = _try(fn)
        dist.barrier()
    print(json.dumps({"gloo_rank": rank, **res}), flush=True)
    res["send_recv"] = _try(send_recv)  # last: a failure may abort the process
    print(json.dumps({"gloo_rank": rank, "send_recv": res["send_recv"]}), flush=True)
    out.put((rank, res))
    dist.destroy_process_group()


def _nccl(rank: int, store_path: str, out) -> None:
    torch.cuda.set_device(0)
    res = {}

    def all_reduce():
        dist.init_process_group("nccl", init_method=f"file://{store_path}", rank=rank,
                                world_size=2, device_id=torch.device("cuda", 0))
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        return t.tolist()

    res["all_reduce"] = _try(all_reduce)
    print(json.dumps({"nccl_rank": rank, **res}), flush=True)
    out.put((rank, res))
    out.close()
    out.join_thread()
    os._exit(0)  # a refused communicator may not tear down cleanly


def run(target) -> dict:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=target, args=(r, store, out)) for r in range(2)]
        for p in procs:
            p.start()
        results, deadline = {}, time.monotonic() + JOIN_S
        while len(results) < 2 and time.monotonic() < deadline:
            try:
                rank, res = out.get(timeout=1.0)
                results[rank] = res
            except Exception:  # noqa: BLE001 - queue.Empty; poll the deadline
                if not any(p.is_alive() for p in procs) and out.empty():
                    break
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join()
        return {"results": results, "exitcodes": [p.exitcode for p in procs],
                "timed_out": len(results) < 2}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tp_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    try:
        gloo = run(_gloo)
    except Exception:  # noqa: BLE001
        gloo = {"error": traceback.format_exc()}
    print(json.dumps({"gloo": gloo}))
    nccl = run(_nccl)
    print(json.dumps({"nccl": nccl}))
    ranks = gloo.get("results", {})
    # A gloo send of a CUDA tensor may abort its rank, so one rank's report
    # of the collectives is enough (each rank also prints its own line).
    ok = bool(ranks) and all(r["all_reduce"]["ok"] and r["broadcast"]["ok"]
                                 for r in ranks.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
