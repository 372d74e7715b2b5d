"""Spawned ranks of the port's parallel tests (torch and the port only).

`spawn(scenario, world, tmp_path, *args)` starts `world` processes over
gloo on the CPU, rendezvous through a FileStore under `tmp_path` (never a
fixed TCP port): each runs `scenario(rank, world, *args)` and returns a
picklable result. Every child is joined under one time limit and killed
past it; a child that fails or hangs fails the caller with its traceback.
The children import neither jax nor the JAX package: the tests compute the
JAX side in the parent.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

JOIN_S = 120.0


def _child(rank: int, world: int, store: str, scenario: str, args, out: str) -> None:
    torch.set_num_threads(1)
    from llm_d_kv_cache_manager_tpu_torch.parallel import multihost

    try:
        multihost.initialize_distributed(init_method=f"file://{store}", world_size=world,
                                         rank=rank, backend="gloo")
        result = ("ok", globals()[scenario](rank, world, *args))
    except Exception:  # noqa: BLE001 - reported to the parent
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if result[0] == "ok":
        dist.barrier()
    os._exit(0)  # no teardown races between ranks of the gloo group


def spawn(scenario: str, world: int, tmp_path, *args, timeout: float = JOIN_S) -> list:
    """Each rank's result of `scenario` (a function of this module)."""
    tmp = Path(tmp_path) / f"{scenario}-{world}-{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    outs = [str(tmp / f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_child, args=(r, world, str(tmp / "store"), scenario, args,
                                              outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results, errors = [], []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit code {procs[r].exitcode})")
            continue
        with open(path, "rb") as f:
            kind, value = pickle.load(f)
        if kind == "error":
            errors.append(f"rank {r}:\n{value}")
        results.append(value)
    if hung or errors:
        raise AssertionError(f"{scenario} x {world}: hung ranks {hung}; " + "\n".join(errors))
    return results


# -- helpers -------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tree(np_params):
    from llm_d_kv_cache_manager_tpu_torch.models import llama

    return llama.params_from_jax(np_params, device="cpu")


def _event_rows(batches):
    return [tuple(e.to_tagged_union()) for b in batches for e in b.events]


# -- tp serving ------------------------------------------------------------------


def tp_serving(rank: int, world: int, cfg_kw: dict, params_by_seed: dict, pod_kw: dict,
               prompts: list, max_new: int) -> dict:
    """Every tp serving scenario of the reference's tp tests on this rank of
    a tp=world group: the ops (prefill + 3 decodes on both page formats,
    verify, multi-step decode), then a tp pod's scheduler, events, prefix
    reuse and page shards."""
    from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
    from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler
    from llm_d_kv_cache_manager_tpu_torch.models import llama
    from llm_d_kv_cache_manager_tpu_torch.parallel import serving
    from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import MeshCoords

    group = dist.group.WORLD
    cfg = llama.LlamaConfig(**cfg_kw, dtype=torch.float32)
    at = MeshCoords({"tp": world}, {"tp": rank})
    out = {}

    def sharded(seed, make, n_pages, page):
        params = serving.shard_serving_params(_tree(params_by_seed[seed]), at)
        cache = serving.shard_kv_cache(make(cfg, n_pages, page, "cpu"), at)
        return params, cache

    for quantized in (False, True):
        make = llama.make_kv_pages_quantized if quantized else llama.make_kv_pages
        params, cache = sharded(0, make, 16, 4)
        prompt = torch.arange(10, dtype=torch.int32)
        table = torch.arange(4, dtype=torch.int32)
        cache, logits = llama.prefill_cache(cfg, params, cache, prompt, table, 0, group=group)
        seq = [_np(logits)]
        tok = torch.argmax(logits)[None].to(torch.int32)
        for i in range(3):
            cache, logits = llama.decode_step_cache(
                cfg, params, cache, tok, table[None], torch.tensor([10 + i], dtype=torch.int32),
                group=group)
            seq.append(_np(logits[0]))
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out["serving_int8" if quantized else "serving"] = seq
        out["heads_int8" if quantized else "heads"] = [tuple(c.shape) for c in cache]

    params, cache = sharded(1, llama.make_kv_pages, 16, 4)
    for t, tab in ((torch.arange(6), [0, 1, 2, 3]), (torch.arange(20, 29), [4, 5, 6, 7])):
        cache, _ = llama.prefill_cache(cfg, params, cache, t.to(torch.int32),
                                       torch.tensor(tab, dtype=torch.int32), 0, group=group)
    _, logits = llama.verify_step_cache(
        cfg, params, cache, torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32),
        torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32),
        torch.tensor([6, 9], dtype=torch.int32), group=group)
    out["verify"] = _np(logits)

    params, cache = sharded(2, llama.make_kv_pages, 17, 4)
    table = torch.arange(4, dtype=torch.int32)
    cache, logits = llama.prefill_cache(cfg, params, cache, torch.arange(7, dtype=torch.int32),
                                        table, 0, group=group)
    pending = torch.argmax(logits)[None].to(torch.int32)
    _, toks = llama.decode_multi_step_cache(
        cfg, params, cache, pending, table[None], torch.tensor([7], dtype=torch.int32),
        torch.tensor([12], dtype=torch.int32), 16, 5, group=group)
    out["multi_step"] = toks[0].tolist()

    def pod(events=None):
        return EnginePod(
            EnginePodConfig(**pod_kw, model_config=cfg, device="cpu", tp=world, group=group),
            event_sink=None if events is None else events.append,
            params=_tree(params_by_seed[0]),
        )

    events = []
    sched = Scheduler(pod(events), max_batch=4)
    ids = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    results = sched.run()
    out["scheduler"] = [results[i] for i in ids]
    out["scheduler_events"] = _event_rows(events)

    p = pod()
    state, cached = p.prefill(list(range(12)))
    p.free(state)
    state2, cached2 = p.prefill(list(range(12)))
    p.free(state2)
    out["prefix_reuse"] = (cached, cached2)

    events = []
    p = pod(events)
    state, _ = p.prefill(list(range(10)))
    first = int(p.choose(torch.argmax(p.last_logits)))
    p.decode_append(state, first)
    for _ in range(4):
        p.decode_step(state)
    out["pod_tokens"] = list(state.tokens)
    out["pod_heads"] = [tuple(c.shape) for c in p.kv_cache]
    p.free(state)
    out["pod_events"] = _event_rows(events)
    return out


# -- ring attention, pipeline, multihost ---------------------------------------


def p2p(rank: int, world: int, ring_cases: list, long_case, pipe_case) -> dict:
    """Ring attention at sp = world and at sp 2 (a subgroup of ranks 0 and
    1), the long-context case at sp = world, the pipeline's two-stage cases
    on the same subgroup, and the hybrid mesh helpers."""
    from llm_d_kv_cache_manager_tpu_torch.models import llama
    from llm_d_kv_cache_manager_tpu_torch.parallel import multihost
    from llm_d_kv_cache_manager_tpu_torch.parallel.pipeline import pipeline_forward
    from llm_d_kv_cache_manager_tpu_torch.parallel.ring_attention import ring_attention

    pair = dist.new_group([0, 1])  # every rank takes part in making it
    out = {"ring": {}, "pipeline": {}}

    def ring(q, k, v, n, group):
        chunk = q.shape[1] // n
        part = slice(rank * chunk, (rank + 1) * chunk)
        got = ring_attention(*(torch.from_numpy(a[:, part]) for a in (q, k, v)), group=group)
        return _np(got)

    for n, (q, k, v) in ring_cases:
        if n == world:
            out["ring"][n] = ring(q, k, v, n, dist.group.WORLD)
        elif rank < n:
            out["ring"][n] = ring(q, k, v, n, pair)
    out["long"] = ring(long_case, long_case, long_case, world, dist.group.WORLD)

    cfg_kw, np_layers, x, micro_counts = pipe_case
    cfg = llama.LlamaConfig(**cfg_kw, dtype=torch.float32)
    layers = _tree(np_layers)
    for n_micro in micro_counts:
        if rank < 2:
            xm = torch.from_numpy(x).reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
            out["pipeline"][n_micro] = _np(pipeline_forward(cfg, layers, xm, pair))

    # The hybrid mesh: axes, shape, and a sum over the mesh's shards.
    mesh = multihost.make_hybrid_mesh({"tp": 2}, {"dp": 2}, device="cpu")
    full = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    d, t = mesh.get_local_rank("dp"), mesh.get_local_rank("tp")
    part = full.chunk(2, 0)[d].chunk(2, 1)[t].sum().reshape(1)
    dist.all_reduce(part)
    out["hybrid"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape), float(part))
    try:
        multihost.make_hybrid_mesh({"tp": 8}, {"dp": 2}, device="cpu")
        out["too_many"] = None
    except ValueError as e:
        out["too_many"] = str(e)
    ici = multihost.make_hybrid_mesh({"tp": world}, device="cpu")
    out["ici"] = tuple(ici.mesh_dim_names)
    out["again"] = multihost.initialize_distributed() is dist.group.WORLD
    return out


# -- training ------------------------------------------------------------------


def train_dp_tp(rank: int, world: int, cfg_kw: dict, np_params: dict, batch: np.ndarray,
                moe_kw: dict, moe_params: dict, moe_batch: np.ndarray) -> dict:
    """A dp 2 x tp 2 llama train step and an ep 2 x tp 2 Mixtral train step,
    f32: each rank's loss and its shard of the new params; and the
    DeviceMesh's shard_params against MeshCoords'."""
    from llm_d_kv_cache_manager_tpu_torch.models import llama, mixtral
    from llm_d_kv_cache_manager_tpu_torch.parallel import mesh as pmesh

    out = {}
    m = pmesh.make_mesh(dp=2, tp=2, device="cpu")
    at = pmesh.mesh_coords(m)
    cfg = llama.LlamaConfig(**cfg_kw, dtype=torch.float32)
    params = pmesh.shard_params(_tree(np_params), m)
    by_coords = pmesh.shard_params(_tree(np_params), pmesh.MeshCoords(at.sizes, at.coords))
    out["mesh_shards_equal"] = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(llama._leaves(params),
                                                     llama._leaves(by_coords)))
    rows = pmesh.batch_sharding(torch.from_numpy(batch), m)
    new, loss = llama.train_step(cfg, params, rows, group=m.get_group("tp"),
                                 dp_group=m.get_group("dp"))
    out["coords"] = at.coords
    out["loss"] = float(loss)
    out["new"] = {"/".join(p): _np(t) for p, t in llama._leaves(new)}

    # Mixtral on the same four ranks: "ep" runs along the mesh's "dp" dim.
    moe_mesh = pmesh.MeshCoords({"ep": 2, "tp": 2}, {"ep": at.coords["dp"], "tp": at.coords["tp"]})
    moe_cfg = mixtral.MixtralConfig(**moe_kw, dtype=torch.float32)
    moe = mixtral.shard_params(_tree(moe_params), moe_mesh)
    new, loss = mixtral.train_step(moe_cfg, moe, torch.from_numpy(moe_batch),
                                   group=m.get_group("tp"), ep_group=m.get_group("dp"))
    out["moe_loss"] = float(loss)
    out["moe_new"] = {"/".join(p): _np(t) for p, t in llama._leaves(new)}
    return out
