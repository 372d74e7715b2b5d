#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card
    python3 chip_smoke.py --phases 3,9  # a development run of some phases
                                        # (no kernels or ok line)
    python3 chip_smoke.py --phases 3,4,13  # the kernels' shapes and the
                                           # Qwen2 family
    python3 chip_smoke.py --phases 12a,14a,14b  # the control plane and the
                                                # read plane
    python3 chip_smoke.py --phases 15a,15b  # the fleet's resilience plane
                                            # (15b runs 12a first)
    python3 chip_smoke.py --phases 16a,16b,16c  # the workload engine and the
                                                # proactive planes
    python3 chip_smoke.py --phases 17a,17b,17c,17d  # the fleet planes' second
                                                    # half
    python3 chip_smoke.py --phases 18a  # the HTTP scoring service in front
                                        # of 16a's precise arm
    python3 chip_smoke.py --phases 19a,19b  # a tp = 2 pod in two processes
                                            # on one card, and the train step

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
     of 4), windows, GQA groups 1-8, 12 and 16 (two chunks of the group
     over one kv head) at head_dim 128 and groups 1-12 at 64, sequences
     short enough to leave splits and cluster ranks empty, a window inside
     one split's share or inside a page's second stage, every decode case
     again at both Qwen2.5 attention shapes (28/4 heads of 128, 14/2 of 64:
     group 7), prefix-hit offsets, padded chunks, per-batch offsets, both
     flash tile plans, flash at head_dim 64 and at group 7, the
     speculative verify's shape: 8 rows of 2, 5 or 9 new tokens at offsets
     that are no multiple of a tile, one offset 0, a window), the
     tiled decode against the pipelined one at f32 on both page formats, and
     two calls of each decode kernel for bf16 q (both page formats, the
     flagship's and both Qwen2.5 shapes) bit for bit;
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
     cached, over the 2,048-position table); every row again at both
     Qwen2.5 attention shapes (decode at batch 8 x 2,048 and at the serving
     shape, prefill at the serving chunk); rows 1, 2 and 5 again at a tp = 2
     rank's shape (8/4 heads of 128: decode at batch 8 x 2,048, prefill at
     the serving chunk);
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
  12a. the control plane at a fleet's size, host only: 16 simulated pods of
     28,672 blocks of 16 (64 shared 64-block prefixes, each held by 4 pods,
     and unique tails; 10% of each pod's blocks then removed), made from
     --seed, as msgpack bytes from the port's own codec through the
     EventPool's 4 workers into IndexConfig.default()'s ShardedIndex; the
     index must hold exactly the (key, pod) pairs of a plain replay, 1,024
     prompt chains scored by score_many (word prompts through the
     tokenization pool, its prefix-store shortcut off; each must derive its
     whole chain, none shed) and one
     by one by score_hashes must equal the plain longest prefix, nothing
     dropped or lost; digestion rate, drain and read-path times are logged;
     a run past 60 s is made again at the pod count its time scales to,
     and the cut is printed;
  12b. four bf16 flagship pods (640 pages each, one set of weights) whose
     event sinks pack their batches into one EventPool, routed by the full
     Indexer (a word-level Tokenizer through the `tokenizer=` seam, the LRU
     prefix store, the chain memo): 4 waves of 8 requests (8 system prompts
     of 1,024 tokens, each request one of them and a 256-token turn of its
     own, 16 greedy tokens) through each pod's Scheduler, once routed to the
     top get_pod_scores pod (ties round robin) and once round robin on fresh
     pods, each pod's share of a wave served batched (max_batch 8) and then,
     on fresh pods, each request alone; after every wave each pod's indexed
     blocks equal its committed pages and each precise request's cached
     tokens equal 16 x the index's match_blocks for its pod; served alone,
     every request's greedy tokens equal those of a pod that never evicts;
     batched, they pass phase 7b's teacher-forced bar; the batched runs' hit
     rates and TTFTs, drain and read-path times are logged. Neither phase imports zmq, msgpack, xxhash or tokenizers:
     the ZMQ hop is checked in tier-1 (tests/test_torch_zmq.py);
  13. the Qwen2 family at its published widths, whole (no depth cut):
     Qwen2.5-7B (28 layers, 28/4 heads of 128, 152,064 tokens, untied head)
     and Qwen2.5-0.5B (24 layers, 14/2 heads of 64, tied head), configs
     through the port's hf_loader.config_from_hf, seeded weights and q/k/v
     biases, bf16. Per model: 13a, a bf16 pod and an int8 pod (page 16)
     whose events one Indexer digests, 8 requests each of 1,024 shared +
     512 unique tokens: cached tokens 0 then 1,024, each pod ranked first
     for its own prefix, launches per layer pass; 13b, phase 5c's
     prefill-logits and phase 6's batch-8 x 2,048 decode-logits checks
     (every page format and decode kernel) against an f32 truth; 13c, phase
     7b's traffic through the Scheduler on a bf16 pod at decode_steps 1 and
     an int8 pod at 4 with its checks and teacher-forced bar, tokens/s and
     tick walls logged;
  14a. (run right after 12a, on its stream) the control plane over the
     native index, host only: 12a's fleet as msgpack bytes through the
     EventPool into IndexConfig(native=True), the C arena built from
     native/kvscore.c (with the C hash core, native/fnvcbor.c) into the
     package's build/ directory; the index must hold the plain replay's
     (key, pod) pairs, the arena must count every stored and removed block,
     and score_many (one native crossing a batch) and score_hashes must
     equal the plain longest prefix and phase 12a's ShardedIndex scores on
     the 1,024 chains, with no fallback to the Python path; then the same
     stream into the cost-aware index, with a budget that holds it all
     (contents = the replay) and with a quarter of those bytes (held bytes
     within the budget, every kept entry in the replay or a tail keyed
     from the root after its parent's mapping was evicted); the native
     digestion rate is logged beside 12a's; cut like 12a past 60 s;
  14b. (run right after 12b) chat requests over four bf16 flagship pods
     (640 pages each, host tiers that always transfer, eager staging, a
     transfer server and an index-backed peer resolver each) behind the
     native index: the committed template (tests/fixtures/chat) renders
     the fixture strings tier-1 holds against transformers; 3 turns of 8
     conversations on 12b's system prompts and a cohort of 8 new users on
     one of them (4 waves of 8), each a RenderRequest scored by
     get_pod_scores_ex and routed by RoutingPolicy.select (load blend,
     weight 1, from each pod's Scheduler queue depth at an explicit `now`)
     or by the top score, the chosen pod's missing tail handed over by the
     RoutePrefetcher before the wave is served; served batched under both
     policies and alone under load blend. Bars: each turn's tokens extend
     the last's; the prefetcher fetches exactly the peer-held head of each
     missing tail; every admission's cached tokens = 16 x (device blocks
     the index predicted + blocks landed); after each wave every pod's gpu
     entries = its committed pages and its cpu entries = its host store;
     every choice = the plain recomputation of the policy, overrides
     counted; alone, greedy tokens = a never-evicting pod bit for bit;
     batched, phase 7b's teacher-forced bar; hit rate, TTFT, prefetched
     and landed blocks, render, read-path and route times are logged;
  15a. (run right after 14b) the fleet's resilience plane around four bf16
     flagship pods (640 pages each) behind one EventPool and Indexer, on a
     fake clock one step a wave: 8 waves of 12b's traffic, each wave scored
     in one score_many call and routed precisely (top score, ties and no
     cache signal to the wave's least loaded pod), each pod's share served
     batched; the pods' messages reach the pool through a FaultInjector
     under a seeded FaultPlan (a pod crashes and restarts cold, a pod's
     stream stalls and resumes, a pod's stream drops, duplicates and
     reorders, a pod is wiped without a removal event). Three arms: no
     faults with the plane wired (FleetHealthTracker through the Indexer's
     fleet_health= and the pool's health_tracker=, AntiEntropyTracker
     through antientropy= and divergence=, a ResidencyAuditor over the
     pods' resident_block_digest after every wave), the plan with the plane,
     the plan without it. Bars: without faults, the scores and routes equal
     an Indexer without the plane over the same index, and the plane acts
     on nothing; with the plan, the crashed and stalled pods go stale within
     stale_after_s plus one step and recover when their streams resume, a
     quarantine purges exactly the pod's indexed entries, the tracker's gap,
     duplicate and reorder counts equal the injector's, no score names a
     stale pod and no request goes to one by its score, after every audit
     from the wipe on every pod's indexed (key, tier) set equals its
     committed pages (a stale pod's is empty), and from then on every
     request's cached tokens equal 16 x the index's match_blocks; the
     control arm's phantom routes, each arm's hit rate and TTFT median are
     logged;
  15b. (host only) the resource governor and the departure reaper over 12a's
     digested index: meters on the index, the chain memo, the prefix store,
     fleet health, load and anti-entropy; a governor whose budget holds
     everything journals and sheds nothing; a third of the pods leave
     (quarantined: purged, then reaped from every per-pod map and the
     resolver's negative cache) and join again (their streams digested
     again: the index equals the replay); then a governor at a quarter of the
     accounted bytes: after its ticks the accounted bytes are within the
     budget, its journal follows SHED_LADDER's order with the index shed
     only at critical, what the index holds is a subset of the replay, and
     score_hashes on 12a's 1,024 chains equals the plain longest prefix over
     the index as it stands;
  16a. (run right after 15a) the ShareGPT replay: the port's workload engine
     generates benchmarking/fleet_device_bench.py's SHAREGPT_FULL trace
     (24 sessions of at most 8 turns, four system-prefix groups, 76
     requests) and its JSONL's sha256 must be the reference's; four bf16
     flagship pods with the bench's v2 capacity (1,536 pages, 704 a
     sequence; 16 new tokens at decode_steps 8, prefill budget 4,096)
     behind one EventPool and Indexer (a word-level text tokenizer: the
     card has no `tokenizers`) serve it open-loop on a virtual per-pod
     clock (TTFT = queue wait + measured time to first token), routed
     precisely (the top score, ties to the lowest pod, no signal round
     robin) and round robin. Bars: each precise request's cached tokens =
     16 x the top pod's match_blocks; after the replay every pod's indexed
     blocks = its committed pages; 16 seeded precise requests' greedy
     tokens = a never-evicting pod's. Hit rate, TTFT p50/p90/mean, queue
     wait and service p50 per arm are logged beside BASELINE.json's
     targets;
  16b. hot-prefix placement: tests/test_placement.py's multi-tenant trace
     (3 tenants, Zipf 2, 16 sessions of at most 2 turns) over four pods
     with host tiers (256 pages, 512 host blocks, the cost gate off, eager
     staging), arms off, observe-only (an unreachable threshold) and on (2
     replicas, threshold 3, cooldown 2 s): the popularity tracker on the
     Indexer, the HotPrefixReplicator ticked at every arrival on a fake
     clock, its jobs through a RoutePrefetcher into prefetch_hashes and
     warm_chain. Bars: observe-only = off (routes, cached and greedy
     tokens, event streams); on, replicated blocks and jobs > 0, no
     unhealthy target, no drop; every pod's gpu entries = its pages and cpu
     entries = its host store after every request;
  16c. session prediction: tests/test_prediction.py's churn scenario (s0
     with a 420-word prefix at 0 s, 24 junk sessions of 500 words from 1
     s, s0's second turn at 12 s) on pods of 192 pages and 2,048 host
     blocks, arms off, observe-only and on (the SessionTable on the
     Indexer, the PrefetchScheduler ticked at every arrival, its jobs into
     the router's pick's prefetch_hashes and warm_chain). Bars:
     observe-only = off; off, s0's first-turn blocks resident before its
     second turn are fewer than its blocks; on, more are resident and
     blocks were pre-landed; the second turn's greedy tokens = a
     never-evicting pod's in every arm; its TTFT is logged. The whole run
     takes 16b's and 16c's off and on arms only (`FULL_RUN_PROACTIVE_ARMS`,
     cut to make room for 18a): observe-only = off is held by
     `--phases 16b` / `--phases 16c` and by tier-1's rehearsals;
  17a. (inside 16a's precise arm) the replicated indexers: 3 IndexerReplicas
     (each an Indexer, an EventPool gated by ReplicaPartitioner.accepts, a
     FleetHealthTracker for its seq watermarks) get every message the
     arm's pool gets. Bars: for every request a ClusterScorer over them
     gives the Indexer's scores, match blocks and chain, and a
     single-region GlobalRouter over the Indexer the same pod; halfway,
     the replica holding the most entries snapshots (CBOR), shuts down,
     misses a request's messages and restarts warm from the file and the
     journal since its 8th last message (the seq floors drop exactly
     those 8), then holds exactly the Indexer's entries of its pods; after
     the replay the replicas' union is the Indexer's entries;
  17b. bench.py --geo's federation cut to two regions of two bf16 flagship
     pods (16a's pods; each region an Indexer, an EventPool and a
     popularity tracker behind a Region) under one GlobalRouter on a fake
     clock: the geo trace of 16 sessions (48 requests), digests at every
     4 s, region-0 lost at 0.55 of the span (no digest, its front raises).
     Bars: region-0 is suspect and then stale exactly when its last digest
     is 8 and 12 s old, detected at the first reading from then on; no
     request delegated to it after that; every failover and retry goes to
     the rendezvous successor; every request's cached tokens = 16 x its
     pod's match_blocks; 12 seeded requests' greedy tokens = a
     never-evicting pod of their region's;
  17c. phase 8's peer onboard under kv_connectors/faults.py's injector (the
     onboarding pod's client wrapped in FaultyTransport), bf16 and int8
     pages. Corrupt, integrity on: the damaged blocks are the seeded draw's,
     each detected, none admitted; the pod onboards the blocks before the
     first and recomputes the rest, and P' (suffix logits, 32 greedy
     tokens) equals a never-evicting pod that served those blocks first.
     Integrity off: every damaged block admitted. Stall (3 requests): the
     breaker opens after 2 charged timeouts, the next fetch is skipped
     uncharged, and every answer equals the never-evicting pod's
     recompute;
  17d. (inside 15a) an AutopilotController (an SLOMonitor of the requests
     whose cached share fell under half, the anti-entropy tracker, the
     auditor's cadence knob) on 15a's fake clock: on the no-fault arm, no
     actuation and the knob at its baseline (the same scores, routes,
     cached and greedy tokens as the arm without it is held by tier-1's
     rehearsal and by `--phases 17d`, which runs that arm too: a cut of the
     whole run, printed); a fourth arm, the plan with the plane and the
     autopilot: actuations, each within its knob's bounds and one max_step,
     journaled, the knob back at baseline after the faults, and 15a's
     bars;
  18a. (inside 16a's precise arm, beside 17a) the port's HTTP scoring
     service (api/http_service.py's ScoringService over its own Indexer,
     the index metrics-instrumented, tracing on, admission at its
     defaults) on 127.0.0.1 over a real socket: every message of the pods
     also goes into the service's EventPool, in process and in order, and
     each precise request is routed by its POST /score_completions answer
     (http.client, a timeout). Bars: every answer equals the Indexer's
     scores; one POST /score_completions/batch of all the prompts equals
     that many single calls; 4 /debug/score_explain answers equal
     /score_completions; /metrics parses as the text format 0.0.4 and its
     lookup, admission, eviction and drop counts and the lookup-latency
     histogram's count moved by what the CPU rehearsal predicts
     (`SERVICE_PREDICTED`); /health is ok and /readyz 200 with the
     predicted pod states; /debug/traces holds one read trace per request
     (each carrying its X-Kvtpu-Trace id) with the read path's spans in the
     reference's order (`SERVICE_READ_SPANS`); /debug/critical_path has the
     scoring root's row;
  19a. a tensor-parallel flagship pod of two ranks: two spawned processes on
     the one card over a gloo group (NCCL refuses two ranks on one device),
     each with the seeded weights' Megatron shard and its 4 of the 8 KV
     heads of every page, the paged paths all-reducing after wo and w_down
     and gathering the vocab-parallel logits, rank 0's tokens broadcast
     each tick; ten requests (phase 5's shape: 1,024 shared + 512 unique
     tokens, 16 greedy tokens) through the Scheduler on bf16 pages at
     decode_steps 1 and int8 pages at 4, against a tp = 1 pod on the same
     weights in this process. Bars: rank 0's BlockStored/BlockRemoved
     stream equals the tp = 1 pod's and rank 1 publishes nothing; the
     second request on caches 1,024 tokens; on each rank the prefix-hit
     prefill's logits (phase 5c's) and batch-8 decode logits (phase 6's,
     both page formats) within 2 x the bf16 plain path's error + 1e-2 of
     the f32 truth; every served token inside phase 7b's teacher-forced
     bar; each rank's pages hold 4 heads and both ranks' block tables and
     tokens are equal every tick; a rank that fails or hangs fails the
     phase (joined under a time limit, each collective bounded). A decode
     tick's wall at tp 1 and 2 and the collectives' share are logged;
  19b. the SGD train step on the flagship (bf16 params, batch 4 x 512
     tokens from a seed) against an f32 twin: the step-0 loss within a
     relative 1e-2, each tensor's gradient (each layer's slice of a
     stacked weight) by relative norm error under the stated bar, and the
     loss falling over 5 steps; step wall and tokens/s logged;
  then a JSON line of details, one JSON line describing every kernel, and
  last: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import http.client
import io
import itertools
import json
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from llm_d_kv_cache_manager_tpu_torch import obs
from llm_d_kv_cache_manager_tpu_torch.api import http_service
from llm_d_kv_cache_manager_tpu_torch.api.web import AppServer
from llm_d_kv_cache_manager_tpu_torch.autopilot import (
    AutopilotConfig,
    AutopilotController,
    KnobRegistry,
    SignalAssembler,
)
from llm_d_kv_cache_manager_tpu_torch.antientropy import (
    AntiEntropyTracker,
    AuditorConfig,
    ResidencyAuditor,
)
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
from llm_d_kv_cache_manager_tpu_torch.cluster import (
    ClusterConfig,
    ClusterScorer,
    IndexerReplica,
    LocalReplicaTransport,
    ReplicaPartitioner,
)
from llm_d_kv_cache_manager_tpu_torch.engine.tiering import IndexBackedPeerResolver
from llm_d_kv_cache_manager_tpu_torch.federation import (
    FederationConfig,
    GlobalRouter,
    Region,
    RegionFailoverTracker,
    derive_fn_from_indexer,
    encode_digest,
)
from llm_d_kv_cache_manager_tpu_torch.fleethealth.faults import (
    FaultInjector,
    FaultPlan,
    PodFaults,
)
from llm_d_kv_cache_manager_tpu_torch.fleethealth.load import PodLoadTracker
from llm_d_kv_cache_manager_tpu_torch.fleethealth.tracker import (
    HEALTHY,
    STALE,
    FleetHealthConfig,
    FleetHealthTracker,
)
from llm_d_kv_cache_manager_tpu_torch.kv_connectors.faults import (
    FaultyTransport,
    PeerTransferFaults,
    TransferFaultPlan,
)
from llm_d_kv_cache_manager_tpu_torch.kv_connectors.prefetch import RoutePrefetcher
from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import (
    Indexer,
    IndexerConfig,
    ScoreRequest,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import hashing, native_index
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.cost_aware import (
    CostAwareIndexConfig,
    CostAwareMemoryIndex,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import (
    InMemoryIndex,
    InMemoryIndexConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import IndexConfig
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.native_index import NativeScoringIndex
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.sharded import ShardedIndex
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.routing import RoutingPolicy, RoutingPolicyConfig
from llm_d_kv_cache_manager_tpu_torch.kvevents.digest import digest_batch
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import (
    BlockRemoved,
    BlockStored,
    EventBatch,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import EventPool, EventPoolConfig, Message
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics_collector
from llm_d_kv_cache_manager_tpu_torch.models import hf_loader, llama, lora, mixtral
from llm_d_kv_cache_manager_tpu_torch.obs.slo import (
    OBJECTIVE_HIT_RATE,
    SLOConfig,
    SLOMonitor,
    SLOObjective,
)
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
from llm_d_kv_cache_manager_tpu_torch.parallel import multihost
from llm_d_kv_cache_manager_tpu_torch.parallel import serving as tp_serving
from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import MeshCoords
from llm_d_kv_cache_manager_tpu_torch.placement import (
    ChainPopularityTracker,
    HotPrefixReplicator,
    PopularityConfig,
    ReplicationConfig,
)
from llm_d_kv_cache_manager_tpu_torch.prediction import (
    PredictionConfig,
    PrefetchScheduler,
    SchedulerConfig,
    SessionTable,
)
from llm_d_kv_cache_manager_tpu_torch.preprocessing.chat_completions import (
    ChatTemplatingProcessor,
    RenderRequest,
)
from llm_d_kv_cache_manager_tpu_torch.resourcegov import (
    LEVEL_CRITICAL,
    LEVEL_OK,
    SHED_LADDER,
    STRUCT_ANTIENTROPY,
    STRUCT_CHAIN_MEMO,
    STRUCT_FLEETHEALTH,
    STRUCT_INDEX,
    STRUCT_LOAD,
    STRUCT_PREFIX_STORE,
    DepartureReaper,
    Meter,
    ResourceAccountant,
    ResourceGovConfig,
    ResourceGovernor,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.pool import (
    TokenizationPool,
    TokenizersPoolConfig,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizer import (
    TokenizationResult,
    Tokenizer,
)
from llm_d_kv_cache_manager_tpu_torch.workloads import (
    GeoConfig,
    MaterializedRequest,
    MultiTenantConfig,
    ShareGPTConfig,
    generate_geo,
    generate_multitenant,
    write_trace,
)
from llm_d_kv_cache_manager_tpu_torch.workloads import generate as generate_sharegpt
from llm_d_kv_cache_manager_tpu_torch.workloads.synthetic import text as synthetic_text

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
# Phase 13's models at their attention shapes (n_q, n_kv, head_dim): GQA
# group 7 at head_dim 128 and at 64.
QWEN_SHAPES = {"qwen2.5-7b": (28, 4, 128), "qwen2.5-0.5b": (14, 2, 64)}
# Their cases of each kernel at the main path's shape, as MAIN_CASES.
QWEN_MAIN_CASES = {
    model: {**{row: f"{row} bf16 {model} B=8" for row in DECODE_ROWS},
            "flash_prefill": f"flash_prefill bf16 {model} L=S=2048 off=0"}
    for model in QWEN_SHAPES
}
# Decode groups held at head_dim 128 beside 1, 4 and 8: 3-7 in one CTA; 12
# and 16 in two even chunks; 13 in chunks of 7 and 6 rows (a partial last
# chunk); 64, the largest, in 8 chunks. And at head_dim 64.
DECODE_GROUPS = (3, 5, 6, 7, 12, 13, 16, 64)
HD64_GROUPS = (1, 2, 4, 7, 8, 12, 13)


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
            for n_q in (8, 32, 64):  # the other powers of two: groups 1, 4, 8
                q, pages, tables, lens_t = decode_inputs(
                    gen, dtype, 5, SPLIT_LENS, PAGE, n_q=n_q, int8=spec["int8"])
                yield (row, dtype, f"{row} {tag} group={n_q // N_KV}",
                       run_decode(row, q, pages, tables, lens_t),
                       run_decode(row, q, pages, tables, lens_t, plain=True))
            # Groups of 3 to 7 rows, and groups above 8 in chunks (12: 2 x 6,
            # 16: 2 x 8), over 4 kv heads; then head_dim 64 over 2.
            for group, n_kv, hd in ([(g, 4, HD) for g in DECODE_GROUPS]
                                    + [(g, 2, 64) for g in HD64_GROUPS]):
                q, pages, tables, lens_t = decode_inputs(
                    gen, dtype, 5, SPLIT_LENS, PAGE, n_q=group * n_kv, n_kv=n_kv, hd=hd,
                    int8=spec["int8"])
                yield (row, dtype, f"{row} {tag} group={group} n_kv={n_kv} hd={hd}",
                       run_decode(row, q, pages, tables, lens_t),
                       run_decode(row, q, pages, tables, lens_t, plain=True))
            # The Qwen2.5 attention shapes, through the edge cases above.
            for model, (n_q, n_kv, hd) in QWEN_SHAPES.items():
                cases = [("B=8", [0, 1, PAGE, PAGE + 1, 2 * PAGE, 1000, 2047, 2048], PAGE, None),
                         ("page=64 window=512 B=8", [1, 63, 64, 65, 700, 1000, 2047, 2048], 64,
                          512), *SPLIT_CASES]
                for name, lens, page, window in cases:
                    q, pages, tables, lens_t = decode_inputs(
                        gen, dtype, len(lens), lens, page, n_q=n_q, n_kv=n_kv, hd=hd,
                        int8=spec["int8"])
                    yield (row, dtype, f"{row} {tag} {model} {name}",
                           run_decode(row, q, pages, tables, lens_t, window),
                           run_decode(row, q, pages, tables, lens_t, window, plain=True))
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
        # (name, batch, L, S, offsets, window, rows kept, n_q, n_kv, head_dim).
        # The bf16 kernel takes 128-row CTAs where that grid covers the card
        # (the 2,048-token chunks, the 4 x 1,000 and group-8 cases), else 64-row.
        cases = [
            ("L=S=2048 off=0", 1, 2048, 2048, 0, None, None, N_Q, N_KV, HD),
            ("L=512 S=2048 off=1536", 1, 512, 2048, 1536, None, None, N_Q, N_KV, HD),
            ("L=512 S=2048 off=1024", 1, 512, 2048, 1024, None, None, N_Q, N_KV, HD),
            ("L=8 chunk n_valid=5 S=64 off=40", 1, 8, 64, 40, None, 5, N_Q, N_KV, HD),
            ("per-batch offsets", 3, 64, 256, [0, 100, 192], None, None, N_Q, N_KV, HD),
            ("L=S=2048 window=512", 1, 2048, 2048, 0, 512, None, N_Q, N_KV, HD),
            ("B=4 L=1000 S=1500 per-batch offsets window=300", 4, 1000, 1500,
             [0, 100, 300, 500], 300, None, N_Q, N_KV, HD),
            ("group=8 L=S=1024", 1, 1024, 1024, 0, None, None, 64, N_KV, HD),
        ]
        # The speculative verify (verify_step_cache, k = 2, 4, 8): 8 rows of
        # L = k + 1 new tokens at per-batch offsets that are no multiple of
        # a tile, so most rows of a tile are padding and the diagonal lands
        # mid-tile; one offset of 0; a window.
        cases += [(f"verify B=8 L={l} S=2048 per-batch offsets", 8, l, 2048, verify_offsets(l),
                   None, None, N_Q, N_KV, HD) for l in (2, 5, 9)]
        cases += [
            ("verify B=8 L=5 S=2048 offsets with 0", 8, 5, 2048, [0] + verify_offsets(5)[1:],
             None, None, N_Q, N_KV, HD),
            ("verify B=8 L=5 S=2048 window=300", 8, 5, 2048, verify_offsets(5), 300, None,
             N_Q, N_KV, HD),
            ("hd=64 L=S=2048 off=0", 1, 2048, 2048, 0, None, None, N_Q, N_KV, 64),
            ("hd=64 L=300 S=700 off=400 window=200", 1, 300, 700, 400, 200, None, N_Q, N_KV, 64),
            # Groups above 8: 13 folds 4 positions into 52 of 64 rows, 64
            # one position a 64-row tile.
            ("group=13 hd=64 B=2 L=200 S=600 per-batch offsets", 2, 200, 600, [100, 400], None,
             None, 26, 2, 64),
            ("group=64 L=100 S=300 off=200 window=150", 1, 100, 300, 200, 150, None, 64, 1, HD),
        ]
        # A group of 7 folds 9 positions into a 64-row tile (18 into 128
        # rows): the two Qwen2.5 shapes at both tile plans (the 2,048-token
        # chunk fills the card with 128-row CTAs, the serving chunk does
        # not), per-batch offsets and a window.
        for model, (n_q, n_kv, hd) in QWEN_SHAPES.items():
            cases += [
                (f"{model} L=S=2048 off=0", 1, 2048, 2048, 0, None, None, n_q, n_kv, hd),
                (f"{model} L=512 S=2048 off=1024", 1, 512, 2048, 1024, None, None, n_q, n_kv,
                 hd),
                (f"{model} B=3 L=300 S=1000 per-batch offsets window=300", 3, 300, 1000,
                 [0, 100, 700], 300, None, n_q, n_kv, hd),
            ]
        for name, b, l, s, off, window, n_valid, n_q, n_kv, hd in cases:
            q, k, v = flash_inputs(gen, dtype, b, l, s, n_q=n_q, n_kv=n_kv, hd=hd)
            offs = off if isinstance(off, int) else torch.tensor(off, dtype=torch.int32, device="cuda")
            got = fp.flash_prefill(q, k, v, offs, window=window)
            ref = fp.dense_attention(q, k, v, offs, window=window)
            if n_valid is not None:
                got, ref = got[:, :n_valid], ref[:, :n_valid]
            yield "flash_prefill", dtype, f"flash_prefill {tag} {name}", got, ref


def determinism_checks(gen) -> int:
    """Two calls of each decode kernel for bf16 q (cluster merge, split and
    combine; bf16 and int8 pages) on the same inputs give the same bits (no
    atomics; phase 6's multi-step check relies on it), at the flagship's and
    the Qwen2.5 attention shapes."""
    n = 0
    shapes = {"flagship": (N_Q, N_KV, HD), **QWEN_SHAPES}
    for row, spec in DECODE_ROWS.items():
        for (model, (n_q, n_kv, hd)), lens in itertools.product(
                shapes.items(), (SPLIT_LENS, [0, 1, PAGE, PAGE + 1, 2 * PAGE, 1000, 2047, 2048])):
            q, pages, tables, lens_t = decode_inputs(gen, torch.bfloat16, len(lens), lens, PAGE,
                                                     n_q=n_q, n_kv=n_kv, hd=hd,
                                                     int8=spec["int8"])
            first = run_decode(row, q, pages, tables, lens_t)
            second = run_decode(row, q, pages, tables, lens_t)
            torch.cuda.synchronize()
            same = torch.equal(first, second)
            log(f"  {row} bf16 {model} B={len(lens)}: two calls bit-identical: {same}")
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


def time_decode(gen, row: str, shape: str, plain: bool = True, n_q: int = N_Q,
                n_kv: int = N_KV, hd: int = HD) -> dict:
    """Row `row` at a DECODE_SHAPES shape (bf16 q, page 16, n_q query heads
    over n_kv KV heads of hd, by default the flagship's), each call cold in
    L2: kernel, plain version (`plain`), SDPA over pre-gathered K/V of the
    live positions (bf16 pages only; no PyTorch call attends over int8
    pages), and the bound. On the timed inputs the kernel is also held
    against its plain version (max_abs_err, under phase 3's bar)."""
    batch, ctx, table_ctx = DECODE_SHAPES[shape]
    int8 = DECODE_ROWS[row]["int8"]
    q, pages, tables, lens = decode_inputs(gen, torch.bfloat16, batch, [ctx] * batch,
                                           PAGE, max_ctx=table_ctx, int8=int8, n_q=n_q,
                                           n_kv=n_kv, hd=hd)
    label = f"{row} {shape} n_q={n_q} n_kv={n_kv} hd={hd}"
    err = check_close(row, label, run_decode(row, q, pages, tables, lens),
                      run_decode(row, q, pages, tables, lens, plain=True), torch.bfloat16)
    kernel_ms = time_graph_ms(lambda: run_decode(row, q, pages, tables, lens), cold=True)
    plain_ms = None
    if plain:
        plain_ms = time_graph_ms(lambda: run_decode(row, q, pages, tables, lens, plain=True),
                                 cold=True)
    library_ms = None
    if not int8:
        k, v = pages
        kd, vd = (p[:, tables.long()].movedim(1, 0).reshape(batch, n_kv, -1, hd)[:, :, :ctx]
                  .contiguous() for p in (k, v))
        library_ms = time_graph_ms(sdpa_gqa(q[:, :, None], kd, vd), cold=True)
    live = int(lens.sum())
    kv_row_bytes = hd * (1 if int8 else 2) + (4 if int8 else 0)  # values (+ scale)
    live_pages = batch * -(-ctx // PAGE)
    nbytes = 2 * live * n_kv * kv_row_bytes + 2 * batch * n_q * hd * 2 + live_pages * 4
    out = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               **_bound(nbytes, 4 * live * n_q * hd), mbytes=nbytes / 1e6, max_abs_err=err)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    plain_txt = "" if plain_ms is None else f", plain {plain_ms:.4f} ms"
    log(f"  {label} page={PAGE}: kernel {kernel_ms:.4f} ms "
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
    # Phase 13's models at their attention shapes: every row, at the batch-8
    # and the serving decode shapes and at the serving prefill chunk.
    qwen_shapes = {}
    for model, (n_q, n_kv, hd) in QWEN_SHAPES.items():
        log(f"  at the {model} attention shape (n_q {n_q}, n_kv {n_kv}, head_dim {hd})")
        shapes = {shape: {row: time_decode(gen, row, shape, n_q=n_q, n_kv=n_kv, hd=hd)
                          for row in DECODE_ROWS}
                  for shape in ("B=8 ctx=2048", "B=1 ctx=1536 table=2048")}
        shapes["flash_prefill serving"] = time_prefill(gen, *PREFILL_SERVING_SHAPE, n_q=n_q,
                                                       n_kv=n_kv, hd=hd)
        qwen_shapes[model] = shapes
    # Phase 19a's rank of a tp = 2 flagship pod: half the heads of each kind.
    n_q, n_kv = N_Q // TP, N_KV // TP
    log(f"  at a tp = {TP} rank's attention shape (n_q {n_q}, n_kv {n_kv}, head_dim {HD})")
    tp_rank_shape = {"B=8 ctx=2048": {row: time_decode(gen, row, "B=8 ctx=2048", n_q=n_q,
                                                       n_kv=n_kv)
                                      for row in ("paged_decode", "paged_decode_int8")},
                     "flash_prefill serving": time_prefill(gen, *PREFILL_SERVING_SHAPE, n_q=n_q,
                                                           n_kv=n_kv)}
    return main, decode, serving, verify, mixtral_shape, qwen_shapes, tp_rank_shape


# The prefill call of a prefix-hit request in phase 5: 512 new tokens after
# 1,024 cached, against the pod's padded table (1,536 tokens need 96 pages of
# 16, padded to a power of two: 128 pages, 2,048 positions).
PREFILL_SERVING_SHAPE = (512, 2048, 1024)


def time_prefill(gen, l: int, s: int, off: int, n_q: int = N_Q, n_kv: int = N_KV,
                 hd: int = HD) -> dict:
    """Row 5 at L new tokens after `off` cached, S positions of K/V (bf16,
    n_q query heads over n_kv KV heads of hd, by default the flagship's):
    kernel, plain version, SDPA (is_causal where off == 0 and L == S, else a
    lower-right causal bias over the first off + L keys, the same function),
    and the bound over the keys the mask keeps. On the timed inputs the
    kernel is also held against its plain version."""
    q, k, v = flash_inputs(gen, torch.bfloat16, 1, l, s, n_q=n_q, n_kv=n_kv, hd=hd)
    label = f"flash_prefill L={l} S={s} off={off} n_q={n_q} n_kv={n_kv} hd={hd}"
    err = check_close("flash_prefill", label,
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
    flops = 4 * causal_pairs(l, s, [off], None) * n_q * hd
    nbytes = (2 * l * n_q * hd + 2 * keys * n_kv * hd) * 2
    out = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, **_bound(nbytes, flops),
               gflop=flops / 1e9, max_abs_err=err)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"  {label}: kernel {kernel_ms:.4f} ms "
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


def token_indexer(index) -> Indexer:
    """An Indexer over `index` for prompts given as token IDs (phases 5-11):
    `chain_scores` scores them through its `score_hashes`."""
    return Indexer(
        IndexerConfig(token_processor_config=TokenProcessorConfig(block_size=PAGE)),
        kv_block_index=index,
    )


def chain_scores(indexer, tokens, model: str, pods=(), lora_id=None) -> dict:
    """The index's pod scores for a token-ID prompt: the lookup and scoring
    stages of the read path (`Indexer.score_hashes`) over the prompt's
    block chain."""
    keys = indexer.token_processor.tokens_to_kv_block_keys(None, tokens, model, lora_id=lora_id)
    return indexer.score_hashes(model, [k.chunk_hash for k in keys], pods).scores


def phase_serving(params, cfg) -> dict:
    log("== phase 5: serving two bf16 flagship pods (4096 pages of 16 each) and "
        "one int8-KV pod (8192 pages of 16)")
    model = "llama-flagship-1.14b"
    index = InMemoryIndex()
    indexer = token_indexer(index)

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
        scores = chain_scores(indexer, probe, model, list(pods))
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
    tokens, table = prefill_check_inputs(cfg, seed)
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
    (`forward_dense`, the tests' oracle): logits at positions first.. (the
    dense family's head runs on those rows only)."""
    if llama.is_moe_config(cfg):
        return mixtral.forward_dense(cfg, params, tokens[None])[0, first:]
    return llama.forward_dense(cfg, params, tokens[None], first=first)[0]


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
    indexer = token_indexer(index)
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
                             delta: float, model: str = "llama-flagship-1.14b") -> dict:
    """Phase 7b on one pod of `model`: a probe run finds a token the EOS
    request reaches (the first after its third that it has not emitted
    before; the pods are deterministic), then the recorded run with that EOS
    on a fresh pod, its checks and the teacher-forced bar."""
    tag = f"{model}, {'int8' if int8 else 'bf16'} pages, decode_steps {decode_steps}"
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
    scores = chain_scores(indexer, probe_prompt, model)
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
        f"{launches['flash_prefill']}}} ({cfg.n_layers} per pass)")
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
    indexer = token_indexer(index)

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
    scores = {str(lid): chain_scores(indexer, probe, model, lora_id=lid).get(pid, 0)
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
    return index, token_indexer(index)


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
        scores[fmt] = chain_scores(index_parts[1], probe, MOE_MODEL)
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


# -- phase 12: the write plane and the prompt read path -----------------------

FLEET_MODEL = "llama-8b-fleet"
FLEET_PODS = 16  # simulated pods of an 80 GB card each
FLEET_BLOCKS_PER_POD = 28672  # 458,752 tokens of an 8B model's 128 KiB/token KV
FLEET_SHARED = 64  # shared prefixes of 64 blocks
FLEET_PREFIXES_PER_POD = 16  # each shared prefix is held by 4 pods (<= 10 per key)
FLEET_TAIL_BLOCKS = 48  # per conversation: one shared prefix + a unique tail
FLEET_CHAINS = 1024
PHASE_12A_LIMIT_S = 60.0
# The tokenization pool answers a prompt that its prefix store covers at
# min_prefix_overlap_ratio (0.8 by default) with the store's cached tokens,
# so a chain comes out short of the prompt by design, and scores below the
# plain longest prefix where a pod holds past the cut. Phase 12a holds
# score_many to whole chains, so its pool tokenizes every prompt; phase 12b
# keeps the default, where bar 2 checks what the shortcut predicts.
WHOLE_PROMPTS = TokenizersPoolConfig(workers=4, min_prefix_overlap_ratio=float("inf"))


# The chat template's tags and roles (tests/fixtures/chat/word-chat.jinja):
# tokens of their own, at the top of the flagship's vocabulary.
CHAT_WORDS = {w: FLAGSHIP["vocab_size"] - 1 - i for i, w in enumerate((
    "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>", "system", "user", "assistant"))}


class WordTokenizer(Tokenizer):
    """A deterministic word-level tokenizer: the word "w01234" is token 1234
    (a CHAT_WORDS word its own id). Every word is 6 bytes and a space
    follows it, so a prompt's text is 7 bytes a token and a 1,024-token
    system prompt fills exactly 28 of the prefix store's 256-byte chunks.
    Chat templates render through the ChatTemplatingProcessor it is given."""

    def __init__(self, chat_templating=None):
        self.chat_templating = chat_templating

    def encode(self, prompt: str, model_name: str) -> TokenizationResult:
        words = prompt.split(" ")
        ends = list(itertools.accumulate(len(w) + 1 for w in words))
        return TokenizationResult(tokens=[CHAT_WORDS[w] if w in CHAT_WORDS else int(w[1:])
                                          for w in words],
                                  offsets=[(e - len(w) - 1, e - 1) for w, e in zip(words, ends)])

    def render_chat_template(self, request) -> str:
        if self.chat_templating is None:
            raise NotImplementedError("no chat templating processor")
        return self.chat_templating.render(request)


def words(tokens) -> str:
    return " ".join(f"w{t:05d}" for t in tokens)


def plain_longest_prefix(chain, held: dict) -> dict:
    """The plain longest-prefix score of a chain: for each pod, the number of
    leading blocks it holds (every tier here weighs 1)."""
    scores = {}
    for pod, keys in held.items():
        n = 0
        for h in chain:
            if h not in keys:
                break
            n += 1
        if n:
            scores[pod] = float(n)
    return scores


def fleet_traffic(seed: int, n_pods: int) -> tuple:
    """Phase 12a's fleet from `seed`: per pod, conversations of a shared
    prefix and a unique tail (one BlockStored each, chained to the prefix),
    then 10% of the pod's blocks removed. Returns (batches per pod, the
    plain replay {pod: live chain hashes}, the conversations as (prefix,
    tail tokens, tail hashes, pod), the shared prefixes' tokens and
    hashes)."""
    rng = np.random.default_rng(seed)
    root = hashing.init_hash("")
    vocab = FLAGSHIP["vocab_size"]
    shared = [rng.integers(0, vocab, 64 * PAGE).tolist() for _ in range(FLEET_SHARED)]
    shared_hashes = [hashing.prefix_hashes_fast(root, t, PAGE) for t in shared]
    n_conv = (FLEET_BLOCKS_PER_POD - FLEET_PREFIXES_PER_POD * 64) // FLEET_TAIL_BLOCKS
    batches, held, convs = {}, {}, []
    for p in range(n_pods):
        pod = f"pod-{p:02d}"
        mine = [(p * 4 + j) % FLEET_SHARED for j in range(FLEET_PREFIXES_PER_POD)]
        out, keys, stored = [], set(), set()
        for c in range(n_conv):
            s = mine[c % len(mine)]
            tail = rng.integers(0, vocab, FLEET_TAIL_BLOCKS * PAGE).tolist()
            tail_hashes = hashing.prefix_hashes_fast(shared_hashes[s][-1], tail, PAGE)
            if s not in stored:  # the prefix's first conversation stores it
                stored.add(s)
                out.append(EventBatch(ts=float(len(out)), events=[BlockStored(
                    block_hashes=shared_hashes[s], parent_block_hash=None,
                    token_ids=shared[s], block_size=PAGE)]))
                keys.update(shared_hashes[s])
            out.append(EventBatch(ts=float(len(out)), events=[BlockStored(
                block_hashes=tail_hashes, parent_block_hash=shared_hashes[s][-1],
                token_ids=tail, block_size=PAGE)]))
            keys.update(tail_hashes)
            convs.append((s, tail, tail_hashes, pod))
        order = sorted(keys)
        gone = [order[i] for i in rng.choice(len(order), len(order) // 10, replace=False)]
        for i in range(0, len(gone), 64):
            out.append(EventBatch(ts=float(len(out)), events=[BlockRemoved(gone[i:i + 64])]))
        held[pod] = keys - set(gone)
        batches[pod] = out
    return batches, held, convs, shared, shared_hashes


def fleet_chains(seed: int, convs, shared, shared_hashes) -> list:
    """Phase 12a's prompts: a shared prefix, the first k blocks of one of
    its conversations' tails (0-48) and 16-64 blocks nobody stored. Returns
    (tokens, full chain) pairs."""
    rng = np.random.default_rng(seed + 1)
    vocab = FLAGSHIP["vocab_size"]
    out = []
    for _ in range(FLEET_CHAINS):
        s, tail, tail_hashes, _ = convs[rng.integers(0, len(convs))]
        k = int(rng.integers(0, FLEET_TAIL_BLOCKS + 1))
        extra = rng.integers(0, vocab, int(rng.integers(16, 65)) * PAGE).tolist()
        tokens = shared[s] + tail[:k * PAGE] + extra
        parent = tail_hashes[k - 1] if k else shared_hashes[s][-1]
        chain = shared_hashes[s] + tail_hashes[:k] + hashing.prefix_hashes_fast(
            parent, extra, PAGE)
        out.append((tokens, chain))
    return out


def index_pairs(index) -> set:
    """(request key hash, pod, tier) for every entry of the index."""
    return {(h, pod, tier) for _, h, pods in index.export_view().entries for pod, tier in pods}


def feed(pool, messages, high: int = 2048, low: int = 256) -> None:
    """Hand messages to the pool as the subscriber would, waiting whenever a
    shard's queue passes `high` until every shard is under `low`: the
    producer never outruns the bounded queues, so nothing is dropped."""
    for i, msg in enumerate(messages):
        pool.add_task(msg)
        if i % 128 == 0 and max(pool.queue_depths()) > high:
            while max(pool.queue_depths()) > low:
                time.sleep(0.001)


def phase_control_plane(seed: int) -> dict:
    """Phase 12a at FLEET_PODS pods; a run past PHASE_12A_LIMIT_S is made
    again at the pod count its time scales to, until one fits."""
    n_pods = FLEET_PODS
    while True:
        res = control_plane_run(seed, n_pods)
        if res["run_s"] <= PHASE_12A_LIMIT_S or n_pods == 1:
            break
        cut = max(1, min(n_pods - 1, int(n_pods * PHASE_12A_LIMIT_S / res["run_s"])))
        log(f"  phase 12a ran {res['run_s']:.1f} s at {n_pods} pods, past its "
            f"{PHASE_12A_LIMIT_S:.0f} s limit: again at {cut} pods")
        n_pods = cut
    res["cut_from"] = None if n_pods == FLEET_PODS else FLEET_PODS
    log(f"  phase 12a: {n_pods} pods"
        + (f" (cut from {FLEET_PODS} pods to fit the time limit)" if res["cut_from"] else
           " (no cut)"))
    return res


def fleet_messages(batches) -> tuple:
    """The pods' streams as msgpack Messages, interleaved round robin (each
    pod's own order kept); with the stored and removed block counts."""
    messages, cursors = [], {pod: 0 for pod in batches}
    while cursors:
        for pod in list(cursors):
            seq = cursors[pod]
            if seq == len(batches[pod]):
                del cursors[pod]
                continue
            messages.append(Message(
                topic=f"kv@{pod}@{FLEET_MODEL}", payload=batches[pod][seq].to_msgpack(),
                seq=seq, pod_identifier=pod, model_name=FLEET_MODEL))
            cursors[pod] = seq + 1
    n_blocks = sum(len(e.block_hashes) for bs in batches.values() for b in bs for e in b.events
                   if isinstance(e, BlockStored))
    n_removed = sum(len(e.block_hashes) for bs in batches.values() for b in bs for e in b.events
                    if isinstance(e, BlockRemoved))
    return messages, n_blocks, n_removed


def control_plane_run(seed: int, n_pods: int) -> dict:
    log(f"== phase 12a: the control plane at a fleet's size (host only): {n_pods} pods x "
        f"{FLEET_BLOCKS_PER_POD} blocks of {PAGE}, IndexConfig.default(), EventPool "
        f"concurrency 4, seed {seed}")
    t_phase = time.perf_counter()
    batches, held, convs, shared, shared_hashes = fleet_traffic(seed, n_pods)
    messages, n_blocks, n_removed = fleet_messages(batches)
    setup_s = time.perf_counter() - t_phase
    payload_mb = sum(len(m.payload) for m in messages) / 1e6
    log(f"  made {len(messages)} msgpack batches ({payload_mb:.1f} MB): {n_blocks} blocks "
        f"stored, {n_removed} removed, in {setup_s:.1f} s")

    indexer = Indexer(
        IndexerConfig(token_processor_config=TokenProcessorConfig(block_size=PAGE)),
        tokenization_pool=TokenizationPool(WHOLE_PROMPTS, tokenizer=WordTokenizer()),
    )
    if not isinstance(indexer.kv_block_index, ShardedIndex):
        raise AssertionError(f"default index is {type(indexer.kv_block_index).__name__}")
    digest_s, drain_s, counters = digest_stream(indexer.kv_block_index,
                                                indexer.token_processor, messages)
    log(f"  digested in {digest_s:.3f} s ({n_blocks / digest_s:.0f} blocks/s stored, "
        f"{len(messages) / digest_s:.0f} batches/s); the last drain took {drain_s:.3f} s; "
        f"{counters}")
    failures = []
    if counters["dropped"] or counters["removals_lost"] or counters["workers_alive"] != 4:
        failures.append(f"pool counters {counters}")
    want = {(h, pod, "gpu") for pod, keys in held.items() for h in keys}
    got = index_pairs(indexer.kv_block_index)
    if got != want:
        failures.append(f"index holds {len(got)} (key, pod) pairs, the plain replay "
                        f"{len(want)}: {len(got - want)} extra, {len(want - got)} missing")

    chains = fleet_chains(seed, convs, shared, shared_hashes)
    requests = [ScoreRequest(words(t), FLEET_MODEL) for t, _ in chains]
    indexer.run()
    try:
        t0 = time.perf_counter()
        many = indexer.score_many(requests)
        many_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        singles = [indexer.score_hashes(FLEET_MODEL, chain) for _, chain in chains]
        single_s = time.perf_counter() - t0
    finally:
        indexer.shutdown()
    # Every prompt is whole blocks, so score_many must derive the whole chain;
    # an item shed by the tokenization pool comes back empty.
    bad, shed = 0, sum(not m.block_hashes for m in many)
    for (tokens, chain), m, s in zip(chains, many, singles):
        plain = plain_longest_prefix(chain, held)
        if m.block_hashes != chain or m.scores != plain or s.scores != plain:
            bad += 1
    hit_blocks = [max(s.match_blocks.values(), default=0) for s in singles]
    if shed:
        failures.append(f"score_many shed {shed} of {len(chains)} prompts")
    if bad:
        failures.append(f"{bad} of {len(chains)} chains score apart from the plain replay")
    run_s = time.perf_counter() - t_phase
    log(f"  {len(chains)} chains of {min(len(c) for _, c in chains)}-"
        f"{max(len(c) for _, c in chains)} blocks: score_many {many_s * 1e6 / len(chains):.1f} "
        f"us/chain (tokenize + derive + lookup + score), score_hashes "
        f"{single_s * 1e6 / len(chains):.1f} us/chain (lookup + score); best match "
        f"{statistics.median(hit_blocks)} blocks median; {bad} chains off the plain score")
    log(f"  phase 12a ran {run_s:.1f} s (limit {PHASE_12A_LIMIT_S:.0f} s) at {n_pods} pods")
    if failures:
        raise AssertionError(f"phase 12a: {failures}")
    return dict(pods=n_pods, blocks_stored=n_blocks, blocks_removed=n_removed,
                batches=len(messages), payload_mb=payload_mb, digest_s=digest_s,
                blocks_per_s=n_blocks / digest_s, last_drain_s=drain_s,
                score_many_us=many_s * 1e6 / len(chains),
                score_hashes_us=single_s * 1e6 / len(chains), setup_s=setup_s, run_s=run_s,
                counters=counters,
                # Phase 14a holds the native index's scores to these.
                readings=dict(seed=seed, many=[(m.scores, m.match_blocks) for m in many],
                              singles=[(x.scores, x.match_blocks) for x in singles]),
                # Phase 15b governs this index rather than digesting it again.
                digested=dict(indexer=indexer, held=held, chains=chains, messages=messages))


FLEET_SYSTEMS = 8  # system prompts of 1,024 tokens
# Waves of 8 requests, each wave one request per system prompt: 8 until
# phase 14 joined the run, cut to 6 to keep the whole run inside the time
# it took before, and to 4 when phase 16 joined (the fewest at which the
# round-robin pods still reclaim a page).
FLEET_WAVES = 4
FLEET_TURN = 256
FLEET_NEW = 16
FLEET_POD_PAGES = 640
FLEET_POD_IDS = ("pod-0", "pod-1", "pod-2", "pod-3")


def system_prompts(rng, vocab: int) -> list:
    """The 8 system prompts of 1,024 tokens that phases 12b and 14b share."""
    return [rng.integers(0, vocab, 1024).tolist() for _ in range(FLEET_SYSTEMS)]


def multitenant_traffic(seed: int, vocab: int, n_waves: int = FLEET_WAVES) -> list:
    """Phase 12b's waves: 8 system prompts, 8 users a wave; wave w sends one
    request per system prompt in a seeded order, each a system prompt and a
    256-token turn of its own."""
    rng = np.random.default_rng(seed + 12)
    systems = system_prompts(rng, vocab)
    return [[dict(system=int(s), tokens=systems[s] + rng.integers(0, vocab, FLEET_TURN).tolist())
             for s in rng.permutation(FLEET_SYSTEMS)] for _ in range(n_waves)]


def fleet_pods(params, cfg, pool, model: str, n_pages: int, ids, removed: list) -> dict:
    """Flagship bf16 pods sharing `params`; each pod's sink packs its event
    batches with the port's codec into `pool` (a Message per batch, as the
    ZMQ subscriber would hand it over) and counts removed blocks into
    `removed`."""
    pods = {}
    for pid in ids:
        seq = iter(range(1 << 62))

        def sink(batch, pid=pid, seq=seq):
            removed[0] += sum(len(e.block_hashes) for e in batch.events
                              if isinstance(e, BlockRemoved))
            pool.add_task(Message(topic=f"kv@{pid}@{model}", payload=batch.to_msgpack(),
                                  seq=next(seq), pod_identifier=pid, model_name=model))

        pods[pid] = EnginePod(
            EnginePodConfig(pod_id=pid, model_name=model, n_pages=n_pages, page_size=PAGE,
                            device_tier="gpu", max_pages_per_seq=96, model_config=cfg,
                            device=params["embed"].device),
            event_sink=sink, params=params)
    return pods


def serve_share(pod, share: list, max_batch: int) -> dict:
    """A pod's share of a wave through its Scheduler (prefill budget 512):
    at `max_batch` 8 the share is submitted at once and served batched, the
    routed load whose hit rate and TTFT phase 12b reports; at `max_batch` 1
    each request is served alone, which runs the same work on every pod:
    its prefill chunks are the same whether its 1,024-token system prompt
    hits (one 256-token chunk at offset 1,024) or not (512, 512, 256), and
    it decodes at batch 1. Batched, cuBLAS picks kernels by row count and a
    bf16 row differs by ulps between batch sizes, so only the batch-1 run
    can equal the reference bit for bit (bar 3)."""
    specs = [dict(prompt_tokens=q["tokens"], max_new_tokens=FLEET_NEW, sampling=None)
             for q in share]
    groups = [specs] if max_batch > 1 else [[spec] for spec in specs]
    out = dict(tokens=[], requests=[], first_token_s=[])
    for group in groups:
        r = run_scheduler(pod, group, decode_steps=1, max_batch=max_batch, budget=512)
        for key in out:
            out[key] += r[key]
    return out


def fleet_run(params, cfg, waves, policy: str, max_batch: int) -> dict:
    """One policy over the waves on four fresh pods: route, serve each pod's
    share through its Scheduler, drain the pool, and check bars 1 and 2."""
    model = "llama-flagship-1.14b"
    indexer = Indexer(
        IndexerConfig(token_processor_config=TokenProcessorConfig(block_size=PAGE)),
        tokenization_pool=TokenizationPool(TokenizersPoolConfig(workers=2),
                                           tokenizer=WordTokenizer()),
    )
    pool = EventPool(EventPoolConfig(concurrency=4), indexer.kv_block_index,
                     indexer.token_processor)
    pool.start(with_subscriber=False)
    indexer.run()
    removed = [0]
    pods = fleet_pods(params, cfg, pool, model, FLEET_POD_PAGES, FLEET_POD_IDS, removed)
    rr = 0
    tokens, requests, cached, ttft, read_s, drain_s, failures = {}, {}, {}, [], [], [], []
    try:
        for w, wave in enumerate(waves):
            share = {pid: [] for pid in pods}
            for j, req in enumerate(wave):
                if policy == "precise":
                    t0 = time.perf_counter()
                    ps = indexer.get_pod_scores_ex(words(req["tokens"]), model, list(pods))
                    read_s.append(time.perf_counter() - t0)
                    best = max(ps.scores.values(), default=None)
                    tied = [p for p in pods if ps.scores.get(p) == best] if ps.scores else list(pods)
                    pid = tied[rr % len(tied)]
                    predicted = PAGE * ps.match_blocks.get(pid, 0)
                else:
                    pid, predicted = FLEET_POD_IDS[rr % len(FLEET_POD_IDS)], None
                rr += 1
                share[pid].append((j, req, predicted))
            for pid, reqs in share.items():
                if not reqs:
                    continue
                r = serve_share(pods[pid], [q for _, q, _ in reqs], max_batch)
                for (j, _, predicted), out, done, first in zip(
                        reqs, r["tokens"], r["requests"], r["first_token_s"]):
                    tokens[(w, j)], requests[(w, j)] = out, done
                    cached[(w, j)] = done.num_cached_tokens
                    ttft.append((first, done.num_cached_tokens > 0))
                    if predicted is not None and done.num_cached_tokens != predicted:
                        failures.append(f"wave {w} request {j} on {pid}: cached "
                                        f"{done.num_cached_tokens}, the index predicted {predicted}")
            t0 = time.perf_counter()
            pool.drain()
            drain_s.append(time.perf_counter() - t0)
            for pid, pod in pods.items():
                committed = {(h, "gpu") for h in pod.block_manager.cached_hashes()}
                indexed = {(h, tier) for h, p, tier in index_pairs(indexer.kv_block_index)
                           if p == pid}
                if committed != indexed:
                    failures.append(f"wave {w} {pid}: index {len(indexed)} blocks, pod "
                                    f"{len(committed)} ({len(indexed - committed)} extra)")
        counters = dict(dropped=pool.dropped_events, removals_lost=pool.removals_lost)
        if counters != dict(dropped=0, removals_lost=0):
            failures.append(f"pool counters {counters}")
    finally:
        indexer.shutdown()
        pool.shutdown()
    prompt_tokens = sum(len(q["tokens"]) for wave in waves for q in wave)
    hit_rate = sum(cached.values()) / prompt_tokens
    hit_ms = [t * 1e3 for t, hit in ttft if hit]
    miss_ms = [t * 1e3 for t, hit in ttft if not hit]
    return dict(tokens=tokens, requests=requests,
                cached={f"{w}.{j}": c for (w, j), c in cached.items()},
                hit_rate=hit_rate, ttft_median_ms=statistics.median(t for t, _ in ttft) * 1e3,
                ttft_mean_ms=statistics.fmean(t for t, _ in ttft) * 1e3,
                ttft_hit_median_ms=statistics.median(hit_ms) if hit_ms else None,
                ttft_miss_median_ms=statistics.median(miss_ms) if miss_ms else None,
                ttft_ms=[t * 1e3 for t, _ in ttft],
                read_ms=[t * 1e3 for t in read_s], drain_ms=[t * 1e3 for t in drain_s],
                failures=failures, counters=counters, removed_blocks=removed[0])


def phase_fleet(params, cfg, seed: int) -> dict:
    log(f"== phase 12b: four bf16 flagship pods ({FLEET_POD_PAGES} pages of {PAGE} each) "
        f"behind the port's Indexer and EventPool; {FLEET_WAVES} waves of {FLEET_SYSTEMS} "
        f"requests (a 1,024-token system prompt of 8 + a {FLEET_TURN}-token turn, "
        f"{FLEET_NEW} greedy tokens), each pod's share of a wave batched (max_batch 8), "
        f"then again with each request alone for bar 3 (cut from 6 waves to {FLEET_WAVES} "
        f"to keep the whole run's time with phase 16)")
    waves = multitenant_traffic(seed, cfg.vocab_size)
    card = card_line()
    # The reference: every request alone on one pod that never evicts.
    ref_pod = EnginePod(
        EnginePodConfig(pod_id="pod-ref", model_name="ref", n_pages=2048, page_size=PAGE,
                        device_tier="gpu", max_pages_per_seq=96, model_config=cfg,
                        device=params["embed"].device), params=params)
    want = {}
    for w, wave in enumerate(waves):
        for j, q in enumerate(wave):
            want[(w, j)] = serve_share(ref_pod, [q], 1)["tokens"][0]
    del ref_pod
    torch.cuda.empty_cache()
    out, failures, batched = {}, [], {}
    reset_launch_counts()
    for policy in ("precise", "round_robin"):
        for max_batch in (8, 1):
            run = f"{policy} batch {max_batch}"
            res = fleet_run(params, cfg, waves, policy, max_batch)
            off = [k for k in want if res["tokens"][k] != want[k]]
            if max_batch == 1 and off:  # bar 3
                res["failures"].append(f"{len(off)} requests' greedy tokens differ from the "
                                       f"never-evicting pod: first {off[0]}")
            if policy == "round_robin" and not res["removed_blocks"]:
                res["failures"].append("round-robin pods never reclaimed a page")
            failures += [f"{run}: {f}" for f in res["failures"]]
            log(f"  {run} ({card}): prefix-hit rate {res['hit_rate']:.4f} (cached / prompt "
                f"tokens), TTFT median {res['ttft_median_ms']:.2f} ms, mean "
                f"{res['ttft_mean_ms']:.2f} ms (median of hits "
                f"{res['ttft_hit_median_ms'] or 0:.2f}, of misses "
                f"{res['ttft_miss_median_ms'] or 0:.2f}); pool drain ms per wave "
                f"{' '.join(f'{t:.2f}' for t in res['drain_ms'])}")
            if res["read_ms"]:
                log(f"    read path per request (get_pod_scores_ex): median "
                    f"{statistics.median(res['read_ms']):.3f} ms, max "
                    f"{max(res['read_ms']):.3f} ms")
            log(f"    cached tokens by wave: "
                f"{[sum(c for k, c in res['cached'].items() if k.startswith(f'{wi}.')) for wi in range(FLEET_WAVES)]}"
                f"; {res['removed_blocks']} blocks removed; {len(off)} of {len(want)} "
                f"requests' greedy tokens apart from the never-evicting pod; "
                f"{len(res['failures'])} failures")
            res["tokens_apart"] = len(off)
            if max_batch > 1:
                batched[policy] = (res.pop("tokens"), res.pop("requests"))
            else:
                res.pop("tokens"), res.pop("requests")
            out[run] = res
    launches = launch_counts()
    log(f"  kernel launches in the four fleet runs: {launches}")
    for name in ("paged_decode", "flash_prefill"):
        if launches[name] <= 0:
            failures.append(f"{name} was never launched on the fleet path")
    # The batched runs' tokens against the f32 truth: phase 7b's
    # teacher-forced bar on every greedy token, at the delta of bf16 pages.
    params32, cfg32 = f32_twin(params, cfg)
    delta, e = teacher_forced_delta(params, cfg, params32, cfg32, False)
    for policy, (tokens, requests) in batched.items():
        keys = sorted(tokens)
        traffic = [dict(prompt_tokens=waves[w][j]["tokens"], sampling=None) for w, j in keys]
        bar = teacher_forced_bar(params32, cfg32, traffic, [requests[k] for k in keys], delta)
        log(f"    {policy} batch 8, teacher-forced bar: greedy worst "
            f"{bar['worst']['greedy']:.4f} over {bar['tokens_checked']['greedy']} tokens "
            f"(delta {delta:.4f}: the bf16 plain path is {e:.4f} off the truth)")
        if not bar["ok"]:
            failures.append(f"{policy} batch 8: teacher-forced bar {bar}")
        out[f"{policy} batch 8"]["bar"] = bar
    del params32
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"phase 12b: {failures[:6]}")
    out.update(card=card, launches=launches)
    return out



# -- phase 14: the read plane's second half -----------------------------------

PHASE_14A_LIMIT_S = 60.0
# The cost-aware replays take the streams of this many of 14a's pods: the
# whole fleet through the Python digest into the cost-aware index took
# 15-23 s a replay on an H100 machine's host, and two of them pushed the
# phase past its 60 s.
COST_AWARE_PODS = 4
CHAT_DIR = Path(__file__).resolve().parent / "tests" / "fixtures" / "chat"


def digest_stream(index, token_processor, messages) -> tuple:
    """`messages` through an EventPool of 4 workers into `index`: (digest
    seconds, the last drain's seconds, the pool's counters)."""
    pool = EventPool(EventPoolConfig(concurrency=4), index, token_processor)
    pool.start(with_subscriber=False)
    try:
        t0 = time.perf_counter()
        feed(pool, messages)
        t1 = time.perf_counter()
        pool.drain()
        t2 = time.perf_counter()
        counters = dict(dropped=pool.dropped_events, removals_lost=pool.removals_lost,
                        workers_alive=pool.workers_alive())
    finally:
        pool.shutdown()
    return t2 - t0, t2 - t1, counters


def native_indexer(tokenizer) -> Indexer:
    """An Indexer over `IndexConfig(native=True)`: the C arena, built on
    first use (a failed build raises)."""
    indexer = Indexer(
        IndexerConfig(token_processor_config=TokenProcessorConfig(block_size=PAGE),
                      kv_block_index_config=IndexConfig(in_memory_config=InMemoryIndexConfig(),
                                                        native=True)),
        tokenization_pool=TokenizationPool(WHOLE_PROMPTS, tokenizer=tokenizer))
    if not isinstance(indexer.kv_block_index, NativeScoringIndex):
        raise AssertionError(f"native=True built {type(indexer.kv_block_index).__name__}")
    return indexer


def phase_native_control_plane(seed: int, sharded: dict) -> dict:
    """Phase 14a at FLEET_PODS pods, cut like 12a past PHASE_14A_LIMIT_S. Its
    scores are held to phase 12a's ShardedIndex readings (same seed): at
    12a's pod count, which is run again when the two counts differ."""
    ref = sharded.pop("readings")
    if ref["seed"] != seed:
        raise AssertionError(f"phase 12a ran at seed {ref['seed']}, 14a at {seed}")
    n_pods = FLEET_PODS
    while True:
        res = native_control_plane_run(seed, n_pods, ref if n_pods == sharded["pods"] else None)
        if res["run_s"] <= PHASE_14A_LIMIT_S or n_pods == 1:
            break
        cut = max(1, min(n_pods - 1, int(n_pods * PHASE_14A_LIMIT_S / res["run_s"])))
        log(f"  phase 14a ran {res['run_s']:.1f} s at {n_pods} pods, past its "
            f"{PHASE_14A_LIMIT_S:.0f} s limit: again at {cut} pods")
        n_pods = cut
    res["cut_from"] = None if n_pods == FLEET_PODS else FLEET_PODS
    log(f"  phase 14a: {n_pods} pods"
        + (f" (cut from {FLEET_PODS} pods to fit the time limit)" if res["cut_from"] else
           " (no cut)"))
    if n_pods != sharded["pods"]:
        log(f"  phase 14a again at phase 12a's {sharded['pods']} pods, for the ShardedIndex "
            f"comparison")
        res["at_12a_pods"] = native_control_plane_run(seed, sharded["pods"], ref,
                                                      cost_aware=False)
    res["python_blocks_per_s"] = sharded["blocks_per_s"]
    log(f"  native digest {res['blocks_per_s']:.0f} blocks/s at {n_pods} pods against phase "
        f"12a's Python digest {sharded['blocks_per_s']:.0f} blocks/s at {sharded['pods']} pods "
        f"({res['blocks_per_s'] / sharded['blocks_per_s']:.2f}x), same call ({card_line()})")
    return res


def native_control_plane_run(seed: int, n_pods: int, ref=None, cost_aware: bool = True) -> dict:
    log(f"== phase 14a: the control plane over the native index (host only): {n_pods} pods x "
        f"{FLEET_BLOCKS_PER_POD} blocks of {PAGE}, IndexConfig(native=True), EventPool "
        f"concurrency 4, seed {seed}")
    t_phase = time.perf_counter()
    batches, held, convs, shared, shared_hashes = fleet_traffic(seed, n_pods)
    messages, n_blocks, n_removed = fleet_messages(batches)
    setup_s = time.perf_counter() - t_phase
    indexer = native_indexer(WordTokenizer())
    index = indexer.kv_block_index
    fallbacks = native_index.fallback_total()
    digest_s, drain_s, counters = digest_stream(index, indexer.token_processor, messages)
    status = index.native_status()
    log(f"  made {len(messages)} msgpack batches in {setup_s:.1f} s; digested {n_blocks} "
        f"stored and {n_removed} removed blocks in {digest_s:.3f} s ({n_blocks / digest_s:.0f} "
        f"blocks/s stored; the last drain {drain_s:.3f} s); {counters}; arena {status}")
    failures = []
    if counters["dropped"] or counters["removals_lost"] or counters["workers_alive"] != 4:
        failures.append(f"pool counters {counters}")
    want = {(h, pod, "gpu") for pod, keys in held.items() for h in keys}
    got = index_pairs(index)
    if got != want:
        failures.append(f"index holds {len(got)} (key, pod) pairs, the plain replay "
                        f"{len(want)}: {len(got - want)} extra, {len(want - got)} missing")
    if status["blocks_applied"] != n_blocks + n_removed:
        failures.append(f"the arena applied {status['blocks_applied']} blocks of "
                        f"{n_blocks + n_removed}")

    chains = fleet_chains(seed, convs, shared, shared_hashes)
    requests = [ScoreRequest(words(t), FLEET_MODEL) for t, _ in chains]
    indexer.run()
    try:
        t0 = time.perf_counter()
        many = indexer.score_many(requests)
        many_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        singles = [indexer.score_hashes(FLEET_MODEL, chain) for _, chain in chains]
        single_s = time.perf_counter() - t0
    finally:
        indexer.shutdown()
    bad = sum(m.block_hashes != chain or m.scores != plain_longest_prefix(chain, held)
              or s.scores != plain_longest_prefix(chain, held)
              for (_, chain), m, s in zip(chains, many, singles))
    if bad:
        failures.append(f"{bad} of {len(chains)} chains score apart from the plain replay")
    apart = None
    if ref is not None:
        apart = sum((m.scores, m.match_blocks) != r1 or (s.scores, s.match_blocks) != r2
                    for m, s, r1, r2 in zip(many, singles, ref["many"], ref["singles"]))
        if apart:
            failures.append(f"{apart} of {len(chains)} chains score apart from phase 12a's "
                            f"ShardedIndex")
    fallbacks = native_index.fallback_total() - fallbacks
    if fallbacks:
        failures.append(f"{fallbacks} batches fell back to the Python path")
    log(f"  {len(chains)} chains: score_many {many_s * 1e6 / len(chains):.1f} us/chain "
        f"(tokenize + derive + one native crossing), score_hashes "
        f"{single_s * 1e6 / len(chains):.1f} us/chain; {bad} off the plain replay, "
        f"{'not compared' if apart is None else apart} off the ShardedIndex; fallbacks "
        f"{fallbacks}")
    out = dict(pods=n_pods, blocks_stored=n_blocks, blocks_removed=n_removed,
               batches=len(messages), digest_s=digest_s, blocks_per_s=n_blocks / digest_s,
               last_drain_s=drain_s, score_many_us=many_s * 1e6 / len(chains),
               score_hashes_us=single_s * 1e6 / len(chains), setup_s=setup_s,
               counters=counters, arena=status, fallbacks=fallbacks, apart_from_sharded=apart)
    if cost_aware:
        # A stored tail whose parent's engine mapping the budget evicted is
        # keyed from the root (the reference's digest rule): those keys, per
        # pod, are the only entries a budgeted index may hold outside the
        # replay.
        pods = {f"pod-{p:02d}" for p in range(min(n_pods, COST_AWARE_PODS))}
        root = hashing.init_hash("")
        orphans = {(h, pod, "gpu") for _, tail, _, pod in convs if pod in pods
                   for h in hashing.prefix_hashes_fast(root, tail, PAGE)}
        out["cost_aware"] = cost_aware_replays(
            [m for m in messages if m.pod_identifier in pods],
            {x for x in want if x[1] in pods}, orphans, failures)
    out["run_s"] = time.perf_counter() - t_phase
    log(f"  phase 14a ran {out['run_s']:.1f} s (limit {PHASE_14A_LIMIT_S:.0f} s) at "
        f"{n_pods} pods")
    if failures:
        raise AssertionError(f"phase 14a: {failures}")
    return out


def cost_aware_replays(messages, want: set, orphans: set, failures: list) -> dict:
    """The same stream into the cost-aware index: with a budget that holds
    it all (its contents must equal the replay, nothing evicted), then with
    a quarter of the bytes that run held (the bytes held stay within the
    budget, something is evicted, and every kept entry is in the replay or
    is one of `orphans`: a tail keyed from the root because its parent's
    mapping was evicted first)."""
    tp = ChunkedTokenDatabase(TokenProcessorConfig(block_size=PAGE))
    full = CostAwareMemoryIndex(CostAwareIndexConfig(max_size_bytes="4GiB"))
    full_s, _, counters = digest_stream(full, tp, messages)
    held_bytes = full.total_cost_bytes
    got = index_pairs(full)
    if got != want or any(full.eviction_stats.values()) or counters["dropped"]:
        failures.append(f"cost_aware (4GiB) holds {len(got)} pairs of {len(want)}, evicted "
                        f"{full.eviction_stats}, {counters}")
    del full
    budget = held_bytes // 4
    small = CostAwareMemoryIndex(CostAwareIndexConfig(max_size_bytes=budget))
    small_s, _, counters = digest_stream(small, tp, messages)
    kept = index_pairs(small)
    rooted = kept - want
    if small.total_cost_bytes > budget or not rooted <= orphans \
            or not small.eviction_stats["lru"]:
        failures.append(f"cost_aware at a quarter budget ({budget} B): holds "
                        f"{small.total_cost_bytes} B, {len(rooted - orphans)} entries in neither "
                        f"the replay nor the root-keyed tails, evicted {small.eviction_stats}")
    out = dict(full_s=full_s, held_bytes=held_bytes, quarter_budget=budget, quarter_s=small_s,
               quarter_held_bytes=small.total_cost_bytes, quarter_kept=len(kept),
               quarter_root_keyed=len(rooted), quarter_evictions=dict(small.eviction_stats),
               replay_pairs=len(want))
    log(f"  cost_aware, the streams of {len({m.pod_identifier for m in messages})} pods "
        f"({len(messages)} batches): the "
        f"whole of them in {full_s:.2f} s holds {held_bytes} B, every pair of the replay; at a "
        f"quarter ({budget} B) in {small_s:.2f} s it holds "
        f"{small.total_cost_bytes} B: {len(kept) - len(rooted)} of the replay's {len(want)} "
        f"pairs and {len(rooted)} root-keyed tail entries; evictions {small.eviction_stats}")
    return out


# Phase 14b: chat requests over four flagship pods, routed by load blend.
CHAT_USER = 96  # tokens of a user turn
CHAT_REPLY = 32  # tokens of an assistant turn
CHAT_TURNS = 3
READ_PLANE_RUNS = (("load_blend", 8), ("prefix_only", 8), ("load_blend", 1))
LOAD_WEIGHT = 1.0


def chat_fixture() -> tuple:
    """The committed chat template and the rendered strings that tier-1
    holds against transformers (tests/test_torch_chat.py)."""
    fixture = json.loads((CHAT_DIR / "rendered.json").read_text())
    return (CHAT_DIR / fixture["template"]).read_text(), fixture["cases"]


def chat_traffic(seed: int, vocab: int, template: str, tok) -> list:
    """Phase 14b's waves of RenderRequests over 12b's 8 system prompts:
    waves 0-2 carry turns 1-3 of 8 conversations (conversation c on system
    prompt c; a seeded user turn of CHAT_USER tokens each, the earlier turns
    answered by seeded replies of CHAT_REPLY), wave 3 the first turns of 8
    new conversations on system prompt 0 (a later cohort of one tenant's
    users). Each request carries its rendered prompt's token ids."""
    rng = np.random.default_rng(seed + 14)
    systems = system_prompts(np.random.default_rng(seed + 12), vocab)

    def turn(n):
        return words(rng.integers(0, vocab, n).tolist())

    convs = [[{"role": "system", "content": words(systems[c])}] for c in range(FLEET_SYSTEMS)]
    waves = []
    for t in range(CHAT_TURNS):
        for conv in convs:
            if t:
                conv.append({"role": "assistant", "content": turn(CHAT_REPLY)})
            conv.append({"role": "user", "content": turn(CHAT_USER)})
        waves.append([(c, t, [dict(m) for m in convs[c]]) for c in rng.permutation(FLEET_SYSTEMS)])
    cohort = [[{"role": "system", "content": words(systems[0])},
               {"role": "user", "content": turn(CHAT_USER)}] for _ in range(FLEET_SYSTEMS)]
    waves.append([(FLEET_SYSTEMS + i, 0, m) for i, m in enumerate(cohort)])
    out = []
    for wave in waves:
        out.append([])
        for conv, t, messages in wave:
            request = RenderRequest(conversations=[messages], chat_template=template,
                                    model_name=READ_PLANE_MODEL)
            tokens = tok.encode(tok.render_chat_template(request), READ_PLANE_MODEL).tokens
            out[-1].append(dict(conv=int(conv), turn=t, request=request, tokens=tokens))
    return out


READ_PLANE_MODEL = "llama-flagship-1.14b"


def read_plane_pods(params, cfg, pool, index) -> dict:
    """Four bf16 flagship pods (shared weights) whose sinks pack their event
    batches into `pool`, each with a host tier that always transfers, eager
    staging (a finished sequence's pages are staged, so the index names a
    peer's copy "cpu" and its transfer server serves it) and a peer
    resolver over the shared index."""
    pods = {}
    for pid in FLEET_POD_IDS:
        seq = iter(range(1 << 62))

        def sink(batch, pid=pid, seq=seq):
            pool.add_task(Message(topic=f"kv@{pid}@{READ_PLANE_MODEL}",
                                  payload=batch.to_msgpack(), seq=next(seq), pod_identifier=pid,
                                  model_name=READ_PLANE_MODEL))

        pods[pid] = EnginePod(
            EnginePodConfig(pod_id=pid, model_name=READ_PLANE_MODEL, n_pages=FLEET_POD_PAGES,
                            page_size=PAGE, device_tier="gpu", max_pages_per_seq=96,
                            model_config=cfg, device=params["embed"].device,
                            enable_host_tier=True, transfer_cost_model=ALWAYS_TRANSFER,
                            eager_stage=True),
            event_sink=sink, params=params)
    addrs = {pid: pod.transfer_address for pid, pod in pods.items()}
    for pid, pod in pods.items():
        pod.set_peer_resolver(IndexBackedPeerResolver(index, READ_PLANE_MODEL, addrs, pid))
    return pods


def held_run(index, chain, pod: str, tier: str, others: bool = False) -> int:
    """Leading blocks of `chain` that `pod` (with `others`: any other pod)
    holds at `tier`, by the index."""
    if not chain:
        return 0
    keys = [Key(READ_PLANE_MODEL, h) for h in chain]
    hits = index.lookup(keys, set())
    n = 0
    for key in keys:
        if not any((e.pod_identifier != pod if others else e.pod_identifier == pod)
                   and e.device_tier == tier for e in hits.get(key, ())):
            break
        n += 1
    return n


def queue_depth(sched) -> int:
    return len(sched._waiting) + len(sched._running)


def plain_route(policy: str, scores: dict, loads: dict, rr: int):
    """The routing choice recomputed in plain Python: load blend's
    utility = prefix_frac - w * load_index (load_index = queue depth / 4,
    the policy's default norm, here the only signal), max then the
    lexicographic-min pod; prefix only, the top score (ties and no cache
    round robin). Returns (choice, whether load blend overrode the prefix
    argmax)."""
    pods = list(FLEET_POD_IDS)
    if policy == "prefix_only":
        best = max(scores.values(), default=None)
        tied = [p for p in pods if scores.get(p) == best] if scores else pods
        return tied[rr % len(tied)], False
    top = max(scores.values()) if scores else 0.0
    util = {p: ((scores.get(p, 0.0) / top) if top else 0.0) - LOAD_WEIGHT * (loads[p] / 4.0)
            for p in pods}
    best = max(util.values())
    choice = min(p for p, u in util.items() if u == best)
    prefix = min((p for p, s in scores.items() if s == top), default=None)
    return choice, prefix is not None and choice != prefix


def read_plane_run(params, cfg, waves, policy: str, max_batch: int,
                   prefetcher_cls=RoutePrefetcher) -> dict:
    """One policy over the waves on four fresh pods. Per request: report
    each pod's Scheduler queue depth to the PodLoadTracker (`now` explicit),
    score the RenderRequest through get_pod_scores_ex, choose with
    RoutingPolicy.select (prefix only: the top score), hand the chosen pod
    its missing tail through the RoutePrefetcher, drain it, wait for the
    peer fetches the index predicts, and queue the request on the pod's
    Scheduler. Then serve every pod's queue. Bars: the prefetch, the
    landing, the index and the routing choices."""
    indexer = native_indexer(WordTokenizer(ChatTemplatingProcessor()))
    index = indexer.kv_block_index
    pool = EventPool(EventPoolConfig(concurrency=4), index, indexer.token_processor)
    pool.start(with_subscriber=False)
    indexer.run()
    pods = read_plane_pods(params, cfg, pool, index)
    clock = [1000.0]
    tracker = PodLoadTracker(clock=lambda: clock[0])
    router = RoutingPolicy(RoutingPolicyConfig(policy=policy, load_weight=LOAD_WEIGHT),
                           load_tracker=tracker)
    prefetcher = prefetcher_cls(lambda pid, hashes: pods[pid].prefetch_hashes(hashes))
    tp = indexer.token_processor
    fallbacks = native_index.fallback_total()
    rr, records, failures = 0, [], []
    tokens, requests, cached, ttft = {}, {}, {}, []
    times = dict(render_ms=[], read_ms=[], route_ms=[], prefetch_wait_ms=[])
    try:
        for w, wave in enumerate(waves):
            scheds = {pid: Scheduler(pod, max_batch=max_batch, prefill_token_budget=512,
                                     decode_steps=1) for pid, pod in pods.items()}
            routed = {}
            for j, q in enumerate(wave):
                clock[0] += 1.0
                now = clock[0]
                loads = {pid: queue_depth(s) for pid, s in scheds.items()}
                for pid, depth in loads.items():
                    tracker.report(pid, queue_depth=depth, now=now)
                t0 = time.perf_counter()
                indexer.tokenizers_pool.tokenizer.render_chat_template(q["request"])
                times["render_ms"].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                ps = indexer.get_pod_scores_ex("", READ_PLANE_MODEL, list(pods),
                                               render_request=q["request"])
                times["read_ms"].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                choice = router.select(ps.scores, list(pods), now=now)
                if choice is None:  # prefix only: the top score, ties round robin
                    choice = plain_route("prefix_only", ps.scores, loads, rr)[0]
                times["route_ms"].append((time.perf_counter() - t0) * 1e3)
                chain = [k.chunk_hash for k in tp.tokens_to_kv_block_keys(
                    None, q["tokens"], READ_PLANE_MODEL)]
                if ps.block_hashes != chain:
                    failures.append(f"wave {w} request {j}: the indexer's chain ({len(ps.block_hashes)} "
                                    f"blocks) is not the rendered prompt's ({len(chain)})")
                device = held_run(index, chain, choice, "gpu")
                tail = ps.missing_tail(choice)
                head = tail[:held_run(index, tail, choice, "cpu", others=True)]
                tier = pods[choice].tier_store
                with tier._mu:  # the ready buffer: payloads fetched, not yet landed
                    ready = set(tier._ready)
                expect = min(sum(h not in ready for h in head),
                             pods[choice].config.prefetch_capacity_blocks - len(ready))
                before = tier.stats["prefetched"]
                t0 = time.perf_counter()
                prefetcher.submit_route(choice, ps)
                prefetcher.drain()
                deadline = time.perf_counter() + 5.0
                while tier.stats["prefetched"] - before < expect and time.perf_counter() < deadline:
                    time.sleep(0.002)
                fetched = tier.stats["prefetched"] - before
                times["prefetch_wait_ms"].append((time.perf_counter() - t0) * 1e3)
                if fetched != expect:
                    failures.append(f"wave {w} request {j} on {choice}: the prefetcher fetched "
                                    f"{fetched} blocks, the index's peer-held head of the "
                                    f"missing tail is {expect}")
                rid = scheds[choice].submit(prompt_tokens=q["tokens"], max_new_tokens=FLEET_NEW)
                routed[(choice, rid)] = j
                records.append(dict(wave=w, request=j, conv=q["conv"], turn=q["turn"], rr=rr,
                                    pod=choice, scores=dict(ps.scores),
                                    match=dict(ps.match_blocks), loads=loads, device=device,
                                    tail=len(tail), peer_head=len(head), fetched=fetched))
                rr += 1
            wave_records = records[-len(wave):]
            for pid, sched in scheds.items():
                if not sched.has_work:
                    continue
                device_of = {rid: wave_records[j]["device"]
                             for (p, rid), j in routed.items() if p == pid}
                r = serve_routed(pods[pid], sched, device_of)
                failures += [f"wave {w} {pid}: {f}" for f in r["failures"]]
                for rid, req in r["done"].items():
                    j = routed[(pid, rid)]
                    tokens[(w, j)], requests[(w, j)] = req.generated, req
                    cached[(w, j)] = req.num_cached_tokens
                    ttft.append((r["first_token_s"][rid], req.num_cached_tokens > 0))
            for pod in pods.values():
                pod.tier_store.drain_async_stages()
            pool.drain()
            pairs = index_pairs(index)
            for pid, pod in pods.items():
                committed = set(pod.block_manager.cached_hashes())
                on_gpu = {h for h, p, tier in pairs if p == pid and tier == "gpu"}
                on_cpu = {h for h, p, tier in pairs if p == pid and tier == "cpu"}
                if committed != on_gpu:
                    failures.append(f"wave {w} {pid}: index {len(on_gpu)} gpu blocks, pod "
                                    f"{len(committed)} ({len(on_gpu - committed)} extra)")
                if pod.tier_store.staged_subset(on_cpu) != on_cpu or \
                        pod.tier_store.staged_count != len(on_cpu):
                    failures.append(f"wave {w} {pid}: index {len(on_cpu)} cpu blocks, host "
                                    f"store {pod.tier_store.staged_count}")
        counters = dict(dropped=pool.dropped_events, removals_lost=pool.removals_lost,
                        prefetch_dropped=prefetcher.stats["dropped"],
                        fallbacks=native_index.fallback_total() - fallbacks)
        if any(counters.values()):
            failures.append(f"counters {counters}")
        tier_stats = {pid: dict(pod.tier_store.stats) for pid, pod in pods.items()}
    finally:
        prefetcher.close()
        indexer.shutdown()
        pool.shutdown()
        for pod in pods.values():
            pod.close()
    overrides = 0
    for rec in records:
        want, overrode = plain_route(policy, rec["scores"], rec["loads"], rec["rr"])
        overrides += overrode
        if rec["pod"] != want:
            failures.append(f"wave {rec['wave']} request {rec['request']}: routed to "
                            f"{rec['pod']}, the plain utility picks {want}")
    if router.stats["overrides"] != overrides:
        failures.append(f"the policy counted {router.stats['overrides']} overrides, the plain "
                        f"recomputation {overrides}")
    prompt_tokens = sum(len(q["tokens"]) for wave in waves for q in wave)
    hit_ms = [t * 1e3 for t, hit in ttft if hit]
    return dict(tokens=tokens, requests=requests, failures=failures, counters=counters,
                cached={f"{w}.{j}": c for (w, j), c in cached.items()},
                hit_rate=sum(cached.values()) / prompt_tokens,
                ttft_median_ms=statistics.median(t for t, _ in ttft) * 1e3,
                ttft_hit_median_ms=statistics.median(hit_ms) if hit_ms else None,
                ttft_ms=[t * 1e3 for t, _ in ttft], overrides=overrides,
                policy_stats=dict(router.stats), prefetcher=prefetcher.status(),
                prefetched_blocks=sum(r["fetched"] for r in records),
                peer_head_blocks=sum(r["peer_head"] for r in records),
                landed_blocks=sum(s["onboards"] + s["restores"] for s in tier_stats.values()),
                tier_stats=tier_stats, routes=[(r["wave"], r["request"], r["pod"])
                                               for r in records],
                **{k: dict(median=statistics.median(v), max=max(v)) for k, v in times.items()})


def serve_routed(pod, sched, device_of: dict) -> dict:
    """Step a pod's Scheduler until its queue drains. At each step that
    admits requests, their cached tokens must equal 16 x (the blocks the
    index said were on the pod's device + the blocks the host tier landed
    in that step): a prefetched block is landed at admission, so the
    prediction plus the landing is exact."""
    sync()
    t0 = time.perf_counter()
    first, done, failures = {}, {}, []
    while sched.has_work:
        pending = [r for r in sched._waiting if r.state is None]
        stats = pod.tier_store.stats
        landed0 = stats["onboards"] + stats["restores"]
        finished = sched.step()
        now = time.perf_counter()
        landed = stats["onboards"] + stats["restores"] - landed0
        admitted = [r for r in pending if r.state is not None]
        got = sum(r.num_cached_tokens for r in admitted)
        want = PAGE * (sum(device_of[r.req_id] for r in admitted) + landed)
        if got != want:
            failures.append(f"requests {[r.req_id for r in admitted]} admitted with {got} cached "
                            f"tokens, the index and the landing predict {want}")
        done.update({r.req_id: r for r in finished})
        for r in [*sched._running, *sched._waiting, *finished]:
            if r.generated and r.req_id not in first:
                first[r.req_id] = now - t0
    if sched.preemptions:
        failures.append(f"{sched.preemptions} preemptions")
    return dict(done=done, first_token_s=first, failures=failures)


def phase_read_plane(params, cfg, seed: int) -> dict:
    log(f"== phase 14b: chat requests over four bf16 flagship pods ({FLEET_POD_PAGES} pages of "
        f"{PAGE}, host tiers, eager staging) behind the native index: {CHAT_TURNS} turns of 8 "
        f"conversations and a cohort of 8 on one system prompt, rendered from the committed "
        f"template, routed by load blend (weight {LOAD_WEIGHT}) and by prefix only, the chosen "
        f"pod's missing tail prefetched; batched (max_batch 8), and load blend again alone")
    t_phase = time.perf_counter()
    template, cases = chat_fixture()
    chat = ChatTemplatingProcessor()
    failures = []
    for c in cases:
        req = dict(c["request"])
        got = chat.render(RenderRequest(chat_template=template, **req))
        if got != c["rendered"]:
            failures.append(f"fixture case {req}: rendered {got!r}")
    tok = WordTokenizer(chat)
    waves = chat_traffic(seed, cfg.vocab_size, template, tok)
    last = {}
    for wave in waves:
        for q in wave:
            prev = last.get(q["conv"])
            if prev is not None and q["tokens"][:len(prev)] != prev:
                failures.append(f"conversation {q['conv']} turn {q['turn'] + 1} does not "
                                f"extend turn {q['turn']}")
            last[q["conv"]] = q["tokens"]
    n_req = sum(len(w) for w in waves)
    log(f"  {len(cases)} fixture renders checked; {n_req} requests of "
        f"{min(len(q['tokens']) for w in waves for q in w)}-"
        f"{max(len(q['tokens']) for w in waves for q in w)} tokens")
    card = card_line()
    ref_pod = EnginePod(
        EnginePodConfig(pod_id="pod-ref", model_name="ref", n_pages=2048, page_size=PAGE,
                        device_tier="gpu", max_pages_per_seq=96, model_config=cfg,
                        device=params["embed"].device), params=params)
    want = {(w, j): serve_share(ref_pod, [q], 1)["tokens"][0]
            for w, wave in enumerate(waves) for j, q in enumerate(wave)}
    del ref_pod
    torch.cuda.empty_cache()
    out, batched = {}, {}
    reset_launch_counts()
    for policy, max_batch in READ_PLANE_RUNS:
        run = f"{policy} batch {max_batch}"
        res = read_plane_run(params, cfg, waves, policy, max_batch)
        off = [k for k in want if res["tokens"][k] != want[k]]
        if max_batch == 1 and off:
            res["failures"].append(f"{len(off)} requests' greedy tokens differ from the "
                                   f"never-evicting pod: first {off[0]}")
        if policy == "load_blend" and not (res["overrides"] and res["prefetched_blocks"]):
            res["failures"].append(f"load blend overrode {res['overrides']} routes and "
                                   f"prefetched {res['prefetched_blocks']} blocks")
        failures += [f"{run}: {f}" for f in res["failures"]]
        log(f"  {run} ({card}): prefix-hit rate {res['hit_rate']:.4f}, TTFT median "
            f"{res['ttft_median_ms']:.2f} ms (of hits {res['ttft_hit_median_ms'] or 0:.2f}); "
            f"overrides {res['overrides']}; prefetched {res['prefetched_blocks']} blocks of "
            f"{res['peer_head_blocks']} peer-held, landed {res['landed_blocks']}; prefetcher "
            f"{res['prefetcher']['stats']}; render {res['render_ms']['median']:.3f} ms, read "
            f"path {res['read_ms']['median']:.3f} ms, route {res['route_ms']['median']:.4f} ms, "
            f"prefetch wait {res['prefetch_wait_ms']['median']:.2f} ms (medians); routes "
            f"{res['routes']}; {len(off)} of {len(want)} apart from the never-evicting pod; "
            f"{len(res['failures'])} failures")
        res["tokens_apart"] = len(off)
        if max_batch > 1:
            batched[policy] = (res.pop("tokens"), res.pop("requests"))
        else:
            res.pop("tokens"), res.pop("requests")
        out[run] = res
    launches = launch_counts()
    log(f"  kernel launches in the three runs: {launches}")
    for name in ("paged_decode", "flash_prefill"):
        if launches[name] <= 0:
            failures.append(f"{name} was never launched on the read plane's path")
    params32, cfg32 = f32_twin(params, cfg)
    delta, e = teacher_forced_delta(params, cfg, params32, cfg32, False)
    for policy, (tokens, requests) in batched.items():
        keys = sorted(tokens)
        traffic = [dict(prompt_tokens=waves[w][j]["tokens"], sampling=None) for w, j in keys]
        bar = teacher_forced_bar(params32, cfg32, traffic, [requests[k] for k in keys], delta)
        log(f"    {policy} batch 8, teacher-forced bar: greedy worst "
            f"{bar['worst']['greedy']:.4f} over {bar['tokens_checked']['greedy']} tokens "
            f"(delta {delta:.4f}: the bf16 plain path is {e:.4f} off the truth)")
        if not bar["ok"]:
            failures.append(f"{policy} batch 8: teacher-forced bar {bar}")
        out[f"{policy} batch 8"]["bar"] = bar
    del params32
    torch.cuda.empty_cache()
    out.update(card=card, launches=launches, seconds=time.perf_counter() - t_phase)
    log(f"  phase 14b took {out['seconds']:.1f} s")
    if failures:
        raise AssertionError(f"phase 14b: {failures[:6]}")
    return out


# -- phase 13: the Qwen2 family at published widths ---------------------------

# The config.json fields of Qwen/Qwen2.5-7B and Qwen/Qwen2.5-0.5B that the
# port's hf_loader.config_from_hf reads, as plain attribute objects (the card
# has no transformers, and nothing is downloaded). Both are served whole:
# no depth cut.
QWEN_HF = {
    "qwen2.5-7b": dict(
        model_type="qwen2", hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
        num_attention_heads=28, num_key_value_heads=4, vocab_size=152064,
        rope_theta=1000000.0, rms_norm_eps=1e-6, max_position_embeddings=131072,
        use_sliding_window=False, sliding_window=131072, max_window_layers=28,
        tie_word_embeddings=False),
    "qwen2.5-0.5b": dict(
        model_type="qwen2", hidden_size=896, intermediate_size=4864, num_hidden_layers=24,
        num_attention_heads=14, num_key_value_heads=2, vocab_size=151936,
        rope_theta=1000000.0, rms_norm_eps=1e-6, max_position_embeddings=32768,
        use_sliding_window=False, sliding_window=32768, max_window_layers=24,
        tie_word_embeddings=True),
}
# The q/k/v biases are drawn (init_params makes them 0, which would leave the
# biased path unchecked): normal with these deviations, beside projections of
# about 1.2 (7B) and 0.6 (0.5B) per element. A v bias passes through the
# softmax whole (the weights sum to 1), so every position gains the same
# vector; a large one would make the random model's output nearly the same at
# every position. q and k biases move the attention weights only.
QWEN_BIAS_STD = {"bq": 0.5, "bk": 0.5, "bv": 0.05}
QWEN_RUNS = (("bf16", False, 1), ("int8", True, 4))  # 13c: page format, decode_steps


def qwen_model(name: str, seed: int = 0) -> tuple:
    """(config, params) of a phase 13 model on the card: the config through
    config_from_hf, seeded init_params, seeded biases, and for a tied
    checkpoint the head as the embedding's transpose (one tensor)."""
    hf = types.SimpleNamespace(**QWEN_HF[name])
    cfg = hf_loader.config_from_hf(hf)
    if (cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim) != QWEN_SHAPES[name] or not cfg.attn_bias \
            or cfg.sliding_window is not None:
        raise AssertionError(f"{name}: config_from_hf gave {cfg}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init_params(cfg, gen, "cuda")
    for key, std in QWEN_BIAS_STD.items():
        params["layers"][key].normal_(0.0, std, generator=gen)
    if hf.tie_word_embeddings:
        params["out"] = params["embed"].t()
    return cfg, params


def qwen_prefixes(name: str, vocab: int) -> dict:
    """13a's traffic: for each pod, a 1,024-token prefix of its own and 8
    prompts of it + 512 unique tokens."""
    rng = np.random.default_rng(131 if name == "qwen2.5-7b" else 137)
    out = {}
    for fmt in ("bf16", "int8"):
        prefix = rng.integers(0, vocab, 1024).tolist()
        out[fmt] = (prefix, [prefix + rng.integers(0, vocab, 512).tolist() for _ in range(8)])
    return out


def qwen_serving(name: str, params, cfg) -> dict:
    """Phase 13a: a bf16 pod and an int8 pod (page 16) whose BlockStored
    streams one Indexer digests; each serves its 8 prompts one at a time
    (prefill, then 8 greedy decode steps). Cached tokens 0, then 1,024;
    finite logits, tokens in the vocabulary; each pod ranked first for a
    prompt on its own prefix; launches = one per layer pass of each call
    (CallCounter)."""
    index, indexer = moe_indexer()
    traffic = qwen_prefixes(name, cfg.vocab_size)
    out, failures = {}, []
    for fmt, int8 in (("bf16", False), ("int8", True)):
        pod_id = f"pod-{name}-{fmt}"
        pod = EnginePod(
            EnginePodConfig(pod_id=pod_id, model_name=name, n_pages=1024, page_size=PAGE,
                            device_tier="gpu", max_pages_per_seq=256, model_config=cfg,
                            device="cuda", use_quantized_kv=int8),
            event_sink=lambda b, pid=pod_id: digest_batch(index, indexer.token_processor, pid,
                                                          name, b),
            params=params)
        reset_launch_counts()
        cached, ttfts = [], []
        with CallCounter() as counter:
            for r, tokens in enumerate(traffic[fmt][1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, n_cached = pod.prefill(tokens)
                first = int(torch.argmax(pod.last_logits))
                ttfts.append(time.perf_counter() - t0)
                if not torch.isfinite(pod.last_logits).all():
                    failures.append(f"{fmt} request {r}: non-finite prefill logits")
                pod.decode_append(state, first)
                generated = [first] + [pod.decode_step(state) for _ in range(8)]
                if not all(0 <= t < cfg.vocab_size for t in generated):
                    failures.append(f"{fmt} request {r}: token out of vocabulary")
                cached.append(n_cached)
                pod.free(state)
        torch.cuda.synchronize()
        launches = launch_counts()
        if cached != [0] + [1024] * 7:
            failures.append(f"{fmt}: cached tokens {cached}")
        passes = counter.layer_passes()
        if launches != counter.kernels or not passes["decode"] or not passes["prefill"]:
            failures.append(f"{fmt}: launches {launches}, expected {counter.kernels}")
        log(f"  13a {name} {fmt} pod: cached {cached}; prefix-hit TTFT "
            f"{min(ttfts[1:]) * 1e3:.2f}-{max(ttfts[1:]) * 1e3:.2f} ms; layer passes {passes}; "
            f"launches {launches}")
        out[fmt] = dict(cached=cached, ttft_ms=[t * 1e3 for t in ttfts], launches=launches,
                        layer_passes=passes)
        del pod
        torch.cuda.empty_cache()
    scores = {}
    for fmt in ("bf16", "int8"):
        probe = traffic[fmt][0] + np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                                    256).tolist()
        scores[fmt] = chain_scores(indexer, probe, name)
        best = max(scores[fmt], key=scores[fmt].get) if scores[fmt] else None
        log(f"  13a {name}: index scores for the {fmt} pod's prefix: {scores[fmt]}")
        if best != f"pod-{name}-{fmt}" or scores[fmt][best] != 1024 // PAGE:
            failures.append(f"the {fmt} prefix ranks {best} first: {scores[fmt]}")
    if failures:
        raise AssertionError(f"phase 13a ({name}): {failures}")
    out["scores"] = scores
    return out


def qwen_logits(name: str, params, cfg, params32, cfg32) -> dict:
    """Phase 13b: phase 5c's prefill-logits check and phase 6's batch-8 x
    2,048 decode-logits check of every (page format, decode kernel) pair, on
    the model at its full depth. The truth computes logits only at the rows
    the checks read."""
    out = {"prefill": prefill_logits_check(params, cfg, params32, cfg32)}
    for int8 in (False, True):
        for pipelined in (True, False):
            r = batched_decode_check(params, cfg, params32, cfg32, int8, pipelined)
            del r["cache"], r["inputs"]
            out[r["row"]] = r
    torch.cuda.empty_cache()
    failed = [k for k, r in out.items() if not r["ok"]]
    if failed:
        raise AssertionError(f"phase 13b ({name}): logits fail their bars: {failed}")
    return out


def phase_qwen() -> dict:
    log("== phase 13: Qwen2.5-7B and Qwen2.5-0.5B at their published widths (bf16, seeded "
        "weights and q/k/v biases): prefix reuse and routing, logits against an f32 truth, "
        "the Scheduler")
    out = {}
    for name in QWEN_HF:
        t0 = time.perf_counter()
        cfg, params = qwen_model(name)
        n_params = sum(w.numel() for w in params["layers"].values()) + sum(
            params[k].numel() for k in ("embed", "final_norm")) + (
            0 if QWEN_HF[name]["tie_word_embeddings"] else params["out"].numel())
        log(f"  {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_q_heads}/"
            f"{cfg.n_kv_heads} of {cfg.head_dim}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B "
            f"params ({n_params * 2 / 1e9:.2f} GB bf16)")
        params32, cfg32 = f32_twin(params, cfg)
        r = dict(n_params=n_params, serving=qwen_serving(name, params, cfg),
                 logits=qwen_logits(name, params, cfg, params32, cfg32))
        for fmt, int8, steps in QWEN_RUNS:
            delta, e = teacher_forced_delta(params, cfg, params32, cfg32, int8)
            log(f"  13c {name} {fmt} pages: bf16 plain path vs f32 truth {e:.4f}; delta "
                f"{delta:.4f}")
            s = flagship_scheduler_check(params, cfg, params32, cfg32, int8, steps, delta,
                                         model=name)
            r[f"scheduler {fmt} steps{steps}"] = dict(s, plain_err=e)
            if not s["ok"]:
                raise AssertionError(f"phase 13c ({name}, {fmt}): {s['failures']}")
        r["seconds"] = time.perf_counter() - t0
        log(f"  {name}: phase 13 took {r['seconds']:.1f} s")
        out[name] = r
        del params, params32
        torch.cuda.empty_cache()
    # Rows 1, 2 and 5 on 13a's pods and 13c's scheduler runs; rows 3 and 4
    # on 13b's tiled decode steps; both models.
    out["launches"] = {
        row: sum(out[m]["serving"][fmt]["launches"][row] for m in QWEN_HF for fmt in ("bf16",
                                                                                       "int8"))
        + sum(out[m][f"scheduler {fmt} steps{steps}"]["launches"][row]
              for m in QWEN_HF for fmt, _, steps in QWEN_RUNS)
        + sum(out[m]["logits"][row]["launches"] for m in QWEN_HF
              if row in out[m]["logits"])
        for row in KERNELS}
    log(f"  phase 13 launches: {out['launches']}")
    return out

# -- phase 15: the fleet's resilience plane -----------------------------------

RESILIENCE_WAVES = 9
RESILIENCE_STEP_S = 1.0  # the fake clock's step per wave
# A pod publishes about two batches a wave, so a lossy stream can miss a whole
# wave: suspect after two quiet waves, stale after three and a half.
RESILIENCE_HEALTH = dict(suspect_after_s=2.5, stale_after_s=3.5)
# The shape of the reference's fault arms (benchmarking/FLEET_BENCH_FAULTS.json
# config.fault_plan and FLEET_BENCH_DIVERGENCE.json's wipe plan) on four pods,
# in waves: one pod crashes and restarts cold, one pod's stream stalls and
# resumes, one pod's stream drops, duplicates and reorders, one pod is wiped
# without a removal event.
RESILIENCE_PLAN = dict(seed=42, pods={
    "pod-0": dict(silent_wipe_at_s=6.0),
    "pod-1": dict(crash_at_s=1.0, restart_at_s=5.0),
    "pod-2": dict(stall_from_s=1.0, stall_until_s=5.0),
    "pod-3": dict(drop_rate=0.1, duplicate_rate=0.05, reorder_rate=0.1),
})
RESILIENCE_CRASHED, RESILIENCE_STALLED, RESILIENCE_LOSSY = "pod-1", "pod-2", "pod-3"
# Every audit challenges all a pod advertises and asks for all it holds: a
# pod holds at most FLEET_POD_PAGES blocks.
RESILIENCE_AUDIT = dict(interval_s=RESILIENCE_STEP_S, sample_per_pod=4 * FLEET_POD_PAGES,
                        readmit_sample=4 * FLEET_POD_PAGES, device_tier="gpu", host_tier="cpu")
RESILIENCE_MODEL = "llama-flagship-1.14b"


class FakeClock:
    """The plane's one clock: a run is a pure function of the plan and the
    traffic."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def fault_plan(spec: dict) -> FaultPlan:
    return FaultPlan(seed=spec["seed"],
                     pods={pod: PodFaults(**f) for pod, f in spec["pods"].items()})


def route_wave(scored, alive: list) -> list:
    """Precise routing of one wave: each request goes to its top-scored
    routable pod (ties to the least loaded of this wave, then pod order);
    the requests with no cache signal on a routable pod then go, in wave
    order, to the least loaded routable pod. Returns (pod, "score" or
    "fallback") per request."""
    order = {p: i for i, p in enumerate(FLEET_POD_IDS)}
    loads = {p: 0 for p in alive}
    out, fallback = [None] * len(scored), []
    for j, ps in enumerate(scored):
        cand = {p: s for p, s in ps.scores.items() if p in loads}
        if not cand:
            fallback.append(j)
            continue
        best = max(cand.values())
        pid = min((p for p, s in cand.items() if s == best), key=lambda p: (loads[p], order[p]))
        out[j] = (pid, "score")
        loads[pid] += 1
    for j in fallback:
        pid = min(loads, key=lambda p: (loads[p], order[p]))
        out[j] = (pid, "fallback")
        loads[pid] += 1
    return out


def resilience_arm(params, cfg, waves, plan: dict, plane: bool,
                   tracker_cls=FleetHealthTracker, auditor_cls=ResidencyAuditor,
                   autopilot=None) -> dict:
    """One arm of phase 15a on four fresh flagship pods: the waves routed
    precisely, each pod's share batched, with `plan`'s faults injected at
    the pods' delivery into the EventPool, and (with `plane`) the fleet
    health tracker, the anti-entropy tracker and the residency auditor
    wired. `autopilot` (a controller class, with `plane`) attaches phase
    17d's `AutopilotRig`, ticked after every wave's audit and on past the
    last wave until its knobs are home. Checks the arm's bars; returns its
    readings (`trace`: every wave's scores, every route, cached and greedy
    tokens) and failures."""
    t_arm = time.perf_counter()
    device = params["embed"].device
    clock = FakeClock()
    faults = fault_plan(plan)
    injector = FaultInjector(faults, clock)
    tracker = trust = auditor = None
    if plane:
        tracker = tracker_cls(FleetHealthConfig(**RESILIENCE_HEALTH), clock=clock)
        trust = AntiEntropyTracker(clock=clock)
    indexer = Indexer(
        IndexerConfig(token_processor_config=TokenProcessorConfig(block_size=PAGE)),
        tokenization_pool=TokenizationPool(TokenizersPoolConfig(workers=2),
                                           tokenizer=WordTokenizer()),
        fleet_health=tracker, antientropy=trust)
    index = indexer.kv_block_index
    if not plan["pods"]:  # the same index without the plane: the no-fault pin
        twin = Indexer(IndexerConfig(token_processor_config=TokenProcessorConfig(
            block_size=PAGE)), kv_block_index=index)
    pool = EventPool(EventPoolConfig(concurrency=4), index, indexer.token_processor,
                     health_tracker=tracker, divergence=trust)
    pool.start(with_subscriber=False)
    indexer.run()
    wave_of, sent, delivered = [0], {p: [] for p in FLEET_POD_IDS}, {p: [] for p in FLEET_POD_IDS}

    def to_pool(msg):
        delivered[msg.pod_identifier].append((wave_of[0], msg.seq))
        pool.add_task(msg)

    deliver = {pid: injector.wrap(pid, to_pool) for pid in FLEET_POD_IDS}
    seqs = {pid: 0 for pid in FLEET_POD_IDS}

    def new_pod(pid):
        def sink(batch):
            seq = seqs[pid]
            seqs[pid] += 1
            sent[pid].append(seq)
            deliver[pid](Message(topic=f"kv@{pid}@{RESILIENCE_MODEL}",
                                 payload=batch.to_msgpack(), seq=seq, pod_identifier=pid,
                                 model_name=RESILIENCE_MODEL))

        return EnginePod(
            EnginePodConfig(pod_id=pid, model_name=RESILIENCE_MODEL, n_pages=FLEET_POD_PAGES,
                            page_size=PAGE, device_tier="gpu", max_pages_per_seq=96,
                            model_config=cfg, device=device),
            event_sink=sink, params=params)

    pods = {pid: new_pod(pid) for pid in FLEET_POD_IDS}
    down = set()
    if plane:
        auditor = auditor_cls(
            index, RESILIENCE_MODEL,
            lambda pod, dev, host, k: None if pod in down else pods[pod].resident_block_digest(
                dev, host, k),
            tracker=trust, config=AuditorConfig(**RESILIENCE_AUDIT), clock=clock)
    rig = AutopilotRig(auditor, trust, autopilot) if autopilot is not None else None
    wipe_s = max((f.silent_wipe_at_s for f in faults.pods.values()
                  if f.silent_wipe_at_s is not None), default=None)
    failures, cached, ttft, routes, states, drained = [], {}, [], [], [], []
    generated, wave_scores = {}, []
    phantom_routes, purge_checks, repair_checks, purged_seen = 0, [], 0, {}
    prev_stale = set()
    try:
        for w, wave in enumerate(waves):
            clock.t = w * RESILIENCE_STEP_S
            wave_of[0] = w
            for pid, f in faults.pods.items():
                if f.silent_wipe_at_s == clock.t:  # its cache replaced, its removals lost
                    pods[pid] = new_pod(pid)
                if f.crashed(clock.t):
                    down.add(pid)
                elif pid in down:  # restart: a cold pod, a fresh publisher
                    down.discard(pid)
                    seqs[pid] = 0
                    pods[pid] = new_pod(pid)
                    pods[pid].block_manager.clear()  # announces its empty cache
            pool.drain()
            before = index_pairs(index) if plane else None
            scored = indexer.score_many([ScoreRequest(words(q["tokens"]), RESILIENCE_MODEL)
                                         for q in wave])
            wave_scores.append([(ps.scores, ps.match_blocks) for ps in scored])
            stale = {p for p in FLEET_POD_IDS if plane and tracker.state_of(p) == STALE}
            states.append({p: tracker.state_of(p) for p in FLEET_POD_IDS} if plane else {})
            alive = [p for p in FLEET_POD_IDS if p not in down]
            route = route_wave(scored, alive)
            if plane:
                for pid in stale - prev_stale:  # detected at this call: the purge bar
                    got = tracker.summary()["pods"][pid]["purged_entries"] - purged_seen.get(pid, 0)
                    want = sum(1 for _, p, _ in before if p == pid)
                    purge_checks.append((w, pid, got, want))
                    if got != want:
                        failures.append(f"wave {w}: {pid} quarantined with {got} entries "
                                        f"purged, {want} indexed at that moment")
                for j, ps in enumerate(scored):
                    named = set(ps.scores) & stale
                    if named:
                        failures.append(f"wave {w} request {j}: a score names stale {named}")
                    if route[j][1] == "score" and route[j][0] in stale:
                        failures.append(f"wave {w} request {j}: routed by score to stale "
                                        f"{route[j][0]}")
                if not plan["pods"]:
                    for j, ps in enumerate(scored):  # the no-fault pin
                        bare = twin.score_hashes(RESILIENCE_MODEL, ps.block_hashes)
                        if (bare.scores, bare.match_blocks) != (ps.scores, ps.match_blocks):
                            failures.append(f"wave {w} request {j}: scores with the plane "
                                            f"{ps.scores} differ from without {bare.scores}")
                    if route_wave([twin.score_hashes(RESILIENCE_MODEL, ps.block_hashes)
                                   for ps in scored], alive) != route:
                        failures.append(f"wave {w}: routes differ with and without the plane")
            prev_stale = stale
            share = {pid: [] for pid in FLEET_POD_IDS}
            for j, (q, ps, (pid, kind)) in enumerate(zip(wave, scored, route)):
                share[pid].append((j, q, PAGE * ps.match_blocks.get(pid, 0)))
                routes.append((w, j, pid, kind))
            for pid, reqs in share.items():
                if not reqs:
                    continue
                r = serve_share(pods[pid], [q for _, q, _ in reqs], 8)
                for (j, q, pred), done, first in zip(reqs, r["requests"], r["first_token_s"]):
                    cached[(w, j)] = done.num_cached_tokens
                    generated[(w, j)] = list(done.generated)
                    if rig is not None:
                        rig.served(clock.t, done.num_cached_tokens, len(q["tokens"]))
                    ttft.append(first)
                    phantom_routes += pred > done.num_cached_tokens
                    # The routing bar: exact wherever the index is held true
                    # (every wave of a run without faults; after the auditor's
                    # first round past the wipe otherwise).
                    settled = not plan["pods"] or (wipe_s is not None and clock.t > wipe_s)
                    if plane and settled and done.num_cached_tokens != pred:
                        failures.append(f"wave {w} request {j} on {pid}: cached "
                                        f"{done.num_cached_tokens}, the index predicted {pred}")
            pool.drain()
            if plane:
                drained.append({p: tracker.state_of(p) for p in FLEET_POD_IDS})
                auditor.tick(clock.t)
                if rig is not None and w == 0:
                    rig.clock.t = clock.t
                    rig.start()
                elif rig is not None:
                    rig.tick(clock.t)
                purged_seen = {p: d["purged_entries"]
                               for p, d in tracker.summary()["pods"].items()}
                if not plan["pods"] or (wipe_s is not None and clock.t >= wipe_s):
                    pairs = index_pairs(index)
                    for pid, pod in pods.items():
                        indexed = {(h, tier) for h, p, tier in pairs if p == pid}
                        want = (set() if tracker.state_of(pid) == STALE else
                                {(h, "gpu") for h in pod.block_manager.cached_hashes()})
                        repair_checks += 1
                        if indexed != want:
                            failures.append(f"wave {w} {pid} after the audit: index "
                                            f"{len(indexed)} blocks, pod {len(want)} "
                                            f"({len(indexed - want)} extra, "
                                            f"{len(want - indexed)} missing)")
        injector.flush()
        pool.drain()
        counters = dict(dropped=pool.dropped_events, removals_lost=pool.removals_lost)
        if counters != dict(dropped=0, removals_lost=0):
            failures.append(f"pool counters {counters}")
    finally:
        indexer.shutdown()
        pool.shutdown()
    out = dict(trace=dict(scores=wave_scores, routes=routes, cached=cached, tokens=generated),
               sent={p: len(s) for p, s in sent.items()},
               delivered_by_wave={p: [sum(1 for w, _ in d if w == wi) for wi in range(len(waves))]
                                  for p, d in delivered.items()},
               phantom_routes=phantom_routes, injected=dict(injector.injected),
               routes_by_kind={k: sum(1 for r in routes if r[3] == k)
                               for k in ("score", "fallback")})
    prompt_tokens = sum(len(q["tokens"]) for wave in waves for q in wave)
    out.update(hit_rate=sum(cached.values()) / prompt_tokens,
               ttft_median_ms=statistics.median(ttft) * 1e3)
    if plane:
        summary = tracker.summary()
        out.update(states=states, purge_checks=purge_checks, repair_checks=repair_checks,
                   anomalies=tracker.anomaly_totals(), auditor=auditor.status(),
                   trust=trust.status()["totals"],
                   detection_latency_s={p: d["detection_latency_s"]
                                        for p, d in summary["pods"].items()},
                   recoveries={p: d["recoveries"] for p, d in summary["pods"].items()},
                   purged={p: d["purged_entries"] for p, d in summary["pods"].items()})
        if plan["pods"]:
            failures += resilience_bars(out, summary, sent, delivered, states, drained)
        else:
            quiet = dict(purged=sum(out["purged"].values()),
                         phantoms=out["auditor"]["phantoms_purged"],
                         readmitted=out["auditor"]["blocks_readmitted"],
                         anomalies=sum(out["anomalies"].values()))
            if any(quiet.values()):
                failures.append(f"the plane acted on a fleet without faults: {quiet}")
    if rig is not None:
        rig.settle(clock.t)
        out["autopilot"] = rig.readings()
        failures += [f"autopilot: {f}" for f in out["autopilot"]["failures"]]
    out.update(failures=failures, seconds=time.perf_counter() - t_arm)
    return out


def autopilot_arms(params, cfg, waves, healthy: dict, bare=None,
                   controller_cls=AutopilotController) -> dict:
    """Phase 17d on phase 15a: `healthy` is 15a's no-fault arm with the
    autopilot attached, and a fourth arm runs the plan with the plane and
    the autopilot. Bars: healthy, no actuation, the knob at its baseline,
    and (where `bare`, the no-fault arm without the autopilot, is given) the
    same scores, routes, cached and greedy tokens as `bare`; under the plan,
    actuations, each inside its knob's bounds and one max_step, journaled,
    the knob back at baseline after the faults, and 15a's bars. The whole
    run gives no `bare` (a cut, printed: one 15a arm less); tier-1's
    rehearsal and `--phases 17d` hold the identity."""
    arms = {"faults_plane_autopilot": resilience_arm(params, cfg, waves, RESILIENCE_PLAN, True,
                                                     autopilot=controller_cls)}
    failures = [f"17d faults_plane_autopilot: {f}"
                for f in arms["faults_plane_autopilot"]["failures"]]
    ap, plan = healthy["autopilot"], arms["faults_plane_autopilot"]["autopilot"]
    if ap["actuations"] or ap["journal"] or not ap["at_baseline"]:
        failures.append(f"17d: the autopilot acted on a fleet without faults: {ap}")
    if bare is not None:
        for key in ("scores", "routes", "cached", "tokens"):
            if healthy["trace"][key] != bare["trace"][key]:
                failures.append(f"17d: {key} differ with the autopilot attached to the "
                                f"no-fault arm")
    if not plan["actuations"] or not plan["reverts"] or not plan["at_baseline"]:
        failures.append(f"17d: under the plan the autopilot made {plan['actuations']} "
                        f"actuations, {plan['reverts']} reverts, at baseline "
                        f"{plan['at_baseline']}")
    return dict(arms=arms, healthy=ap, compared_to_bare=bare is not None, failures=failures)


def report_autopilot(out: dict, healthy: dict, card: str) -> None:
    ap = out["healthy"]
    same = ("the same scores, routes, cached and greedy tokens as the arm without it"
            if out["compared_to_bare"] else "cut: no second no-fault arm without the "
            "autopilot (tier-1's rehearsal holds that identity)")
    log(f"== phase 17d on 15a's no-fault arm ({card}): {ap['actuations']} actuations, journal "
        f"{ap['journal']}, at baseline {ap['at_baseline']}, bad/total {ap['counts']}; hit rate "
        f"{healthy['hit_rate']:.4f}; {same}")
    for name, arm in out["arms"].items():
        ap = arm["autopilot"]
        log(f"== phase 17d {name} ({card}): {ap['actuations']} actuations ({ap['reverts']} "
            f"reverts), journal {ap['journal']}, at baseline {ap['at_baseline']}, bad/total "
            f"by wave {ap['by_wave']}; hit rate {arm['hit_rate']:.4f}, phantom routes "
            f"{arm['phantom_routes']}, {arm['seconds']:.1f} s, {len(arm['failures'])} failures")
    log(f"  launches in the faulted autopilot arm: {out['launches']}")


def resilience_bars(out: dict, summary: dict, sent: dict, delivered: dict, states: list,
                    drained: list) -> list:
    """Phase 15a's detection and anomaly bars on the faulted, wired arm:
    `states` holds each pod's state at each wave's routing, `drained` after
    each wave's events were digested."""
    failures = []
    limit = RESILIENCE_HEALTH["stale_after_s"] + RESILIENCE_STEP_S
    for pid in (RESILIENCE_CRASHED, RESILIENCE_STALLED):
        latency = summary["pods"][pid]["detection_latency_s"]
        if latency is None or latency > limit:
            failures.append(f"{pid} detected after {latency} s (limit {limit} s)")
        stale_waves = [w for w, s in enumerate(states) if s[pid] == STALE]
        resumed = [w for w, _ in delivered[pid] if stale_waves and w > stale_waves[0]]
        if not resumed:
            failures.append(f"{pid}'s stream never resumed after its detection")
        elif not summary["pods"][pid]["recoveries"] or drained[resumed[0]][pid] != HEALTHY:
            failures.append(f"{pid} did not recover when its stream resumed (wave {resumed[0]})")
    # The tracker sees a lost seq only after the first delivered one: a seq
    # below the first delivered one (lost, or held and swapped behind it) or
    # a lost seq past the last delivered one shows no gap.
    lossy = summary["pods"][RESILIENCE_LOSSY]
    order = [s for _, s in delivered[RESILIENCE_LOSSY]]
    got, sent_seqs = set(order), set(sent[RESILIENCE_LOSSY])
    leading = sum(1 for s in sent_seqs if s < order[0])
    trailing = sum(1 for s in sent_seqs - got if s > max(got))
    inj = out["injected"]
    seen = dict(gap_events=lossy["gap_events"], duplicates=lossy["duplicates"],
                reorders=lossy["reorders"])
    want = dict(gap_events=inj["dropped"] + inj["reordered"] - leading - trailing,
                duplicates=inj["duplicated"], reorders=inj["reordered"])
    out["anomaly_check"] = dict(seen=seen, injected=want, leading=leading, trailing=trailing)
    if lossy["recoveries"]:
        failures.append(f"{RESILIENCE_LOSSY} left the healthy state (its seq tracking was "
                        f"reset, so its counts cannot be held to the injector's)")
    if seen != want or not (inj["dropped"] and inj["duplicated"] and inj["reordered"]):
        failures.append(f"{RESILIENCE_LOSSY}'s anomalies {seen}, the injector's {want}")
    return failures


def phase_resilience(params, cfg, seed: int) -> dict:
    log(f"== phase 15a: faults and anti-entropy around four bf16 flagship pods "
        f"({FLEET_POD_PAGES} pages of {PAGE}): {RESILIENCE_WAVES} waves of phase 12b's traffic "
        f"routed precisely, each pod's share batched, a fake clock {RESILIENCE_STEP_S} s a "
        f"wave; plan {RESILIENCE_PLAN}; health {RESILIENCE_HEALTH}; arms: no faults with the "
        f"plane, the plan with the plane, the plan without it")
    t_phase = time.perf_counter()
    card = card_line()
    waves = multitenant_traffic(seed, cfg.vocab_size, RESILIENCE_WAVES)
    reset_launch_counts()
    no_faults = dict(seed=0, pods={})
    # Phase 17d's healthy autopilot rides on the no-fault arm.
    arms = {"no_faults": resilience_arm(params, cfg, waves, no_faults, True,
                                        autopilot=AutopilotController),
            "faults_plane": resilience_arm(params, cfg, waves, RESILIENCE_PLAN, True),
            "faults_control": resilience_arm(params, cfg, waves, RESILIENCE_PLAN, False)}
    launches = launch_counts()
    failures = [f"{name}: {f}" for name, arm in arms.items() for f in arm["failures"]]
    reset_launch_counts()
    autopilot = autopilot_arms(params, cfg, waves, arms["no_faults"])
    autopilot["launches"] = launch_counts()
    failures += autopilot.pop("failures")
    for name, arm in arms.items():
        log(f"  {name} ({card}): hit rate {arm['hit_rate']:.4f}, TTFT median "
            f"{arm['ttft_median_ms']:.2f} ms, phantom routes {arm['phantom_routes']}, routes "
            f"{arm['routes_by_kind']}, injected {arm['injected']}, {arm['seconds']:.1f} s, "
            f"{len(arm['failures'])} failures")
        if "auditor" in arm:
            log(f"    detection latency s {arm['detection_latency_s']}, recoveries "
                f"{arm['recoveries']}, purged {arm['purged']}; purge checks "
                f"{arm['purge_checks']}; auditor {arm['auditor']}; trust {arm['trust']}; "
                f"anomalies {arm['anomalies']} {arm.get('anomaly_check', '')}; "
                f"{arm['repair_checks']} pod checks after an audit")
    log(f"  kernel launches in the three arms: {launches}")
    report_autopilot(autopilot, arms["no_faults"], card)
    for name in ("paged_decode", "flash_prefill"):
        if launches[name] <= 0:
            failures.append(f"{name} was never launched on the resilience path")
        if autopilot["launches"][name] <= 0:
            failures.append(f"{name} was never launched on the autopilot's arms")
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 15a and 17d ran {seconds:.1f} s")
    if failures:
        raise AssertionError(f"phase 15a/17d: {failures[:6]}")
    for arm in [*arms.values(), *autopilot["arms"].values()]:
        arm.pop("states", None)
        arm.pop("trace", None)
    return dict(arms=arms, launches=launches, autopilot=autopilot, card=card, seconds=seconds)


# Ticks of the quarter-budget governor at most (one rung fires a tick at
# elevated, so draining the small structures takes tens of ticks).
GOVERNOR_MAX_TICKS = 256


def phase_governor(seed: int, control: dict) -> dict:
    """Phase 15b over phase 12a's digested index (its indexer, stream and
    plain replay, handed over in `control["digested"]`)."""
    dig = control.pop("digested")
    log(f"== phase 15b: the resource governor and the departure reaper over phase 12a's "
        f"digested fleet ({control['pods']} pods, host only): meters on the index, the chain "
        f"memo, the prefix store, fleet health, load and anti-entropy; a governor at a "
        f"quarter of the accounted bytes; a third of the pods leave and are reaped, then "
        f"join again")
    t_phase = time.perf_counter()
    indexer, held, chains, messages = dig["indexer"], dig["held"], dig["chains"], dig["messages"]
    index = indexer.kv_block_index
    pods = sorted(held)
    clock = FakeClock()
    # The run's clock spans a minute at most: windows of an hour keep every
    # live pod healthy, so only the churn takes pods out.
    tracker = FleetHealthTracker(FleetHealthConfig(suspect_after_s=3600.0, stale_after_s=7200.0),
                                 index=index, clock=clock)
    load = PodLoadTracker(clock=clock)
    trust = AntiEntropyTracker(clock=clock)
    addrs = {pod: ("10.0.0.1", 7000 + i) for i, pod in enumerate(pods)}
    resolver = IndexBackedPeerResolver(index, FLEET_MODEL, addrs, "router",
                                       negative_ttl_s=3600.0, clock=clock)
    for msg in messages:  # the pods' streams as the tracker would have seen them
        tracker.observe_batch(msg.pod_identifier, msg.topic, msg.seq, 0.0)
    for i, pod in enumerate(pods):
        load.report(pod, queue_depth=i % 4, inflight=1, busy_until=1.0)
        trust.observe_audit(pod, verified=16, phantom=0)
        resolver.note_miss(addrs[pod], [i])
    reaper = DepartureReaper(clock=clock)
    reaper.register("fleethealth", tracker.forget_pod)
    reaper.register("load", load.forget_pod)
    reaper.register("antientropy", trust.forget_pod)
    reaper.register("negative_cache", resolver.forget_pod)
    tracker.on_departed = reaper.reap
    acc = ResourceAccountant()
    memo = indexer.token_processor.chain_memo
    acc.register(Meter(STRUCT_INDEX, lambda: sum(index.segment_sizes()), bytes_per_entry=1024.0,
                       shed=index.shed))
    acc.register(Meter(STRUCT_CHAIN_MEMO, memo.entries, bytes_per_entry=256.0, shed=memo.shed))
    acc.register(Meter(STRUCT_PREFIX_STORE, indexer.prefix_store.entries,
                       bytes_per_entry=4096.0, shed=indexer.prefix_store.shed))
    acc.register(Meter(STRUCT_FLEETHEALTH, tracker.entries, bytes_per_entry=512.0))
    acc.register(Meter(STRUCT_LOAD, load.entries, bytes_per_entry=256.0))
    acc.register(Meter(STRUCT_ANTIENTROPY, trust.entries, bytes_per_entry=256.0))
    failures = []

    def rows() -> dict:
        return dict(fleethealth=sorted(tracker.summary()["pods"]), load=sorted(load.snapshot()),
                    antientropy=sorted(trust.status()["pods"]))

    # A governor whose budget holds everything journals nothing, sheds nothing.
    total = acc.total_bytes()
    entries0 = sum(index.segment_sizes())
    roomy = ResourceGovernor(acc, ResourceGovConfig(budget_mb=2 * total / 2**20,
                                                    min_interval_s=0.0), clock=clock)
    for _ in range(3):
        clock.t += 1.0
        roomy.tick()
    if roomy.journal() or roomy.stats_counters["sheds"] or sum(index.segment_sizes()) != entries0:
        failures.append(f"a governor with room journaled {roomy.journal()}")

    # Churn: a third of the pods leave (a quarantine: purge, then the reap).
    leavers = pods[1::3]
    t0 = time.perf_counter()
    purged = {pod: tracker.quarantine(pod) for pod in leavers}
    churn_s = time.perf_counter() - t0
    pairs = index_pairs(index)
    left_behind = sum(1 for _, p, _ in pairs if p in leavers)
    if left_behind:
        failures.append(f"{left_behind} entries of reaped pods remain")
    live = sorted(set(pods) - set(leavers))
    after_leave = rows()
    for name, have in after_leave.items():
        if have != live:
            failures.append(f"after the reap, {name} holds rows for {have}, live {live}")
    if resolver.negative_entries() != len(live):  # one noted miss a pod
        failures.append(f"after the reap the negative cache holds "
                        f"{resolver.negative_entries()} rows, {len(live)} live pods")
    # They join again: their streams through an EventPool with the tracker wired.
    t0 = time.perf_counter()
    pool = EventPool(EventPoolConfig(concurrency=4), index, indexer.token_processor,
                     health_tracker=tracker)
    pool.start(with_subscriber=False)
    try:
        feed(pool, [m for m in messages if m.pod_identifier in leavers])
        pool.drain()
    finally:
        pool.shutdown()
    for i, pod in enumerate(pods):
        if pod in leavers:
            load.report(pod, queue_depth=i % 4, inflight=1, busy_until=1.0)
            trust.observe_audit(pod, verified=16, phantom=0)
    rejoin_s = time.perf_counter() - t0
    want = {(h, pod, "gpu") for pod, keys in held.items() for h in keys}
    pairs = index_pairs(index)
    if pairs != want:
        failures.append(f"after the rejoin the index holds {len(pairs)} pairs, the replay "
                        f"{len(want)}")
    for name, have in rows().items():
        if have != pods:
            failures.append(f"after the rejoin, {name} holds rows for {have}")

    # The governor at a quarter of the accounted bytes.
    total = acc.total_bytes()
    gov = ResourceGovernor(acc, ResourceGovConfig(budget_mb=total / 4 / 2**20,
                                                  min_interval_s=0.0, cooldown_s=1.0,
                                                  journal_len=GOVERNOR_MAX_TICKS * 4),
                           clock=clock)
    t0 = time.perf_counter()
    ticks = 0
    while ticks < GOVERNOR_MAX_TICKS:
        clock.t += 1.0
        ticks += 1
        if gov.tick() is None and gov.level != LEVEL_CRITICAL:
            break
    shed_s = time.perf_counter() - t0
    status = gov.status()
    journal = gov.journal()
    if status["accounted_bytes"] > gov.budget_bytes:
        failures.append(f"accounted {status['accounted_bytes']} B over the budget "
                        f"{gov.budget_bytes:.0f} B after {ticks} ticks")
    if len(journal) == gov.config.journal_len:
        failures.append("the journal filled up: its order cannot be checked")
    order = {r.structure: i for i, r in enumerate(SHED_LADDER)}
    level, by_tick = LEVEL_OK, {}
    for t, kind, what, _, _ in journal:
        if kind == "level":
            level = what.split("->")[1]
        elif kind == "shed":
            by_tick.setdefault(t, []).append(order[what])
            if what == STRUCT_INDEX and level != LEVEL_CRITICAL:
                failures.append(f"the index was shed at {level} (t {t})")
    if any(ix != sorted(ix) for ix in by_tick.values()):
        failures.append(f"sheds out of the ladder's order: {by_tick}")
    if not any(e[1] == "shed" and e[2] == STRUCT_INDEX for e in journal):
        failures.append("a quarter budget never shed the index")
    pairs = index_pairs(index)
    if not pairs <= want:
        failures.append(f"{len(pairs - want)} entries after the shed are not in the replay")
    now_held = {}
    for h, pod, _ in pairs:
        now_held.setdefault(pod, set()).add(h)
    t0 = time.perf_counter()
    off = sum(1 for _, chain in chains
              if indexer.score_hashes(FLEET_MODEL, chain).scores
              != plain_longest_prefix(chain, now_held))
    score_s = time.perf_counter() - t0
    if off:
        failures.append(f"{off} of {len(chains)} chains score apart from the plain longest "
                        f"prefix over the shed index")
    for name, have in rows().items():
        if have != pods:
            failures.append(f"{name} holds rows for {have}, live {pods}")
    seconds = time.perf_counter() - t_phase
    log(f"  accounted {total:.0f} B before the governor, budget {gov.budget_bytes:.0f} B, after "
        f"{ticks} ticks {status['accounted_bytes']} B ({status['level']}); meters "
        f"{status['meters']}; journal {journal}")
    log(f"  churn: {len(leavers)} pods left (purged {sum(purged.values())} entries in "
        f"{churn_s:.3f} s, reaper {reaper.status()['stats']}), rejoined in {rejoin_s:.1f} s; "
        f"shed ticks {shed_s:.2f} s; {len(chains)} chains scored in {score_s:.2f} s, {off} off "
        f"the plain longest prefix; index {len(pairs)} of the replay's {len(want)} pairs; "
        f"phase 15b ran {seconds:.1f} s")
    if failures:
        raise AssertionError(f"phase 15b: {failures[:6]}")
    return dict(budget_bytes=gov.budget_bytes, accounted_before=total,
                accounted_after=status["accounted_bytes"], level=status["level"], ticks=ticks,
                journal=journal, meters=status["meters"], stats=status["stats"],
                leavers=leavers, purged=purged, reaper=reaper.status()["stats"],
                index_pairs_after=len(pairs), replay_pairs=len(want), churn_s=churn_s,
                rejoin_s=rejoin_s, shed_s=shed_s, score_s=score_s, seconds=seconds)


# -- phase 16: the workload engine and the proactive planes --------------------

PROACTIVE_MODEL = "llama-flagship-1.14b"
# benchmarking/fleet_device_bench.py's SHAREGPT_FULL over its four pods (one
# prefix group a pod) at its default seed, and the sha256 of that trace's JSONL
# as the JAX package writes it (tests/test_torch_workloads.py holds the two
# equal, so the card serves the reference's exact prompt stream).
SHAREGPT_FULL = dict(seed=7, prefix_groups=4, n_sessions=24, max_turns=8, length_scale=1.0,
                     session_rate_per_s=0.5)
SHAREGPT_SHA256 = "140bf40a7c5ca9d936b49931c8ce794bfcc803970d761f62dba97b5a5c138273"
# fleet_device_bench.py's "v2" pods and Scheduler: pages a pod, pages a
# sequence, new tokens, decode steps, prefill budget and batch.
TRACE_POD = dict(n_pages=1536, max_pages_per_seq=704)
TRACE_SERVE = dict(max_new=16, decode_steps=8, budget=4096, max_batch=4)
TRACE_ALONE = 16  # precise requests held to a pod that never evicts
TRACE_ALONE_SEED = 16
# tests/test_placement.py TestPlacementEndToEnd: its trace, pods and arms, and
# bench.py's placement constants (the tracker's half-life, the queue bound).
PLACEMENT_TRACE = dict(n_tenants=3, n_sessions=16, seed=5, zipf_s=2.0, session_rate_per_s=6.0,
                       max_turns=2, prefix_words=120)
PLACEMENT_POD = dict(n_pages=256, host_capacity_blocks=512, max_pages_per_seq=240)
PLACEMENT_ARMS = {"off": None, "observe": dict(hotness_threshold=1e9),
                  "on": dict(k_replicas=2, hotness_threshold=3.0, cooldown_s=2.0)}
PLACEMENT_HALF_LIFE_S = 60.0
PROACTIVE_QUEUE_BOUND = 64
# tests/test_prediction.py TestPredictionEndToEnd: its pods and arms.
PREDICTION_POD = dict(n_pages=192, host_capacity_blocks=2048, max_pages_per_seq=64)
PREDICTION_ARMS = {"off": None, "observe": dict(max_jobs_per_tick=0, tail_trim_blocks=0),
                   "on": dict(max_jobs_per_tick=4, session_cooldown_s=1.0, start_frac=0.8,
                              tail_trim_blocks=8, default_eta_s=10.0)}
PREDICTION_SESSION = "s0"
# The whole run's cut, made to make room for phase 18a: 16b and 16c run
# their off and on arms; the observe-only arm, whose bar is that it equals
# the off arm, runs in `--phases 16b` / `--phases 16c` and in tier-1's
# rehearsals (tests/test_torch_{placement,prediction}.py).
FULL_RUN_PROACTIVE_ARMS = ("off", "on")
# The rehearsal's model: the flagship's vocabulary at a CPU's width (tier-1
# runs the three phases' arms on it: tests/test_torch_{workloads,placement,
# prediction}.py).
REHEARSAL_MODEL = dict(d_model=64, n_layers=1, n_q_heads=2, n_kv_heads=1, head_dim=32, d_ff=128,
                       vocab_size=FLAGSHIP["vocab_size"])


class TextTokenizer(Tokenizer):
    """Word-level tokenizer of the workload engine's text prompts: every
    space-separated word, the empty one included, is one token, its FNV-1a
    hash modulo the vocabulary. (The card has no `tokenizers` library, so
    the reference bench's BPE fixture cannot load there.)"""

    def __init__(self, vocab: int):
        self.vocab = vocab
        self._ids = {}

    def encode(self, prompt: str, model_name: str) -> TokenizationResult:
        words = prompt.split(" ")
        ids = self._ids
        tokens = []
        for w in words:
            t = ids.get(w)
            if t is None:
                t = ids[w] = hashing.fnv64a(w.encode("utf-8")) % self.vocab
            tokens.append(t)
        ends = list(itertools.accumulate(len(w) + 1 for w in words))
        return TokenizationResult(tokens=tokens, offsets=[(e - len(w) - 1, e - 1)
                                                          for w, e in zip(words, ends)])


def sharegpt_trace():
    return generate_sharegpt(ShareGPTConfig(**SHAREGPT_FULL))


def sharegpt_requests() -> list:
    return sharegpt_trace().requests()


def trace_sha256(trace) -> str:
    buf = io.StringIO()
    write_trace(trace, buf)
    return hashlib.sha256(buf.getvalue().encode("utf-8")).hexdigest()


def placement_requests() -> list:
    return generate_multitenant(MultiTenantConfig(**PLACEMENT_TRACE)).requests()


def prediction_requests() -> list:
    """tests/test_prediction.py's `_mini_trace`: session s0 (a 420-word
    prefix) at t=0, 24 single-turn junk sessions of 500 words churning every
    pod's pages during its think window, s0's next turn at t=12 s."""
    rng = random.Random(7)
    base = "session zero shared prefix " + synthetic_text(rng, 420)
    reqs = [MaterializedRequest(arrival_s=0.0, session="s0", turn=0, prompt=base,
                                output_len=20)]
    for j in range(24):
        reqs.append(MaterializedRequest(arrival_s=1.0 + 0.25 * j, session=f"junk-{j}", turn=0,
                                        prompt=f"[junk {j}] " + synthetic_text(rng, 500),
                                        output_len=10))
    grown = base + " [user] " + synthetic_text(rng, 60)
    reqs.append(MaterializedRequest(arrival_s=12.0, session="s0", turn=1, prompt=grown,
                                    output_len=20))
    return reqs


def pctl(xs, q: float) -> float:
    """fleet_device_bench.py's percentile: the sorted sample at int(n q)."""
    s = sorted(xs)
    return s[min(int(len(s) * q), len(s) - 1)]


def proactive_fleet(params, cfg, tok, n_pages: int, max_pages_per_seq: int,
                    host_capacity_blocks=None, popularity=None, prediction=None,
                    health=None, tap=None, pod_ids=FLEET_POD_IDS) -> dict:
    """Four flagship pods sharing `params` behind an Indexer (whole prompts
    through `tok`; the prefix store's shortcut off, so every route scores the
    served chain) and an EventPool fed msgpack batches by the pods' sinks;
    `popularity` rides both (routes and stores). With
    `host_capacity_blocks`: host tiers with the cost gate off, eager staging
    and peer resolvers over the index. Each pod's event batches are kept in
    `events`; `tap`, where given, gets every message the pool gets."""
    indexer = Indexer(
        IndexerConfig(token_processor_config=TokenProcessorConfig(block_size=PAGE)),
        tokenization_pool=TokenizationPool(
            TokenizersPoolConfig(workers=2, min_prefix_overlap_ratio=float("inf")),
            tokenizer=tok),
        popularity=popularity, prediction=prediction)
    index = indexer.kv_block_index
    pool = EventPool(EventPoolConfig(concurrency=4), index, indexer.token_processor,
                     health_tracker=health, popularity=popularity)
    pool.start(with_subscriber=False)
    indexer.run()
    host = host_capacity_blocks is not None
    pods, events = {}, {pid: [] for pid in pod_ids}
    for pid in pod_ids:
        seq = iter(range(1 << 62))

        def sink(batch, pid=pid, seq=seq):
            events[pid].append(batch)
            msg = Message(topic=f"kv@{pid}@{PROACTIVE_MODEL}", payload=batch.to_msgpack(),
                          seq=next(seq), pod_identifier=pid, model_name=PROACTIVE_MODEL)
            pool.add_task(msg)
            if tap is not None:
                tap(msg)

        tier = dict(enable_host_tier=True, host_capacity_blocks=host_capacity_blocks,
                    transfer_cost_model=None, eager_stage=True) if host else {}
        pods[pid] = EnginePod(
            EnginePodConfig(pod_id=pid, model_name=PROACTIVE_MODEL, n_pages=n_pages,
                            page_size=PAGE, device_tier="gpu",
                            max_pages_per_seq=max_pages_per_seq, model_config=cfg,
                            device=params["embed"].device, **tier),
            event_sink=sink, params=params)
    if host:
        addrs = {pid: pod.transfer_address for pid, pod in pods.items()}
        for pid, pod in pods.items():
            pod.set_peer_resolver(IndexBackedPeerResolver(index, PROACTIVE_MODEL, addrs, pid))
    return dict(indexer=indexer, index=index, pool=pool, pods=pods, events=events, host=host)


def settle(fleet) -> None:
    """Every staged page admitted to its host store and every event batch
    digested: the index as the pods stand."""
    if fleet["host"]:
        for pod in fleet["pods"].values():
            pod.tier_store.drain_async_stages()
    fleet["pool"].drain()


def close_fleet(fleet) -> None:
    fleet["indexer"].shutdown()
    fleet["pool"].shutdown()
    for pod in fleet["pods"].values():
        pod.close()


def tier_failures(fleet) -> list:
    """14b's residency check: each pod's gpu entries are its committed pages
    and (with a host tier) its cpu entries are its host store."""
    pairs = index_pairs(fleet["index"])
    out = []
    for pid, pod in fleet["pods"].items():
        committed = set(pod.block_manager.cached_hashes())
        on_gpu = {h for h, p, tier in pairs if p == pid and tier == "gpu"}
        if committed != on_gpu:
            out.append(f"{pid}: index {len(on_gpu)} gpu blocks, pod {len(committed)} "
                       f"({len(on_gpu - committed)} extra)")
        if fleet["host"]:
            on_cpu = {h for h, p, tier in pairs if p == pid and tier == "cpu"}
            if pod.tier_store.staged_subset(on_cpu) != on_cpu or \
                    pod.tier_store.staged_count != len(on_cpu):
                out.append(f"{pid}: index {len(on_cpu)} cpu blocks, host store "
                           f"{pod.tier_store.staged_count}")
    return out


def pool_failures(fleet) -> list:
    counters = dict(dropped=fleet["pool"].dropped_events,
                    removals_lost=fleet["pool"].removals_lost)
    return [f"pool counters {counters}"] if any(counters.values()) else []


def serve_alone(pod, tokens, max_new: int = TRACE_SERVE["max_new"]) -> tuple:
    """One request alone through the pod's Scheduler at TRACE_SERVE's
    settings: (the finished request, seconds to its first token, seconds in
    all)."""
    r = run_scheduler(pod, [dict(prompt_tokens=tokens, max_new_tokens=max_new, sampling=None)],
                      decode_steps=TRACE_SERVE["decode_steps"],
                      max_batch=TRACE_SERVE["max_batch"], budget=TRACE_SERVE["budget"])
    return r["requests"][0], r["first_token_s"][0], r["wall_s"]


def trace_route(scores: dict, rr: int) -> tuple:
    """fleet_device_bench.py's precise router: the top score, ties to the
    lowest pod number; no cache signal round robin. (pod, rr)."""
    if not scores:
        return FLEET_POD_IDS[rr % len(FLEET_POD_IDS)], rr + 1
    best = max(scores.values())
    return min((p for p, s in scores.items() if s == best), key=FLEET_POD_IDS.index), rr


def spread_route(scores: dict, served: dict) -> str:
    """Phases 16b and 16c's router: the top score, ties and no cache signal
    to the pod that has served the fewest requests, then pod order. It
    reads no clock, so every arm routes the same given the same scores."""
    cand = scores or {p: 0.0 for p in FLEET_POD_IDS}
    best = max(cand.values())
    return min((p for p, s in cand.items() if s == best),
               key=lambda p: (served[p], FLEET_POD_IDS.index(p)))


def never_evicting_tokens(params, cfg, prompts: list, checked) -> list:
    """Greedy tokens of the `checked` prompts (indices, in order) when every
    prompt is served alone in order on one pod large enough to never evict.
    Each prompt's prefill then starts where the fleet's did, over KV computed
    by the same earlier prefills (a fleet that routes to the longest prefix
    and never evicts computes each block once), so the tokens must be the
    fleet's bit for bit; the unchecked prompts stop after their first token
    (their prefill is all a later prompt reuses)."""
    checked = sorted(checked)
    pages = sum(-(-(len(t) + TRACE_SERVE["max_new"]) // PAGE) for t in prompts) + 8
    pod = EnginePod(EnginePodConfig(
        pod_id="pod-ref", model_name="ref", n_pages=pages, page_size=PAGE, device_tier="gpu",
        max_pages_per_seq=TRACE_POD["max_pages_per_seq"], model_config=cfg,
        device=params["embed"].device), params=params)
    out = {k: serve_alone(pod, t, TRACE_SERVE["max_new"] if k in checked else 1)[0].generated
           for k, t in enumerate(prompts)}
    del pod
    return [out[k] for k in checked]


def served_row(r, pid: str, done, first_s: float, total_s: float, free_at: dict) -> dict:
    """The open-loop replay's clock: a request waits until its pod is free
    (each pod serves in arrival order); TTFT = the wait + the measured time
    to its first token."""
    wait = max(0.0, free_at[pid] - r.arrival_s)
    free_at[pid] = max(r.arrival_s, free_at[pid]) + total_s
    return dict(session=r.session, turn=r.turn, pod=pid, prompt=len(done.prompt_tokens),
                cached=done.num_cached_tokens, wait_s=wait, first_s=first_s,
                service_s=total_s, ttft_s=wait + first_s, tokens=list(done.generated))


def replay_summary(rows: list) -> dict:
    ttft = [r["ttft_s"] for r in rows]
    return dict(requests=len(rows),
                hit_rate=sum(r["cached"] for r in rows) / sum(r["prompt"] for r in rows),
                ttft_p50_s=pctl(ttft, 0.5), ttft_p90_s=pctl(ttft, 0.9),
                ttft_mean_s=statistics.fmean(ttft),
                queue_wait_p50_s=pctl([r["wait_s"] for r in rows], 0.5),
                service_p50_s=pctl([r["service_s"] for r in rows], 0.5),
                compute_ttft_p50_s=pctl([r["first_s"] for r in rows], 0.5))


def trace_arm(params, cfg, requests, policy: str, route=trace_route, shadow=None) -> dict:
    """One arm of phase 16a on four fresh pods: the trace replayed open-loop
    in arrival order, each request routed (`precise`: by the index through
    `route`; else round robin) and served alone, the pool drained after
    each. Bars: a precise request's cached tokens = 16 x the index's
    match_blocks for its top-scored pod (the router's prediction comes
    true), and after the replay every pod's indexed blocks = its committed
    pages. A `shadow` (phase 17a's `ClusterShadow`, phase 18a's
    `ServiceShadow`, or both in `Shadows`) gets every message of the pods
    and holds its answers to each precise route; an answer from its `check`
    (the service's) is what routes the request."""
    t_arm = time.perf_counter()
    tok = TextTokenizer(cfg.vocab_size)
    fleet = proactive_fleet(params, cfg, tok, **TRACE_POD,
                            tap=shadow.deliver if shadow is not None else None)
    if shadow is not None:
        shadow.attach(fleet, len(requests))
    indexer, pods = fleet["indexer"], fleet["pods"]
    tp = indexer.token_processor
    free_at = {pid: 0.0 for pid in pods}
    rr, rows, failures, read_ms = 0, [], [], []
    try:
        for k, r in enumerate(requests):
            tokens = tok.encode(r.prompt, PROACTIVE_MODEL).tokens
            predicted = None
            if policy == "precise":
                t0 = time.perf_counter()
                ps = indexer.get_pod_scores_ex(r.prompt, PROACTIVE_MODEL, list(pods))
                read_ms.append((time.perf_counter() - t0) * 1e3)
                chain = [key.chunk_hash for key in
                         tp.tokens_to_kv_block_keys(None, tokens, PROACTIVE_MODEL)]
                if ps.block_hashes != chain:
                    failures.append(f"request {k}: the indexer scored {len(ps.block_hashes)} "
                                    f"blocks, the prompt has {len(chain)}")
                # The index's prediction: the top-scored pod holds this
                # many of the prompt's blocks, and the request lands there.
                best = trace_route(ps.scores, rr)[0]
                predicted = PAGE * ps.match_blocks.get(best, 0)
                answer = shadow.check(k, r.prompt, ps, rr) if shadow is not None else None
                pid, rr = route(ps.scores if answer is None else answer, rr)
            else:
                pid, rr = FLEET_POD_IDS[rr % len(FLEET_POD_IDS)], rr + 1
            if shadow is not None:
                shadow.before_serve(k)
            done, first_s, total_s = serve_alone(pods[pid], tokens)
            rows.append(served_row(r, pid, done, first_s, total_s, free_at))
            rows[-1]["predicted"] = predicted
            if predicted is not None and done.num_cached_tokens != predicted:
                failures.append(f"request {k} on {pid}: cached {done.num_cached_tokens}, the "
                                f"index predicted {predicted} (on {best})")
            settle(fleet)
            if shadow is not None:
                shadow.after_serve(k)
        failures += tier_failures(fleet) + pool_failures(fleet)
        if shadow is not None:
            shadow.finish()
        removed = sum(len(e.block_hashes) for batches in fleet["events"].values()
                      for b in batches for e in b.events if isinstance(e, BlockRemoved))
    finally:
        if shadow is not None:
            shadow.close()
        close_fleet(fleet)
    return dict(summary=replay_summary(rows), rows=rows, failures=failures,
                removed_blocks=removed, routes={p: sum(r["pod"] == p for r in rows)
                                                for p in FLEET_POD_IDS},
                read_ms_p50=pctl(read_ms, 0.5) if read_ms else None,
                seconds=time.perf_counter() - t_arm)


def alone_subset(n_requests: int) -> list:
    return sorted(random.Random(TRACE_ALONE_SEED).sample(range(n_requests), TRACE_ALONE))


def phase_sharegpt(params, cfg) -> dict:
    log(f"== phase 16a: the ShareGPT replay (fleet_device_bench.py's SHAREGPT_FULL {SHAREGPT_FULL})"
        f" over four bf16 flagship pods ({TRACE_POD['n_pages']} pages of {PAGE}, "
        f"{TRACE_POD['max_pages_per_seq']} a sequence; {TRACE_SERVE}), open-loop on a virtual "
        f"per-pod clock, routed precisely by the index and round robin")
    t_phase = time.perf_counter()
    trace = sharegpt_trace()
    digest = trace_sha256(trace)
    requests = trace.requests()
    failures = [] if digest == SHAREGPT_SHA256 else [
        f"the trace's sha256 {digest} is not the reference's {SHAREGPT_SHA256}"]
    card = card_line()
    tok = TextTokenizer(cfg.vocab_size)
    subset = alone_subset(len(requests))
    want = never_evicting_tokens(params, cfg, [tok.encode(r.prompt, "").tokens
                                               for r in requests], subset)
    torch.cuda.empty_cache()
    reset_launch_counts()
    # Phases 17a and 18a ride on the precise arm: replicas beside its
    # Indexer, and the HTTP service whose answers route it.
    arms = {"precise": cluster_arm(params, cfg, requests, service=ServiceShadow())}
    arms["precise"]["cluster"]["launches"] = launch_counts()
    arms["precise"]["service"]["launches"] = launch_counts()
    arms["round_robin"] = trace_arm(params, cfg, requests, "round_robin")
    launches = launch_counts()
    off = [k for k, w in zip(subset, want) if arms["precise"]["rows"][k]["tokens"] != w]
    if off:
        failures.append(f"{len(off)} of {TRACE_ALONE} precise requests' greedy tokens differ "
                        f"from the never-evicting pod: {off}")
    for policy, arm in arms.items():
        failures += [f"{policy}: {f}" for f in arm["failures"]]
        s = arm["summary"]
        log(f"  {policy} ({card}): {s['requests']} requests, hit rate {s['hit_rate']:.4f}, "
            f"TTFT p50 {s['ttft_p50_s'] * 1e3:.2f} ms p90 {s['ttft_p90_s'] * 1e3:.2f} ms mean "
            f"{s['ttft_mean_s'] * 1e3:.2f} ms, queue wait p50 {s['queue_wait_p50_s'] * 1e3:.2f} "
            f"ms, service p50 {s['service_p50_s'] * 1e3:.2f} ms, compute TTFT p50 "
            f"{s['compute_ttft_p50_s'] * 1e3:.2f} ms; routes {arm['routes']}; "
            f"{arm['removed_blocks']} blocks removed; read path p50 {arm['read_ms_p50']} ms; "
            f"{arm['seconds']:.1f} s; {len(arm['failures'])} failures")
    p, rr = arms["precise"]["summary"], arms["round_robin"]["summary"]
    ratio = rr["ttft_p50_s"] / p["ttft_p50_s"]
    # The same request under both policies: where its compute TTFT moved.
    pairs = list(zip(arms["precise"]["rows"], arms["round_robin"]["rows"]))
    for name, keep in (("both miss", lambda a, b: not a["cached"] and not b["cached"]),
                       ("precise hits more", lambda a, b: a["cached"] > b["cached"]),
                       ("equal hits", lambda a, b: a["cached"] == b["cached"] > 0)):
        d = [(a["first_s"] - b["first_s"]) * 1e3 for a, b in pairs if keep(a, b)]
        if d:
            log(f"    paired compute TTFT, precise - round robin, {name} ({len(d)} requests): "
                f"median {statistics.median(d):.2f} ms")
    failures += report_cluster(arms["precise"], card)
    failures += report_service(arms["precise"], card)
    log(f"  precise / round robin: hit rate {p['hit_rate']:.4f} vs {rr['hit_rate']:.4f} "
        f"(BASELINE.json target >= 0.8), TTFT p50 {ratio:.3f}x lower (target >= 2x); "
        f"{TRACE_ALONE - len(off)} of {TRACE_ALONE} alone checks equal; launches {launches}")
    for name in ("paged_decode", "flash_prefill"):
        if launches[name] <= 0:
            failures.append(f"{name} was never launched on the ShareGPT path")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 16a (with 17a and 18a) ran {seconds:.1f} s, "
        f"{arms['precise']['service']['seconds']:.2f} s of it in 18a's service calls")
    if failures:
        raise AssertionError(f"phase 16a/17a/18a: {failures[:6]}")
    for arm in arms.values():
        for row in arm["rows"]:
            row.pop("tokens")
    return dict(sha256=digest, arms=arms, ttft_p50_ratio=ratio, alone=subset, card=card,
                launches=launches, seconds=seconds)


def proactive_replay(fleet, requests, tok, served: dict, before=None, hook=None) -> tuple:
    """Phases 16b and 16c's replay on `fleet`: per request, `before(now)`
    (the proactive plane's tick), route by `spread_route` over the index's
    scores (`served` counts each pod's requests), `hook(request, pod,
    tokens)` before admission, serve alone, settle, and hold every pod's
    tiers to the index. (rows, failures)."""
    indexer, pods = fleet["indexer"], fleet["pods"]
    free_at = {pid: 0.0 for pid in pods}
    rows, failures = [], []
    for k, r in enumerate(requests):
        fleet["clock"].t = r.arrival_s
        if before is not None:
            for pid, seconds in before(r.arrival_s).items():  # background work on pod clocks
                free_at[pid] = max(free_at[pid], r.arrival_s) + seconds
        tokens = tok.encode(r.prompt, PROACTIVE_MODEL).tokens
        ps = indexer.get_pod_scores_ex(r.prompt, PROACTIVE_MODEL, list(pods))
        pid = spread_route(ps.scores, served)
        served[pid] += 1
        if hook is not None:
            hook(r, pods[pid], tokens)
        done, first_s, total_s = serve_alone(pods[pid], tokens)
        rows.append(served_row(r, pid, done, first_s, total_s, free_at))
        settle(fleet)
        failures += [f"request {k}: {f}" for f in tier_failures(fleet)]
    return rows, failures


def arm_streams(fleet, rows) -> dict:
    """What an observe-only arm must leave exactly as the plane-off arm:
    routes, cached tokens, greedy tokens and every pod's event stream."""
    return dict(routes=[r["pod"] for r in rows], cached=[r["cached"] for r in rows],
                tokens=[r["tokens"] for r in rows],
                events={pid: event_rows(b) for pid, b in fleet["events"].items()})


def timed_jobs(prefetcher, fleet, seconds: dict) -> dict:
    """Drain a prefetcher's queued jobs and settle the fleet; returns the
    seconds the jobs took on each pod (`seconds`, filled by the jobs)."""
    prefetcher.drain(timeout_s=30.0)
    settle(fleet)
    out = dict(seconds)
    seconds.clear()
    return out


def placement_arm(params, cfg, requests, placement, replicator_cls=HotPrefixReplicator) -> dict:
    """One arm of phase 16b: the multi-tenant trace over four fresh pods
    with host tiers; with `placement`, the popularity tracker on the
    Indexer's read path and a HotPrefixReplicator ticked at every arrival
    on a fake clock, its jobs through a RoutePrefetcher (source
    "replication") into the target pod's prefetch_hashes and warm_chain."""
    t_arm = time.perf_counter()
    clock = FakeClock()
    tok = TextTokenizer(cfg.vocab_size)
    health = FleetHealthTracker(FleetHealthConfig(), clock=clock)
    rep_cfg = ReplicationConfig(**placement) if placement is not None else None
    popularity = None if rep_cfg is None else ChainPopularityTracker(
        PopularityConfig(half_life_s=PLACEMENT_HALF_LIFE_S,
                         max_prefix_blocks=rep_cfg.max_prefix_blocks), clock=clock)
    fleet = proactive_fleet(params, cfg, tok, popularity=popularity, health=health,
                            **PLACEMENT_POD)
    fleet["clock"] = clock
    pods = fleet["pods"]
    landed, job_s, errors = {pid: 0 for pid in pods}, {}, []

    def replicate(pid, hashes):
        try:
            t0 = time.perf_counter()
            pod = pods[pid]
            pod.prefetch_hashes(list(hashes))
            chain = popularity.chain(hashes[0])
            if chain is None or not chain.prefix_tokens:
                return 0
            n = pod.warm_chain(chain.prefix_tokens)
            sync()
            landed[pid] += n
            job_s[pid] = job_s.get(pid, 0.0) + time.perf_counter() - t0
            return n
        except Exception as e:  # the prefetcher swallows a job's error
            errors.append(f"replication to {pid}: {e!r}")
            raise

    prefetcher = RoutePrefetcher(replicate, queue_bound=PROACTIVE_QUEUE_BOUND)
    replicator = None if rep_cfg is None else replicator_cls(
        popularity, submit_fn=lambda pod, hashes, chain: prefetcher.submit(
            pod, hashes, source="replication"),
        pods_fn=lambda: list(FLEET_POD_IDS), config=rep_cfg, fleet_health=health,
        index=fleet["index"], clock=clock)

    def before(now):
        if replicator is not None and replicator.tick(now):
            return timed_jobs(prefetcher, fleet, job_s)
        return {}

    try:
        rows, failures = proactive_replay(fleet, requests, tok, {pid: 0 for pid in pods},
                                          before=before)
        streams = arm_streams(fleet, rows)
        failures += errors + pool_failures(fleet)
        out = dict(rows=rows, streams=streams, failures=failures,
                   replicated_blocks=sum(landed.values()), landed=landed,
                   prefetcher=prefetcher.status(),
                   replicator=dict(replicator.stats) if replicator else None,
                   tracker=popularity.stats() if popularity else None,
                   tier_stats={pid: dict(pod.tier_store.stats) for pid, pod in pods.items()})
    finally:
        prefetcher.close()
        close_fleet(fleet)
    out.update(summary=replay_summary(rows), seconds=time.perf_counter() - t_arm)
    return out


def placement_bars(arms: dict) -> list:
    """tests/test_placement.py's claims on the card: observe-only is the
    off arm exactly; on, blocks land, jobs were submitted, no target was
    unhealthy and nothing was dropped."""
    failures = []
    off, on = arms["off"], arms["on"]
    observe = arms.get("observe", off)  # the full run's 16b has no observe-only arm
    for key in off["streams"]:
        if observe["streams"][key] != off["streams"][key]:
            failures.append(f"observe-only differs from off in {key}")
    if off["replicated_blocks"] or observe["replicated_blocks"]:
        failures.append(f"replicated without a hot chain: off {off['replicated_blocks']}, "
                        f"observe {observe['replicated_blocks']}")
    rep = on["replicator"]
    if not (on["replicated_blocks"] > 0 and rep["jobs_submitted"] > 0):
        failures.append(f"placement on landed {on['replicated_blocks']} blocks from "
                        f"{rep['jobs_submitted']} jobs")
    if rep["skipped_unhealthy"] or on["prefetcher"]["stats"]["dropped"]:
        failures.append(f"skipped unhealthy {rep['skipped_unhealthy']}, prefetcher dropped "
                        f"{on['prefetcher']['stats']['dropped']}")
    return failures


def phase_placement(params, cfg, arm_names=tuple(PLACEMENT_ARMS)) -> dict:
    chosen = {name: PLACEMENT_ARMS[name] for name in arm_names}
    log(f"== phase 16b: hot-prefix placement over four bf16 flagship pods with host tiers "
        f"({PLACEMENT_POD}, cost gate off, eager staging): tests/test_placement.py's "
        f"multi-tenant trace {PLACEMENT_TRACE} (lora_id dropped), arms {chosen}")
    t_phase = time.perf_counter()
    card = card_line()
    requests = placement_requests()
    reset_launch_counts()
    arms = {name: placement_arm(params, cfg, requests, p) for name, p in chosen.items()}
    launches = launch_counts()
    failures = [f"{name}: {f}" for name, arm in arms.items() for f in arm["failures"]]
    failures += placement_bars(arms)
    for name, arm in arms.items():
        s = arm["summary"]
        log(f"  {name} ({card}): hit rate {s['hit_rate']:.4f}, TTFT p50 "
            f"{s['ttft_p50_s'] * 1e3:.2f} ms, mean {s['ttft_mean_s'] * 1e3:.2f} ms; replicated "
            f"{arm['replicated_blocks']} blocks {arm['landed']}; replicator {arm['replicator']}; "
            f"prefetcher {arm['prefetcher']['by_source']}; {arm['seconds']:.1f} s; "
            f"{len(arm['failures'])} failures")
    log(f"  launches {launches}")
    for name in ("paged_decode", "flash_prefill"):
        if launches[name] <= 0:
            failures.append(f"{name} was never launched on the placement path")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 16b ran {seconds:.1f} s")
    if failures:
        raise AssertionError(f"phase 16b: {failures[:6]}")
    for arm in arms.values():
        arm.pop("streams")
        for row in arm["rows"]:
            row.pop("tokens")
    return dict(arms=arms, launches=launches, card=card, seconds=seconds)


def prediction_arm(params, cfg, requests, prediction, table_cls=SessionTable) -> dict:
    """One arm of phase 16c: the churn scenario over four fresh pods with
    host tiers; with `prediction`, a SessionTable on the Indexer's read
    path and a PrefetchScheduler ticked at every arrival on a fake clock,
    its jobs through a RoutePrefetcher (source "prediction") into the
    router's pick's prefetch_hashes and warm_chain. Reads the blocks of s0's
    first turn resident on its routed pod just before its second turn."""
    t_arm = time.perf_counter()
    clock = FakeClock()
    tok = TextTokenizer(cfg.vocab_size)
    table = scheduler = None
    kwargs = dict(prediction or {})
    sched_kwargs = {k: kwargs.pop(k) for k in ("max_jobs_per_tick", "session_cooldown_s",
                                               "start_frac") if k in kwargs}
    if prediction is not None:
        table = table_cls(PredictionConfig(**kwargs), clock=clock)
    fleet = proactive_fleet(params, cfg, tok, prediction=table, **PREDICTION_POD)
    fleet["clock"] = clock
    pods, tp = fleet["pods"], fleet["indexer"].token_processor
    landed, job_s, errors, served = [0], {}, [], {pid: 0 for pid in pods}
    audit, prev_chain = {}, []

    def preland(pid, hashes):
        try:
            t0 = time.perf_counter()
            pod = pods[pid]
            pod.prefetch_hashes(list(hashes))
            rec = table.record_by_tail(hashes[-1])
            if rec is None or not rec.tokens:
                return 0
            n = pod.warm_chain(rec.tokens, lora_id=rec.lora_id)
            sync()
            if n:
                landed[0] += n
                table.note_landed(hashes[-1], n)
            job_s[pid] = job_s.get(pid, 0.0) + time.perf_counter() - t0
            return n
        except Exception as e:  # the prefetcher swallows a job's error
            errors.append(f"prediction prefetch to {pid}: {e!r}")
            raise

    prefetcher = RoutePrefetcher(preland, queue_bound=PROACTIVE_QUEUE_BOUND)
    if table is not None:
        scheduler = PrefetchScheduler(
            table, score_fn=fleet["indexer"].score_hashes,
            submit_fn=lambda pod, hashes: prefetcher.submit(pod, hashes, source="prediction"),
            config=SchedulerConfig(**sched_kwargs),
            select_fn=lambda scores: spread_route(scores, served), clock=clock)

    def before(now):
        if scheduler is not None and scheduler.tick(now):
            return timed_jobs(prefetcher, fleet, job_s)
        return {}

    def hook(r, pod, tokens):
        if r.session != PREDICTION_SESSION:
            return
        keys = tp.tokens_to_kv_block_keys(None, tokens, PROACTIVE_MODEL)
        if r.turn == 0:
            prev_chain[:] = [k.chunk_hash for k in keys]
        else:
            audit.update(resident=pod.resident_prefix_blocks(prev_chain),
                         prefix_blocks=len(prev_chain))

    try:
        rows, failures = proactive_replay(fleet, requests, tok, served, before=before,
                                          hook=hook)
        streams = arm_streams(fleet, rows)
        failures += errors + pool_failures(fleet)
        out = dict(rows=rows, streams=streams, failures=failures, audit=audit,
                   predicted_landed_blocks=landed[0], prefetcher=prefetcher.status(),
                   scheduler=dict(scheduler.stats) if scheduler else None,
                   table=table.stats() if table else None,
                   tier_stats={pid: dict(pod.tier_store.stats) for pid, pod in pods.items()})
    finally:
        prefetcher.close()
        close_fleet(fleet)
    turn1 = next(r for r in rows if (r["session"], r["turn"]) == (PREDICTION_SESSION, 1))
    out.update(summary=replay_summary(rows), turn1=turn1, seconds=time.perf_counter() - t_arm)
    return out


def prediction_bars(arms: dict, want: list) -> list:
    """tests/test_prediction.py's claims on the card: observe-only is the
    off arm exactly; off, s0's prefix was really evicted before its next
    turn; on, more of it is resident and blocks were pre-landed; and turn
    1's tokens are a never-evicting pod's in every arm."""
    failures = []
    off, on = arms["off"], arms["on"]
    observe = arms.get("observe", off)  # the full run's 16c has no observe-only arm
    for key in off["streams"]:
        if observe["streams"][key] != off["streams"][key]:
            failures.append(f"observe-only differs from off in {key}")
    if not off["audit"]["resident"] < off["audit"]["prefix_blocks"]:
        failures.append(f"off: {off['audit']} (the scenario must evict s0's prefix)")
    if not (on["audit"]["resident"] > off["audit"]["resident"]
            and on["predicted_landed_blocks"] > 0):
        failures.append(f"on: resident {on['audit']['resident']} (off "
                        f"{off['audit']['resident']}), pre-landed "
                        f"{on['predicted_landed_blocks']} blocks")
    for name, arm in arms.items():
        if arm["turn1"]["tokens"] != want:
            failures.append(f"{name}: turn 1's greedy tokens differ from the never-evicting pod")
    return failures


def phase_prediction(params, cfg, arm_names=tuple(PREDICTION_ARMS)) -> dict:
    chosen = {name: PREDICTION_ARMS[name] for name in arm_names}
    log(f"== phase 16c: session prediction over four bf16 flagship pods with host tiers "
        f"({PREDICTION_POD}, cost gate off, eager staging): tests/test_prediction.py's churn "
        f"scenario (s0 at 0 s, 24 junk sessions from 1 s, s0's turn 1 at 12 s), arms "
        f"{chosen}")
    t_phase = time.perf_counter()
    card = card_line()
    requests = prediction_requests()
    tok = TextTokenizer(cfg.vocab_size)
    want = never_evicting_tokens(params, cfg, [tok.encode(r.prompt, "").tokens for r in requests
                                               if r.session == PREDICTION_SESSION], [1])[0]
    reset_launch_counts()
    arms = {name: prediction_arm(params, cfg, requests, p) for name, p in chosen.items()}
    launches = launch_counts()
    failures = [f"{name}: {f}" for name, arm in arms.items() for f in arm["failures"]]
    failures += prediction_bars(arms, want)
    for name, arm in arms.items():
        t1 = arm["turn1"]
        log(f"  {name} ({card}): s0 resident {arm['audit']['resident']} of "
            f"{arm['audit']['prefix_blocks']} blocks before turn 1 on {t1['pod']}; turn 1 "
            f"cached {t1['cached']} of {t1['prompt']} tokens, TTFT {t1['ttft_s'] * 1e3:.2f} ms "
            f"(compute {t1['first_s'] * 1e3:.2f} ms); pre-landed "
            f"{arm['predicted_landed_blocks']}; scheduler {arm['scheduler']}; table "
            f"{arm['table']}; hit rate {arm['summary']['hit_rate']:.4f}; "
            f"{arm['seconds']:.1f} s; {len(arm['failures'])} failures")
    log(f"  launches {launches}")
    for name in ("paged_decode", "flash_prefill"):
        if launches[name] <= 0:
            failures.append(f"{name} was never launched on the prediction path")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 16c ran {seconds:.1f} s")
    if failures:
        raise AssertionError(f"phase 16c: {failures[:6]}")
    for arm in arms.values():
        arm.pop("streams")
        for row in arm["rows"]:
            row.pop("tokens")
    return dict(arms=arms, launches=launches, card=card, seconds=seconds)


# -- phase 17: the fleet planes' second half ------------------------------------

# 17a: benchmarking/fleet_device_bench.py's --cluster-replicas wiring (N
# partition-gated replicas beside the monolithic Indexer, fed the same
# messages) over phase 16a's precise arm; one replica restarts warm halfway.
CLUSTER_REPLICAS = 3
# Messages of its pods digested before the snapshot that the restarted
# replica is handed again with its tail: the snapshot's seq floors must drop
# each.
CLUSTER_OVERLAP = 8
# A fan-out deadline no CPU stall reaches: a late replica would show as a
# missing partition, a failure, not as a slower answer.
CLUSTER_SCATTER_TIMEOUT_S = 120.0


def entry_rows(index) -> set:
    """(model, request key hash, pod, tier) for every entry of the index."""
    return {(m, h, pod, tier) for m, h, pods in index.export_view().entries for pod, tier in pods}


def engine_rows(index) -> set:
    return set(index.export_view().engine_map)


class ClusterShadow:
    """Phase 17a beside phase 16a's precise arm: `CLUSTER_REPLICAS`
    partition-gated IndexerReplicas (each its own Indexer over the fleet's
    tokenization pool, its pool gated by `ReplicaPartitioner.accepts`, a
    FleetHealthTracker on a frozen clock for its seq watermarks) get every
    message the fleet's pool gets, in order; a ClusterScorer over them and
    a single-region GlobalRouter over the monolithic Indexer answer every
    precise route. Halfway through, the replica holding the most entries
    snapshots, shuts down, misses one request's messages and restarts warm
    from the CBOR file plus the journal since its `CLUSTER_OVERLAP`-th last
    message. Failures are collected in `failures`."""

    def __init__(self, snapshot_path: str, scorer_cls=ClusterScorer):
        self.snapshot_path = snapshot_path
        self.scorer_cls = scorer_cls
        self.journal, self.failures = [], []
        self.replicas, self.down, self.fleet = [], set(), None
        self.compared = self.router_compared = 0
        self.restart = None

    def _replica(self, rid: int):
        indexer = Indexer(IndexerConfig(token_processor_config=TokenProcessorConfig(
            block_size=PAGE)), tokenization_pool=self.fleet["indexer"].tokenizers_pool)
        rep = IndexerReplica(
            indexer, ClusterConfig(num_replicas=CLUSTER_REPLICAS, replica_id=rid,
                                   snapshot_path=self.snapshot_path),
            pool_config=EventPoolConfig(concurrency=2),
            health_tracker=FleetHealthTracker(FleetHealthConfig(), clock=lambda: 0.0))
        rep.start()
        return rep

    def attach(self, fleet, n_requests: int) -> None:
        self.fleet, self.half = fleet, n_requests // 2
        self.replicas = [self._replica(rid) for rid in range(CLUSTER_REPLICAS)]
        for msg in self.journal:  # anything published before the replicas came up
            for rep in self.replicas:
                rep.ingest(msg)
        self.scorer = self.scorer_cls(
            [LocalReplicaTransport(r.indexer) for r in self.replicas],
            partitioner=ReplicaPartitioner(CLUSTER_REPLICAS),
            config=ClusterConfig(num_replicas=CLUSTER_REPLICAS,
                                 scatter_timeout_s=CLUSTER_SCATTER_TIMEOUT_S),
            clock=lambda: 0.0)
        self.router = GlobalRouter(FederationConfig(region_id="region-0"),
                                   [Region("region-0", fleet["indexer"])], clock=lambda: 0.0)

    def deliver(self, msg) -> None:
        self.journal.append(msg)
        for rid, rep in enumerate(self.replicas):
            if rid not in self.down:
                rep.ingest(msg)

    def drain(self) -> None:
        for rid, rep in enumerate(self.replicas):
            if rid not in self.down:
                rep.event_pool.drain()

    def check(self, k: int, prompt: str, ps, rr: int) -> None:
        """Request k's replicated and federated answers against the
        monolithic Indexer's `ps` (its pool drained)."""
        self.drain()
        pods = list(self.fleet["pods"])
        cs = self.scorer.get_pod_scores_ex(prompt, PROACTIVE_MODEL, pods)
        want = (ps.scores, ps.match_blocks, ps.block_hashes)
        if (cs.scores, cs.match_blocks, cs.block_hashes) != want:
            self.failures.append(f"request {k}: the cluster scored {cs.scores} "
                                 f"{cs.match_blocks}, the Indexer {ps.scores} {ps.match_blocks}")
        self.compared += 1
        gs = self.router.score_ex(prompt, PROACTIVE_MODEL, pods)
        if gs.region != "region-0" or (gs.pod_scores.scores, gs.pod_scores.match_blocks) != \
                want[:2] or trace_route(gs.pod_scores.scores, rr)[0] != trace_route(ps.scores,
                                                                                   rr)[0]:
            self.failures.append(f"request {k}: the single-region router picked "
                                 f"{gs.region}/{gs.pod_scores.scores}, the Indexer {ps.scores}")
        self.router_compared += 1

    def before_serve(self, k: int) -> None:
        if k != self.half:
            return
        self.drain()
        sizes = [len(entry_rows(r.indexer.kv_block_index)) for r in self.replicas]
        self.rid = sizes.index(max(sizes))
        rep = self.replicas[self.rid]
        taken = rep.take_snapshot()
        self.snap_at = len(self.journal)
        owned = [i for i in range(self.snap_at) if rep.partitioner.accepts(self.journal[i])]
        self.tail_at = owned[-CLUSTER_OVERLAP] if len(owned) >= CLUSTER_OVERLAP else 0
        rep.shutdown()
        self.down.add(self.rid)
        self.restart = dict(request=k, replica=self.rid, snapshot=taken)

    def after_serve(self, k: int) -> None:
        if k != self.half:
            return
        self.fleet["pool"].drain()
        rep = self._replica(self.rid)
        part = rep.partitioner
        tail = self.journal[self.tail_at:]
        missed = sum(part.accepts(m) for m in self.journal[self.snap_at:])
        stats = rep.warm_restart(tail=tail)
        self.replicas[self.rid] = rep
        self.down.discard(self.rid)
        self.scorer.transports[self.rid] = LocalReplicaTransport(rep.indexer)
        dup = sum(part.accepts(m) for m in self.journal[self.tail_at:self.snap_at])
        owned = {r for r in entry_rows(self.fleet["index"]) if part.owns(r[2])}
        got = entry_rows(rep.indexer.kv_block_index)
        self.restart.update(tail=len(tail), missed=missed, duplicates=dup,
                            replay_skipped=stats["replay_skipped"], state=rep.state,
                            imported=stats["imported_pod_entries"], entries=len(got),
                            owned=len(owned), seq_floors=stats["seq_floors"])
        if stats["tail_messages"] != len(tail) or stats["replay_skipped"] != dup or \
                rep.state != "ready" or not dup:
            self.failures.append(f"warm restart: {self.restart}, {stats}")
        if got != owned:
            self.failures.append(f"warm restart: the replica holds {len(got)} entries, the "
                                 f"Indexer {len(owned)} of its pods ({len(got - owned)} extra, "
                                 f"{len(owned - got)} missing)")

    def finish(self) -> None:
        self.drain()
        union, engine = set(), set()
        for rep in self.replicas:
            union |= entry_rows(rep.indexer.kv_block_index)
            engine |= engine_rows(rep.indexer.kv_block_index)
        mono = entry_rows(self.fleet["index"])
        self.union = dict(replica_entries=len(union), indexer_entries=len(mono),
                          engine_rows=len(engine),
                          indexer_engine_rows=len(engine_rows(self.fleet["index"])))
        if union != mono:
            self.failures.append(f"the replicas' union holds {len(union)} entries, the Indexer "
                                 f"{len(mono)} ({len(union - mono)} extra, {len(mono - union)} "
                                 f"missing)")
        if not engine <= engine_rows(self.fleet["index"]):
            self.failures.append("the replicas map engine keys the Indexer does not")
        filtered = [rep.event_pool.filtered_events for rep in self.replicas]
        self.union["filtered"] = filtered

    def close(self) -> None:
        if hasattr(self, "scorer"):
            self.scorer.close()
        for rid, rep in enumerate(self.replicas):
            if rid not in self.down:
                rep.shutdown()

    def readings(self) -> dict:
        return dict(compared=self.compared, router_compared=self.router_compared,
                    restart=self.restart, union=getattr(self, "union", None),
                    scatter=self.scorer.status()["scatter_calls"] if hasattr(self, "scorer")
                    else 0, failures=self.failures)


def release_device() -> None:
    """Collect the pods earlier arms left in reference cycles (a pod and its
    event sink, tier store and connector refer to each other, so no
    refcount frees their device pages) and return the cached blocks."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def cluster_failures(shadow, n_requests: int) -> list:
    out = list(shadow.failures)
    if shadow.compared != n_requests or shadow.router_compared != n_requests:
        out.append(f"{shadow.compared} cluster and {shadow.router_compared} router answers "
                   f"compared of {n_requests} requests")
    if shadow.restart is None or "replay_skipped" not in shadow.restart:
        out.append("the replica never restarted")
    return out


def cluster_arm(params, cfg, requests, scorer_cls=ClusterScorer, service=None) -> dict:
    """Phase 16a's precise arm with phase 17a's shadow (and, given
    `service`, phase 18a's `ServiceShadow` beside it, which then routes): the
    arm and the shadows' readings, and their failures. The restarted
    replica's snapshot is a file of its own under the package's build/
    directory (git ignores it), removed after the arm."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="phase17a-", suffix=".cbor", dir=_build.BUILD_DIR)
    os.close(fd)
    try:
        shadow = ClusterShadow(path, scorer_cls=scorer_cls)
        both = shadow if service is None else Shadows(shadow, service)
        arm = trace_arm(params, cfg, requests, "precise", shadow=both)
    finally:
        os.unlink(path)
    arm["cluster"] = shadow.readings()
    arm["cluster"]["failures"] = cluster_failures(shadow, len(requests))
    if service is not None:
        arm["service"] = dict(service.readings, seconds=service.seconds,
                              failures=service_failures(service))
    return arm


def report_cluster(arm: dict, card: str) -> list:
    c = arm["cluster"]
    log(f"== phase 17a: {CLUSTER_REPLICAS} partition-gated indexer replicas and a "
        f"single-region GlobalRouter beside phase 16a's precise arm ({card}): "
        f"{c['compared']} requests scored by the ClusterScorer ({c['scatter']} scatter calls) "
        f"and the router; a replica restarted warm: {c['restart']}; union {c['union']}; "
        f"{len(c['failures'])} failures")
    return [f"17a: {f}" for f in c["failures"]]


# -- phase 18a: the HTTP scoring service in front of 16a's precise arm ----------

# The service's environment (api/http_service.py config_from_env's keys): the
# index metrics-instrumented, tracing on with a ring that holds the whole
# arm's traces, admission and the SLO monitor at their defaults, and
# fleet-health windows no gap of a slow machine reaches.
SERVICE_ENV = dict(zmq_endpoint="tcp://*:0", zmq_topic="kv@", pool_concurrency=4, hash_seed="",
                   block_size=PAGE, http_port=0, enable_metrics=True, trace_enabled=True,
                   trace_ring=4096, trace_slow_ms=10.0, trace_propagate=True,
                   suspect_after_s=1e6, stale_after_s=2e6)
SERVICE_TIMEOUT_S = 60.0  # every HTTP call's socket timeout
SERVICE_TRACE_BASE = 0x18A0_0000_0000_0000  # request k's trace id is this + k + 1
SERVICE_EXPLAIN = 4  # /debug/score_explain calls, at seeded requests
SERVICE_EXPLAIN_SEED = 18
# The read path's spans of one /score_completions, in the order the reference
# package records them (tests/test_torch_service.py holds it to the JAX
# package's trace of the same read path); a prompt shorter than one block
# stops after the derivation (`SERVICE_SHORT_SPANS`).
SERVICE_READ_SPANS = ("read.tokenize_queue_wait", "read.prefix_store", "read.encode",
                      "read.tokenize", "read.derive", "read.lookup", "read.score")
SERVICE_SHORT_SPANS = SERVICE_READ_SPANS[:5]
# What /metrics must have moved by over the arm (the service's registry is the
# process's, so the bar reads the difference from the arm's start), by the
# number of requests replayed: the CPU rehearsal's counts
# (tests/test_torch_service.py runs it and holds these equal).
SERVICE_METRICS = ("kvcache_index_lookup_requests_total", "kvcache_index_admissions_total",
                   "kvcache_index_evictions_total", "kvcache_events_dropped_total",
                   "kvcache_index_lookup_latency_seconds_count")
SERVICE_PREDICTED = {
    n: dict(metrics=dict(zip(SERVICE_METRICS, counts)), pod_states=dict.fromkeys(FLEET_POD_IDS, "healthy"),
            read_traces=n)
    for n, counts in ((76, (220.0, 1734.0, 0.0, 0.0, 149.0)),)  # the whole trace
}


_SAMPLE_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
_LABEL_PAIR = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(,|$)')


def parse_exposition(text: str) -> dict:
    """The Prometheus text format 0.0.4, parsed strictly: {(sample name,
    sorted label pairs): value}. A HELP or TYPE line of an unknown form, a
    sample before its family's TYPE, or a sample line that does not parse
    raises ValueError."""
    samples, typed = {}, {}
    for n, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# HELP "):
            if len(line.split(" ", 3)) < 3:
                raise ValueError(f"line {n}: bad HELP line {line!r}")
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in ("counter", "gauge", "histogram", "summary",
                                                   "untyped"):
                raise ValueError(f"line {n}: bad TYPE line {line!r}")
            typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_LINE.match(line)
        if m is None:
            raise ValueError(f"line {n}: bad sample line {line!r}")
        name, _, body, value = m.groups()
        family = next((f for f in (name, re.sub(r"_(bucket|count|sum)$", "", name))
                       if f in typed), None)
        if family is None:
            raise ValueError(f"line {n}: sample {name!r} before its family's TYPE line")
        labels = []
        if body:
            pos = 0
            while pos < len(body):
                lm = _LABEL_PAIR.match(body, pos)
                if lm is None:
                    raise ValueError(f"line {n}: bad labels {body!r}")
                labels.append((lm.group(1), lm.group(2)))
                pos = lm.end()
        samples[(name, tuple(sorted(labels)))] = float(value)
    return samples


class ServiceShadow:
    """Phase 18a beside phase 16a's precise arm: the port's ScoringService
    (`service_cls`) over an Indexer built as the fleet's is (TextTokenizer,
    the prefix store's shortcut off) with its index metrics-instrumented,
    served by api/web.py's AppServer on 127.0.0.1. Every message of the pods
    goes into the service's EventPool in order; each precise request is
    scored by POST /score_completions (carrying request k's X-Kvtpu-Trace
    id), and the arm routes by that answer. `finish` holds the batch,
    explain, metrics, health, readiness and trace surfaces to their bars.
    Failures are collected in `failures`; `seconds` is the time spent in
    the shadow's calls (the service's own pool digests beside them)."""

    def __init__(self, service_cls=http_service.ScoringService):
        self.service_cls = service_cls
        self.pending, self.failures, self.prompts = [], [], []
        self.blocks, self.delivered = [], 0
        self.service = self.server = self.fleet = None
        self.seconds = 0.0
        self.readings = {}

    # -- HTTP over the loopback socket --------------------------------------

    def call(self, method: str, path: str, body=None, headers=None) -> tuple:
        """(status, headers, body bytes) of one request on a fresh
        connection with a timeout."""
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=SERVICE_TIMEOUT_S)
        try:
            data = None if body is None else json.dumps(body).encode()
            hdrs = dict(headers or {})
            if data is not None:
                hdrs["Content-Type"] = "application/json"
            conn.request(method, path, body=data, headers=hdrs)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def call_json(self, method: str, path: str, body=None, headers=None, want: int = 200):
        status, _, data = self.call(method, path, body, headers)
        if status != want:
            self.failures.append(f"{method} {path}: status {status}, want {want}: "
                                 f"{data[:200]!r}")
            return None
        return json.loads(data)

    def score(self, prompt: str, headers=None):
        got = self.call_json("POST", "/score_completions", dict(
            prompt=prompt, model=PROACTIVE_MODEL, pods=list(self.fleet["pods"])), headers)
        return None if got is None else got["podScores"]

    def metrics(self) -> dict:
        status, hdrs, data = self.call("GET", "/metrics")
        if status != 200 or not hdrs.get("Content-Type", "").startswith(
                "text/plain; version=0.0.4"):
            self.failures.append(f"GET /metrics: status {status}, {hdrs.get('Content-Type')}")
            return {}
        try:
            samples = parse_exposition(data.decode("utf-8"))
        except ValueError as e:
            self.failures.append(f"GET /metrics does not parse: {e}")
            return {}
        return {name: sum(v for (n, _), v in samples.items() if n == name)
                for name in SERVICE_METRICS}

    # -- the arm's hooks ------------------------------------------------------

    def attach(self, fleet, n_requests: int) -> None:
        t0 = time.perf_counter()
        self.fleet, self.n = fleet, n_requests
        vocab = fleet["indexer"].tokenizers_pool.tokenizer.vocab
        indexer = Indexer(
            IndexerConfig(token_processor_config=TokenProcessorConfig(block_size=PAGE),
                          kv_block_index_config=dataclasses.replace(IndexConfig.default(),
                                                                    enable_metrics=True)),
            tokenization_pool=TokenizationPool(
                TokenizersPoolConfig(workers=2, min_prefix_overlap_ratio=float("inf")),
                tokenizer=TextTokenizer(vocab)))
        self.service = self.service_cls(dict(SERVICE_ENV), indexer=indexer)
        self.service.start(with_subscriber=False)
        obs.get_recorder().clear()  # the arm's traces only (trace ids repeat across arms)
        self.server = AppServer(self.service.make_app())
        self.port = self.server.start("127.0.0.1", 0)
        self.before = self.metrics()
        for msg in self.pending:
            self.service.event_pool.add_task(msg)
        self.pending = []
        self.seconds += time.perf_counter() - t0

    def deliver(self, msg) -> None:
        t0 = time.perf_counter()
        self.delivered += 1
        if self.service is None:
            self.pending.append(msg)
        else:
            self.service.event_pool.add_task(msg)
        self.seconds += time.perf_counter() - t0

    def check(self, k: int, prompt: str, ps, rr: int):
        """Request k's answer over the socket, held to the Indexer's `ps`;
        the arm routes by it."""
        t0 = time.perf_counter()
        self.service.event_pool.drain()
        carrier = obs.TraceCarrier(SERVICE_TRACE_BASE + k + 1, SERVICE_TRACE_BASE).serialize()
        got = self.score(prompt, {obs.HTTP_TRACE_HEADER: carrier})
        if got is not None and got != ps.scores:
            self.failures.append(f"request {k}: the service scored {got}, the Indexer "
                                 f"{ps.scores}")
        self.prompts.append(prompt)
        self.blocks.append(len(ps.block_hashes))
        self.seconds += time.perf_counter() - t0
        return ps.scores if got is None else got

    def before_serve(self, k: int) -> None:
        pass

    def after_serve(self, k: int) -> None:
        pass

    def finish(self) -> None:
        t0 = time.perf_counter()
        self.service.event_pool.drain()
        pods = list(self.fleet["pods"])
        got = self.call_json("POST", "/score_completions/batch", dict(requests=[
            dict(prompt=p, model=PROACTIVE_MODEL, pods=pods) for p in self.prompts]))
        singles = [self.score(p) for p in self.prompts]
        batch = None if got is None else [r["podScores"] for r in got["results"]]
        if batch != singles:
            off = [k for k, (b, s) in enumerate(zip(batch or [], singles)) if b != s]
            self.failures.append(f"the batch of {len(self.prompts)} differs from single calls "
                                 f"at {off[:8]} (batch {None if batch is None else len(batch)})")
        explained = sorted(random.Random(SERVICE_EXPLAIN_SEED).sample(
            range(len(self.prompts)), min(SERVICE_EXPLAIN, len(self.prompts))))
        for k in explained:
            explain = self.call_json("POST", "/debug/score_explain", dict(
                prompt=self.prompts[k], model=PROACTIVE_MODEL, pods=pods))
            if explain is not None and explain["scores"] != singles[k]:
                self.failures.append(f"score_explain of request {k}: {explain['scores']}, "
                                     f"/score_completions {singles[k]}")
        after = self.metrics()
        moved = {name: after.get(name, 0.0) - self.before.get(name, 0.0)
                 for name in SERVICE_METRICS}
        health = self.call_json("GET", "/health")
        if health != {"status": "ok"}:
            self.failures.append(f"/health answered {health}")
        ready = self.call_json("GET", "/readyz")
        states = {} if ready is None else {p: d["state"]
                                           for p, d in ready["fleet"]["pods"].items()}
        traces = self.call_json("GET", f"/debug/traces?plane=read&limit={SERVICE_ENV['trace_ring']}")
        ids = {f"{SERVICE_TRACE_BASE + k + 1:016x}": k for k in range(len(self.prompts))}
        mine = [t for t in (traces or {}).get("recent", []) if t["trace_id"] in ids]
        off_shape = [ids[t["trace_id"]] for t in mine
                     if tuple(s["name"] for s in t["spans"]) != (
                         SERVICE_READ_SPANS if self.blocks[ids[t["trace_id"]]]
                         else SERVICE_SHORT_SPANS)]
        roots = {t["name"] for t in mine}
        critical = self.call_json("GET", "/debug/critical_path")
        self.readings = dict(
            metrics=moved, pod_states=states, read_traces=len(mine),
            short_prompts=sum(not b for b in self.blocks), roots=sorted(roots),
            explained=explained,
            batch=None if batch is None else len(batch),
            critical_roots=sorted((critical or {}).get("roots", {})),
            dropped=self.service.event_pool.dropped_events, messages=self.delivered)
        want = SERVICE_PREDICTED.get(len(self.prompts))
        if want is None:
            self.failures.append(f"no prediction for {len(self.prompts)} requests")
        else:
            for key in ("metrics", "pod_states", "read_traces"):
                if self.readings[key] != want[key]:
                    self.failures.append(f"{key}: {self.readings[key]}, the rehearsal "
                                         f"predicted {want[key]}")
        if moved.get("kvcache_events_dropped_total"):
            self.failures.append(f"the service's pool dropped events: {moved}")
        if off_shape or roots - {"read.get_pod_scores"}:
            self.failures.append(f"read traces {sorted(roots)}; requests {off_shape[:8]} lack "
                                 f"the read path's spans {SERVICE_READ_SPANS}")
        if "read.get_pod_scores" not in self.readings["critical_roots"]:
            self.failures.append(f"/debug/critical_path has no read.get_pod_scores row: "
                                 f"{self.readings['critical_roots']}")
        if len(self.prompts) != self.n:
            self.failures.append(f"{len(self.prompts)} of {self.n} requests went through the "
                                 f"service")
        self.seconds += time.perf_counter() - t0

    def close(self) -> None:
        t0 = time.perf_counter()
        if self.server is not None:
            self.server.stop()
        if self.service is not None:
            self.service.stop()
        metrics_collector.stop_metrics_logging()
        self.seconds += time.perf_counter() - t0


class Shadows:
    """Several shadows beside one arm, each called in turn; `check` answers
    with the last answer one of them gave (the service's, which routes)."""

    def __init__(self, *shadows):
        self.shadows = shadows

    def attach(self, fleet, n_requests: int) -> None:
        for s in self.shadows:
            s.attach(fleet, n_requests)

    def deliver(self, msg) -> None:
        for s in self.shadows:
            s.deliver(msg)

    def check(self, k: int, prompt: str, ps, rr: int):
        answer = None
        for s in self.shadows:
            got = s.check(k, prompt, ps, rr)
            if got is not None:
                answer = got
        return answer

    def before_serve(self, k: int) -> None:
        for s in self.shadows:
            s.before_serve(k)

    def after_serve(self, k: int) -> None:
        for s in self.shadows:
            s.after_serve(k)

    def finish(self) -> None:
        for s in self.shadows:
            s.finish()

    def close(self) -> None:
        for s in self.shadows:
            s.close()


def service_failures(shadow) -> list:
    return [f"18a: {f}" for f in shadow.failures]


def service_arm(params, cfg, requests, service_cls=http_service.ScoringService) -> dict:
    """Phase 16a's precise arm routed by phase 18a's service alone (`--phases
    18a`, the rehearsal and the fault check): the arm and the service's
    readings and failures."""
    shadow = ServiceShadow(service_cls)
    arm = trace_arm(params, cfg, requests, "precise", shadow=shadow)
    arm["service"] = dict(shadow.readings, seconds=shadow.seconds,
                          failures=service_failures(shadow))
    return arm


def report_service(arm: dict, card: str) -> list:
    s = arm["service"]
    log(f"== phase 18a: the HTTP scoring service in front of phase 16a's precise arm ({card}): "
        f"{arm['summary']['requests']} requests routed by POST /score_completions over "
        f"127.0.0.1; /metrics moved {s.get('metrics')}; pods {s.get('pod_states')}; "
        f"{s.get('read_traces')} read traces; explain at {s.get('explained')}; batch of "
        f"{s.get('batch')}; {s['seconds']:.2f} s in the service's calls; "
        f"{len(s['failures'])} failures")
    return list(s["failures"])


# 17b: bench.py --geo's federation (its trace, sketch, digest cadence and
# windows, GEO_LOST_REGION lost at GEO_LOSS_AT_FRAC of the span), cut to two
# regions of two pods and a trace of 16 sessions (48 requests).
GEO = dict(n_regions=2, n_sessions=16, seed=42, day_period_s=120.0, diurnal_amplitude=0.85,
           session_rate_per_s=2.4, prefixes_per_region=2, prefix_words=900, max_turns=5)
GEO_MAX_REQUESTS = 48
GEO_REGION_PODS = 2
# The region lost: the cut trace's last requests (after the loss is detected)
# are homed in region-0, so losing it sends them to the failover successor.
GEO_LOST_REGION = "region-0"
GEO_LOSS_AT_FRAC = 0.55
GEO_FEDERATION = dict(digest_interval_s=4.0, digest_suspect_after_s=8.0,
                      digest_stale_after_s=12.0, digest_hot_k=6, digest_max_prefix_blocks=24,
                      replicate_hot_chains=False)
GEO_SKETCH = dict(half_life_s=60.0, top_k=24, max_prefix_blocks=24, sketch_width=1024)
GEO_ALONE = 12  # delegated requests held to a never-evicting pod of their region
GEO_ALONE_SEED = 17


def geo_requests() -> tuple:
    """The cut geo trace's requests and the trace's full request count."""
    requests = generate_geo(GeoConfig(**GEO)).requests()
    return requests[:GEO_MAX_REQUESTS], len(requests)


class RegionFront:
    """A region's precise front (its Indexer) that stops answering once the
    region is lost."""

    def __init__(self, indexer):
        self.indexer, self.lost = indexer, False

    def get_pod_scores_ex(self, prompt, model_name, pod_identifiers, lora_id=None):
        if self.lost:
            raise ConnectionError("region lost")
        return self.indexer.get_pod_scores_ex(prompt, model_name, pod_identifiers,
                                              lora_id=lora_id)


def region_route(scores: dict, ids: list, rr: int) -> tuple:
    """Inside a region: the top score, ties to the lowest pod; no cache
    signal round robin over the region's pods. (pod, rr)."""
    if not scores:
        return ids[rr % len(ids)], rr + 1
    best = max(scores.values())
    return min((p for p, s in scores.items() if s == best), key=ids.index), rr


def rendezvous_successor(home: str, regions: list, skip=()) -> str:
    """federation/failover.py's rule, computed here: the surviving region
    of the highest fnv64a(home:region)."""
    return max((r for r in regions if r != home and r not in skip),
               key=lambda r: hashing.fnv64a(f"{home}:{r}".encode("utf-8")))


def geo_arm(params, cfg, requests, tracker_cls=RegionFailoverTracker) -> dict:
    """Phase 17b: two regions of two flagship pods (phase 16a's pods), each
    region an Indexer, an EventPool and a popularity tracker behind a
    `Region`, one GlobalRouter over both on a fake clock set to each
    arrival; digests ship at every multiple of the interval (the clock
    visits each before the next arrival); from `loss_at` the lost region
    ships none and its front raises. Each request is scored by `score_ex`
    (home region from the trace), routed inside the picked region and
    served alone. The lost region's failover state is read at every digest
    tick and arrival."""
    t_arm = time.perf_counter()
    clock = FakeClock()
    tok = TextTokenizer(cfg.vocab_size)
    fed_cfg = FederationConfig(region_id="region-0",
                               regions=[f"region-{r}" for r in range(GEO["n_regions"])],
                               **GEO_FEDERATION)
    names = fed_cfg.region_set()
    fleets, fronts, regions, ids = {}, {}, {}, {}
    try:
        for r, name in enumerate(names):
            ids[name] = [f"pod-{r * GEO_REGION_PODS + i}" for i in range(GEO_REGION_PODS)]
            tracker = ChainPopularityTracker(PopularityConfig(**GEO_SKETCH), clock=clock)
            fleets[name] = proactive_fleet(params, cfg, tok, **TRACE_POD, popularity=tracker,
                                           pod_ids=ids[name])
            fronts[name] = RegionFront(fleets[name]["indexer"])
            regions[name] = Region(name, fronts[name], tracker=tracker,
                                   pods_fn=lambda name=name: ids[name])
        survivor = next(n for n in names if n != GEO_LOST_REGION)
        router = GlobalRouter(fed_cfg, regions,
                              derive_fn=derive_fn_from_indexer(fleets[survivor]["indexer"]),
                              clock=clock)
        router.failover = tracker_cls(names, suspect_after_s=fed_cfg.digest_suspect_after_s,
                                      stale_after_s=fed_cfg.digest_stale_after_s, clock=clock)
        loss_at = round(requests[-1].arrival_s * GEO_LOSS_AT_FRAC, 3)
        lost, next_digest, last_lost_digest, detected = False, 0.0, None, None
        rr = {name: 0 for name in names}
        rows, failures, states = [], [], []
        def at(t: float) -> None:
            nonlocal lost, detected
            clock.t = t
            if not lost and t >= loss_at:
                lost = fronts[GEO_LOST_REGION].lost = True
            state = router.failover.state_of(GEO_LOST_REGION)
            states.append((t, state))
            if lost and detected is None and state == STALE:
                detected = t

        for k, req in enumerate(requests):
            while next_digest <= req.arrival_s:
                at(next_digest)
                for name in names:
                    if lost and name == GEO_LOST_REGION:
                        continue
                    router.ingest_digest(encode_digest(regions[name].build_digest(
                        fed_cfg, now=clock.t)), now=clock.t)
                    if name == GEO_LOST_REGION:
                        last_lost_digest = clock.t
                next_digest += fed_cfg.digest_interval_s
            at(req.arrival_s)
            gs = router.score_ex(req.prompt, PROACTIVE_MODEL, [], home_region=req.region,
                                 now=clock.t)
            tried = gs.detail.get("tried", [])
            if detected is not None and (gs.region == GEO_LOST_REGION or
                                         GEO_LOST_REGION in tried):
                failures.append(f"request {k}: delegated to {GEO_LOST_REGION} after its "
                                f"detection at {detected} s")
            fo = gs.detail.get("failover")
            if fo is not None and fo["target"] != rendezvous_successor(fo["home"], names):
                failures.append(f"request {k}: failover to {fo['target']}, the rendezvous "
                                f"successor of {fo['home']} is "
                                f"{rendezvous_successor(fo['home'], names)}")
            if tried and gs.region != rendezvous_successor(tried[0], names, skip=tried):
                failures.append(f"request {k}: {tried} failed, then {gs.region}")
            if not gs.region:
                failures.append(f"request {k}: no region answered ({gs.detail})")
                continue
            pid, rr[gs.region] = region_route(gs.pod_scores.scores, ids[gs.region],
                                              rr[gs.region])
            tokens = tok.encode(req.prompt, PROACTIVE_MODEL).tokens
            done, first_s, total_s = serve_alone(fleets[gs.region]["pods"][pid], tokens)
            predicted = PAGE * gs.pod_scores.match_blocks.get(pid, 0)
            if done.num_cached_tokens != predicted:
                failures.append(f"request {k} on {gs.region}/{pid}: cached "
                                f"{done.num_cached_tokens}, match_blocks say {predicted}")
            settle(fleets[gs.region])
            rows.append(dict(k=k, home=req.region, region=gs.region, pod=pid,
                             cached=done.num_cached_tokens, prompt=len(tokens),
                             tried=list(tried), failover=fo is not None, first_s=first_s,
                             tokens=list(done.generated)))
        # Demotion: suspect once its last digest is suspect_after old, stale
        # once stale_after old; detected at the first reading from then on,
        # which a digest tick bounds by one interval.
        window = (last_lost_digest or 0.0) + fed_cfg.digest_stale_after_s
        after = [t for t, _ in states if t >= window]
        if detected is None or not after or detected != after[0] or \
                detected > window + fed_cfg.digest_interval_s:
            failures.append(f"{GEO_LOST_REGION} detected at {detected} s, its window closed at "
                            f"{window} s (first reading past it {after[:1]})")
        for t, st in states:
            if t < loss_at or last_lost_digest is None:
                continue
            age = t - last_lost_digest
            want = ("stale" if age >= fed_cfg.digest_stale_after_s else "suspect"
                    if age >= fed_cfg.digest_suspect_after_s else "healthy")
            if st != want:
                failures.append(f"{GEO_LOST_REGION} at {t} s (digest {age:.3f} s old) is {st}, "
                                f"not {want}")
        seen = [st for t, st in states if t >= loss_at]
        if "suspect" not in seen or "stale" not in seen:
            failures.append(f"{GEO_LOST_REGION}'s states after the loss: {seen}")
        post = [r for r in rows if r["home"] == GEO_LOST_REGION and detected is not None and
                requests[r["k"]].arrival_s >= detected]
        if not post or not any(r["tried"] for r in rows):
            failures.append(f"the loss left {len(post)} requests homed in {GEO_LOST_REGION} "
                            f"after its detection and {sum(bool(r['tried']) for r in rows)} "
                            f"failed delegations: the bars would be vacuous")
        failures += [f"{name}: {f}" for name in names
                     for f in tier_failures(fleets[name]) + pool_failures(fleets[name])]
        removed = sum(len(e.block_hashes) for f in fleets.values()
                      for batches in f["events"].values()
                      for b in batches for e in b.events if isinstance(e, BlockRemoved))
        if removed:
            failures.append(f"{removed} blocks evicted: the never-evicting bar needs pods that "
                            f"keep every block")
        status = router.status(now=clock.t)
    finally:
        for f in fleets.values():
            close_fleet(f)
    return dict(rows=rows, failures=failures, loss_at=loss_at, detected=detected,
                last_lost_digest=last_lost_digest, states=states,
                detection_s=None if detected is None else detected - loss_at,
                routed={name: sum(r["region"] == name for r in rows) for name in names},
                failovers=sum(r["failover"] for r in rows),
                retried=sum(bool(r["tried"]) for r in rows),
                hit_rate=sum(r["cached"] for r in rows) / max(1, sum(r["prompt"] for r in rows)),
                counters=status["counters"], lost_state=status["regions"][GEO_LOST_REGION],
                seconds=time.perf_counter() - t_arm)


def geo_alone_failures(params, cfg, arm: dict, requests) -> list:
    """The greedy tokens of `GEO_ALONE` seeded delegated requests against a
    never-evicting pod of the region each went to, serving that region's
    requests in order."""
    tok = TextTokenizer(cfg.vocab_size)
    rows = arm["rows"]
    checked = set(random.Random(GEO_ALONE_SEED).sample(range(len(rows)),
                                                        min(GEO_ALONE, len(rows))))
    out = []
    for name in sorted({r["region"] for r in rows}):
        mine = [i for i, r in enumerate(rows) if r["region"] == name]
        prompts = [tok.encode(requests[rows[i]["k"]].prompt, "").tokens for i in mine]
        local = [j for j, i in enumerate(mine) if i in checked]
        want = never_evicting_tokens(params, cfg, prompts, local)
        for j, w in zip(local, want):
            if rows[mine[j]]["tokens"] != w:
                out.append(f"request {rows[mine[j]]['k']} on {name}: greedy tokens differ from "
                           f"the never-evicting pod")
    arm["alone_checked"] = sorted(rows[i]["k"] for i in checked)
    return out


# 17c: the transfer plane's chaos injector (kv_connectors/faults.py, wrapped
# as bench.py's --chaos wraps each pod's client) on phase 8's peer onboard.
CHAOS_RATE = 0.05
CHAOS_CUT = (16, 48)  # the first corrupted block lies in this range of the prefix
CHAOS_BREAKER = 2  # breaker_failure_threshold of the stalled client
CHAOS_STALL_REQUESTS = 3


class RecordingTransport(FaultyTransport):
    """FaultyTransport that records the blocks its seeded draw damaged."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.damaged = []

    def _block_corrupted(self, block_hash: int, rate: float) -> bool:
        hit = super()._block_corrupted(block_hash, rate)
        if hit:
            self.damaged.append(block_hash)
        return hit


def chaos_seed(prefix_hashes) -> tuple:
    """The first plan seed whose draw damages the prefix first at a block in
    CHAOS_CUT: (seed, the damaged block indices)."""
    probe = FaultyTransport(None, TransferFaultPlan(), clock=lambda: 0.0)
    for seed in range(1, 1000):
        probe.plan.seed = seed
        bad = [i for i, h in enumerate(prefix_hashes) if probe._block_corrupted(h, CHAOS_RATE)]
        if bad and CHAOS_CUT[0] <= bad[0] < CHAOS_CUT[1]:
            return seed, bad
    raise AssertionError("no seed damages the prefix inside CHAOS_CUT")


def chaos_check(params, cfg, int8: bool, transport_cls=RecordingTransport) -> dict:
    """Phase 17c on one page format. A source pod S (host tier, never
    evicts) serves the first `cut` blocks of the prefix and then P
    (exported to its ready buffer, found through the index); an onboarding
    pod C whose `connector.client` is wrapped in the injector serves P'.
    Corrupt with integrity on: the damaged blocks are the seeded draw's, each
    detected, none admitted; C onboards the `cut` blocks before the first
    and recomputes the rest, and P' (suffix logits, 32 greedy tokens) equals
    a never-evicting pod M that served the same `cut` blocks first. Integrity
    off: every damaged block is admitted. Stall: the breaker opens after
    CHAOS_BREAKER charged timeouts, later fetches are skipped uncharged, and
    each answer equals M's recompute."""
    model = "llama-flagship-1.14b"
    rng = np.random.default_rng(88)
    vocab = cfg.vocab_size
    prefix = rng.integers(0, vocab, PREFIX_TOKENS).tolist()
    prompt_p = prefix + rng.integers(0, vocab, SUFFIX_TOKENS).tolist()
    prompt_q = prefix + rng.integers(0, vocab, SUFFIX_TOKENS).tolist()
    stall = [rng.integers(0, vocab, PREFIX_TOKENS + SUFFIX_TOKENS).tolist()
             for _ in range(CHAOS_STALL_REQUESTS)]
    stall_q = [p[:PREFIX_TOKENS] + rng.integers(0, vocab, SUFFIX_TOKENS).tolist() for p in stall]
    index = InMemoryIndex()
    tp = ChunkedTokenDatabase(TokenProcessorConfig(block_size=PAGE))
    hashes = [key.chunk_hash for key in tp.tokens_to_kv_block_keys(None, prefix, "")]
    seed, bad = chaos_seed(hashes)
    cut = bad[0]
    clock = FakeClock()
    pods = []

    def pod(pid, n_pages, host_tier=True):
        def sink(batch):
            digest_batch(index, tp, pid, model, batch)

        p = EnginePod(EnginePodConfig(
            pod_id=pid, model_name=model, n_pages=n_pages, page_size=PAGE, device_tier="gpu",
            max_pages_per_seq=256, model_config=cfg, device=params["embed"].device,
            use_quantized_kv=int8, enable_host_tier=host_tier,
            transfer_cost_model=ALWAYS_TRANSFER), event_sink=sink, params=params)
        pods.append(p)
        return p

    def onboarding_pod(pid, faults, verify):
        c = pod(pid, 256)
        c.set_peer_resolver(IndexBackedPeerResolver(index, model, {"pod-s": src.transfer_address},
                                                    pid))
        inner = c.connector.client
        inner.config.breaker_failure_threshold = CHAOS_BREAKER
        inner.clock = clock
        plan = TransferFaultPlan(seed=seed, peers={tuple(src.transfer_address): faults})
        c.connector.client = transport_cls(inner, plan, clock=clock, verify_integrity=verify)
        return c

    out, failures = dict(seed=seed, damaged_indices=bad, cut=cut), []
    try:
        src = pod("pod-s", 4096)
        ttft_serve(src, prefix[:cut * PAGE])
        p_src = ttft_serve(src, prompt_p, keep=True)
        src.export_sequence(p_src["state"])
        src.free(p_src["state"])
        for q in stall:
            r = ttft_serve(src, q, keep=True)
            src.export_sequence(r["state"])
            src.free(r["state"])
        ref = pod("pod-m", 4096, host_tier=False)
        ttft_serve(ref, prefix[:cut * PAGE])
        want = ttft_serve(ref, prompt_q, HOST_TIER_DECODE)
        want_stall = [ttft_serve(ref, q, HOST_TIER_DECODE) for q in stall_q]

        arms = {}
        for name, verify in (("corrupt", True), ("corrupt_integrity_off", False)):
            c = onboarding_pod(f"pod-c-{name}", PeerTransferFaults(corrupt_rate=CHAOS_RATE),
                               verify)
            # The control arm's counts are its bar: its answer is not held, so
            # it stops at its first token.
            got = ttft_serve(c, prompt_q, HOST_TIER_DECODE if verify else 1)
            ft = c.connector.client
            # A block that came back damaged is asked for again (the store's
            # fallback fetch): the draw damages it again, and it counts again.
            damaged = ft.damaged
            arms[name] = dict(cached=got["cached"], counters=dict(ft.counters),
                              damaged=len(damaged), damaged_blocks=len(set(damaged)),
                              onboards=c.tier_store.stats["onboards"],
                              logits_equal=torch.equal(got["logits"], want["logits"]),
                              tokens_equal=got["tokens"] == want["tokens"][:len(got["tokens"])],
                              max_abs_logit_diff=float((got["logits"].float() -
                                                        want["logits"].float()).abs().max()))
            draw = {hashes[i] for i in bad}
            if set(damaged) != draw:
                failures.append(f"{name}: the injector damaged {len(set(damaged))} blocks, the "
                                f"seeded draw {len(draw)}")
            if verify:
                want_counts = dict(corrupt_injected=len(damaged), corrupt_detected=len(damaged),
                                   corrupt_admitted=0)
                if {k: ft.counters[k] for k in want_counts} != want_counts:
                    failures.append(f"{name}: counters {ft.counters}, want {want_counts}")
                if got["cached"] != cut * PAGE or arms[name]["onboards"] != cut:
                    failures.append(f"{name}: cached {got['cached']} after {arms[name]['onboards']} "
                                    f"onboards; the first damaged block is {cut}")
                if not (arms[name]["logits_equal"] and arms[name]["tokens_equal"]):
                    failures.append(f"{name}: P' differs from the never-evicting pod "
                                    f"({arms[name]['max_abs_logit_diff']})")
            elif ft.counters["corrupt_admitted"] != len(bad) or len(damaged) != len(bad):
                failures.append(f"{name}: {ft.counters['corrupt_admitted']} admitted, "
                                f"{len(bad)} damaged")
        c = onboarding_pod("pod-c-stall", PeerTransferFaults(stall_from_s=0.0), True)
        got_stall = [ttft_serve(c, q, HOST_TIER_DECODE) for q in stall_q]
        ft = c.connector.client
        ladder = ft._timeout_ladder_s(connect=False)
        log_rows = list(ft.fetch_log)
        state = ft.peer_state(*src.transfer_address).breaker.state
        arms["stall"] = dict(counters=dict(ft.counters), fetch_log=log_rows, breaker=state,
                             cached=[g["cached"] for g in got_stall],
                             equal=[torch.equal(g["logits"], w["logits"]) and
                                    g["tokens"] == w["tokens"]
                                    for g, w in zip(got_stall, want_stall)])
        kinds = [row[3] for row in log_rows]
        want_kinds = ["stalled"] * CHAOS_BREAKER + ["breaker_skip"] * (
            CHAOS_STALL_REQUESTS - CHAOS_BREAKER)
        if kinds != want_kinds or [row[2] for row in log_rows] != \
                [ladder] * CHAOS_BREAKER + [0.0] * (CHAOS_STALL_REQUESTS - CHAOS_BREAKER):
            failures.append(f"stall: fetches {log_rows}, want {want_kinds} at {ladder} s each "
                            f"until the breaker opens")
        if state != "open" or ft.counters["stalled_fetches"] != CHAOS_BREAKER:
            failures.append(f"stall: breaker {state}, counters {ft.counters}")
        if not all(arms["stall"]["equal"]) or any(arms["stall"]["cached"]):
            failures.append(f"stall: answers {arms['stall']['equal']}, cached "
                            f"{arms['stall']['cached']}")
        out.update(arms=arms, failures=failures)
        return out
    finally:
        for p in pods:
            p.close()


# 17d: the SLO autopilot on phase 15a. The monitor's hit-rate objective
# counts the requests whose cached share of the prompt fell under
# AUTOPILOT_HIT_FLOOR (bench.py's autopilot arm's objective), sampled from
# the second wave on (the first is the cold start). Windows and controller
# cadence in waves of RESILIENCE_STEP_S.
AUTOPILOT_HIT_FLOOR = 0.5
AUTOPILOT_HIT_BUDGET = 0.05
AUTOPILOT_SLO = dict(fast_window_s=2.0, slow_window_s=4.0, burn_threshold=2.0)
AUTOPILOT_CTRL = dict(min_interval_s=RESILIENCE_STEP_S, warmup_s=2.0, cooldown_s=1.0,
                      decay_after_s=2.0)
AUTOPILOT_SETTLE_TICKS = 16  # quiet ticks after the replay for the knobs to walk home


class AutopilotRig:
    """Phase 17d's controller on a resilience arm: an SLOMonitor over the
    arm's hit counters, a SignalAssembler over it and the anti-entropy
    tracker, the auditor's cadence knob, an AutopilotController on the arm's
    fake clock. `tick(now)` checks every actuation's bounds; `settle`
    ticks on after the replay until every knob is home."""

    def __init__(self, auditor, trust, controller_cls=AutopilotController):
        # Its own clock: it follows the arm's wave by wave, and walks on
        # alone after the replay (the plane's clock stays where it ended).
        self.clock = FakeClock()
        self.counts = [0, 0]  # (bad, total) requests since the monitor's birth
        self.monitor = None
        self.registry = KnobRegistry()
        if auditor is not None:
            auditor.register_knobs(self.registry)
        self.baseline = {n: d["position"] for n, d in self.registry.positions().items()}
        self.trust = trust
        self.controller_cls = controller_cls
        self.controller = None
        self.applied, self.failures, self.by_wave = [], [], {}

    def start(self) -> None:
        """After the first wave: the monitor's baseline sample excludes the
        cold start."""
        self.monitor = SLOMonitor([SLOObjective(
            name=OBJECTIVE_HIT_RATE, description=f"requests with a cached share under "
            f"{AUTOPILOT_HIT_FLOOR}", budget=AUTOPILOT_HIT_BUDGET,
            counts_fn=lambda: tuple(self.counts))], SLOConfig(**AUTOPILOT_SLO), clock=self.clock)
        self.controller = self.controller_cls(
            self.registry, SignalAssembler(slo_monitor=self.monitor, antientropy=self.trust,
                                           clock=self.clock),
            config=AutopilotConfig(**AUTOPILOT_CTRL), clock=self.clock)

    def served(self, now: float, cached: int, prompt: int) -> None:
        if self.monitor is not None:
            bad = cached < AUTOPILOT_HIT_FLOOR * prompt
            self.counts[0] += bad
            self.counts[1] += 1
            wave = self.by_wave.setdefault(now, [0, 0])
            wave[0] += bad
            wave[1] += 1

    def tick(self, now: float) -> list:
        if self.controller is None:
            return []
        self.clock.t = now
        applied = self.controller.tick(now)
        self.applied += applied
        for t, rule, name, direction, delta, pos in applied:
            spec = self.registry.get(name).spec
            if abs(delta) > spec.max_step + 1e-12 or not spec.floor <= pos <= spec.ceiling:
                self.failures.append(f"{t} s: {rule} moved {name} by {delta} to {pos}, bounds "
                                     f"[{spec.floor}, {spec.ceiling}] step {spec.max_step}")
        for name, doc in self.registry.positions().items():
            spec = self.registry.get(name).spec
            if not spec.floor <= doc["position"] <= spec.ceiling:
                self.failures.append(f"{now} s: {name} at {doc['position']}, outside "
                                     f"[{spec.floor}, {spec.ceiling}]")
        return applied

    def settle(self, now: float) -> float:
        for _ in range(AUTOPILOT_SETTLE_TICKS):
            if self.registry.at_baseline() and self.applied:
                break
            now += RESILIENCE_STEP_S
            self.tick(now)
        return now

    def readings(self) -> dict:
        journal = list(self.controller.journal) if self.controller is not None else []
        if journal != self.applied:
            self.failures.append(f"the journal {journal} is not the actuations {self.applied}")
        return dict(actuations=len(self.applied), journal=journal,
                    reverts=sum(e[3] == "revert" for e in journal),
                    at_baseline=self.registry.at_baseline(), baseline=self.baseline,
                    final={n: d["position"] for n, d in self.registry.positions().items()},
                    counts=list(self.counts), by_wave=dict(self.by_wave),
                    status=self.controller.status()["rules"] if self.controller else None,
                    failures=self.failures)


def phase_cluster(params, cfg) -> dict:
    """Phase 17a alone (`--phases 17a`): phase 16a's precise arm with the
    replicas beside it (the full run's 16a carries it)."""
    t_phase = time.perf_counter()
    card = card_line()
    release_device()
    reset_launch_counts()
    arm = cluster_arm(params, cfg, sharegpt_requests())
    arm["cluster"]["launches"] = launch_counts()
    failures = report_cluster(arm, card) + [f"16a precise: {f}" for f in arm["failures"]]
    seconds = time.perf_counter() - t_phase
    log(f"  phase 17a ran {seconds:.1f} s; launches {arm['cluster']['launches']}")
    if failures:
        raise AssertionError(f"phase 17a: {failures[:6]}")
    return dict(cluster=arm["cluster"], summary=arm["summary"], seconds=seconds)


def phase_service(params, cfg) -> dict:
    """Phase 18a alone (`--phases 18a`): phase 16a's precise arm routed by
    the service (the full run's 16a carries it, beside 17a)."""
    t_phase = time.perf_counter()
    card = card_line()
    release_device()
    reset_launch_counts()
    arm = service_arm(params, cfg, sharegpt_requests())
    arm["service"]["launches"] = launches = launch_counts()
    failures = report_service(arm, card) + [f"16a precise: {f}" for f in arm["failures"]]
    for name in ("paged_decode", "flash_prefill"):
        if launches[name] <= 0:
            failures.append(f"{name} was never launched on the service's path")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 18a ran {seconds:.1f} s (the precise arm {arm['seconds']:.1f} s, "
        f"{arm['service']['seconds']:.2f} s of it in the service's calls); launches {launches}")
    if failures:
        raise AssertionError(f"phase 18a: {failures[:6]}")
    return dict(service=arm["service"], summary=arm["summary"], seconds=seconds)


def phase_geo(params, cfg) -> dict:
    requests, n_all = geo_requests()
    log(f"== phase 17b: two regions of {GEO_REGION_PODS} bf16 flagship pods "
        f"({TRACE_POD['n_pages']} pages of {PAGE}) under one GlobalRouter on a fake clock; the "
        f"geo trace {GEO} cut from {n_all} to its first {len(requests)} requests; "
        f"{GEO_LOST_REGION} lost at {GEO_LOSS_AT_FRAC} of the span; federation "
        f"{GEO_FEDERATION}; sketch {GEO_SKETCH}")
    t_phase = time.perf_counter()
    card = card_line()
    release_device()
    reset_launch_counts()
    arm = geo_arm(params, cfg, requests)
    launches = launch_counts()
    failures = list(arm["failures"]) + geo_alone_failures(params, cfg, arm, requests)
    log(f"  ({card}): loss at {arm['loss_at']} s, {GEO_LOST_REGION}'s last digest "
        f"{arm['last_lost_digest']} s, detected stale at {arm['detected']} s "
        f"({arm['detection_s']} s after the loss); routed {arm['routed']}, "
        f"{arm['failovers']} failovers, {arm['retried']} failed delegations retried; hit rate "
        f"{arm['hit_rate']:.4f}; counters {arm['counters']}; {GEO_LOST_REGION} "
        f"{arm['lost_state']}; never-evicting checks on requests {arm['alone_checked']}; "
        f"launches {launches}; {arm['seconds']:.1f} s; {len(failures)} failures")
    for name in ("paged_decode", "flash_prefill"):
        if launches[name] <= 0:
            failures.append(f"{name} was never launched on the federation path")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 17b ran {seconds:.1f} s")
    if failures:
        raise AssertionError(f"phase 17b: {failures[:6]}")
    for row in arm["rows"]:
        row.pop("tokens")
    arm.pop("states")
    return dict(arm=arm, launches=launches, card=card, seconds=seconds)


def phase_chaos(params, cfg) -> dict:
    log(f"== phase 17c: phase 8's peer onboard under the transfer plane's chaos injector "
        f"(the onboarding pod's client wrapped in FaultyTransport; corrupt rate {CHAOS_RATE}, "
        f"the first damaged block in {CHAOS_CUT}; a stall with breaker threshold "
        f"{CHAOS_BREAKER} over {CHAOS_STALL_REQUESTS} requests), bf16 and int8 pages")
    t_phase = time.perf_counter()
    card = card_line()
    out, failures = {}, []
    reset_launch_counts()
    for int8 in (False, True):
        fmt = "int8" if int8 else "bf16"
        release_device()
        r = chaos_check(params, cfg, int8)
        failures += [f"{fmt}: {f}" for f in r.pop("failures")]
        for name, arm in r["arms"].items():
            log(f"  {fmt} {name} ({card}): " + ", ".join(
                f"{k} {v}" for k, v in arm.items() if k != "fetch_log"))
        log(f"  {fmt}: plan seed {r['seed']}, damaged prefix blocks {r['damaged_indices']}; "
            f"stall fetches {r['arms']['stall']['fetch_log']}")
        out[fmt] = r
    launches = launch_counts()
    for name in ("paged_decode", "paged_decode_int8", "flash_prefill"):
        if launches[name] <= 0:
            failures.append(f"{name} was never launched on the transfer chaos path")
    seconds = time.perf_counter() - t_phase
    log(f"  phase 17c ran {seconds:.1f} s; launches {launches}")
    if failures:
        raise AssertionError(f"phase 17c: {failures[:6]}")
    return dict(formats=out, launches=launches, card=card, seconds=seconds)


def phase_autopilot(params, cfg, seed: int) -> dict:
    """Phase 17d alone (`--phases 17d`): phase 15a's no-fault arm without the
    autopilot and with it, held equal, then the faulted autopilot arm (the
    full run's 15a carries the latter two)."""
    t_phase = time.perf_counter()
    card = card_line()
    release_device()
    waves = multitenant_traffic(seed, cfg.vocab_size, RESILIENCE_WAVES)
    bare = resilience_arm(params, cfg, waves, dict(seed=0, pods={}), True)
    healthy = resilience_arm(params, cfg, waves, dict(seed=0, pods={}), True,
                             autopilot=AutopilotController)
    reset_launch_counts()
    out = autopilot_arms(params, cfg, waves, healthy, bare)
    out["launches"] = launch_counts()
    failures = out.pop("failures") + [f"no_faults: {f}" for arm in (bare, healthy)
                                      for f in arm["failures"]]
    report_autopilot(out, healthy, card)
    seconds = time.perf_counter() - t_phase
    log(f"  phase 17d ran {seconds:.1f} s")
    if failures:
        raise AssertionError(f"phase 17d: {failures[:6]}")
    for arm in out["arms"].values():
        arm.pop("states", None)
        arm.pop("trace", None)
    return dict(out, seconds=seconds)


# -- phase 19: a tp pod of two ranks on one card, and the train step -------------

TP = 2  # the pod's ranks: two processes on cuda:0 over gloo
TP_MODEL = "llama-flagship-1.14b"
TP_RUNS = (("bf16", False, 1), ("int8", True, 4))  # page format, decode_steps
TP_NEW = 16  # greedy tokens a request
TP_JOIN_S = 300.0  # the children's time limit, from their start
TP_COLLECTIVE_S = 60  # gloo's bound on one collective: a rank out of step fails, not hangs
TP_TICK_REPS = 10
TRAIN_BATCH = (4, 512)
TRAIN_STEPS = 5
TRAIN_LR = 1e-3
# 19b's bars: the step-0 loss within this relative error of the f32 twin's;
# each tensor's gradient (each layer's slice of a stacked weight) within
# this relative norm error of the f32 twin's: about 3x the largest reading
# on an H100 (4.87e-2, layer 15's wk), far under the 1.0 of a dropped
# layer (chip_fault_check.py).
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL = 0.15


def tp_traffic(vocab: int) -> list:
    """Phase 5's traffic shape for one pod: ten requests of one 1,024-token
    prefix and 512 unique tokens, TP_NEW greedy tokens each."""
    rng = np.random.default_rng(1234)
    prefix = rng.integers(0, vocab, 1024).tolist()
    return [dict(prompt_tokens=prefix + rng.integers(0, vocab, 512).tolist(),
                 max_new_tokens=TP_NEW, sampling=None) for _ in range(10)]


def tp_pod(params, cfg, int8: bool, events: list, group=None) -> EnginePod:
    return EnginePod(
        EnginePodConfig(pod_id="pod-tp", model_name=TP_MODEL, n_pages=4096, page_size=PAGE,
                        device_tier="gpu", max_pages_per_seq=256, model_config=cfg,
                        device="cuda", use_quantized_kv=int8,
                        tp=1 if group is None else TP, group=group),
        event_sink=events.append, params=params,
    )


class TableRecorder(Scheduler):
    """A Scheduler that keeps every running sequence's block table after
    each tick (the bar: both ranks' tables equal, tick by tick)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.tables = []

    def step(self):
        finished = super().step()
        self.tables.append([(r.req_id, list(r.state.block_table)) for r in self._running])
        return finished


def tp_serve(params, cfg, int8: bool, steps: int, group=None) -> dict:
    """The traffic through a Scheduler on a fresh pod (tp over `group`, or
    tp = 1): tokens, cached tokens, events, per-tick tables, page shapes,
    launches, tick walls."""
    events = []
    pod = tp_pod(params, cfg, int8, events, group)
    reset_launch_counts()
    r = run_scheduler(pod, tp_traffic(cfg.vocab_size), steps, max_batch=8, budget=512,
                      scheduler=TableRecorder)
    torch.cuda.synchronize()
    out = dict(tokens=r["tokens"], cached=[q.num_cached_tokens for q in r["requests"]],
               events=event_rows(events), tables=r["scheduler"].tables,
               heads=[tuple(c.shape) for c in pod.kv_cache], launches=launch_counts(),
               tick_ms=[t * 1e3 for t in r["tick_s"]], wall_s=r["wall_s"])
    del pod
    torch.cuda.empty_cache()
    return out


def prefill_check_inputs(cfg, seed: int = 3) -> tuple:
    """prefill_logits_check's tokens (1,024 cached + the 512 chunk) and its
    128-page table, the same for the same seed."""
    l_new, s, off = PREFILL_SERVING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (off + l_new,), generator=gen, device="cuda",
                           dtype=torch.int32)
    table = torch.randperm(s // PAGE, generator=gen, device="cuda").to(torch.int32)
    return tokens, table


def tp_prefill_logits(cfg, params, group=None, plain=False, at=None):
    """The prefix-hit prefill's chunk logits on a fresh cache (head-sharded
    under `at` with `group`)."""
    l_new, s, off = PREFILL_SERVING_SHAPE
    tokens, table = prefill_check_inputs(cfg)
    cache = llama.make_kv_pages(cfg, s // PAGE, PAGE, "cuda")
    if at is not None:
        cache = tp_serving.shard_kv_cache(cache, at)
    llama.prefill_cache(cfg, params, cache, tokens[:off], table, 0, plain=plain, group=group)
    _, out = llama.prefill_cache(cfg, params, cache, tokens[off:], table, off, plain=plain,
                                 group=group)
    return out.float()


def tp_decode_inputs(cfg, int8: bool, at=None):
    """phase 6's batch-8 decode state (seed 5), head-sharded under `at`."""
    cache, tables, lens, tokens, _ = decode_setup(cfg, int8, seed=5)
    if at is not None:
        cache = tp_serving.shard_kv_cache(cache, at)
    return cache, tables, lens, tokens


class CollectiveTimer:
    """While entered, every all_reduce, all_gather and broadcast of this
    process is timed between two synchronizations (checks only)."""

    NAMES = ("all_reduce", "all_gather", "broadcast")

    def __enter__(self):
        self.ms, self.calls = 0.0, 0
        self._real = {n: getattr(dist, n) for n in self.NAMES}

        def timed(fn):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.ms += (time.perf_counter() - t) * 1e3
                self.calls += 1
                return out
            return call
        for n, fn in self._real.items():
            setattr(dist, n, timed(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._real.items():
            setattr(dist, n, fn)


def decode_tick_ms(cfg, params, cache, tables, lens, tokens, group=None) -> dict:
    """The wall of one decode tick at batch 8 (the model step, the argmax,
    rank 0's tokens broadcast, the read back), median of TP_TICK_REPS; with
    `group`, again with every collective timed between synchronizations:
    their share of that tick."""
    from llm_d_kv_cache_manager_tpu_torch.parallel.collectives import broadcast_from_first

    def tick():
        _, logits = llama.decode_step_cache(cfg, params, cache, tokens, tables, lens,
                                            group=group)
        return broadcast_from_first(torch.argmax(logits, dim=-1), group).tolist()

    wall = time_ms(tick, runs=TP_TICK_REPS, warmup=2)
    out = dict(wall_ms=wall)
    if group is not None:
        ticks = []
        for _ in range(TP_TICK_REPS):
            with CollectiveTimer() as timer:
                t = time.perf_counter()
                tick()
                torch.cuda.synchronize()
                ticks.append(((time.perf_counter() - t) * 1e3, timer.ms, timer.calls))
        tick_ms, coll_ms, calls = sorted(ticks)[len(ticks) // 2]
        out.update(timed_tick_ms=tick_ms, collective_ms=coll_ms, collectives=calls,
                   collective_share=coll_ms / tick_ms)
    return out


def tp_rank_main(rank: int, store: str, out_path: str, fault=None) -> None:
    """One rank of phase 19a's tp pod, in its own process on cuda:0: the
    same seeded weights as the parent, its shards; the traffic through the
    Scheduler on both page formats; the logits checks' inputs on its shard;
    a decode tick's wall and collective share. `fault`: a planted fault
    (chip_fault_check.py), installed first. Writes its results to
    `out_path` (or the traceback) and exits."""
    import pickle
    import traceback
    from datetime import timedelta

    result = None
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        multihost.initialize_distributed(init_method=f"file://{store}", world_size=TP,
                                         rank=rank, backend="gloo",
                                         timeout=timedelta(seconds=TP_COLLECTIVE_S))
        group = dist.group.WORLD
        if fault is not None:
            fault(rank)
        cfg = llama.LlamaConfig(**FLAGSHIP)
        params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        out = {"runs": {}}
        for fmt, int8, steps in TP_RUNS:
            out["runs"][fmt] = tp_serve(params, cfg, int8, steps, group)
        at = MeshCoords({"tp": TP}, {"tp": rank})
        shard = tp_serving.shard_serving_params(params, at)
        del params
        out["prefill_logits"] = tp_prefill_logits(cfg, shard, group, at=at).cpu()
        out["decode_logits"] = {}
        for fmt, int8, _ in TP_RUNS:
            cache, tables, lens, tokens = tp_decode_inputs(cfg, int8, at)
            _, logits = llama.decode_step_cache(cfg, shard, cache, tokens, tables, lens,
                                                group=group)
            out["decode_logits"][fmt] = logits.float().cpu()
            if not int8:
                out["tick"] = decode_tick_ms(cfg, shard, cache, tables, lens, tokens, group)
            del cache
        result = ("ok", out)
    except Exception:  # noqa: BLE001 - reported to the parent
        result = ("error", traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    os._exit(0)  # the gloo group of a failed peer may not tear down


def spawn_tp_ranks(fault=None) -> list:
    """Run tp_rank_main in TP processes (spawned, a FileStore under the
    package's build/ directory), each joined under TP_JOIN_S and killed
    past it; returns each rank's results or raises with the failures."""
    import multiprocessing as mp
    import pickle

    tmp = Path(tempfile.mkdtemp(prefix="tp-", dir=_build.BUILD_DIR))
    ctx = mp.get_context("spawn")
    outs = [tmp / f"rank{r}.pkl" for r in range(TP)]
    procs = [ctx.Process(target=tp_rank_main, args=(r, str(tmp / "store"), str(outs[r]), fault))
             for r in range(TP)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TP_JOIN_S
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results, failures = [], []
    for r, path in enumerate(outs):
        if not path.exists():
            failures.append(f"rank {r}: no result (exit code {procs[r].exitcode})")
            continue
        kind, value = pickle.loads(path.read_bytes())
        if kind == "error":
            failures.append(f"rank {r}: {value}")
        results.append(value)
    for path in tmp.iterdir():
        path.unlink()
    tmp.rmdir()
    if hung or failures:
        raise AssertionError(f"phase 19a: ranks hung {hung}; " + "; ".join(failures)[-4000:])
    return results


class _Served:
    def __init__(self, generated):
        self.generated = generated


def tp_check(params, cfg, params32, cfg32, deltas: dict, fault=None) -> dict:
    """Phase 19a: the tp = 2 pod in two processes against a tp = 1 pod and
    the f32 truth on the same weights. Returns the readings, with
    `failures` listing every bar that failed."""
    card = card_line()
    failures = []
    # The parent's side first, so the ranks' timings have the card alone.
    truth = {"prefill": tp_prefill_logits(cfg32, params32, plain=True)}
    plain = {"prefill": tp_prefill_logits(cfg, params, plain=True)}
    decode_truth, decode_plain = {}, {}
    for fmt, int8, _ in TP_RUNS:
        cache, tables, lens, toks = tp_decode_inputs(cfg, int8)
        page_ids = torch.gather(tables, 1, (lens // PAGE).long()[:, None])[:, 0]
        cache32 = tuple(p.float() if p.dtype == torch.bfloat16 else p.clone() for p in cache)
        _, t = llama._decode_once(cfg32, params32, cache32, toks, tables, lens, page_ids,
                                  lens % PAGE, plain=True)
        del cache32
        _, p = llama._decode_once(cfg, params, cache, toks, tables, lens, page_ids,
                                  lens % PAGE, plain=True)
        decode_truth[fmt], decode_plain[fmt] = t.float(), p.float()
        if not int8:
            single_tick = decode_tick_ms(cfg, params, *tp_decode_inputs(cfg, False))
        del cache
    single = {fmt: tp_serve(params, cfg, int8, steps) for fmt, int8, steps in TP_RUNS}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn_tp_ranks(fault)
    ranks_s = time.perf_counter() - t0

    out = dict(card=card, ranks_s=ranks_s, runs={}, logits={})
    n_kv = cfg.n_kv_heads // TP
    traffic = tp_traffic(cfg.vocab_size)
    for fmt, int8, steps in TP_RUNS:
        r0, r1 = (r["runs"][fmt] for r in ranks)
        ref = single[fmt]
        # (i) rank 0 publishes the tp = 1 pod's prompt-page stream, rank 1 nothing.
        # Every event is a prompt page's: 16 new tokens after a 96-page prompt
        # never complete a page, so the whole streams are compared.
        if r0["events"] != ref["events"]:
            failures.append(f"{fmt}: rank 0's events differ from the tp = 1 pod's "
                            f"({len(r0['events'])} vs {len(ref['events'])})")
        if r1["events"]:
            failures.append(f"{fmt}: rank 1 published {len(r1['events'])} events")
        # (ii) the prefix hit.
        if r0["cached"][0] != 0 or any(c != 1024 for c in r0["cached"][1:]):
            failures.append(f"{fmt}: cached tokens {r0['cached']}")
        # (iv) every served token inside the teacher-forced bar.
        bar = teacher_forced_bar(params32, cfg32, traffic, [_Served(g) for g in r0["tokens"]],
                                 deltas[fmt])
        if not bar["ok"]:
            failures.append(f"{fmt}: teacher-forced bar {bar}")
        # (v) head shards, and the same tables (and tokens) on both ranks every tick.
        for rank, r in enumerate((r0, r1)):
            if any(shape[1] != n_kv for shape in r["heads"]):
                failures.append(f"{fmt}: rank {rank}'s pages {r['heads']}")
        if r0["tables"] != r1["tables"] or r0["tokens"] != r1["tokens"]:
            failures.append(f"{fmt}: the ranks' block tables or tokens differ")
        if r0["launches"] != r1["launches"]:
            failures.append(f"{fmt}: launches differ between ranks: {r0['launches']} "
                            f"{r1['launches']}")
        agree = sum(a == b for a, b in zip(r0["tokens"], ref["tokens"]))
        out["runs"][fmt] = dict(
            decode_steps=steps, cached=r0["cached"], events=len(r0["events"]), bar=bar,
            launches=r0["launches"], ticks=len(r0["tick_ms"]),
            tick_ms_median=statistics.median(r0["tick_ms"]), wall_s=r0["wall_s"],
            tp1_wall_s=ref["wall_s"], tp1_tick_ms_median=statistics.median(ref["tick_ms"]),
            requests_equal_to_tp1=agree)
        log(f"  19a {fmt} pages, decode_steps {steps} ({card}): {len(r0['events'])} events from "
            f"rank 0 (tp = 1: {len(ref['events'])}), {len(r1['events'])} from rank 1; cached "
            f"{r0['cached']}; teacher-forced worst {bar['worst']['greedy']:.4f} (delta "
            f"{deltas[fmt]:.4f}); {agree}/10 requests' tokens equal the tp = 1 pod's; "
            f"{len(r0['tick_ms'])} ticks, median {statistics.median(r0['tick_ms']):.1f} ms "
            f"(tp = 1: {statistics.median(ref['tick_ms']):.1f} ms); wall {r0['wall_s']:.2f} s "
            f"(tp = 1: {ref['wall_s']:.2f} s); launches {r0['launches']}")
    # (iii) logits against the f32 truth, each rank.
    checks = [("prefill", "prefill", r["prefill_logits"], rank) for rank, r in enumerate(ranks)]
    checks += [(f"decode {fmt}", fmt, r["decode_logits"][fmt], rank)
               for rank, r in enumerate(ranks) for fmt, _, _ in TP_RUNS]
    for name, key, got, rank in checks:
        want = truth[key] if key == "prefill" else decode_truth[key]
        base = plain[key] if key == "prefill" else decode_plain[key]
        got = got.to(want.device)
        err = float((got - want).abs().max())
        err_plain = float((base - want).abs().max())
        tol = 2 * err_plain + 1e-2
        ok = bool(torch.isfinite(got).all()) and got.shape == want.shape and err <= tol
        out["logits"][f"{name} rank {rank}"] = dict(err=err, err_plain=err_plain, tol=tol, ok=ok)
        log(f"  19a {name} logits, rank {rank}: vs f32 truth {err:.4e}, bf16 plain path "
            f"{err_plain:.4e} (tol {tol:.4e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} logits on rank {rank}: {err:.4e} > {tol:.4e}")
    tick = ranks[0]["tick"]
    out.update(tick_tp1_ms=single_tick["wall_ms"], tick_tp2_ms=tick["wall_ms"],
               collective_share=tick["collective_share"], collectives=tick["collectives"],
               collective_ms=tick["collective_ms"],
               launches={name: sum(r["launches"][name] for r in out["runs"].values())
                         for name in KERNELS})
    log(f"  19a decode tick, batch 8 x 2,048 ({card}): tp = 1 {single_tick['wall_ms']:.2f} ms, "
        f"tp = 2 {tick['wall_ms']:.2f} ms; with each collective timed between syncs "
        f"{tick['timed_tick_ms']:.2f} ms, of it {tick['collective_ms']:.2f} ms in "
        f"{tick['collectives']} collectives ({100 * tick['collective_share']:.1f}%); the ranks "
        f"took {ranks_s:.1f} s from spawn to join")
    out["failures"] = failures
    return out


def phase_tp(params, cfg, deltas=None) -> dict:
    log(f"== phase 19a: a tp = {TP} flagship pod, two processes on one card over gloo "
        "(10 requests of 1,024 shared + 512 unique tokens, 16 greedy tokens; bf16 pages at "
        "decode_steps 1, int8 pages at 4)")
    t0 = time.perf_counter()
    params32, cfg32 = f32_twin(params, cfg)
    if deltas is None:
        deltas = {fmt: teacher_forced_delta(params, cfg, params32, cfg32, int8)[0]
                  for fmt, int8 in (("bf16", False), ("int8", True))}
    out = tp_check(params, cfg, params32, cfg32, deltas)
    del params32
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"  19a took {out['phase_s']:.1f} s")
    if out["failures"]:
        raise AssertionError(f"phase 19a: {out['failures']}")
    return out


def train_batch(vocab: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(19)
    return torch.randint(0, vocab, TRAIN_BATCH, generator=gen, device="cuda", dtype=torch.int32)


def grad_errors(grads, grads32) -> dict:
    """Relative norm error of each tensor's gradient (each layer's slice of
    a stacked weight) against the f32 twin's."""
    out = {}
    for (path, g), (_, g32) in zip(llama._leaves(grads), llama._leaves(grads32)):
        name = "/".join(path)
        slices = [(name, g, g32)] if path[0] != "layers" else [
            (f"{name}[{i}]", g[i], g32[i]) for i in range(g.shape[0])]
        for label, a, b in slices:
            out[label] = float((a.float() - b).norm() / b.norm().clamp_min(1e-30))
    return out


def plain_grads(cfg, params, tokens) -> tuple:
    """The truth's (loss, gradient tree): plain autograd over the dense
    forward, apart from the train step's own gradient code."""
    paths, leaves = zip(*llama._leaves(params))
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        logits = llama.dense_core(cfg, llama._rebuild(params, dict(zip(paths, live))), tokens)
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].float().reshape(-1, logits.shape[-1]),
            tokens[:, 1:].long().reshape(-1))
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), llama._rebuild(params, dict(zip(paths, grads)))


def train_check(params, cfg, params32, cfg32) -> dict:
    """Phase 19b's readings and failures: the step-0 loss and every gradient
    against the f32 twin's, then TRAIN_STEPS SGD steps, timed."""
    card = card_line()
    tokens = train_batch(cfg.vocab_size)
    loss, grads = llama.loss_and_grads(lambda p: llama.loss_fn(cfg, p, tokens), params)
    loss32, grads32 = plain_grads(cfg32, params32, tokens)
    errs = grad_errors(grads, grads32)
    del grads, grads32
    torch.cuda.empty_cache()
    worst = max(errs, key=errs.get)
    loss_rel = abs(float(loss) - float(loss32)) / abs(float(loss32))
    failures = []
    if not loss_rel <= TRAIN_LOSS_REL:
        failures.append(f"step-0 loss {float(loss):.5f} vs f32 {float(loss32):.5f}")
    if not errs[worst] <= TRAIN_GRAD_REL:
        failures.append(f"gradient of {worst}: relative error {errs[worst]:.4e} > "
                        f"{TRAIN_GRAD_REL:.4e}")
    p, losses, step_ms = params, [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, step_loss = llama.train_step(cfg, p, tokens, lr=TRAIN_LR)
        losses.append(float(step_loss))  # the read back ends the step
        step_ms.append((time.perf_counter() - t) * 1e3)
    del p
    if not losses[-1] < losses[0]:
        failures.append(f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    n_tokens = TRAIN_BATCH[0] * TRAIN_BATCH[1]
    ms = statistics.median(step_ms)
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    log(f"  19b ({card}): step-0 loss {float(loss):.5f}, f32 twin {float(loss32):.5f} "
        f"(relative {loss_rel:.3e}, bar {TRAIN_LOSS_REL}); gradients of {len(errs)} tensors, "
        f"relative norm error max {errs[worst]:.4e} ({worst}), median "
        f"{statistics.median(errs.values()):.4e}; largest {top}; bar {TRAIN_GRAD_REL}")
    log(f"  19b losses over {TRAIN_STEPS} steps at lr {TRAIN_LR}: {losses}; step wall ms "
        f"{' '.join(f'{t:.1f}' for t in step_ms)} (median {ms:.1f} ms, "
        f"{n_tokens / ms * 1e3:.0f} tokens/s)")
    return dict(card=card, loss=float(loss), loss32=float(loss32), loss_rel=loss_rel,
                grad_rel_max=errs[worst], grad_rel_worst=worst,
                grad_rel_median=statistics.median(errs.values()), grad_bar=TRAIN_GRAD_REL,
                losses=losses, step_ms=step_ms, tokens_per_s=n_tokens / ms * 1e3,
                failures=failures)


def phase_train(params, cfg) -> dict:
    log(f"== phase 19b: the SGD train step on the flagship at full width (bf16 params, batch "
        f"{TRAIN_BATCH[0]} x {TRAIN_BATCH[1]} tokens) against an f32 twin")
    t0 = time.perf_counter()
    params32, cfg32 = f32_twin(params, cfg)
    out = train_check(params, cfg, params32, cfg32)
    del params32
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"  19b took {out['phase_s']:.1f} s")
    if out["failures"]:
        raise AssertionError(f"phase 19b: {out['failures']}")
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=None,
                        help="comma-separated phases to run after the build (3 4 5 5b 5c 6 7a "
                        "7b 8a 8 9a 9b 10a 10b 11a 11b 12a 12b 13 14a 14b 15a 15b 16a 16b "
                        "16c 17a 17b 17c 17d 18a 19a 19b; 9b and "
                        "10b run 7b's deltas first, 14a and 15b run 12a first); a partial run "
                        "prints no "
                        "kernels or ok line")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of phases 12 and 14's events, prompts and traffic")
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
        return partial_run(args.phases.split(","), gen, cfg, args.seed)
    errs = phase_kernel_checks(gen)
    (times, decode_times, prefill_serving, verify_time, mixtral_times, qwen_times,
     tp_rank_times) = phase_times(gen)

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
    control = phase_control_plane(args.seed)
    native = phase_native_control_plane(args.seed, control)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    fleet = phase_fleet(params, cfg, args.seed)
    read_plane = phase_read_plane(params, cfg, args.seed)
    resilience = phase_resilience(params, cfg, args.seed)
    proactive = {"sharegpt": phase_sharegpt(params, cfg),
                 "placement": phase_placement(params, cfg, FULL_RUN_PROACTIVE_ARMS),
                 "prediction": phase_prediction(params, cfg, FULL_RUN_PROACTIVE_ARMS)}
    log(f"  the whole run's cut (for phase 18a): 16b and 16c ran their arms "
        f"{FULL_RUN_PROACTIVE_ARMS}; the observe-only arm runs in --phases 16b / 16c")
    federation = phase_geo(params, cfg)
    chaos = phase_chaos(params, cfg)
    tp = phase_tp(params, cfg, deltas)
    train = phase_train(params, cfg)
    del params
    torch.cuda.empty_cache()
    governor = phase_governor(args.seed, control)
    qwen = phase_qwen()

    # Rows 1, 2 and 5 are counted on the serving path (phase 5), on the
    # scheduler's path (phase 7b's recorded runs, summed), on the host
    # tier's (phase 8b-8d), on multi-LoRA's (phase 9b), on speculative
    # decoding's (phase 10b's scheduler runs) and on the MoE family's
    # (phase 11b's scheduler runs) and on the fleet's (phase 12b's four pods,
    # both policies; bf16 pages only) and on the Qwen2 family's (phase 13a's
    # pods and 13c's scheduler runs, both models) and on the read plane's
    # (phase 14b's four pods, its three runs; bf16 pages); rows 1 and 5 also on
    # the fleet's resilience plane (phase 15a's pods, its three arms); rows 3 and 4 (the tiled
    # decode entry) on phase 6's, phase 11b's and phase 13b's tiled decode
    # steps.
    runs = [sched[f"{fmt} steps{steps}"] for fmt, _, steps in FLAGSHIP_RUNS]
    by_path = {name: {"serving": serving["launches"][name],
                      "scheduler": sum(r["launches"][name] for r in runs),
                      "host_tier": tier["launches"][name],
                      "lora": lora_flagship["launches"][name],
                      "speculative": spec["launches"][name],
                      "moe": moe["launches"][name],
                      "fleet": fleet["launches"][name],
                      "qwen": qwen["launches"][name],
                      "read_plane": read_plane["launches"][name]}
               for name in ("paged_decode", "paged_decode_int8", "flash_prefill")}
    for name in ("paged_decode", "flash_prefill"):  # phase 15a's bf16 pods: rows 1 and 5
        by_path[name]["fleet_health"] = resilience["launches"][name]
        # Phase 16's bf16 pods, rows 1 and 5: 16a-16c, each counted from 0.
        by_path[name]["sharegpt"] = sum(p["launches"][name] for p in proactive.values())
        # Phase 17's: 17a's replicated arm (16a's precise arm, inside the
        # count above), 17b's two regions, 17d's two autopilot arms.
        by_path[name]["cluster"] = proactive["sharegpt"]["arms"]["precise"]["cluster"][
            "launches"][name]
        # Phase 18a's: the service routes 16a's precise arm (inside the
        # sharegpt count, as the cluster's).
        by_path[name]["service"] = proactive["sharegpt"]["arms"]["precise"]["service"][
            "launches"][name]
        by_path[name]["federation"] = federation["launches"][name]
        by_path[name]["autopilot"] = resilience["autopilot"]["launches"][name]
    for name in ("paged_decode", "paged_decode_int8", "flash_prefill"):  # 17c, both formats
        by_path[name]["transfer_chaos"] = chaos["launches"][name]
        # Phase 19a's tp pod: rank 0's launches over its bf16 and int8 runs
        # (rank 1 launches as many on its own head shard).
        by_path[name]["tp"] = tp["launches"][name]
    for row in ("paged_decode_tiled", "paged_decode_tiled_int8"):
        by_path[row] = {"batched_decode": batched["checks"][row]["launches"],
                        "moe_batched_decode": moe["logits"][row]["launches"],
                        "qwen_batched_decode": qwen["launches"][row]}
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
                    "control_plane": control, "native_control_plane": native,
                    "fleet": fleet, "read_plane": read_plane, "resilience": resilience,
                    "governor": governor, "proactive": proactive, "federation": federation,
                    "transfer_chaos": chaos,
                    "qwen_attention_shapes": qwen_times, "qwen": qwen,
                    "tp_rank_attention_shape": tp_rank_times, "tp": tp, "train": train,
                    "build_s": build_s, "run_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def partial_run(phases, gen, cfg, seed: int = 0) -> int:
    """A development run of some phases (no kernels or ok line); exits 0
    when each of them passes."""
    t_start = time.perf_counter()
    out = {}
    if "3" in phases:
        out["kernel_errs"] = phase_kernel_checks(gen)
    if "4" in phases:
        out["times"] = phase_times(gen)
    params = None
    if ("14a" in phases or "15b" in phases) and "12a" not in phases:
        phases = ["12a", *phases]  # 14a holds its scores to 12a's index, 15b governs it
    if any(p not in ("3", "4", "5b", "7a", "8a", "9a", "10a", "11a", "11b", "12a", "13", "14a",
                     "15b") for p in phases):
        params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    steps = {
        "5": lambda: phase_serving(params, cfg), "5b": phase_small_pod_vs_cpu,
        "5c": lambda: phase_prefill_logits(params, cfg),
        "6": lambda: phase_batched_decode(params, cfg), "7a": phase_scheduler_small,
        "7b": lambda: phase_scheduler_flagship(params, cfg), "8a": phase_host_tier_small,
        "8": lambda: phase_host_tier_flagship(params, cfg), "9a": phase_lora_small,
        "10a": phase_spec_small, "11a": phase_moe_small,
        "12a": lambda: phase_control_plane(seed), "12b": lambda: phase_fleet(params, cfg, seed),
        "14a": lambda: phase_native_control_plane(seed, out["12a"]),
        "14b": lambda: phase_read_plane(params, cfg, seed),
        "15a": lambda: phase_resilience(params, cfg, seed),
        "16a": lambda: phase_sharegpt(params, cfg),
        "16b": lambda: phase_placement(params, cfg),
        "16c": lambda: phase_prediction(params, cfg),
        "17a": lambda: phase_cluster(params, cfg),
        "17b": lambda: phase_geo(params, cfg),
        "17c": lambda: phase_chaos(params, cfg),
        "17d": lambda: phase_autopilot(params, cfg, seed),
        "18a": lambda: phase_service(params, cfg),
        "19a": lambda: phase_tp(params, cfg),
        "19b": lambda: phase_train(params, cfg),
        "15b": lambda: phase_governor(seed, out["12a"]),
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
    if "11b" in phases or "13" in phases:
        del params
        torch.cuda.empty_cache()
    if "11b" in phases:
        out["11b"] = phase_moe_flagship()
    if "13" in phases:
        out["13"] = phase_qwen()
    out.get("12a", {}).pop("readings", None)
    out.get("12a", {}).pop("digested", None)
    log(json.dumps(out, default=str))
    log(f"partial run of phases {phases}: {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
