"""llm-d-kv-cache-manager-tpu, ported to PyTorch and CUDA for NVIDIA Hopper.

The serving path of `llm_d_kv_cache_manager_tpu` (the JAX reference package
beside this one) rebuilt on torch: a paged-KV Llama pod whose decode and
prefill attention run through hand-written CUDA kernels (`csrc/`), a block
manager that emits the same BlockStored/BlockRemoved events, and the
control plane's write path (events over ZMQ into a sharded worker pool and
index) and read path (prompt -> tokens -> block keys -> lookup -> pod
scores).

Layout mirrors the reference package module for module:
  - kvcache/        the Indexer (get_pod_scores, score_many, score_hashes,
                    explain_scores; chat requests through render_request),
                    scorer, the load-blend routing policy, kvblock
                    hashing/keys/chain memo/token processor and the
                    in-memory, sharded, cost-aware, Redis and native
                    (C arena) indexes
  - kvevents/       event schema (msgpack wire form), the sharded
                    EventPool, the ZMQ subscriber and publisher, and a
                    synchronous digest for in-process callers
  - tokenization/   the tokenization pool, tokenizers (local, HF, the UDS
                    sidecar client) and prefix stores
  - preprocessing/  chat-template rendering (jinja2)
  - fleethealth/    per-pod load signals for the routing policy
  - kv_connectors/  the transfer data plane and the route-driven prefetcher
  - utils/          LRU, a msgpack codec, XXH64 and human-size parsing
  - engine/         BlockManager + EnginePod (model mode, multi-LoRA) + the
                    continuous-batching Scheduler + speculative decoding
                    (SpeculativeDecoder, SpeculativeScheduler) + the host
                    tier (tiering, costs)
  - models/         paged-KV Llama serving functions (llama.py) and LoRA
                    adapters (lora.py)
  - ops/            paged_attention / flash_prefill wrappers (kernel on CUDA,
                    plain torch version on CPU), the build step (nvcc for
                    the kernels, the C compilers for the host libraries and
                    the native/ hash core and scoring arena), and sampling
                    (JAX's Threefry noise in torch ops)
  - csrc/           CUDA C++ kernels for sm_90a

This package imports torch and numpy only (pyzmq in the two ZMQ modules,
HF `tokenizers` when a tokenizer loads, jinja2 when a chat template
renders); it never imports jax or the reference package. Entry points default to device="cuda" and raise when no
GPU is present; pass device="cpu" to run the plain versions on the CPU.
"""

__version__ = "0.1.0"
