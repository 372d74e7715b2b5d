"""llm-d-kv-cache-manager-tpu, ported to PyTorch and CUDA for NVIDIA Hopper.

The serving path of `llm_d_kv_cache_manager_tpu` (the JAX reference package
beside this one) rebuilt on torch: a paged-KV Llama pod whose decode and
prefill attention run through hand-written CUDA kernels (`csrc/`), a block
manager that emits the same BlockStored/BlockRemoved events, and the slice
of the control plane that digests those events into an index and scores
pods by cached prefix.

Layout mirrors the reference package module for module:
  - kvcache/        token-ID read path (Indexer.get_pod_scores), scorer,
                    kvblock hashing/keys/token processor/in-memory index
  - kvevents/       event schema (msgpack wire form) + synchronous digest
  - engine/         BlockManager + EnginePod (model mode, multi-LoRA) + the
                    continuous-batching Scheduler + speculative decoding
                    (SpeculativeDecoder, SpeculativeScheduler) + the host
                    tier (tiering, costs)
  - models/         paged-KV Llama serving functions (llama.py) and LoRA
                    adapters (lora.py)
  - ops/            paged_attention / flash_prefill wrappers (kernel on CUDA,
                    plain torch version on CPU), the nvcc build step, and
                    sampling (JAX's Threefry noise in torch ops)
  - csrc/           CUDA C++ kernels for sm_90a

This package imports torch and numpy only; it never imports jax or the
reference package. Entry points default to device="cuda" and raise when no
GPU is present; pass device="cpu" to run the plain versions on the CPU.
"""

__version__ = "0.1.0"
