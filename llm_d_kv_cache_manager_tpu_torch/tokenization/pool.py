"""Tokenization worker pool.

Copy of the reference package's `tokenization/pool.py`: N workers (default
5) drain a task queue; each task optionally renders a chat template, then
consults the prefix store — if the
cached-prefix coverage is at least `min_prefix_overlap_ratio` (default 0.8)
the cached tokens are used directly, otherwise the prompt is fully
tokenized and the result is fed back into the prefix store. Two submission
modes: blocking `tokenize` (the read path) and fire-and-forget
`enqueue_tokenization` (cache warming).

The composite tokenizer is assembled from the enabled backends in the order
local → UDS sidecar → HF hub; a caller may inject its own `Tokenizer` instead
(`tokenizer=`). The task queue is bounded. Overload policy: blocking
`tokenize` waits briefly for a slot then raises `PoolOverloadedError` so the
caller can shed or back off; fire-and-forget `enqueue_tokenization` is
dropped and counted (`rejected_tasks`) — cache warming is best-effort.

The reference's trace spans and metrics counters are not ported.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.indexer import (
    PrefixStore,
    PrefixStoreConfig,
    new_prefix_store,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizer import (
    CachedHFTokenizer,
    CachedLocalTokenizer,
    CompositeTokenizer,
    Tokenizer,
)
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("tokenization.pool")

DEFAULT_WORKERS = 5
DEFAULT_MIN_PREFIX_OVERLAP_RATIO = 0.8


class PoolOverloadedError(RuntimeError):
    """The tokenization queue is full; the caller should shed or back off."""


@dataclass
class TokenizersPoolConfig:
    workers: int = DEFAULT_WORKERS
    min_prefix_overlap_ratio: float = DEFAULT_MIN_PREFIX_OVERLAP_RATIO
    # Queue bound; <=0 means unbounded. Blocking submissions wait up to
    # `enqueue_timeout_s` for a slot before raising PoolOverloadedError.
    max_queue_depth: int = 2048
    enqueue_timeout_s: float = 1.0
    enable_local: bool = True
    enable_uds: bool = False
    enable_hf: bool = False
    uds_socket_path: Optional[str] = None
    hf_auth_token: Optional[str] = None
    # Explicit model→tokenizer.json map for the local backend; None = discover
    # from LOCAL_TOKENIZER_DIR.
    local_tokenizer_files: Optional[dict] = None


@dataclass
class TokenizedPrompt:
    """A tokenization result plus its prefix-store boundary state.

    `prefix_state` is the cumulative token-fingerprint chain of the covered
    prefix-store chunks — ((fingerprint, n_tokens), ...) in prompt order,
    () when the backing store doesn't support it (trie) or nothing was
    covered. The chain-state memo (kvcache/kvblock/chain_memo.py) uses it to
    resume block-key derivation at the first novel block; it is advisory
    only and never changes the derived keys.
    """

    tokens: List[int]
    prefix_state: tuple = ()


@dataclass
class _Task:
    render_request: Optional[object]
    prompt: str
    model_name: str
    future: Optional[Future]


class TokenizationPool:
    """Sync/async tokenization over a shared prefix store."""

    def __init__(
        self,
        config: Optional[TokenizersPoolConfig] = None,
        prefix_store: Optional[PrefixStore] = None,
        tokenizer: Optional[Tokenizer] = None,
        chat_templating=None,
    ):
        self.config = config or TokenizersPoolConfig()
        self.prefix_store = prefix_store or new_prefix_store(PrefixStoreConfig())
        self.tokenizer = tokenizer or self._build_composite(chat_templating)
        depth = max(0, self.config.max_queue_depth)
        self._queue: "queue.Queue[Optional[_Task]]" = queue.Queue(maxsize=depth)
        self._workers: List[threading.Thread] = []
        self._started = False
        self._mu = threading.Lock()
        self._rejected = 0
        self._rejected_mu = threading.Lock()

    def _build_composite(self, chat_templating) -> CompositeTokenizer:
        backends: List[Tokenizer] = []
        if self.config.enable_local:
            backends.append(
                CachedLocalTokenizer(
                    tokenizer_files=self.config.local_tokenizer_files,
                    chat_templating=chat_templating,
                )
            )
        if self.config.enable_uds:
            from llm_d_kv_cache_manager_tpu_torch.tokenization.uds_client import UDSTokenizer

            backends.append(UDSTokenizer(self.config.uds_socket_path))
        if self.config.enable_hf:
            backends.append(
                CachedHFTokenizer(
                    auth_token=self.config.hf_auth_token,
                    chat_templating=chat_templating,
                )
            )
        if not backends:
            raise ValueError("no tokenizer backends enabled")
        return CompositeTokenizer(backends)

    # -- lifecycle ---------------------------------------------------------

    def run(self) -> None:
        """Start the worker threads (idempotent)."""
        with self._mu:
            if self._started:
                return
            self._started = True
            for i in range(self.config.workers):
                t = threading.Thread(
                    target=self._worker_loop, name=f"tokenize-worker-{i}", daemon=True
                )
                t.start()
                self._workers.append(t)

    def shutdown(self) -> None:
        with self._mu:
            if not self._started:
                return
            for _ in self._workers:
                self._queue.put(None)
            workers, self._workers = self._workers, []
            self._started = False
        for t in workers:
            t.join(timeout=5.0)

    # -- submission --------------------------------------------------------

    @property
    def rejected_tasks(self) -> int:
        """Submissions refused because the queue was full."""
        with self._rejected_mu:
            return self._rejected

    def _count_rejected(self) -> None:
        with self._rejected_mu:
            self._rejected += 1
            rejected = self._rejected
        if rejected == 1 or rejected % 1000 == 0:
            logger.warning(
                "tokenization pool overloaded: rejected %d task(s) "
                "(queue full at depth %d)",
                rejected, self.config.max_queue_depth,
            )

    def tokenize(
        self, render_request, prompt: str, model_name: str, timeout: Optional[float] = None
    ) -> List[int]:
        """Blocking tokenization (the read path).

        Raises PoolOverloadedError when no queue slot frees up within
        `enqueue_timeout_s`.
        """
        return list(
            self.tokenize_ex(render_request, prompt, model_name, timeout).tokens
        )

    def tokenize_ex(
        self, render_request, prompt: str, model_name: str, timeout: Optional[float] = None
    ) -> TokenizedPrompt:
        """Blocking tokenization returning the prefix state alongside the
        tokens (the Indexer's read path — see TokenizedPrompt). Same
        overload semantics as `tokenize`."""
        if not self._started:
            self.run()
        fut: Future = Future()
        task = _Task(render_request, prompt, model_name, fut)
        try:
            self._queue.put(task, timeout=self.config.enqueue_timeout_s)
        except queue.Full:
            self._count_rejected()
            raise PoolOverloadedError(
                f"tokenization queue full (depth {self.config.max_queue_depth}); "
                "retry with backoff or shed the request"
            ) from None
        return fut.result(timeout=timeout)

    def tokenize_many(
        self, items: Sequence[tuple], timeout: Optional[float] = None
    ) -> List[object]:
        """Batched blocking tokenization (the `score_many` read path).

        `items` is a sequence of `(render_request, prompt, model_name)`
        tuples. EVERY task is enqueued before ANY future is waited on, so
        batch latency is the max of the items' latencies (the workers chew
        the batch in parallel), not their sum.

        Overload degrades per ITEM, never per batch: an item whose enqueue
        finds no queue slot within `enqueue_timeout_s` yields a
        `PoolOverloadedError` INSTANCE in its result slot (counted like any
        rejected submission) while the rest of the batch proceeds. The
        returned list is aligned with `items`: `TokenizedPrompt` on
        success, the error instance when that item was shed. Worker-side
        exceptions (unknown model, tokenizer failure) still raise, exactly
        as N sequential `tokenize_ex` calls would.

        Two batch fast paths on top of the single-call semantics:

        - Warm items resolve INLINE: plain-prompt items run a BATCHED
          prefix-store walk first (`find_longest_with_state_many` — one
          chunk-hash chain per distinct shared byte prefix, not one per
          item); items the store covers at or above
          `min_prefix_overlap_ratio` never touch the queue at all. Tokens
          and prefix state are exactly what the worker path would return.
        - The caller WORK-STEALS while it would otherwise block: after
          enqueueing the remaining (cold / render-template) items, it
          drains still-queued tasks and processes them inline (same
          worker body, futures resolved identically), so a batch chews
          with `workers + 1` threads and a pool whose workers are all
          busy can never stall a batch that already holds queue slots."""
        if not self._started:
            self.run()
        resolved: Dict[int, TokenizedPrompt] = {}
        walk_many = getattr(
            self.prefix_store, "find_longest_with_state_many", None
        )
        if walk_many is not None:
            plain = [
                i for i, (render_request, _, _) in enumerate(items)
                if render_request is None
            ]
            if plain:
                walked = walk_many([items[i][1] for i in plain])
                min_ratio = self.config.min_prefix_overlap_ratio
                for i, (tokens, ratio, state) in zip(plain, walked):
                    if ratio >= min_ratio:
                        resolved[i] = TokenizedPrompt(
                            tokens=tokens, prefix_state=tuple(state)
                        )
        futures: List[Optional[Future]] = []
        for i, (render_request, prompt, model_name) in enumerate(items):
            if i in resolved:
                futures.append(None)
                continue
            fut: Future = Future()
            task = _Task(render_request, prompt, model_name, fut)
            try:
                self._queue.put(task, timeout=self.config.enqueue_timeout_s)
            except queue.Full:
                self._count_rejected()
                futures.append(None)
                continue
            futures.append(fut)
        # Steal: anything still queued (this batch's tasks or an earlier
        # submitter's — either way it's ahead of our last item) runs on
        # THIS thread instead of waiting for a worker.
        while True:
            try:
                task = self._queue.get_nowait()
            except queue.Empty:
                break
            if task is None:
                # Shutdown sentinel: hand it back for a worker to consume.
                self._queue.put(None)
                self._queue.task_done()
                break
            try:
                result = self._process(task)
                if task.future is not None:
                    task.future.set_result(result)
            except Exception as e:  # noqa: BLE001 - deliver errors to waiter
                if task.future is not None:
                    task.future.set_exception(e)
                else:
                    logger.warning("async tokenization task failed: %s", e)
            finally:
                self._queue.task_done()
        results: List[object] = []
        for i, fut in enumerate(futures):
            if fut is None:
                hit = resolved.get(i)
                results.append(hit if hit is not None else PoolOverloadedError(
                    f"tokenization queue full (depth "
                    f"{self.config.max_queue_depth}); item shed from batch"
                ))
            else:
                results.append(fut.result(timeout=timeout))
        return results

    def enqueue_tokenization(self, render_request, prompt: str, model_name: str) -> None:
        """Fire-and-forget tokenization (cache warming). Dropped when full."""
        try:
            self._queue.put_nowait(_Task(render_request, prompt, model_name, None))
        except queue.Full:
            self._count_rejected()

    # -- workers -----------------------------------------------------------

    def drain(self) -> None:
        """Block until every queued task has been processed."""
        self._queue.join()

    def _worker_loop(self) -> None:
        while True:
            task = self._queue.get()
            try:
                if task is None:
                    return
                result = self._process(task)
                if task.future is not None:
                    task.future.set_result(result)
            except Exception as e:  # noqa: BLE001 - deliver errors to waiter
                if task is not None and task.future is not None:
                    task.future.set_exception(e)
                else:
                    logger.warning("async tokenization task failed: %s", e)
            finally:
                self._queue.task_done()

    def _process(self, task: _Task) -> TokenizedPrompt:
        prompt = task.prompt
        if task.render_request is not None:
            prompt = self.tokenizer.render_chat_template(task.render_request)

        # Prefix-store shortcut, with boundary state when the store supports
        # it (LRU store). The trie store only speaks the base contract.
        find_with_state = getattr(
            self.prefix_store, "find_longest_with_state", None
        )
        if find_with_state is not None:
            tokens, ratio, state = find_with_state(prompt)
        else:
            tokens, ratio = self.prefix_store.find_longest_contained_tokens(
                prompt
            )
            state = ()
        if ratio < self.config.min_prefix_overlap_ratio:
            result = self.tokenizer.encode(prompt, task.model_name)
            state = self.prefix_store.add_tokenization(
                prompt, result.tokens, result.offsets
            ) or ()
            tokens = list(result.tokens)
        return TokenizedPrompt(tokens=tokens, prefix_state=tuple(state))
