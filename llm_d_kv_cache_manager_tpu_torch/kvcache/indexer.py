"""Indexer orchestrator: the read path.

Copy of the reference package's `kvcache/indexer.py`. `get_pod_scores`
runs the four-stage read path:

  1. tokenize the prompt (chat-template render → prefix-store shortcut →
     full tokenization) via the tokenization pool,
  2. convert tokens to chained KV-block keys (ChunkedTokenDatabase, with
     the chain memo),
  3. look the keys up in the KV-block index (which pods hold which blocks),
  4. score pods by weighted longest consecutive cached prefix.

The write plane (kvevents.pool.EventPool) is constructed separately and
shares this Indexer's `kv_block_index` and token processor — index sharing
is the only read/write coupling. The optional fleet-health, popularity,
routing-policy, prediction and anti-entropy objects are duck-typed, as in
the reference. Over the native index (kvblock/native_index.py) a
`score_many` batch runs as one fused crossing (`_native_score_plan`). The
reference's trace spans are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.kvcache.backend import (
    KVCacheBackendConfig,
    default_kv_cache_backend_configs,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index, IndexConfig, new_index
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.scorer import (
    KVBlockScorerConfig,
    new_kv_block_scorer,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.pool import (
    PoolOverloadedError,
    TokenizationPool,
    TokenizersPoolConfig,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.indexer import (
    PrefixStoreConfig,
    new_prefix_store,
)
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("kvcache.indexer")


@dataclass
class IndexerConfig:
    prefix_store_config: PrefixStoreConfig = field(default_factory=PrefixStoreConfig)
    token_processor_config: TokenProcessorConfig = field(
        default_factory=TokenProcessorConfig
    )
    kv_block_index_config: IndexConfig = field(default_factory=IndexConfig.default)
    scorer_config: KVBlockScorerConfig = field(default_factory=KVBlockScorerConfig)
    tokenizers_pool_config: TokenizersPoolConfig = field(
        default_factory=TokenizersPoolConfig
    )
    backend_configs: List[KVCacheBackendConfig] = field(
        default_factory=default_kv_cache_backend_configs
    )


@dataclass
class ScoreRequest:
    """One item of a `score_many` batch — the same argument set
    `get_pod_scores_ex` takes, carried as data so a router can hand the
    whole arrival window over in one call."""

    prompt: str
    model_name: str
    pod_identifiers: Sequence[str] = ()
    render_request: Optional[object] = None
    lora_id: Optional[object] = None


@dataclass
class PodScores:
    """Read-path result carrying the routing signal AND the transfer-plane
    signal. `scores` is what `get_pod_scores` always returned (post
    fleet-health filtering). `match_blocks` is each pod's matched-prefix
    length in blocks (pre-filter — a demoted pod's cache state is still
    real), and `block_hashes` is the prompt's chain in order, so the exact
    set of blocks any pod will MISS is `block_hashes[match_blocks[pod]:]` —
    known at routing time, and the input the route-driven prefetcher feeds
    the chosen pod before the engine faults on it."""

    scores: Dict[str, float] = field(default_factory=dict)
    match_blocks: Dict[str, int] = field(default_factory=dict)
    block_hashes: List[int] = field(default_factory=list)

    def missing_tail(self, pod_identifier: str) -> List[int]:
        """Chain hashes the pod does not hold as a leading prefix — what a
        router should hand the pod's prefetch queue when choosing it."""
        return self.block_hashes[self.match_blocks.get(pod_identifier, 0):]


class Indexer:
    """KV-cache-aware pod scorer over a fleet of serving pods."""

    def __init__(
        self,
        config: Optional[IndexerConfig] = None,
        tokenization_pool: Optional[TokenizationPool] = None,
        kv_block_index: Optional[Index] = None,
        chat_templating=None,
        fleet_health=None,
        popularity=None,
        routing_policy=None,
        prediction=None,
        antientropy=None,
    ):
        self.config = config or IndexerConfig()
        # Optional fleethealth.FleetHealthTracker: when wired, scores pass
        # through `filter_scores` — suspect pods demoted, stale pods
        # excluded (and their entries bulk-purged on detection). A healthy
        # fleet passes through untouched, so enabling the subsystem is
        # bit-identical on the no-fault path.
        self.fleet_health = fleet_health
        # Optional kvcache.routing.RoutingPolicy: the saturation-regime
        # load blend, applied AFTER fleet-health filtering (health decides
        # what is trustworthy; the policy decides what is affordable). The
        # prefix_only policy — and None, the default — return the scores
        # dict unchanged, pinning the pure-prefix path bit-identical.
        self.routing_policy = routing_policy
        # Optional antientropy.AntiEntropyTracker: truth-weighted score
        # demotion, applied between fleet-health filtering (is the pod's
        # STREAM alive?) and the routing policy (is the pod affordable?):
        # a pod whose advertised-vs-verified accuracy EWMA fell below the
        # distrust threshold has its prefix scores decayed like a suspect
        # pod's, recovering as audits come back clean. A clean (or absent)
        # tracker returns the scores dict unchanged — the SAME object —
        # so attachment is bit-identical on a truthful fleet (pinned by
        # its tests).
        self.antientropy = antientropy
        # Optional placement.ChainPopularityTracker: every scored request
        # reports its chain head + tenant/LoRA extra to the hot-prefix
        # detector (placement/popularity.py). Observation only — scores are
        # bit-identical with the tracker attached, and None (the default)
        # keeps the hot path at one attribute check.
        self.popularity = popularity
        # Optional prediction.SessionTable: every scored request reports
        # its chain + token slice to the session predictor
        # (prediction/sessions.py), which learns per-session next-turn
        # ETAs and continuation prefixes. Observation only — same contract
        # as the popularity seam: scores are bit-identical with a table
        # attached, None costs one attribute check.
        self.prediction = prediction

        self.prefix_store = (
            tokenization_pool.prefix_store
            if tokenization_pool is not None
            else new_prefix_store(self.config.prefix_store_config)
        )
        self.token_processor = ChunkedTokenDatabase(self.config.token_processor_config)
        self.kv_block_index = kv_block_index or new_index(self.config.kv_block_index_config)
        if fleet_health is not None and fleet_health.index is None:
            # Quarantine purges target the same index lookups read.
            fleet_health.bind_index(self.kv_block_index)

        # Scorer tier weights follow the top-level backend configs.
        self.config.scorer_config.backend_configs = self.config.backend_configs
        self.scorer = new_kv_block_scorer(self.config.scorer_config)

        self.tokenizers_pool = tokenization_pool or TokenizationPool(
            self.config.tokenizers_pool_config,
            prefix_store=self.prefix_store,
            chat_templating=chat_templating,
        )

    def run(self) -> None:
        """Start the tokenization workers."""
        self.tokenizers_pool.run()

    def shutdown(self) -> None:
        self.tokenizers_pool.shutdown()

    def get_pod_scores(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers: Sequence[str],
        render_request=None,
        lora_id=None,
    ) -> Dict[str, float]:
        """Score pods by cached-prefix length for `prompt`.

        Empty `pod_identifiers` means all known pods are relevant. Returns
        {pod_identifier: score}; pods without hits are absent. `lora_id`
        scopes the lookup to blocks cached under that adapter.
        """
        return self.get_pod_scores_ex(
            prompt, model_name, pod_identifiers,
            render_request=render_request, lora_id=lora_id,
        ).scores

    def get_pod_scores_ex(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers: Sequence[str],
        render_request=None,
        lora_id=None,
        _explain: Optional[dict] = None,
    ) -> PodScores:
        """`get_pod_scores` plus the transfer-plane signal: per-pod matched
        prefix lengths and the prompt's block-hash chain. The scores dict
        is bit-identical to `get_pod_scores` (same derivation, same scorer
        arithmetic, same fleet-health filtering); the extra fields let the
        router drive the data plane's prefetch queue with the exact blocks
        the chosen pod will miss, instead of discarding what the scorer
        already computed.

        `_explain` (score-explain plumbing — `explain_scores` is the public
        face): when a dict is passed, the intermediate stages deposit their
        evidence into it. Explain therefore runs THIS code path, not a
        parallel reimplementation, which is what makes its scores
        bit-identical by construction."""
        # Same validation as the event-ingest side (kvevents/pool.py): an
        # invalid adapter id degrades to the base keyspace rather than
        # hashing into a keyspace no event can ever populate.
        if not isinstance(lora_id, int) or isinstance(lora_id, bool) or lora_id < 0:
            if lora_id is not None:
                kvlog.trace(logger, "ignoring invalid lora_id %r", lora_id)
            lora_id = None

        try:
            tokenized = self.tokenizers_pool.tokenize_ex(
                render_request, prompt, model_name
            )
        except PoolOverloadedError:
            # Degrade, don't fail: an empty score map routes the request by
            # the caller's fallback strategy, which beats queueing the read
            # path without bound behind a saturated tokenizer.
            logger.warning(
                "tokenization pool overloaded; returning empty scores for model %s",
                model_name,
            )
            if _explain is not None:
                _explain["degraded"] = "tokenization_overloaded"
            return PodScores()

        # The pool's prefix-store boundary state rides along so the chain
        # memo can resume key derivation at the first novel block of a
        # follow-up turn — same keys, none of the re-hashing.
        block_keys = self.token_processor.tokens_to_kv_block_keys(
            None, tokenized.tokens, model_name, lora_id=lora_id,
            prefix_state=tokenized.prefix_state,
        )
        if _explain is not None:
            memo = self.token_processor.chain_memo
            _explain["tokens"] = len(tokenized.tokens)
            _explain["blocks"] = len(block_keys)
            _explain["lora_id"] = lora_id
            _explain["chain_memo"] = (
                {"family": memo.last_family(), "stats": memo.stats()}
                if memo is not None
                else None
            )
        if not block_keys:
            kvlog.trace(logger, "no block keys for prompt, returning empty scores")
            if _explain is not None:
                _explain.setdefault("degraded", "no_block_keys")
            return PodScores()

        if self.popularity is not None:
            # Hot-prefix detection (placement/): the chain head + tenant
            # extra this request routed under, plus the leading token slice
            # a replication warm-up would need. Pure observation — nothing
            # below reads the tracker.
            self.popularity.observe_route(
                [k.chunk_hash for k in block_keys],
                tokens=tokenized.tokens,
                lora_id=lora_id,
                model_name=model_name,
                block_size=self.token_processor.block_size,
            )
        if self.prediction is not None:
            # Session prediction (prediction/): continuation detection +
            # think-time learning over the same chain the scorer is about
            # to walk. Pure observation — nothing below reads the table.
            self.prediction.observe_route(
                [k.chunk_hash for k in block_keys],
                tokens=tokenized.tokens,
                lora_id=lora_id,
                model_name=model_name,
                block_size=self.token_processor.block_size,
            )

        key_to_pods = self.kv_block_index.lookup(
            block_keys, set(pod_identifiers)
        )
        scores, match_blocks = self.scorer.score_ex(block_keys, key_to_pods)
        if _explain is not None:
            _explain["raw_scores"] = dict(scores)
        if self.fleet_health is not None:
            # Degraded-mode scoring: suspect pods demoted, stale pods
            # excluded. An emptied map is the explicit no-cache-signal
            # answer — the caller's load/round-robin fallback takes over
            # instead of routing to phantom placements.
            scores = self.fleet_health.filter_scores(scores)
        if self.antientropy is not None:
            scores = self.antientropy.adjust_scores(scores)
        if self.routing_policy is not None:
            scores = self.routing_policy.adjust(scores, _explain=_explain)
        kvlog.trace(logger, "pod scores: %s", scores)
        return PodScores(
            scores=scores,
            match_blocks=match_blocks,
            block_hashes=[k.chunk_hash for k in block_keys],
        )

    def score_many(self, requests: Sequence[ScoreRequest]) -> List[PodScores]:
        """Bulk read path: score a router batch in one call, amortizing
        every stage across the batch — the tokenization pool chews all
        items in parallel (batch latency is max-of-items, not
        sum-of-items), derivation dedupes shared prefixes through one
        chain-memo probe and at most two batched hash calls, the index
        crosses each lock once per batch (`Index.lookup_many`), and the
        scorer reuses per-block weight maps across items sharing a prefix.

        Results are BIT-IDENTICAL to `[get_pod_scores_ex(r) for r in
        requests]` over the same state. Degradation is per
        ITEM: a request shed by a saturated tokenization pool returns an
        empty `PodScores` in its slot while the rest of the batch scores
        normally (the single-call overload contract, item-scoped)."""
        if not requests:
            return []
        n = len(requests)
        results: List[Optional[PodScores]] = [None] * n

        # Same per-item adapter-id validation as the single-call path.
        loras: List[Optional[int]] = []
        for r in requests:
            lora_id = r.lora_id
            if (
                not isinstance(lora_id, int) or isinstance(lora_id, bool)
                or lora_id < 0
            ):
                if lora_id is not None:
                    kvlog.trace(logger, "ignoring invalid lora_id %r", lora_id)
                lora_id = None
            loras.append(lora_id)

        tokenized = self.tokenizers_pool.tokenize_many(
            [(r.render_request, r.prompt, r.model_name) for r in requests]
        )
        live: List[int] = []
        shed = 0
        for i, t in enumerate(tokenized):
            if isinstance(t, PoolOverloadedError):
                # Per-item degradation: one shed item never degrades the
                # batch — its slot carries the explicit no-signal answer.
                results[i] = PodScores()
                shed += 1
            else:
                live.append(i)
        if shed:
            logger.warning(
                "tokenization pool overloaded; %d/%d batch item(s) "
                "degraded to empty scores", shed, n,
            )

        keys_per_item = self.token_processor.tokens_to_kv_block_keys_many([
            (
                tokenized[i].tokens, requests[i].model_name, loras[i],
                tokenized[i].prefix_state,
            )
            for i in live
        ])

        # Relevant-pod sets are built ONCE per distinct pod list and reused
        # across the batch (the single-call path rebuilds per call).
        #
        # Prefix-sharing plan: items whose chains share their FIRST key
        # OBJECT under the same pod filter share a leading prefix — the
        # chain memo hands requests over a common system prefix the same
        # Key objects, so a zip-`is` scan finds the shared span at pointer
        # speed. The first such item becomes the bucket's reference and is
        # looked up (and walked by the scorer) in full; every later member
        # looks up only its TAIL past the shared span and forks the
        # reference's walk state at the divergence point
        # (`scorer.score_plan`). Bit-identity: the shared span contributes
        # the exact same entry lists and float additions either way —
        # sharing only moves who performs the walk. Cold chains (distinct
        # objects for equal hashes) simply never match: correct, just
        # unamortized.
        pod_sets: dict = {}
        buckets: dict = {}          # (id(pod_set), id(keys[0])) -> plan pos
        plan_specs: List[dict] = []  # one per scored item, plan order
        lookup_reqs: List[tuple] = []
        for pos, i in enumerate(live):
            block_keys = keys_per_item[pos]
            if not block_keys:
                kvlog.trace(
                    logger, "no block keys for batch item, empty scores"
                )
                results[i] = PodScores()
                continue
            if self.popularity is not None:
                tp = tokenized[i]
                self.popularity.observe_route(
                    [k.chunk_hash for k in block_keys],
                    tokens=tp.tokens,
                    lora_id=loras[i],
                    model_name=requests[i].model_name,
                    block_size=self.token_processor.block_size,
                )
            if self.prediction is not None:
                self.prediction.observe_route(
                    [k.chunk_hash for k in block_keys],
                    tokens=tokenized[i].tokens,
                    lora_id=loras[i],
                    model_name=requests[i].model_name,
                    block_size=self.token_processor.block_size,
                )
            pods = tuple(requests[i].pod_identifiers)
            pod_set = pod_sets.get(pods)
            if pod_set is None:
                pod_set = pod_sets[pods] = set(pods)
            bucket_key = (id(pod_set), id(block_keys[0]))
            ref_pos = buckets.get(bucket_key)
            if ref_pos is None:
                buckets[bucket_key] = len(plan_specs)
                lookup_idx = len(lookup_reqs)
                lookup_reqs.append((block_keys, pod_set))
                plan_specs.append({
                    "item": i, "keys": block_keys, "lookup": lookup_idx,
                    "ref": None, "pods": pods,
                })
            else:
                ref_keys = plan_specs[ref_pos]["keys"]
                shared_blocks = 0
                for a, b in zip(ref_keys, block_keys):
                    if a is not b:
                        break
                    shared_blocks += 1
                tail = block_keys[shared_blocks:]
                lookup_idx = None
                if tail:
                    lookup_idx = len(lookup_reqs)
                    lookup_reqs.append((tail, pod_set))
                plan_specs.append({
                    "item": i, "keys": block_keys, "lookup": lookup_idx,
                    "ref": ref_pos, "shared": shared_blocks, "tail": tail,
                    "pods": pods,
                })
                plan_specs[ref_pos]["forked"] = True

        if plan_specs:
            native_out = self._native_score_plan(plan_specs)
            if native_out is not None:
                for spec, (scores, match_blocks) in zip(plan_specs, native_out):
                    results[spec["item"]] = PodScores(
                        scores=scores,
                        match_blocks=match_blocks,
                        block_hashes=[k.chunk_hash for k in spec["keys"]],
                    )
                return results
            lookup_many = getattr(self.kv_block_index, "lookup_many", None)
            if lookup_many is not None:
                hits = lookup_many(lookup_reqs)
            else:  # duck-typed test doubles without the batch API
                hits = [
                    self.kv_block_index.lookup(keys, pod_set)
                    for keys, pod_set in lookup_reqs
                ]
            plan: List[tuple] = []
            for spec in plan_specs:
                if spec["ref"] is None:
                    plan.append((
                        "solo", spec["keys"], hits[spec["lookup"]],
                        spec.get("forked", False),
                    ))
                else:
                    plan.append((
                        "fork", spec["ref"], spec["shared"], spec["tail"],
                        hits[spec["lookup"]]
                        if spec["lookup"] is not None else {},
                    ))
            scored = self.scorer.score_plan(plan)
            fleet_health = self.fleet_health
            antientropy = self.antientropy
            routing_policy = self.routing_policy
            for spec, (scores, match_blocks) in zip(plan_specs, scored):
                if fleet_health is not None:
                    scores = fleet_health.filter_scores(scores)
                if antientropy is not None:
                    scores = antientropy.adjust_scores(scores)
                if routing_policy is not None:
                    scores = routing_policy.adjust(scores)
                results[spec["item"]] = PodScores(
                    scores=scores,
                    match_blocks=match_blocks,
                    block_hashes=[k.chunk_hash for k in spec["keys"]],
                )
        return results

    def _native_score_plan(self, plan_specs):
        """Fused read path: when the index is the native arena, run the
        whole batch plan — lookup + longest-prefix score + fleet-health /
        anti-entropy / routing adjustments — in one GIL-released crossing.

        Returns the per-spec `(scores, match_blocks)` list, or None when
        the backend isn't native (the ordinary Python path, not a
        fallback) or the crossing failed (counted in
        `native_index.fallback_total()`; the Python path recomputes the
        batch from the same state, so degradation is invisible in the
        scores)."""
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.native_index import (
            NativeScoringIndex,
            count_fallback,
        )

        inner = getattr(self.kv_block_index, "inner", self.kv_block_index)
        if not isinstance(inner, NativeScoringIndex):
            return None
        medium_weights = getattr(self.scorer, "medium_weights", None)
        if medium_weights is None:
            count_fallback()  # custom scorer: parity not provable in C
            return None
        try:
            return inner.score_plan(
                plan_specs,
                medium_weights,
                fleet_health=self.fleet_health,
                antientropy=self.antientropy,
                routing_policy=self.routing_policy,
            )
        except Exception as e:  # noqa: BLE001 - any native failure must
            # degrade to the Python path, never the read path itself.
            count_fallback()
            logger.warning(
                "native scoring crossing failed; batch fell back to the "
                "Python path: %s", e,
            )
            return None

    def score_hashes(
        self,
        model_name: str,
        block_hashes: Sequence[int],
        pod_identifiers: Sequence[str] = (),
    ) -> PodScores:
        """Score pods over an ALREADY-DERIVED chain: the read path's
        lookup/score/fleet-health/routing-policy stages, minus
        tokenization and key derivation (the caller holds the chain —
        e.g. the anticipatory-prefetch scheduler replaying a session's
        observed chain during its idle window).

        By running the exact same stages over the same live state, a
        decision made here can never disagree with what
        `get_pod_scores_ex` would answer for a prompt deriving this
        chain — which is what lets the predictor target "the pod the
        router would pick" instead of a parallel heuristic. Tenant/LoRA
        scoping needs no extra argument: the adapter id is already mixed
        into every chunk hash."""
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key

        if not block_hashes:
            return PodScores()
        block_keys = [Key(model_name, h) for h in block_hashes]
        key_to_pods = self.kv_block_index.lookup(
            block_keys, set(pod_identifiers)
        )
        scores, match_blocks = self.scorer.score_ex(block_keys, key_to_pods)
        if self.fleet_health is not None:
            scores = self.fleet_health.filter_scores(scores)
        if self.antientropy is not None:
            scores = self.antientropy.adjust_scores(scores)
        if self.routing_policy is not None:
            scores = self.routing_policy.adjust(scores)
        return PodScores(
            scores=scores,
            match_blocks=match_blocks,
            block_hashes=list(block_hashes),
        )

    def explain_scores(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers: Sequence[str],
        render_request=None,
        lora_id=None,
    ) -> dict:
        """Score with the decision evidence attached (`/debug/score_explain`).

        Runs the exact `get_pod_scores_ex` pipeline (scores bit-identical to
        `get_pod_scores`) and reports, per
        pod: the raw scorer output, the matched-prefix length in blocks,
        the fleet-health state and the adjustment it caused (suspect pods
        demoted ×suspect_demotion_factor, stale pods excluded), plus which
        chain-memo entry family served the derivation and the chosen pod
        under the deterministic best-score/lexicographic tie-break."""
        detail: dict = {}
        result = self.get_pod_scores_ex(
            prompt, model_name, pod_identifiers,
            render_request=render_request, lora_id=lora_id, _explain=detail,
        )
        raw = detail.pop("raw_scores", {})
        final = result.scores
        pods = {}
        for pod in sorted(raw):
            health = (
                self.fleet_health.state_of(pod)
                if self.fleet_health is not None
                else "healthy"
            )
            raw_score = raw[pod]
            if pod not in final:
                adjustment = "excluded"
            elif final[pod] != raw_score:
                adjustment = "demoted"
            else:
                adjustment = "none"
            pods[pod] = {
                "raw_score": raw_score,
                "score": final.get(pod),
                "match_blocks": result.match_blocks.get(pod, 0),
                "matched_ratio": round(
                    result.match_blocks.get(pod, 0)
                    / max(len(result.block_hashes), 1),
                    4,
                ),
                "health": health,
                "adjustment": adjustment,
            }
        chosen = None
        if final:
            best = max(final.values())
            chosen = min(p for p, s in final.items() if s == best)
        return {
            "model": model_name,
            "prompt_chars": len(prompt),
            "scores": final,
            "chosen": chosen,
            "pods": pods,
            **detail,
        }
