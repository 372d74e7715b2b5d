"""Chain-state memo: incremental block-key derivation for the read path.

Copy of the reference package's `kvcache/kvblock/chain_memo.py`. Without
it, every GetPodScores call re-CBOR-encodes and re-FNV-chains the WHOLE
prompt prefix from the root hash, even though on a multi-turn workload
(long shared conversation prefixes) almost all of those chain links were
already derived one turn earlier. This module is the hashing half of what
the prefix store (`tokenization/prefixstore`) is for the tokenization
half: amortize shared-prefix work across requests.

The memo caches `(prefix boundary → chain state)` so ChunkedTokenDatabase
resumes hashing at the FIRST NOVEL BLOCK of a follow-up turn instead of
block 0. Entries hold ready-made `Key` tuples (not raw hashes): on a warm
walk the covered prefix costs tuple concatenation, not object
construction. Three entry families share one LRU:

**Request entries.** When the prefix state covers the whole token list
(the pool's warm path always does: it returns exactly the covered-chunk
tokens), the final boundary fingerprint identifies the entire request and
one probe returns the complete key tuple.

**Boundary entries** (the read path). The tokenization prefix store already
walks the prompt's text chunks and returns the cached tokens; each cached
chunk now also carries a fingerprint of its token content, and the pool
folds those into a cumulative `prefix_state`: a tuple of
`(fingerprint, n_tokens)` pairs, one per covered text-chunk boundary
(tokenization/prefixstore/lru_store.py). Because the fingerprint chain is a
pure function of the exact token lists the pool RETURNS, a boundary entry
can never go stale: if the prefix store re-tokenizes (or evicts and
relearns) a chunk differently, the fingerprints change and the memo simply
misses — cold recomputation, never wrong keys. A warm multi-turn lookup
does NO per-token work at all for the covered prefix: one batched LRU get
over ~dozens of boundary keys, then tuple concatenation.

**Segment entries** (everything else: the kvevents write plane, direct
callers without a prompt). Tokens are fingerprinted in fixed segments of
`segment_blocks` blocks (`hashing.token_fingerprints`, a plain-Python
fold: the port has no C hash core yet) and each segment's derived keys
are cached under the running fingerprint. An engine fleet re-storing the
same chains (N pods × same prompt prefix) derives them once.

Correctness model: fingerprints are 64-bit cache keys, not security
hashes. An accidental collision would serve a wrong chain state — the same
accepted risk class as the prefix store's xxhash64 chunk keys
(a collision there serves wrong TOKENS). All entry families key their
chains off a derivation identity that folds in the model name, the hash
algorithm, the root/parent hash (hence the hash seed), the block size, and
the LoRA extra-key tuple — extra keys change every block hash, so memo
entries for different adapters can never alias.

Eviction: one LRU (utils/lru.py), same lifecycle discipline as the
tokenization prefix cache it rides alongside; an evicted entry only ever
costs recomputation. Thread-safe: the LRU locks internally and entries are
immutable tuples, so concurrent read-path and write-plane derivations
compose; duplicate inserts are idempotent.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import hashing
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key
from llm_d_kv_cache_manager_tpu_torch.utils.lru import LRUCache

# `prefix_state` as produced by the tokenization pool: ((fp, n_tokens), ...)
# per covered text-chunk boundary, in prompt order. `fp` chains over the
# per-chunk token fingerprints; `n_tokens` is the cumulative token count.
PrefixState = Tuple[Tuple[int, int], ...]

_M64 = 0xFFFFFFFFFFFFFFFF
_PRIME = 0x100000001B3

# Distinct fold bases keep the entry families (and anything a later PR
# adds) in disjoint key chains even for identical token content.
_IDENT_BASIS = 0x9E3779B97F4A7C15
_SEG_TAG = 0x5345474D454E5431  # "SEGMENT1"
_BND_TAG = 0x424F554E44415259  # "BOUNDARY"
_REQ_TAG = 0x5245515545535431  # "REQUEST1"


@dataclass
class ChainMemoConfig:
    enabled: bool = True
    # Entries (requests + boundary states + token segments), not blocks. At
    # the defaults an entry holds at most a handful of keys: 128k entries
    # bound the memo around the same order as the prefix store's 500k token
    # blocks.
    capacity: int = 131072
    # Segment granularity of the token-domain family, in blocks. Smaller =
    # finer reuse on divergent chains, more entries per request.
    segment_blocks: int = 8
    # Boundary entries are written at every `boundary_stride`-th text-chunk
    # boundary (plus the final one), bounding the cold path's insert cost;
    # the walk is gap-tolerant (entries carry their block span), so thinning
    # only coarsens WHERE a follow-up turn resumes, never correctness.
    boundary_stride: int = 2


class ChainMemo:
    """Memoized chained block-key derivation (see module docstring)."""

    def __init__(self, config: Optional[ChainMemoConfig] = None):
        self.config = config or ChainMemoConfig()
        if self.config.capacity <= 0:
            raise ValueError("chain memo capacity must be positive")
        if self.config.segment_blocks <= 0:
            raise ValueError("chain memo segment_blocks must be positive")
        if self.config.boundary_stride <= 0:
            raise ValueError("chain memo boundary_stride must be positive")
        # key u64 → request:  (keys,)
        #           boundary: (start_blocks, delta_keys, parent_after,
        #                      n_blocks_total)
        #           segment:  (delta_keys, parent_after)
        self._cache: LRUCache[int, tuple] = LRUCache(self.config.capacity)
        self._str_fp_cache: dict = {}
        self._mu = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._blocks_reused = 0
        self._blocks_hashed = 0
        # Which entry family served this thread's most recent derivation
        # ("request" / "boundary" / "segment" / "cold") — thread-local, so
        # the score-explain path (obs/) can attribute its own derivation
        # without racing concurrent callers.
        self._last = threading.local()

    # -- identity ----------------------------------------------------------

    def _str_fp(self, s: str) -> int:
        fp = self._str_fp_cache.get(s)
        if fp is None:
            fp = hashing.fnv64a(s.encode("utf-8"))
            # Unbounded in principle; in practice model names and algo tags
            # are a handful of interned strings per deployment.
            self._str_fp_cache[s] = fp
        return fp

    def _ident(
        self, model_name: str, parent: int, block_size: int,
        extra: Optional[Sequence[int]], algo: str,
    ) -> int:
        """Fold the derivation identity: two derivations share memo entries
        iff model, algorithm, root/parent hash, block size and extra tuple
        all match — the conditions under which their key chains are equal."""
        h = _IDENT_BASIS
        for v in (self._str_fp(algo), self._str_fp(model_name), parent,
                  block_size):
            h = ((h ^ (v & _M64)) * _PRIME) & _M64
        if extra is not None:
            h = ((h ^ (len(extra) + 1)) * _PRIME) & _M64
            for e in extra:
                h = ((h ^ (int(e) & _M64)) * _PRIME) & _M64
        return h

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            return {
                "entries": len(self._cache),
                "capacity": self.config.capacity,
                "hits": self._hits,
                "misses": self._misses,
                "blocks_reused": self._blocks_reused,
                "blocks_hashed": self._blocks_hashed,
                "native": hashing.have_native(),
            }

    def _count(self, hit: bool, reused: int, hashed: int) -> None:
        with self._mu:
            if hit:
                self._hits += 1
            else:
                self._misses += 1
            self._blocks_reused += reused
            self._blocks_hashed += hashed

    def _count_batch(
        self, hits: int, misses: int, reused: int, hashed: int
    ) -> None:
        """One lock crossing for a whole batch's counters. Counts carry
        per-ITEM semantics (what N single calls would have reported), so
        hit-rate math stays comparable; intra-batch dedup means the actual
        hash work can be lower than `blocks_hashed` suggests."""
        with self._mu:
            self._hits += hits
            self._misses += misses
            self._blocks_reused += reused
            self._blocks_hashed += hashed

    def last_family(self) -> Optional[str]:
        """Entry family that served this thread's last `derive_keys` call:
        "request" (whole-key-tuple probe), "boundary" (prefix-store
        boundary chain), "segment" (token-domain segments), or "cold" (no
        memoized prefix — full derivation). None before any call."""
        return getattr(self._last, "family", None)

    # -- derivation --------------------------------------------------------

    def derive_keys(
        self,
        model_name: str,
        parent: int,
        tokens: Sequence[int],
        block_size: int,
        extra: Optional[Sequence[int]],
        algo: str,
        prefix_state: Optional[PrefixState] = None,
    ) -> List[Key]:
        """Chained block Keys for `tokens`, resuming from the longest
        memoized prefix. Bit-identical to from-scratch derivation
        (hashing.prefix_hashes_fast) by construction — the memo only ever
        changes WHERE hashing starts, never what it produces."""
        n_full = len(tokens) // block_size
        self._last.family = "cold"
        if n_full == 0:
            return []
        ident = self._ident(model_name, parent, block_size, extra, algo)
        if prefix_state:
            return self._derive_boundary(
                ident, model_name, parent, tokens, block_size, extra, algo,
                prefix_state, n_full,
            )
        return self._derive_segments(
            ident, model_name, parent, tokens, block_size, extra, algo, n_full
        )

    def _tail_keys(
        self, model_name: str, parent_h: int, tokens: Sequence[int],
        covered_blocks: int, block_size: int, extra, algo: str,
    ) -> List[Key]:
        if covered_blocks * block_size >= len(tokens):
            return []
        return [
            Key(model_name, h)
            for h in hashing.prefix_hashes_fast(
                parent_h, tokens[covered_blocks * block_size:], block_size,
                extra, algo=algo,
            )
        ]

    def _derive_boundary(
        self, ident: int, model_name: str, parent: int, tokens,
        block_size: int, extra, algo: str, prefix_state: PrefixState,
        n_full: int,
    ) -> List[Key]:
        cache = self._cache
        n_tokens = len(tokens)
        last_fp, last_n = prefix_state[-1]

        # Whole-request probe: the pool's warm path returns exactly the
        # covered tokens, so the final boundary identifies the request.
        req_key = None
        if last_n == n_tokens:
            h = ((ident ^ _REQ_TAG) * _PRIME) & _M64
            h = ((h ^ last_fp) * _PRIME) & _M64
            req_key = ((h ^ n_tokens) * _PRIME) & _M64
            entry = cache.get(req_key)
            if entry is not None:
                keys = entry[0]
                self._last.family = "request"
                self._count(True, len(keys), 0)
                return list(keys)

        bnd_root = ((ident ^ _BND_TAG) * _PRIME) & _M64
        bnd_keys = [
            ((((bnd_root ^ fp) * _PRIME) & _M64) ^ n_tok) * _PRIME & _M64
            for fp, n_tok in prefix_state
        ]
        found = cache.get_many(bnd_keys)
        keys: List[Key] = []
        parent_h = parent
        covered = 0  # blocks
        hit_boundaries = 0
        # Gap-tolerant walk: entries carry their block span, so a hit whose
        # span starts exactly where we left off extends the chain even when
        # intermediate boundaries were never written (insert stride) or
        # were evicted.
        for bk in bnd_keys:
            entry = found.get(bk)
            if entry is not None and len(entry) == 4 and entry[0] == covered:
                _, delta, parent_after, n_blocks = entry
                keys.extend(delta)
                parent_h = parent_after
                covered = n_blocks
                hit_boundaries += 1
        tail = self._tail_keys(
            model_name, parent_h, tokens, covered, block_size, extra, algo
        )
        full = keys + tail
        inserts = []
        # Record (a strided subset of) the boundaries past the covered
        # prefix — nothing to record when the walk already covered every
        # derived block. Boundary token counts are clamped to the blocks
        # this call actually derived (the last text chunk can cover tokens
        # past the final full block).
        if tail and hit_boundaries < len(prefix_state):
            stride = self.config.boundary_stride
            prev_blocks = covered
            last_i = len(prefix_state) - 1
            for i in range(len(prefix_state)):
                if i % stride != stride - 1 and i != last_i:
                    continue
                n_blocks = min(prefix_state[i][1] // block_size, n_full)
                if n_blocks < prev_blocks:
                    continue  # inside the already-covered prefix
                if bnd_keys[i] in found and n_blocks == prev_blocks:
                    continue  # already present and nothing new to add
                delta = tuple(full[prev_blocks:n_blocks])
                parent_after = (
                    full[n_blocks - 1].chunk_hash if n_blocks else parent
                )
                inserts.append(
                    (bnd_keys[i], (prev_blocks, delta, parent_after, n_blocks))
                )
                prev_blocks = n_blocks
        if req_key is not None:
            inserts.append((req_key, (tuple(full),)))
        if inserts:
            cache.add_many(inserts)
        if hit_boundaries > 0:
            self._last.family = "boundary"
        self._count(hit_boundaries > 0, covered, len(tail))
        return full

    def _derive_segments(
        self, ident: int, model_name: str, parent: int, tokens,
        block_size: int, extra, algo: str, n_full: int,
    ) -> List[Key]:
        seg_tokens = self.config.segment_blocks * block_size
        seg_root = ((ident ^ _SEG_TAG) * _PRIME) & _M64
        # floor(len/seg_tokens) == floor(n_full/segment_blocks): fingerprints
        # cover exactly the full segments of full blocks.
        fps = hashing.token_fingerprints(seg_root, tokens, seg_tokens)
        found = self._cache.get_many(fps)
        keys: List[Key] = []
        parent_h = parent
        covered_segs = 0
        for fp in fps:
            entry = found.get(fp)
            if entry is None:
                break
            delta, parent_after = entry
            keys.extend(delta)
            parent_h = parent_after
            covered_segs += 1
        sb = self.config.segment_blocks
        tail = self._tail_keys(
            model_name, parent_h, tokens, covered_segs * sb, block_size,
            extra, algo,
        )
        full = keys + tail
        if covered_segs < len(fps):
            inserts = []
            for s in range(covered_segs, len(fps)):
                delta = tuple(full[s * sb:(s + 1) * sb])
                inserts.append((fps[s], (delta, delta[-1].chunk_hash)))
            self._cache.add_many(inserts)
        if covered_segs > 0:
            self._last.family = "segment"
        self._count(covered_segs > 0, covered_segs * sb, len(tail))
        return full

    # -- batched derivation ------------------------------------------------

    def derive_keys_many(
        self, items: Sequence[tuple]
    ) -> List[List[Key]]:
        """Batched `derive_keys`: one request per router-batch item, every
        memo probe folded into a single `get_many` (one LRU lock crossing
        for the whole batch), intra-batch dedup of shared chains, and all
        residual hashing done in at most two batched calls
        (hashing.prefix_hashes_fast_many) instead of one per item.

        `items` is a sequence of `(model_name, parent, tokens, block_size,
        extra, algo, prefix_state)` tuples — `derive_keys`'s argument list.
        Returns one Key list per item, bit-identical to calling
        `derive_keys` per item (the batch only moves WHERE hashing happens
        and shares chains that are already identical by fingerprint — the
        same 64-bit-collision risk class every memo probe accepts).

        Intra-batch sharing: a boundary key folds the cumulative token
        fingerprint of everything before it, so under one derivation
        identity two items sharing their FINAL boundary fingerprint share
        the entire chain up to that boundary. Such items form a chain
        group: the group's chain derives once (from the member with the
        least memo coverage) and every member slices its span out of the
        shared result — B requests over one hot system prefix cost one
        derivation, not B. Identical residual tails (duplicate prompts)
        dedupe the same way by content."""
        n_items = len(items)
        results: List[Optional[List[Key]]] = [None] * n_items
        plans: List[Optional[dict]] = [None] * n_items
        req_probe: List[int] = []

        # -- phase 1: whole-request probe -----------------------------------
        # The warm steady state is every item resolving on its request
        # entry, so probe those FIRST (one small get_many) and only build
        # boundary/segment probe keys for the items that miss — cold-path
        # bookkeeping never taxes the warm batch.
        for i, (model_name, parent, tokens, block_size, extra, algo,
                prefix_state) in enumerate(items):
            n_full = len(tokens) // block_size
            if n_full == 0:
                results[i] = []
                continue
            ident = self._ident(model_name, parent, block_size, extra, algo)
            plan: dict = {"ident": ident, "n_full": n_full, "req_key": None}
            if prefix_state:
                n_tokens = len(tokens)
                last_fp, last_n = prefix_state[-1]
                if last_n == n_tokens:
                    h = ((ident ^ _REQ_TAG) * _PRIME) & _M64
                    h = ((h ^ last_fp) * _PRIME) & _M64
                    req_key = ((h ^ n_tokens) * _PRIME) & _M64
                    plan["req_key"] = req_key
                    req_probe.append(req_key)
            plans[i] = plan

        found_req = self._cache.get_many(req_probe) if req_probe else {}
        hits = misses = reused_total = 0
        probe_keys: List[int] = []
        for i, plan in enumerate(plans):
            if plan is None:
                continue
            req_key = plan["req_key"]
            if req_key is not None:
                entry = found_req.get(req_key)
                if entry is not None:
                    keys = entry[0]
                    results[i] = list(keys)
                    plan["resolved"] = True
                    hits += 1
                    reused_total += len(keys)
                    continue
            (model_name, parent, tokens, block_size, extra, algo,
             prefix_state) = items[i]
            if prefix_state:
                ident = plan["ident"]
                bnd_root = ((ident ^ _BND_TAG) * _PRIME) & _M64
                bnd_keys = [
                    ((((bnd_root ^ fp) * _PRIME) & _M64) ^ n_tok)
                    * _PRIME & _M64
                    for fp, n_tok in prefix_state
                ]
                plan["kind"] = "bnd"
                plan["bnd_keys"] = bnd_keys
                plan["n_bnd"] = prefix_state[-1][1] // block_size
                probe_keys.extend(bnd_keys)
            else:
                seg_tokens = self.config.segment_blocks * block_size
                seg_root = ((plan["ident"] ^ _SEG_TAG) * _PRIME) & _M64
                fps = hashing.token_fingerprints(seg_root, tokens, seg_tokens)
                plan["kind"] = "seg"
                plan["fps"] = fps
                probe_keys.extend(fps)

        found = self._cache.get_many(probe_keys) if probe_keys else {}

        # -- phase 2: probe walk + work planning (no hashing yet) ----------
        chain_groups: dict = {}   # (ident, final bnd key) -> group
        wave1_specs: List[tuple] = []
        direct_tasks: dict = {}   # (ident, parent_h, tail tuple) -> task

        for i, plan in enumerate(plans):
            if plan is None or plan.get("resolved"):
                continue
            (model_name, parent, tokens, block_size, extra, algo,
             prefix_state) = items[i]
            covered_keys: List[Key] = []
            parent_h = parent
            if plan["kind"] == "bnd":
                covered = 0
                hit_boundaries = 0
                for bk in plan["bnd_keys"]:
                    entry = found.get(bk)
                    if (
                        entry is not None and len(entry) == 4
                        and entry[0] == covered
                    ):
                        _, delta, parent_after, n_blocks = entry
                        covered_keys.extend(delta)
                        parent_h = parent_after
                        covered = n_blocks
                        hit_boundaries += 1
                plan["hit_boundaries"] = hit_boundaries
                n_bnd = plan["n_bnd"]
                if covered < n_bnd:
                    # Chain group: everything up to the final boundary is
                    # shared by fingerprint; derive it once per group.
                    gk = (plan["ident"], plan["bnd_keys"][-1])
                    grp = chain_groups.get(gk)
                    if grp is None or covered < grp["covered"]:
                        chain_groups[gk] = {
                            "covered": covered, "parent_h": parent_h,
                            "tokens": tokens, "block_size": block_size,
                            "extra": extra, "algo": algo, "end": n_bnd,
                            "model": model_name,
                        }
                    plan["chain"] = gk
                elif covered < plan["n_full"]:
                    # Memo reached (or passed) the final boundary; the
                    # private tail derives directly.
                    tail_tokens = tokens[covered * block_size:]
                    dk = (plan["ident"], parent_h, tuple(tail_tokens))
                    task = direct_tasks.get(dk)
                    if task is None:
                        task = direct_tasks[dk] = len(wave1_specs)
                        wave1_specs.append((
                            parent_h, tail_tokens, block_size, extra, algo,
                        ))
                    plan["direct"] = task
            else:
                fps = plan["fps"]
                covered_segs = 0
                for fp in fps:
                    entry = found.get(fp)
                    if entry is None:
                        break
                    delta, parent_after = entry
                    covered_keys.extend(delta)
                    parent_h = parent_after
                    covered_segs += 1
                covered = covered_segs * self.config.segment_blocks
                plan["covered_segs"] = covered_segs
                if covered < plan["n_full"]:
                    tail_tokens = tokens[covered * block_size:]
                    dk = (plan["ident"], parent_h, tuple(tail_tokens))
                    task = direct_tasks.get(dk)
                    if task is None:
                        task = direct_tasks[dk] = len(wave1_specs)
                        wave1_specs.append((
                            parent_h, tail_tokens, block_size, extra, algo,
                        ))
                    plan["direct"] = task
            plan["covered"] = covered
            plan["parent_h"] = parent_h
            plan["covered_keys"] = covered_keys

        # -- wave 1: chain groups + direct tails, one batched call --------
        n_chain = len(chain_groups)
        chain_list = list(chain_groups.items())
        specs = [
            (
                grp["parent_h"],
                grp["tokens"][
                    grp["covered"] * grp["block_size"]:
                    grp["end"] * grp["block_size"]
                ],
                grp["block_size"], grp["extra"], grp["algo"],
            )
            for _, grp in chain_list
        ] + wave1_specs
        wave1_out = hashing.prefix_hashes_fast_many(specs)
        for idx, (_, grp) in enumerate(chain_list):
            hashes = wave1_out[idx]
            grp["keys"] = [Key(grp["model"], h) for h in hashes]
            grp["end_parent"] = hashes[-1]
        direct_keys: List[List[Key]] = []
        for task in range(len(wave1_specs)):
            direct_keys.append(None)  # filled below, model comes per item
        # Direct-tail Key lists are shared across deduped items; build each
        # once with the first referencing item's model name (the identity
        # fold guarantees members share it).
        for i, plan in enumerate(plans):
            if plan is None or plan.get("resolved") or "direct" not in plan:
                continue
            task = plan["direct"]
            if direct_keys[task] is None:
                model_name = items[i][0]
                direct_keys[task] = [
                    Key(model_name, h) for h in wave1_out[n_chain + task]
                ]

        # -- wave 2: private tails past a chain group's final boundary -----
        wave2_specs: List[tuple] = []
        wave2_tasks: dict = {}
        for i, plan in enumerate(plans):
            if plan is None or plan.get("resolved") or "chain" not in plan:
                continue
            if plan["n_full"] <= plan["n_bnd"]:
                continue
            (model_name, parent, tokens, block_size, extra, algo,
             prefix_state) = items[i]
            grp = chain_groups[plan["chain"]]
            tail_tokens = tokens[plan["n_bnd"] * block_size:]
            wk = (plan["ident"], plan["chain"][1], tuple(tail_tokens))
            task = wave2_tasks.get(wk)
            if task is None:
                task = wave2_tasks[wk] = len(wave2_specs)
                wave2_specs.append((
                    grp["end_parent"], tail_tokens, block_size, extra, algo,
                ))
            plan["wave2"] = task
        wave2_out = (
            hashing.prefix_hashes_fast_many(wave2_specs)
            if wave2_specs else []
        )
        wave2_keys: List[Optional[List[Key]]] = [None] * len(wave2_specs)

        # -- assembly + memo inserts ---------------------------------------
        inserts: List[tuple] = []
        for i, plan in enumerate(plans):
            if plan is None or plan.get("resolved"):
                continue
            (model_name, parent, tokens, block_size, extra, algo,
             prefix_state) = items[i]
            covered = plan["covered"]
            full = plan["covered_keys"]
            if "chain" in plan:
                grp = chain_groups[plan["chain"]]
                full = full + grp["keys"][covered - grp["covered"]:]
                if "wave2" in plan:
                    task = plan["wave2"]
                    if wave2_keys[task] is None:
                        wave2_keys[task] = [
                            Key(model_name, h) for h in wave2_out[task]
                        ]
                    full = full + wave2_keys[task]
            elif "direct" in plan:
                full = full + direct_keys[plan["direct"]]
            results[i] = full
            new_keys = len(full) - covered
            if plan["kind"] == "bnd":
                hit = plan["hit_boundaries"] > 0
                bnd_keys = plan["bnd_keys"]
                if new_keys and plan["hit_boundaries"] < len(prefix_state):
                    # Same strided insert policy as the single-item path.
                    stride = self.config.boundary_stride
                    prev_blocks = covered
                    last_j = len(prefix_state) - 1
                    n_full = plan["n_full"]
                    for j in range(len(prefix_state)):
                        if j % stride != stride - 1 and j != last_j:
                            continue
                        n_blocks = min(
                            prefix_state[j][1] // block_size, n_full
                        )
                        if n_blocks < prev_blocks:
                            continue
                        if bnd_keys[j] in found and n_blocks == prev_blocks:
                            continue
                        delta = tuple(full[prev_blocks:n_blocks])
                        parent_after = (
                            full[n_blocks - 1].chunk_hash
                            if n_blocks else parent
                        )
                        inserts.append((
                            bnd_keys[j],
                            (prev_blocks, delta, parent_after, n_blocks),
                        ))
                        prev_blocks = n_blocks
                if plan["req_key"] is not None:
                    inserts.append((plan["req_key"], (tuple(full),)))
            else:
                hit = plan["covered_segs"] > 0
                fps = plan["fps"]
                sb = self.config.segment_blocks
                if plan["covered_segs"] < len(fps):
                    for s in range(plan["covered_segs"], len(fps)):
                        delta = tuple(full[s * sb:(s + 1) * sb])
                        inserts.append((fps[s], (delta, delta[-1].chunk_hash)))
            if hit:
                hits += 1
            else:
                misses += 1
            reused_total += covered

        if inserts:
            self._cache.add_many(inserts)
        hashed_total = sum(
            len(r) - p["covered"]
            for r, p in zip(results, plans)
            if p is not None and not p.get("resolved")
        )
        self._last.family = "batch"
        self._count_batch(hits, misses, reused_total, hashed_total)
        return results
