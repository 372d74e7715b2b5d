"""Tokenizer backends: cached HF/local tokenizers + ordered composite fallback.

Copy of the reference package's `tokenization/tokenizer.py`:
- a bounded LRU of loaded tokenizers with singleflight load deduplication,
- a local provider that auto-discovers `tokenizer.json` files under a
  directory, understanding both HF-cache layout (`models--org--name` →
  `org/name`) and plain relative paths, configured via
  LOCAL_TOKENIZER_DIR / LOCAL_TOKENIZER_FILENAME,
- an HF-hub provider that downloads tokenizers on demand,
- a composite that tries backends in order for both encode and chat-template
  rendering.

The HuggingFace `tokenizers` package is imported lazily, when a backend
first loads a tokenizer, so the port imports without it. Offsets are
converted from character to **byte** offsets because the prefix store
chunks the prompt's UTF-8 bytes. The local and HF backends render chat
templates through the `ChatTemplatingProcessor` they are given
(preprocessing/chat_completions.py). The reference's per-backend metrics
counters are not ported.
"""

from __future__ import annotations

import abc
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.indexer import Offset
from llm_d_kv_cache_manager_tpu_torch.utils.lru import LRUCache
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("tokenization.tokenizer")

DEFAULT_TOKENIZER_CACHE_SIZE = 20
ENV_LOCAL_TOKENIZER_DIR = "LOCAL_TOKENIZER_DIR"
ENV_LOCAL_TOKENIZER_FILENAME = "LOCAL_TOKENIZER_FILENAME"
DEFAULT_TOKENIZER_FILENAME = "tokenizer.json"


@dataclass
class TokenizationResult:
    tokens: List[int]
    offsets: List[Offset]  # byte offsets into the prompt


class Tokenizer(abc.ABC):
    @abc.abstractmethod
    def encode(self, prompt: str, model_name: str) -> TokenizationResult: ...

    def render_chat_template(self, request) -> str:
        """Render a chat-completions request to a prompt string.

        `request` is a preprocessing.chat_completions.RenderRequest. Backends
        that cannot render raise NotImplementedError so the composite falls
        through to the next backend.
        """
        raise NotImplementedError


def _char_to_byte_offsets(text: str, char_offsets: Sequence[Tuple[int, int]]) -> List[Offset]:
    """Convert HF (char_start, char_end) offsets to byte offsets."""
    # Cumulative byte length at each char boundary.
    cum = [0] * (len(text) + 1)
    total = 0
    for i, ch in enumerate(text):
        total += len(ch.encode("utf-8"))
        cum[i + 1] = total
    n = len(text)
    out: List[Offset] = []
    for lo, hi in char_offsets:
        lo = min(max(lo, 0), n)
        hi = min(max(hi, 0), n)
        out.append((cum[lo], cum[hi]))
    return out


class _Flight:
    __slots__ = ("done", "result", "error")

    def __init__(self):
        self.done = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


class _SingleflightLoader:
    """Deduplicates concurrent loads of the same tokenizer."""

    def __init__(self):
        self._mu = threading.Lock()
        self._inflight: Dict[str, _Flight] = {}

    def load(self, key: str, loader):
        with self._mu:
            flight = self._inflight.get(key)
            leader = flight is None
            if leader:
                flight = _Flight()
                self._inflight[key] = flight
        if leader:
            try:
                flight.result = loader()
            except Exception as e:  # propagate to all waiters
                flight.error = e
            finally:
                with self._mu:
                    self._inflight.pop(key, None)
                flight.done.set()
        else:
            flight.done.wait()
        if flight.error is not None:
            raise flight.error
        return flight.result


class _CachedTokenizerBase(Tokenizer):
    """LRU of loaded `tokenizers.Tokenizer` objects + singleflight loads."""

    def __init__(self, cache_size: int = DEFAULT_TOKENIZER_CACHE_SIZE):
        self._cache: LRUCache[str, object] = LRUCache(cache_size)
        self._flight = _SingleflightLoader()

    @abc.abstractmethod
    def _load(self, model_name: str):
        """Load and return a tokenizers.Tokenizer for the model."""

    def _get(self, model_name: str):
        tok = self._cache.get(model_name)
        if tok is not None:
            return tok
        loaded = self._flight.load(model_name, lambda: self._load(model_name))
        self._cache.add(model_name, loaded)
        return loaded

    def encode(self, prompt: str, model_name: str) -> TokenizationResult:
        tok = self._get(model_name)
        encoding = tok.encode(
            prompt, add_special_tokens=resolve_add_special_tokens(tok, prompt)
        )
        byte_offsets = _char_to_byte_offsets(prompt, encoding.offsets)
        return TokenizationResult(tokens=list(encoding.ids), offsets=byte_offsets)


# BOS strings to probe for dedup; vocab membership decides applicability.
_BOS_CANDIDATES = ("<s>", "<|begin_of_text|>", "<bos>", "[CLS]")


def detect_bos_token(tok, configured: Optional[str] = None) -> Optional[str]:
    """The tokenizer's BOS string: the configured one (if present in the
    vocab), else the first candidate the vocab contains. A tokenizer has
    one BOS; first-in-vocab keeps detection deterministic."""
    if configured:
        return configured if tok.token_to_id(configured) is not None else None
    for candidate in _BOS_CANDIDATES:
        if tok.token_to_id(candidate) is not None:
            return candidate
    return None


def resolve_add_special_tokens(
    tok,
    prompt: str,
    configured: Optional[bool] = None,
    bos_token: Optional[str] = None,
) -> bool:
    """BOS-dedup: if the prompt already starts with the tokenizer's BOS
    string (chat templates commonly bake it in), special tokens must not be
    added again — overriding even an explicit True. Otherwise the
    configured value applies (True when unset).

    Every tokenizer backend must share this one rule, or the composite's
    fallback order would change token ids (and therefore block hashes) for
    the very same prompt."""
    bos = detect_bos_token(tok, bos_token)
    if bos is not None and prompt.startswith(bos):
        return False
    return True if configured is None else bool(configured)


def discover_local_tokenizers(
    root_dir: str, filename: str = DEFAULT_TOKENIZER_FILENAME
) -> Dict[str, str]:
    """Walk `root_dir` mapping model names to tokenizer files.

    Discovery rules:
    - HF cache layout `models--org--name/snapshots/<rev>/tokenizer.json`
      maps to model name `org/name`;
    - any other `<subdir>/tokenizer.json` maps to the relative dir path.
    """
    found: Dict[str, str] = {}
    if not root_dir or not os.path.isdir(root_dir):
        return found
    for dirpath, _dirnames, filenames in os.walk(root_dir):
        if filename not in filenames:
            continue
        full = os.path.join(dirpath, filename)
        rel = os.path.relpath(dirpath, root_dir)
        model_name = None
        for part in rel.split(os.sep):
            if part.startswith("models--"):
                pieces = part.split("--")[1:]
                if pieces:
                    model_name = "/".join(pieces)
                break
        if model_name is None:
            model_name = rel.replace(os.sep, "/")
            if model_name == ".":
                continue
        # First hit wins (e.g. the first snapshot revision found).
        found.setdefault(model_name, full)
    return found


class CachedLocalTokenizer(_CachedTokenizerBase):
    """Loads tokenizers from local `tokenizer.json` files (no network)."""

    def __init__(
        self,
        tokenizer_files: Optional[Dict[str, str]] = None,
        cache_size: int = DEFAULT_TOKENIZER_CACHE_SIZE,
        chat_templating=None,
    ):
        super().__init__(cache_size)
        self._chat_templating = chat_templating
        if tokenizer_files is None:
            root = os.environ.get(ENV_LOCAL_TOKENIZER_DIR, "")
            fname = os.environ.get(
                ENV_LOCAL_TOKENIZER_FILENAME, DEFAULT_TOKENIZER_FILENAME
            )
            tokenizer_files = discover_local_tokenizers(root, fname)
        self.tokenizer_files = tokenizer_files

    def _load(self, model_name: str):
        from tokenizers import Tokenizer as HFTokenizer

        path = self.tokenizer_files.get(model_name)
        if path is None:
            raise FileNotFoundError(
                f"no local tokenizer file registered for model {model_name!r}"
            )
        return HFTokenizer.from_file(path)

    def render_chat_template(self, request) -> str:
        if self._chat_templating is None:
            raise NotImplementedError("local tokenizer has no chat templating processor")
        return self._chat_templating.render(request)


class CachedHFTokenizer(_CachedTokenizerBase):
    """Downloads tokenizers from the HuggingFace hub on demand."""

    def __init__(
        self,
        cache_size: int = DEFAULT_TOKENIZER_CACHE_SIZE,
        auth_token: Optional[str] = None,
        chat_templating=None,
    ):
        super().__init__(cache_size)
        self._chat_templating = chat_templating
        self.auth_token = auth_token or os.environ.get("HF_TOKEN")

    def _load(self, model_name: str):
        from tokenizers import Tokenizer as HFTokenizer

        return HFTokenizer.from_pretrained(model_name, auth_token=self.auth_token)

    def render_chat_template(self, request) -> str:
        if self._chat_templating is None:
            raise NotImplementedError("hf tokenizer has no chat templating processor")
        return self._chat_templating.render(request)


class CompositeTokenizer(Tokenizer):
    """Ordered fallback over tokenizer backends (local → UDS → HF)."""

    def __init__(self, backends: Sequence[Tokenizer]):
        if not backends:
            raise ValueError("composite tokenizer requires at least one backend")
        self.backends = list(backends)

    def encode(self, prompt: str, model_name: str) -> TokenizationResult:
        errors: List[str] = []
        for backend in self.backends:
            name = type(backend).__name__
            try:
                return backend.encode(prompt, model_name)
            except Exception as e:  # noqa: BLE001 - fallback semantics
                errors.append(f"{name}: {e}")
        raise RuntimeError(
            f"all tokenizer backends failed for model {model_name!r}: {'; '.join(errors)}"
        )

    def render_chat_template(self, request) -> str:
        errors: List[str] = []
        for backend in self.backends:
            name = type(backend).__name__
            try:
                return backend.render_chat_template(request)
            except NotImplementedError:
                continue
            except Exception as e:  # noqa: BLE001
                errors.append(f"{name}: {e}")
        raise RuntimeError(
            f"all chat-templating backends failed: {'; '.join(errors) or 'none capable'}"
        )
