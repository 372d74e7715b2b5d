"""Chat-completions preprocessing: Jinja chat-template rendering + fetching.

Copy of the reference package's `preprocessing/chat_completions.py`, with one
difference: the reference renders through
`transformers.utils.chat_template_utils.render_jinja_template`, and the port
renders with `jinja2` directly (a dependency of torch; transformers is not
needed). `_compile` and `_render_conversation` rebuild the environment and
the per-conversation steps of transformers 4.57: an
`ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)` with
the loop-control extension and the `{% generation %}` block, the `tojson`
filter with transformers' defaults (no HTML escaping), and the
`raise_exception` and `strftime_now` globals; tools are JSON schemas (dicts)
and `continue_final_message` cuts the rendered prompt after the final
message.

`fetch_chat_template` reads a local `chat_template.jinja` or
`tokenizer_config.json`; where the reference falls back to
`transformers.AutoTokenizer` (which may download), the port raises.
"""

from __future__ import annotations

import copy
import json
import os
import threading
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("preprocessing.chat_completions")

_CONTINUE_TAG = "CONTINUE_FINAL_MESSAGE_TAG "
# Compiled templates kept per processor (transformers keeps an unbounded
# lru_cache); past this many distinct templates the cache starts over.
_TEMPLATE_CACHE_MAX = 64


@dataclass
class RenderRequest:
    """Mirror of the reference's RenderJinjaTemplateRequest JSON contract."""

    conversations: List[List[Dict[str, Any]]]
    chat_template: Optional[str] = None
    tools: Optional[List[Dict[str, Any]]] = None
    documents: Optional[List[Dict[str, Any]]] = None
    add_generation_prompt: bool = True
    continue_final_message: bool = False
    template_vars: Dict[str, Any] = field(default_factory=dict)
    model_name: Optional[str] = None

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "RenderRequest":
        """The one place the JSON body contract maps to fields — shared by
        the HTTP service, the UDS sidecar, and from_json."""
        if "conversations" in data:
            conversations = data["conversations"]
        else:
            conversations = [data["messages"]]
        return cls(
            conversations=conversations,
            chat_template=data.get("chat_template"),
            tools=data.get("tools"),
            documents=data.get("documents"),
            add_generation_prompt=data.get("add_generation_prompt", True),
            continue_final_message=data.get("continue_final_message", False),
            template_vars=data.get("template_vars", {}),
            model_name=data.get("model"),
        )

    @classmethod
    def from_json(cls, payload: str) -> "RenderRequest":
        return cls.from_dict(json.loads(payload))


def _compile(chat_template: str):
    """The template compiled in transformers' environment."""
    import jinja2
    import jinja2.ext
    import jinja2.nodes
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    class AssistantTracker(jinja2.ext.Extension):
        # `{% generation %}...{% endgeneration %}` marks assistant text for
        # training masks; rendering a prompt only needs the body's output.
        tags = {"generation"}

        def parse(self, parser):
            lineno = next(parser.stream).lineno
            body = parser.parse_statements(["name:endgeneration"], drop_needle=True)
            return jinja2.nodes.CallBlock(
                self.call_method("_generation_support"), [], [], body
            ).set_lineno(lineno)

        @jinja2.pass_eval_context
        def _generation_support(self, context, caller):
            return caller()

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
        return json.dumps(
            x, ensure_ascii=ensure_ascii, indent=indent, separators=separators,
            sort_keys=sort_keys,
        )

    def strftime_now(format):
        return datetime.now().strftime(format)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[AssistantTracker, jinja2.ext.loopcontrols],
    )
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env.from_string(chat_template)


def _render_conversation(compiled, chat, request: RenderRequest) -> str:
    """One conversation, as transformers' `render_jinja_template` renders it."""
    tools = request.tools
    if tools is not None:
        for tool in tools:
            if not isinstance(tool, dict):
                raise ValueError("Tools should be JSON schemas (dicts)")
    if request.documents is not None:
        for document in request.documents:
            if not isinstance(document, dict):
                raise TypeError(
                    "Documents should be a list of dicts with 'title' and 'text' keys!"
                )
    final_message = None
    if request.continue_final_message:
        chat = copy.deepcopy(chat)
        final_message = chat[-1]["content"]
        if isinstance(final_message, (list, tuple)):
            for block in reversed(final_message):
                if "text" in block:
                    final_message = block["text"]
                    block["text"] = block["text"] + _CONTINUE_TAG
                    break
            else:
                raise ValueError(
                    "continue_final_message is set but we could not find any "
                    "text to continue in the final message!"
                )
        else:
            chat[-1]["content"] = chat[-1]["content"] + _CONTINUE_TAG
    rendered = compiled.render(
        messages=chat,
        tools=tools,
        documents=request.documents,
        add_generation_prompt=request.add_generation_prompt,
        **request.template_vars,
    )
    if request.continue_final_message:
        tag = _CONTINUE_TAG.strip()
        if final_message.strip() not in rendered or tag not in rendered:
            raise ValueError(
                "continue_final_message is set but the final message does not "
                "appear in the chat after applying the chat template! This can "
                "happen if the chat template deletes portions of the final "
                "message. Please verify the chat template and final message in "
                "your chat to ensure they are compatible."
            )
        loc = rendered.rindex(tag)
        if rendered[loc: loc + len(_CONTINUE_TAG)] == _CONTINUE_TAG:
            rendered = rendered[:loc]
        else:
            rendered = rendered[:loc].rstrip()
    return rendered


class ChatTemplatingProcessor:
    """Renders chat templates and fetches/caches per-model templates."""

    def __init__(self):
        self._template_cache: Dict[str, str] = {}
        self._compiled: Dict[str, Any] = {}
        self._mu = threading.Lock()

    def render(self, request: RenderRequest) -> str:
        """Render the first conversation to a prompt string."""
        template = request.chat_template
        if not template and request.model_name:
            template = self.fetch_chat_template(request.model_name)
        if not template:
            raise ValueError("no chat template provided or fetchable")
        with self._mu:
            compiled = self._compiled.get(template)
        if compiled is None:
            compiled = _compile(template)
            with self._mu:
                if len(self._compiled) >= _TEMPLATE_CACHE_MAX:
                    self._compiled.clear()
                self._compiled[template] = compiled
        return _render_conversation(compiled, request.conversations[0], request)

    def fetch_chat_template(
        self, model_name: str, local_dir: Optional[str] = None
    ) -> Optional[str]:
        """Fetch a model's chat template, caching per model.

        Resolution order: cache → local `tokenizer_config.json` /
        `chat_template.jinja` (under `local_dir` or LOCAL_TOKENIZER_DIR) →
        `_fetch_auto`, which raises in the port.
        """
        with self._mu:
            cached = self._template_cache.get(model_name)
        if cached is not None:
            return cached

        template = self._fetch_local(model_name, local_dir)
        if template is None:
            template = self._fetch_auto(model_name)
        if template is not None:
            with self._mu:
                self._template_cache[model_name] = template
        return template

    def clear_caches(self) -> None:
        with self._mu:
            self._template_cache.clear()
            self._compiled.clear()

    def _fetch_local(self, model_name: str, local_dir: Optional[str]) -> Optional[str]:
        root = local_dir or os.environ.get("LOCAL_TOKENIZER_DIR", "")
        if not root:
            return None
        candidates = [
            os.path.join(root, model_name),
            os.path.join(root, model_name.replace("/", os.sep)),
        ]
        for base in candidates:
            jinja_path = os.path.join(base, "chat_template.jinja")
            if os.path.isfile(jinja_path):
                with open(jinja_path, encoding="utf-8") as f:
                    return f.read()
            cfg_path = os.path.join(base, "tokenizer_config.json")
            if os.path.isfile(cfg_path):
                try:
                    with open(cfg_path, encoding="utf-8") as f:
                        cfg = json.load(f)
                    template = cfg.get("chat_template")
                    if isinstance(template, str):
                        return template
                except (OSError, json.JSONDecodeError) as e:
                    logger.warning("failed reading %s: %s", cfg_path, e)
        return None

    def _fetch_auto(self, model_name: str) -> Optional[str]:
        raise LookupError(
            f"no local chat template for {model_name!r}: the port reads "
            "chat_template.jinja or tokenizer_config.json under local_dir or "
            "LOCAL_TOKENIZER_DIR, and does not load transformers.AutoTokenizer "
            "(which may download); pass the template in the request instead"
        )
