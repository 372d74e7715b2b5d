"""The port's chat-template rendering and UDS tokenizer against the JAX
package's, on the same inputs.

The JAX package renders through transformers' `render_jinja_template`; the
port renders with jinja2 in the environment transformers builds. Every
rendered string (or the error raised) must be equal, on the committed
fixture template (tests/fixtures/chat/word-chat.jinja, whose renders
tests/fixtures/chat/rendered.json holds; chip_smoke.py phase 14b renders
the same cases on the card) and on templates that use loop controls,
`tojson`, `raise_exception`, generation tags, tools, documents,
`continue_final_message` and template variables. Then the Indexer's
`render_request` path on both packages over the same events, and the
port's `UDSTokenizer` against the sidecar (services/uds_tokenizer), beside
the JAX client.
"""

import asyncio
import importlib
import json
import os
import threading
from types import SimpleNamespace

import pytest

from tests.conftest import FIXTURES_DIR, TEST_MODEL_NAME, TEST_TOKENIZER_JSON

pytest.importorskip("transformers")

JAX_PKG = "llm_d_kv_cache_manager_tpu"
PORT_PKG = "llm_d_kv_cache_manager_tpu_torch"
CHAT_DIR = os.path.join(FIXTURES_DIR, "chat")
BLOCK = 4


def _pkg(pkg):
    mods = dict(
        chat="preprocessing.chat_completions", tok="tokenization.tokenizer",
        tpool="tokenization.pool", uds="tokenization.uds_client", indexer="kvcache.indexer",
        tp="kvcache.kvblock.token_processor", ev="kvevents.events", pool="kvevents.pool",
        hashing="kvcache.kvblock.hashing",
    )
    return SimpleNamespace(name=pkg, **{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in mods.items()})


BOTH = [_pkg(JAX_PKG), _pkg(PORT_PKG)]
FIXTURE = json.load(open(os.path.join(CHAT_DIR, "rendered.json")))
WORD_CHAT = open(os.path.join(CHAT_DIR, FIXTURE["template"])).read()


def _render(p, template, conversation, **options):
    """The rendered string, or the error's type name and message."""
    request = p.chat.RenderRequest(conversations=[conversation], chat_template=template,
                                   **options)
    try:
        return p.chat.ChatTemplatingProcessor().render(request)
    except Exception as e:  # noqa: BLE001 - the error is the reading
        return (type(e).__name__, str(e))


def _both(template, conversation, **options):
    jax_out, port_out = (_render(p, template, conversation, **options) for p in BOTH)
    assert port_out == jax_out
    return port_out


# -- RenderRequest --------------------------------------------------------------


@pytest.mark.parametrize("body", [
    {"messages": [{"role": "user", "content": "x"}]},
    {"conversations": [[{"role": "user", "content": "x"}], []], "chat_template": "T",
     "tools": [{"name": "t"}], "documents": [{"title": "a", "text": "b"}],
     "add_generation_prompt": False, "continue_final_message": True,
     "template_vars": {"bos_token": "<s>"}, "model": "m"},
], ids=["messages", "every_field"])
def test_render_request_matches_jax(body):
    outs = []
    for p in BOTH:
        a = p.chat.RenderRequest.from_dict(body)
        b = p.chat.RenderRequest.from_json(json.dumps(body))
        assert a == b
        outs.append(vars(a))
    assert outs[1] == outs[0]


# -- rendering --------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(FIXTURE["cases"])))
def test_fixture_template_renders_the_committed_strings(case):
    """transformers (the JAX package), the port and the committed string
    agree on every fixture case."""
    c = FIXTURE["cases"][case]
    request = dict(c["request"])
    conversation = request.pop("conversations")[0]
    assert _both(WORD_CHAT, conversation, **request) == c["rendered"]


def test_fixture_template_refuses_a_conversation_without_system_prompt():
    err = _both(WORD_CHAT, [{"role": "user", "content": "w00001"}])
    assert err[0] == "TemplateError" and "system prompt" in err[1]


CONVERSATION = [
    {"role": "system", "content": "Be brief & <precise>."},
    {"role": "user", "content": "Héllo — \"quoted\""},
    {"role": "assistant", "content": "Hi."},
    {"role": "user", "content": "Next?"},
]
TEMPLATES = {
    "loop_controls": (
        "{% for m in messages %}{% if m.role == 'system' %}{% continue %}{% endif %}"
        "{% if loop.index > 3 %}{% break %}{% endif %}[{{ m.role }}]{{ m.content }}"
        "{% endfor %}"
    ),
    "tojson": "{{ messages | tojson }}|{{ messages[1] | tojson(indent=2, sort_keys=True) }}"
              "|{{ {'b': 1, 'a': [1, 2]} | tojson(separators=(',', ':')) }}",
    "raise_exception": "{% if messages | length > 2 %}{{ raise_exception('too long: ' ~ "
                       "messages | length) }}{% endif %}ok",
    "generation": (
        "{% for m in messages %}{% if m.role == 'assistant' %}{% generation %}"
        "<a>{{ m.content }}</a>{% endgeneration %}{% else %}<{{ m.role }}>{{ m.content }}"
        "{% endif %}{% endfor %}{% if add_generation_prompt %}<a>{% endif %}"
    ),
    "tools_and_documents": (
        "{% if tools %}{% for t in tools %}TOOL {{ t.function.name }} "
        "{{ t.function.parameters | tojson }}\n{% endfor %}{% endif %}"
        "{% if documents %}{% for d in documents %}DOC {{ d.title }}: {{ d.text }}\n"
        "{% endfor %}{% endif %}{% for m in messages %}{{ m.role }}: {{ m.content }}\n"
        "{% endfor %}"
    ),
    "whitespace": (
        "{% for m in messages %}\n"
        "    {% if m.role == 'user' %}\n"
        "USER {{ m.content }}\n"
        "    {% else %}\n"
        "OTHER {{ m.content }}\n"
        "    {% endif %}\n"
        "{% endfor %}\n"
        "{% if add_generation_prompt %}ASSISTANT{% endif %}"
    ),
    "template_vars": "{{ bos_token }}{% for m in messages %}{{ m.content }}{{ eos_token }}"
                     "{% endfor %}{{ custom | default('none') }}",
    "sandbox": "{% set x = messages.append({'role': 'user', 'content': 'x'}) %}{{ x }}",
    "strftime_now": "{{ strftime_now('%Y') }}:{{ messages | length }}",
    "undefined": "{{ messages[0].nope }}|{{ nothing }}|{{ messages | length }}",
}
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather by city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}}]
DOCUMENTS = [{"title": "Doc <1>", "text": "Ünïcode text"}, {"title": "Doc 2", "text": "more"}]


@pytest.mark.parametrize("name", sorted(TEMPLATES))
@pytest.mark.parametrize("add_generation_prompt", [True, False], ids=["agp", "no_agp"])
def test_template_features_match_transformers(name, add_generation_prompt):
    options = dict(add_generation_prompt=add_generation_prompt)
    if name == "tools_and_documents":
        options.update(tools=TOOLS, documents=DOCUMENTS)
    if name == "template_vars":
        options.update(template_vars=dict(bos_token="<s>", eos_token="</s>"))
    out = _both(TEMPLATES[name], CONVERSATION, **options)
    if name == "raise_exception":
        assert out == ("TemplateError", "too long: 4")
    if name == "sandbox":
        assert out[0] == "SecurityError"


@pytest.mark.parametrize("template, content", [
    ("generation", "Partial answer"),
    ("whitespace", "Partial answer"),
    ("generation", [{"type": "text", "text": "first"}, {"type": "image"},
                    {"type": "text", "text": "last"}]),
    ("generation", [{"type": "image"}]),
], ids=["string", "string_trimmed", "blocks", "no_text"])
def test_continue_final_message_matches_transformers(template, content):
    conversation = CONVERSATION[:2] + [{"role": "assistant", "content": content}]
    _both(TEMPLATES[template], conversation, add_generation_prompt=False,
          continue_final_message=True)


def test_continue_final_message_cut_by_the_template_raises_on_both():
    out = _both("{% for m in messages %}{{ m.content[:3] }}{% endfor %}", CONVERSATION[:3],
                continue_final_message=True, add_generation_prompt=False)
    assert out[0] == "ValueError"


def test_missing_template_raises_on_both():
    outs = [_render(p, None, CONVERSATION) for p in BOTH]
    assert outs[0] == outs[1] and outs[1][0] == "ValueError"


# -- fetching -------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["tokenizer_config", "jinja_wins", "org_name"])
def test_fetch_chat_template_matches_jax(tmp_path, layout):
    model = "org/model" if layout == "org_name" else "m"
    model_dir = tmp_path / model
    model_dir.mkdir(parents=True)
    (model_dir / "tokenizer_config.json").write_text(json.dumps({"chat_template": "CFG"}))
    if layout == "jinja_wins":
        (model_dir / "chat_template.jinja").write_text(WORD_CHAT)
    outs = []
    for p in BOTH:
        proc = p.chat.ChatTemplatingProcessor()
        first = proc.fetch_chat_template(model, local_dir=str(tmp_path))
        (model_dir / "tokenizer_config.json").write_text(json.dumps({"chat_template": "V2"}))
        cached = proc.fetch_chat_template(model, local_dir=str(tmp_path))
        proc.clear_caches()
        fresh = proc.fetch_chat_template(model, local_dir=str(tmp_path))
        (model_dir / "tokenizer_config.json").write_text(json.dumps({"chat_template": "CFG"}))
        outs.append((first, cached, fresh))
    assert outs[1] == outs[0]


def test_render_by_model_name_reads_local_template(tmp_path, monkeypatch):
    model_dir = tmp_path / "chat-model"
    model_dir.mkdir()
    (model_dir / "chat_template.jinja").write_text(WORD_CHAT)
    monkeypatch.setenv("LOCAL_TOKENIZER_DIR", str(tmp_path))
    conversation = FIXTURE["cases"][1]["request"]["conversations"][0]
    outs = [p.chat.ChatTemplatingProcessor().render(p.chat.RenderRequest(
        conversations=[conversation], model_name="chat-model")) for p in BOTH]
    assert outs[0] == outs[1] == FIXTURE["cases"][1]["rendered"]


def test_port_never_loads_auto_tokenizer(monkeypatch, tmp_path):
    """Where the reference falls back to transformers.AutoTokenizer (which
    may download), the port raises, saying why."""
    p = BOTH[1]
    monkeypatch.setenv("LOCAL_TOKENIZER_DIR", str(tmp_path))
    with pytest.raises(LookupError, match="AutoTokenizer"):
        p.chat.ChatTemplatingProcessor().fetch_chat_template("org/absent")


# -- rendering through the tokenizers, the pool and the Indexer -----------------


def _chat_indexer(p):
    """An Indexer whose local tokenizer renders through the package's
    ChatTemplatingProcessor, with pod-a holding the first turn's whole chain
    and pod-b half of it."""
    indexer = p.indexer.Indexer(
        p.indexer.IndexerConfig(
            token_processor_config=p.tp.TokenProcessorConfig(block_size=BLOCK),
            tokenizers_pool_config=p.tpool.TokenizersPoolConfig(
                workers=2, local_tokenizer_files={TEST_MODEL_NAME: TEST_TOKENIZER_JSON})),
        chat_templating=p.chat.ChatTemplatingProcessor())
    indexer.run()
    first = p.chat.RenderRequest(conversations=[CONVERSATION[:2]], chat_template=WORD_CHAT,
                                 model_name=TEST_MODEL_NAME)
    tokens = indexer.tokenizers_pool.tokenize(first, "", TEST_MODEL_NAME)
    n_blocks = len(tokens) // BLOCK
    pool = p.pool.EventPool(p.pool.EventPoolConfig(concurrency=1), indexer.kv_block_index,
                            indexer.token_processor)
    pool.start(with_subscriber=False)
    for pod, depth in (("pod-a", n_blocks), ("pod-b", n_blocks // 2)):
        ev = p.ev.BlockStored(block_hashes=list(range(1, depth + 1)), parent_block_hash=None,
                              token_ids=list(tokens[: depth * BLOCK]), block_size=BLOCK)
        pool.add_task(p.pool.Message(
            topic=f"kv@{pod}@{TEST_MODEL_NAME}",
            payload=p.ev.EventBatch(ts=0.0, events=[ev]).to_msgpack(),
            seq=0, pod_identifier=pod, model_name=TEST_MODEL_NAME))
    pool.drain()
    pool.shutdown()
    return indexer, tokens


def _own_core(p, explain):
    """The explain document with the chain memo's "native" flag replaced by
    whether it tells the truth about package `p`'s own C hash core: the
    port builds its core on first use, the JAX package's is loaded only
    where it was built, so the raw flags differ between checkouts."""
    memo = dict(explain["chain_memo"])
    stats = dict(memo["stats"])
    stats["native"] = stats["native"] == p.hashing.have_native()
    memo["stats"] = stats
    return {**explain, "chain_memo": memo}


def test_indexer_render_request_matches_jax():
    """get_pod_scores(_ex), explain_scores and score_many with a render
    request: the same tokens, scores, match lengths and chains."""
    outs = []
    for p in BOTH:
        indexer, tokens = _chat_indexer(p)
        try:
            second = p.chat.RenderRequest(conversations=[CONVERSATION],
                                          chat_template=WORD_CHAT)
            ex = indexer.get_pod_scores_ex("", TEST_MODEL_NAME, [], render_request=second)
            plain = indexer.get_pod_scores("", TEST_MODEL_NAME, ["pod-b"],
                                           render_request=second)
            explain = indexer.explain_scores("", TEST_MODEL_NAME, [], render_request=second)
            many = indexer.score_many([
                p.indexer.ScoreRequest("", TEST_MODEL_NAME, render_request=second),
                p.indexer.ScoreRequest("unrendered prompt text", TEST_MODEL_NAME),
                p.indexer.ScoreRequest("", TEST_MODEL_NAME, render_request=p.chat.RenderRequest(
                    conversations=[CONVERSATION[:2]], chat_template=WORD_CHAT,
                    add_generation_prompt=False)),
            ])
        finally:
            indexer.shutdown()
        assert ex.scores["pod-a"] > ex.scores["pod-b"] > 0
        outs.append((tokens, ex.scores, ex.match_blocks, ex.block_hashes, plain,
                     _own_core(p, {k: v for k, v in explain.items() if k != "timings"}),
                     [(m.scores, m.match_blocks, m.block_hashes) for m in many]))
    assert outs[1] == outs[0]


def test_tokenizers_render_through_their_processor():
    """The local backend and the composite render with the processor they
    were given; without one the local backend raises NotImplementedError
    and the composite says no backend could."""
    request_of = lambda p: p.chat.RenderRequest(  # noqa: E731
        conversations=[CONVERSATION[:2]], chat_template=WORD_CHAT)
    outs = []
    for p in BOTH:
        files = {TEST_MODEL_NAME: TEST_TOKENIZER_JSON}
        local = p.tok.CachedLocalTokenizer(tokenizer_files=files,
                                           chat_templating=p.chat.ChatTemplatingProcessor())
        bare = p.tok.CachedLocalTokenizer(tokenizer_files=files)
        composite = p.tok.CompositeTokenizer([bare, local])
        with pytest.raises(NotImplementedError):
            bare.render_chat_template(request_of(p))
        with pytest.raises(RuntimeError) as err:
            p.tok.CompositeTokenizer([bare]).render_chat_template(request_of(p))
        outs.append((local.render_chat_template(request_of(p)),
                     composite.render_chat_template(request_of(p)), str(err.value)))
    assert outs[1] == outs[0]


# -- the UDS tokenizer against the sidecar ---------------------------------------


@pytest.fixture
def sidecar(tmp_path):
    """The sidecar (services/uds_tokenizer) on a Unix socket, as
    tests/test_uds_sidecar.py runs it."""
    pytest.importorskip("aiohttp")
    from services.uds_tokenizer.server import make_app
    from services.uds_tokenizer.tokenizer_service import TokenizerService

    socket_path = str(tmp_path / "tok.sock")
    service = TokenizerService({"local_tokenizer_dir": FIXTURES_DIR, "allow_remote": False})
    loop = asyncio.new_event_loop()
    started = threading.Event()
    holder = {}

    async def start():
        from aiohttp import web

        runner = web.AppRunner(make_app(service))
        await runner.setup()
        await web.UnixSite(runner, socket_path).start()
        holder["runner"] = runner
        started.set()

    def run_loop():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(start())
        loop.run_forever()

    thread = threading.Thread(target=run_loop, daemon=True)
    thread.start()
    assert started.wait(10)
    yield socket_path

    async def stop():
        await holder["runner"].cleanup()

    asyncio.run_coroutine_threadsafe(stop(), loop).result(5)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=5)
    assert not thread.is_alive()


def _uds_readings(p, socket_path):
    client = p.uds.UDSTokenizer(socket_path=socket_path)
    out = []
    for prompt in ("The quick brown fox", "KV cache aware routing with prefix reuse",
                   "ünïcode — bytes"):
        r = client.encode(prompt, TEST_MODEL_NAME)
        out.append((r.tokens, r.offsets))
    out.append(client.render_chat_template(p.chat.RenderRequest(
        conversations=[CONVERSATION[:2]], chat_template=WORD_CHAT)))
    try:
        p.uds.UDSTokenizer(socket_path=socket_path, retries=0).encode("hi", "missing-model")
    except RuntimeError as e:
        out.append("500" in str(e))
    return out


def test_uds_tokenizer_matches_jax_client(sidecar):
    jax_out, port_out = (_uds_readings(p, sidecar) for p in BOTH)
    assert port_out == jax_out and port_out[-1] is True
    local = BOTH[1].tok.CachedLocalTokenizer(
        tokenizer_files={TEST_MODEL_NAME: TEST_TOKENIZER_JSON})
    r = local.encode("The quick brown fox", TEST_MODEL_NAME)
    assert port_out[0] == (r.tokens, r.offsets)
    assert port_out[3] == _render(BOTH[1], WORD_CHAT, CONVERSATION[:2])


def test_uds_tokenizer_unreachable_socket_retries_then_fails(tmp_path):
    p = BOTH[1]
    client = p.uds.UDSTokenizer(socket_path=str(tmp_path / "nope.sock"), timeout_s=0.2,
                                retries=1)
    with pytest.raises(RuntimeError, match="after 2 attempts"):
        client.encode("hi", TEST_MODEL_NAME)


def test_pool_with_enable_uds_falls_back_to_the_sidecar(sidecar):
    """TokenizersPoolConfig(enable_uds=True): the local backend knows no
    model, so the composite falls through to the sidecar, on both packages."""
    outs = []
    for p in BOTH:
        pool = p.tpool.TokenizationPool(p.tpool.TokenizersPoolConfig(
            workers=1, enable_uds=True, uds_socket_path=sidecar, local_tokenizer_files={}))
        pool.run()
        try:
            outs.append(pool.tokenize(None, "fallback to sidecar", TEST_MODEL_NAME))
        finally:
            pool.shutdown()
    assert outs[1] == outs[0] and outs[1]
