"""The PyTorch port stands alone: it never imports jax or the JAX package,
and its entry points refuse to run on a missing GPU unless the CPU is asked
for by name."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "llm_d_kv_cache_manager_tpu_torch"
REFERENCE = "llm_d_kv_cache_manager_tpu"


def _is_forbidden(module: str) -> bool:
    """jax, or the reference package by exact or dotted name (the port's own
    name shares the reference's prefix, so a bare startswith would not do)."""
    return (
        module == "jax" or module.startswith("jax.")
        or module == REFERENCE or module.startswith(REFERENCE + ".")
    )


def _port_files():
    return sorted(PORT.rglob("*.py")) + sorted(REPO.glob("chip_*.py"))


@pytest.mark.parametrize(
    "name, forbidden",
    [
        ("jax", True),
        ("jax.numpy", True),
        ("jaxlib", False),
        (REFERENCE, True),
        (REFERENCE + ".kvcache.indexer", True),
        (REFERENCE + "_torch", False),
        (REFERENCE + "_torch.models.llama", False),
    ],
)
def test_forbidden_name_match_is_exact_or_dotted(name, forbidden):
    assert _is_forbidden(name) is forbidden


def test_import_with_jax_blocked_loads_no_reference_module():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"ref = {REFERENCE!r}\n"
        "bad = [m for m in sys.modules if m == ref or m.startswith(ref + '.')\n"
        "       or m.startswith('jax.') or (m == 'jax' and sys.modules[m] is not None)]\n"
        "print('LOADED', len(sys.modules), 'BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            imported.append(node.module)
    assert not [m for m in imported if _is_forbidden(m)], imported


def test_default_device_pod_raises_without_gpu():
    from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
    from llm_d_kv_cache_manager_tpu_torch.models.llama import LlamaConfig

    assert not torch.cuda.is_available()
    cfg = LlamaConfig(vocab_size=64, d_model=32, n_layers=1, n_q_heads=2,
                      n_kv_heads=1, head_dim=16, d_ff=64, dtype=torch.float32)
    assert EnginePodConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnginePod(EnginePodConfig(model_config=cfg))


@pytest.mark.parametrize("module", ["engine.scheduler", "ops.sampling"])
def test_scheduler_and_sampler_are_checked(module):
    """The scheduler and the sampler are among the modules the import checks
    above load and parse."""
    path = PORT / (module.replace(".", "/") + ".py")
    assert path in _port_files()
    assert "import torch" in path.read_text()


def test_default_device_scheduler_raises_without_gpu():
    """A Scheduler needs a pod, and a pod built without device='cpu' raises
    on a machine with no card: the scheduler never falls back to the CPU.
    The sampler's keys default to the card the same way."""
    from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
    from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler
    from llm_d_kv_cache_manager_tpu_torch.models.llama import LlamaConfig
    from llm_d_kv_cache_manager_tpu_torch.ops.sampling import prng_key

    cfg = LlamaConfig(vocab_size=64, d_model=32, n_layers=1, n_q_heads=2,
                      n_kv_heads=1, head_dim=16, d_ff=64, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler(EnginePod(EnginePodConfig(model_config=cfg)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prng_key(0)
    pod = EnginePod(EnginePodConfig(model_config=cfg, device="cpu"))
    assert Scheduler(pod).pod.device.type == "cpu"


@pytest.mark.parametrize(
    "entry", ["init_params", "make_kv_pages", "params_from_jax", "make_kv_pages_quantized",
              "make_quantized_kv_pages"]
)
def test_default_device_model_entry_points_raise_without_gpu(entry):
    from llm_d_kv_cache_manager_tpu_torch.models import llama
    from llm_d_kv_cache_manager_tpu_torch.ops.quantized_kv import make_quantized_kv_pages

    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=1, n_q_heads=2,
                            n_kv_heads=1, head_dim=16, d_ff=64, dtype=torch.float32)
    calls = {
        "init_params": lambda: llama.init_params(cfg, torch.Generator()),
        "make_kv_pages": lambda: llama.make_kv_pages(cfg, 4, 4),
        "params_from_jax": lambda: llama.params_from_jax({"w": [1.0]}),
        "make_kv_pages_quantized": lambda: llama.make_kv_pages_quantized(cfg, 4, 4),
        "make_quantized_kv_pages": lambda: make_quantized_kv_pages(1, 4, 4, 16),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)  # nothing prebuilt
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["paged_decode"])


def test_kernel_library_name_tracks_source_hash():
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    for name in _build.KERNELS:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
        assert (_build.CSRC_DIR / f"{name}.cu").exists()


def test_kernel_library_name_tracks_shared_header(monkeypatch, tmp_path):
    """Both decode sources include csrc/paged_decode_common.cuh: an edit
    there must rebuild them, not reuse a library built from the old body."""
    import shutil

    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    header = csrc / "paged_decode_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    assert all(after[name] != before[name] for name in _build.KERNELS)


@pytest.mark.parametrize(
    "module", ["engine.costs", "engine.tiering", "kv_connectors.connector", "engine.engine"]
)
def test_host_tier_modules_are_checked(module):
    """The host tier's modules are among those the import checks above load
    and parse."""
    path = PORT / (module.replace(".", "/") + ".py")
    assert path.exists() and path in _port_files()


def test_default_device_host_tier_pod_raises_without_gpu():
    """A host-tier pod defaults to the card like any pod and raises before
    it starts a transfer server."""
    from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
    from llm_d_kv_cache_manager_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(vocab_size=64, d_model=32, n_layers=1, n_q_heads=2,
                      n_kv_heads=1, head_dim=16, d_ff=64, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnginePod(EnginePodConfig(model_config=cfg, enable_host_tier=True,
                                  transfer_cost_model=None))


def test_transfer_build_without_cxx_raises(monkeypatch, tmp_path):
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)  # nothing prebuilt
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _build.build([_build.TRANSFER])


def test_transfer_library_name_tracks_its_source(monkeypatch, tmp_path):
    """The transfer library is keyed by its source's hash, lives in the
    port's build/ directory, and is never the JAX package's file name."""
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    path = _build.library_path(_build.TRANSFER)
    assert path.parent == _build.BUILD_DIR and path.name != "libkvtransfer.so"
    src = tmp_path / "kv_transfer.cpp"
    src.write_text(_build.TRANSFER_SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "TRANSFER_SOURCE", src)
    assert _build.library_path(_build.TRANSFER) != path


@pytest.mark.parametrize("module", ["models.lora", "engine.speculative"])
def test_lora_and_speculative_modules_are_checked(module):
    """Multi-LoRA and speculative decoding are among the modules the import
    checks above load and parse."""
    path = PORT / (module.replace(".", "/") + ".py")
    assert path in _port_files()
    assert "import torch" in path.read_text()


def test_default_device_lora_and_speculation_raise_without_gpu():
    """A LoRA pod, the speculative decoder and scheduler (each needs a pod)
    and the adapter constructors default to the card and raise without one;
    asked for by name, the CPU serves them."""
    from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
    from llm_d_kv_cache_manager_tpu_torch.engine.speculative import (
        SpeculativeDecoder,
        SpeculativeScheduler,
    )
    from llm_d_kv_cache_manager_tpu_torch.models import llama, lora

    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=1, n_q_heads=2,
                            n_kv_heads=1, head_dim=16, d_ff=64, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator(), "cpu")
    adapter = lora.init_lora_adapter(cfg, 2, torch.Generator(), device="cpu")
    calls = [
        lambda: EnginePod(EnginePodConfig(model_config=cfg), lora_adapters={1: adapter}),
        lambda: SpeculativeDecoder(EnginePod(EnginePodConfig(model_config=cfg)), cfg, params),
        lambda: SpeculativeScheduler(EnginePod(EnginePodConfig(model_config=cfg)), cfg, params),
        lambda: lora.init_lora_adapter(cfg, 2, torch.Generator()),
        lambda: lora.make_test_adapter(cfg, 2, torch.Generator()),
        lambda: lora.lora_from_jax({k: v.numpy() for k, v in adapter.items()}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    pod = EnginePod(EnginePodConfig(model_config=cfg, device="cpu"), lora_adapters={1: adapter})
    assert pod.lora_for_decode([1, None])[1].device.type == "cpu"
    spec = SpeculativeScheduler(EnginePod(EnginePodConfig(model_config=cfg, device="cpu")),
                                cfg, params)
    assert spec._draft_cache[0].device.type == "cpu"


@pytest.mark.parametrize("module", ["models.mixtral", "models.hf_loader"])
def test_moe_and_hf_loader_modules_are_checked(module):
    """The MoE family and the HF bridge are among the modules the import
    checks above load and parse."""
    path = PORT / (module.replace(".", "/") + ".py")
    assert path in _port_files()
    assert "import torch" in path.read_text()


def test_port_imports_without_transformers():
    """The card's machine has no transformers: every port module imports
    with it blocked (hf_loader imports it inside load_hf_llama only)."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        "sys.modules['transformers'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print('OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout + proc.stderr


def test_default_device_moe_entry_points_raise_without_gpu():
    """A MoE pod, mixtral.init_params and the HF loader default to the card
    and raise without one; asked for by name, the CPU serves them."""
    from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
    from llm_d_kv_cache_manager_tpu_torch.models import hf_loader, mixtral

    cfg = mixtral.MixtralConfig(vocab_size=64, d_model=32, n_layers=1, n_q_heads=2,
                                n_kv_heads=1, head_dim=16, d_ff=64, n_experts=4,
                                dtype=torch.float32)
    params = mixtral.init_params(cfg, torch.Generator(), "cpu")
    state_dict = {"model.embed_tokens.weight": params["embed"]}
    calls = [
        lambda: EnginePod(EnginePodConfig(model_config=cfg)),
        lambda: mixtral.init_params(cfg, torch.Generator()),
        lambda: hf_loader.mixtral_params_from_hf(state_dict, cfg),
        lambda: hf_loader.params_from_hf(state_dict, cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    pod = EnginePod(EnginePodConfig(model_config=cfg, device="cpu"))
    assert pod.params["layers"]["router"].device.type == "cpu"


WIRE_LIBRARIES = ("zmq", "msgpack", "xxhash", "tokenizers", "transformers")
ZMQ_MODULES = ("kvevents/publisher.py", "kvevents/zmq_subscriber.py")


def test_port_imports_without_the_wire_libraries():
    """The card's machine has no pyzmq, msgpack, xxhash, tokenizers or
    transformers: with all five blocked, every port module but the two ZMQ
    ones imports, and chip_smoke imports."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
        if str(p.relative_to(PORT)) not in ZMQ_MODULES
    )
    code = (
        "import importlib, sys\n"
        f"for lib in {WIRE_LIBRARIES!r}:\n"
        "    sys.modules[lib] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print('OK', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout + proc.stderr


def _top_level_imports(path):
    """Modules a file imports at module level (not inside a function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_wire_libraries_are_never_imported_at_module_level(path):
    """Only the two ZMQ modules import zmq at module level; no port file
    imports msgpack, xxhash, tokenizers or transformers there (the port
    has its own msgpack codec and XXH64, and imports tokenizers lazily)."""
    rel = str(path.relative_to(PORT)) if PORT in path.parents else path.name
    allowed = {"zmq"} if rel in ZMQ_MODULES else set()
    bad = [m for m in _top_level_imports(path)
           if m.split(".")[0] in WIRE_LIBRARIES and m.split(".")[0] not in allowed]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "utils.msgpack_codec", "utils.xxh64", "kvevents.pool", "kvevents.publisher",
    "kvevents.zmq_subscriber", "kvcache.indexer", "kvcache.kvblock.sharded",
    "kvcache.kvblock.chain_memo", "tokenization.pool", "tokenization.tokenizer",
    "tokenization.prefixstore.lru_store", "tokenization.prefixstore.trie_store",
])
def test_control_plane_modules_are_checked(module):
    """The write and read planes are among the modules the import checks
    above load and parse."""
    path = PORT / (module.replace(".", "/") + ".py")
    assert path in _port_files()


READ_PLANE_MODULES = [
    "utils.humansize", "kvcache.kvblock.cost_aware", "kvcache.kvblock.resp",
    "kvcache.kvblock.redis_index", "kvcache.kvblock.native_index", "fleethealth.load",
    "kvcache.routing", "kv_connectors.prefetch", "preprocessing.chat_completions",
    "tokenization.uds_client",
]


@pytest.mark.parametrize("module", READ_PLANE_MODULES)
def test_read_plane_modules_are_checked(module):
    """The read plane's second half (the index backends, routing, prefetch,
    chat templates, the UDS tokenizer) is among the modules the import
    checks above load and parse."""
    path = PORT / (module.replace(".", "/") + ".py")
    assert path in _port_files()


def test_read_plane_imports_without_the_wire_libraries():
    """With transformers, zmq, msgpack, xxhash and tokenizers blocked, each
    new module imports and the chat renderer renders (on jinja2)."""
    code = (
        "import importlib, sys\n"
        f"for lib in {WIRE_LIBRARIES!r}:\n"
        "    sys.modules[lib] = None\n"
        f"for m in {READ_PLANE_MODULES!r}:\n"
        f"    importlib.import_module({(PORT.name + '.')!r} + m)\n"
        f"from {PORT.name}.preprocessing.chat_completions import (\n"
        "    ChatTemplatingProcessor, RenderRequest)\n"
        "out = ChatTemplatingProcessor().render(RenderRequest(\n"
        "    conversations=[[{'role': 'user', 'content': 'hi'}]],\n"
        "    chat_template='{% for m in messages %}{{ m.content }}{% endfor %}'))\n"
        "print('OK', out)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and "OK hi" in proc.stdout, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", ["_kvtpu_native", "_kvtpu_kvscore"])
def test_native_extension_loads_under_the_port_name(name):
    """The C hash core and the arena build into the port's build/ directory
    and load under the port's dotted name: never a file of the JAX package,
    whose own build decides which of its tests run."""
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    module = _build.extension(name)
    assert module.__name__ == f"{PORT.name}.{name}"
    assert Path(module.__file__).parent == _build.BUILD_DIR
    assert sys.modules[module.__name__] is module
    assert not list((REPO / REFERENCE).glob(f"{name}_*.so"))


def test_native_build_without_cc_raises(monkeypatch, tmp_path):
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)  # nothing prebuilt
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        _build.build(["_kvtpu_kvscore"])


def test_native_build_without_python_header_raises(monkeypatch, tmp_path):
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.sysconfig, "get_paths", lambda: {"include": str(tmp_path)})
    with pytest.raises(RuntimeError, match="Python.h not found"):
        _build.build(["_kvtpu_native"])


def test_native_extension_name_tracks_its_sources(monkeypatch, tmp_path):
    """An extension is keyed by its source and the shared kvhash.h."""
    import shutil

    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    before = {name: _build.library_path(name) for name in _build.EXTENSIONS}
    native = tmp_path / "native"
    shutil.copytree(_build.NATIVE_DIR, native, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "NATIVE_DIR", native)
    assert {name: _build.library_path(name) for name in _build.EXTENSIONS} == before
    header = native / "kvhash.h"
    header.write_text(header.read_text() + "\n/* edited */\n")
    after = {name: _build.library_path(name) for name in _build.EXTENSIONS}
    assert all(after[name] != before[name] for name in _build.EXTENSIONS)


RESILIENCE_MODULES = [
    "autopilot", "autopilot.knobs", "fleethealth", "fleethealth.tracker",
    "fleethealth.faults", "antientropy", "antientropy.tracker", "antientropy.feedback",
    "antientropy.auditor", "resourcegov", "resourcegov.accountant", "resourcegov.reaper",
    "resourcegov.governor",
]


# Ids as paths: tests/conftest.py skips a test whose keywords hold a bare
# "antientropy" when the JAX package's transfer library is not built.
@pytest.mark.parametrize("module", RESILIENCE_MODULES, ids=lambda m: m.replace(".", "/") + ".py")
def test_resilience_plane_modules_are_checked(module):
    """The fleet's resilience plane (fleet health and fault injection,
    anti-entropy, the resource governor and the autopilot's knobs) is among
    the modules the import checks above load and parse."""
    rel = module.replace(".", "/")
    path = PORT / rel / "__init__.py" if (PORT / rel).is_dir() else PORT / (rel + ".py")
    assert path in _port_files()


def test_resilience_plane_imports_without_the_wire_libraries():
    """With jax, transformers, zmq, msgpack, xxhash and tokenizers blocked,
    each module of the resilience plane imports, and none loads a metrics or
    tracing module (the port has none yet)."""
    code = (
        "import importlib, sys\n"
        f"for lib in {WIRE_LIBRARIES + ('jax', 'prometheus_client')!r}:\n"
        "    sys.modules[lib] = None\n"
        f"for m in {RESILIENCE_MODULES!r}:\n"
        f"    importlib.import_module({(PORT.name + '.')!r} + m)\n"
        f"bad = [m for m in sys.modules if '.metrics' in m or ('.obs' in m and m not in {SLO!r})]\n"
        "print('BAD', bad)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and "BAD []" in proc.stdout, proc.stdout + proc.stderr


# The fleet planes' second half: replicated indexers, the region tier, the
# transfer plane's chaos injector and the SLO autopilot. The SLO monitor
# (obs/slo.py, the obs package's only module) is the one obs module they load.
SLO = (f"{PORT.name}.obs", f"{PORT.name}.obs.slo")
FLEET_PLANE_MODULES = [
    "utils.cbor", "obs", "obs.slo", "autopilot.signals", "autopilot.controller", "api",
    "api.admission", "kv_connectors.faults", "cluster", "cluster.partition", "cluster.snapshot",
    "cluster.replica", "cluster.scorer", "cluster.membership", "federation",
    "federation.digest", "federation.region", "federation.failover", "federation.router",
]


# Ids as paths, as above: a bare "cluster" or "federation" keyword is one
# tests/conftest.py skips when grpcio is missing.
@pytest.mark.parametrize("module", FLEET_PLANE_MODULES, ids=lambda m: m.replace(".", "/") + ".py")
def test_fleet_plane_modules_are_checked(module):
    """Each module of the fleet planes' second half is among the modules the
    import checks above load and parse."""
    rel = module.replace(".", "/")
    path = PORT / rel / "__init__.py" if (PORT / rel).is_dir() else PORT / (rel + ".py")
    assert path in _port_files()


def test_fleet_plane_imports_without_the_wire_libraries():
    """With jax, grpc, aiohttp, transformers, zmq, msgpack, xxhash and
    tokenizers blocked, each module of the fleet planes' second half imports
    and loads no metrics or tracing module."""
    code = (
        "import importlib, sys\n"
        f"for lib in {WIRE_LIBRARIES + ('jax', 'prometheus_client', 'grpc', 'aiohttp')!r}:\n"
        "    sys.modules[lib] = None\n"
        f"for m in {FLEET_PLANE_MODULES!r}:\n"
        f"    importlib.import_module({(PORT.name + '.')!r} + m)\n"
        f"bad = [m for m in sys.modules if '.metrics' in m or ('.obs' in m and m not in {SLO!r})]\n"
        "print('BAD', bad)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and "BAD []" in proc.stdout, proc.stdout + proc.stderr
