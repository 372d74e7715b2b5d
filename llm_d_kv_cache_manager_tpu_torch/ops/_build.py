"""Builds the port's native libraries and loads them.

Each CUDA kernel `csrc/<name>.cu` compiles on its own with nvcc into
`build/lib<name>_<hash>.so`, a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds). The host tier's block store and
transfer wire, `kv_connectors/cpp/kv_transfer.cpp` at the repository root,
compiles the same way with the C++ compiler into
`build/lib<TRANSFER>_<hash>.so`. The C hash core and scoring arena,
`native/fnvcbor.c` and `native/kvscore.c` at the repository root, compile
with the C compiler against this Python's headers into
`build/<name>_<hash>.so` and load as CPython extension modules under the
port's own dotted names (`extension`); the sources fix the init symbols, so
the names end in `_kvtpu_native` and `_kvtpu_kvscore`. The hash covers the
source (and, for a kernel, the headers of `csrc/`; for an extension,
`native/kvhash.h` and the include directory) and the flags, so an edited
source or header rebuilds and an unchanged one is reused. All missing libraries build in
parallel, one compiler process per source; each writes a pid-suffixed
temporary file and renames it into place, so processes that build the same
library at once do no harm.

There is no fallback: a missing compiler or a failed build raises, with the
compiler's log.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
KERNELS = ("paged_decode", "paged_decode_tiled", "paged_decode_wide", "flash_prefill")
# --split-compile=0 (NVVM) and -Xptxas --split-compile=0 (ptxas) optimize and
# assemble a source's kernels on every core: the two decode sources hold about
# a hundred instantiations each, and their build then takes 67.5 s where it
# took 122.4 s, with the same registers and SASS (H100 host, CUDA 12.9).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--split-compile=0", "-Xptxas", "--split-compile=0",
)
# The host tier's C++ engine, with the flags of kv_connectors/cpp/Makefile.
TRANSFER = "kvtransfer"
TRANSFER_SOURCE = _PKG.parent / "kv_connectors" / "cpp" / "kv_transfer.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
CXX_LIBS = ("-lpthread",)
# The C hash core and the scoring arena: extension name -> source in native/.
NATIVE_DIR = _PKG.parent / "native"
EXTENSIONS = {"_kvtpu_native": "fnvcbor.c", "_kvtpu_kvscore": "kvscore.c"}
CC_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_extensions: Dict[str, ModuleType] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from csrc/ "
            "with nvcc for sm_90a and have no fallback"
        )
    return nvcc


def find_cxx() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(
            "no C++ compiler (g++ or c++) found: the host tier's transfer "
            f"library is built from {TRANSFER_SOURCE.name} and has no fallback"
        )
    return cxx


def find_cc() -> str:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError(
            "no C compiler (cc or gcc) found: the native hash core and "
            "scoring arena are built from native/*.c and have no fallback"
        )
    return cc


def python_include() -> Path:
    """This interpreter's header directory; the extensions need Python.h."""
    include = Path(sysconfig.get_paths()["include"])
    if not (include / "Python.h").exists():
        raise RuntimeError(
            f"Python.h not found in {include}: the native hash core and "
            "scoring arena (native/*.c) cannot be built without it"
        )
    return include


def library_path(name: str) -> Path:
    if name in EXTENSIONS:
        digest = hashlib.sha256((NATIVE_DIR / EXTENSIONS[name]).read_bytes())
        digest.update((NATIVE_DIR / "kvhash.h").read_bytes())
        digest.update(" ".join(CC_FLAGS).encode())
        digest.update(sysconfig.get_paths()["include"].encode())
        return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    if name == TRANSFER:
        digest = hashlib.sha256(TRANSFER_SOURCE.read_bytes())
        digest.update(" ".join(CXX_FLAGS + CXX_LIBS).encode())
    else:
        digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):  # sources include these
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> List[str]:
    if name in EXTENSIONS:
        return [
            find_cc(), *CC_FLAGS, f"-I{python_include()}", f"-I{NATIVE_DIR}",
            "-o", str(out), str(NATIVE_DIR / EXTENSIONS[name]),
        ]
    if name == TRANSFER:
        return [find_cxx(), *CXX_FLAGS, "-o", str(out), str(TRANSFER_SOURCE), *CXX_LIBS]
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every named library whose file is missing, all compiler
    processes started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    commands = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        commands[name] = (out, tmp, _command(name, tmp))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = [
        (name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
        for name, (out, tmp, cmd) in commands.items()
    ]
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("native library build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """Compiler output of the last build of `name` (registers, spills)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name` (a kernel of csrc/, or TRANSFER), built on
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def extension(name: str) -> ModuleType:
    """The CPython extension `name` (a key of EXTENSIONS), built on first use
    and loaded as `llm_d_kv_cache_manager_tpu_torch.<name>`. A failed build
    raises with the compiler's log."""
    with _lock:
        module = _extensions.get(name)
        if module is None:
            build([name])
            dotted = f"{_PKG.name}.{name}"
            path = str(library_path(name))
            loader = importlib.machinery.ExtensionFileLoader(dotted, path)
            spec = importlib.util.spec_from_file_location(dotted, path, loader=loader)
            module = importlib.util.module_from_spec(spec)
            loader.exec_module(module)
            sys.modules[dotted] = module
            _extensions[name] = module
        return module
