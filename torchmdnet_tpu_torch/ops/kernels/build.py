"""Builds the port's CUDA sources (``torchmdnet_tpu_torch/csrc``) at first use.

Each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  No PyTorch headers are
included, so a build takes seconds.  Libraries go to
``torchmdnet_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source, of every header under ``csrc/`` it includes (``#include "..."``,
followed through headers) and of the flags, so an edited source or header is
rebuilt.  ``build`` starts one ``nvcc`` per source, all at once.

The host sources (``HOST_SOURCES``: the data loader's collation engine,
``collate.cpp``) are built the same way by the host's C++ compiler (``CXX``,
else ``c++`` or ``g++`` on ``PATH``).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("et_message.cu", "select_topk.cu", "tn_message.cu", "ell_gather.cu", "t_message.cu", "compaction.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

HOST_SOURCES = ("collate.cpp",)
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's CUDA "
        "kernels are built from torchmdnet_tpu_torch/csrc at first use"
    )


def cxx_path() -> str:
    for cand in (os.environ.get("CXX", ""), shutil.which("c++") or "", shutil.which("g++") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("no C++ compiler found (set CXX or put c++ on PATH); the port's host sources are "
                       "built from torchmdnet_tpu_torch/csrc at first use")


def _host(source: str) -> bool:
    return source in HOST_SOURCES


def _flags(source: str):
    return CXX_FLAGS if _host(source) else NVCC_FLAGS


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources_of(source: str):
    """``source`` and the headers under ``csrc/`` it includes, each once, in
    the order first reached."""
    seen, order, todo = set(), [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.add(name)
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            text = f.read()
        order.append(text)
        todo += [h.decode() for h in _INCLUDE.findall(text)
                 if os.path.isfile(os.path.join(CSRC_DIR, h.decode()))]
    return order


def library_path(source: str) -> str:
    h = hashlib.sha256()
    for text in _sources_of(source):
        h.update(hashlib.sha256(text).digest())
    h.update(" ".join(_flags(source)).encode())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def build(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns {source: the compiler's output} for the sources compiled (nvcc's
    ``-Xptxas=-v`` lines give registers, shared memory and spills).
    Raises if a compile fails or its compiler is missing.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for src in sources:
        out = library_path(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        compiler = cxx_path() if _host(src) else nvcc_path()
        cmd = [compiler, *_flags(src), "-o", tmp, os.path.join(CSRC_DIR, src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[src] = (proc, tmp, out)
    logs = {}
    failed = []
    for src, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[src] = log
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("compile failed for " + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The library built from ``source``, compiled first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(library_path(source))
            _LIBS[source] = lib
        return lib

