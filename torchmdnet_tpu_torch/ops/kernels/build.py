"""Builds the port's CUDA sources (``torchmdnet_tpu_torch/csrc``) at first use.

Each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  No PyTorch headers are
included, so a build takes seconds.  Libraries go to
``torchmdnet_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the flags, so an edited source is rebuilt.  ``build`` starts one
``nvcc`` per source, all at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("et_message.cu", "select_topk.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

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


def library_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def build(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns {source: nvcc's output} for the sources compiled (the
    ``-Xptxas=-v`` lines give registers, shared memory and spills).
    Raises if a compile fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for src in sources:
        out = library_path(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
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
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
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

