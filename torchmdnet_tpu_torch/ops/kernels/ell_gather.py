"""The ELL row gather and its transpose-sum for bf16 rows (counterpart of
torchmdnet_tpu/ops/pallas/onehot_gather.py).

The kernels (``csrc/ell_gather.cu``) replace the Pallas TPU kernels
``_gather_kernel`` (onehot_gather.py:178) and ``_transpose_kernel`` (:227).
The source file's header says what bounds them on an H100 and what their
design does about it.

- ``gather_rows(x, idx)``: out[i, k] = x[idx[i, k]] for x (N, ...) bf16,
  exact;
- ``transpose_sum_rows(g, idx, perm)``: dh[j] = sum of g[i, k] over the slots
  with idx[i, k] == j for g (N, K, ...) bf16, summed in f32 in ascending slot
  order through ``perm`` (``transpose_perm(idx)``) and rounded once to bf16.

``ops/neighbors.py`` routes every bf16 ``ell_gather`` and its transposes
through these, at every derivative order.  The plain versions are
``neighbors._gather_rows`` and ``neighbors._transpose_sum``; CUDA tensors
launch the kernels (or raise), CPU tensors take the plain versions.
"""

import ctypes
import math
from typing import Any, NamedTuple

import torch

from torchmdnet_tpu_torch.ops.kernels import build
from torchmdnet_tpu_torch.ops.neighbors import _gather_rows, _transpose_sum

SOURCE = "ell_gather.cu"


class _Lib(NamedTuple):
    gather: Any
    transpose: Any
    error: Any
    stream: Any  # device index -> its current stream's handle
    resources: Any


_LIB = None  # bound once, after the first build: a launch takes no lock and builds no Stream object


def _bind() -> _Lib:
    global _LIB
    if _LIB is None:
        lib = build.load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ell_gather_error_string.argtypes = [i]
        lib.ell_gather_error_string.restype = ctypes.c_char_p
        lib.ell_gather_bf16.argtypes = [p, p, ctypes.c_longlong, i, p, p]
        lib.ell_gather_bf16.restype = i
        lib.ell_transpose_sum_bf16.argtypes = [p, p, i, i, i, p, p]
        lib.ell_transpose_sum_bf16.restype = i
        lib.ell_gather_resources.argtypes = [i, i, i, i, p]
        lib.ell_gather_resources.restype = i
        _LIB = _Lib(lib.ell_gather_bf16, lib.ell_transpose_sum_bf16, lib.ell_gather_error_string,
                    torch._C._cuda_getCurrentRawStream, lib.ell_gather_resources)
    return _LIB


def _check(t, what):
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{what} takes bf16 rows, got {t.dtype}")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {t.device}")


def _launch(which, what, device, *args):
    """Launch on the current stream of ``device``, made the current device
    only where it is not already."""
    lib = _bind()
    fn, d = getattr(lib, which), device.index
    if d == torch.cuda.current_device():
        err = fn(*args, lib.stream(d))
    else:
        with torch.cuda.device(d):
            err = fn(*args, lib.stream(d))
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({lib.error(err).decode()})")


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, K, ...) = x[idx]: kernel #4 for CUDA tensors."""
    _check(x, "gather_rows")
    if x.device.type == "cpu":
        return _gather_rows(x, idx)
    x = x.contiguous()
    flat = idx.to(torch.int32).contiguous()
    out = torch.empty(tuple(idx.shape) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _launch("gather", "ell_gather", x.device, x.data_ptr(), flat.data_ptr(), flat.numel(),
            math.prod(x.shape[1:]), out.data_ptr())
    gather_rows.launches += 1
    return out


def transpose_sum_rows(g: torch.Tensor, idx: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(N, ...) slot sums of g (N, K, ...): kernel #5 for CUDA tensors."""
    _check(g, "transpose_sum_rows")
    if g.device.type == "cpu":
        return _transpose_sum(g, idx, perm)
    n, k = idx.shape
    g, perm = g.contiguous(), perm.to(torch.int32).contiguous()
    out = torch.empty((n,) + tuple(g.shape[2:]), dtype=g.dtype, device=g.device)
    _launch("transpose", "ell_transpose_sum", g.device, g.data_ptr(), perm.data_ptr(), n, k,
            math.prod(g.shape[2:]), out.data_ptr())
    transpose_sum_rows.launches += 1
    return out


def kernel_resources(kind: str, n: int, k: int, f: int) -> dict:
    """The resources of the kernel the launch plan takes for ``kind``
    ("gather": N*K rows of width ``f``; "transpose": N atoms of K slots)
    with aligned rows, from the CUDA runtime: {registers, spill_bytes (local
    memory a thread), threads, smem (a block), blocks_per_sm (resident),
    grid (blocks launched)}.  Needs a CUDA device."""
    lib = _bind()
    out = (ctypes.c_int * 6)()
    err = lib.resources(("gather", "transpose").index(kind), int(n), int(k), int(f), out)
    if err != 0:
        raise RuntimeError(f"ell_gather_resources failed: CUDA error {err} ({lib.error(err).decode()})")
    return dict(zip(("registers", "spill_bytes", "threads", "smem", "blocks_per_sm", "grid"), out))


def reset_launch_counts():
    gather_rows.launches = 0
    transpose_sum_rows.launches = 0


reset_launch_counts()
