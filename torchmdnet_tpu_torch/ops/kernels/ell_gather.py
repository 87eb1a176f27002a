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

import torch

from torchmdnet_tpu_torch.ops.kernels import build
from torchmdnet_tpu_torch.ops.neighbors import _gather_rows, _transpose_sum

SOURCE = "ell_gather.cu"

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.ell_gather_error_string.argtypes = [ctypes.c_int]
        lib.ell_gather_error_string.restype = ctypes.c_char_p
        lib.ell_gather_bf16.argtypes = [_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P]
        lib.ell_gather_bf16.restype = ctypes.c_int
        lib.ell_transpose_sum_bf16.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P]
        lib.ell_transpose_sum_bf16.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check(t, what):
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{what} takes bf16 rows, got {t.dtype}")


def _launch(fn, what, device, *args):
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, _P(stream))
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.ell_gather_error_string(err).decode()})")


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, K, ...) = x[idx]: kernel #4 for CUDA tensors."""
    _check(x, "gather_rows")
    if x.device.type == "cpu":
        return _gather_rows(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu tensors, not {x.device}")
    x2 = x.reshape(x.shape[0], -1).contiguous()
    flat = idx.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty((flat.numel(), x2.shape[1]), dtype=x.dtype, device=x.device)
    _launch("ell_gather_bf16", "ell_gather", x.device, _P(x2.data_ptr()), _P(flat.data_ptr()),
            flat.numel(), x2.shape[1], _P(out.data_ptr()))
    gather_rows.launches += 1
    return out.reshape(tuple(idx.shape) + tuple(x.shape[1:]))


def transpose_sum_rows(g: torch.Tensor, idx: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(N, ...) slot sums of g (N, K, ...): kernel #5 for CUDA tensors."""
    _check(g, "transpose_sum_rows")
    if g.device.type == "cpu":
        return _transpose_sum(g, idx, perm)
    if g.device.type != "cuda":
        raise ValueError(f"transpose_sum_rows runs on cuda or cpu tensors, not {g.device}")
    n, k = idx.shape
    g2 = g.reshape(n * k, -1).contiguous()
    perm = perm.to(torch.int32).contiguous()
    out = torch.empty((n, g2.shape[1]), dtype=g.dtype, device=g.device)
    _launch("ell_transpose_sum_bf16", "ell_transpose_sum", g.device, _P(g2.data_ptr()),
            _P(perm.data_ptr()), n, k, g2.shape[1], _P(out.data_ptr()))
    transpose_sum_rows.launches += 1
    return out.reshape((n,) + tuple(g.shape[2:]))


def reset_launch_counts():
    gather_rows.launches = 0
    transpose_sum_rows.launches = 0


reset_launch_counts()
