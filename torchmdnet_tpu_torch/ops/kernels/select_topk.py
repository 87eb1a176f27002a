"""Per-row k-smallest selection (counterpart of torchmdnet_tpu/ops/pallas/select_topk.py).

The kernel (``csrc/select_topk.cu``) replaces the Pallas TPU kernel
``_kernel`` (select_topk.py:32).  The source file's header says what bounds it
on an H100 and what its design does about it.

``select_topk(keys, k, sentinel)`` keeps, per row of ``keys`` (N, W) int32,
the k smallest entries in ascending order; slots past a row's real keys hold
``sentinel``.  Real keys of a row are unique and below ``sentinel``; every
other entry equals ``sentinel`` (the cell list's candidate keys are so).  The
result is integers, so the kernel and ``select_topk_reference`` agree bitwise.

CUDA tensors launch the kernel (or raise); CPU tensors take the plain version.
"""

import ctypes

import torch

from torchmdnet_tpu_torch.ops.kernels import build

SOURCE = "select_topk.cu"


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.select_topk_error_string.argtypes = [ctypes.c_int]
        lib.select_topk_error_string.restype = ctypes.c_char_p
        lib.select_topk.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.select_topk.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def select_topk_reference(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: sort each row, keep the first k columns."""
    return torch.sort(keys, dim=1).values[:, :k].contiguous()


def _check(keys: torch.Tensor, k: int, sentinel: int):
    if keys.dtype != torch.int32:
        raise ValueError(f"select_topk takes int32 keys, got {keys.dtype}")
    if keys.ndim != 2:
        raise ValueError(f"select_topk takes (N, W) keys, got shape {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("select_topk takes contiguous keys")
    if not 1 <= k <= keys.shape[1]:
        raise ValueError(f"select_topk needs 1 <= k <= W, got k={k}, W={keys.shape[1]}")
    if not -(2**31) < sentinel < 2**31:
        raise ValueError(f"sentinel {sentinel} is not an int32")


def select_topk(keys: torch.Tensor, k: int, sentinel: int) -> torch.Tensor:
    """(N, k) int32: each row's k smallest keys, ascending, sentinel-filled."""
    k, sentinel = int(k), int(sentinel)
    _check(keys, k, sentinel)
    if keys.device.type == "cpu":
        return select_topk_reference(keys, k)
    if keys.device.type != "cuda":
        raise ValueError(f"select_topk runs on cuda or cpu tensors, not {keys.device}")
    lib = _lib()
    n, w = keys.shape
    out = torch.empty((n, k), dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.select_topk(
            ctypes.c_void_p(keys.data_ptr()), n, w, k, sentinel,
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"select_topk launch failed: CUDA error {err} "
            f"({lib.select_topk_error_string(err).decode()})"
        )
    select_topk.launches += 1
    return out


select_topk.launches = 0
