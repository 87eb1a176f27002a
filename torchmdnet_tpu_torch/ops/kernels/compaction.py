"""Brute-force neighbor search with ordered compaction (counterpart of
torchmdnet_tpu/ops/pallas/compaction.py).

The kernel (``csrc/compaction.cu``) replaces the Pallas TPU kernel ``_kernel``
(compaction.py:31, launched by ``compact_neighbors_pallas`` at :159).  The
source file's header says what bounds it on an H100 and what its design does
about it.

``compact_neighbors(pos, batch, atom_mask, k=..., ...)`` returns, per atom i,
the first k atoms j within the cutoff window (same molecule, both real, j !=
i) in ascending j, as ``(idx (N, k) int32, mask (N, k) bool, n_neighbors (N,)
int32)``: empty slots point at i, ``n_neighbors`` counts past k.  The squared
distance is the TPU kernel's difference form, ``dx*dx + dy*dy + dz*dz`` of
``x_i - x_j`` in f32, not the Gram form of the ``strategy="brute"`` search
(``ops/neighbors.py``); the two lists can differ for a pair within float
rounding of a cutoff.  The kernel and ``compact_neighbors_reference`` do the
same arithmetic and agree bitwise.

CUDA tensors launch the kernel (or raise); CPU tensors take the plain version.
"""

import ctypes

import torch

from torchmdnet_tpu_torch.ops.kernels import build
from torchmdnet_tpu_torch.ops.neighbors import _finish_rows

SOURCE = "compaction.cu"


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.compaction_error_string.argtypes = [ctypes.c_int]
        lib.compaction_error_string.restype = ctypes.c_char_p
        lib.compact_neighbors.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 4
        )
        lib.compact_neighbors.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


@torch.no_grad()
def compact_neighbors_reference(pos, batch, atom_mask, *, k: int, cutoff_lower: float = 0.0,
                                cutoff_upper: float = 5.0):
    """Plain PyTorch version: the (N, N) squared distances in the kernel's
    arithmetic (each op rounded once in f32), the validity mask, and the k
    smallest valid column ids per row."""
    p = pos.detach().float()
    n = p.shape[0]
    dx = p[:, None, 0] - p[None, :, 0]
    dy = p[:, None, 1] - p[None, :, 1]
    dz = p[:, None, 2] - p[None, :, 2]
    d2 = dx * dx + dy * dy + dz * dz
    ar = torch.arange(n, device=p.device)
    valid = (
        (d2 < cutoff_upper * cutoff_upper) & (d2 >= cutoff_lower * cutoff_lower)
        & (batch[:, None] == batch[None, :]) & atom_mask[:, None] & atom_mask[None, :]
        & (ar[:, None] != ar[None, :])
    )
    key = torch.where(valid, ar[None, :], n)
    first = torch.topk(key, min(k, n), dim=1, largest=False, sorted=True).values
    idx, mask = _finish_rows(first, n, k, False, atom_mask)
    return idx, mask, valid.sum(dim=1).to(torch.int32)


def compact_neighbors(pos, batch, atom_mask, *, k: int, cutoff_lower: float = 0.0,
                      cutoff_upper: float = 5.0):
    """(idx (N, k) int32, mask (N, k) bool, n_neighbors (N,) int32); see the
    module docstring.  ``batch`` holds molecule ids >= 0."""
    k = int(k)
    if pos.device.type == "cpu":
        return compact_neighbors_reference(pos, batch, atom_mask, k=k, cutoff_lower=cutoff_lower,
                                           cutoff_upper=cutoff_upper)
    if pos.device.type != "cuda":
        raise ValueError(f"compact_neighbors runs on cuda or cpu tensors, not {pos.device}")
    n = pos.shape[0]
    if pos.ndim != 2 or pos.shape[1] != 3 or tuple(batch.shape) != (n,) or tuple(atom_mask.shape) != (n,):
        raise ValueError(f"compact_neighbors takes pos (N, 3), batch (N,) and atom_mask (N,); got "
                         f"{tuple(pos.shape)}, {tuple(batch.shape)}, {tuple(atom_mask.shape)}")
    if k < 1:
        raise ValueError(f"compact_neighbors needs k >= 1, got {k}")
    dev = pos.device
    p = pos.detach().float().contiguous()
    b = batch.to(device=dev, dtype=torch.int32).contiguous()
    m = atom_mask.to(device=dev, dtype=torch.bool).contiguous()
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    mask = torch.empty((n, k), dtype=torch.bool, device=dev)
    count = torch.empty((n,), dtype=torch.int32, device=dev)
    # the squared cutoffs as the plain version's comparisons round them
    cl2 = float(torch.tensor(cutoff_lower * cutoff_lower, dtype=torch.float32))
    cu2 = float(torch.tensor(cutoff_upper * cutoff_upper, dtype=torch.float32))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.compact_neighbors(
            ctypes.c_void_p(p.data_ptr()), ctypes.c_void_p(b.data_ptr()), ctypes.c_void_p(m.data_ptr()),
            n, k, cl2, cu2, ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(mask.data_ptr()),
            ctypes.c_void_p(count.data_ptr()), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"compact_neighbors launch failed: CUDA error {err} "
                           f"({lib.compaction_error_string(err).decode()})")
    compact_neighbors.launches += 1
    return idx, mask, count


compact_neighbors.launches = 0


def reset_launch_counts():
    compact_neighbors.launches = 0
