"""Brute-force neighbor search with ordered compaction (counterpart of
torchmdnet_tpu/ops/pallas/compaction.py).

The kernel (``csrc/compaction.cu``) replaces the Pallas TPU kernel ``_kernel``
(compaction.py:31, launched by ``compact_neighbors_pallas`` at :159).  The
source file's header says what bounds it on an H100 and what its design does
about it.

``compact_neighbors(pos, batch, atom_mask, k=..., loop=...)`` returns, per
atom i, the first k atoms j within the cutoff window (same molecule, both
real, j != i) in ascending j, as ``(idx (N, k + loop) int32, mask (N, k +
loop) bool, n_neighbors (N,) int32)``: with ``loop`` the self edge comes
first (column 0: i itself, mask the atom's validity), empty slots point at
i, and ``n_neighbors`` counts every valid j != i, past k too.  ``batch``
holds molecule ids in [0, 2**31) as int64 or int32 and ``atom_mask`` is
bool: the kernel reads both as they come, so a build is one launch.  The
squared distance is the TPU kernel's difference form, ``dx*dx + dy*dy +
dz*dz`` of ``x_i - x_j`` in f32, not the Gram form of the
``strategy="brute"`` search (``ops/neighbors.py``); the two lists can differ
for a pair within float rounding of a cutoff.  The kernel and
``compact_neighbors_reference`` do the same arithmetic and agree bitwise.

CUDA tensors launch the kernel (or raise); CPU tensors take the plain version.
"""

import ctypes
from typing import Any, NamedTuple

import numpy as np
import torch

from torchmdnet_tpu_torch.ops.kernels import build
from torchmdnet_tpu_torch.ops.neighbors import _finish_rows

SOURCE = "compaction.cu"


class _Lib(NamedTuple):
    launch: Any
    error: Any
    stream: Any  # device index -> its current stream's handle
    resources: Any


_LIB = None  # bound once, after the first build: a launch takes no lock and builds no Stream object


def _bind() -> _Lib:
    global _LIB
    if _LIB is None:
        lib = build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.compaction_error_string.argtypes = [i]
        lib.compaction_error_string.restype = ctypes.c_char_p
        lib.compact_neighbors.argtypes = [p, p, i, p, i, i, i, f, f, p, p, p, p]
        lib.compact_neighbors.restype = i
        lib.compaction_resources.argtypes = [i, p]
        lib.compaction_resources.restype = i
        _LIB = _Lib(lib.compact_neighbors, lib.compaction_error_string, torch._C._cuda_getCurrentRawStream,
                    lib.compaction_resources)
    return _LIB


def _squared(c: float) -> float:
    """c * c rounded to f32, as the plain version's comparisons round it."""
    return float(np.float32(c * c))


@torch.no_grad()
def compact_neighbors_reference(pos, batch, atom_mask, *, k: int, cutoff_lower: float = 0.0,
                                cutoff_upper: float = 5.0, loop: bool = False):
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
    idx, mask = _finish_rows(first, n, k, bool(loop), atom_mask)
    return idx, mask, valid.sum(dim=1).to(torch.int32)


def _launch(pos, batch, atom_mask, k, loop, cutoff_lower, cutoff_upper, idx, mask, count):
    """One launch on the current stream of the tensors' device, made the
    current device only where it is not already."""
    lib = _bind()
    d = pos.device.index
    args = (pos.data_ptr(), batch.data_ptr(), batch.dtype == torch.int64, atom_mask.data_ptr(), pos.shape[0], k,
            loop, _squared(cutoff_lower), _squared(cutoff_upper), idx.data_ptr(), mask.data_ptr(),
            count.data_ptr())
    if d == torch.cuda.current_device():
        err = lib.launch(*args, lib.stream(d))
    else:
        with torch.cuda.device(d):
            err = lib.launch(*args, lib.stream(d))
    if err != 0:
        raise RuntimeError(f"compact_neighbors launch failed: CUDA error {err} ({lib.error(err).decode()})")


def compact_neighbors(pos, batch, atom_mask, *, k: int, cutoff_lower: float = 0.0,
                      cutoff_upper: float = 5.0, loop: bool = False):
    """(idx (N, k + loop) int32, mask (N, k + loop) bool, n_neighbors (N,)
    int32); see the module docstring."""
    k, loop = int(k), bool(loop)
    if pos.device.type == "cpu":
        return compact_neighbors_reference(pos, batch, atom_mask, k=k, cutoff_lower=cutoff_lower,
                                           cutoff_upper=cutoff_upper, loop=loop)
    if pos.device.type != "cuda":
        raise ValueError(f"compact_neighbors runs on cuda or cpu tensors, not {pos.device}")
    n = pos.shape[0]
    if pos.ndim != 2 or pos.shape[1] != 3 or tuple(batch.shape) != (n,) or tuple(atom_mask.shape) != (n,):
        raise ValueError(f"compact_neighbors takes pos (N, 3), batch (N,) and atom_mask (N,); got "
                         f"{tuple(pos.shape)}, {tuple(batch.shape)}, {tuple(atom_mask.shape)}")
    if batch.dtype not in (torch.int64, torch.int32) or atom_mask.dtype != torch.bool:
        raise ValueError(f"compact_neighbors takes int64 or int32 molecule ids and a bool atom_mask; got "
                         f"{batch.dtype}, {atom_mask.dtype}")
    if batch.device != pos.device or atom_mask.device != pos.device:
        raise ValueError(f"compact_neighbors takes its tensors on one device; got {pos.device}, {batch.device}, "
                         f"{atom_mask.device}")
    if k < 1:
        raise ValueError(f"compact_neighbors needs k >= 1, got {k}")
    p = pos.detach().float().contiguous()
    b, m = batch.contiguous(), atom_mask.contiguous()
    idx = torch.empty((n, k + loop), dtype=torch.int32, device=p.device)
    mask = torch.empty((n, k + loop), dtype=torch.bool, device=p.device)
    count = torch.empty((n,), dtype=torch.int32, device=p.device)
    _launch(p, b, m, k, loop, cutoff_lower, cutoff_upper, idx, mask, count)
    compact_neighbors.launches += 1
    return idx, mask, count


def kernel_resources(n: int) -> dict:
    """The launch plan and the kernel's resources at N atoms (int64 ids),
    from the CUDA runtime: {registers, spill_bytes (local memory a thread),
    threads, smem (a block, static and dynamic), blocks_per_sm (resident),
    grid (blocks launched), rows (a warp), stage (columns a stage)}.  Needs
    a CUDA device."""
    lib = _bind()
    out = (ctypes.c_int * 8)()
    err = lib.resources(int(n), out)
    if err != 0:
        raise RuntimeError(f"compaction_resources failed: CUDA error {err} ({lib.error(err).decode()})")
    return dict(zip(("registers", "spill_bytes", "threads", "smem", "blocks_per_sm", "grid", "rows", "stage"), out))


def reset_launch_counts():
    compact_neighbors.launches = 0


reset_launch_counts()
