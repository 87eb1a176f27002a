"""Segment (per-molecule) reductions (counterpart of torchmdnet_tpu/ops/segment.py).

Padding atoms carry id == num_segments - 1 (a trash row the caller slices
off).  Sums go through a dense one-hot matrix product rather than
``index_add_``: on the GPU ``index_add_`` adds floats with atomics in an order
that changes from run to run, while the product is the same every run.

Under edge partitioning (``parallel/context.py``) ``x`` holds only this
rank's atoms (ids stay global): the reduction becomes a local partial
reduction whose partials every rank combines in rank order
(``parallel/edge_partition.ring_segment_reduce``).
"""

import torch

from torchmdnet_tpu_torch.parallel.context import ring_info


def segment_reduce(x, segment_ids, num_segments: int, op: str = "sum"):
    """Reduce per-atom values (N, ...) into per-segment values (num_segments, ...)."""
    info = ring_info()
    if info is not None:
        from torchmdnet_tpu_torch.parallel.edge_partition import ring_segment_reduce

        return ring_segment_reduce(x, segment_ids, num_segments, op, info.mesh)
    return local_segment_reduce(x, segment_ids, num_segments, op)


def local_segment_reduce(x, segment_ids, num_segments: int, op: str = "sum"):
    """``segment_reduce`` of these rows alone, whatever the scope."""
    if op == "max":
        shape = (num_segments,) + tuple(x.shape[1:])
        out = torch.full(shape, float("-inf"), dtype=x.dtype, device=x.device)
        index = segment_ids.long().reshape((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
        return out.scatter_reduce(0, index, x, "amax", include_self=True)
    if op not in ("sum", "add", "mean"):
        raise ValueError(f"Unknown reduce op: {op}")
    onehot = (
        segment_ids.long()[None, :]
        == torch.arange(num_segments, device=x.device)[:, None]
    ).to(x.dtype)
    total = (onehot @ x.reshape(x.shape[0], -1)).reshape((num_segments,) + tuple(x.shape[1:]))
    if op == "mean":
        count = onehot.sum(dim=1).clamp_min(1.0)
        return total / count.reshape((num_segments,) + (1,) * (x.ndim - 1))
    return total
