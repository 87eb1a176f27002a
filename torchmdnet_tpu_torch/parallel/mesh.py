"""Rank layout (counterpart of torchmdnet_tpu/parallel/mesh.py).

The JAX package's parallelism is a ``jax.sharding.Mesh`` over the devices of
one program.  The port's is PyTorch's: one process per rank in a
``torch.distributed`` process group, each rank with its own device.  A
``Mesh`` here names that layout: the ranks of the default process group, this
process's rank and its device.  Data parallelism gives each rank its slice of
every global batch (``data/loader.py``) and sums the gradients
(``train/trainer.py``); edge partitioning gives each rank a block of the atom
rows of one large batch (``parallel/edge_partition.py``).
"""

import dataclasses
import os
import warnings
from typing import Optional

import torch


@dataclasses.dataclass
class Mesh:
    """One process's view of a 1-D rank layout along ``axis``."""

    size: int
    rank: int
    device: torch.device
    backend: str  # the process group's backend ("gloo", "nccl"; "none" for one process)
    axis: str = "dp"

    @property
    def shape(self):
        return {self.axis: self.size}

    @property
    def distributed(self) -> bool:
        return self.backend != "none"


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` if named, else ``cuda:(local_rank %
    device_count)`` (ranks share cards when there are more ranks than cards).
    Raises without a GPU unless a device is named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the ranks on the CPU explicitly"
        )
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(ndevices: int = -1, axis_name: str = "dp", allow_single: bool = False,
              device=None) -> Optional[Mesh]:
    """1-D layout over the ranks of the default process group.

    Returns None for a single rank unless ``allow_single`` (edge
    partitioning runs on a degenerate one-rank partition).  ``ndevices`` -1
    takes every rank; more ranks than the group has warns and takes the
    group, as the JAX package warns when more devices are asked for than
    exist.  A layout spans the whole group.
    """
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if ndevices is None or ndevices < 0:
        ndevices = world
    if ndevices > world:
        warnings.warn(
            f"Requested {ndevices} devices but the process group has {world} rank(s); a user expecting "
            f"sharded execution may silently get fewer. Using {world}."
        )
    elif 1 < ndevices < world:
        raise ValueError(f"a mesh spans every rank of the process group ({world}); got ndevices={ndevices}")
    if min(ndevices, world) <= 1 and not allow_single:
        return None
    backend = dist.get_backend() if initialized else "none"
    return Mesh(size=world, rank=rank, device=rank_device(device), backend=str(backend), axis=axis_name)


def make_2d_mesh(dp: int, mp: int):
    """dp x mp layout of the process group's ranks for edge-partitioned
    (model-parallel) execution: rank r at row r // mp, column r % mp.
    Returns ((row, column), dp_group, mp_group): along "mp" the mp ranks of
    this rank's row (one batch's atom rows split among them), along "dp" the
    dp ranks of its column (the same rows of different batches); the groups
    are None without a process group.  Every rank calls it (creating a group
    is collective); dp * mp must be the group's size."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if dp < 1 or mp < 1 or dp * mp != world:
        raise ValueError(f"a {dp} x {mp} mesh needs {dp * mp} ranks; the process group has {world}")
    groups = [None, None]
    if initialized:
        columns = [list(range(j, world, mp)) for j in range(mp)]
        rows = [list(range(i * mp, (i + 1) * mp)) for i in range(dp)]
        for axis, lines in enumerate((columns, rows)):
            for line in lines:
                group = dist.new_group(line)
                if rank in line:
                    groups[axis] = group
    return divmod(rank, mp), groups[0], groups[1]
