"""Edge-partitioned execution scope (counterpart of torchmdnet_tpu/parallel/context.py).

Under edge partitioning (``parallel/edge_partition.py``) every rank holds one
block of atom rows, and the models run UNCHANGED on those rows: the ops that
move data across atoms consult the scope set here while the model runs.

- ``ops.neighbors.ell_gather`` / ``ell_transpose_sum``: a list whose
  transpose permutation is a ``ShardPlan`` (its rows carry GLOBAL atom ids)
  gathers the rows of other ranks through a per-owner exchange of boundary
  rows, and its transpose sums each local atom's K slots, local and
  received, in the order of the global transpose permutation;
- ``ops.segment.segment_reduce``: a local partial reduction, then the
  partials of every rank summed (or maxed) in rank order;
- ``ops.neighbors.neighbor_list``: a pair prior's build returns the matching
  PREBUILT global list (this rank's rows, global ids), so ZBL, D2 and
  Coulomb run unmodified.

The scope is set by the executor around one model call and cleared after it.
This module imports nothing but the standard library and torch.
"""

import dataclasses
from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch

_RING: Optional["RingInfo"] = None
_CAPTURE: Optional[list] = None


@dataclasses.dataclass(eq=False)
class ShardPlan:
    """One rank's exchange plan for one neighbor list (rows [rank * n_local,
    (rank + 1) * n_local) of a global (N, K) list).

    Gather (``out[i, k] = x_global[idx[i, k]]``): the rank's rows of x, then
    the ghost rows it receives from each owner in rank order, form an
    extended table that ``lidx`` indexes.

    Transpose (``dx[j] = sum of g over the global slots pointing at j``): the
    rank's flat slots, then the slots it receives from each receiver's owner
    in rank order, form an extended slot table that ``perm_ext`` indexes:
    row j of ``perm_ext.reshape(n_local, K)`` lists the K slots of the global
    transpose permutation's group for atom j, in that group's order.

    Receiver ghosts (the fused source passes): whole receiver rows (their K
    slots) that another rank's atoms are sources of; ``perm_rx`` indexes the
    slots of [local receivers | ghost receivers].  None for a derived list.
    """

    mesh: object
    n_local: int
    k: int
    lidx: torch.Tensor  # (n_local, K) int32
    src_send: List[torch.Tensor]  # per peer: local rows it needs (int64)
    src_recv: List[int]  # per peer: rows received from it
    perm_ext: torch.Tensor  # (n_local * K,) int64
    slot_send: List[torch.Tensor]  # per peer: local flat slots it needs
    slot_recv: List[int]
    rx_send: Optional[List[torch.Tensor]] = None  # per peer: local receiver rows
    rx_recv: Optional[List[int]] = None
    perm_rx: Optional[torch.Tensor] = None  # (n_local * K,) int32

    @property
    def ghost_rows(self) -> int:
        return sum(self.src_recv)

    def without_self_loops(self) -> "ShardPlan":
        """The plan of the list without its self-loop column 0.  Self slots
        are local, so the ghost sources and the received slots stay the same;
        slot (i, c) becomes (i, c - 1) and each atom's group drops its one
        column-0 slot."""
        n, k = self.n_local, self.k
        local_slots = n * k
        groups = self.perm_ext.reshape(n, k)
        local = groups < local_slots
        keep = ~(local & (groups % k == 0))
        order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, : k - 1]
        g = torch.gather(groups, 1, order)
        g = torch.where(g < local_slots, (g // k) * (k - 1) + g % k - 1, g - local_slots + n * (k - 1))
        return ShardPlan(
            mesh=self.mesh, n_local=n, k=k - 1, lidx=self.lidx[:, 1:].contiguous(),
            src_send=self.src_send, src_recv=self.src_recv, perm_ext=g.reshape(-1).contiguous(),
            slot_send=[(s // k) * (k - 1) + s % k - 1 for s in self.slot_send],
            slot_recv=self.slot_recv,
        )


@dataclasses.dataclass
class RingInfo:
    """The scope of one partitioned model call.

    Attributes:
        mesh: the ``parallel.mesh.Mesh`` the atom rows are sharded over.
        prior_lists: ((signature, local NeighborList), ...) of the pair
            priors' prebuilt lists; the signature is (k, cutoff_lower,
            cutoff_upper, loop) of the prior's ``neighbor_list`` call.
    """

    mesh: object
    prior_lists: Tuple = ()

    def match_build(self, sig):
        for s, nbl in self.prior_lists:
            if s == sig:
                return nbl
        return None


def ring_info() -> Optional[RingInfo]:
    return _RING


@contextmanager
def ring_scope(info: Optional[RingInfo]):
    """Set the partition scope (None clears it) for the block's duration."""
    global _RING
    prev, _RING = _RING, info
    try:
        yield
    finally:
        _RING = prev


@contextmanager
def capture_neighbor_builds():
    """Record every ``neighbor_list`` call made in the block as (signature,
    NeighborList), in call order (the executor's probe of the pair priors'
    global lists)."""
    global _CAPTURE
    prev, _CAPTURE = _CAPTURE, []
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = prev


def record_build(sig, nbl):
    if _CAPTURE is not None:
        _CAPTURE.append((sig, nbl))
