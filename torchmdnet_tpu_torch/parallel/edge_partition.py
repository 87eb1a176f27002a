"""Edge-partitioned execution of one large molecular graph across ranks
(counterpart of torchmdnet_tpu/parallel/edge_partition.py).

With the ELL layout, partitioning the ATOM axis partitions the edges with it:
rank r owns rows [r * N/D, (r + 1) * N/D) of the neighbor list, so every edge
whose RECEIVER lives on r.  The unchanged model runs on each rank's rows
(``parallel/context.py`` routes the cross-atom ops):

1. a gather reads its local rows, plus the GHOST rows (sources owned by
   another rank) that the rank receives from each owner in one exchange of
   boundary rows (``all_to_all_single``);
2. its gradient, the transpose-sum, sums each local atom's K slots in the
   order of the GLOBAL list's transpose permutation: the local slots in
   place, the boundary slots received from their receivers' ranks.  The list
   is symmetric, so this is the single-process ``ell_transpose_sum`` of
   those rows, scatter-free, with the same sums in the same order;
3. per-molecule reductions sum every rank's partials in rank order.

No rank holds an (N, H) feature table: a rank's features are its N/D rows
plus its ghost rows, a surface term for a spatially sorted batch
(``data.batch.spatial_sort``).  The global neighbor list, (N, K) integers,
is built on every rank at the rebuild cadence (each rank builds the same
list from the same positions) and each rank keeps its rows and its plan.
The JAX package streams source chunks round a ring with ``ppermute``
(edge_partition.py:251, 300) to overlap transfer with compute; the port
exchanges only the boundary rows, once per gather, which bounds memory the
same way.

ET's fused edge phase runs its kernels (#1, #2) on each rank's receiver rows
(``ops/kernels/et_message.py``): the forward reads an extended source table
(local rows, then ghosts), and the backward's source pass reads extended
receiver tables (local receivers, then the ghost receivers whose slots point
at this rank's atoms, shipped with their slot data).

The JAX names stay (``make_ring_plan``, ``RingExecutor``, ``ring_apply``)
so each function has its obvious counterpart.
"""

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from torchmdnet_tpu_torch.parallel.context import (
    RingInfo,
    ShardPlan,
    capture_neighbor_builds,
    ring_scope,
)
from torchmdnet_tpu_torch.parallel.distributed import all_gather_stack, all_to_all_rows, sum_in_rank_order


def _rows(mesh, n: int) -> slice:
    if n % mesh.size:
        raise ValueError(f"padded atom count {n} must divide over {mesh.size} ranks")
    nl = n // mesh.size
    return slice(mesh.rank * nl, (mesh.rank + 1) * nl)


def shard_batch_by_atoms(batch, mesh):
    """This rank's rows of every atom-indexed tensor of ``batch`` (molecule-
    indexed ones are kept whole).  The padded atom count must divide over the
    ranks (``pad_molecules``' capacity, or ``External``-style padding)."""
    n = batch.num_atoms
    rows = _rows(mesh, n)
    return batch.map_tensors(lambda t: t[rows] if t.shape[:1] == (n,) else t)


def gather_atom_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of an atom-indexed tensor, in rank order (the whole
    (N, ...) tensor on every rank: for checks and outputs, not the model)."""
    parts = all_gather_stack(mesh, t)
    return parts.reshape((-1,) + tuple(t.shape[1:]))


# --- the exchange plan ------------------------------------------------------


def ring_boundary_counts(idx, mask, mesh) -> torch.Tensor:
    """(D, D) boundary-edge counts of a global list: row = receiver rank,
    column = source owner (valid slots whose source lives on another rank).
    Every rank computes it from the global list, without communication."""
    n, _ = idx.shape
    d = mesh.size
    nl = n // d
    owner = idx.long() // nl
    recv = torch.arange(n, device=idx.device)[:, None] // nl
    key = torch.where(mask.bool() & (owner != recv), recv * d + owner, torch.full_like(owner, d * d))
    return torch.bincount(key.reshape(-1), minlength=d * d + 1)[: d * d].reshape(d, d)


def make_ring_plan(idx, mesh, perm=None, receivers: bool = True) -> ShardPlan:
    """This rank's exchange plan for a global (N, K) list (``ShardPlan``).

    ``perm`` is the global ``transpose_perm(idx)`` (computed when None; it
    raises for a list that is not symmetric, i.e. one truncated at its
    capacity).  ``receivers`` adds the ghost-receiver tables that the fused
    ET source pass reads.
    """
    from torchmdnet_tpu_torch.ops.neighbors import transpose_perm

    n, k = idx.shape
    d, r = mesh.size, mesh.rank
    rows = _rows(mesh, n)
    nl, lo = rows.stop - rows.start, rows.start
    g = idx.long()
    owner = g // nl
    empty = g.new_empty(0)

    def block(t, p):
        return t[p * nl:(p + 1) * nl]

    def sources_of(p, o):  # sorted ids owned by o among rank p's rows
        return torch.unique(block(g, p)[block(owner, p) == o])

    mine = [sources_of(r, o) if o != r else empty for o in range(d)]
    ghosts = torch.cat(mine)  # ascending: owners in rank order, ids in order
    loc = g[rows]
    remote = owner[rows] != r
    pos = torch.searchsorted(ghosts, loc.reshape(-1)).reshape(loc.shape) if ghosts.numel() else loc * 0
    lidx = torch.where(remote, nl + pos, loc - lo).to(torch.int32).contiguous()
    src_send = [sources_of(p, r) - lo if p != r else empty for p in range(d)]

    if perm is None:
        perm = transpose_perm(idx)
    pm = perm.long().reshape(n, k)

    def group(p):  # rank p's atoms' slot groups, flat global slots
        return block(pm, p).reshape(-1)

    gr = group(r)
    rown = (gr // k) // nl
    rem = rown != r
    ext = gr - lo * k
    rem_at = torch.nonzero(rem).squeeze(1)
    order = torch.argsort(rown[rem_at], stable=True)
    ext[rem_at[order]] = nl * k + torch.arange(rem_at.numel(), device=g.device)
    slot_recv = torch.bincount(rown[rem], minlength=d).tolist()
    slot_send = []
    for p in range(d):
        gp = group(p) if p != r else empty
        slot_send.append(gp[(gp // k) // nl == r] - lo * k)

    rx_send = rx_recv = perm_rx = None
    if receivers:
        recv_ids = torch.unique(gr[rem] // k)
        at = torch.searchsorted(recv_ids, gr // k) if recv_ids.numel() else gr * 0
        perm_rx = torch.where(rem, (nl + at) * k + gr % k, gr - lo * k).to(torch.int32).contiguous()
        rx_recv = torch.bincount(recv_ids // nl, minlength=d).tolist()
        rx_send = []
        for p in range(d):
            ip = group(p) // k if p != r else empty
            rx_send.append(torch.unique(ip[ip // nl == r]) - lo)
    return ShardPlan(
        mesh=mesh, n_local=nl, k=k, lidx=lidx, src_send=src_send,
        src_recv=[m.numel() for m in mine], perm_ext=ext.contiguous(), slot_send=slot_send,
        slot_recv=slot_recv, rx_send=rx_send, rx_recv=rx_recv, perm_rx=perm_rx,
    )


def shard_list(nbl, mesh, plan: ShardPlan):
    """This rank's rows of a global NeighborList, with ``plan`` as its
    transpose permutation (so every op on it takes the partitioned route)."""
    from torchmdnet_tpu_torch.ops.neighbors import NeighborList

    rows = _rows(mesh, nbl.num_atoms)
    return NeighborList(
        idx=nbl.idx[rows], mask=nbl.mask[rows], n_neighbors=nbl.n_neighbors[rows],
        self_loops=nbl.self_loops, cell_overflow=nbl.cell_overflow, _perm=plan,
    )


# --- the cross-rank gather and its transpose ----------------------------------


def ghost_rows(x: torch.Tensor, plan: ShardPlan) -> torch.Tensor:
    """The ghost rows of ``x`` (this rank's rows of an atom table) that this
    rank receives, owners in rank order: one exchange."""
    sends = [x.index_select(0, s) for s in plan.src_send]
    return all_to_all_rows(plan.mesh, sends, plan.src_recv)


def _gather_impl(x, plan):
    from torchmdnet_tpu_torch.ops.neighbors import _gather_rows

    ext = torch.cat([x, ghost_rows(x, plan)])
    if x.dtype == torch.bfloat16:  # kernel #4 on the card
        from torchmdnet_tpu_torch.ops.kernels import ell_gather as kernels

        return kernels.gather_rows(ext, plan.lidx)
    return _gather_rows(ext, plan.lidx)


def _transpose_impl(g, plan):
    nl, k = plan.n_local, plan.k
    trail = tuple(g.shape[2:])
    flat = g.reshape((nl * k,) + trail)
    sends = [flat.index_select(0, s) for s in plan.slot_send]
    ext = torch.cat([flat, all_to_all_rows(plan.mesh, sends, plan.slot_recv)])
    if g.dtype == torch.bfloat16 and g.device.type == "cuda":  # kernel #5
        from torchmdnet_tpu_torch.ops.kernels import ell_gather as kernels

        return kernels.transpose_sum_rows(ext.reshape((ext.shape[0], 1) + trail), plan.lidx, plan.perm_ext)
    # low-precision cotangents accumulate the K-axis sum in f32, as ell_transpose_sum
    acc = torch.float32 if g.dtype in (torch.bfloat16, torch.float16) else g.dtype
    out = ext.reshape(ext.shape[0], -1).index_select(0, plan.perm_ext).reshape(nl, k, -1).sum(dim=1, dtype=acc)
    return out.to(g.dtype).reshape((nl,) + trail)


class _ShardGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _gather_impl(x, plan)

    @staticmethod
    def backward(ctx, g):
        return _ShardTransposeSum.apply(g.contiguous(), ctx.plan), None


class _ShardTransposeSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, plan):
        ctx.plan = plan
        return _transpose_impl(g, plan)

    @staticmethod
    def backward(ctx, c):
        return _ShardGather.apply(c.contiguous(), ctx.plan), None


def ring_ell_gather(x, plan: ShardPlan):
    """``ell_gather`` of this rank's rows ``x`` on a partitioned list:
    out[i, k] = x_global[idx[i, k]].  Its gradient is ``ring_ell_transpose``
    and the other way round, so every derivative order stays partitioned and
    scatter-free."""
    return _ShardGather.apply(x, plan)


def ring_ell_transpose(g, plan: ShardPlan):
    """``ell_transpose_sum`` on a partitioned list: dx[j] = the sum of g over
    the global slots pointing at this rank's atom j, in the global transpose
    permutation's order."""
    return _ShardTransposeSum.apply(g, plan)


class _RankPartials(torch.autograd.Function):
    """(D, ...) every rank's partial in rank order; the gradient of a rank's
    own partial is its row of the cotangent (every rank computes the same
    function of the stacked partials)."""

    @staticmethod
    def forward(ctx, part, mesh):
        ctx.rank = mesh.rank
        return all_gather_stack(mesh, part)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


def ring_segment_reduce(x, segment_ids, num_segments: int, op: str, mesh):
    """Two-stage per-molecule readout: a local partial reduction, then the
    partials of every rank combined in rank order (replicated on every
    rank)."""
    from torchmdnet_tpu_torch.ops.segment import local_segment_reduce

    if op not in ("sum", "add", "mean", "max"):
        raise ValueError(f"Unknown reduce op: {op}")
    part = local_segment_reduce(x, segment_ids, num_segments, "max" if op == "max" else "sum")
    parts = _RankPartials.apply(part, mesh)
    if op == "max":
        return parts.amax(dim=0)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    if op != "mean":
        return total
    ones = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    count = sum_in_rank_order(mesh, local_segment_reduce(ones, segment_ids, num_segments, "sum")).clamp_min(1.0)
    return total / count.reshape((num_segments,) + (1,) * (x.ndim - 1))


def two_stage_molecular_reduce(per_atom, batch_ids, num_mol: int, mesh):
    """Edge-partitioned readout of this rank's per-atom values: (num_mol, ...)
    per-molecule sums, replicated (padding atoms carry id num_mol)."""
    return ring_segment_reduce(per_atom, batch_ids, num_mol + 1, "sum", mesh)[:num_mol]


def sharded_gather_aggregate(x, idx, mask, w, mesh):
    """Explicit reference of one partitioned aggregation, out[i] = sum_k
    mask[i, k] * x[idx[i, k]] * w[i, k] on this rank's rows: all-gather x
    (the full (N, H) table, which the partitioned path never builds), then a
    local gather and masked weighted sum."""
    full = gather_atom_rows(mesh, x)
    msg = full[idx.long()] * w[..., None]
    return torch.where(mask[..., None], msg, torch.zeros_like(msg)).sum(dim=1)


# --- accounting -------------------------------------------------------------


class RingCommStats(NamedTuple):
    """One rank's exchange per gather of a partitioned list.

    The port ships each ghost row once per gather (no ring hops), so the
    bytes a rank receives are its ghost rows times the row width; the
    boundary edges are the slots those rows feed."""

    d: int  # ranks
    rank: int
    n_local: int  # atom rows resident on the rank
    row_bytes: int  # bytes per exchanged row
    ghost_rows: int  # rows received per gather
    bytes_received: int  # ghost_rows * row_bytes
    edges_total: int  # valid slots of the rank's rows
    edges_boundary: int  # valid slots with a source on another rank
    boundary_fraction: float


def ring_comm_stats(idx, mask, mesh, row_bytes: int = 0, plan: Optional[ShardPlan] = None) -> RingCommStats:
    """This rank's exchange of a list: ``idx``/``mask`` the global list, or
    this rank's rows of it with its ``plan`` (``row_bytes``: the widest row
    a layer moves, e.g. 7H * 2 for ET's fused bf16 source rows)."""
    if plan is None:
        plan = make_ring_plan(idx, mesh, receivers=False)
    nl = plan.n_local
    if idx.shape[0] != nl:
        rows = _rows(mesh, idx.shape[0])
        idx, mask = idx[rows], mask[rows]
    boundary = mask.bool() & (idx.long() // nl != mesh.rank)
    edges_total, edges_boundary = int(mask.sum()), int(boundary.sum())
    return RingCommStats(
        d=mesh.size, rank=mesh.rank, n_local=nl, row_bytes=int(row_bytes),
        ghost_rows=plan.ghost_rows, bytes_received=plan.ghost_rows * int(row_bytes),
        edges_total=edges_total, edges_boundary=edges_boundary,
        boundary_fraction=edges_boundary / edges_total if edges_total else 0.0,
    )


# --- the executor -------------------------------------------------------------


@dataclasses.dataclass
class RingContext:
    """One partitioned configuration: this rank's rows of the model's list and
    of each pair prior's (with their plans), and ``overflow``, a bool tensor
    that folds every capacity violation (the model's and the priors' K, their
    cells, a boundary over its capacity).  Rebuilt at the MD rebuild
    cadence."""

    nbl: object
    priors: Tuple = ()  # ((signature, local NeighborList), ...)
    overflow: Optional[torch.Tensor] = None


def _cap(c: int) -> int:
    return max(256, -(-int(c) // 256) * 256)


class RingExecutor:
    """Reusable edge-partitioned execution of one Potential over a mesh.

    Every rank constructs it with the same model and calls ``build`` with the
    same global batch (the same positions); ``energy`` and
    ``energy_and_forces`` then take this rank's rows (``shard``).  Boundary
    capacities are set at construction (``sized_ring_executor`` measures them
    once); a build whose boundary exceeds them sets ``RingContext.overflow``,
    as a neighbor capacity overflow does.
    """

    def __init__(self, model, mesh, boundary_capacity: int = 2048, prior_caps=None, box=None,
                 cell_kwargs=None):
        self.model = model
        self.mesh = mesh
        self.d = mesh.size
        self.cap = _cap(boundary_capacity)
        self.box = box
        self._cell_kwargs = {k: v for k, v in (cell_kwargs or {}).items() if k in ("cell_capacity", "max_cells")}
        self._fused = bool(model.args.get("fused_attention") or model.args.get("fused_message"))
        self._sigs = None
        self.prior_caps = None if prior_caps is None else tuple(_cap(c) for c in prior_caps)

    def _prior_lists(self, batch):
        """[(signature, global NeighborList)] of every pair prior's own list,
        in call order."""
        found = []
        for prior in self.model.module.priors:
            with capture_neighbor_builds() as rec:
                prior.build_neighbor_list(batch.pos, batch.batch, batch.atom_mask)
            found.extend(rec)
        return found

    def build(self, batch, nbl=None, skin: float = 0.0, strategy: str = "auto", **cell_kwargs) -> RingContext:
        """The global lists (every rank builds the same), this rank's rows and
        plans, and the overflow flag.  ``batch`` is the global batch."""
        n = batch.num_atoms
        _rows(self.mesh, n)
        if nbl is None:
            kw = {**self._cell_kwargs, **cell_kwargs}
            for key in ("gather_plan", "plan_block_rows", "plan_width", "plan_inv_capacity"):
                kw.pop(key, None)
            nbl = self.model.neighbors(batch, box=self.box, skin=skin, strategy=strategy, **kw)
        counts = ring_boundary_counts(nbl.idx, nbl.mask, self.mesh)
        over = nbl.overflow() | (counts.max() > self.cap)
        if nbl.cell_overflow is not None:
            over = over | nbl.cell_overflow
        plan = make_ring_plan(nbl.idx, self.mesh, receivers=self._fused)
        local = shard_list(nbl, self.mesh, plan)
        found = self._prior_lists(batch)
        sigs = tuple(s for s, _ in found)
        if self._sigs is None:
            self._sigs = sigs
        elif sigs != self._sigs:
            raise ValueError(f"the pair priors' list signatures changed: {sigs} != {self._sigs}")
        caps = self.prior_caps or tuple(self.cap for _ in found)
        priors = []
        for (sig, pn), cap in zip(found, caps):
            pcounts = ring_boundary_counts(pn.idx, pn.mask, self.mesh)
            over = over | pn.overflow() | (pcounts.max() > cap)
            if pn.cell_overflow is not None:
                over = over | pn.cell_overflow
            pplan = make_ring_plan(pn.idx, self.mesh, receivers=False)
            priors.append((sig, shard_list(pn, self.mesh, pplan)))
        return RingContext(nbl=local, priors=tuple(priors), overflow=over)

    def shard(self, batch):
        return shard_batch_by_atoms(batch, self.mesh)

    def energy(self, batch, ctx: RingContext, refine=None):
        """Per-molecule energies (M, ...) from this rank's rows ``batch``,
        replicated on every rank.  ``refine`` = (cutoff_lower, cutoff_upper)
        re-applies the true cutoff to a skin-built list (Verlet-skin MD); the
        neighbor positions ride the exchange."""
        info = RingInfo(mesh=self.mesh, prior_lists=ctx.priors)
        nbl = ctx.nbl
        with ring_scope(info):
            if refine is not None:
                nbl = nbl.refine(batch.pos, refine[0], refine[1], self.box)
            return self.model.module(batch, self.box, nbl)

    def energy_and_forces(self, batch, ctx: RingContext, refine=None, create_graph: bool = False):
        """(energies (M, 1), this rank's forces (N/D, 3)): forces = -dE/dpos by
        autograd through the partitioned gathers.  A force-loss gradient
        through them (``create_graph``) is the next slice's."""
        pos = batch.pos.detach().requires_grad_(True)
        with torch.enable_grad():
            y = self.energy(batch.replace(pos=pos), ctx, refine)
            (grad,) = torch.autograd.grad(y.sum(), pos, create_graph=create_graph)
        if create_graph:
            return y, -grad
        return y.detach(), -grad


def sized_ring_executor(model, batch, mesh, nbl=None, boundary_limit: int = 65536, headroom: float = 1.5,
                        box=None, cell_kwargs=None) -> RingExecutor:
    """A RingExecutor whose capacities are the boundary counts measured on an
    example (global) batch times ``headroom``.  Raises when a capacity would
    exceed ``boundary_limit``."""

    def sized(idx, mask, what):
        need = int(ring_boundary_counts(idx, mask, mesh).max())
        cap = max(256, int(need * headroom))
        if cap > boundary_limit:
            raise ValueError(
                f"Ring boundary capacity {cap} (measured max {need} {what} per (rank, source-owner) pair "
                f"x{headroom} headroom) exceeds boundary_limit={boundary_limit}. Raise the limit, or "
                "spatially sort the batch (data.batch.spatial_sort) so cross-rank edges stay a surface term."
            )
        return cap

    if nbl is None:
        nbl = model.neighbors(batch, box=box, **(cell_kwargs or {}))
        if nbl.cell_overflow is not None and bool(nbl.cell_overflow):
            raise ValueError(
                "sized_ring_executor: the sizing neighbor list cell-overflowed; boundary capacities would be "
                "sized from a truncated list. Pass probed cell_kwargs (probe_cell_kwargs)."
            )
    cap = sized(nbl.idx, nbl.mask, "boundary edges")
    ex = RingExecutor(model, mesh, boundary_capacity=cap, box=box, cell_kwargs=cell_kwargs)
    ex.prior_caps = tuple(_cap(sized(pn.idx, pn.mask, "prior boundary edges")) for _, pn in ex._prior_lists(batch))
    return ex


def ring_potential(model, batch, mesh, nbl=None, boundary_capacity: int = 2048, check_overflow: bool = True):
    """One-shot library entry: sizes the capacities from THIS (global) batch,
    builds the context once and returns (energy_fn, sharded_batch,
    (executor, context)); ``energy_fn(local_batch)`` gives the replicated
    energies.  The cell sizes of large molecules are probed from the batch,
    as ``External`` probes them.  Raises when a (rank, owner) pair has more
    boundary edges than ``boundary_capacity``."""
    from torchmdnet_tpu_torch.ops.cell_list import probe_cell_kwargs

    cell_kwargs = probe_cell_kwargs(batch, cutoff_upper=model.args.get("cutoff_upper", 5.0))
    for prior in model.module.priors:
        prior.probe_cell_sizes(batch)
    if nbl is None:
        nbl = model.neighbors(batch, **cell_kwargs)
    need = int(ring_boundary_counts(nbl.idx, nbl.mask, mesh).max())
    if need > boundary_capacity:
        raise ValueError(
            f"Ring boundary capacity exceeded: a (rank, source-owner) pair has {need} boundary edges, above "
            f"boundary_capacity={boundary_capacity}. Raise it, or spatially sort the batch "
            "(data.batch.spatial_sort) so cross-rank edges stay a surface term."
        )
    ex = sized_ring_executor(model, batch, mesh, nbl=nbl, boundary_limit=max(boundary_capacity, 256), headroom=1.0,
                             cell_kwargs=cell_kwargs)
    ctx = ex.build(batch, nbl=nbl)
    if check_overflow:
        nbl.raise_on_overflow("ring_apply")
        for prior in model.module.priors:
            prior.check_neighbor_capacity(batch, "ring_apply")
    sharded = ex.shard(batch)
    return (lambda b: ex.energy(b, ctx)), sharded, (ex, ctx)


def ring_apply(model, batch, mesh, nbl=None, boundary_capacity: int = 2048, derivative=None,
               check_overflow: bool = True):
    """Energy (and this rank's forces) of one large batch with O(N/D) feature
    memory per rank.  Every rank passes the same global ``batch``; returns
    (energies (M, 1) replicated, forces (N/D, 3) of this rank's rows, or
    None without ``derivative``)."""
    if derivative is None:
        derivative = model.args.get("derivative", False)
    _, sharded, (ex, ctx) = ring_potential(model, batch, mesh, nbl=nbl, boundary_capacity=boundary_capacity,
                                           check_overflow=check_overflow)
    if not derivative:
        with torch.no_grad():
            return ex.energy(sharded, ctx), None
    return ex.energy_and_forces(sharded, ctx)


def edge_sharded_apply(model, batch, mesh):
    """Energies of one large batch with its atoms sharded over the mesh (the
    JAX package's GSPMD entry; here ``ring_apply`` without forces)."""
    return ring_apply(model, batch, mesh, derivative=False)[0]
