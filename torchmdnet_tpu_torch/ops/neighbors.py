"""Neighbor search in the dense ELL format (counterpart of torchmdnet_tpu/ops/neighbors.py).

For each atom i the list stores K neighbor slots:

    idx  : (N, K) int32 -- neighbor j for each slot of atom i (invalid -> i)
    mask : (N, K) bool  -- slot validity

Slots are filled in ascending neighbor-index order, so the list is the same
on every run and bitwise equal to the JAX package's.  Distances and
directions are recomputed from ``pos`` in plain PyTorch, so autograd through
positions needs no custom rule.

The list is symmetric (j is in row i iff i is in row j), so every atom is
pointed at by exactly K slots: its neighbors' transposed edges plus its own
self/padding slots.  The transpose of a gather is therefore one argsort of
``idx`` (shared by every gather of a list), a row gather and a sum over K
slots (``ell_transpose_sum``).  No ``index_add_`` is involved, so gradients
(forces) are bitwise the same from run to run on the GPU, where
``index_add_`` adds floats with atomics.  The argsort is made only when a
backward first needs it (``NeighborList.lazy_perm``): a list truncated at
its capacity (not symmetric, so without a transpose) still runs forwards, as
the reference's truncating ``radius_graph`` does, and a gradient through it
raises.  bf16 rows gather and transpose-sum through the CUDA kernels of
``ops/kernels/ell_gather.py`` (their plain versions on the CPU); other
dtypes stay ``index_select`` and a K-axis sum.

PBC: rectangular and reduced-form triclinic boxes via minimum image, with the
reference's convention and box-validity preconditions (the cell strategy,
``ops/cell_list.py``, takes rectangular boxes only).

Edge partitioning (``parallel/``): a list whose transpose permutation is a
``ShardPlan`` holds one rank's rows with global ids; ``ell_gather`` and
``ell_transpose_sum`` on it exchange the boundary rows with the other ranks
(``parallel/edge_partition.py``), and under a partition scope
``neighbor_list`` returns the executor's prebuilt list of the same
signature (a pair prior's own list).
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from torchmdnet_tpu_torch.parallel.context import ShardPlan, record_build, ring_info

# atom count at which 'auto' switches from brute to the cell list, the JAX
# package's threshold (torchmdnet_tpu/ops/neighbors.py:60)
_AUTO_CELL_THRESHOLD = 2048


def transpose_perm(idx: torch.Tensor) -> torch.Tensor:
    """Permutation sending row-major ELL slots to transpose-grouped order.

    Sorting the flat slot indices by target groups the K slots that point at
    each atom together (stable sort: ascending slot order inside a group).
    Raises if an atom is not pointed at by exactly K slots, i.e. if the list
    is not symmetric (a neighbor-capacity overflow truncates rows unevenly).
    """
    n, k = idx.shape
    flat = idx.reshape(-1)
    counts = torch.bincount(flat.long(), minlength=n)
    if counts.numel() != n or not bool((counts == k).all()):
        raise ValueError(
            "the ELL neighbor list is not symmetric (some atom is not pointed "
            f"at by exactly K={k} slots); a neighbor capacity overflow "
            "truncates rows unevenly. Increase max_num_neighbors."
        )
    return torch.argsort(flat, stable=True).to(torch.int32)


def _gather_rows(x, idx):
    out = x.index_select(0, idx.reshape(-1))
    return out.reshape(tuple(idx.shape) + tuple(x.shape[1:]))


def _transpose_sum(g, idx, perm):
    n, k = idx.shape
    g2 = g.reshape(n * k, -1).index_select(0, perm).reshape(n, k, -1)
    # low-precision cotangents still accumulate the K-axis sum in f32
    acc = torch.float32 if g.dtype in (torch.bfloat16, torch.float16) else g.dtype
    out = g2.sum(dim=1, dtype=acc).to(g.dtype)
    return out.reshape((n,) + tuple(g.shape[2:]))


def _gather(x, idx):
    if x.dtype == torch.bfloat16:  # kernel #4 on the card
        from torchmdnet_tpu_torch.ops.kernels import ell_gather as kernels

        return kernels.gather_rows(x, idx)
    return _gather_rows(x, idx)


def _resolve_perm(idx, perm):
    """``perm`` as given, the value of a callable (``NeighborList.lazy_perm``),
    or ``transpose_perm(idx)`` for None."""
    if perm is None:
        return transpose_perm(idx)
    return perm() if callable(perm) else perm


class _EllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, perm):
        # the permutation (a tensor, a callable or None; never differentiated)
        # is resolved by a backward only: a forward through a truncated (not
        # symmetric) list needs none.  It stays off save_for_backward, so a
        # recomputation (remat) saves the same tensors whether or not it has
        # been resolved since.
        ctx.save_for_backward(idx)
        ctx.save_for_forward(idx)
        ctx.perm = perm
        return _gather(x, idx)

    @staticmethod
    def jvp(ctx, t, _idx, _perm):
        # linear: the tangent is gathered as the rows are (#4 for bf16 on the card)
        (idx,) = ctx.saved_tensors
        return ell_gather(t, idx, ctx.perm)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return ell_transpose_sum(g, idx, ctx.perm), None, None


class _EllTransposeSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, idx, perm):
        perm = _resolve_perm(idx, perm)
        ctx.save_for_backward(idx, perm)
        ctx.save_for_forward(idx, perm)
        if g.dtype == torch.bfloat16:  # kernel #5 on the card
            from torchmdnet_tpu_torch.ops.kernels import ell_gather as kernels

            return kernels.transpose_sum_rows(g, idx, perm)
        return _transpose_sum(g, idx, perm)

    @staticmethod
    def jvp(ctx, t, _idx, _perm):
        # linear: the tangent is transpose-summed as the rows are (#5 for bf16)
        idx, perm = ctx.saved_tensors
        return ell_transpose_sum(t, idx, perm)

    @staticmethod
    def backward(ctx, c):
        idx, perm = ctx.saved_tensors
        return ell_gather(c, idx, perm), None, None


def ell_gather(x, idx, perm=None):
    """out[i, k] = x[idx[i, k]], whose gradient is the scatter-free
    ``ell_transpose_sum``.  ``perm`` is ``transpose_perm(idx)``, or a callable
    returning it (``NeighborList.lazy_perm``: computed when a backward first
    needs it, once per list), or None (computed by each backward).  The pair
    of functions are each other's gradients, so every derivative order stays
    scatter-free.  A ``ShardPlan`` as ``perm`` takes the partitioned route.
    """
    if isinstance(perm, ShardPlan):
        from torchmdnet_tpu_torch.parallel.edge_partition import ring_ell_gather

        return ring_ell_gather(x, perm)
    return _EllGather.apply(x, idx, perm)


def ell_transpose_sum(g, idx, perm=None):
    """dh[j] = sum of g[i, k] over all slots with idx[i, k] == j; ``perm`` as
    for ``ell_gather``."""
    if isinstance(perm, ShardPlan):
        from torchmdnet_tpu_torch.parallel.edge_partition import ring_ell_transpose

        return ring_ell_transpose(g, perm)
    return _EllTransposeSum.apply(g, idx, perm)


@dataclasses.dataclass
class NeighborList:
    """Static-shape ELL neighbor list.

    Attributes:
        idx: (N, K) int32, neighbor index j per slot of atom i. Invalid slots
            point at i itself, so gathers are always in bounds.
        mask: (N, K) bool, True where the slot holds a real neighbor.
        n_neighbors: (N,) int32, the TRUE number of in-cutoff neighbors of
            each atom (before capping at K), for overflow checks.
        self_loops: if True, column 0 is the self edge (i, i) with distance 0.
        cell_overflow: cell strategy only, a scalar bool tensor: True if a
            static cell-list size overflowed (the list may be incomplete).
    """

    idx: torch.Tensor
    mask: torch.Tensor
    n_neighbors: torch.Tensor
    self_loops: bool = False
    cell_overflow: Optional[torch.Tensor] = None
    # the transpose permutation, or a callable giving it when first needed
    _perm: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def num_atoms(self) -> int:
        return self.idx.shape[0]

    @property
    def k(self) -> int:
        return self.idx.shape[1]

    @property
    def transpose_perm(self) -> torch.Tensor:
        """``transpose_perm(idx)``, computed once per list (raises for a list
        that is not symmetric)."""
        if self._perm is None:
            self._perm = transpose_perm(self.idx)
        elif callable(self._perm):
            self._perm = self._perm()
        return self._perm

    @property
    def lazy_perm(self):
        """The transpose permutation if it is known, else a callable that
        gives ``transpose_perm`` when a backward first needs it (a
        partitioned list's ``ShardPlan`` as it is)."""
        if isinstance(self._perm, (torch.Tensor, ShardPlan)):
            return self._perm
        return lambda: self.transpose_perm

    def without_self_loops(self) -> "NeighborList":
        """Drop the self-loop column (used by NeighborEmbedding).

        The new list's transpose permutation comes from this list's, when
        first needed, without a sort or a host check: every group of K slots
        pointing at atom j holds exactly one column-0 slot, (j, 0); dropping
        it keeps the others' order, and slot (i, c) becomes (i, c - 1)."""
        if not self.self_loops:
            return self
        n, k = self.idx.shape
        if isinstance(self._perm, ShardPlan):
            return NeighborList(
                idx=self.idx[:, 1:].contiguous(), mask=self.mask[:, 1:].contiguous(),
                n_neighbors=self.n_neighbors, self_loops=False, cell_overflow=self.cell_overflow,
                _perm=self._perm.without_self_loops(),
            )

        def derived():
            groups = self.transpose_perm.reshape(n, k).long()
            keep = torch.argsort((groups % k == 0).to(torch.int32), dim=1, stable=True)[:, : k - 1]
            flat = torch.gather(groups, 1, keep)
            return ((flat // k) * (k - 1) + flat % k - 1).reshape(-1).to(torch.int32)

        return NeighborList(
            idx=self.idx[:, 1:].contiguous(),
            mask=self.mask[:, 1:].contiguous(),
            n_neighbors=self.n_neighbors,
            self_loops=False,
            cell_overflow=self.cell_overflow,
            _perm=derived,
        )

    def overflow(self) -> torch.Tensor:
        """Scalar bool: did any atom exceed the K-neighbor capacity?"""
        k_real = self.k - (1 if self.self_loops else 0)
        return (self.n_neighbors > k_real).any()

    def raise_on_overflow(self, context: str = "") -> "NeighborList":
        """Loud failure when the list is incomplete (up to two host fetches)."""
        where = f" in {context}" if context else ""
        if bool(self.overflow()):
            k_real = self.k - (1 if self.self_loops else 0)
            raise ValueError(
                f"Neighbor capacity exceeded{where}: "
                f"an atom has more than max_num_neighbors={k_real} neighbors "
                f"within the cutoff (true max: {int(self.n_neighbors.max())}). "
                "Increase max_num_neighbors."
            )
        if self.cell_overflow is not None and bool(self.cell_overflow):
            raise ValueError(
                f"Cell-list capacity exceeded{where}: "
                "raise cell_capacity / max_cells / max_dense_cells, or use "
                "strategy='brute' or the hash fallback."
            )
        return self

    def refine(
        self, pos, cutoff_lower: float, cutoff_upper: float, box=None
    ) -> "NeighborList":
        """Re-apply the true cutoff window to a skin-padded list (Verlet-skin
        reuse); the self-loop column, if present, stays valid."""
        with torch.no_grad():
            pj = ell_gather(pos, self.idx, self.lazy_perm)
            dx = pj[..., 0] - pos[:, None, 0]
            dy = pj[..., 1] - pos[:, None, 1]
            dz = pj[..., 2] - pos[:, None, 2]
            if box is not None:
                dx, dy, dz = _wrap_components(dx, dy, dz, box.to(pos.dtype))
            d2 = dx * dx + dy * dy + dz * dz
            window = (d2 < cutoff_upper * cutoff_upper) & (
                d2 >= cutoff_lower * cutoff_lower
            )
            if self.self_loops:
                window[:, 0] = True
        return NeighborList(
            idx=self.idx,
            mask=self.mask & window,
            n_neighbors=self.n_neighbors,
            self_loops=self.self_loops,
            cell_overflow=self.cell_overflow,
            # depends only on idx: computed once on this list and shared by
            # every refinement (one argsort and host check per skin rebuild)
            _perm=self.lazy_perm,
        )


def _wrap_components(dx, dy, dz, b):
    """Sequential triclinic round-subtract in c, b, a order (minimum image)."""
    s = torch.round(dz / b[2, 2])
    dx, dy, dz = dx - s * b[2, 0], dy - s * b[2, 1], dz - s * b[2, 2]
    s = torch.round(dy / b[1, 1])
    dx, dy = dx - s * b[1, 0], dy - s * b[1, 1]
    s = torch.round(dx / b[0, 0])
    dx = dx - s * b[0, 0]
    return dx, dy, dz


def minimum_image(delta, box):
    """Minimum-image displacements; ``box`` is (3, 3) with rows a, b, c in
    reduced triclinic form (a[1]=a[2]=b[2]=0)."""
    delta = delta - torch.round(delta[..., 2:3] / box[2, 2]) * box[2]
    delta = delta - torch.round(delta[..., 1:2] / box[1, 1]) * box[1]
    delta = delta - torch.round(delta[..., 0:1] / box[0, 0]) * box[0]
    return delta


def check_box(box, cutoff: float):
    """Validate the reduced triclinic box requirements (raises)."""
    box = np.asarray(box.detach().cpu() if isinstance(box, torch.Tensor) else box)
    if box.shape != (3, 3):
        raise ValueError("box must have shape (3, 3)")
    a, b, c = box
    eps = 1e-5 * max(1.0, float(np.abs(box).max()))
    if not (abs(a[1]) < eps and abs(a[2]) < eps and abs(b[2]) < eps):
        raise ValueError("box is not in reduced form (a[1]=a[2]=b[2]=0 required)")
    if a[0] < 2 * cutoff or b[1] < 2 * cutoff or c[2] < 2 * cutoff:
        raise ValueError("box dimensions must be at least 2*cutoff")
    if a[0] < 2 * abs(b[0]) or a[0] < 2 * abs(c[0]) or b[1] < 2 * abs(c[1]):
        raise ValueError("triclinic box is not in reduced form")


def _is_rectangular(box) -> bool:
    """True without a box or for a diagonal one (one host fetch)."""
    if box is None:
        return True
    box = torch.as_tensor(box)
    return not bool((box - torch.diag(torch.diagonal(box))).any())


def safe_norm(x, dim=-1, keepdim=False):
    """Euclidean norm that is finite, value and gradient, at x == 0."""
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    nonzero = sq > 0
    sq_safe = torch.where(nonzero, sq, torch.ones_like(sq))
    return torch.where(nonzero, torch.sqrt(sq_safe), torch.zeros_like(sq))


@torch.no_grad()
def _neighbor_list_brute(pos, batch, atom_mask, box, *, k, cutoff_lower, cutoff_upper, loop):
    n = pos.shape[0]
    p = pos.float() if pos.dtype in (torch.float16, torch.bfloat16) else pos
    if box is not None:
        dx = p[:, None, 0] - p[None, :, 0]
        dy = p[:, None, 1] - p[None, :, 1]
        dz = p[:, None, 2] - p[None, :, 2]
        dx, dy, dz = _wrap_components(dx, dy, dz, box.to(p.dtype))
        d2 = dx * dx + dy * dy + dz * dz
    else:
        # |xi - xj|^2 = |xi|^2 + |xj|^2 - 2 xi.xj on centered coordinates,
        # the JAX package's formula, so the lists agree bitwise
        c = p - p.mean(dim=0, keepdim=True)
        sq = (c * c).sum(dim=-1)
        d2 = (sq[:, None] + sq[None, :] - 2.0 * (c @ c.T)).clamp_min(0.0)

    ar = torch.arange(n, device=pos.device)
    same_mol = batch[:, None] == batch[None, :]
    both_real = atom_mask[:, None] & atom_mask[None, :]
    not_self = ar[None, :] != ar[:, None]
    window = (d2 < cutoff_upper * cutoff_upper) & (d2 >= cutoff_lower * cutoff_lower)
    valid = same_mol & both_real & not_self & window
    n_neighbors = valid.sum(dim=1).to(torch.int32)

    # keep the k valid neighbors with the smallest column index, ascending
    key = torch.where(valid, ar[None, :], n)
    idx = torch.topk(key, min(k, n), dim=1, largest=False, sorted=True).values
    idx, mask = _finish_rows(idx, n, k, loop, atom_mask)
    return idx, mask, n_neighbors


def _finish_rows(idx, n: int, k: int, loop: bool, atom_mask):
    """ELL rows from each atom's ascending candidate ids (``n`` = empty):
    empty slots point at the atom itself, rows are padded to k columns, and
    the self edge is prepended when ``loop``.  Returns (idx int32, mask)."""
    k_eff = idx.shape[1]
    ar = torch.arange(n, device=idx.device, dtype=idx.dtype)
    mask = idx < n
    idx = torch.where(mask, idx, ar[:, None].expand(n, k_eff))
    if k_eff < k:
        pad = k - k_eff
        idx = torch.cat([idx, ar[:, None].expand(n, pad)], dim=1)
        mask = torch.cat([mask, mask.new_zeros((n, pad))], dim=1)
    if loop:
        idx = torch.cat([ar[:, None], idx], dim=1)
        mask = torch.cat([atom_mask[:, None], mask], dim=1)
    return idx.to(torch.int32).contiguous(), mask.contiguous()


def neighbor_list(
    pos,
    batch=None,
    atom_mask=None,
    *,
    k: int,
    cutoff_lower: float = 0.0,
    cutoff_upper: float = 5.0,
    loop: bool = False,
    box=None,
    strategy: str = "auto",
    **cell_kwargs,
) -> NeighborList:
    """Build a static-shape ELL neighbor list.

    Args:
        pos: (N, 3) positions.
        batch: (N,) molecule ids; None -> single molecule.
        atom_mask: (N,) bool; False rows are padding and get no neighbors.
        k: max neighbors per atom. The output has K = k (+1 if loop).
        loop: include the self edge as column 0.
        box: optional (3, 3) periodic box (reduced triclinic rows a, b, c).
        strategy: 'brute' (O(N^2) masked search), 'brute-pallas' (the same
            search fused into one kernel with ordered compaction,
            ``ops/kernels/compaction.py``, the JAX package's strategy of that
            name; no box; d^2 in difference form, so a pair within float
            rounding of a cutoff may differ from 'brute'), 'cell' (the cell
            list, O(N), ``ops/cell_list.py``; rectangular boxes only), or
            'auto': the cell list from ``_AUTO_CELL_THRESHOLD`` atoms unless
            the box is triclinic, brute otherwise.
        cell_kwargs: the cell strategy's static sizes (``cell_capacity``,
            ``max_cells``, ...; see ``neighbor_list_cell``); brute ignores them.

    Under a partition scope the list comes from the executor's prebuilt lists
    (matched by (k, cutoff_lower, cutoff_upper, loop)), not from ``pos``.
    """
    sig = (int(k), float(cutoff_lower), float(cutoff_upper), bool(loop))
    info = ring_info()
    if info is not None:
        nbl = info.match_build(sig)
        if nbl is None:
            raise ValueError(
                f"under edge partitioning a neighbor list must be prebuilt by the executor; none matches "
                f"(k, cutoff_lower, cutoff_upper, loop) = {sig}"
            )
        return nbl
    nbl = _build_list(pos, batch, atom_mask, k=k, cutoff_lower=cutoff_lower, cutoff_upper=cutoff_upper,
                      loop=loop, box=box, strategy=strategy, **cell_kwargs)
    record_build(sig, nbl)
    return nbl


def _build_list(pos, batch, atom_mask, *, k, cutoff_lower, cutoff_upper, loop, box, strategy, **cell_kwargs):
    n = pos.shape[0]
    if strategy == "auto":
        strategy = "cell" if n >= _AUTO_CELL_THRESHOLD and _is_rectangular(box) else "brute"
    if strategy == "cell":
        from torchmdnet_tpu_torch.ops.cell_list import neighbor_list_cell

        return neighbor_list_cell(
            pos, batch, atom_mask, k=k, cutoff_lower=cutoff_lower,
            cutoff_upper=cutoff_upper, loop=loop, box=box, **cell_kwargs,
        )
    if strategy not in ("brute", "brute-pallas"):
        raise ValueError(f"Unknown neighbor strategy: {strategy}")
    if batch is None:
        batch = torch.zeros(n, dtype=torch.int64, device=pos.device)
    if atom_mask is None:
        atom_mask = torch.ones(n, dtype=torch.bool, device=pos.device)
    if strategy == "brute-pallas":
        if box is not None:
            raise ValueError("strategy='brute-pallas' takes no periodic box (use 'brute' or 'cell')")
        from torchmdnet_tpu_torch.ops.kernels.compaction import compact_neighbors

        idx, mask, n_neighbors = compact_neighbors(
            pos.detach(), batch, atom_mask, k=int(k),
            cutoff_lower=float(cutoff_lower), cutoff_upper=float(cutoff_upper), loop=bool(loop),
        )
        return NeighborList(idx=idx, mask=mask, n_neighbors=n_neighbors, self_loops=loop)
    idx, mask, n_neighbors = _neighbor_list_brute(
        pos.detach(), batch, atom_mask, box, k=int(k),
        cutoff_lower=float(cutoff_lower), cutoff_upper=float(cutoff_upper),
        loop=bool(loop),
    )
    return NeighborList(idx=idx, mask=mask, n_neighbors=n_neighbors, self_loops=loop)


def edge_geometry_components(pos, nbl: NeighborList, box=None):
    """Edge displacement components and distances, recomputed from positions.

    Returns:
        (dx, dy, dz): (N, K) each; component of pos[j] - pos[i] (from the
            receiving atom i to its neighbor j), zero on invalid slots.
        dist: (N, K) distances, exactly 0 on self-loops/invalid slots, with
            finite derivatives.
    """
    pj = ell_gather(pos, nbl.idx, nbl.lazy_perm)  # (N, K, 3)
    dx = pj[..., 0] - pos[:, None, 0]
    dy = pj[..., 1] - pos[:, None, 1]
    dz = pj[..., 2] - pos[:, None, 2]
    if box is not None:
        dx, dy, dz = _wrap_components(dx, dy, dz, box.to(pos.dtype))
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    dx = torch.where(nbl.mask, dx, zero)
    dy = torch.where(nbl.mask, dy, zero)
    dz = torch.where(nbl.mask, dz, zero)
    d2 = dx * dx + dy * dy + dz * dz
    nonzero = d2 > 0
    dist = torch.where(nonzero, torch.sqrt(torch.where(nonzero, d2, torch.ones_like(d2))), zero)
    return (dx, dy, dz), dist
