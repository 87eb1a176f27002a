"""Cell-list neighbor search (counterpart of torchmdnet_tpu/ops/cell_list.py).

Two strategies with the brute strategy's semantics (the same idx, mask and
n_neighbors, slots in ascending neighbor order):

1. ``neighbor_list_cell`` (default, per-cell tiles): atoms are binned into a
   dense grid of cutoff-wide cells, sorted by cell key (stable), and given
   compact cell ranks and in-cell slots with scans.  A direct-mapped table
   (grid cell -> rank) finds each cell's 27 neighbor cells with one gather;
   each cell's candidate tile (27 * cell_capacity atom ids) is shared by its
   atoms.  Static sizes: ``cell_capacity`` atoms per cell, ``max_cells``
   occupied cells, ``max_dense_cells`` grid cells.  Every overflow of one of
   them sets the single ``cell_overflow`` flag; nothing is dropped silently.
2. The hash fallback (``hash_strategy=True``): cells hashed into buckets, no
   bound on the spatial extent (collisions only add candidates that the
   distance filter rejects).

Both end in the same per-atom distance filter over (N, 27 * cell_capacity)
candidates and the same compaction: per row, the k smallest candidate ids in
ascending order.  On a CUDA tensor that compaction always runs the
hand-written selection kernel (``ops/kernels/select_topk.py``, kernel #6);
the JAX package's gate ``k <= 64 or the key matrix exceeds 16 MB``
(cell_list.py:80-81) is a rule about TPU VMEM residency and is not carried
over.  On the CPU the kernel's plain version (a sort) runs.

Differences of formulation that leave the results bitwise the same: the
TPU's AoS/SoA choice of candidate field tiles is one gather per field here
(a tile gathered through the cell table is the field gathered at the
candidate ids); ``.at[].set(mode="drop")`` scatters become writes into tables
with one trash row that is sliced off, and only the trash row ever receives
more than one write (``index_put_`` with duplicate indices is not
deterministic on the GPU).  Cells are binned by dividing by a tensor, not by
a Python float: PyTorch's CUDA division by a scalar multiplies by its
reciprocal, which rounds differently from the JAX package and the probes.

PBC: rectangular boxes only, as in the reference's cell strategy
(neighbors_cuda_cell.cuh:14-28); positions are wrapped into the box before
binning and candidate displacements use minimum image.  A triclinic box
raises here (the JAX package bins it by its diagonal and may miss pairs);
the brute strategy takes it, and ``strategy="auto"`` sends it there.
"""

from typing import Optional

import numpy as np
import torch

from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk
from torchmdnet_tpu_torch.ops.neighbors import NeighborList, _finish_rows, _is_rectangular, _wrap_components

# Standard spatial-hashing primes (Teschner et al. 2003), hash fallback only.
_P1, _P2, _P3, _P4 = 73856093, 19349663, 83492791, 126271


def _offsets(device) -> torch.Tensor:
    """The 27 neighbor-cell offsets, (27, 3), the first axis slowest."""
    r = torch.arange(-1, 2, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(27, 3)


def _hash_cells(cx, cy, cz, mol, num_buckets: int) -> torch.Tensor:
    """The JAX package's int32 hash: products wrap at 32 bits, computed here
    in int64 and reduced to the int32 bit pattern before abs & mask."""
    h = (cx.long() * _P1) ^ (cy.long() * _P2) ^ (cz.long() * _P3) ^ (mol.long() * _P4)
    low = h & 0xFFFFFFFF  # the int32 result's bits, as an unsigned value
    absval = torch.where(low >= 2**31, 2**32 - low, low)  # |int32| (INT_MIN -> 2^31)
    return absval & (num_buckets - 1)


def _dedupe_sorted(ids: torch.Tensor, fill: int) -> torch.Tensor:
    """Sort each row and replace repeats by ``fill`` (wrapped or colliding
    neighbor cells must contribute their atoms once)."""
    ids = torch.sort(ids, dim=1).values
    dup = torch.cat([torch.zeros_like(ids[:, :1], dtype=torch.bool), ids[:, 1:] == ids[:, :-1]], dim=1)
    return torch.where(dup, torch.full_like(ids, fill), ids)


def _float_pos(pos: torch.Tensor) -> torch.Tensor:
    return pos.float() if pos.dtype in (torch.float16, torch.bfloat16) else pos


def _rect_diag(box, dtype) -> torch.Tensor:
    box = box.to(dtype)
    if not _is_rectangular(box):
        raise ValueError(
            "the cell strategy takes rectangular boxes only (as the reference's "
            "cell strategy); use strategy='brute' for a triclinic box"
        )
    return torch.diagonal(box)


def _cell_coords(p, atom_mask, box, cutoff_upper):
    """Each atom's integer cell coordinates floor(x / cutoff), from positions
    wrapped into the box or, without one, from the real atoms' lower corner;
    and with a box the cells per axis (at least 1), else None."""
    cut = torch.tensor(cutoff_upper, dtype=p.dtype, device=p.device)
    if box is None:
        inf = torch.tensor(float("inf"), dtype=p.dtype, device=p.device)
        origin = torch.where(atom_mask[:, None], p, inf).amin(dim=0, keepdim=True)
        return torch.floor((p - origin) / cut).long(), None
    diag = _rect_diag(box, p.dtype)
    wrapped = p - torch.floor(p / diag) * diag
    return torch.floor(wrapped / cut).long(), torch.clamp(torch.floor(diag / cut).long(), min=1)


def _filter(p, batch, atom_mask, box, cand, *, cutoff_lower, cutoff_upper):
    """Per-atom distance filter over the candidates ``cand`` (N, W) int32
    (atom ids, ``n`` where empty): (keys, n_neighbors), keys holding the
    in-cutoff candidate ids and ``n`` elsewhere."""
    n = p.shape[0]
    dev = p.device
    cl = cand.long()
    # candidate fields gathered at the candidate ids; row n is the empty slot
    fields = torch.cat([p, p.new_zeros((1, 3))])
    pj = fields.index_select(0, cl.reshape(-1)).reshape(n, -1, 3)
    # batch id of real atoms, -1 for padding and empty slots (ids are >= 0)
    meta = torch.cat([torch.where(atom_mask, batch.long(), -1), batch.new_full((1,), -1).long()])
    cmeta = meta[cl]
    dx = pj[..., 0] - p[:, None, 0]
    dy = pj[..., 1] - p[:, None, 1]
    dz = pj[..., 2] - p[:, None, 2]
    if box is not None:
        dx, dy, dz = _wrap_components(dx, dy, dz, box.to(p.dtype))
    d2 = dx * dx + dy * dy + dz * dz
    iota = torch.arange(n, device=dev)
    valid = (
        (cand < n)
        & (cmeta == batch.long()[:, None])
        & (cl != iota[:, None])
        & atom_mask[:, None]
        & (d2 < cutoff_upper * cutoff_upper)
        & (d2 >= cutoff_lower * cutoff_lower)
    )
    return torch.where(valid, cand, n), valid.sum(dim=1).to(torch.int32)


@torch.no_grad()
def _cell_keys_tiles(
    pos, batch, atom_mask, box, *, cutoff_lower, cutoff_upper,
    cell_capacity, max_cells, max_dense_cells,
):
    n = pos.shape[0]
    dev = pos.device
    p = _float_pos(pos)
    m, c_max, dense = cell_capacity, max_cells, max_dense_cells
    iota = torch.arange(n, device=dev)

    # --- bin atoms into the grid -------------------------------------------
    cc, ext = _cell_coords(p, atom_mask, box, cutoff_upper)
    if box is not None:
        cc = torch.minimum(torch.clamp(cc, min=0), ext - 1)  # atoms exactly on the edge
    else:
        cc = torch.where(atom_mask[:, None], cc, 0)
        ext = cc.amax(dim=0) + 1
    # grid-capacity check in float, as the JAX package does it
    grid_overflow = ext[0].float() * ext[1].float() * ext[2].float() > float(dense)

    def dense_key(c0, c1, c2):
        return torch.clamp((c0 * ext[1] + c1) * ext[2] + c2, 0, dense - 1)

    key = torch.where(atom_mask, dense_key(cc[:, 0], cc[:, 1], cc[:, 2]), dense)

    # --- sort by cell; compact cell ranks and in-cell slots with scans -------
    order = torch.argsort(key, stable=True)  # cell ascending, atom ascending
    skey = key[order]
    is_first = torch.cat([skey.new_ones((1,), dtype=torch.bool), skey[1:] != skey[:-1]])
    first_idx = torch.cummax(torch.where(is_first, iota, -1), dim=0).values
    slot = iota - first_idx
    rank = torch.cumsum(is_first, dim=0) - 1
    valid_atom = skey < dense
    cap_overflow = ((slot >= m) & valid_atom).any()
    rank_overflow = (is_first & valid_atom).sum() > c_max
    overflow = grid_overflow | cap_overflow | rank_overflow

    # --- cell table (C, M) of atom ids, n where empty; row C is the trash ----
    ok = valid_atom & (rank < c_max) & (slot < m)
    table = torch.full((c_max * m + 1,), n, dtype=torch.int32, device=dev)
    table[torch.where(ok, rank * m + slot, c_max * m)] = order.to(torch.int32)
    table = torch.cat([table[: c_max * m].reshape(c_max, m), table.new_full((1, m), n)])

    # per-cell grid coordinates and the direct-mapped (grid cell -> rank) table
    head = is_first & ok
    rpos = torch.where(head, rank, c_max)
    ccell = torch.full((c_max + 1, 3), -1, dtype=torch.int64, device=dev)
    ccell[rpos] = cc[order]
    ccell = ccell[:c_max]
    dense_map = torch.full((dense + 1,), c_max, dtype=torch.int64, device=dev)
    dense_map[torch.where(head, skey, dense)] = rpos

    # --- 27 neighbor cells per cell (one gather) -----------------------------
    ncc = ccell[:, None, :] + _offsets(dev)[None, :, :]  # (C, 27, 3)
    if box is not None:
        ncc = torch.remainder(ncc, ext)
        in_grid = torch.ones(ncc.shape[:2], dtype=torch.bool, device=dev)
    else:
        in_grid = ((ncc >= 0) & (ncc < ext)).all(dim=-1)
    in_grid = in_grid & (ccell[:, None, 0] >= 0)  # unused cells see no neighbors
    nkey = torch.where(in_grid, dense_key(ncc[..., 0], ncc[..., 1], ncc[..., 2]), dense)
    nrank = _dedupe_sorted(dense_map[nkey], c_max)  # (C, 27), c_max = none

    # --- candidate tiles (C, 27M), shared by each cell's atoms ---------------
    cand = table[nrank].reshape(c_max, 27 * m)
    cand = torch.cat([cand, cand.new_full((1, 27 * m), n)])
    atom_rank = torch.empty(n, dtype=torch.int64, device=dev)
    atom_rank[order] = torch.where(ok, rank, c_max)  # order is a permutation
    keys, n_neighbors = _filter(
        p, batch, atom_mask, box, cand[atom_rank],
        cutoff_lower=cutoff_lower, cutoff_upper=cutoff_upper,
    )
    return keys, n_neighbors, overflow


@torch.no_grad()
def _cell_keys_hash(
    pos, batch, atom_mask, box, *, cutoff_lower, cutoff_upper,
    cell_capacity, num_buckets,
):
    n = pos.shape[0]
    dev = pos.device
    p = _float_pos(pos)
    m, cb = cell_capacity, num_buckets

    cc, ncells = _cell_coords(p, atom_mask, box, cutoff_upper)
    if box is not None:
        cc = torch.minimum(cc, ncells - 1)  # atoms exactly on the edge

    h_atom = _hash_cells(cc[:, 0], cc[:, 1], cc[:, 2], batch, cb)
    h_atom = torch.where(atom_mask, h_atom, cb)  # padding -> the trash bucket

    # --- bucket table (C, M) via sort + rank; row C*M is the trash ------------
    order = torch.argsort(h_atom, stable=True)  # bucket ascending, atom ascending
    sorted_h = h_atom[order]
    rank = torch.arange(n, device=dev) - torch.searchsorted(sorted_h, sorted_h, side="left")
    used = sorted_h < cb
    bucket_overflow = ((rank >= m) & used).any()
    table = torch.full((cb * m + 1,), n, dtype=torch.int32, device=dev)
    table[torch.where((rank < m) & used, sorted_h * m + rank, cb * m)] = order.to(torch.int32)
    table = table[: cb * m].reshape(cb, m)

    # --- 27 neighbor buckets per atom ----------------------------------------
    ncc = cc[:, None, :] + _offsets(dev)[None, :, :]  # (N, 27, 3)
    if box is not None:
        ncc = torch.remainder(ncc, ncells)
    hb = torch.sort(_hash_cells(ncc[..., 0], ncc[..., 1], ncc[..., 2], batch[:, None], cb), dim=1).values
    dup = torch.cat([torch.zeros_like(hb[:, :1], dtype=torch.bool), hb[:, 1:] == hb[:, :-1]], dim=1)
    cand = torch.where(dup[:, :, None], n, table[hb]).reshape(n, 27 * m)
    keys, n_neighbors = _filter(
        p, batch, atom_mask, box, cand, cutoff_lower=cutoff_lower, cutoff_upper=cutoff_upper,
    )
    return keys, n_neighbors, bucket_overflow


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def wants_cell_probe(num_atoms, num_mol=1) -> bool:
    """The one large-molecule gate for the setup-time occupancy probes.

    The cell strategy (and so the probe) pays off for batches of large
    molecules: >= 2048 atoms in all and >= 512 atoms per molecule.
    ``md.Simulation`` and ``optimize`` both call this predicate.
    """
    num_atoms = int(num_atoms)
    return num_atoms >= 2048 and num_atoms / max(1, int(num_mol)) >= 512


def _probe_cells(pos, atom_mask, cutoff_upper, box):
    """Grid keys of the real atoms, binned as the build bins them: in the
    build's dtype (f64 stays f64, everything else f32), with the box branch's
    clipping of the boundary remainder into the last cell of each axis."""
    p = _host_array(pos)
    if p.dtype != np.float64:
        p = p.astype(np.float32)
    if atom_mask is not None:
        p = p[_host_array(atom_mask).astype(bool)]
    cut = p.dtype.type(cutoff_upper)
    if box is not None:
        diag = np.diagonal(_host_array(box)).astype(p.dtype)
        p = p - np.floor(p / diag) * diag
        ext = np.maximum(np.floor(diag / cut).astype(np.int64), 1)
        cc = np.clip(np.floor(p / cut).astype(np.int64), 0, ext - 1)
    else:
        p = p - p.min(axis=0)
        cc = np.floor(p / cut).astype(np.int64)
        ext = cc.max(axis=0) + 1
    return (cc[:, 0] * ext[1] + cc[:, 1]) * ext[2] + cc[:, 2]


def suggest_cell_capacity(pos, atom_mask=None, *, cutoff_upper: float, box=None,
                          headroom: float = 1.1, floor: int = 8) -> int:
    """Setup-time probe: a tight static ``cell_capacity`` for these positions.

    The cell-tile costs (candidate gather, distance filter, selection) all
    scale with 27 * cell_capacity, and the default (32) is about half padding
    at protein density.  Runs on the host (numpy) once at setup; occupancy
    overflow later stays flagged in ``cell_overflow``.

    Args:
        headroom: margin over the observed maximum occupancy (MD: atoms drift
            between rebuilds; 1.0 is exact for static inputs).
    """
    key = _probe_cells(pos, atom_mask, cutoff_upper, box)
    occ = int(np.bincount(key).max()) if key.size else 1
    return max(int(floor), int(np.ceil(occ * float(headroom))))


def suggest_max_cells(pos, atom_mask=None, *, cutoff_upper: float, box=None,
                      headroom: float = 1.2) -> int:
    """Setup-time probe: a tight static ``max_cells`` for these positions.

    The default (N / 8) assumes a mean occupancy of at least 8, which sparse
    or hollow systems violate.  Returns the occupied cell count with drift
    headroom, at least 256, rounded up to a multiple of 8.
    """
    key = _probe_cells(pos, atom_mask, cutoff_upper, box)
    occupied = int(np.unique(key).size) if key.size else 1
    return -(-max(256, int(np.ceil(occupied * float(headroom)))) // 8) * 8


def probe_cell_kwargs(batch, neighbor_kwargs=None, *, cutoff_upper: float, box=None,
                      strategy: str = "auto") -> dict:
    """``neighbor_kwargs`` with ``cell_capacity`` and ``max_cells`` probed
    from ``batch``'s positions (headroom 1.3 for drift between rebuilds) when
    the batch holds large molecules, the strategy may take the cell list, and
    the caller pinned no capacity: the setup of ``md.Simulation`` and
    ``optimize`` (torchmdnet_tpu/md.py:109-142)."""
    kw = dict(neighbor_kwargs or {})
    if ("cell_capacity" not in kw and strategy in ("auto", "cell")
            and wants_cell_probe(batch.num_atoms, batch.num_mol)):
        probe = dict(cutoff_upper=cutoff_upper, box=box)
        kw["cell_capacity"] = suggest_cell_capacity(batch.pos, batch.atom_mask, headroom=1.3, **probe)
        kw.setdefault("max_cells", suggest_max_cells(batch.pos, batch.atom_mask, **probe))
    return kw


def cell_candidate_keys(
    pos,
    batch=None,
    atom_mask=None,
    *,
    cutoff_lower: float = 0.0,
    cutoff_upper: float = 5.0,
    box: Optional[torch.Tensor] = None,
    cell_capacity: int = 32,
    max_cells: Optional[int] = None,
    max_dense_cells: int = 1 << 18,
    hash_strategy: bool = False,
    num_buckets: Optional[int] = None,
):
    """The cell search before its compaction: (keys (N, 27 * cell_capacity)
    int32, n_neighbors (N,) int32, cell_overflow scalar bool).  Row i of
    ``keys`` holds the ids of atom i's in-cutoff neighbors, each once, and N
    in every other slot: the selection kernel's input.  Arguments as
    ``neighbor_list_cell``."""
    n = pos.shape[0]
    dev = pos.device
    if batch is None:
        batch = torch.zeros(n, dtype=torch.int64, device=dev)
    if atom_mask is None:
        atom_mask = torch.ones(n, dtype=torch.bool, device=dev)
    kw = dict(cutoff_lower=float(cutoff_lower), cutoff_upper=float(cutoff_upper),
              cell_capacity=int(cell_capacity))
    if hash_strategy:
        if num_buckets is None:
            num_buckets = 1 << max(4, (4 * n - 1).bit_length())
        return _cell_keys_hash(pos.detach(), batch, atom_mask, box, num_buckets=int(num_buckets), **kw)
    if max_cells is None:
        max_cells = max(256, -(-n // 8))
    max_cells = -(-int(max_cells) // 8) * 8
    return _cell_keys_tiles(
        pos.detach(), batch, atom_mask, box, max_cells=max_cells,
        max_dense_cells=int(max_dense_cells), **kw
    )


def neighbor_list_cell(
    pos,
    batch=None,
    atom_mask=None,
    *,
    k: int,
    cutoff_lower: float = 0.0,
    cutoff_upper: float = 5.0,
    loop: bool = False,
    box: Optional[torch.Tensor] = None,
    **cell_kwargs,
) -> NeighborList:
    """Cell-list neighbor search with the semantics of ``neighbor_list``.

    Args (``cell_kwargs``):
        cell_capacity: static max atoms per grid cell (or hash bucket), 32.
        max_cells: static max occupied cells; default max(256, N / 8),
            rounded up to a multiple of 8.
        max_dense_cells: size of the direct-mapped grid -> rank table (2^18);
            the system's bounding grid must fit.
        hash_strategy: use the hash-bucket fallback (no bound on the extent).
        num_buckets: hash fallback only; a power of two, default the
            smallest one >= 4N (at least 16).

    Overflow of any static size sets ``cell_overflow`` (a scalar bool tensor
    on the device); ``raise_on_overflow`` checks it on the host.  The
    compaction keeps each row's k smallest candidate ids through
    ``select_topk`` (the kernel on a CUDA tensor).
    """
    n = pos.shape[0]
    keys, n_neighbors, overflow = cell_candidate_keys(
        pos, batch, atom_mask, cutoff_lower=cutoff_lower, cutoff_upper=cutoff_upper,
        box=box, **cell_kwargs,
    )
    if atom_mask is None:
        atom_mask = torch.ones(n, dtype=torch.bool, device=pos.device)
    idx = select_topk(keys, min(int(k), keys.shape[1]), n)
    idx, mask = _finish_rows(idx, n, int(k), bool(loop), atom_mask)
    return NeighborList(idx=idx, mask=mask, n_neighbors=n_neighbors, self_loops=bool(loop),
                        cell_overflow=overflow)
