"""Padded batches of molecules (counterpart of torchmdnet_tpu/data/batch.py).

A batch is padded to a fixed (num_atoms, num_mol) capacity:

- padding atoms have atom_mask False, z = 0, pos = 0, and batch id equal to
  ``num_mol`` (a trash segment sliced off after reduction);
- padding molecules have mol_mask False.
"""

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class AtomicBatch:
    """One padded batch of molecules."""

    z: torch.Tensor  # (N,) int64 atomic numbers; padding = 0
    pos: torch.Tensor  # (N, 3)
    batch: torch.Tensor  # (N,) int64 molecule id; padding atoms -> num_mol
    atom_mask: torch.Tensor  # (N,) bool
    mol_mask: torch.Tensor  # (M,) bool
    num_mol: int  # M, the padded molecule capacity
    y: Optional[torch.Tensor] = None  # (M, 1) energy labels
    neg_dy: Optional[torch.Tensor] = None  # (N, 3) force labels

    @property
    def num_atoms(self) -> int:
        return self.z.shape[0]

    def replace(self, **changes) -> "AtomicBatch":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "AtomicBatch":
        """The same batch with every tensor on ``device``."""
        return self.replace(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def pad_molecules(
    mols: Sequence[Dict[str, np.ndarray]],
    num_atoms: int,
    num_mol: Optional[int] = None,
    float_dtype=np.float32,
    device="cpu",
) -> AtomicBatch:
    """Collate a list of per-molecule dicts ``{"z": (n,), "pos": (n, 3)}``,
    with the optional labels ``y`` (energy) and ``neg_dy`` (n, 3) (forces),
    into one padded AtomicBatch, built on ``device`` (the CPU unless named).
    A label is carried when every molecule has it; padding rows are zero."""
    if num_mol is None:
        num_mol = len(mols)
    if len(mols) > num_mol:
        raise ValueError(f"{len(mols)} molecules exceed the capacity {num_mol}")
    total = sum(len(m["z"]) for m in mols)
    if total > num_atoms:
        raise ValueError(f"batch needs {total} atom slots, capacity {num_atoms}")

    z = np.zeros(num_atoms, dtype=np.int64)
    pos = np.zeros((num_atoms, 3), dtype=float_dtype)
    batch = np.full(num_atoms, num_mol, dtype=np.int64)
    atom_mask = np.zeros(num_atoms, dtype=bool)
    mol_mask = np.zeros(num_mol, dtype=bool)
    has_y = bool(mols) and all(m.get("y") is not None for m in mols)
    has_f = bool(mols) and all(m.get("neg_dy") is not None for m in mols)
    y = np.zeros((num_mol, 1), dtype=float_dtype) if has_y else None
    neg_dy = np.zeros((num_atoms, 3), dtype=float_dtype) if has_f else None
    offset = 0
    for i, m in enumerate(mols):
        n = len(m["z"])
        sl = slice(offset, offset + n)
        z[sl] = m["z"]
        pos[sl] = m["pos"]
        batch[sl] = i
        atom_mask[sl] = True
        mol_mask[i] = True
        if has_y:
            y[i, 0] = np.asarray(m["y"]).reshape(-1)[0]
        if has_f:
            neg_dy[sl] = m["neg_dy"]
        offset += n

    def t(a):
        return torch.as_tensor(a, device=device)

    return AtomicBatch(
        z=t(z), pos=t(pos), batch=t(batch), atom_mask=t(atom_mask),
        mol_mask=t(mol_mask), num_mol=num_mol,
        y=None if y is None else t(y), neg_dy=None if neg_dy is None else t(neg_dy),
    )


def spatial_sort(batch: AtomicBatch, cell: float = 5.0) -> Tuple[AtomicBatch, torch.Tensor]:
    """Reorder atoms so that storage order follows space (cell-key sort).

    The JAX package's key (torchmdnet_tpu/data/batch.py:131-165): molecule id
    first, then the cutoff-wide cell's x, y, z, with a stable sort and padding
    atoms last, so molecule boundaries and segment reductions are untouched.
    Atom order means nothing to the models; per-atom outputs (forces) come
    back in the sorted order and map to the original one with the inverse
    permutation, ``forces_original = forces_sorted[torch.argsort(order)]``.
    Force labels (``neg_dy``) move with their atoms.
    ``cell`` should be about the model cutoff.  Returns (sorted batch, order).
    """
    pos = batch.pos.detach().cpu().numpy()
    ids = batch.batch.cpu().numpy().astype(np.int64)
    mask = batch.atom_mask.cpu().numpy()
    c = np.floor((pos - pos.min(axis=0)) / float(cell)).astype(np.int64)
    span = int(max(c.max() + 1, 1))
    key = ((ids * span + c[:, 0]) * span + c[:, 1]) * span + c[:, 2]
    key = np.where(mask, key, np.iinfo(np.int64).max)  # padding last
    order = torch.as_tensor(np.argsort(key, kind="stable"), device=batch.pos.device)
    n = batch.num_atoms
    return batch.replace(**{
        f.name: getattr(batch, f.name)[order]
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor) and getattr(batch, f.name).shape[:1] == (n,)
    }), order
