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
    q: Optional[torch.Tensor] = None  # (M,) total charge
    s: Optional[torch.Tensor] = None  # (M,) spin
    # per-atom fields by name, (N,) each (e.g. "partial_charges")
    extra: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def num_atoms(self) -> int:
        return self.z.shape[0]

    def replace(self, **changes) -> "AtomicBatch":
        return dataclasses.replace(self, **changes)

    def map_tensors(self, fn) -> "AtomicBatch":
        """The same batch with ``fn`` applied to every tensor, those in
        ``extra`` too."""
        changes = {
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        changes["extra"] = {key: fn(value) for key, value in self.extra.items()}
        return self.replace(**changes)

    def to(self, device) -> "AtomicBatch":
        """The same batch with every tensor on ``device``."""
        return self.map_tensors(lambda t: t.to(device))


def pad_molecules(
    mols: Sequence[Dict[str, np.ndarray]],
    num_atoms: int,
    num_mol: Optional[int] = None,
    extra_atom_keys: Sequence[str] = (),
    float_dtype=np.float32,
    device="cpu",
) -> AtomicBatch:
    """Collate a list of per-molecule dicts ``{"z": (n,), "pos": (n, 3)}``,
    with the optional labels ``y`` (energy) and ``neg_dy`` (n, 3) (forces),
    the per-molecule ``q`` (charge) and ``s`` (spin), and the per-atom
    fields named by ``extra_atom_keys`` (into ``extra``), into one padded
    AtomicBatch, built on ``device`` (the CPU unless named).  A label, ``q``
    or ``s`` is carried when every molecule has it; padding rows are zero.
    The arrays are the JAX package's collation, bit for bit."""
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
    has_q = bool(mols) and all(m.get("q") is not None for m in mols)
    has_s = bool(mols) and all(m.get("s") is not None for m in mols)
    y = np.zeros((num_mol, 1), dtype=float_dtype) if has_y else None
    neg_dy = np.zeros((num_atoms, 3), dtype=float_dtype) if has_f else None
    q = np.zeros(num_mol, dtype=float_dtype) if has_q else None
    s = np.zeros(num_mol, dtype=float_dtype) if has_s else None
    extra = {key: np.zeros(num_atoms, dtype=float_dtype) for key in extra_atom_keys}
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
        if has_q:
            q[i] = np.asarray(m["q"]).reshape(-1)[0]
        if has_s:
            s[i] = np.asarray(m["s"]).reshape(-1)[0]
        for key in extra_atom_keys:
            extra[key][sl] = np.asarray(m[key]).reshape(n)
        offset += n

    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return AtomicBatch(
        z=t(z), pos=t(pos), batch=t(batch), atom_mask=t(atom_mask),
        mol_mask=t(mol_mask), num_mol=num_mol, y=t(y), neg_dy=t(neg_dy), q=t(q), s=t(s),
        extra={key: t(value) for key, value in extra.items()},
    )


def spatial_sort(batch: AtomicBatch, cell: float = 5.0) -> Tuple[AtomicBatch, torch.Tensor]:
    """Reorder atoms so that storage order follows space (cell-key sort).

    The JAX package's key (torchmdnet_tpu/data/batch.py:131-165): molecule id
    first, then the cutoff-wide cell's x, y, z, with a stable sort and padding
    atoms last, so molecule boundaries and segment reductions are untouched.
    Atom order means nothing to the models; per-atom outputs (forces) come
    back in the sorted order and map to the original one with the inverse
    permutation, ``forces_original = forces_sorted[torch.argsort(order)]``.
    Every tensor whose first axis is the atom axis moves with its atoms: the
    force labels (``neg_dy``) and the per-atom fields of ``extra`` (partial
    charges) too, as the JAX package permutes every such leaf.
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
    return batch.map_tensors(lambda t: t[order] if t.shape[:1] == (n,) else t), order
