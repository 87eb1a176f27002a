"""Padded batches of molecules (counterpart of torchmdnet_tpu/data/batch.py).

A batch is padded to a fixed (num_atoms, num_mol) capacity:

- padding atoms have atom_mask False, z = 0, pos = 0, and batch id equal to
  ``num_mol`` (a trash segment sliced off after reduction);
- padding molecules have mol_mask False.
"""

import dataclasses
from typing import Dict, Optional, Sequence

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

    @property
    def num_atoms(self) -> int:
        return self.z.shape[0]

    def replace(self, **changes) -> "AtomicBatch":
        return dataclasses.replace(self, **changes)


def pad_molecules(
    mols: Sequence[Dict[str, np.ndarray]],
    num_atoms: int,
    num_mol: Optional[int] = None,
    float_dtype=np.float32,
    device="cpu",
) -> AtomicBatch:
    """Collate a list of per-molecule dicts ``{"z": (n,), "pos": (n, 3)}``
    into one padded AtomicBatch, built on ``device`` (the CPU unless named).
    Labels (energies, forces, charges) arrive with the trainer."""
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
    offset = 0
    for i, m in enumerate(mols):
        n = len(m["z"])
        sl = slice(offset, offset + n)
        z[sl] = m["z"]
        pos[sl] = m["pos"]
        batch[sl] = i
        atom_mask[sl] = True
        mol_mask[i] = True
        offset += n

    def t(a):
        return torch.as_tensor(a, device=device)

    return AtomicBatch(
        z=t(z), pos=t(pos), batch=t(batch), atom_mask=t(atom_mask),
        mol_mask=t(mol_mask), num_mol=num_mol,
    )
