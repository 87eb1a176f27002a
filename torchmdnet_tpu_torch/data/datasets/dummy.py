"""In-memory random dataset for smoke tests and CI (counterpart of
torchmdnet_tpu/data/datasets/dummy.py: the same arrays from the same seed).

Equivalent of the reference's DummyDataset fake backend
(tests/utils.py:39-92): random molecules with optional energies, forces and
atomrefs, plus the prior-required attributes.
"""

import numpy as np

from torchmdnet_tpu_torch.data.datasets.base import MolecularDataset


class DummyDataset(MolecularDataset):
    def __init__(
        self,
        root=None,  # accepted first for CLI parity (DataModule passes it), unused
        num_samples=100,
        num_atoms=10,
        atom_types=(1, 6, 7, 8),
        has_energy=True,
        has_forces=True,
        has_atomref=False,
        seed=1234,
        **kwargs,
    ):
        rng = np.random.default_rng(seed)
        self.num_samples = num_samples
        self.z = rng.choice(atom_types, size=(num_samples, num_atoms)).astype(np.int64)
        self.pos = rng.standard_normal((num_samples, num_atoms, 3)).astype(np.float32)
        self.has_energy = has_energy
        self.has_forces = has_forces
        if has_energy:
            self.y = rng.standard_normal((num_samples, 1)).astype(np.float32)
        if has_forces:
            self.neg_dy = rng.standard_normal((num_samples, num_atoms, 3)).astype(
                np.float32
            )
        self.atomref = (
            rng.standard_normal((100, 1)).astype(np.float32) if has_atomref else None
        )

        # prior-required attributes
        self.atomic_number = list(range(100))
        self.distance_scale = 1e-10
        self.energy_scale = 1.60218e-19  # eV -> J

    def __len__(self):
        return self.num_samples

    def sample_sizes(self):
        return np.full(self.num_samples, self.z.shape[1])

    def __getitem__(self, idx):
        sample = {"z": self.z[idx], "pos": self.pos[idx]}
        if self.has_energy:
            sample["y"] = self.y[idx]
        if self.has_forces:
            sample["neg_dy"] = self.neg_dy[idx]
        return sample

    def get_atomref(self):
        return self.atomref
