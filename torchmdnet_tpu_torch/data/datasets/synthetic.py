"""Synthetic pair-potential dataset with exact energies and forces
(counterpart of torchmdnet_tpu/data/datasets/synthetic.py: the same arrays
from the same seed).

Random molecular configurations labeled by an analytic Morse pair potential
(per-element-pair depths/ranges).  Because labels are exact and cheap, this
dataset demonstrates end-to-end learnability of the framework (energy MAE and
force MAE driven to small values) without any downloads — the closed-form
analog of the reference's DummyDataset, but with physics to learn.
"""

import numpy as np

from torchmdnet_tpu_torch.data.datasets.base import MolecularDataset


class SyntheticMorse(MolecularDataset):
    """E = sum_pairs eps_ij [exp(-2 a (r - r0_ij)) - 2 exp(-a (r - r0_ij))]"""

    def __init__(
        self,
        root=None,
        num_samples=2000,
        num_atoms=8,
        atom_types=(1, 6, 7, 8),
        cell=4.0,
        alpha=1.5,
        seed=0,
        **kwargs,
    ):
        rng = np.random.default_rng(seed)
        self.num_samples = num_samples
        types = np.asarray(atom_types)
        self.z = rng.choice(types, size=(num_samples, num_atoms)).astype(np.int64)
        # keep atoms from overlapping: jittered grid positions
        side = int(np.ceil(num_atoms ** (1 / 3)))
        grid = np.stack(
            np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), axis=-1
        ).reshape(-1, 3)[:num_atoms]
        base = grid * (cell / side)
        self.pos = (
            base[None, :, :]
            + rng.uniform(-0.3, 0.3, size=(num_samples, num_atoms, 3))
        ).astype(np.float32)

        # per-element-pair Morse parameters
        zmax = int(types.max()) + 1
        eps_el = rng.uniform(0.1, 0.5, zmax)
        r0_el = rng.uniform(1.2, 2.2, zmax)
        self.alpha = alpha
        self._eps = np.sqrt(np.outer(eps_el, eps_el))
        self._r0 = 0.5 * (r0_el[:, None] + r0_el[None, :])

        self.y = np.zeros((num_samples, 1), np.float32)
        self.neg_dy = np.zeros((num_samples, num_atoms, 3), np.float32)
        for i in range(num_samples):
            e, f = self._energy_forces(self.z[i], self.pos[i].astype(np.float64))
            self.y[i, 0] = e
            self.neg_dy[i] = f

        self.atomic_number = list(range(100))
        self.distance_scale = 1e-10
        self.energy_scale = 1.602176634e-19

    def _energy_forces(self, z, pos):
        n = len(z)
        e = 0.0
        f = np.zeros((n, 3))
        for i in range(n):
            for j in range(i + 1, n):
                d = pos[i] - pos[j]
                r = np.linalg.norm(d)
                eps = self._eps[z[i], z[j]]
                r0 = self._r0[z[i], z[j]]
                ex = np.exp(-self.alpha * (r - r0))
                e += eps * (ex * ex - 2 * ex)
                # dE/dr = eps * (-2a ex^2 + 2a ex)
                dedr = eps * 2 * self.alpha * (ex - ex * ex)
                grad_i = dedr * d / r
                f[i] -= grad_i
                f[j] += grad_i
        return e, f

    def __len__(self):
        return self.num_samples

    def sample_sizes(self):
        return np.full(self.num_samples, self.z.shape[1])

    def __getitem__(self, idx):
        return {
            "z": self.z[idx],
            "pos": self.pos[idx],
            "y": self.y[idx],
            "neg_dy": self.neg_dy[idx],
        }

    def get_atomref(self):
        return None
