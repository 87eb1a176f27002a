"""QM9q: charged-species QM9 variant (counterpart of
torchmdnet_tpu/data/datasets/qm9q.py; reference datasets/qm9q.py).

HDF5 files with per-conformation energies, gradients, electronic charges and
dipoles; per-element/charge reference energies subtracted with a greedy charge
assignment (qm9q.py:89-119); extended memmap format with q/pq/dp.
"""

import hashlib
import os

import numpy as np

from torchmdnet_tpu_torch.data.datasets.mmap_base import (
    BOHR_TO_ANGSTROM,
    DEBYE_TO_EANG,
    HARTREE_TO_EV,
    MmapDataset,
)

ELEMENT_ENERGIES = {
    1: {0: -0.5013312007, 1: 0.0000000000},
    6: {-1: -37.8236383010, 0: -37.8038423252, 1: -37.3826165878},
    7: {-1: -54.4626446440, 0: -54.5269367415, 1: -53.9895574739},
    8: {-1: -74.9699154500, 0: -74.9812632126, 1: -74.4776884006},
    9: {-1: -99.6695561536, 0: -99.6185158728},
}

# lowest-energy ion per element (qm9q.py:25-29)
INITIAL_CHARGES = {
    element: sorted(zip(charges.values(), charges.keys()))[0][1]
    for element, charges in ELEMENT_ENERGIES.items()
}


def compute_reference_energy(atomic_numbers, charge):
    """Greedy per-element charge assignment (reference qm9q.py:89-119)."""
    atomic_numbers = np.asarray(atomic_numbers)
    charge = int(charge)
    charges = [INITIAL_CHARGES[z] for z in atomic_numbers]
    energy = sum(ELEMENT_ENERGIES[z][q] for z, q in zip(atomic_numbers, charges))
    while sum(charges) != charge:
        dq = np.sign(charge - sum(charges))
        new_energies = []
        for i, (z, q) in enumerate(zip(atomic_numbers, charges)):
            if (q + dq) in ELEMENT_ENERGIES[z]:
                new_energy = (
                    energy - ELEMENT_ENERGIES[z][q] + ELEMENT_ENERGIES[z][q + dq]
                )
                new_energies.append((new_energy, i, q + dq))
        energy, i, q = sorted(new_energies)[0]
        charges[i] = q
    assert sum(charges) == charge
    energy = sum(ELEMENT_ENERGIES[z][q] for z, q in zip(atomic_numbers, charges))
    return energy * HARTREE_TO_EV


class QM9q(MmapDataset):
    EXTRA_FIELDS = ("q", "pq", "dp")

    def __init__(self, root=None, paths=None, **kwargs):
        self.paths = str(paths if paths is not None else root)
        arg_hash = hashlib.md5(self.paths.encode()).hexdigest()
        self.atomic_number = list(range(100))
        self.distance_scale = 1e-10
        self.energy_scale = 1.602176634e-19
        super().__init__(root or ".", name=f"{self.__class__.__name__}-{arg_hash}")

    def _raw_paths(self):
        if os.path.isfile(self.paths):
            return [self.paths]
        if os.path.isdir(self.paths):
            return [
                os.path.join(self.paths, f)
                for f in sorted(os.listdir(self.paths))
                if f.endswith(".h5")
            ]
        raise RuntimeError(f"Cannot load {self.paths}")

    def sample_iter(self):
        import h5py

        for path in self._raw_paths():
            with h5py.File(path, "r") as f:
                molecules = list(f.values())[0].items()
                for _, mol in molecules:
                    z = np.asarray(mol["atomic_numbers"], dtype=np.int64)
                    for conf in mol["energy"]:
                        assert mol["positions"].attrs["units"] == "Å : ångströms"
                        pos = np.asarray(mol["positions"][conf], dtype=np.float32)
                        assert mol["energy"].attrs["units"] == "E_h : hartree"
                        y = np.float64(mol["energy"][conf][()]) * HARTREE_TO_EV
                        assert (
                            mol["gradient_vector"].attrs["units"]
                            == "vector : Hartree/Bohr "
                        )
                        neg_dy = (
                            -np.asarray(mol["gradient_vector"][conf], dtype=np.float32)
                            * HARTREE_TO_EV
                            / BOHR_TO_ANGSTROM
                        )
                        assert (
                            mol["electronic_charge"].attrs["units"]
                            == "n : fractional electrons"
                        )
                        pq = np.asarray(mol["electronic_charge"][conf], dtype=np.float32)
                        q = int(np.round(pq.sum()))
                        assert mol["dipole_moment"].attrs["units"] == "\\mu : Debye "
                        dp = (
                            np.asarray(mol["dipole_moment"][conf], dtype=np.float32)
                            * DEBYE_TO_EANG
                        )
                        y -= compute_reference_energy(z, q)
                        if np.linalg.norm(neg_dy, axis=1).max() > 100:  # eV/A
                            continue
                        yield {
                            "z": z,
                            "pos": pos,
                            "y": y,
                            "neg_dy": neg_dy,
                            "q": q,
                            "pq": pq,
                            "dp": dp,
                        }
