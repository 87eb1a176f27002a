"""ANI dataset family (counterpart of torchmdnet_tpu/data/datasets/ani.py;
reference datasets/ani.py).

ANI1 (20M conformers, HDF5 with byte species), ANI1X / ANI1CCX (single HDF5
with per-method energies/forces).  Energies are converted Hartree -> eV and
per-element self energies are subtracted at read time
(datasets/ani.py:22-26,158).
"""

import os
import os.path as osp

import numpy as np

from torchmdnet_tpu_torch.data.datasets.mmap_base import (
    HARTREE_TO_EV,
    MmapDataset,
    download_url,
)

_ANI1_ELEMENT_ENERGIES = {
    1: -0.500607632585,
    6: -37.8302333826,
    7: -54.5680045287,
    8: -75.0362229210,
}


class ANIBase(MmapDataset):
    ELEMENT_ENERGIES = _ANI1_ELEMENT_ENERGIES

    def __init__(self, root, **kwargs):
        # prior-required attributes (priors/zbl.py:13-17)
        self.atomic_number = list(range(100))
        self.distance_scale = 1e-10  # Angstrom
        self.energy_scale = 1.602176634e-19  # eV -> J
        super().__init__(root)

    def reference_energy(self, z):
        table = np.zeros(100)
        for zi, e in self.ELEMENT_ENERGIES.items():
            table[zi] = e
        return float(table[z].sum() * HARTREE_TO_EV)

    def get_atomref(self, max_z=100):
        refs = np.zeros((max_z, 1), dtype=np.float32)
        for zi, e in _ANI1_ELEMENT_ENERGIES.items():
            refs[zi, 0] = e * HARTREE_TO_EV
        return refs


class ANI1(ANIBase):
    raw_url = "https://ndownloader.figshare.com/files/9057631"

    def _raw_paths(self):
        return [
            osp.join(self.raw_dir, "ANI-1_release", f"ani_gdb_s{i:02d}.h5")
            for i in range(1, 9)
        ]

    def _ensure_raw(self):
        if all(osp.exists(p) for p in self._raw_paths()):
            return
        import tarfile

        archive = download_url(self.raw_url, self.raw_dir, "ANI1_release.tar.gz")
        with tarfile.open(archive) as tar:
            tar.extractall(self.raw_dir)
        os.remove(archive)

    def sample_iter(self):
        import h5py

        atomic_numbers = {b"H": 1, b"C": 6, b"N": 7, b"O": 8}
        for path in self._raw_paths():
            with h5py.File(path, "r") as f:
                molecules = list(f.values())[0].items()
                for _, mol in molecules:
                    z = np.array(
                        [atomic_numbers[a] for a in mol["species"]], dtype=np.int64
                    )
                    all_pos = np.asarray(mol["coordinates"], dtype=np.float32)
                    all_y = np.asarray(mol["energies"], dtype=np.float64) * HARTREE_TO_EV
                    assert all_pos.shape[0] == all_y.shape[0]
                    assert all_pos.shape[1] == z.shape[0]
                    for pos, y in zip(all_pos, all_y):
                        yield {"z": z, "pos": pos, "y": y}


class ANI1XBase(ANIBase):
    raw_url = "https://figshare.com/ndownloader/files/18112775"

    def _raw_paths(self):
        return [osp.join(self.raw_dir, "ani1x-release.h5")]

    def _ensure_raw(self):
        if not osp.exists(self._raw_paths()[0]):
            download_url(self.raw_url, self.raw_dir, "ani1x-release.h5")

    def get_atomref(self, max_z=100):
        import warnings

        warnings.warn("Atomic references from the ANI-1 dataset are used!")
        return super().get_atomref(max_z)


class ANI1X(ANI1XBase):
    def sample_iter(self):
        import h5py

        with h5py.File(self._raw_paths()[0], "r") as h5:
            for _, mol in h5.items():
                z = np.asarray(mol["atomic_numbers"], dtype=np.int64)
                all_pos = np.asarray(mol["coordinates"], dtype=np.float32)
                all_y = (
                    np.asarray(mol["wb97x_dz.energy"], dtype=np.float64) * HARTREE_TO_EV
                )
                all_neg_dy = (
                    np.asarray(mol["wb97x_dz.forces"], dtype=np.float32) * HARTREE_TO_EV
                )
                for pos, y, neg_dy in zip(all_pos, all_y, all_neg_dy):
                    if np.isnan(y) or np.isnan(neg_dy).any():
                        continue
                    yield {"z": z, "pos": pos, "y": y, "neg_dy": neg_dy}


class ANI1CCX(ANI1XBase):
    def sample_iter(self):
        import h5py

        with h5py.File(self._raw_paths()[0], "r") as h5:
            for _, mol in h5.items():
                z = np.asarray(mol["atomic_numbers"], dtype=np.int64)
                all_pos = np.asarray(mol["coordinates"], dtype=np.float32)
                all_y = (
                    np.asarray(mol["ccsd(t)_cbs.energy"], dtype=np.float64)
                    * HARTREE_TO_EV
                )
                for pos, y in zip(all_pos, all_y):
                    if np.isnan(y):
                        continue
                    yield {"z": z, "pos": pos, "y": y}
