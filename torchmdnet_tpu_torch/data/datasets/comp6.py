"""COMP6 benchmark suite (counterpart of
torchmdnet_tpu/data/datasets/comp6.py; reference datasets/comp6.py).

Six HDF5 subsets (ANI-MD, DrugBank, GDB7to9, GDB10to13, Tripeptides, S66x8)
in the ANI species/coordinates/energies/forces layout, plus the COMP6v1
superset that concatenates them.  Energies Hartree -> eV with ANI-1x
per-element reference energies subtracted during preprocessing
(comp6.py:86-127).
"""

import os.path as osp

import numpy as np

from torchmdnet_tpu_torch.data.datasets.base import MolecularDataset
from torchmdnet_tpu_torch.data.datasets.mmap_base import (
    HARTREE_TO_EV,
    MmapDataset,
    download_url,
)

_ELEMENT_ENERGIES = {
    1: -0.500607632585,
    6: -37.8302333826,
    7: -54.5680045287,
    8: -75.0362229210,
}
_ATOMIC_NUMBERS = {b"H": 1, b"C": 6, b"N": 7, b"O": 8}
_URL_PREFIX = "https://raw.githubusercontent.com/isayev/COMP6/master/COMP6v1"


class COMP6Base(MmapDataset):
    RAW_FILE_NAMES = []

    def __init__(self, root, **kwargs):
        self.atomic_number = list(range(100))
        self.distance_scale = 1e-10
        self.energy_scale = 1.602176634e-19
        super().__init__(root)

    @property
    def raw_url_name(self):
        return self.__class__.__name__

    def _raw_paths(self):
        return [osp.join(self.raw_dir, n) for n in self.RAW_FILE_NAMES]

    def _ensure_raw(self):
        for name, path in zip(self.RAW_FILE_NAMES, self._raw_paths()):
            if not osp.exists(path):
                download_url(f"{_URL_PREFIX}/{self.raw_url_name}/{name}", self.raw_dir, name)

    @staticmethod
    def compute_reference_energy(z):
        return sum(_ELEMENT_ENERGIES[zi] for zi in np.asarray(z)) * HARTREE_TO_EV

    def sample_iter(self):
        import h5py

        for path in self._raw_paths():
            with h5py.File(path, "r") as f:
                molecules = list(f.values())[0].items()
                for _, mol in molecules:
                    z = np.array(
                        [_ATOMIC_NUMBERS[a] for a in mol["species"]], dtype=np.int64
                    )
                    all_pos = np.asarray(mol["coordinates"], dtype=np.float32)
                    all_y = (
                        np.asarray(mol["energies"], dtype=np.float64) * HARTREE_TO_EV
                    )
                    all_neg_dy = (
                        np.asarray(mol["forces"], dtype=np.float32) * HARTREE_TO_EV
                    )
                    all_y -= self.compute_reference_energy(z)
                    for pos, y, neg_dy in zip(all_pos, all_y, all_neg_dy):
                        yield {"z": z, "pos": pos, "y": y, "neg_dy": neg_dy}

    def get_atomref(self, max_z=100):
        refs = np.zeros((max_z, 1), dtype=np.float32)
        for zi, e in _ELEMENT_ENERGIES.items():
            refs[zi, 0] = e * HARTREE_TO_EV
        return refs


class ANIMD(COMP6Base):
    RAW_FILE_NAMES = ["ani_md_bench.h5"]

    @property
    def raw_url_name(self):
        return "ANI-MD"


class DrugBank(COMP6Base):
    RAW_FILE_NAMES = ["drugbank_testset.h5"]


class GDB07to09(COMP6Base):
    RAW_FILE_NAMES = [
        "gdb11_07_test500.h5",
        "gdb11_08_test500.h5",
        "gdb11_09_test500.h5",
    ]


class GDB10to13(COMP6Base):
    RAW_FILE_NAMES = [
        "gdb11_10_test500.h5",
        "gdb11_11_test500.h5",
        "gdb13_12_test1000.h5",
        "gdb13_13_test1000.h5",
    ]


class Tripeptides(COMP6Base):
    RAW_FILE_NAMES = ["tripeptide_full.h5"]


class S66X8(COMP6Base):
    RAW_FILE_NAMES = ["s66x8_wb97x6-31gd.h5"]

    @property
    def raw_url_name(self):
        return "s66x8"


class COMP6v1(MolecularDataset):
    """Concatenation of the 6 subsets (comp6.py:372-404)."""

    def __init__(self, root, **kwargs):
        self.subsets = [
            DS(root)
            for DS in (ANIMD, DrugBank, GDB07to09, GDB10to13, Tripeptides, S66X8)
        ]
        self.atomic_number = list(range(100))
        self.distance_scale = 1e-10
        self.energy_scale = 1.602176634e-19
        self.subset_indices = np.array(
            [
                (i_subset, i_sample)
                for i_subset, subset in enumerate(self.subsets)
                for i_sample in range(len(subset))
            ]
        )

    def __len__(self):
        return len(self.subset_indices)

    def sample_sizes(self):
        return np.concatenate([s.sample_sizes() for s in self.subsets])

    def __getitem__(self, idx):
        i_subset, i_sample = self.subset_indices[idx]
        return self.subsets[i_subset][i_sample]

    def get_atomref(self, max_z=100):
        return self.subsets[0].get_atomref(max_z)
