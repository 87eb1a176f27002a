"""SPICE dataset (counterpart of torchmdnet_tpu/data/datasets/spice.py;
reference datasets/spice.py; openmm/spice-dataset).

Versions 1.0-1.1.3, subset filtering, max-gradient filtering, molecule
subsampling, Bohr -> Angstrom and Hartree -> eV conversion, memmap-processed.
"""

import hashlib
import os.path as osp

import numpy as np

from torchmdnet_tpu_torch.data.datasets.mmap_base import (
    BOHR_TO_ANGSTROM,
    HARTREE_TO_EV,
    MmapDataset,
    download_url,
)


class SPICE(MmapDataset):
    VERSIONS = {
        "1.0": {
            "url": "https://github.com/openmm/spice-dataset/releases/download/1.0",
            "file": "SPICE.hdf5",
        },
        "1.1": {
            "url": "https://github.com/openmm/spice-dataset/releases/download/1.1",
            "file": "SPICE.hdf5",
        },
        "1.1.1": {"url": "https://zenodo.org/record/7258940/files", "file": "SPICE-1.1.1.hdf5"},
        "1.1.2": {"url": "https://zenodo.org/record/7338495/files", "file": "SPICE-1.1.2.hdf5"},
        "1.1.3": {"url": "https://zenodo.org/record/7606550/files", "file": "SPICE-1.1.3.hdf5"},
    }

    def __init__(
        self,
        root,
        version="1.1.3",
        subsets=None,
        max_gradient=None,
        subsample_molecules=1,
        **kwargs,
    ):
        self.version = str(version)
        assert self.version in self.VERSIONS
        self.subsets = subsets
        self.max_gradient = max_gradient
        self.subsample_molecules = int(subsample_molecules)
        arg_hash = f"{version}{subsets}{max_gradient}{subsample_molecules}"
        arg_hash = hashlib.md5(arg_hash.encode()).hexdigest()
        self.atomic_number = list(range(100))
        self.distance_scale = 1e-10
        self.energy_scale = 1.602176634e-19
        super().__init__(root, name=f"{self.__class__.__name__}-{arg_hash}")

    def _raw_path(self):
        return osp.join(
            self.raw_dir, self.version, self.VERSIONS[self.version]["file"]
        )

    def _ensure_raw(self):
        if not osp.exists(self._raw_path()):
            v = self.VERSIONS[self.version]
            download_url(
                f"{v['url']}/{v['file']}", osp.join(self.raw_dir, self.version), v["file"]
            )

    def sample_iter(self):
        import h5py

        assert self.subsample_molecules > 0
        with h5py.File(self._raw_path(), "r") as f:
            for i_mol, (_, mol) in enumerate(f.items()):
                if self.subsets:
                    if mol["subset"][0].decode() not in list(self.subsets):
                        continue
                if i_mol % self.subsample_molecules != 0:
                    continue
                z = np.asarray(mol["atomic_numbers"], dtype=np.int64)
                all_pos = (
                    np.asarray(mol["conformations"], dtype=np.float32)
                    * BOHR_TO_ANGSTROM
                )
                all_y = (
                    np.asarray(mol["formation_energy"], dtype=np.float64)
                    * HARTREE_TO_EV
                )
                all_neg_dy = (
                    -np.asarray(mol["dft_total_gradient"], dtype=np.float32)
                    * HARTREE_TO_EV
                    / BOHR_TO_ANGSTROM
                )
                assert all_pos.shape[0] == all_y.shape[0]
                assert all_pos.shape[1] == z.shape[0]
                for pos, y, neg_dy in zip(all_pos, all_y, all_neg_dy):
                    if self.max_gradient:
                        if np.linalg.norm(neg_dy, axis=1).max() > float(
                            self.max_gradient
                        ):
                            continue
                    yield {"z": z, "pos": pos, "y": y, "neg_dy": neg_dy}
