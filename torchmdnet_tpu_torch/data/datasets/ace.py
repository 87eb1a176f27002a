""""Ace" HDF5 dataset layouts v1.0 / v2.0 (counterpart of
torchmdnet_tpu/data/datasets/ace.py; reference datasets/ace.py).

Samples carry total charge q, partial charges pq, and dipole moments dp in
addition to energies and forces; processed into the extended memmap format
(.q/.pq/.dp, datasets/ace.py:207-218).
"""

import hashlib
import os

import numpy as np

from torchmdnet_tpu_torch.data.datasets.mmap_base import MmapDataset


class Ace(MmapDataset):
    EXTRA_FIELDS = ("q", "pq", "dp")

    def __init__(
        self,
        root=None,
        paths=None,
        max_gradient=None,
        subsample_molecules=1,
        **kwargs,
    ):
        self.paths = paths if paths is not None else root
        self.max_gradient = max_gradient
        self.subsample_molecules = int(subsample_molecules)
        arg_hash = f"{self.paths}{max_gradient}{subsample_molecules}"
        arg_hash = hashlib.md5(arg_hash.encode()).hexdigest()
        self.atomic_number = list(range(100))
        self.distance_scale = 1e-10
        self.energy_scale = 1.602176634e-19
        super().__init__(root or ".", name=f"{self.__class__.__name__}-{arg_hash}")

    def _raw_paths(self):
        paths_init = self.paths if isinstance(self.paths, list) else [self.paths]
        paths = []
        for path in paths_init:
            if os.path.isfile(path):
                paths.append(path)
            elif os.path.isdir(path):
                paths.extend(
                    os.path.join(path, f)
                    for f in sorted(os.listdir(path))
                    if f.endswith(".h5")
                )
            else:
                raise RuntimeError(f"{path} is neither a directory nor a file")
        return paths

    @staticmethod
    def _load_confs_1_0(mol, n_atoms):
        for conf in mol["conformations"].values():
            if "formation_energy" not in conf:
                continue
            assert conf["positions"].attrs["units"] == "Å"
            pos = np.asarray(conf["positions"], dtype=np.float32)
            assert pos.shape == (n_atoms, 3)
            assert conf["formation_energy"].attrs["units"] == "eV"
            y = np.float64(conf["formation_energy"][()])
            assert conf["forces"].attrs["units"] == "eV/Å"
            neg_dy = np.asarray(conf["forces"], dtype=np.float32)
            assert conf["partial_charges"].attrs["units"] == "e"
            pq = np.asarray(conf["partial_charges"], dtype=np.float32)
            assert conf["dipole_moment"].attrs["units"] == "e*Å"
            dp = np.asarray(conf["dipole_moment"], dtype=np.float32)
            yield pos, y, neg_dy, pq, dp

    @staticmethod
    def _load_confs_2_0(mol, n_atoms):
        assert mol["positions"].attrs["units"] == "Å"
        all_pos = np.asarray(mol["positions"], dtype=np.float32)
        assert mol["formation_energies"].attrs["units"] == "eV"
        all_y = np.asarray(mol["formation_energies"], dtype=np.float64)
        assert mol["forces"].attrs["units"] == "eV/Å"
        all_neg_dy = np.asarray(mol["forces"], dtype=np.float32)
        assert mol["partial_charges"].attrs["units"] == "e"
        all_pq = np.asarray(mol["partial_charges"], dtype=np.float32)
        assert mol["dipole_moments"].attrs["units"] == "e*Å"
        all_dp = np.asarray(mol["dipole_moments"], dtype=np.float32)
        for pos, y, neg_dy, pq, dp in zip(all_pos, all_y, all_neg_dy, all_pq, all_dp):
            if np.isnan(y):
                continue
            yield pos, y, neg_dy, pq, dp

    def sample_iter(self):
        import h5py

        assert self.subsample_molecules > 0
        for path in self._raw_paths():
            with h5py.File(path, "r") as h5:
                assert h5.attrs["layout"] == "Ace"
                version = h5.attrs["layout_version"]
                if version == "1.0":
                    assert "name" in h5.attrs
                    mols = list(h5.items())
                    load_confs = self._load_confs_1_0
                elif version == "2.0":
                    assert len(h5.keys()) == 1
                    mols = list(list(h5.values())[0].items())
                    load_confs = self._load_confs_2_0
                else:
                    raise RuntimeError(f"Unsupported layout version: {version}")

                for i_mol, (_, mol) in enumerate(mols):
                    if i_mol % self.subsample_molecules != 0:
                        continue
                    z = np.asarray(mol["atomic_numbers"], dtype=np.int64)
                    fq = np.asarray(mol["formal_charges"], dtype=np.int64)
                    q = int(fq.sum())
                    for pos, y, neg_dy, pq, dp in load_confs(mol, n_atoms=len(z)):
                        if self.max_gradient:
                            if np.linalg.norm(neg_dy, axis=1).max() > float(
                                self.max_gradient
                            ):
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
