"""Glob-driven NumPy-file dataset (counterpart of
torchmdnet_tpu/data/datasets/custom.py).

Equivalent of reference datasets/custom.py: coordinate/embedding files are
required, energies and/or forces optional; per-frame reads go through
np.load(mmap_mode='r') so large trajectory files never load fully.
"""

import glob

import numpy as np

from torchmdnet_tpu_torch.data.datasets.base import MolecularDataset


class Custom(MolecularDataset):
    def __init__(self, coordglob, embedglob, energyglob=None, forceglob=None, **kwargs):
        assert energyglob is not None or forceglob is not None, (
            "Either energies, forces or both must be specified as the target"
        )
        self.has_energies = energyglob is not None
        self.has_forces = forceglob is not None

        self.coordfiles = sorted(glob.glob(coordglob))
        self.embedfiles = sorted(glob.glob(embedglob))
        self.energyfiles = sorted(glob.glob(energyglob)) if self.has_energies else None
        self.forcefiles = sorted(glob.glob(forceglob)) if self.has_forces else None

        assert len(self.coordfiles) == len(self.embedfiles), (
            f"Number of coordinate files {len(self.coordfiles)} "
            f"does not match number of embed files {len(self.embedfiles)}."
        )
        if self.has_energies:
            assert len(self.coordfiles) == len(self.energyfiles)
        if self.has_forces:
            assert len(self.coordfiles) == len(self.forcefiles)

        # index: (file id, frame id) per sample, with consistency checks as in
        # the reference (datasets/custom.py:64-90)
        self.index = []
        self._sizes = []
        for i in range(len(self.coordfiles)):
            coord = np.load(self.coordfiles[i], mmap_mode="r")
            embed = np.load(self.embedfiles[i]).astype(int)
            assert coord.shape[1] == embed.shape[0], (
                f"Number of atoms in coordinate file {i} ({coord.shape[1]}) "
                f"does not match embed file {i} ({embed.shape[0]})."
            )
            if self.has_energies:
                energy = np.load(self.energyfiles[i], mmap_mode="r")
                assert coord.shape[0] == energy.shape[0]
            if self.has_forces:
                force = np.load(self.forcefiles[i], mmap_mode="r")
                assert coord.shape == force.shape
            n_frames = coord.shape[0]
            self.index.extend((i, j) for j in range(n_frames))
            self._sizes.extend([embed.shape[0]] * n_frames)

    def __len__(self):
        return len(self.index)

    def sample_sizes(self):
        return np.asarray(self._sizes)

    def __getitem__(self, idx):
        fileid, frame = self.index[idx]
        coord = np.array(np.load(self.coordfiles[fileid], mmap_mode="r")[frame])
        embed = np.load(self.embedfiles[fileid]).astype(np.int64)
        sample = {"z": embed, "pos": coord.astype(np.float32)}
        if self.has_energies:
            e = np.array(np.load(self.energyfiles[fileid], mmap_mode="r")[frame])
            sample["y"] = e.reshape(1).astype(np.float32)
        if self.has_forces:
            f = np.array(np.load(self.forcefiles[fileid], mmap_mode="r")[frame])
            sample["neg_dy"] = f.astype(np.float32)
        return sample
