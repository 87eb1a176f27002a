"""MD22 large-molecule trajectory datasets (counterpart of
torchmdnet_tpu/data/datasets/md22.py; reference datasets/md22.py)."""

import os.path as osp

import numpy as np

from torchmdnet_tpu_torch.data.datasets.base import InMemoryArrays
from torchmdnet_tpu_torch.data.datasets.md17 import _download


class MD22(InMemoryArrays):
    gdml_url = "http://quantum-machine.org/gdml/data/npz"

    file_names = {
        "AT-AT-CG-CG": "md22_AT-AT-CG-CG.npz",
        "AT-AT": "md22_AT-AT.npz",
        "Ac-Ala3-NHMe": "md22_Ac-Ala3-NHMe.npz",
        "DHA": "md22_DHA.npz",
        "buckyball-catcher": "md22_buckyball-catcher.npz",
        "dw-nanotube": "md22_dw_nanotube.npz",
        "stachyose": "md22_stachyose.npz",
    }

    def __init__(self, root, molecules=None, dataset_arg=None, **kwargs):
        name = molecules or dataset_arg
        if name not in self.file_names:
            raise ValueError(f"Unknown dataset name '{name}'")
        self.name = name
        raw_dir = osp.join(root, name, "raw")
        raw_path = osp.join(raw_dir, self.file_names[name])
        if not osp.exists(raw_path):
            _download(f"{self.gdml_url}/{self.file_names[name]}", raw_dir)

        raw = np.load(raw_path)
        z = raw["z"].astype(np.int64)
        pos = raw["R"].astype(np.float32)
        energy = raw["E"].astype(np.float32).reshape(-1)
        force = raw["F"].astype(np.float32)

        n_frames, n_atoms = pos.shape[0], pos.shape[1]
        offsets = np.arange(n_frames + 1, dtype=np.int64) * n_atoms
        super().__init__(
            z=np.tile(z, n_frames),
            pos=pos.reshape(-1, 3),
            offsets=offsets,
            y=energy.reshape(-1, 1),
            neg_dy=force.reshape(-1, 3),
        )
