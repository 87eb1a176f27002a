"""MD17 / revised MD17 / CCSD trajectory datasets (counterpart of
torchmdnet_tpu/data/datasets/md17.py).

Equivalent of reference datasets/md17.py: npz trajectories (energies +
forces) for the GDML molecules, including the revised (rMD17) and CCSD
variants.  Raw npz files are expected under <root>/...; download is attempted
only if files are missing (offline environments simply pre-place the files).
"""

import os
import os.path as osp

import numpy as np

from torchmdnet_tpu_torch.data.datasets.base import InMemoryArrays


def _download(url, folder):
    import urllib.request

    os.makedirs(folder, exist_ok=True)
    filename = osp.join(folder, url.rpartition("/")[2].split("?")[0])
    print(f"Downloading {url}")
    urllib.request.urlretrieve(url, filename)
    return filename


class MD17(InMemoryArrays):
    gdml_url = "http://quantum-machine.org/gdml/data/npz"
    revised_url = (
        "https://archive.materialscloud.org/record/"
        "file?filename=rmd17.tar.bz2&record_id=466"
    )

    file_names = {
        "benzene": "md17_benzene2017.npz",
        "uracil": "md17_uracil.npz",
        "naphtalene": "md17_naphthalene.npz",
        "aspirin": "md17_aspirin.npz",
        "salicylic_acid": "md17_salicylic.npz",
        "malonaldehyde": "md17_malonaldehyde.npz",
        "ethanol": "md17_ethanol.npz",
        "toluene": "md17_toluene.npz",
        "paracetamol": "paracetamol_dft.npz",
        "azobenzene": "azobenzene_dft.npz",
        "revised_benzene": "rmd17_benzene.npz",
        "revised_uracil": "rmd17_uracil.npz",
        "revised_naphthalene": "rmd17_naphthalene.npz",
        "revised_aspirin": "rmd17_aspirin.npz",
        "revised_salicylic_acid": "rmd17_salicylic.npz",
        "revised_malonaldehyde": "rmd17_malonaldehyde.npz",
        "revised_ethanol": "rmd17_ethanol.npz",
        "revised_toluene": "rmd17_toluene.npz",
        "revised_paracetamol": "rmd17_paracetamol.npz",
        "revised_azobenzene": "rmd17_azobenzene.npz",
        "benzene_CCSD_T": "benzene_ccsd_t.zip",
        "aspirin_CCSD": "aspirin_ccsd.zip",
        "malonaldehyde_CCSD_T": "malonaldehyde_ccsd_t.zip",
        "ethanol_CCSD_T": "ethanol_ccsd_t.zip",
        "toluene_CCSD_T": "toluene_ccsd_t.zip",
        "benzene_FHI-aims": "benzene2018_dft.npz",
    }

    def __init__(self, root, molecules=None, dataset_arg=None, train=None, **kwargs):
        name = molecules or dataset_arg
        if name not in self.file_names:
            raise ValueError(f"Unknown dataset name '{name}'")
        self.name = name
        self.revised = "revised" in name
        self.ccsd = "CCSD" in name

        raw_dir = (
            osp.join(root, "raw") if self.revised else osp.join(root, name, "raw")
        )
        raw_paths = self._raw_paths(raw_dir)
        if not all(osp.exists(p) for p in raw_paths):
            self._download(raw_dir)

        if self.ccsd:
            if train is None:
                raise ValueError(
                    f"'{name}' provides pre-defined splits but 'train' was not "
                    "specified"
                )
            raw = np.load(raw_paths[0 if train else 1])
        else:
            if train is not None:
                raise ValueError(
                    f"'{name}' does not provide pre-defined splits but 'train' "
                    f"is set to '{train}'"
                )
            raw = np.load(raw_paths[0])

        if self.revised:
            z = raw["nuclear_charges"].astype(np.int64)
            pos = raw["coords"].astype(np.float32)
            energy = raw["energies"].astype(np.float32)
            force = raw["forces"].astype(np.float32)
        else:
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

    def _raw_paths(self, raw_dir):
        name = self.file_names[self.name]
        if self.revised:
            return [osp.join(raw_dir, "rmd17", "npz_data", name)]
        if self.ccsd:
            base = name[:-4]
            return [
                osp.join(raw_dir, base + "-train.npz"),
                osp.join(raw_dir, base + "-test.npz"),
            ]
        return [osp.join(raw_dir, name)]

    def _download(self, raw_dir):
        if self.revised:
            import tarfile

            path = _download(self.revised_url, raw_dir)
            with tarfile.open(path, "r:bz2") as tar:
                tar.extractall(raw_dir)
            os.unlink(path)
        else:
            path = _download(f"{self.gdml_url}/{self.file_names[self.name]}", raw_dir)
            if self.ccsd:
                import zipfile

                with zipfile.ZipFile(path) as zf:
                    zf.extractall(raw_dir)
                os.unlink(path)
