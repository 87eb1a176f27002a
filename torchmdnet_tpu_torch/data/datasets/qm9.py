"""QM9 dataset (134k small organic molecules, 12 regression targets;
counterpart of torchmdnet_tpu/data/datasets/qm9.py).

Torch-free equivalent of the reference wrapper (datasets/qm9.py) around PyG's
QM9: parses the raw figshare xyz archive (dsgdb9nsd.xyz.tar.bz2), removes the
3054 uncharacterized molecules, converts Hartree targets to eV with the same
conversion vector PyG applies, selects one target by ``label``, and exposes
``get_atomref`` padded to max_z (datasets/qm9.py:26-35).

Processing caches a single npz under <root>/processed/ (the mmap-preprocess
idea of datasets/ani.py applied to QM9).
"""

import os
import os.path as osp
import tarfile

import numpy as np

from torchmdnet_tpu_torch.data.datasets.base import InMemoryArrays

HAR2EV = 27.211386246
KCALMOL2EV = 0.04336414

# Target order of the first 12 QM9 targets (PyG qm9_target_dict).
qm9_target_dict = {
    0: "dipole_moment",
    1: "isotropic_polarizability",
    2: "homo",
    3: "lumo",
    4: "gap",
    5: "electronic_spatial_extent",
    6: "zpve",
    7: "energy_U0",
    8: "energy_U",
    9: "enthalpy_H",
    10: "free_energy",
    11: "heat_capacity",
}

# Hartree -> eV conversion per target (PyG convention).
_CONVERSION = np.array(
    [1.0, 1.0, HAR2EV, HAR2EV, HAR2EV, 1.0, HAR2EV, HAR2EV, HAR2EV, HAR2EV, HAR2EV, 1.0]
)

# Single-atom reference values in eV for H, C, N, O, F (QM9 atomref.txt
# thermochemistry converted Hartree->eV; identical to PyG's table).
_ATOMREFS = {
    6: [0.0, 0.0, 0.0, 0.0, 0.0],  # zpve
    7: [-13.61312172, -1029.86312267, -1485.30251237, -2042.61123593, -2713.48485589],
    8: [-13.5745904, -1029.82456413, -1485.26398105, -2042.5727046, -2713.44632457],
    9: [-13.54887564, -1029.79887659, -1485.2382935, -2042.54701705, -2713.42063702],
    10: [-13.90303183, -1030.25891228, -1485.71166277, -2043.01812778, -2713.88796536],
    11: [0.0, 0.0, 0.0, 0.0, 0.0],  # heat capacity
}
_ATOMREF_Z = [1, 6, 7, 8, 9]

_SYMBOL_TO_Z = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}

_RAW_URL = (
    "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets/"
    "gdb9.tar.gz"
)
_UNCHAR_URL = (
    "https://ndownloader.figshare.com/files/3195404"  # uncharacterized.txt
)


class QM9(InMemoryArrays):
    def __init__(self, root, label=None, dataset_arg=None, **kwargs):
        label = label or dataset_arg
        label2idx = dict(zip(qm9_target_dict.values(), qm9_target_dict.keys()))
        assert label in label2idx, (
            'Please pass the desired property to train on via "label". '
            f'Available properties are {", ".join(label2idx)}.'
        )
        self.label = label
        self.label_idx = label2idx[label]
        self.root = root

        processed = osp.join(root, "processed", "qm9_tpu.npz")
        if not osp.exists(processed):
            self._process(processed)
        data = np.load(processed)
        y = data["y"][:, self.label_idx].astype(np.float32).reshape(-1, 1)
        super().__init__(
            z=data["z"], pos=data["pos"], offsets=data["offsets"], y=y
        )

    def get_atomref(self, max_z=100):
        if self.label_idx not in _ATOMREFS:
            return None
        out = np.zeros((max_z, 1), dtype=np.float32)
        for zi, val in zip(_ATOMREF_Z, _ATOMREFS[self.label_idx]):
            if zi < max_z:
                out[zi, 0] = val
        return out

    # --- processing -------------------------------------------------------

    def _process(self, processed_path):
        raw_dir = osp.join(self.root, "raw")
        tar_candidates = [
            osp.join(raw_dir, "dsgdb9nsd.xyz.tar.bz2"),
            osp.join(raw_dir, "gdb9.tar.gz"),
        ]
        tar_path = next((p for p in tar_candidates if osp.exists(p)), None)
        if tar_path is None:
            from torchmdnet_tpu_torch.data.datasets.md17 import _download

            tar_path = _download(_RAW_URL, raw_dir)

        unchar_path = osp.join(raw_dir, "uncharacterized.txt")
        skip = set()
        if osp.exists(unchar_path):
            with open(unchar_path) as f:
                lines = f.read().split("\n")[9:-2]
            skip = {int(x.split()[0]) - 1 for x in lines if x.strip()}

        zs, poss, ys, sizes = [], [], [], []
        mode = "r:bz2" if tar_path.endswith("bz2") else "r:gz"
        with tarfile.open(tar_path, mode) as tar:
            members = sorted(
                (m for m in tar.getmembers() if m.name.endswith(".xyz")),
                key=lambda m: m.name,
            )
            for i, member in enumerate(members):
                if i in skip:
                    continue
                text = tar.extractfile(member).read().decode("utf-8")
                z, pos, targets = _parse_xyz(text)
                zs.append(z)
                poss.append(pos)
                ys.append(targets)
                sizes.append(len(z))

        offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=offsets[1:])
        y = np.asarray(ys, dtype=np.float64) * _CONVERSION
        os.makedirs(osp.dirname(processed_path), exist_ok=True)
        np.savez_compressed(
            processed_path,
            z=np.concatenate(zs).astype(np.int8),
            pos=np.concatenate(poss).astype(np.float32),
            offsets=offsets,
            y=y.astype(np.float32),
        )


def _parse_xyz(text):
    """Parse one dsgdb9nsd xyz file: returns (z, pos, 12 raw targets)."""
    lines = text.strip().split("\n")
    n = int(lines[0])
    # properties line: gdb tag idx A B C mu alpha homo lumo gap r2 zpve U0 U H G Cv
    props = lines[1].split()
    targets = np.array([float(p) for p in props[5:17]])  # mu..Cv (12 values)
    z = np.zeros(n, dtype=np.int64)
    pos = np.zeros((n, 3), dtype=np.float64)
    for i in range(n):
        parts = lines[2 + i].replace("*^", "e").split()
        z[i] = _SYMBOL_TO_Z[parts[0]]
        pos[i] = [float(parts[1]), float(parts[2]), float(parts[3])]
    return z, pos, targets
