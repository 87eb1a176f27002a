"""Memmap-preprocessed dataset base (counterpart of
torchmdnet_tpu/data/datasets/mmap_base.py).

Shared machinery for the HDF5-sourced dataset families (ANI, SPICE, COMP6,
Ace, QM9q), mirroring the reference's mmap preprocessing
(datasets/ani.py:96-145): a one-time pass converts the raw files into flat
``.idx/.z/.pos/.y/.neg_dy`` (plus optional ``.q/.pq/.dp``) memmaps with ragged
indexing via idx offsets, and per-sample reads are O(atoms) memmap slices.
"""

import os
import os.path as osp
from typing import Dict, Iterator

import numpy as np

from torchmdnet_tpu_torch.data.datasets.base import MolecularDataset

HARTREE_TO_EV = 27.211386246
BOHR_TO_ANGSTROM = 0.529177
DEBYE_TO_EANG = 0.2081943


class MmapDataset(MolecularDataset):
    """Subclasses implement sample_iter() and set EXTRA_FIELDS as needed.

    EXTRA_FIELDS may contain 'q' (per-mol, f32), 'pq' (per-atom, f32),
    'dp' (per-mol (3,), f32).
    """

    EXTRA_FIELDS = ()
    HAS_FORCES = True

    def __init__(self, root, name=None):
        self.root = root
        self.name = name or self.__class__.__name__
        self.raw_dir = osp.join(root, "raw")
        self.processed_dir = osp.join(root, "processed")
        if not all(osp.exists(p) for p in self._processed_paths()):
            os.makedirs(self.processed_dir, exist_ok=True)
            self._ensure_raw()
            self.process()
        self._open_memmaps()

    # --- subclass hooks ---------------------------------------------------

    def sample_iter(self) -> Iterator[Dict[str, np.ndarray]]:
        raise NotImplementedError

    def _ensure_raw(self):
        """Download raw files if missing (no-op when pre-placed)."""

    # --- processed file management ---------------------------------------

    def _processed_paths(self):
        fields = ["idx", "z", "pos", "y", "neg_dy"] + list(self.EXTRA_FIELDS)
        return [osp.join(self.processed_dir, f"{self.name}.{f}.mmap") for f in fields]

    def process(self):
        print(f"[{self.name}] Gathering statistics...")
        num_confs = 0
        num_atoms = 0
        has_neg_dy = False
        for data in self.sample_iter():
            num_confs += 1
            num_atoms += len(data["z"])
            has_neg_dy = "neg_dy" in data
        print(f"  Total number of conformers: {num_confs}")
        print(f"  Total number of atoms: {num_atoms}")

        paths = self._processed_paths()
        names = ["idx", "z", "pos", "y", "neg_dy"] + list(self.EXTRA_FIELDS)
        specs = {
            "idx": (np.int64, (num_confs + 1,)),
            "z": (np.int8, (num_atoms,)),
            "pos": (np.float32, (num_atoms, 3)),
            "y": (np.float64, (num_confs,)),
            "neg_dy": (np.float32, (num_atoms, 3)),
            "q": (np.int8, (num_confs,)),
            "pq": (np.float32, (num_atoms,)),
            "dp": (np.float32, (num_confs, 3)),
        }
        mms = {}
        for name, path in zip(names, paths):
            dtype, shape = specs[name]
            if (name == "neg_dy" and not has_neg_dy) or 0 in shape:
                open(path, "w").close()  # empty marker file
                mms[name] = None
                continue
            mms[name] = np.memmap(path + ".tmp", mode="w+", dtype=dtype, shape=shape)
        if num_confs == 0:
            # idx must still carry the [0] sentinel for the invariants below
            idx_path = paths[0]
            mm = np.memmap(idx_path + ".tmp", mode="w+", dtype=np.int64, shape=(1,))
            mm[0] = 0
            mm.flush()
            os.rename(idx_path + ".tmp", idx_path)
            return

        print(f"[{self.name}] Storing data...")
        i_atom = 0
        for i_conf, data in enumerate(self.sample_iter()):
            nxt = i_atom + len(data["z"])
            mms["idx"][i_conf] = i_atom
            mms["z"][i_atom:nxt] = data["z"]
            mms["pos"][i_atom:nxt] = data["pos"]
            mms["y"][i_conf] = data["y"]
            if has_neg_dy:
                mms["neg_dy"][i_atom:nxt] = data["neg_dy"]
            if "q" in mms:
                mms["q"][i_conf] = data.get("q", 0)
            if "pq" in mms:
                mms["pq"][i_atom:nxt] = data.get("pq", np.zeros(len(data["z"])))
            if "dp" in mms:
                mms["dp"][i_conf] = data.get("dp", np.zeros(3))
            i_atom = nxt
        mms["idx"][-1] = num_atoms
        assert i_atom == num_atoms

        for name, path in zip(names, paths):
            mm = mms[name]
            if mm is None:
                continue
            mm.flush()
            os.rename(path + ".tmp", path)

    def _open_memmaps(self):
        paths = self._processed_paths()
        names = ["idx", "z", "pos", "y", "neg_dy"] + list(self.EXTRA_FIELDS)
        p = dict(zip(names, paths))

        def open_mm(path, dtype, shape=None):
            if os.path.getsize(path) == 0:
                return np.zeros((0,) if shape is None else shape, dtype=dtype)
            return np.memmap(path, mode="r", dtype=dtype, shape=shape)

        self.idx_mm = open_mm(p["idx"], np.int64)
        self.z_mm = open_mm(p["z"], np.int8)
        n_at = self.z_mm.shape[0]
        self.pos_mm = open_mm(p["pos"], np.float32, (n_at, 3))
        self.y_mm = open_mm(p["y"], np.float64)
        self.neg_dy_mm = (
            np.memmap(p["neg_dy"], mode="r", dtype=np.float32, shape=(n_at, 3))
            if os.path.getsize(p["neg_dy"]) > 0
            else None
        )
        self.q_mm = open_mm(p["q"], np.int8) if "q" in self.EXTRA_FIELDS else None
        self.pq_mm = open_mm(p["pq"], np.float32) if "pq" in self.EXTRA_FIELDS else None
        self.dp_mm = (
            open_mm(p["dp"], np.float32, (len(self.y_mm), 3))
            if "dp" in self.EXTRA_FIELDS
            else None
        )
        assert self.idx_mm[0] == 0
        assert self.idx_mm[-1] == len(self.z_mm)
        assert len(self.idx_mm) == len(self.y_mm) + 1

    # --- reads ------------------------------------------------------------

    def __len__(self):
        return len(self.y_mm)

    def sample_sizes(self):
        return np.diff(self.idx_mm)

    def reference_energy(self, z):
        """Per-sample energy offset subtracted at read time; 0 by default."""
        return 0.0

    def __getitem__(self, idx):
        atoms = slice(int(self.idx_mm[idx]), int(self.idx_mm[idx + 1]))
        z = np.asarray(self.z_mm[atoms], dtype=np.int64)
        sample = {
            "z": z,
            "pos": np.asarray(self.pos_mm[atoms], dtype=np.float32),
            "y": np.asarray(
                [self.y_mm[idx] - self.reference_energy(z)], dtype=np.float32
            ),
        }
        if self.neg_dy_mm is not None:
            sample["neg_dy"] = np.asarray(self.neg_dy_mm[atoms], dtype=np.float32)
        if self.q_mm is not None:
            sample["q"] = np.asarray([self.q_mm[idx]], dtype=np.float32)
        if self.pq_mm is not None:
            sample["pq"] = np.asarray(self.pq_mm[atoms], dtype=np.float32)
        if self.dp_mm is not None:
            sample["dp"] = np.asarray(self.dp_mm[idx], dtype=np.float32)
        return sample


def download_url(url, folder, filename=None):
    import urllib.request

    os.makedirs(folder, exist_ok=True)
    filename = filename or url.rpartition("/")[2].split("?")[0]
    path = osp.join(folder, filename)
    if osp.exists(path):
        return path
    print(f"Downloading {url}")
    urllib.request.urlretrieve(url, path)
    return path
