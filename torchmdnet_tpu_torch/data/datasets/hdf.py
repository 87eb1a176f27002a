"""Generic multi-file HDF5 dataset (counterpart of
torchmdnet_tpu/data/datasets/hdf.py).

Equivalent of reference datasets/hdf.py: each group holds same-size samples
with arrays 'types', 'pos', 'energy' and optionally 'forces' and
'partial_charges'; a '_metadata' group maps to dataset attributes; file
handles open lazily so worker processes never inherit open fds
(datasets/hdf.py:70-76).
"""

import numpy as np

from torchmdnet_tpu_torch.data.datasets.base import MolecularDataset


class HDF5(MolecularDataset):
    def __init__(self, filename, dataset_root=None, **kwargs):
        import h5py

        self.filename = filename if filename is not None else dataset_root
        self.index = None
        self.fields = None
        self.num_molecules = 0
        self._sizes = []
        for fn in self.filename.split(";"):
            with h5py.File(fn, "r") as f:
                for group_name in f:
                    group = f[group_name]
                    if group_name == "_metadata":
                        for name in group:
                            setattr(self, name, np.array(group[name]))
                        continue
                    count = len(group["energy"])
                    self.num_molecules += count
                    n_atoms = group["pos"].shape[1] if group["pos"].ndim == 3 else len(group["types"])
                    self._sizes.extend([n_atoms] * count)
                    if self.fields is None:
                        self.fields = [("pos", "pos"), ("z", "types"), ("y", "energy")]
                        if "forces" in group:
                            self.fields.append(("neg_dy", "forces"))
                        if "partial_charges" in group:
                            self.fields.append(("pq", "partial_charges"))

    def _setup_index(self):
        import h5py

        self.index = []
        self._files = [h5py.File(fn, "r") for fn in self.filename.split(";")]
        for f in self._files:
            for group_name in f:
                if group_name == "_metadata":
                    continue
                group = f[group_name]
                data = tuple(group[src] for _, src in self.fields)
                for i in range(len(group["energy"])):
                    self.index.append(data + (i,))
        assert self.num_molecules == len(self.index), (
            "Mismatch between previously calculated molecule count and actual "
            "molecule count"
        )

    def __len__(self):
        return self.num_molecules

    def sample_sizes(self):
        return np.asarray(self._sizes)

    def __getitem__(self, idx):
        if self.index is None:
            self._setup_index()
        entry = self.index[idx]
        i = entry[-1]
        sample = {}
        for j, (out_key, _) in enumerate(self.fields):
            d = entry[j]
            if d.ndim == 1:
                sample[out_key] = np.asarray([d[i]])
            else:
                sample[out_key] = np.asarray(d[i])
        sample["z"] = sample["z"].astype(np.int64).reshape(-1)
        sample["pos"] = sample["pos"].astype(np.float32)
        if "y" in sample:
            sample["y"] = np.asarray(sample["y"], dtype=np.float32).reshape(1)
        if "neg_dy" in sample:
            sample["neg_dy"] = sample["neg_dy"].astype(np.float32)
        return sample
