"""Dataset base classes (counterpart of torchmdnet_tpu/data/datasets/base.py).

A dataset is a sequence of per-molecule sample dicts (numpy arrays):
``{z (n,), pos (n, 3), y? (1,), neg_dy? (n, 3), q? (1,), s? (1,), pq? (n,),
dp? (3,)}`` — the reference's Data schema (README.md:53-57).

Datasets used by priors additionally expose ``atomic_number``,
``distance_scale``, ``energy_scale`` (reference priors/zbl.py:13-17) and
``get_atomref()`` (priors/atomref.py:9-12).
"""

from typing import Dict, Optional, Sequence

import numpy as np


class MolecularDataset:
    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def get_atomref(self) -> Optional[np.ndarray]:
        return None

    def sample_sizes(self) -> np.ndarray:
        """Number of atoms per sample; used for padding/bucketing decisions.

        Subclasses should override with an O(1)-per-sample implementation.
        """
        return np.array([len(self[i]["z"]) for i in range(len(self))])


class Subset(MolecularDataset):
    """Index-based view of another dataset (torch.utils.data.Subset analog)."""

    def __init__(self, dataset: MolecularDataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[int(self.indices[idx])]

    def get_atomref(self):
        return self.dataset.get_atomref()

    def sample_sizes(self):
        return self.dataset.sample_sizes()[self.indices]

    def __getattr__(self, name):
        # forward prior-required attributes (atomic_number, scales, ...)
        return getattr(self.dataset, name)


class InMemoryArrays(MolecularDataset):
    """Flat-array storage: concatenated atoms with per-sample offsets.

    Ragged samples live in contiguous arrays indexed by offsets, which also
    makes sample_sizes O(1).
    """

    def __init__(
        self,
        z: np.ndarray,
        pos: np.ndarray,
        offsets: np.ndarray,
        y: Optional[np.ndarray] = None,
        neg_dy: Optional[np.ndarray] = None,
        q: Optional[np.ndarray] = None,
        s: Optional[np.ndarray] = None,
        pq: Optional[np.ndarray] = None,
        dp: Optional[np.ndarray] = None,
    ):
        self.z = z
        self.pos = pos
        self.offsets = offsets  # (num_samples + 1,)
        self.y = y
        self.neg_dy = neg_dy
        self.q = q
        self.s = s
        self.pq = pq
        self.dp = dp

    def __len__(self):
        return len(self.offsets) - 1

    def sample_sizes(self):
        return np.diff(self.offsets)

    def __getitem__(self, idx):
        lo, hi = int(self.offsets[idx]), int(self.offsets[idx + 1])
        sample = {
            "z": np.asarray(self.z[lo:hi], dtype=np.int64),
            "pos": np.asarray(self.pos[lo:hi], dtype=np.float32),
        }
        if self.y is not None:
            sample["y"] = np.asarray(self.y[idx]).reshape(1)
        if self.neg_dy is not None:
            sample["neg_dy"] = np.asarray(self.neg_dy[lo:hi], dtype=np.float32)
        if self.q is not None:
            sample["q"] = np.asarray(self.q[idx]).reshape(1)
        if self.s is not None:
            sample["s"] = np.asarray(self.s[idx]).reshape(1)
        if self.pq is not None:
            sample["pq"] = np.asarray(self.pq[lo:hi], dtype=np.float32)
        if self.dp is not None:
            sample["dp"] = np.asarray(self.dp[idx], dtype=np.float32).reshape(3)
        return sample
