"""Atomref prior: trainable per-element reference energies (counterpart of
torchmdnet_tpu/priors/atomref.py).

A (max_z, 1) table seeded from the dataset's ``get_atomref()`` and added to
each atom's scalar prediction before the reduction.
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from torchmdnet_tpu_torch.priors.base import BasePrior


class Atomref(BasePrior):
    def __init__(self, max_z: Optional[int] = None, initial_atomref: Optional[Sequence[float]] = None):
        super().__init__()
        if initial_atomref is None:
            if max_z is None:
                raise ValueError("Can't instantiate Atomref prior, all arguments are None.")
            initial = torch.zeros((max_z, 1), dtype=torch.float32)
        else:
            initial = torch.as_tensor(np.asarray(initial_atomref, dtype=np.float32)).reshape(-1, 1)
        self.max_z = int(initial.shape[0])
        self.atomref = nn.Parameter(initial)

    @staticmethod
    def from_dataset(dataset=None, max_z=None) -> "Atomref":
        """From the dataset's atomref table (zeros (100, 1) if it has none),
        else zeros (max_z, 1): the JAX package's factory."""
        if max_z is None and dataset is None:
            raise ValueError("Can't instantiate Atomref prior, all arguments are None.")
        atomref = None
        if dataset is not None:
            atomref = dataset.get_atomref()
            if atomref is None:
                atomref = np.zeros((100, 1))
        if atomref is None:
            atomref = np.zeros((max_z, 1))
        atomref = np.asarray(atomref).reshape(-1)
        return Atomref(initial_atomref=[float(v) for v in atomref])

    def get_init_args(self) -> Dict:
        return {"max_z": self.max_z}

    def pre_reduce(self, x, z, pos, batch_ids, atom_mask, extra=None):
        return x + self.atomref[z]
