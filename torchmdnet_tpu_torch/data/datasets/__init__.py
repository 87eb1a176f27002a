"""Dataset registry (counterpart of torchmdnet_tpu/data/datasets/__init__.py).

Samples are dicts of numpy arrays with keys z, pos and optionally y, neg_dy,
q, s, pq (per-atom partial charges, which the loader carries to the Coulomb
prior) and dp.  The readers are numpy only; those of HDF5 files import h5py
when they read one, so importing the registry needs no h5py.
"""

from torchmdnet_tpu_torch.data.datasets.ace import Ace  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.ani import ANI1, ANI1CCX, ANI1X  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.base import InMemoryArrays, MolecularDataset, Subset  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.comp6 import (  # noqa: F401
    ANIMD,
    COMP6v1,
    DrugBank,
    GDB07to09,
    GDB10to13,
    S66X8,
    Tripeptides,
)
from torchmdnet_tpu_torch.data.datasets.custom import Custom  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.dummy import DummyDataset  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.hdf import HDF5  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.md17 import MD17  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.md22 import MD22  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.qm9 import QM9  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.qm9q import QM9q  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.spice import SPICE  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.synthetic import SyntheticMorse  # noqa: F401

__all__ = [
    "Ace",
    "ANIMD",
    "ANI1",
    "ANI1CCX",
    "ANI1X",
    "COMP6v1",
    "Custom",
    "DrugBank",
    "DummyDataset",
    "GDB07to09",
    "GDB10to13",
    "HDF5",
    "MD17",
    "MD22",
    "QM9",
    "QM9q",
    "S66X8",
    "SPICE",
    "SyntheticMorse",
    "Tripeptides",
]
