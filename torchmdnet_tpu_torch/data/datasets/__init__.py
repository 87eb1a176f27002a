"""Dataset registry (counterpart of torchmdnet_tpu/data/datasets/__init__.py).

Samples are dicts of numpy arrays with keys z, pos and optionally y, neg_dy
(and, in the datasets still to port, q, s, pq, dp).  The registry names
every dataset of the JAX package; those whose files need a download are not
ported yet and raise.
"""

from torchmdnet_tpu_torch.data.datasets.base import InMemoryArrays, MolecularDataset, Subset  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.dummy import DummyDataset  # noqa: F401
from torchmdnet_tpu_torch.data.datasets.synthetic import SyntheticMorse  # noqa: F401

DATASETS_TODO = (
    "is not ported yet: its files need a download, and the port trains on the "
    "in-repo DummyDataset and SyntheticMorse so far (ROADMAP.md, 'Modules to "
    "port', slice D)"
)


def _not_ported(name):
    def make(*args, **kwargs):
        raise NotImplementedError(f"dataset {name!r} {DATASETS_TODO}")

    make.__name__ = name
    return make


_NOT_PORTED = ("Ace", "ANIMD", "ANI1", "ANI1CCX", "ANI1X", "COMP6v1", "Custom", "DrugBank",
               "GDB07to09", "GDB10to13", "HDF5", "MD17", "MD22", "QM9", "QM9q", "S66X8",
               "SPICE", "Tripeptides")
globals().update({name: _not_ported(name) for name in _NOT_PORTED})

__all__ = sorted(_NOT_PORTED + ("DummyDataset", "SyntheticMorse"))
