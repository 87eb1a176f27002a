"""Prior models (counterpart of torchmdnet_tpu/priors).  Atomref is ported;
the pair priors raise until they are."""

from torchmdnet_tpu_torch.priors.atomref import Atomref  # noqa: F401
from torchmdnet_tpu_torch.priors.base import BasePrior  # noqa: F401

PRIORS_TODO = (
    "only the Atomref prior is ported so far; ZBL, Coulomb and D2 follow "
    "(ROADMAP.md, 'Modules to port', item 5)"
)


def _not_ported(name):
    def make(*args, **kwargs):
        raise NotImplementedError(f"prior {name!r}: {PRIORS_TODO}")

    return make


prior_class_mapping = {
    "Atomref": Atomref,
    "D2": _not_ported("D2"),
    "ZBL": _not_ported("ZBL"),
    "Coulomb": _not_ported("Coulomb"),
}

__all__ = ["Atomref", "BasePrior", "prior_class_mapping"]
