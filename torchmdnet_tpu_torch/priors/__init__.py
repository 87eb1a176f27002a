"""Prior models (counterpart of torchmdnet_tpu/priors)."""

from torchmdnet_tpu_torch.priors.atomref import Atomref  # noqa: F401
from torchmdnet_tpu_torch.priors.base import BasePrior  # noqa: F401
from torchmdnet_tpu_torch.priors.coulomb import Coulomb  # noqa: F401
from torchmdnet_tpu_torch.priors.d2 import D2  # noqa: F401
from torchmdnet_tpu_torch.priors.zbl import ZBL  # noqa: F401

prior_class_mapping = {"Atomref": Atomref, "D2": D2, "ZBL": ZBL, "Coulomb": Coulomb}

__all__ = ["Atomref", "BasePrior", "Coulomb", "D2", "ZBL", "prior_class_mapping"]
