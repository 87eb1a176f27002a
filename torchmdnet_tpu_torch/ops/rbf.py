"""Radial basis function expansions (counterpart of torchmdnet_tpu/ops/rbf.py).

GaussianSmearing and ExpNormalSmearing as ``nn.Module``s; ``trainable=True``
registers the shape constants as parameters, else as buffers.  The constants
are computed in ``buffer_dtype`` (float32 for ET, whose reference omits the
dtype when building its RBF) and held in the module's dtype.
``torch.linspace`` gives natively the buffers that the JAX package emulates.
"""

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff


class _Smearing(nn.Module):
    def _register(self, name: str, value: torch.Tensor, trainable: bool):
        if trainable:
            self.register_parameter(name, nn.Parameter(value))
        else:
            self.register_buffer(name, value)


class GaussianSmearing(_Smearing):
    def __init__(
        self,
        cutoff_lower: float = 0.0,
        cutoff_upper: float = 5.0,
        num_rbf: int = 50,
        trainable: bool = True,
        buffer_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        bdt = buffer_dtype or torch.float32
        offset = torch.linspace(cutoff_lower, cutoff_upper, num_rbf, dtype=bdt)
        coeff = -0.5 / (offset[1] - offset[0]) ** 2
        self._register("offset", offset, trainable)
        self._register("coeff", coeff, trainable)

    def forward(self, dist):
        d = dist[..., None] - self.offset
        return torch.exp(self.coeff * d * d)


class ExpNormalSmearing(_Smearing):
    def __init__(
        self,
        cutoff_lower: float = 0.0,
        cutoff_upper: float = 5.0,
        num_rbf: int = 50,
        trainable: bool = True,
        buffer_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        bdt = buffer_dtype or torch.float32
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.alpha = 5.0 / (cutoff_upper - cutoff_lower)
        # exp of the f64 value rounded once to the buffer dtype, as the
        # reference's float32 torch.exp returns it
        npdt = np.float32 if bdt == torch.float32 else np.float64
        start = np.asarray(math.exp(-cutoff_upper + cutoff_lower), npdt)
        means = torch.linspace(float(start), 1.0, num_rbf, dtype=bdt)
        beta = (np.asarray(2.0 / num_rbf, npdt) * (1 - start)) ** -2
        betas = torch.full((num_rbf,), float(beta), dtype=bdt)
        self._register("means", means, trainable)
        self._register("betas", betas, trainable)

    def forward(self, dist):
        d = dist[..., None]
        # the reference's expnorm cutoff always uses lower bound 0
        c = cosine_cutoff(d, 0.0, self.cutoff_upper)
        return c * torch.exp(
            -self.betas * (torch.exp(self.alpha * (-d + self.cutoff_lower)) - self.means) ** 2
        )


rbf_class_mapping = {"gauss": GaussianSmearing, "expnorm": ExpNormalSmearing}
