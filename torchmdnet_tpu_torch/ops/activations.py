"""Activation registry (counterpart of torchmdnet_tpu/ops/activations.py).

Mirrors the reference's act_class_mapping (torchmdnet/models/utils.py) as pure
functions: {ssp, silu, tanh, sigmoid}.
"""

import math

import torch
import torch.nn.functional as F

_LOG2 = math.log(2.0)


def shifted_softplus(x):
    """softplus(x) - log(2), with softplus = logaddexp(x, 0) as in JAX."""
    return torch.logaddexp(x, torch.zeros_like(x)) - _LOG2


act_fn_mapping = {
    "ssp": shifted_softplus,
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


class Activation(torch.nn.Module):
    """An activation from ``act_fn_mapping`` as a module (for nn.Sequential)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = act_fn_mapping[name]

    def forward(self, x):
        return self.fn(x)
