"""Weights from a seed, made on the device in one draw, for the reference
and the program alike.

Every matrix (linear weights, embeddings) takes its slice of one
``torch.randn`` from a generator on the device seeded with the run's seed:
linear weights scaled to a Xavier-normal spread, embeddings unit normal,
as torchmd-net initialises them (Xavier-uniform and normal).  Biases are
zero, layer norms one and zero, and the RBF's means and betas their
published start, as torchmd-net's ``reset_parameters`` leaves them.
"""

import math

import torch
from torch import nn

from nnpbench.reference.et import ExpNormal


def fill(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model``'s storage in place from ``seed``; returns it."""
    mats = [(name, t) for name, t in model.named_parameters() if t.dim() >= 2]
    dev = mats[0][1].device
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2 ** 64)
    flat = torch.randn(sum(t.numel() for _, t in mats), generator=gen, device=dev)
    off = 0
    with torch.no_grad():
        for name, t in mats:
            chunk = flat[off:off + t.numel()].view_as(t)
            off += t.numel()
            std = 1.0 if name.endswith("embedding.weight") else math.sqrt(2.0 / (t.shape[0] + t.shape[1]))
            t.copy_(chunk * std)
        for mod in model.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear) and mod.bias is not None:
                mod.bias.zero_()
            elif isinstance(mod, ExpNormal):
                means, betas = mod.constants()
                mod.means.copy_(means)
                mod.betas.copy_(betas)
    return model
