"""Smooth radial cutoff (counterpart of torchmdnet_tpu/ops/cutoff.py)."""

import math

import torch


def cosine_cutoff(distances, cutoff_lower: float = 0.0, cutoff_upper: float = 5.0):
    """Smooth cosine cutoff, hard-zero outside the [lower, upper) window.

    With cutoff_lower == 0:   0.5 * (cos(pi * d / upper) + 1) for d < upper.
    With cutoff_lower  > 0:   0.5 * (cos(pi * (2*(d-lo)/(hi-lo) + 1)) + 1)
                              for lo < d < hi, zero elsewhere.
    """
    if cutoff_lower > 0:
        c = 0.5 * (
            torch.cos(
                math.pi
                * (2.0 * (distances - cutoff_lower) / (cutoff_upper - cutoff_lower) + 1.0)
            )
            + 1.0
        )
        inside = (distances < cutoff_upper) & (distances > cutoff_lower)
        return c * inside.to(c.dtype)
    c = 0.5 * (torch.cos(distances * (math.pi / cutoff_upper)) + 1.0)
    return c * (distances < cutoff_upper).to(c.dtype)
