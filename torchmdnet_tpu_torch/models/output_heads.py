"""Output heads (counterpart of torchmdnet_tpu/models/output_heads.py).

Each head has ``pre_reduce(x, v, z, pos, batch_ids)`` and ``post_reduce(y)``;
the reduction itself (segment sum/mean over molecule ids) lives in
``potential.EnergyModel``, which owns the molecule capacity.  Module names
follow the reference (``output_network``).  ``allow_prior_model`` gates the
priors as in the JAX package: the dipole, spatial-extent and vector heads
take none.

The center of mass divides only where a segment has mass, so padded batches
(the trash segment) and atom filters stay NaN-free in values and gradients.
"""

import torch
from torch import nn

from torchmdnet_tpu_torch.constants import ATOMIC_MASSES
from torchmdnet_tpu_torch.models.blocks import GatedEquivariantBlock, xavier_linear
from torchmdnet_tpu_torch.ops.activations import Activation
from torchmdnet_tpu_torch.ops.segment import segment_reduce


def _center_of_mass(masses, z, pos, batch_ids, num_segments: int):
    """Per-molecule center of mass gathered back per atom, (N, 3); a segment
    without mass (the trash segment, a molecule whose atoms are all
    filtered) has its center at 0."""
    mass = masses.to(pos.dtype)[z][:, None]  # (N, 1)
    m_pos = segment_reduce(mass * pos, batch_ids, num_segments, "sum")
    m_tot = segment_reduce(mass, batch_ids, num_segments, "sum")
    has_mass = m_tot > 0
    c = torch.where(has_mass, m_pos / torch.where(has_mass, m_tot, torch.ones_like(m_tot)),
                    torch.zeros_like(m_pos))
    return c[batch_ids]


def _norm(y):
    """|y| over the last axis as the JAX package takes it (sqrt of the sum of
    squares): its gradient at y = 0 is NaN, as there."""
    return torch.sqrt((y * y).sum(dim=-1, keepdim=True))


class _MassesMixin:
    def _register_masses(self):
        # not in the state_dict: the JAX package's heads hold no masses
        self.register_buffer("atomic_mass", torch.as_tensor(ATOMIC_MASSES), persistent=False)

    def _center(self, z, pos, batch_ids):
        # N + 1 segments: every id (molecules, then the trash segment) fits
        return _center_of_mass(self.atomic_mass, z, pos, batch_ids, batch_ids.shape[0] + 1)


class Scalar(nn.Module):
    """MLP head: H -> H/2 -> 1."""

    allow_prior_model = True

    def __init__(self, hidden_channels: int, activation: str = "silu", reduce_op: str = "sum", *, generator):
        super().__init__()
        self.reduce_op = reduce_op
        self.output_network = nn.Sequential(
            xavier_linear(hidden_channels, hidden_channels // 2, generator=generator),
            Activation(activation),
            xavier_linear(hidden_channels // 2, 1, generator=generator),
        )

    def pre_reduce(self, x, v, z, pos, batch_ids):
        return self.output_network(x)

    def post_reduce(self, y):
        return y


class EquivariantScalar(nn.Module):
    """Two gated equivariant blocks; ``v`` is (N, 3, H)."""

    allow_prior_model = True

    def __init__(self, hidden_channels: int, activation: str = "silu", reduce_op: str = "sum", *, generator):
        super().__init__()
        self.reduce_op = reduce_op
        self.output_network = nn.ModuleList([
            GatedEquivariantBlock(
                hidden_channels, hidden_channels // 2, activation=activation,
                scalar_activation=True, generator=generator,
            ),
            GatedEquivariantBlock(hidden_channels // 2, 1, activation=activation, generator=generator),
        ])

    def _blocks(self, x, v):
        for block in self.output_network:
            x, v = block(x, v)
        return x, v

    def pre_reduce(self, x, v, z, pos, batch_ids):
        x, v = self._blocks(x, v)
        # + 0 * v.sum() keeps v in the graph, as the reference does
        return x + 0.0 * v.sum()

    def post_reduce(self, y):
        return y


class DipoleMoment(_MassesMixin, Scalar):
    """Dipole about the center of mass; post_reduce takes its norm."""

    allow_prior_model = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._register_masses()

    def pre_reduce(self, x, v, z, pos, batch_ids):
        x = self.output_network(x)
        return x * (pos - self._center(z, pos, batch_ids))

    def post_reduce(self, y):
        return _norm(y)


class EquivariantDipoleMoment(_MassesMixin, EquivariantScalar):
    """Charges times positions about the center of mass plus the atoms'
    vector output; post_reduce takes its norm."""

    allow_prior_model = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._register_masses()

    def pre_reduce(self, x, v, z, pos, batch_ids):
        x, v = self._blocks(x, v)
        return x * (pos - self._center(z, pos, batch_ids)) + v.squeeze(-1)

    def post_reduce(self, y):
        return _norm(y)


class ElectronicSpatialExtent(_MassesMixin, Scalar):
    """Squared distance from the center of mass weighted by an MLP output."""

    allow_prior_model = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._register_masses()

    def pre_reduce(self, x, v, z, pos, batch_ids):
        x = self.output_network(x)
        d = pos - self._center(z, pos, batch_ids)
        return (d * d).sum(dim=-1, keepdim=True) * x


class EquivariantElectronicSpatialExtent(ElectronicSpatialExtent):
    pass


class EquivariantVectorOutput(EquivariantScalar):
    """The atoms' vector output, summed per molecule: (M, 3)."""

    allow_prior_model = False

    def pre_reduce(self, x, v, z, pos, batch_ids):
        x, v = self._blocks(x, v)
        return v.squeeze(-1)


head_class_mapping = {
    "Scalar": Scalar,
    "EquivariantScalar": EquivariantScalar,
    "DipoleMoment": DipoleMoment,
    "EquivariantDipoleMoment": EquivariantDipoleMoment,
    "ElectronicSpatialExtent": ElectronicSpatialExtent,
    "EquivariantElectronicSpatialExtent": EquivariantElectronicSpatialExtent,
    "EquivariantVectorOutput": EquivariantVectorOutput,
}
