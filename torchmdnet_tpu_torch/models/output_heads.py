"""Output heads (counterpart of torchmdnet_tpu/models/output_heads.py).

Each head has ``pre_reduce(x, v, z, pos, batch_ids)`` and ``post_reduce(y)``;
the reduction itself (segment sum/mean over molecule ids) lives in
``potential.EnergyModel``, which owns the molecule capacity.  Module names
follow the reference (``output_network``).
"""

from torch import nn

from torchmdnet_tpu_torch.models.blocks import GatedEquivariantBlock, xavier_linear
from torchmdnet_tpu_torch.ops.activations import Activation

_HEADS_TODO = (
    "only the Scalar and EquivariantScalar heads are ported so far; the other "
    "heads are queued (ROADMAP.md, queue 1, 'The remaining heads')"
)


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

    def pre_reduce(self, x, v, z, pos, batch_ids):
        for block in self.output_network:
            x, v = block(x, v)
        # + 0 * v.sum() keeps v in the graph, as the reference does
        return x + 0.0 * v.sum()

    def post_reduce(self, y):
        return y


head_class_mapping = {"Scalar": Scalar, "EquivariantScalar": EquivariantScalar}


def head_class(name: str):
    if name not in head_class_mapping:
        raise NotImplementedError(f"output head {name!r}: {_HEADS_TODO}")
    return head_class_mapping[name]
