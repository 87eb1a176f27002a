"""SchNet-style graph network (counterpart of torchmdnet_tpu/models/graph_network.py).

Continuous-filter convolutions over the dense ELL list (N, K): the filter
W = MLP(rbf) * cosine_cutoff, the message x_j * W, with add/mean/max slot
aggregation.  The list has no self loops (the reference's Distance with
loop=False).  The layout and names are the reference torchmd-net's
(``interactions.{i}.mlp.0``, ``.conv.lin1``, ...), so the port computes what
the JAX package computes with the same weights.

With ``bf16_messages`` the edge MLP computes in bf16 the way a Flax
``Dense(dtype=bf16)`` does (bf16 operands, products and bias adds), the
message ``x_j * W`` is a bf16 product and the K-axis sum accumulates in the
model dtype.  The gather of x_j is then a bf16 row gather: CUDA kernel #4 on
the card, and its gradient kernel #5 (``ops/kernels/ell_gather.py``).
"""

import torch
from torch import nn

from torchmdnet_tpu_torch.models.blocks import NeighborEmbedding, embedding, remat_call, xavier_linear
from torchmdnet_tpu_torch.ops.activations import Activation, act_fn_mapping
from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
from torchmdnet_tpu_torch.ops.neighbors import NeighborList, edge_geometry_components, ell_gather, neighbor_list
from torchmdnet_tpu_torch.ops.rbf import rbf_class_mapping

AGGREGATIONS = ("add", "mean", "max")


class CFConv(nn.Module):
    """The convolution's two projections (reference torchmd_gn.py:236-272):
    ``lin1`` into the filter space before the gather, ``lin2`` out of it."""

    def __init__(self, hidden_channels: int, num_filters: int, *, generator):
        super().__init__()
        self.lin1 = xavier_linear(hidden_channels, num_filters, bias=False, generator=generator)
        self.lin2 = xavier_linear(num_filters, hidden_channels, generator=generator)


class InteractionBlock(nn.Module):
    """One interaction (torchmd_gn.py:187-233): CFConv with the filter MLP
    ``mlp``, an activation and ``lin``."""

    def __init__(self, hidden_channels, num_rbf, num_filters, activation, cutoff_lower,
                 cutoff_upper, aggr="add", bf16_messages=False, *, generator):
        super().__init__()
        g = generator
        self.mlp = nn.Sequential(
            xavier_linear(num_rbf, num_filters, generator=g),
            Activation(activation),
            xavier_linear(num_filters, num_filters, generator=g),
        )
        self.conv = CFConv(hidden_channels, num_filters, generator=g)
        self.lin = xavier_linear(hidden_channels, hidden_channels, generator=g)
        self.activation = activation
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.aggr = aggr
        self.bf16_messages = bf16_messages

    def forward(self, x, nbl: NeighborList, dist, edge_attr):
        act = act_fn_mapping[self.activation]
        acc = x.dtype
        mp = torch.bfloat16 if self.bf16_messages else acc

        def proj(lin, t):  # a Linear layer computed in the message dtype
            return torch.matmul(t.to(mp), lin.weight.to(mp).t()) + lin.bias.to(mp)

        c = cosine_cutoff(dist, self.cutoff_lower, self.cutoff_upper)
        w = proj(self.mlp[2], act(proj(self.mlp[0], edge_attr)))
        w = w * c.to(mp)[..., None]  # (N, K, F)
        h = self.conv.lin1(x)
        msg = ell_gather(h.to(mp), nbl.idx, nbl.lazy_perm) * w  # (N, K, F)
        mask3 = nbl.mask[..., None]
        if self.aggr == "max":
            msg = torch.where(mask3, msg, torch.full_like(msg, -torch.inf))
            # amax's gradient splits ties evenly, as JAX's max does
            agg = msg.amax(dim=1).to(acc)
            # atoms with no neighbors aggregate to 0, scatter-max's fill
            agg = torch.where(nbl.mask.any(dim=1, keepdim=True), agg, torch.zeros_like(agg))
        else:
            agg = torch.where(mask3, msg, torch.zeros_like(msg)).sum(dim=1, dtype=acc)
            if self.aggr == "mean":
                agg = agg / nbl.mask.sum(dim=1, keepdim=True).clamp_min(1).to(acc)
        return self.lin(act(self.conv.lin2(agg)))


class TorchMD_GN(nn.Module):
    """Graph network (reference torchmd_gn.py:14-184).

    ``remat`` recomputes each interaction (and the neighbor embedding) in the
    backward pass, as the JAX package's ``nn.remat`` does: one layer's (N, K,
    F) residuals at a time instead of all layers'.
    """

    def __init__(
        self,
        hidden_channels: int = 128,
        num_filters: int = 128,
        num_layers: int = 6,
        num_rbf: int = 50,
        rbf_type: str = "expnorm",
        trainable_rbf: bool = True,
        activation: str = "silu",
        neighbor_embedding: bool = True,
        cutoff_lower: float = 0.0,
        cutoff_upper: float = 5.0,
        max_z: int = 100,
        max_num_neighbors: int = 32,
        aggr: str = "add",
        remat: bool = False,
        bf16_messages: bool = False,
        buffer_dtype=None,
        *,
        generator,
    ):
        super().__init__()
        if aggr not in AGGREGATIONS:
            raise ValueError(f"Unknown aggregation: {aggr} (one of {', '.join(AGGREGATIONS)})")
        g = generator
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.max_num_neighbors = max_num_neighbors
        self.remat = remat
        self.embedding = embedding(max_z, hidden_channels, generator=g)
        # the reference GN hands its dtype to the RBF: constants in the model dtype
        self.distance_expansion = rbf_class_mapping[rbf_type](
            cutoff_lower, cutoff_upper, num_rbf, trainable_rbf, buffer_dtype=buffer_dtype
        )
        self.neighbor_embedding = (
            NeighborEmbedding(hidden_channels, num_rbf, cutoff_lower, cutoff_upper, max_z, generator=g)
            if neighbor_embedding else None
        )
        self.interactions = nn.ModuleList(
            InteractionBlock(hidden_channels, num_rbf, num_filters, activation, cutoff_lower,
                             cutoff_upper, aggr=aggr, bf16_messages=bf16_messages, generator=g)
            for _ in range(num_layers)
        )

    def forward(self, z, pos, batch, atom_mask=None, box=None, nbl=None):
        x = self.embedding(z)
        if nbl is None:
            nbl = neighbor_list(
                pos, batch, atom_mask, k=self.max_num_neighbors,
                cutoff_lower=self.cutoff_lower, cutoff_upper=self.cutoff_upper,
                loop=False, box=box,
            )
        if nbl.self_loops:
            raise ValueError("TorchMD_GN takes a neighbor list without self loops")
        _, dist = edge_geometry_components(pos, nbl, box=box)
        edge_attr = self.distance_expansion(dist)
        if self.neighbor_embedding is not None:
            x = remat_call(self.remat, self.neighbor_embedding, z, x, nbl, dist, edge_attr)
        for block in self.interactions:
            x = x + remat_call(self.remat, block, x, nbl, dist, edge_attr)
        return x, None
