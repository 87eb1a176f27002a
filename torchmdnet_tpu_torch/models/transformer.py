"""Invariant graph Transformer representation model (counterpart of
torchmdnet_tpu/models/transformer.py).

Per-edge multi-head attention over the dense ELL list (N, K), with
RBF-projected distance filters on keys and values and cosine-cutoff-weighted
activations; self-loops included (column 0, distance 0).  Module and key
names are the reference torchmd-net's (``attention_layers.{i}.q_proj``, ...,
``out_norm``); unlike ET, the value projection and filter need no column
permutation.

With ``fused_attention`` the edge phase of each layer runs through one fused
op (``ops/kernels/t_message.py``): the CUDA kernels for tensors on the GPU,
its plain version on the CPU.
"""

import torch
from torch import nn

from torchmdnet_tpu_torch.models.blocks import (
    NeighborEmbedding,
    embedding,
    layer_norm,
    remat_call,
    xavier_linear,
)
from torchmdnet_tpu_torch.ops.activations import act_fn_mapping
from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
from torchmdnet_tpu_torch.ops.kernels.t_message import fused_t_messages
from torchmdnet_tpu_torch.ops.neighbors import (
    NeighborList,
    edge_geometry_components,
    ell_gather,
    neighbor_list,
)
from torchmdnet_tpu_torch.ops.rbf import rbf_class_mapping


class MultiHeadAttention(nn.Module):
    """One attention layer in ELL form (reference torchmd_t.py:185-283)."""

    def __init__(
        self,
        hidden_channels: int,
        num_rbf: int,
        distance_influence: str,
        num_heads: int,
        activation: str,
        attn_activation: str,
        cutoff_lower: float,
        cutoff_upper: float,
        bf16_messages: bool = False,
        fused_attention: bool = False,
        *,
        generator,
    ):
        super().__init__()
        if fused_attention and not bf16_messages:
            raise ValueError(
                "fused_attention=True requires bf16_messages=True (the kernel "
                "computes the edge phase in bf16 with f32 accumulation)."
            )
        h = hidden_channels
        self.hidden_channels = h
        self.num_heads = num_heads
        self.activation = activation
        self.attn_activation = attn_activation
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.bf16_messages = bf16_messages
        self.fused_attention = fused_attention
        g = generator
        self.layernorm = layer_norm(h)
        self.q_proj = xavier_linear(h, h, generator=g)
        self.k_proj = xavier_linear(h, h, generator=g)
        self.v_proj = xavier_linear(h, h, generator=g)
        self.dk_proj = (
            xavier_linear(num_rbf, h, generator=g) if distance_influence in ("keys", "both") else None
        )
        self.dv_proj = (
            xavier_linear(num_rbf, h, generator=g) if distance_influence in ("values", "both") else None
        )
        self.o_proj = xavier_linear(h, h, generator=g)

    def forward(self, x, nbl: NeighborList, dist, edge_attr):
        x = self.layernorm(x)
        q = self.q_proj(x)
        k = self.k_proj(x)
        v = self.v_proj(x)
        if self.fused_attention:
            out = self._fused_edges(q, k, v, nbl, dist, edge_attr)
        else:
            out = self._composable_edges(q, k, v, nbl, dist, edge_attr)
        return self.o_proj(out.to(x.dtype))

    def _fused_edges(self, q, k, v, nbl, dist, edge_attr):
        bf = torch.bfloat16
        cutm = (cosine_cutoff(dist, self.cutoff_lower, self.cutoff_upper) * nbl.mask).to(torch.float32)
        wdk = bdk = wdv = bdv = None
        if self.dk_proj is not None:
            wdk = self.dk_proj.weight.to(bf).t()
            bdk = self.dk_proj.bias.to(bf).reshape(1, -1)
        if self.dv_proj is not None:
            wdv = self.dv_proj.weight.to(bf).t()
            bdv = self.dv_proj.bias.to(bf).reshape(1, -1)
        return fused_t_messages(
            nbl.idx, q.to(bf), k.to(bf), v.to(bf), edge_attr.to(bf), cutm, wdk, bdk, wdv, bdv,
            heads=self.num_heads, act=self.activation, attn_act=self.attn_activation,
            perm=nbl.transpose_perm,
        )

    def _composable_edges(self, q, k, v, nbl, dist, edge_attr):
        """The edge phase from composable ops.  With ``bf16_messages`` every
        (N, K, ...) intermediate is bf16 and the K-axis sum accumulates in the
        model dtype, as in the JAX package."""
        h = self.hidden_channels
        heads = self.num_heads
        n, kk = nbl.idx.shape
        acc = q.dtype
        mp = torch.bfloat16 if self.bf16_messages else acc
        act = act_fn_mapping[self.activation]
        attn_act = act_fn_mapping[self.attn_activation]
        perm = nbl.lazy_perm

        def proj(lin, t):  # a Linear layer computed in the message dtype
            return torch.matmul(t.to(mp), lin.weight.to(mp).t()) + lin.bias.to(mp)

        dk = act(proj(self.dk_proj, edge_attr)) if self.dk_proj is not None else None
        dv = act(proj(self.dv_proj, edge_attr)) if self.dv_proj is not None else None

        k_j = ell_gather(k.to(mp), nbl.idx, perm)  # (N, K, H)
        prod = q.to(mp)[:, None, :] * k_j
        if dk is not None:
            prod = prod * dk
        # per-head sum, broadcast back to the head's lanes
        hd = h // heads
        attn = prod.reshape(n, kk, heads, hd).sum(dim=-1, keepdim=True)
        attn = attn.expand(n, kk, heads, hd).reshape(n, kk, h)
        cut = cosine_cutoff(dist, self.cutoff_lower, self.cutoff_upper).to(mp)
        attn = attn_act(attn) * cut[..., None]
        attn = torch.where(nbl.mask[..., None], attn, torch.zeros_like(attn))

        v_j = ell_gather(v.to(mp), nbl.idx, perm)  # (N, K, H)
        if dv is not None:
            v_j = v_j * dv
        return (v_j * attn).sum(dim=1, dtype=acc)


class TorchMD_T(nn.Module):
    """Transformer (reference torchmd_t.py:14-182)."""

    def __init__(
        self,
        hidden_channels: int = 128,
        num_layers: int = 6,
        num_rbf: int = 50,
        rbf_type: str = "expnorm",
        trainable_rbf: bool = True,
        activation: str = "silu",
        attn_activation: str = "silu",
        neighbor_embedding: bool = True,
        num_heads: int = 8,
        distance_influence: str = "both",
        cutoff_lower: float = 0.0,
        cutoff_upper: float = 5.0,
        max_z: int = 100,
        max_num_neighbors: int = 32,
        bf16_messages: bool = False,
        fused_attention: bool = False,
        remat: bool = False,
        buffer_dtype=None,
        *,
        generator,
    ):
        super().__init__()
        if distance_influence not in ("keys", "values", "both", "none"):
            raise ValueError(f"Unknown distance_influence: {distance_influence}")
        if hidden_channels % num_heads != 0:
            raise ValueError("hidden_channels must be divisible by num_heads")
        g = generator
        self.hidden_channels = hidden_channels
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.max_num_neighbors = max_num_neighbors
        # recompute the neighbor embedding and each layer in the backward pass
        self.remat = remat
        self.embedding = embedding(max_z, hidden_channels, generator=g)
        # the JAX model builds its RBF constants in the model dtype
        self.distance_expansion = rbf_class_mapping[rbf_type](
            cutoff_lower, cutoff_upper, num_rbf, trainable_rbf, buffer_dtype=buffer_dtype
        )
        self.neighbor_embedding = (
            NeighborEmbedding(hidden_channels, num_rbf, cutoff_lower, cutoff_upper, max_z, generator=g)
            if neighbor_embedding else None
        )
        self.attention_layers = nn.ModuleList(
            MultiHeadAttention(
                hidden_channels, num_rbf, distance_influence, num_heads, activation,
                attn_activation, cutoff_lower, cutoff_upper,
                bf16_messages=bf16_messages, fused_attention=fused_attention, generator=g,
            )
            for _ in range(num_layers)
        )
        self.out_norm = layer_norm(hidden_channels)

    def forward(self, z, pos, batch, atom_mask=None, box=None, nbl=None):
        x = self.embedding(z)
        if nbl is None:
            nbl = neighbor_list(
                pos, batch, atom_mask, k=self.max_num_neighbors,
                cutoff_lower=self.cutoff_lower, cutoff_upper=self.cutoff_upper,
                loop=True, box=box,
            )
        if not nbl.self_loops:
            raise ValueError("TorchMD_T needs a neighbor list with self loops")
        _, dist = edge_geometry_components(pos, nbl, box=box)
        edge_attr = self.distance_expansion(dist)
        if self.neighbor_embedding is not None:
            x = remat_call(self.remat, self.neighbor_embedding, z, x, nbl, dist, edge_attr)
        for layer in self.attention_layers:
            x = x + remat_call(self.remat, layer, x, nbl, dist, edge_attr)
        return self.out_norm(x), None
