"""Equivariant Transformer representation model (counterpart of torchmdnet_tpu/models/et.py).

Neighbor interactions run over the dense ELL list (N, K): every per-edge
quantity is (N, K, ...) and aggregation is a masked sum over K.  The layout is
the JAX package's, so the port computes exactly what JAX computes with the
same weights:

- vectors are three (N, H) xyz components, stacked to (N, 3, H) only for the
  output head;
- the 3H-wide value projection and value filter are split in global thirds
  (``vproj_column_perm`` maps the reference's per-head split onto it);
- d_ij is the unit vector from receiving atom i to neighbor j; the self edge
  (column 0) and invalid slots have distance 0 and zero direction.

With ``fused_attention`` the edge phase of each layer runs through one fused
op (``ops/kernels/et_message.py``): the CUDA kernels for tensors on the GPU,
its plain version on the CPU.
"""

import numpy as np
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
from torchmdnet_tpu_torch.ops.kernels.et_message import fused_et_messages
from torchmdnet_tpu_torch.ops.neighbors import (
    NeighborList,
    edge_geometry_components,
    ell_gather,
    neighbor_list,
)
from torchmdnet_tpu_torch.ops.rbf import rbf_class_mapping


def vproj_column_perm(hidden_channels: int, num_heads: int) -> np.ndarray:
    """Column permutation from the reference's per-head v/dv layout to the
    global-thirds layout: W_ours = W_ref[:, perm] (reference column
    g*3hd + p*hd + d holds head g, part p, dim d; ours is p*H + g*hd + d)."""
    hd = hidden_channels // num_heads
    ours = np.arange(3 * hidden_channels)
    p, rem = np.divmod(ours, hidden_channels)
    g, d = np.divmod(rem, hd)
    return g * 3 * hd + p * hd + d


class EquivariantMultiHeadAttention(nn.Module):
    """One ET attention layer in ELL form."""

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
        self.v_proj = xavier_linear(h, 3 * h, generator=g)
        self.vec_proj = xavier_linear(h, 3 * h, bias=False, generator=g)
        self.dk_proj = (
            xavier_linear(num_rbf, h, generator=g)
            if distance_influence in ("keys", "both") else None
        )
        self.dv_proj = (
            xavier_linear(num_rbf, 3 * h, generator=g)
            if distance_influence in ("values", "both") else None
        )
        self.o_proj = xavier_linear(h, 3 * h, generator=g)

    def forward(self, x, vec, nbl: NeighborList, dist, edge_attr, edge_dir):
        h = self.hidden_channels
        x = self.layernorm(x)
        q = self.q_proj(x)
        k = self.k_proj(x)
        v = self.v_proj(x)
        vec123 = [self.vec_proj(vc) for vc in vec]  # 3 x (N, 3H)
        vec1 = [vc[:, :h] for vc in vec123]
        vec2 = [vc[:, h : 2 * h] for vc in vec123]
        vec3 = [vc[:, 2 * h :] for vc in vec123]
        vec_dot = sum(v1 * v2 for v1, v2 in zip(vec1, vec2))  # (N, H)

        if self.fused_attention:
            x_agg, vec_agg = self._fused_edges(q, k, v, vec, nbl, dist, edge_attr, edge_dir)
        else:
            x_agg, vec_agg = self._composable_edges(q, k, v, vec, nbl, dist, edge_attr, edge_dir)
        x_agg = x_agg.to(x.dtype)
        vec_agg = [va.to(x.dtype) for va in vec_agg]

        o1, o2, o3 = torch.split(self.o_proj(x_agg), h, dim=-1)
        dx = vec_dot * o2 + o3
        dvec = tuple(v3 * o1 + agg for v3, agg in zip(vec3, vec_agg))
        return dx, dvec

    def _fused_edges(self, q, k, v, vec, nbl, dist, edge_attr, edge_dir):
        bf = torch.bfloat16
        f32 = torch.float32
        h = self.hidden_channels
        cutm = (cosine_cutoff(dist, self.cutoff_lower, self.cutoff_upper) * nbl.mask).to(f32)
        wdk = bdk = wdv = bdv = None
        if self.dk_proj is not None:
            wdk = self.dk_proj.weight.to(bf).t()
            bdk = self.dk_proj.bias.to(bf).reshape(1, -1)
        if self.dv_proj is not None:
            wdv = self.dv_proj.weight.to(bf).t()
            bdv = self.dv_proj.bias.to(bf).reshape(1, -1)
        x_agg, vec_cat = fused_et_messages(
            nbl.idx, q.to(bf), k.to(bf), v.to(bf),
            vec[0].to(bf), vec[1].to(bf), vec[2].to(bf),
            edge_attr.to(bf), cutm, nbl.mask.to(f32),
            edge_dir[0].to(f32), edge_dir[1].to(f32), edge_dir[2].to(f32),
            wdk, bdk, wdv, bdv,
            heads=self.num_heads, act=self.activation, attn_act=self.attn_activation,
            perm=nbl.transpose_perm,
        )
        return x_agg, [vec_cat[:, c * h : (c + 1) * h] for c in range(3)]

    def _composable_edges(self, q, k, v, vec, nbl, dist, edge_attr, edge_dir):
        """The edge phase from composable ops.  With ``bf16_messages`` every
        (N, K, ...) intermediate is bf16 and every K-axis sum accumulates in
        the model dtype, as in the JAX package."""
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
        mask3 = nbl.mask[..., None]
        attn = torch.where(mask3, attn, torch.zeros_like(attn))

        v_j = ell_gather(v.to(mp), nbl.idx, perm)  # (N, K, 3H)
        if dv is not None:
            v_j = v_j * dv
        x_m, vw1, vw2 = torch.split(v_j, h, dim=-1)
        x_agg = (x_m * attn).sum(dim=1, dtype=acc)
        vec_agg = []
        for c in range(3):
            vec_j_c = ell_gather(vec[c].to(mp), nbl.idx, perm)
            msg = vec_j_c * vw1 + vw2 * edge_dir[c].to(mp)[..., None]
            msg = torch.where(mask3, msg, torch.zeros_like(msg))
            vec_agg.append(msg.sum(dim=1, dtype=acc))
        return x_agg, vec_agg


class TorchMD_ET(nn.Module):
    """Equivariant Transformer (reference torchmd_et.py)."""

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
        # the reference ET builds its RBF without a dtype, leaving float32
        # constants in any precision mode
        self.distance_expansion = rbf_class_mapping[rbf_type](
            cutoff_lower, cutoff_upper, num_rbf, trainable_rbf, buffer_dtype=torch.float32
        )
        self.neighbor_embedding = (
            NeighborEmbedding(hidden_channels, num_rbf, cutoff_lower, cutoff_upper, max_z, generator=g)
            if neighbor_embedding else None
        )
        self.attention_layers = nn.ModuleList(
            EquivariantMultiHeadAttention(
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
            raise ValueError("TorchMD_ET needs a neighbor list with self loops")
        delta, dist = edge_geometry_components(pos, nbl, box=box)
        edge_attr = self.distance_expansion(dist)
        # unit vector from receiver i to neighbor j; zero on self/invalid slots
        pos_d = dist > 0
        inv_dist = pos_d.to(dist.dtype) / torch.where(pos_d, dist, torch.ones_like(dist))
        edge_dir = tuple(comp * inv_dist for comp in delta)

        if self.neighbor_embedding is not None:
            x = remat_call(self.remat, self.neighbor_embedding, z, x, nbl, dist, edge_attr)

        zero = torch.zeros((x.shape[0], self.hidden_channels), dtype=x.dtype, device=x.device)
        vec = (zero, zero, zero)
        for layer in self.attention_layers:
            dx, dvec = remat_call(self.remat, layer, x, vec, nbl, dist, edge_attr, edge_dir)
            x = x + dx
            vec = tuple(vc + dc for vc, dc in zip(vec, dvec))
        x = self.out_norm(x)
        return x, torch.stack(vec, dim=1)
