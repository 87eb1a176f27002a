"""TensorNet representation model (counterpart of torchmdnet_tpu/models/tensornet.py).

Each atom carries a rank-2 tensor X (reference (N, H, 3, 3)) as NINE (N, H)
component tensors, a "T9": ``t[a * 3 + b] = X[a, b]``.  Irrep decomposition,
per-channel 3x3 products and Frobenius norms are closed-form in the
components, exactly as in the JAX package, so the port computes what JAX
computes with the same weights:

- message passing gathers the nine unique irrep generators of each source
  atom (1 trace + 3 skew + 5 symmetric-traceless) as one (N, 9H) table and
  rebuilds the messages per atom (s22 = -s00 - s11);
- the interaction's edge MLP ends in contiguous irrep thirds (I, A, S), the
  JAX package's layout; ``wproj_column_perm`` maps the reference's (H, 3)
  interleaved layout onto it;
- the edge vector is pos_i - pos_j, normalized except on self loops (the
  reference's convention), kept as three (N, K) components.

With ``fused_message`` each interaction's message phase runs through one
fused op (``ops/kernels/tn_message.py``): the CUDA kernels for tensors on
the GPU, its plain version on the CPU.  Module names follow the reference
torchmd-net (``tensor_embedding.distance_proj1``, ``layers.0.linears_scalar.0``,
``out_norm``, ``linear``), so the ``state_dict`` has its key layout.
"""

import numpy as np
import torch
from torch import nn

from torchmdnet_tpu_torch.models.blocks import embedding, layer_norm, remat_call, torch_default_linear
from torchmdnet_tpu_torch.ops.activations import act_fn_mapping
from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
from torchmdnet_tpu_torch.ops.kernels import tn_message
from torchmdnet_tpu_torch.ops.neighbors import (
    NeighborList,
    edge_geometry_components,
    ell_gather,
    neighbor_list,
)
from torchmdnet_tpu_torch.ops.rbf import rbf_class_mapping

# ---------------------------------------------------------------------------
# T9 representation: a tuple of 9 tensors (..., H); X[a, b] = t[a * 3 + b].
# Irreps: I = lam * eye; A skew (a10, a20, a21, where A[1,0] = a10 etc.);
# S symmetric traceless (s00, s11, s22, s01, s02, s12).
# ---------------------------------------------------------------------------


def t9_norm(t):
    """Frobenius norm^2 over the 3x3 axes: -> (..., H)."""
    return sum(c * c for c in t)


def t9_decompose(t):
    """T9 -> (lam, (a10, a20, a21), (s00, s11, s22, s01, s02, s12)):
    I = trace/3 * eye, A = (X - X^T)/2, S = (X + X^T)/2 - I."""
    lam = (t[0] + t[4] + t[8]) / 3.0
    a = (0.5 * (t[3] - t[1]), 0.5 * (t[6] - t[2]), 0.5 * (t[7] - t[5]))
    s = (t[0] - lam, t[4] - lam, t[8] - lam,
         0.5 * (t[1] + t[3]), 0.5 * (t[2] + t[6]), 0.5 * (t[5] + t[7]))
    return lam, a, s


def t9_from_irreps(lam, a, s):
    """Assemble T9 = I + A + S from irrep components."""
    a10, a20, a21 = a
    s00, s11, s22, s01, s02, s12 = s
    return (
        lam + s00, -a10 + s01, -a20 + s02,
        a10 + s01, lam + s11, -a21 + s12,
        a20 + s02, a21 + s12, lam + s22,
    )


def irrep_norms(lam, a, s):
    """Frobenius norm^2 of each irrep (orthogonal, so they add)."""
    a10, a20, a21 = a
    s00, s11, s22, s01, s02, s12 = s
    ni = 3.0 * lam * lam
    na = 2.0 * (a10 * a10 + a20 * a20 + a21 * a21)
    ns = s00 * s00 + s11 * s11 + s22 * s22 + 2.0 * (s01 * s01 + s02 * s02 + s12 * s12)
    return ni, na, ns


def t9_matmul(x, y):
    """3x3 matrix product per channel: out[a,c] = sum_b X[a,b] Y[b,c]."""
    return tuple(
        x[a * 3] * y[c] + x[a * 3 + 1] * y[3 + c] + x[a * 3 + 2] * y[6 + c]
        for a in range(3) for c in range(3)
    )


def t9_add(x, y):
    return tuple(xc + yc for xc, yc in zip(x, y))


def t9_scale(x, w):
    return tuple(c * w for c in x)


def _linear_list(count, in_features, out_features, bias, generator):
    return nn.ModuleList(
        torch_default_linear(in_features, out_features, bias=bias, generator=generator)
        for _ in range(count)
    )


class TensorEmbedding(nn.Module):
    """Edge-tensor embedding, T9 output: only the 10 unique per-edge sums
    over K are formed (no (N, K, 3, 3, H) tensor)."""

    def __init__(self, hidden_channels, num_rbf, activation, cutoff_lower, cutoff_upper, max_z=128,
                 *, generator):
        super().__init__()
        h, g = hidden_channels, generator
        self.activation = activation
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.distance_proj1 = torch_default_linear(num_rbf, h, generator=g)
        self.distance_proj2 = torch_default_linear(num_rbf, h, generator=g)
        self.distance_proj3 = torch_default_linear(num_rbf, h, generator=g)
        self.emb = embedding(max_z, h, generator=g)
        self.emb2 = torch_default_linear(2 * h, h, generator=g)
        self.init_norm = layer_norm(h)
        self.linears_tensor = _linear_list(3, h, h, False, g)
        self.linears_scalar = nn.ModuleList([
            torch_default_linear(h, 2 * h, generator=g),
            torch_default_linear(2 * h, 3 * h, generator=g),
        ])

    def forward(self, z, nbl: NeighborList, dist, edge_dir, edge_attr):
        act = act_fn_mapping[self.activation]
        n, k = nbl.idx.shape
        c = cosine_cutoff(dist, self.cutoff_lower, self.cutoff_upper)[..., None]
        w1 = self.distance_proj1(edge_attr) * c
        w2 = self.distance_proj2(edge_attr) * c
        w3 = self.distance_proj3(edge_attr) * c
        ex, ey, ez = edge_dir
        zemb = self.emb(z)  # (N, H)
        h = zemb.shape[-1]
        pair = torch.cat([zemb[:, None, :].expand(n, k, h),
                          ell_gather(zemb, nbl.idx, nbl.lazy_perm)], dim=-1)
        zij = self.emb2(pair)
        gate = torch.where(nbl.mask[..., None], zij, torch.zeros_like(zij))
        gw1, gw2, gw3 = gate * w1, gate * w2, gate * w3
        lam = gw1.sum(dim=1)
        px, py, pz = ((gw2 * e[..., None]).sum(dim=1) for e in (ex, ey, ez))
        qxx, qyy, qzz, qxy, qxz, qyz = (
            (gw3 * e[..., None]).sum(dim=1)
            for e in (ex * ex, ey * ey, ez * ez, ex * ey, ex * ez, ey * ez)
        )
        tr3 = (qxx + qyy + qzz) / 3.0
        # skew convention: A[1,0] = pz, A[2,0] = -py, A[2,1] = px
        a_n = (pz, -py, px)
        s_n = (qxx - tr3, qyy - tr3, qzz - tr3, qxy, qxz, qyz)
        ni, na, ns = irrep_norms(lam, a_n, s_n)
        norm = self.init_norm(ni + na + ns)
        lam = self.linears_tensor[0](lam)
        a_n = tuple(self.linears_tensor[1](comp) for comp in a_n)
        s_n = tuple(self.linears_tensor[2](comp) for comp in s_n)
        norm = act(self.linears_scalar[0](norm))
        norm = act(self.linears_scalar[1](norm))
        g_i, g_a, g_s = norm[..., 0::3], norm[..., 1::3], norm[..., 2::3]
        return t9_from_irreps(
            lam * g_i,
            tuple(comp * g_a for comp in a_n),
            tuple(comp * g_s for comp in s_n),
        )


def wproj_column_perm(hidden_channels: int) -> np.ndarray:
    """Column permutation from the reference's interaction edge-filter
    layout (irrep r of channel c at column c*3 + r) to the contiguous thirds
    the port and the JAX package use: W_ours = W_ref[:, perm]."""
    ours = np.arange(3 * hidden_channels)
    return (ours % hidden_channels) * 3 + ours // hidden_channels


class Interaction(nn.Module):
    """One TensorNet interaction layer, T9 in and out."""

    def __init__(self, num_rbf, hidden_channels, activation, cutoff_lower, cutoff_upper,
                 equivariance_invariance_group, bf16_messages=False, fused_message=False, *, generator):
        super().__init__()
        if fused_message and not bf16_messages:
            raise ValueError(
                "fused_message=True requires bf16_messages=True (the kernel "
                "computes the message phase in bf16 with f32 accumulation)."
            )
        if equivariance_invariance_group not in ("O(3)", "SO(3)"):
            raise ValueError(f"Unknown equivariance group: {equivariance_invariance_group}")
        h, g = hidden_channels, generator
        self.hidden_channels = h
        self.activation = activation
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.group = equivariance_invariance_group
        self.bf16_messages = bf16_messages
        self.fused_message = fused_message
        self.linears_scalar = nn.ModuleList([
            torch_default_linear(num_rbf, h, generator=g),
            torch_default_linear(h, 2 * h, generator=g),
            torch_default_linear(2 * h, 3 * h, generator=g),
        ])
        self.linears_tensor = _linear_list(6, h, h, False, g)

    def forward(self, x, nbl: NeighborList, dist, edge_attr):
        h = self.hidden_channels
        lt = self.linears_tensor
        c = cosine_cutoff(dist, self.cutoff_lower, self.cutoff_upper)
        x = t9_scale(x, 1.0 / (t9_norm(x) + 1.0))
        lam, a_p, s_p = t9_decompose(x)
        lam = lt[0](lam)
        a_p = tuple(lt[1](comp) for comp in a_p)
        s_p = tuple(lt[2](comp) for comp in s_p)
        y = t9_from_irreps(lam, a_p, s_p)
        # the nine unique irrep components of each source atom; s22 is derived
        cat = torch.cat([lam, *a_p, s_p[0], s_p[1], s_p[3], s_p[4], s_p[5]], dim=-1)
        if self.fused_message:
            m = self._fused_messages(cat, nbl, c, edge_attr)
        else:
            m = self._composable_messages(cat, nbl, c, edge_attr)
        m = m.to(x[0].dtype)
        m_l, m_a0, m_a1, m_a2, m_s00, m_s11, m_s01, m_s02, m_s12 = torch.split(m, h, dim=-1)
        msg = t9_from_irreps(m_l, (m_a0, m_a1, m_a2),
                             (m_s00, m_s11, -m_s00 - m_s11, m_s01, m_s02, m_s12))
        if self.group == "O(3)":
            lam, a_p, s_p = t9_decompose(t9_add(t9_matmul(msg, y), t9_matmul(y, msg)))
        else:  # SO(3)
            lam, a_p, s_p = t9_decompose(tuple(2.0 * comp for comp in t9_matmul(y, msg)))
        ni, na, ns = irrep_norms(lam, a_p, s_p)
        invp = 1.0 / (ni + na + ns + 1.0)
        lam = lt[3](lam * invp)
        a_p = tuple(lt[4](comp * invp) for comp in a_p)
        s_p = tuple(lt[5](comp * invp) for comp in s_p)
        dx = t9_from_irreps(lam, a_p, s_p)
        # x + dx + dx^2 (the reference's matrix_power)
        return t9_add(t9_add(x, dx), t9_matmul(dx, dx))

    def _fused_messages(self, cat, nbl, c, edge_attr):
        bf = torch.bfloat16
        ls = self.linears_scalar
        cutm = (c * nbl.mask).to(torch.float32)
        ws = []
        for lin in ls:
            ws += [lin.weight.to(bf).t(), lin.bias.to(bf).reshape(1, -1)]
        return tn_message.fused_tn_messages(
            nbl.idx, cat.to(bf), edge_attr.to(bf), cutm, *ws,
            act=self.activation, perm=nbl.transpose_perm,
        )

    def _composable_messages(self, cat, nbl, c, edge_attr):
        """The message phase from composable ops.  With ``bf16_messages`` the
        gathered rows and the edge weights are bf16 and every K-axis sum
        accumulates in the model dtype, as in the JAX package."""
        h = self.hidden_channels
        act = act_fn_mapping[self.activation]
        acc = cat.dtype
        mp = torch.bfloat16 if self.bf16_messages else acc
        w = edge_attr
        for lin in self.linears_scalar:
            w = act(lin(w))
        w = w * c[..., None]
        w = torch.where(nbl.mask[..., None], w, torch.zeros_like(w))  # (N, K, 3H)
        cat_j = ell_gather(cat.to(mp), nbl.idx, nbl.lazy_perm)  # (N, K, 9H)
        w_i, w_a, w_s = torch.split(w.to(mp), h, dim=-1)
        wb = (w_i, w_a, w_a, w_a, w_s, w_s, w_s, w_s, w_s)
        parts = torch.split(cat_j, h, dim=-1)
        return torch.cat([(p * wc).sum(dim=1, dtype=acc) for p, wc in zip(parts, wb)], dim=-1)


class TensorNet(nn.Module):
    """TensorNet (reference tensornet.py)."""

    def __init__(
        self,
        hidden_channels: int = 128,
        num_layers: int = 2,
        num_rbf: int = 32,
        rbf_type: str = "expnorm",
        trainable_rbf: bool = False,
        activation: str = "silu",
        cutoff_lower: float = 0.0,
        cutoff_upper: float = 4.5,
        max_num_neighbors: int = 64,
        max_z: int = 128,
        equivariance_invariance_group: str = "O(3)",
        bf16_messages: bool = False,
        fused_message: bool = False,
        remat: bool = False,
        *,
        generator,
    ):
        super().__init__()
        g = generator
        self.hidden_channels = hidden_channels
        # recompute the embedding and each interaction in the backward pass
        self.remat = remat
        self.activation = activation
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.max_num_neighbors = max_num_neighbors
        # the reference TensorNet builds its RBF without a dtype, leaving
        # float32 constants in any precision mode
        self.distance_expansion = rbf_class_mapping[rbf_type](
            cutoff_lower, cutoff_upper, num_rbf, trainable_rbf, buffer_dtype=torch.float32
        )
        self.tensor_embedding = TensorEmbedding(
            hidden_channels, num_rbf, activation, cutoff_lower, cutoff_upper, max_z, generator=g
        )
        self.layers = nn.ModuleList(
            Interaction(num_rbf, hidden_channels, activation, cutoff_lower, cutoff_upper,
                        equivariance_invariance_group, bf16_messages=bf16_messages,
                        fused_message=fused_message, generator=g)
            for _ in range(num_layers)
        )
        self.out_norm = layer_norm(3 * hidden_channels)
        self.linear = torch_default_linear(3 * hidden_channels, hidden_channels, generator=g)

    def forward(self, z, pos, batch, atom_mask=None, box=None, nbl=None):
        if nbl is None:
            nbl = neighbor_list(
                pos, batch, atom_mask, k=self.max_num_neighbors,
                cutoff_lower=self.cutoff_lower, cutoff_upper=self.cutoff_upper,
                loop=True, box=box,
            )
        if not nbl.self_loops:
            raise ValueError("TensorNet needs a neighbor list with self loops")
        delta, dist = edge_geometry_components(pos, nbl, box=box)
        edge_attr = self.distance_expansion(dist)
        # edge_vec = pos_i - pos_j = -delta, normalized except on self loops
        pos_d = dist > 0
        neg_inv = -(pos_d.to(dist.dtype) / torch.where(pos_d, dist, torch.ones_like(dist)))
        edge_dir = tuple(comp * neg_inv for comp in delta)
        x = remat_call(self.remat, self.tensor_embedding, z, nbl, dist, edge_dir, edge_attr)
        for layer in self.layers:
            x = remat_call(self.remat, layer, x, nbl, dist, edge_attr)
        lam, a_p, s_p = t9_decompose(x)
        feats = self.out_norm(torch.cat(irrep_norms(lam, a_p, s_p), dim=-1))
        return act_fn_mapping[self.activation](self.linear(feats)), None
