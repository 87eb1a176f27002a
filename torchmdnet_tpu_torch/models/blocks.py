"""Shared NN building blocks (counterpart of torchmdnet_tpu/models/blocks.py).

Layers keep the reference torchmd-net module names (``distance_proj``,
``update_net.0``, ...), so the port's ``state_dict`` has the reference's key
layout.  Initialisation draws from an explicit ``torch.Generator`` and
reproduces the reference's distributions: xavier-uniform with zero bias where
the reference calls ``nn.init.xavier_uniform_``, torch's default Linear init
elsewhere, N(0, 1) embeddings.
"""

import math
from typing import Optional

import torch
from torch import nn

from torchmdnet_tpu_torch.ops.activations import Activation, act_fn_mapping
from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
from torchmdnet_tpu_torch.ops.kernels import save_list
from torchmdnet_tpu_torch.ops.neighbors import NeighborList, ell_gather, safe_norm


def _empty_linear(in_features: int, out_features: int, bias: bool) -> nn.Linear:
    """An nn.Linear whose parameters are allocated but not initialised (its
    default init would draw from the global RNG)."""
    lin = nn.Linear(in_features, out_features, bias=bias, device="meta")
    lin.weight = nn.Parameter(torch.empty(out_features, in_features))
    if bias:
        lin.bias = nn.Parameter(torch.empty(out_features))
    return lin


def xavier_linear(in_features: int, out_features: int, bias: bool = True, *, generator) -> nn.Linear:
    """Linear layer with xavier-uniform weight and zero bias."""
    lin = _empty_linear(in_features, out_features, bias)
    with torch.no_grad():
        nn.init.xavier_uniform_(lin.weight, generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


def torch_default_linear(in_features: int, out_features: int, bias: bool = True, *, generator) -> nn.Linear:
    """Linear layer with torch's default reset_parameters, U(+-1/sqrt(fan_in))."""
    lin = _empty_linear(in_features, out_features, bias)
    bound = 1.0 / math.sqrt(in_features)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


def layer_norm(features: int) -> nn.LayerNorm:
    """LayerNorm with torch's epsilon (1e-5)."""
    return nn.LayerNorm(features, eps=1e-5)


def embedding(num_embeddings: int, features: int, *, generator) -> nn.Embedding:
    emb = nn.Embedding(num_embeddings, features, _weight=torch.empty(num_embeddings, features))
    with torch.no_grad():
        emb.weight.normal_(0.0, 1.0, generator=generator)
    return emb


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; under ``remat`` its activations are recomputed in the
    backward pass instead of kept (``torch.utils.checkpoint``, non-reentrant,
    so every derivative order works), as the JAX package's ``nn.remat``,
    except the outputs of the fused forward kernels ``fn`` calls: those are
    kept and served again in each recomputation (``save_list``, the JAX
    package's ``save_only_these_names("fused_edge_agg")``)."""
    if not remat:
        return fn(*args)
    from torch.utils import checkpoint

    _give_input_saver_a_jvp(checkpoint)
    return checkpoint.checkpoint(fn, *args, use_reentrant=False, context_fn=save_list.contexts)


def _no_tangent(ctx, *tangents):
    return torch.zeros((0,))


def _give_input_saver_a_jvp(checkpoint):
    """Some torch releases keep a checkpointed call's inputs through
    ``checkpoint._NoopSaveInputs``, an ``autograd.Function`` without a
    ``jvp``, so a checkpoint under forward-mode AD (``force_grad_mode="jvp"``
    with ``remat``) raises.  Its output is an empty placeholder that nothing
    reads, so its tangent is an empty zero; the inputs it saves keep their
    own tangents for the recomputation."""
    saver = getattr(checkpoint, "_NoopSaveInputs", None)
    if saver is not None and "jvp" not in vars(saver):
        saver.jvp = staticmethod(_no_tangent)


class NeighborEmbedding(nn.Module):
    """Initial neighborhood-type embedding (eq. 3 of the ET paper).

    Gathers neighbor type-embeddings, weights them with an RBF-projected
    distance filter under the cosine cutoff, sums over neighbor slots, and
    mixes with the per-atom features.  Self-loops are excluded.
    """

    def __init__(self, hidden_channels, num_rbf, cutoff_lower, cutoff_upper, max_z=100, *, generator):
        super().__init__()
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.distance_proj = xavier_linear(num_rbf, hidden_channels, generator=generator)
        self.embedding = embedding(max_z, hidden_channels, generator=generator)
        self.combine = xavier_linear(2 * hidden_channels, hidden_channels, generator=generator)

    def forward(self, z, x, nbl: NeighborList, dist, edge_attr):
        nbl = nbl.without_self_loops()
        k = nbl.k
        dist = dist[:, -k:]
        edge_attr = edge_attr[:, -k:]
        c = cosine_cutoff(dist, self.cutoff_lower, self.cutoff_upper)
        w = self.distance_proj(edge_attr) * c[..., None]
        x_neighbors = self.embedding(z)
        msg = ell_gather(x_neighbors, nbl.idx, nbl.lazy_perm) * w  # (N, K, H)
        msg = torch.where(nbl.mask[..., None], msg, torch.zeros_like(msg))
        agg = msg.sum(dim=1)
        return self.combine(torch.cat([x, agg], dim=-1))


class GatedEquivariantBlock(nn.Module):
    """Gated equivariant block (Schuett et al. 2021); ``v`` is (N, 3, H)."""

    def __init__(
        self,
        hidden_channels: int,
        out_channels: int,
        intermediate_channels: Optional[int] = None,
        activation: str = "silu",
        scalar_activation: bool = False,
        *,
        generator,
    ):
        super().__init__()
        inter = hidden_channels if intermediate_channels is None else intermediate_channels
        self.out_channels = out_channels
        self.vec1_proj = xavier_linear(hidden_channels, hidden_channels, bias=False, generator=generator)
        self.vec2_proj = xavier_linear(hidden_channels, out_channels, bias=False, generator=generator)
        self.update_net = nn.Sequential(
            xavier_linear(2 * hidden_channels, inter, generator=generator),
            Activation(activation),
            xavier_linear(inter, 2 * out_channels, generator=generator),
        )
        self.act = act_fn_mapping[activation] if scalar_activation else None

    def forward(self, x, v):
        vec1 = safe_norm(self.vec1_proj(v), dim=-2)  # (N, H): norm over xyz
        vec2 = self.vec2_proj(v)
        h = self.update_net(torch.cat([x, vec1], dim=-1))
        x_out, gate = torch.split(h, self.out_channels, dim=-1)
        v_out = gate[:, None, :] * vec2
        if self.act is not None:
            x_out = self.act(x_out)
        return x_out, v_out
