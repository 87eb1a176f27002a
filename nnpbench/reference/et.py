"""Plain float32 Equivariant Transformer: the yardstick the benchmark holds
the port's ET against.

Written from the ET paper (Tholke and De Fabritiis, ICLR 2022,
arXiv:2202.02541) and torchmd-net's ``torchmd_et.py``, in plain PyTorch on
an edge list: every pair (i, j) within the cutoff of the same molecule, and
the self pair (i, i) at distance 0, as torchmd-net's ET takes it
(``loop=True``).  No neighbor capacity, no padding, no kernel.  It imports
nothing of the program under test and nothing of JAX.

Parameter names are torchmd-net's ``state_dict`` names (the port keeps
them), so one set of weights loads into both.  The 3H-wide value projection
and value filter are read in global thirds (x, vec1, vec2 = the first,
second and third H columns), the port's layout of those weights; with
weights drawn at random either reading is an ET.

``set_message_rounding``: a dtype (bfloat16, float8_e4m3fn, ...) through
which the edge phase's operands and per-edge products are rounded, where
the port's fused kernels round to bfloat16, and their cotangents in every
derivative; values beyond the dtype's range saturate at its largest.
``set_node_rounding``: the same for the float32 parts' matrix products
(the node projections, NeighborEmbedding, the head): ``"tf32"`` rounds
their operands to TF32's 10-bit mantissa and sums in float32, as a TF32
matrix product does; bfloat16 rounds operands and products.  None (the
yardstick) rounds nothing.  A precision below the configuration's, in
either part, makes a control of the correctness check.
"""

import math
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

ACTS = {
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "ssp": lambda x: F.softplus(x) - math.log(2.0),
}


@contextmanager
def exact_fp32():
    """Float32 matrix products in float32 (no TF32) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def cosine_cutoff(d, lower, upper):
    if lower > 0:
        c = 0.5 * (torch.cos(math.pi * (2.0 * (d - lower) / (upper - lower) + 1.0)) + 1.0)
        return c * ((d < upper) & (d > lower)).to(c.dtype)
    return 0.5 * (torch.cos(d * (math.pi / upper)) + 1.0) * (d < upper).to(d.dtype)


class Graph:
    """The pairs of a set of molecules: receivers ``i``, sources ``j`` (E,)
    int64, self pairs included; ``mol`` (N,) molecule ids of the atoms;
    ``side`` the periodic cube's side, or None."""

    def __init__(self, i, j, mol, n_mol, side=None):
        self.i, self.j, self.mol, self.n_mol, self.side = i, j, mol, n_mol, side


def minimum_image(d, side):
    """Displacements ``d`` to their nearest periodic images in a cube of
    ``side`` (None: no box)."""
    return d if side is None else d - side * torch.round(d / side)


@torch.no_grad()
def pairs_within(pos, mol, lower, upper, block=4096, side=None):
    """Every ordered pair (i, j), i != j, of one molecule with
    lower <= |pos_j - pos_i| < upper (nearest images in a periodic cube of
    ``side``), then every (i, i); rows in blocks of ``block`` so that an
    STMV-sized system fits."""
    n = pos.shape[0]
    iis, jjs = [], []
    for s in range(0, n, block):
        e = min(n, s + block)
        d = minimum_image(pos[None, :, :] - pos[s:e, None, :], side)
        d2 = (d * d).sum(-1)
        ok = (d2 < upper * upper) & (d2 >= lower * lower) & (mol[s:e, None] == mol[None, :])
        ok[torch.arange(e - s, device=pos.device), torch.arange(s, e, device=pos.device)] = False
        i, j = ok.nonzero(as_tuple=True)
        iis.append(i + s)
        jjs.append(j)
    ar = torch.arange(n, device=pos.device)
    return torch.cat(iis + [ar]), torch.cat(jjs + [ar])


def graph_of(pos, mol, n_mol, lower, upper, side=None):
    i, j = pairs_within(pos, mol, lower, upper, side=side)
    return Graph(i, j, mol, n_mol, side)


class _Round(torch.autograd.Function):
    """Round to ``dtype`` and back to float32, saturating at its largest
    finite value; the cotangent is rounded the same way, in every order."""

    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        big = torch.finfo(dtype).max
        return t.clamp(-big, big).to(dtype).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return _Round.apply(g, ctx.dtype), None


def round_tf32(t):
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero; the cotangent is rounded the same way."""
    return _RoundTF32.apply(t)


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return _RoundTF32.apply(g)


class Linear(nn.Linear):
    """``nn.Linear`` of the float32 parts; ``set_node_rounding`` sets how
    its operands (``rnd_in``) and its product (``rnd_out``) are rounded."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rnd_in = self.rnd_out = _identity

    def forward(self, t):
        b = None if self.bias is None else self.rnd_in(self.bias)
        return self.rnd_out(F.linear(self.rnd_in(t), self.rnd_in(self.weight), b))


def _identity(t):
    return t


def _linear(t, lin, rnd):
    return rnd(F.linear(rnd(t), rnd(lin.weight), None if lin.bias is None else rnd(lin.bias)))


class ExpNormal(nn.Module):
    def __init__(self, lower, upper, num_rbf, trainable):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.alpha = 5.0 / (upper - lower)
        self.num_rbf = num_rbf
        for name in ("means", "betas"):
            value = torch.empty(num_rbf)
            if trainable:
                self.register_parameter(name, nn.Parameter(value))
            else:
                self.register_buffer(name, value)

    def constants(self):
        """The RBF's initial (means, betas), float32, as torchmd-net makes them."""
        start = torch.tensor(math.exp(-self.upper + self.lower), dtype=torch.float32, device="cpu")
        means = torch.linspace(float(start), 1.0, self.num_rbf, device="cpu")
        beta = (torch.tensor(2.0 / self.num_rbf, device="cpu") * (1 - start)) ** -2
        return means, beta.expand(self.num_rbf).clone()

    def forward(self, d):
        d = d[:, None]
        return cosine_cutoff(d, 0.0, self.upper) * torch.exp(
            -self.betas * (torch.exp(self.alpha * (-d + self.lower)) - self.means) ** 2)


class NeighborEmbedding(nn.Module):
    def __init__(self, h, num_rbf, lower, upper, max_z):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.distance_proj = Linear(num_rbf, h)
        self.embedding = nn.Embedding(max_z, h)
        self.combine = Linear(2 * h, h)

    def forward(self, z, x, g, dist, rbf):
        ne = g.i != g.j
        w = self.distance_proj(rbf[ne]) * cosine_cutoff(dist[ne], self.lower, self.upper)[:, None]
        msg = self.embedding(z[g.j[ne]]) * w
        agg = torch.zeros_like(x).index_add_(0, g.i[ne], msg)
        return self.combine(torch.cat([x, agg], dim=-1))


class Attention(nn.Module):
    def __init__(self, h, num_rbf, heads, act, attn_act, lower, upper):
        super().__init__()
        self.h, self.heads = h, heads
        self.act, self.attn_act = ACTS[act], ACTS[attn_act]
        self.lower, self.upper = lower, upper
        self.layernorm = nn.LayerNorm(h, eps=1e-5)
        self.q_proj = Linear(h, h)
        self.k_proj = Linear(h, h)
        self.v_proj = Linear(h, 3 * h)
        self.vec_proj = Linear(h, 3 * h, bias=False)
        self.dk_proj = nn.Linear(num_rbf, h)
        self.dv_proj = nn.Linear(num_rbf, 3 * h)
        self.o_proj = Linear(h, 3 * h)
        self.rnd = lambda t: t

    def forward(self, x, vec, i, j, dist, rbf, dirs):
        h, heads, rnd = self.h, self.heads, self.rnd
        x = self.layernorm(x)
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        vec1, vec2, vec3 = torch.split(self.vec_proj(vec), h, dim=-1)  # (N, 3, H) each
        vec_dot = (vec1 * vec2).sum(dim=1)
        dk = rnd(self.act(_linear(rbf, self.dk_proj, rnd)))
        dv = rnd(self.act(_linear(rbf, self.dv_proj, rnd)))
        prod = rnd(rnd(rnd(q)[i] * rnd(k)[j]) * dk)
        e = prod.shape[0]
        attn = prod.view(e, heads, h // heads).sum(-1)
        attn = self.attn_act(attn) * cosine_cutoff(dist, self.lower, self.upper)[:, None]
        attn = rnd(attn[:, :, None].expand(e, heads, h // heads).reshape(e, h))
        vd = rnd(rnd(v)[j] * dv)
        x_m, vw1, vw2 = torch.split(vd, h, dim=-1)
        x_agg = torch.zeros_like(q).index_add_(0, i, rnd(x_m * attn))
        vec_j = rnd(vec)[j]  # (E, 3, H)
        msg = rnd(rnd(vec_j * vw1[:, None, :]) + rnd(vw2[:, None, :] * dirs[:, :, None]))
        vec_agg = torch.zeros_like(vec).index_add_(0, i, msg)
        o1, o2, o3 = torch.split(self.o_proj(x_agg), h, dim=-1)
        return vec_dot * o2 + o3, vec3 * o1[:, None, :] + vec_agg


def _safe_norm(t, dim):
    sq = (t * t).sum(dim=dim)
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))), torch.zeros_like(sq))


class GatedEquivariantBlock(nn.Module):
    def __init__(self, h, out, act, scalar_act):
        super().__init__()
        self.out = out
        self.vec1_proj = Linear(h, h, bias=False)
        self.vec2_proj = Linear(h, out, bias=False)
        self.update_net = nn.Sequential(Linear(2 * h, h), _Act(act), Linear(h, 2 * out))
        self.act = ACTS[act] if scalar_act else None

    def forward(self, x, v):
        vec1 = _safe_norm(self.vec1_proj(v), dim=1)
        vec2 = self.vec2_proj(v)
        x_out, gate = torch.split(self.update_net(torch.cat([x, vec1], dim=-1)), self.out, dim=-1)
        v_out = gate[:, None, :] * vec2
        return (self.act(x_out) if self.act is not None else x_out), v_out


class _Act(nn.Module):
    def __init__(self, name):
        super().__init__()
        self.fn = ACTS[name]

    def forward(self, x):
        return self.fn(x)


class Representation(nn.Module):
    def __init__(self, a):
        super().__init__()
        h, r = a["embedding_dimension"], a["num_rbf"]
        lo, hi = a["cutoff_lower"], a["cutoff_upper"]
        self.lower, self.upper = lo, hi
        self.embedding = nn.Embedding(a["max_z"], h)
        self.distance_expansion = ExpNormal(lo, hi, r, a["trainable_rbf"])
        self.neighbor_embedding = NeighborEmbedding(h, r, lo, hi, a["max_z"])
        self.attention_layers = nn.ModuleList(
            Attention(h, r, a["num_heads"], a["activation"], a["attn_activation"], lo, hi)
            for _ in range(a["num_layers"]))
        self.out_norm = nn.LayerNorm(h, eps=1e-5)


class EquivariantScalar(nn.Module):
    def __init__(self, h, act):
        super().__init__()
        self.output_network = nn.ModuleList([GatedEquivariantBlock(h, h // 2, act, True),
                                             GatedEquivariantBlock(h // 2, 1, act, False)])


class ET(nn.Module):
    """ET with the EquivariantScalar head, a sum over each molecule, times
    ``std``; ``args`` are the configuration's model arguments.  The options
    the benchmark's configurations fix (expnorm RBF, NeighborEmbedding,
    distance influence "both", no prior, no atom filter) are the only ones
    taken, and any other value raises."""

    def __init__(self, args, std=1.0):
        super().__init__()
        fixed = dict(model="equivariant-transformer", rbf_type="expnorm", neighbor_embedding=True,
                     distance_influence="both", prior_model=None, atom_filter=-1, reduce_op="add",
                     output_model="Scalar")
        for key, value in fixed.items():
            if args.get(key, value) != value:
                raise ValueError(f"the reference ET takes {key}={value!r}, not {args[key]!r}")
        self.args = dict(args)
        self.std = float(std)
        self.representation_model = Representation(args)
        self.output_model = EquivariantScalar(args["embedding_dimension"], args["activation"])
        self.checkpoint_layers = False

    def set_message_rounding(self, dtype: Optional[torch.dtype]):
        rnd = (lambda t: t) if dtype is None else (lambda t: _Round.apply(t, dtype))
        for layer in self.representation_model.attention_layers:
            layer.rnd = rnd

    def set_node_rounding(self, precision):
        """None, ``"tf32"`` or a dtype for the float32 parts' products."""
        if precision is None:
            rnd_in = rnd_out = _identity
        elif precision == "tf32":
            rnd_in, rnd_out = round_tf32, _identity
        else:
            rnd_in = rnd_out = lambda t: _Round.apply(t, precision)
        for mod in self.modules():
            if isinstance(mod, Linear):
                mod.rnd_in, mod.rnd_out = rnd_in, rnd_out

    def graph(self, pos, mol, n_mol, side=None):
        r = self.representation_model
        return graph_of(pos.detach(), mol, n_mol, r.lower, r.upper, side)

    def atom_energies(self, z, pos, g):
        """(N,) per-atom energies (times ``std``) of the atoms of ``g``."""
        r = self.representation_model
        delta = minimum_image(pos[g.j] - pos[g.i], g.side)
        d2 = (delta * delta).sum(-1)
        nz = d2 > 0
        dist = torch.where(nz, torch.sqrt(torch.where(nz, d2, torch.ones_like(d2))), torch.zeros_like(d2))
        inv = nz.to(dist.dtype) / torch.where(nz, dist, torch.ones_like(dist))
        dirs = delta * inv[:, None]
        rbf = r.distance_expansion(dist)
        x = r.embedding(z)
        x = r.neighbor_embedding(z, x, g, dist, rbf)
        vec = torch.zeros((x.shape[0], 3, x.shape[1]), dtype=x.dtype, device=x.device)
        for layer in r.attention_layers:
            if self.checkpoint_layers:
                dx, dvec = checkpoint(layer, x, vec, g.i, g.j, dist, rbf, dirs, use_reentrant=False)
            else:
                dx, dvec = layer(x, vec, g.i, g.j, dist, rbf, dirs)
            x, vec = x + dx, vec + dvec
        x = r.out_norm(x)
        for block in self.output_model.output_network:
            x, vec = block(x, vec)
        return (x + 0.0 * vec.sum())[:, 0] * self.std

    def energies(self, z, pos, g):
        e = self.atom_energies(z, pos, g)
        return torch.zeros(g.n_mol, dtype=e.dtype, device=e.device).index_add_(0, g.mol, e)

    def energy_and_forces(self, z, pos, g, create_graph=False):
        """(per-molecule energies (M,), forces (N, 3), per-atom energies (N,))."""
        pos = pos.detach().requires_grad_(True)
        with torch.enable_grad():
            e_atoms = self.atom_energies(z, pos, g)
            y = torch.zeros(g.n_mol, dtype=e_atoms.dtype, device=e_atoms.device).index_add_(0, g.mol, e_atoms)
            (grad,) = torch.autograd.grad(y.sum(), pos, create_graph=create_graph)
        if create_graph:
            return y, -grad, e_atoms
        return y.detach(), -grad, e_atoms.detach()


def build(args, device, std=1.0):
    """The reference ET with uninitialised storage on ``device`` (fill it with
    ``weights.fill``)."""
    with torch.device("meta"):
        model = ET(args, std=std)
    return model.to_empty(device=device)


def loaded(args, device, state_dict, std=1.0, edge=None, node=None):
    """The reference with ``state_dict`` loaded, its edge phase rounded
    through ``edge`` and its float32 parts through ``node`` (None: float32),
    its layers checkpointed on a card so that an STMV-sized system fits."""
    model = build(args, device, std=std)
    model.load_state_dict(state_dict)
    model.checkpoint_layers = torch.device(device).type == "cuda"
    model.set_message_rounding(edge)
    model.set_node_rounding(node)
    return model


def system_forces(model, z, pos, side=None):
    """(n, 3) forces on one system of atoms ``z`` at ``pos``, in a periodic
    cube of ``side`` or in open space (None)."""
    mol = torch.zeros(len(z), dtype=torch.long, device=pos.device)
    return model.energy_and_forces(z, pos, model.graph(pos, mol, 1, side))[1]
