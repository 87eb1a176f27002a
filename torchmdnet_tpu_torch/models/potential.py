"""Model composition: representation -> output head -> reduction
(counterpart of torchmdnet_tpu/models/potential.py).

- ``EnergyModel`` is the ``nn.Module`` computing per-molecule energies;
- ``Potential`` wraps it with forces = -dE/dpos from ``torch.autograd.grad``;
- ``create_model`` builds a Potential from the flat config dict the JAX
  package takes.  Only the equivariant transformer is ported so far.
"""

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from torchmdnet_tpu_torch.data.batch import AtomicBatch
from torchmdnet_tpu_torch.models.et import TorchMD_ET
from torchmdnet_tpu_torch.models.output_heads import head_class
from torchmdnet_tpu_torch.ops.neighbors import neighbor_list
from torchmdnet_tpu_torch.ops.segment import segment_reduce
from torchmdnet_tpu_torch.utils import resolve_device

dtype_mapping = {32: torch.float32, 64: torch.float64}

_MODELS_TODO = (
    "only the equivariant-transformer is ported so far; TensorNet, the "
    "transformer and the graph network follow (ROADMAP.md, 'Modules to port', "
    "slice E)"
)
_PRIORS_TODO = "prior models are not ported yet (ROADMAP.md, 'Modules to port', slice D)"


class EnergyModel(nn.Module):
    """representation -> pre_reduce -> *std -> reduce -> +mean -> post_reduce."""

    def __init__(self, representation_model, output_model, mean=0.0, std=1.0, atom_filter=-1):
        super().__init__()
        self.representation_model = representation_model
        self.output_model = output_model
        self.mean = float(mean)
        self.std = float(std)
        self.atom_filter = atom_filter

    def forward(self, batch: AtomicBatch, box=None, nbl=None):
        z, pos, batch_ids = batch.z, batch.pos, batch.batch
        m = batch.num_mol
        x, v = self.representation_model(z, pos, batch_ids, batch.atom_mask, box=box, nbl=nbl)
        if self.atom_filter > -1:
            # atoms with Z <= threshold go to the trash segment
            batch_ids = torch.where(z > self.atom_filter, batch_ids, torch.full_like(batch_ids, m))
        x = self.output_model.pre_reduce(x, v, z, pos, batch_ids)
        x = x * self.std
        # padding atoms carry batch id == m (the trash segment)
        y = segment_reduce(x, batch_ids, m + 1, self.output_model.reduce_op)[:m]
        y = y + self.mean
        return self.output_model.post_reduce(y)


@dataclasses.dataclass
class Potential:
    """User-facing bundle of (module, hyperparameters) on one device."""

    module: EnergyModel
    args: Dict[str, Any]
    device: torch.device

    @property
    def dtype(self) -> torch.dtype:
        return dtype_mapping[self.args.get("precision", 32)]

    def energy(self, batch: AtomicBatch, box=None, nbl=None) -> torch.Tensor:
        return self.module(batch, box, nbl)

    def energy_and_forces(self, batch: AtomicBatch, box=None, nbl=None):
        """(y (M, 1), forces (N, 3)) with forces = -dE/dpos by autograd."""
        pos = batch.pos.detach().requires_grad_(True)
        with torch.enable_grad():
            y = self.module(batch.replace(pos=pos), box, nbl)
            (grad,) = torch.autograd.grad(y.sum(), pos)
        return y.detach(), -grad

    def neighbors(self, batch: AtomicBatch, box=None, strategy: str = "auto", skin: float = 0.0, k: Optional[int] = None):
        """The representation's neighbor list, built on its own.

        With ``skin`` > 0 the list is built with ``cutoff_upper + skin`` and
        stays exact under ``NeighborList.refine`` while no atom moves more
        than skin/2; ``k`` defaults to max_num_neighbors, scaled by the skin
        volume ratio (rounded up to a multiple of 8).
        """
        a = self.args
        cutoff_upper = a.get("cutoff_upper", 5.0)
        cutoff_lower = a.get("cutoff_lower", 0.0)
        if k is None:
            k = a["max_num_neighbors"]
            if skin > 0.0:
                scale = ((cutoff_upper + skin) / cutoff_upper) ** 3
                k = int(math.ceil(k * scale / 8.0)) * 8
        if skin > 0.0:
            cutoff_lower = max(0.0, cutoff_lower - skin)
        return neighbor_list(
            batch.pos, batch.batch, batch.atom_mask, k=k,
            cutoff_lower=cutoff_lower, cutoff_upper=cutoff_upper + skin,
            loop=a["model"] != "graph-network", box=box, strategy=strategy,
        )


def create_representation(args: Dict[str, Any], generator: torch.Generator) -> nn.Module:
    if args["model"] != "equivariant-transformer":
        raise NotImplementedError(f"model {args['model']!r}: {_MODELS_TODO}")
    return TorchMD_ET(
        hidden_channels=args["embedding_dimension"],
        num_layers=args["num_layers"],
        num_rbf=args["num_rbf"],
        rbf_type=args["rbf_type"],
        trainable_rbf=args["trainable_rbf"],
        activation=args["activation"],
        attn_activation=args.get("attn_activation", "silu"),
        neighbor_embedding=args.get("neighbor_embedding", False),
        num_heads=args.get("num_heads", 8),
        distance_influence=args.get("distance_influence", "both"),
        cutoff_lower=args["cutoff_lower"],
        cutoff_upper=args["cutoff_upper"],
        max_z=args["max_z"],
        max_num_neighbors=args["max_num_neighbors"],
        bf16_messages=args.get("bf16_messages", False),
        fused_attention=args.get("fused_attention", False),
        generator=generator,
    )


def create_model(
    args: Dict[str, Any],
    mean: Optional[float] = None,
    std: Optional[float] = None,
    device=None,
    seed: int = 0,
) -> Potential:
    """Build a Potential from a flat config dict, with weights drawn from a
    ``torch.Generator`` seeded with ``seed``.

    Runs on ``cuda`` unless ``device`` names another device; with no device
    given and no GPU present this raises.
    """
    device = resolve_device(device)
    args = dict(args)
    precision = args.get("precision", 32)
    if precision not in dtype_mapping:
        raise ValueError(f"precision {precision} is not supported (32 or 64)")
    if args.get("prior_model"):
        raise NotImplementedError(_PRIORS_TODO)
    if args.get("atom_filter", -1) > -1 and args.get("derivative", False):
        raise ValueError("Derivative and atom filter can't be used together")
    generator = torch.Generator().manual_seed(int(seed))
    representation = create_representation(args, generator)
    head_name = args.get("output_model", "Scalar")
    if args["model"] == "equivariant-transformer" and not head_name.startswith("Equivariant"):
        head_name = "Equivariant" + head_name
    head = head_class(head_name)(
        args["embedding_dimension"], args["activation"],
        reduce_op=args.get("reduce_op", "sum"), generator=generator,
    )
    module = EnergyModel(
        representation, head,
        mean=0.0 if mean is None else mean,
        std=1.0 if std is None else std,
        atom_filter=args.get("atom_filter", -1),
    )
    module = module.to(device=device, dtype=dtype_mapping[precision])
    return Potential(module=module, args=args, device=device)
