"""Model composition: representation -> output head -> reduction
(counterpart of torchmdnet_tpu/models/potential.py).

- ``EnergyModel`` is the ``nn.Module`` computing per-molecule energies;
- ``Potential`` wraps it with forces = -dE/dpos from ``torch.autograd.grad``;
- ``create_model`` builds a Potential from the flat config dict the JAX
  package takes, ``create_prior_models`` its priors, ``load_model`` a
  Potential from a port checkpoint.  All four representation models (the
  equivariant transformer, TensorNet, the graph network and the
  Transformer) are ported, with the seven output heads and the Atomref,
  ZBL, Coulomb and D2 priors.
"""

import dataclasses
import inspect
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from torchmdnet_tpu_torch.data.batch import AtomicBatch
from torchmdnet_tpu_torch.models.et import TorchMD_ET
from torchmdnet_tpu_torch.models.graph_network import TorchMD_GN
from torchmdnet_tpu_torch.models.output_heads import head_class_mapping
from torchmdnet_tpu_torch.models.tensornet import TensorNet
from torchmdnet_tpu_torch.models.transformer import TorchMD_T
from torchmdnet_tpu_torch.ops.neighbors import neighbor_list
from torchmdnet_tpu_torch.ops.segment import segment_reduce
from torchmdnet_tpu_torch.priors import prior_class_mapping
from torchmdnet_tpu_torch.utils import resolve_device

dtype_mapping = {32: torch.float32, 64: torch.float64}



class EnergyModel(nn.Module):
    """representation -> pre_reduce -> *std -> priors' pre_reduce -> reduce
    -> +mean -> post_reduce -> priors' post_reduce."""

    def __init__(self, representation_model, output_model, priors=(), mean=0.0, std=1.0,
                 atom_filter=-1):
        super().__init__()
        self.representation_model = representation_model
        self.output_model = output_model
        self.priors = nn.ModuleList(priors)
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
        for prior in self.priors:
            x = prior.pre_reduce(x, z, pos, batch_ids, batch.atom_mask, batch.extra)
        # padding atoms carry batch id == m (the trash segment)
        y = segment_reduce(x, batch_ids, m + 1, self.output_model.reduce_op)[:m]
        y = y + self.mean
        y = self.output_model.post_reduce(y)
        for prior in self.priors:
            y = prior.post_reduce(y, z, pos, batch_ids, batch.atom_mask, m, batch.extra)
        return y


def check_atom_filter_batch(module: EnergyModel, batch: AtomicBatch, context: str = ""):
    """Raise when the atom filter would remove every atom of a molecule (the
    reference asserts it in AtomFilter.forward); its energy would otherwise
    silently be the mean plus the priors."""
    if module.atom_filter <= -1:
        return
    z, ids, mask = (t.cpu().numpy() for t in (batch.z, batch.batch, batch.atom_mask))
    keep = (z > module.atom_filter) & mask
    m = batch.num_mol
    present = np.bincount(ids[mask], minlength=m + 1)[:m]
    kept = np.bincount(ids[keep], minlength=m + 1)[:m]
    if np.any((present > 0) & (kept == 0)):
        bad = int(np.argmax((present > 0) & (kept == 0)))
        raise ValueError(f"Atom filter (Z > {module.atom_filter}) removed all atoms of sample "
                         f"{bad}{' in ' + context if context else ''}; its energy would silently be zero.")


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

    def energy_and_forces(self, batch: AtomicBatch, box=None, nbl=None, create_graph: bool = False):
        """(y (M, 1), forces (N, 3)) with forces = -dE/dpos by autograd.

        The default returns both detached (energies and forces for MD and
        serving).  ``create_graph=True`` is the training form: both stay in
        the autograd graph, so a loss on the forces differentiates through
        them to the parameters (grad-of-grad).
        """
        pos = batch.pos.detach().requires_grad_(True)
        with torch.enable_grad():
            y = self.module(batch.replace(pos=pos), box, nbl)
            (grad,) = torch.autograd.grad(y.sum(), pos, create_graph=create_graph)
        if create_graph:
            return y, -grad
        return y.detach(), -grad

    def neighbors(self, batch: AtomicBatch, box=None, strategy: str = "auto", skin: float = 0.0,
                  k: Optional[int] = None, gather_plan: bool = False, plan_block_rows: int = 0,
                  plan_width: int = 0, plan_inv_capacity: int = 0, **cell_kwargs):
        """The representation's neighbor list, built on its own.

        With ``skin`` > 0 the list is built with ``cutoff_upper + skin`` and
        stays exact under ``NeighborList.refine`` while no atom moves more
        than skin/2; ``k`` defaults to max_num_neighbors, scaled by the skin
        volume ratio (rounded up to a multiple of 8).  ``cell_kwargs`` go to
        the cell strategy (``cell_capacity``, ``max_cells``, ...).  Batches of
        small molecules (fewer than 512 atoms each on average) take the brute
        strategy under 'auto': they overlap in space, so cells would hold
        every sample's atoms at once.

        ``strategy``: 'auto', 'brute', 'brute-pallas' (the fused search
        kernel, ``ops/kernels/compaction.py``; no box) or 'cell'; see
        ``ops.neighbors.neighbor_list``.

        ``gather_plan`` and its ``plan_*`` sizes are accepted and have no
        effect: the JAX package's block gather plan feeds its one-hot MXU
        gather, and the port's kernels gather by index, with the same result.
        """
        a = self.args
        cutoff_upper = a.get("cutoff_upper", 5.0)
        cutoff_lower = a.get("cutoff_lower", 0.0)
        if strategy == "auto" and batch.num_mol > 1 and batch.num_atoms / batch.num_mol < 512:
            strategy = "brute"
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
            loop=a["model"] != "graph-network", box=box, strategy=strategy, **cell_kwargs,
        )


def create_representation(args: Dict[str, Any], generator: torch.Generator) -> nn.Module:
    shared = dict(
        hidden_channels=args["embedding_dimension"],
        num_layers=args["num_layers"],
        num_rbf=args["num_rbf"],
        rbf_type=args["rbf_type"],
        trainable_rbf=args["trainable_rbf"],
        activation=args["activation"],
        cutoff_lower=args["cutoff_lower"],
        cutoff_upper=args["cutoff_upper"],
        max_z=args["max_z"],
        max_num_neighbors=args["max_num_neighbors"],
        bf16_messages=args.get("bf16_messages", False),
        remat=args.get("remat", False),
        generator=generator,
    )
    if args["model"] == "graph-network":
        return TorchMD_GN(
            num_filters=args["embedding_dimension"],
            aggr=args.get("aggr", "add"),
            neighbor_embedding=args.get("neighbor_embedding", False),
            buffer_dtype=dtype_mapping[args.get("precision", 32)],
            **shared,
        )
    if args["model"] == "tensornet":
        return TensorNet(
            equivariance_invariance_group=args.get("equivariance_invariance_group", "O(3)"),
            fused_message=args.get("fused_message", False),
            **shared,
        )
    attention = dict(
        attn_activation=args.get("attn_activation", "silu"),
        neighbor_embedding=args.get("neighbor_embedding", False),
        num_heads=args.get("num_heads", 8),
        distance_influence=args.get("distance_influence", "both"),
        fused_attention=args.get("fused_attention", False),
    )
    if args["model"] == "transformer":
        return TorchMD_T(buffer_dtype=dtype_mapping[args.get("precision", 32)], **attention, **shared)
    if args["model"] != "equivariant-transformer":
        raise ValueError(f"Unknown architecture: {args['model']}")
    return TorchMD_ET(**attention, **shared)


def create_prior_models(args: Dict[str, Any], dataset=None):
    """The priors of ``args["prior_model"]``: a name, a dict {name: kwargs}
    or a list of either; ``prior_args`` saved in a checkpoint replay when
    present (the JAX package's parser).  With a ``dataset``, the pair priors
    take those of its ``atomic_number``, ``distance_scale`` and
    ``energy_scale`` that their constructor has and their kwargs do not
    name, and Atomref its atomref table."""
    from torchmdnet_tpu_torch.priors import Atomref

    prior_models = []
    if not args.get("prior_model"):
        return prior_models
    prior_model = args["prior_model"]
    if not isinstance(prior_model, list):
        prior_model = [prior_model]
    names, kwargs_list = [], []
    for prior in prior_model:
        if isinstance(prior, dict):
            for key, value in prior.items():
                names.append(key)
                kwargs_list.append({} if value is None else value)
        else:
            names.append(prior)
            kwargs_list.append({})
    if args.get("prior_args") is not None:
        kwargs_list = args["prior_args"]
        if not isinstance(kwargs_list, list):
            kwargs_list = [kwargs_list]
    for name, kwargs in zip(names, kwargs_list):
        if name not in prior_class_mapping:
            raise ValueError(f"Unknown prior model {name}. Available models are "
                             f"{', '.join(prior_class_mapping)}")
        kwargs = dict(kwargs)
        if name == "Atomref":
            if "initial_atomref" in kwargs:
                prior_models.append(Atomref(**kwargs))
            else:
                prior_models.append(Atomref.from_dataset(dataset=dataset, max_z=kwargs.get("max_z")))
        else:
            if dataset is not None:
                # only what the prior's constructor takes (Coulomb has no
                # atomic_number): JAX passes all three, and its Coulomb
                # raises a TypeError for a dataset with atomic numbers
                accepted = inspect.signature(prior_class_mapping[name]).parameters
                for key in ("atomic_number", "distance_scale", "energy_scale"):
                    if key in accepted:
                        kwargs.setdefault(key, getattr(dataset, key, None))
            kwargs = {k: v for k, v in kwargs.items() if v is not None}
            prior_models.append(prior_class_mapping[name](**kwargs))
    return prior_models


def create_model(
    args: Dict[str, Any],
    prior_models=None,
    mean: Optional[float] = None,
    std: Optional[float] = None,
    device=None,
    seed: int = 0,
) -> Potential:
    """Build a Potential from a flat config dict, with weights drawn from a
    ``torch.Generator`` seeded with ``seed``.  ``prior_models`` default to
    ``create_prior_models(args)``.

    Runs on ``cuda`` unless ``device`` names another device; with no device
    given and no GPU present this raises.
    """
    device = resolve_device(device)
    args = dict(args)
    precision = args.get("precision", 32)
    if precision not in dtype_mapping:
        raise ValueError(f"precision {precision} is not supported (32 or 64)")
    if args.get("prior_model") and prior_models is None:
        prior_models = create_prior_models(args)
    prior_models = list(prior_models or [])
    if args.get("atom_filter", -1) > -1 and args.get("derivative", False):
        raise ValueError("Derivative and atom filter can't be used together")
    generator = torch.Generator().manual_seed(int(seed))
    representation = create_representation(args, generator)
    head_name = args.get("output_model", "Scalar")
    if args["model"] == "equivariant-transformer" and not head_name.startswith("Equivariant"):
        head_name = "Equivariant" + head_name
    head = head_class_mapping[head_name](
        args["embedding_dimension"], args["activation"],
        reduce_op=args.get("reduce_op", "sum"), generator=generator,
    )
    if prior_models and not head.allow_prior_model:
        import warnings

        warnings.warn("Prior model was given but the output model does not allow prior "
                      "models. Dropping the prior model.")
        prior_models = []
    module = EnergyModel(
        representation, head, priors=prior_models,
        mean=0.0 if mean is None else mean,
        std=1.0 if std is None else std,
        atom_filter=args.get("atom_filter", -1),
    )
    module = module.to(device=device, dtype=dtype_mapping[precision])
    return Potential(module=module, args=args, device=device)


def load_model(filepath, args=None, device=None, **kwargs) -> Potential:
    """A Potential with the weights of a checkpoint of the port or of the
    JAX package (``train/checkpoints.py``) and the standardization's mean
    and std saved beside them (a JAX checkpoint keeps none).  Hyperparameters
    come from the checkpoint unless ``args`` is given; ``kwargs`` override
    single ones.  Runs on ``cuda`` unless ``device`` names another device."""
    from torchmdnet_tpu_torch.train.checkpoints import load_checkpoint, load_weights

    ckpt = load_checkpoint(filepath)
    args = dict(ckpt["hyper_parameters"] if args is None else args)
    for key, value in kwargs.items():
        if key not in args:
            import warnings

            warnings.warn(f"Unknown hyperparameter: {key}={value}")
        args[key] = value
    extra = ckpt.get("extra") or {}
    model = create_model(args, device=device, mean=extra.get("mean"), std=extra.get("std"))
    load_weights(model.module, ckpt)
    return model
