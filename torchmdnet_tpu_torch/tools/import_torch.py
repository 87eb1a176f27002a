"""Import reference (PyTorch torchmd-net) checkpoints into the port
(counterpart of torchmdnet_tpu/tools/import_torch.py).

A reference Lightning checkpoint holds ``hyper_parameters`` and a
``state_dict`` whose keys carry a ``model.`` prefix (reference model.py:133).
The port keeps the reference's key names and torch's (out, in) weights, so
most tensors carry over as they are.  Two layouts differ, and their rows
are permuted on the way in, as the JAX package permutes its columns:

- ET's value projections ``v_proj`` and ``dv_proj``: the reference splits
  them per head, the port in global thirds (``models/et.py``,
  ``vproj_column_perm``);
- TensorNet's interaction filter ``linears_scalar.2``: the reference
  interleaves it (H, 3), the port slices irrep thirds
  (``models/tensornet.py``, ``wproj_column_perm``).

The import reads what the JAX package's importer reads and nothing else, so
``import_state_dict`` equals the JAX package's ``import_state_dict``
followed by ``state_dict_from_jax``, key for key.  What it leaves out are
constants the port computes from the hyperparameters (a fixed RBF's shape
buffers, Atomref's initial table).
"""

from typing import Any, Dict

import numpy as np
import torch

from torchmdnet_tpu_torch.models.et import vproj_column_perm
from torchmdnet_tpu_torch.models.tensornet import wproj_column_perm
from torchmdnet_tpu_torch.utils import resolve_device


def _t(a):
    """float32 tensor (float64 where the checkpoint holds float64), as
    ``tools/from_jax.py`` makes them."""
    a = np.asarray(a)
    return torch.as_tensor(np.array(a, dtype=np.float64 if a.dtype == np.float64 else np.float32))


class _Importer:
    def __init__(self, sd):
        self.sd = sd
        self.out: Dict[str, torch.Tensor] = {}

    def copy(self, key, perm=None):
        value = self.sd[key]
        self.out[key] = _t(value if perm is None else value[perm])

    def linear(self, prefix, bias=True, perm=None):
        """A torch Linear: weight (out, in) and bias (out,); ``perm`` reorders
        the outputs (the weight's rows)."""
        self.copy(prefix + ".weight", perm)
        if bias:
            self.copy(prefix + ".bias", perm)

    def layer_norm(self, prefix):
        self.copy(prefix + ".weight")
        self.copy(prefix + ".bias")

    def rbf(self, prefix, trainable):
        """Only a trainable expansion's shape constants are weights."""
        if not trainable:
            return
        for a, b in (("means", "betas"), ("offset", "coeff")):
            if f"{prefix}.{a}" in self.sd:
                self.copy(f"{prefix}.{a}")
                self.copy(f"{prefix}.{b}")
                return

    def embeddings(self, p, args):
        self.copy(f"{p}.embedding.weight")
        self.rbf(f"{p}.distance_expansion", args.get("trainable_rbf", False))
        if args.get("neighbor_embedding"):
            self.linear(f"{p}.neighbor_embedding.distance_proj")
            self.copy(f"{p}.neighbor_embedding.embedding.weight")
            self.linear(f"{p}.neighbor_embedding.combine")

    def gated_block(self, prefix):
        self.linear(prefix + ".vec1_proj", bias=False)
        self.linear(prefix + ".vec2_proj", bias=False)
        self.linear(prefix + ".update_net.0")
        self.linear(prefix + ".update_net.2")


def _attention(imp, p, args):
    """ET's and the Transformer's layers; ET's v/dv rows permuted to global
    thirds."""
    imp.embeddings(p, args)
    et = args["model"] == "equivariant-transformer"
    perm = vproj_column_perm(args["embedding_dimension"], args.get("num_heads", 8)) if et else None
    influence = args.get("distance_influence", "both")
    for i in range(args["num_layers"]):
        lp = f"{p}.attention_layers.{i}"
        imp.layer_norm(f"{lp}.layernorm")
        imp.linear(f"{lp}.q_proj")
        imp.linear(f"{lp}.k_proj")
        imp.linear(f"{lp}.v_proj", perm=perm)
        if et:
            imp.linear(f"{lp}.vec_proj", bias=False)
        if influence in ("keys", "both"):
            imp.linear(f"{lp}.dk_proj")
        if influence in ("values", "both"):
            imp.linear(f"{lp}.dv_proj", perm=perm)
        imp.linear(f"{lp}.o_proj")
    imp.layer_norm(f"{p}.out_norm")


def _graph_network(imp, p, args):
    imp.embeddings(p, args)
    for i in range(args["num_layers"]):
        lp = f"{p}.interactions.{i}"
        imp.linear(f"{lp}.mlp.0")
        imp.linear(f"{lp}.mlp.2")
        imp.linear(f"{lp}.conv.lin1", bias=False)
        imp.linear(f"{lp}.conv.lin2")
        imp.linear(f"{lp}.lin")


def _tensornet(imp, p, args):
    """TensorNet's layers; each interaction's filter rows permuted from the
    reference's (H, 3) interleave to irrep thirds."""
    imp.rbf(f"{p}.distance_expansion", args.get("trainable_rbf", False))
    te = f"{p}.tensor_embedding"
    for name in ("distance_proj1", "distance_proj2", "distance_proj3"):
        imp.linear(f"{te}.{name}")
    imp.copy(f"{te}.emb.weight")
    imp.linear(f"{te}.emb2")
    imp.layer_norm(f"{te}.init_norm")
    for i in range(3):
        imp.linear(f"{te}.linears_tensor.{i}", bias=False)
    for i in range(2):
        imp.linear(f"{te}.linears_scalar.{i}")
    perm = wproj_column_perm(args["embedding_dimension"])
    for li in range(args["num_layers"]):
        lp = f"{p}.layers.{li}"
        imp.linear(f"{lp}.linears_scalar.0")
        imp.linear(f"{lp}.linears_scalar.1")
        imp.linear(f"{lp}.linears_scalar.2", perm=perm)
        for i in range(6):
            imp.linear(f"{lp}.linears_tensor.{i}", bias=False)
    imp.layer_norm(f"{p}.out_norm")
    imp.linear(f"{p}.linear")


def _head(imp, args):
    """The gated equivariant blocks of ET's heads and of the equivariant
    heads that have them, else the two-layer MLP (the JAX package's
    ``import_head``)."""
    p = "output_model.output_network"
    name = args.get("output_model", "Scalar")
    gated = ("Scalar", "DipoleMoment", "EquivariantScalar", "EquivariantDipoleMoment", "EquivariantVectorOutput")
    if (args["model"] == "equivariant-transformer" or name.startswith("Equivariant")) and name in gated:
        imp.gated_block(f"{p}.0")
        imp.gated_block(f"{p}.1")
    else:
        imp.linear(f"{p}.0")
        imp.linear(f"{p}.2")


def _priors(imp):
    """Atomref's table; the reference's ``prior_model.{i}`` becomes the
    port's ``priors.{i}``, and priors without weights are skipped."""
    i = 0
    while any(k.startswith(f"prior_model.{i}.") for k in imp.sd):
        key = f"prior_model.{i}.atomref.weight"
        if key in imp.sd:
            imp.out[f"priors.{i}.atomref"] = _t(imp.sd[key])
        i += 1


def _strip(state_dict):
    """numpy arrays under the keys without their ``model.`` prefix."""
    sd = {}
    for key, val in state_dict.items():
        if key.startswith("model."):
            key = key[len("model."):]
        if hasattr(val, "detach"):
            val = val.detach().cpu().numpy()
        sd[key] = np.asarray(val)
    return sd


def import_state_dict(args: Dict[str, Any], state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` (torch tensors or numpy arrays, with or
    without ``model.`` prefixes) -> the port's ``state_dict`` for
    ``create_model(args)``'s ``module``."""
    imp = _Importer(_strip(state_dict))
    p = "representation_model"
    model = args["model"]
    if model in ("equivariant-transformer", "transformer"):
        _attention(imp, p, args)
    elif model == "graph-network":
        _graph_network(imp, p, args)
    elif model == "tensornet":
        _tensornet(imp, p, args)
    else:
        raise ValueError(f"Unknown model: {model}")
    _head(imp, args)
    _priors(imp)
    return imp.out


def load_torch_checkpoint(filepath, args=None):
    """A reference .ckpt -> (args, the port's state_dict).  The
    hyperparameters come from the checkpoint unless ``args`` is given."""
    ckpt = torch.load(filepath, map_location="cpu", weights_only=False)
    if args is None:
        args = dict(ckpt["hyper_parameters"])
    return args, import_state_dict(args, ckpt["state_dict"])


def import_checkpoint(filepath, device=None, **kwargs):
    """A reference .ckpt -> a port ``Potential`` with its weights, on
    ``cuda`` unless ``device`` names another device.  ``kwargs`` override
    the checkpoint's hyperparameters (e.g. ``max_num_neighbors``), as the
    reference's ``load_model`` does (model.py:121-143).

    The reference registers the standardization's ``mean`` and ``std`` as
    buffers of its model; where the checkpoint has them, the Potential
    takes them (the JAX package's importer drops them)."""
    from torchmdnet_tpu_torch.models.potential import create_model

    ckpt = torch.load(filepath, map_location="cpu", weights_only=False)
    args = dict(ckpt["hyper_parameters"])
    args.update(kwargs)
    sd = _strip(ckpt["state_dict"])
    scale = {k: float(sd[k]) for k in ("mean", "std") if k in sd}
    model = create_model(args, device=resolve_device(device), **scale)
    state = import_state_dict(args, sd)
    missing, unexpected = model.module.load_state_dict(state, strict=False)
    buffers = {name for name, _ in model.module.named_buffers()}
    if unexpected or set(missing) - buffers:
        raise ValueError(f"{filepath} does not fit the model of its hyperparameters: missing weights "
                         f"{sorted(set(missing) - buffers)}, unexpected {sorted(unexpected)}")
    return model
