"""Carry weights from the JAX package into the port.

``state_dict_from_jax(args, params)`` turns the JAX package's flax parameter
tree (nested dicts of arrays, with or without the outer ``{"params": ...}``)
into the port's ``state_dict``.  The port keeps the reference torchmd-net key
names (``representation_model.attention_layers.0.q_proj.weight``, ...) and
the JAX package's column layout (v/dv projections in global thirds), so no
column permutation is needed here.  A prior's table (Atomref's
``priors_0/atomref``) becomes ``priors.0.atomref``.  Flax kernels are (in, out); torch Linear
weights are (out, in): transposed on the way.  This is the same map as
torchmdnet_tpu/tools/import_torch.py, read from the other side.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a):
    a = np.asarray(a)
    return torch.as_tensor(np.array(a, dtype=np.float64 if a.dtype == np.float64 else np.float32))


def _dense(out, prefix, tree, bias=True):
    out[prefix + ".weight"] = _t(np.asarray(tree["kernel"]).T)
    if bias:
        out[prefix + ".bias"] = _t(tree["bias"])


def _layer_norm(out, prefix, tree):
    out[prefix + ".weight"] = _t(tree["scale"])
    out[prefix + ".bias"] = _t(tree["bias"])


def _gated_block(out, prefix, tree):
    _dense(out, prefix + ".vec1_proj", tree["Dense_0"], bias=False)
    _dense(out, prefix + ".vec2_proj", tree["Dense_1"], bias=False)
    _dense(out, prefix + ".update_net.0", tree["Dense_2"])
    _dense(out, prefix + ".update_net.2", tree["Dense_3"])


def state_dict_from_jax(args: Dict[str, Any], params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``Potential`` params -> the port's ``state_dict`` (float32 tensors,
    float64 where the tree holds float64)."""
    if "params" in params:
        params = params["params"]
    if args["model"] != "equivariant-transformer":
        raise NotImplementedError(
            "only the equivariant-transformer is ported so far (ROADMAP.md, slice E)"
        )
    rep = params["representation"]
    out: Dict[str, torch.Tensor] = {}
    p = "representation_model"
    out[f"{p}.embedding.weight"] = _t(rep["Embed_0"]["embedding"])
    rbf_name = "ExpNormalSmearing_0" if args["rbf_type"] == "expnorm" else "GaussianSmearing_0"
    if args.get("trainable_rbf", False):
        for name, value in rep[rbf_name].items():
            out[f"{p}.distance_expansion.{name}"] = _t(value)
    if args.get("neighbor_embedding", False):
        ne = rep["NeighborEmbedding_0"]
        _dense(out, f"{p}.neighbor_embedding.distance_proj", ne["Dense_0"])
        out[f"{p}.neighbor_embedding.embedding.weight"] = _t(ne["Embed_0"]["embedding"])
        _dense(out, f"{p}.neighbor_embedding.combine", ne["Dense_1"])
    influence = args.get("distance_influence", "both")
    for i in range(args["num_layers"]):
        layer = rep[f"EquivariantMultiHeadAttention_{i}"]
        lp = f"{p}.attention_layers.{i}"
        _layer_norm(out, f"{lp}.layernorm", layer["LayerNorm_0"])
        _dense(out, f"{lp}.q_proj", layer["Dense_0"])
        _dense(out, f"{lp}.k_proj", layer["Dense_1"])
        _dense(out, f"{lp}.v_proj", layer["Dense_2"])
        _dense(out, f"{lp}.vec_proj", layer["Dense_3"], bias=False)
        nxt = 4
        if influence in ("keys", "both"):
            _dense(out, f"{lp}.dk_proj", layer[f"Dense_{nxt}"])
            nxt += 1
        if influence in ("values", "both"):
            _dense(out, f"{lp}.dv_proj", layer[f"Dense_{nxt}"])
            nxt += 1
        _dense(out, f"{lp}.o_proj", layer[f"Dense_{nxt}"])
    _layer_norm(out, f"{p}.out_norm", rep["LayerNorm_0"])

    head = params["head"]
    if "block1" in head:
        _gated_block(out, "output_model.output_network.0", head["block1"])
        _gated_block(out, "output_model.output_network.1", head["block2"])
    else:
        _dense(out, "output_model.output_network.0", head["lin1"])
        _dense(out, "output_model.output_network.2", head["lin2"])
    i = 0
    while f"priors_{i}" in params:
        for name, value in params[f"priors_{i}"].items():
            out[f"priors.{i}.{name}"] = _t(value)
        i += 1
    return out
