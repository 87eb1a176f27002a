"""Carry weights from the JAX package into the port.

``state_dict_from_jax(args, params)`` turns the JAX package's flax parameter
tree (nested dicts of arrays, with or without the outer ``{"params": ...}``)
into the port's ``state_dict``.  The port keeps the reference torchmd-net key
names (``representation_model.attention_layers.0.q_proj.weight``, ...) and
the JAX package's column layout (ET's v/dv projections in global thirds,
TensorNet's interaction filter in irrep thirds), so no column permutation is
needed here: the reference's (H, 3)-interleaved TensorNet filter
(``wproj_column_perm``) applies only to reference torch checkpoints.  Every
head is ``lin1``/``lin2`` (Scalar, DipoleMoment, ElectronicSpatialExtent)
or ``block1``/``block2`` (the equivariant heads).  A prior's table
(Atomref's ``priors_1/atomref``) becomes ``priors.1.atomref``; the pair
priors have no parameters.
Flax kernels are (in, out); torch Linear weights are (out, in): transposed
on the way.  This is the same map as
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
    if args["model"] not in ("equivariant-transformer", "transformer", "tensornet", "graph-network"):
        raise ValueError(f"Unknown architecture: {args['model']}")
    rep = params["representation"]
    out: Dict[str, torch.Tensor] = {}
    p = "representation_model"
    rbf_name = "ExpNormalSmearing_0" if args["rbf_type"] == "expnorm" else "GaussianSmearing_0"
    if args.get("trainable_rbf", False):
        for name, value in rep[rbf_name].items():
            out[f"{p}.distance_expansion.{name}"] = _t(value)
    if args["model"] == "tensornet":
        _tensornet(out, p, rep, args["num_layers"])
    elif args["model"] == "graph-network":
        _graph_network(out, p, rep, args)
    else:
        _attention(out, p, rep, args)
    _head_and_priors(out, params)
    return out


def _tensornet(out, p, rep, num_layers):
    """TensorNet's keys, those torchmdnet_tpu/tools/import_torch.py reads."""
    te, emb = f"{p}.tensor_embedding", rep["TensorEmbedding_0"]
    for i, name in enumerate(("distance_proj1", "distance_proj2", "distance_proj3")):
        _dense(out, f"{te}.{name}", emb[f"Dense_{i}"])
    out[f"{te}.emb.weight"] = _t(emb["Embed_0"]["embedding"])
    _dense(out, f"{te}.emb2", emb["Dense_3"])
    _layer_norm(out, f"{te}.init_norm", emb["LayerNorm_0"])
    for i in range(3):
        _dense(out, f"{te}.linears_tensor.{i}", emb[f"Dense_{4 + i}"], bias=False)
    for i in range(2):
        _dense(out, f"{te}.linears_scalar.{i}", emb[f"Dense_{7 + i}"])
    for li in range(num_layers):
        layer, lp = rep[f"Interaction_{li}"], f"{p}.layers.{li}"
        for i in range(3):
            _dense(out, f"{lp}.linears_scalar.{i}", layer[f"Dense_{i}"])
        for i in range(6):
            _dense(out, f"{lp}.linears_tensor.{i}", layer[f"Dense_{3 + i}"], bias=False)
    _layer_norm(out, f"{p}.out_norm", rep["LayerNorm_0"])
    _dense(out, f"{p}.linear", rep["Dense_0"])


def _embeddings(out, p, rep, args):
    """The atom embedding and the optional NeighborEmbedding (ET, the Transformer and GN)."""
    out[f"{p}.embedding.weight"] = _t(rep["Embed_0"]["embedding"])
    if args.get("neighbor_embedding", False):
        ne = rep["NeighborEmbedding_0"]
        _dense(out, f"{p}.neighbor_embedding.distance_proj", ne["Dense_0"])
        out[f"{p}.neighbor_embedding.embedding.weight"] = _t(ne["Embed_0"]["embedding"])
        _dense(out, f"{p}.neighbor_embedding.combine", ne["Dense_1"])


def _graph_network(out, p, rep, args):
    """GN's keys, those torchmdnet_tpu/tools/import_torch.py reads."""
    _embeddings(out, p, rep, args)
    for i in range(args["num_layers"]):
        block, lp = rep[f"InteractionBlock_{i}"], f"{p}.interactions.{i}"
        conv = block["CFConv_0"]
        _dense(out, f"{lp}.mlp.0", conv["Dense_0"])
        _dense(out, f"{lp}.mlp.2", conv["Dense_1"])
        _dense(out, f"{lp}.conv.lin1", conv["Dense_2"], bias=False)
        _dense(out, f"{lp}.conv.lin2", conv["Dense_3"])
        _dense(out, f"{lp}.lin", block["Dense_0"])


def _attention(out, p, rep, args):
    """ET's and the Transformer's keys, in the order of
    torchmdnet_tpu/tools/import_torch.py:84-123: q, k, v, (ET: vec), then
    dk and dv where distance_influence keeps them, then o."""
    _embeddings(out, p, rep, args)
    influence = args.get("distance_influence", "both")
    et = args["model"] == "equivariant-transformer"
    for i in range(args["num_layers"]):
        layer = rep[f"{'EquivariantMultiHeadAttention' if et else 'MultiHeadAttention'}_{i}"]
        lp = f"{p}.attention_layers.{i}"
        _layer_norm(out, f"{lp}.layernorm", layer["LayerNorm_0"])
        _dense(out, f"{lp}.q_proj", layer["Dense_0"])
        _dense(out, f"{lp}.k_proj", layer["Dense_1"])
        _dense(out, f"{lp}.v_proj", layer["Dense_2"])
        nxt = 3
        if et:
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


def _head_and_priors(out, params):
    head = params["head"]
    if "block1" in head:
        _gated_block(out, "output_model.output_network.0", head["block1"])
        _gated_block(out, "output_model.output_network.1", head["block2"])
    else:
        _dense(out, "output_model.output_network.0", head["lin1"])
        _dense(out, "output_model.output_network.2", head["lin2"])
    # only priors with parameters have a subtree, so a prior's index is read
    # from its name
    for key, value in params.items():
        if key.startswith("priors_"):
            i = int(key[len("priors_"):])
            for name, leaf in value.items():
                out[f"priors.{i}.{name}"] = _t(leaf)
