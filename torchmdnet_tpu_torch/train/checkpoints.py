"""Checkpoint save and load (counterpart of torchmdnet_tpu/train/checkpoints.py).

A checkpoint of the port is one file written with ``torch.save``: the
model's ``state_dict``, the hyperparameters, the optimizer's state (absent
in a file meant for inference only) and the trainer's state (epoch, step,
learning rate, best metric, EMA, and the standardization's mean and std,
which ``load_model`` restores), so one file serves both ``load_model`` and a
full resume.

``load_checkpoint`` also reads the JAX package's checkpoints (told apart by
their ``TMDNTPU2`` magic): a JSON header of hyperparameters, ``extra`` and
blob sizes, then flax msgpack blobs ``params`` and ``opt_state``
(torchmdnet_tpu/train/checkpoints.py:33-80), decoded here by a small msgpack
reader of the standard library and numpy.  The parameters become the port's
``state_dict`` through ``state_dict_from_jax``; optax's AdamW state becomes
``torch.optim.AdamW``'s (``adamw_state_from_optax``).  The JAX trainer keeps
no standardization in its checkpoints, so a JAX checkpoint's mean and std
are the defaults.  The JAX package cannot read the port's checkpoints.
"""

import json
import os
import re
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

_JAX_MAGIC = b"TMDNTPU2"


def save_checkpoint(filepath, state_dict, hyper_parameters: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None, optimizer=None):
    torch.save({
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "hyper_parameters": dict(hyper_parameters),
        "extra": dict(extra or {}),
        "optimizer": optimizer,
    }, filepath)


def is_jax_checkpoint(filepath) -> bool:
    with open(filepath, "rb") as f:
        return f.read(len(_JAX_MAGIC)) == _JAX_MAGIC


def load_checkpoint(filepath) -> Dict[str, Any]:
    """{'state_dict', 'hyper_parameters', 'extra', 'optimizer'}, tensors on
    the CPU.  A JAX checkpoint adds 'jax_params' and 'jax_opt_state' (the
    decoded trees, None where absent) and has 'optimizer' None: its state
    needs the optimizer's parameter order (``adamw_state_from_optax``)."""
    if is_jax_checkpoint(filepath):
        return _load_jax_checkpoint(filepath)
    ckpt = torch.load(filepath, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict) or "state_dict" not in ckpt:
        raise ValueError(f"{filepath} is not a torchmdnet_tpu_torch checkpoint")
    return ckpt


def read_hyperparameters(filepath) -> Dict[str, Any]:
    """A checkpoint's hyperparameters (of a JAX one, from its header alone)."""
    if is_jax_checkpoint(filepath):
        return _read_jax(filepath)[0]["hyper_parameters"]
    return load_checkpoint(filepath)["hyper_parameters"]


def load_weights(module, ckpt):
    """Load a checkpoint's ``state_dict`` into ``module``.  A JAX
    checkpoint's has no buffers (the port builds its constant RBF tables
    itself): those keep the module's values; any other missing or extra key
    raises, as a strict load does."""
    if "jax_params" not in ckpt:
        module.load_state_dict(ckpt["state_dict"])
        return
    missing, unexpected = module.load_state_dict(ckpt["state_dict"], strict=False)
    params = dict(module.named_parameters())
    bad = [k for k in missing if k in params] + list(unexpected)
    if bad:
        raise ValueError(f"the JAX checkpoint does not fit the model: {bad}")


def _read_jax(filepath):
    with open(filepath, "rb") as f:
        if f.read(len(_JAX_MAGIC)) != _JAX_MAGIC:
            raise ValueError(f"{filepath} is not a torchmdnet_tpu checkpoint")
        (meta_len,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(meta_len).decode("utf-8"))
        blobs = {name: f.read(size) for name, size in meta["blob_sizes"].items()}
    return meta, blobs


def _load_jax_checkpoint(filepath):
    from torchmdnet_tpu_torch.tools.from_jax import state_dict_from_jax

    meta, blobs = _read_jax(filepath)
    hparams = meta["hyper_parameters"]
    params = msgpack_restore(blobs["params"])
    opt_state = msgpack_restore(blobs["opt_state"]) if "opt_state" in blobs else None
    return {
        "state_dict": state_dict_from_jax(hparams, params),
        "hyper_parameters": hparams,
        "extra": meta.get("extra", {}),
        "optimizer": None,
        "jax_params": params,
        "jax_opt_state": opt_state,
    }


def adamw_state_from_optax(ckpt, optimizer, param_names):
    """``optimizer`` (a ``torch.optim.AdamW`` over the parameters named
    ``param_names``, in order) with the state of a JAX checkpoint's optax
    chain, ``clip_by_global_norm`` then ``inject_hyperparams(adamw)``
    (torchmdnet_tpu/train/trainer.py:123-130): the moments mu and nu are
    carried through ``state_dict_from_jax`` as the parameters are and become
    exp_avg and exp_avg_sq, adam's count becomes step.  Both optimizers apply
    the same bias correction, eps and decoupled decay, so the next step is
    the one JAX would take.  The learning rate is set by the trainer."""
    from torchmdnet_tpu_torch.tools.from_jax import state_dict_from_jax

    adam = _find_adam_state(ckpt["jax_opt_state"])
    hparams = ckpt["hyper_parameters"]
    mu, nu = state_dict_from_jax(hparams, adam["mu"]), state_dict_from_jax(hparams, adam["nu"])
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state = optimizer.state_dict()
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    state["state"] = {
        i: {"step": step.clone(), "exp_avg": mu[name].to(p.dtype), "exp_avg_sq": nu[name].to(p.dtype)}
        for i, (name, p) in enumerate(zip(param_names, params))
    }
    optimizer.load_state_dict(state)


def _find_adam_state(tree):
    """The ``ScaleByAdamState`` (count, mu, nu) inside a restored optax state."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for value in tree.values():
            found = _find_adam_state(value)
            if found is not None:
                return found
    return None


# --- flax's msgpack, read with the standard library and numpy --------------


def msgpack_restore(data: bytes):
    """Decode what flax's ``msgpack_serialize`` writes: maps, arrays, str,
    bin, ints, floats, nil and bools, flax's ext types 1 (an ndarray as
    (shape, dtype name, C-order bytes)), 2 (a complex) and 3 (a numpy scalar),
    and its chunked arrays.  bfloat16 arrays come back as torch tensors (numpy
    has no such dtype), every other array as numpy."""
    value, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} trailing bytes")
    return _unchunk(value)


_FIXED = {0xc0: None, 0xc2: False, 0xc3: True}
_STRUCTS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _length(buf, at, size):
    return struct.unpack_from(_LEN[size], buf, at)[0], at + size


def _unpack(buf, at):
    b = buf[at]
    at += 1
    if b <= 0x7f:
        return b, at
    if b >= 0xe0:
        return b - 0x100, at
    if 0x80 <= b <= 0x8f:
        return _map(buf, at, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _array(buf, at, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return str(buf[at:at + n], "utf-8"), at + n
    if b in _FIXED:
        return _FIXED[b], at
    if b in _STRUCTS:
        fmt = _STRUCTS[b]
        return struct.unpack_from(fmt, buf, at)[0], at + struct.calcsize(fmt)
    if b in (0xc4, 0xc5, 0xc6):  # bin 8/16/32
        n, at = _length(buf, at, 1 << (b - 0xc4))
        return bytes(buf[at:at + n]), at + n
    if b in (0xd9, 0xda, 0xdb):  # str 8/16/32
        n, at = _length(buf, at, 1 << (b - 0xd9))
        return str(buf[at:at + n], "utf-8"), at + n
    if b in (0xdc, 0xdd):  # array 16/32
        n, at = _length(buf, at, 2 if b == 0xdc else 4)
        return _array(buf, at, n)
    if b in (0xde, 0xdf):  # map 16/32
        n, at = _length(buf, at, 2 if b == 0xde else 4)
        return _map(buf, at, n)
    if 0xd4 <= b <= 0xd8:  # fixext 1/2/4/8/16
        n = 1 << (b - 0xd4)
    elif b in (0xc7, 0xc8, 0xc9):  # ext 8/16/32
        n, at = _length(buf, at, 1 << (b - 0xc7))
    else:
        raise ValueError(f"msgpack: unknown type byte {b:#x}")
    code = struct.unpack_from(">b", buf, at)[0]
    return _ext(code, bytes(buf[at + 1:at + 1 + n])), at + 1 + n


def _array(buf, at, n):
    out = []
    for _ in range(n):
        v, at = _unpack(buf, at)
        out.append(v)
    return out, at


def _map(buf, at, n):
    out = {}
    for _ in range(n):
        k, at = _unpack(buf, at)
        out[k], at = _unpack(buf, at)
    return out, at


def _ext(code, data):
    if code == 2:  # a complex as (real, imag)
        real, imag = msgpack_restore(data)
        return complex(real, imag)
    if code not in (1, 3):
        raise ValueError(f"msgpack: unknown ext type {code}")
    shape, dtype, raw = msgpack_restore(data)
    if dtype == "bfloat16":
        arr = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(shape)
    else:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return arr if code == 1 else arr[()]


def _unchunk(tree):
    """flax's arrays above its chunk size, split into flat chunks, joined."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def latest_checkpoint(log_dir) -> Optional[str]:
    """The newest .ckpt in ``log_dir`` by the epoch in its name (the newer
    file breaks ties); None if there is none."""
    best = best_key = None
    try:
        names = os.listdir(log_dir)
    except FileNotFoundError:
        return None
    for name in names:
        if not name.endswith(".ckpt"):
            continue
        path = os.path.join(log_dir, name)
        m = re.search(r"epoch=(\d+)", name)
        key = (int(m.group(1)) if m else -1, os.path.getmtime(path))
        if best_key is None or key > best_key:
            best, best_key = path, key
    return best
