"""Checkpoint save and load (counterpart of torchmdnet_tpu/train/checkpoints.py).

A checkpoint is one file written with ``torch.save``: the model's
``state_dict``, the hyperparameters, the optimizer's state (absent in a file
meant for inference only) and the trainer's state (epoch, step, learning
rate, best metric, EMA, and the standardization's mean and std, which
``load_model`` restores), so one file serves both ``load_model`` and a full
resume.  The JAX package's msgpack checkpoints are not read (ROADMAP.md).
"""

import os
import re
from typing import Any, Dict, Optional

import torch


def save_checkpoint(filepath, state_dict, hyper_parameters: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None, optimizer=None):
    torch.save({
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "hyper_parameters": dict(hyper_parameters),
        "extra": dict(extra or {}),
        "optimizer": optimizer,
    }, filepath)


def load_checkpoint(filepath) -> Dict[str, Any]:
    """{'state_dict', 'hyper_parameters', 'extra', 'optimizer'}, tensors on
    the CPU."""
    ckpt = torch.load(filepath, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict) or "state_dict" not in ckpt:
        raise ValueError(f"{filepath} is not a torchmdnet_tpu_torch checkpoint")
    return ckpt


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
