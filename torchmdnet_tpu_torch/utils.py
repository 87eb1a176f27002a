"""Helpers shared by the port's entry points: the device rule, train/val/test
splits and the CLI's configuration handling."""

import argparse
import json
import os
import warnings
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names one.

    With no device given and no GPU present this raises instead of carrying on
    on the CPU: a silent CPU run would look like a working (and very slow)
    GPU run.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)


# --- splits and configuration (counterpart of torchmdnet_tpu/utils.py:17-182)


def train_val_test_split(dset_len, train_size, val_size, test_size, seed, order=None):
    """Float-ratio or absolute-count splits of a seeded permutation: the JAX
    package's (and the reference's) index order for the same seed."""
    assert (train_size is None) + (val_size is None) + (test_size is None) <= 1, (
        "Only one of train_size, val_size, test_size is allowed to be None."
    )
    is_float = (isinstance(train_size, float), isinstance(val_size, float), isinstance(test_size, float))
    train_size = round(dset_len * train_size) if is_float[0] else train_size
    val_size = round(dset_len * val_size) if is_float[1] else val_size
    test_size = round(dset_len * test_size) if is_float[2] else test_size
    if train_size is None:
        train_size = dset_len - val_size - test_size
    elif val_size is None:
        val_size = dset_len - train_size - test_size
    elif test_size is None:
        test_size = dset_len - train_size - val_size
    if train_size + val_size + test_size > dset_len:
        if is_float[2]:
            test_size -= 1
        elif is_float[1]:
            val_size -= 1
        elif is_float[0]:
            train_size -= 1
    assert train_size >= 0 and val_size >= 0 and test_size >= 0, (
        f"One of training ({train_size}), validation ({val_size}) or "
        f"testing ({test_size}) splits ended up with a negative size."
    )
    total = train_size + val_size + test_size
    assert dset_len >= total, (
        f"The dataset ({dset_len}) is smaller than the combined split sizes ({total})."
    )
    if total < dset_len:
        warnings.warn(f"{dset_len - total} samples were excluded from the dataset")
    idxs = np.arange(dset_len, dtype=int)
    if order is None:
        idxs = np.random.default_rng(seed).permutation(idxs)
    idx_train = idxs[:train_size]
    idx_val = idxs[train_size : train_size + val_size]
    idx_test = idxs[train_size + val_size : total]
    if order is not None:
        idx_train = [order[i] for i in idx_train]
        idx_val = [order[i] for i in idx_val]
        idx_test = [order[i] for i in idx_test]
    return np.array(idx_train), np.array(idx_val), np.array(idx_test)


def make_splits(dataset_len, train_size, val_size, test_size, seed, filename=None, splits=None,
                order=None):
    """Splits from an ``.npz`` (idx_train, idx_val, idx_test) or drawn anew;
    saved to ``filename`` when given."""
    if splits is not None:
        splits = np.load(splits)
        idx_train, idx_val, idx_test = splits["idx_train"], splits["idx_val"], splits["idx_test"]
    else:
        idx_train, idx_val, idx_test = train_val_test_split(
            dataset_len, train_size, val_size, test_size, seed, order
        )
    if filename is not None:
        np.savez(filename, idx_train=idx_train, idx_val=idx_val, idx_test=idx_test)
    return (np.asarray(idx_train, dtype=np.int64), np.asarray(idx_val, dtype=np.int64),
            np.asarray(idx_test, dtype=np.int64))


def number(text):
    """A CLI string as an int if it is one, else a float; "None" is None."""
    if text is None or text == "None":
        return None
    try:
        return int(text)
    except ValueError:
        return float(text)


class LoadFromFile(argparse.Action):
    """``--conf config.yaml``: merge a YAML file into the flags, rejecting
    unknown keys; flags given after it override it."""

    def __call__(self, parser, namespace, values, option_string=None):
        if not values.name.endswith(("yaml", "yml")):
            raise ValueError("Configuration file must end with yaml or yml")
        import yaml

        with values as f:
            config = yaml.safe_load(f)
        for key in config.keys():
            if key not in namespace:
                raise ValueError(f"Unknown argument in config file: {key}")
        if ("load_model" in config and namespace.load_model is not None
                and config["load_model"] != namespace.load_model):
            warnings.warn(
                f"The load model argument was specified as a command line argument "
                f"({namespace.load_model}) and in the config file ({config['load_model']}). "
                "Ignoring the config file option."
            )
            del config["load_model"]
        namespace.__dict__.update(config)


class LoadFromCheckpoint(argparse.Action):
    """``--load-model ckpt``: take the hyperparameters from ``hparams.yaml``
    beside the checkpoint (the port writes it as JSON, the JAX package as
    YAML), or, where there is none, from the checkpoint itself (the port's or
    the JAX package's)."""

    def __call__(self, parser, namespace, values, option_string=None):
        hparams_path = os.path.join(os.path.dirname(values), "hparams.yaml")
        if os.path.exists(hparams_path):
            with open(hparams_path) as f:
                text = f.read()
            try:
                config = json.loads(text)
            except json.JSONDecodeError:
                import yaml

                config = yaml.safe_load(text)
        else:
            from torchmdnet_tpu_torch.train.checkpoints import read_hyperparameters

            warnings.warn(
                "hparams.yaml file not found next to the checkpoint; "
                "hyperparameters will come from the checkpoint file itself."
            )
            config = read_hyperparameters(values)
        for key in config.keys():
            if key not in namespace and key != "prior_args":
                raise ValueError(f"Unknown argument in the model checkpoint: {key}")
        namespace.__dict__.update(config)
        namespace.__dict__.update(load_model=values)


def save_argparse(args, filename, exclude=None):
    """Write the resolved flags: ``.yaml``/``.yml`` files as JSON (a subset of
    YAML, so YAML readers load them), anything else as ``key=value`` lines."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    if filename.endswith(("yaml", "yml")):
        if isinstance(exclude, str):
            exclude = [exclude]
        args = {k: v for k, v in vars(args).items() if k not in (exclude or [])}
        with open(filename, "w") as f:
            json.dump(args, f, indent=1, default=str)
    else:
        with open(filename, "w") as f:
            for k, v in vars(args).items():
                f.write(f"{k}={v}\n")
