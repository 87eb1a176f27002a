"""Data module: dataset by name, splits, standardization, loaders
(counterpart of torchmdnet_tpu/data/module.py).

Its loaders put the batches on ``hparams["device"]``: ``cuda`` unless a
device is named (with no device named and no GPU present, it raises)."""

import math
import os
from os.path import join
from typing import Optional

import numpy as np

from torchmdnet_tpu_torch.data import datasets as datasets_module
from torchmdnet_tpu_torch.data.datasets.base import Subset
from torchmdnet_tpu_torch.data.loader import PaddedLoader, _round_up
from torchmdnet_tpu_torch.utils import make_splits, resolve_device

# capacities are multiples of 8 atoms, as in the JAX package on one device,
# and of the rank count under data parallelism (``pad_multiple``)
PAD_MULTIPLE = 8


def pad_multiple(ranks: int) -> int:
    """The capacity multiple: 8 and the rank count, so that every rank's
    share of a batch's atom slots is whole (the JAX package rounds to its
    device count)."""
    return PAD_MULTIPLE * ranks // math.gcd(PAD_MULTIPLE, ranks)


class DataModule:
    def __init__(self, hparams, dataset=None):
        self.hparams = dict(hparams)
        self.device = resolve_device(self.hparams.get("device"))
        self._mean: Optional[float] = None
        self._std: Optional[float] = None
        self.dataset = dataset

    def setup(self):
        h = self.hparams
        if self.dataset is None and h["dataset"] == "Custom":
            # globs of npy files, from --coord-files etc.
            self.dataset = datasets_module.Custom(h["coord_files"], h["embed_files"], h["energy_files"],
                                                  h["force_files"])
        elif self.dataset is None:
            dataset_arg = {}
            if h.get("dataset_arg") is not None:
                da = h["dataset_arg"]
                dataset_arg = da if isinstance(da, dict) else {"dataset_arg": da}
            self.dataset = getattr(datasets_module, h["dataset"])(h["dataset_root"], **dataset_arg)
        log_dir = h.get("log_dir", "/tmp/logs")
        os.makedirs(log_dir, exist_ok=True)
        self.idx_train, self.idx_val, self.idx_test = make_splits(
            len(self.dataset), h.get("train_size"), h.get("val_size"), h.get("test_size"),
            h.get("seed", 1), join(log_dir, "splits.npz"), h.get("splits"),
        )
        print(f"train {len(self.idx_train)}, val {len(self.idx_val)}, test {len(self.idx_test)}")
        self.train_dataset = Subset(self.dataset, self.idx_train)
        self.val_dataset = Subset(self.dataset, self.idx_val)
        self.test_dataset = Subset(self.dataset, self.idx_test)
        # one capacity for every stage
        sizes = np.asarray(self.dataset.sample_sizes())
        max_size = int(sizes.max()) if len(sizes) else 1
        bs = max(h["batch_size"], h.get("inference_batch_size") or h["batch_size"])
        self.num_atoms_pad = _round_up(bs * max_size, pad_multiple(self._ranks()[1]))
        if h.get("standardize"):
            self._standardize()

    def _ranks(self):
        """(rank, count) of the data-parallel ranks; (0, 1) outside a process
        group and under edge partitioning (every rank loads the same batch)."""
        from torchmdnet_tpu_torch.parallel.distributed import process_info

        if self.hparams.get("edge_partition"):
            return 0, 1
        return process_info()

    def _loader(self, dataset, stage):
        h = self.hparams
        rank, count = self._ranks()
        batch_size = h["batch_size"] if stage == "train" else (h.get("inference_batch_size") or h["batch_size"])
        float_dtype = {16: np.float32, 32: np.float32, 64: np.float64}[h.get("precision", 32)]
        num_buckets = int(h.get("loader_buckets", 1) or 1)
        return PaddedLoader(
            dataset,
            batch_size=batch_size,
            shuffle=stage == "train",
            seed=h.get("seed", 1),
            # bucketed loaders take their capacities from the subset they serve
            num_atoms_pad=None if num_buckets > 1 else self.num_atoms_pad,
            extra_atom_keys=("partial_charges",) if self._has_partial_charges() else (),
            float_dtype=float_dtype,
            prefetch=2 if h.get("num_workers", 0) else 0,
            num_buckets=num_buckets,
            pad_multiple=pad_multiple(count),
            device=self.device,
            process_rank=rank,
            process_count=count,
        )

    def _has_partial_charges(self):
        """Whether the samples carry per-atom partial charges (``pq``), which
        the loaders then collate into ``batch.extra["partial_charges"]``."""
        if len(self.dataset) == 0:
            return False
        sample = self.dataset[0]
        return "pq" in sample or "partial_charges" in sample

    def train_dataloader(self):
        return self._loader(self.train_dataset, "train")

    def val_dataloader(self):
        return self._loader(self.val_dataset, "val")

    def test_dataloader(self):
        return self._loader(self.test_dataset, "test")

    @property
    def atomref(self):
        if hasattr(self.dataset, "get_atomref"):
            return self.dataset.get_atomref()
        return None

    @property
    def mean(self):
        return self._mean

    @property
    def std(self):
        return self._std

    def _standardize(self):
        """Mean and std (ddof 1) of the train energies minus their atomref
        contributions."""
        atomref = self.atomref if self.hparams.get("prior_model") == "Atomref" else None
        ys = []
        for i in range(len(self.train_dataset)):
            sample = self.train_dataset[i]
            if "y" not in sample:
                import warnings

                warnings.warn(
                    "Standardize is true but failed to compute dataset mean and "
                    "standard deviation. Maybe the dataset only contains forces."
                )
                return
            y = float(np.asarray(sample["y"]).reshape(-1)[0])
            if atomref is not None:
                y -= float(np.asarray(atomref).reshape(-1)[sample["z"]].sum())
            ys.append(y)
        ys = np.asarray(ys)
        self._mean = float(ys.mean())
        self._std = float(ys.std(ddof=1))
