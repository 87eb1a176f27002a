"""Batched, padded data loading (counterpart of torchmdnet_tpu/data/loader.py).

Every batch has one (num_atoms, num_mol) capacity: batch_size times the
largest molecule, rounded up to a multiple of 8 (or ``pad_multiple``), unless
given.  With ``num_buckets > 1`` samples are grouped by size into buckets,
batched within a bucket and padded to the bucket's own capacity; the order of
batches shuffles across buckets.  The epoch plan (shuffle order, buckets,
``drop_last``) is the JAX package's for the same seed and epoch, and the
batches are collated in numpy (``pad_molecules``), so they are bitwise the
JAX package's.  Batches come out on ``device`` (the CPU unless named).
"""

import math
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from torchmdnet_tpu_torch.data.batch import AtomicBatch, pad_molecules


def _round_up(x, m):
    return int(math.ceil(x / m) * m)


class PaddedLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_atoms_pad: Optional[int] = None,
        drop_last: bool = False,
        prefetch: int = 0,
        float_dtype=np.float32,
        num_buckets: int = 1,
        pad_multiple: Optional[int] = None,
        device="cpu",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.prefetch = prefetch
        self.device = device
        self.float_dtype = np.dtype(float_dtype)
        mult = pad_multiple if pad_multiple else 8
        mult = mult * 8 // math.gcd(mult, 8)
        sizes = np.asarray(dataset.sample_sizes())
        self.num_buckets = max(1, int(num_buckets))
        self._buckets = None  # [(member_indices, capacity)] when bucketing
        if self.num_buckets > 1 and len(sizes) and num_atoms_pad is None:
            by_size = np.argsort(sizes, kind="stable")
            groups = [g for g in np.array_split(by_size, self.num_buckets) if len(g)]
            self._buckets = [(g, _round_up(batch_size * int(sizes[g].max()), mult)) for g in groups]
            num_atoms_pad = max(cap for _, cap in self._buckets)
        if num_atoms_pad is None:
            max_size = int(sizes.max()) if len(sizes) else 1
            num_atoms_pad = _round_up(batch_size * max_size, mult)
        self.num_atoms_pad = num_atoms_pad  # the largest capacity

    def __len__(self):
        def nbatches(n):
            return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

        if self._buckets is not None:
            return sum(nbatches(len(members)) for members, _ in self._buckets)
        return nbatches(len(self.dataset))

    def _batch_plan(self):
        """The epoch's [(sample_indices, capacity)], seeded by seed + epoch."""
        rng = np.random.default_rng(self.seed + self.epoch)
        plan = []
        if self._buckets is not None:
            for members, cap in self._buckets:
                mem = rng.permutation(members) if self.shuffle else members
                for start in range(0, len(mem), self.batch_size):
                    idxs = mem[start : start + self.batch_size]
                    if self.drop_last and len(idxs) < self.batch_size:
                        break
                    plan.append((idxs, cap))
            if self.shuffle:
                rng.shuffle(plan)
            return plan
        n = len(self.dataset)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, self.batch_size):
            idxs = order[start : start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                break
            plan.append((idxs, self.num_atoms_pad))
        return plan

    def _batches(self) -> Iterator[AtomicBatch]:
        plan = self._batch_plan()
        self.epoch += 1
        for idxs, cap in plan:
            mols = [self.dataset[int(i)] for i in idxs]
            yield pad_molecules(mols, num_atoms=cap, num_mol=self.batch_size,
                                float_dtype=self.float_dtype, device=self.device)

    def __iter__(self) -> Iterator[AtomicBatch]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        # a background thread collates ahead of the consumer
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            finally:
                q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
