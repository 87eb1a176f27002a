"""The native collation engine (``torchmdnet_tpu_torch/data/native_collate.py``,
``csrc/collate.cpp``) on the CPU.

- Random molecules with y, neg_dy, q, s and partial charges: the port's
  native path, its numpy path (``pad_molecules``) and the JAX package's
  ``fast_pad_collate`` (numpy and ctypes, no JAX program) give bitwise equal
  arrays, the port's two in the same dtypes.
- ``PaddedLoader`` gives equal batches with ``use_native`` on and off
  (shuffled, bucketed, a ragged last batch, charges carried).
- Without a C++ compiler the engine's build raises, naming
  ``use_native=False``, and so does the loader; it does not fall back.
"""

import numpy as np
import pytest
import torch

from torchmdnet_tpu_torch.data import native_collate
from torchmdnet_tpu_torch.data.batch import pad_molecules
from torchmdnet_tpu_torch.data.loader import PaddedLoader
from torchmdnet_tpu_torch.ops.kernels import build

FIELDS = ("z", "pos", "batch", "atom_mask", "mol_mask", "y", "neg_dy", "q", "s")


def _molecules(seed, count, labels=True, f64=False):
    rng = np.random.default_rng(seed)
    dt = np.float64 if f64 else np.float32
    mols = []
    for _ in range(count):
        n = int(rng.integers(1, 12))
        m = dict(z=rng.integers(1, 100, n), pos=rng.normal(size=(n, 3)).astype(dt),
                 pq=rng.normal(size=n).astype(dt))
        if labels:
            m.update(y=rng.normal(size=(1, 1)).astype(dt), neg_dy=rng.normal(size=(n, 3)).astype(dt),
                     q=np.array([float(rng.integers(-2, 3))]), s=np.array([float(rng.integers(0, 3))]))
        m["partial_charges"] = m["pq"]
        mols.append(m)
    return mols


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        assert a.dtype == b.dtype == np.float32
        return np.array_equal(a.view(np.uint32), b.view(np.uint32))
    return a.shape == b.shape and np.array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("labels,f64", [(True, False), (True, True), (False, False)])
def test_native_equals_numpy_and_jax(labels, f64):
    from torchmdnet_tpu.data.native_collate import fast_pad_collate as jax_collate

    mols = _molecules(3 + int(f64), 7, labels, f64)
    cap, num_mol = 80, 9
    got = native_collate.fast_pad_collate(mols, cap, num_mol, ("partial_charges",))
    want = pad_molecules(mols, num_atoms=cap, num_mol=num_mol, extra_atom_keys=("partial_charges",))
    jax_out = jax_collate(mols, cap, num_mol)
    assert jax_out is not None
    for key in FIELDS:
        w = getattr(want, key)
        if w is None:
            assert got[key] is None and jax_out[key] is None, key
            continue
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        assert torch.equal(got[key], w) and _same_bits(got[key], w), key
        assert _same_bits(got[key], jax_out[key]), key
    assert torch.equal(got["pq"], want.extra["partial_charges"]) and _same_bits(got["pq"], jax_out["pq"])


def test_native_capacity_raises_as_numpy():
    mols = _molecules(5, 4)
    need = sum(len(m["z"]) for m in mols)
    for call in (lambda: native_collate.fast_pad_collate(mols, need - 1, 4),
                 lambda: pad_molecules(mols, num_atoms=need - 1, num_mol=4)):
        with pytest.raises(ValueError, match="capacity"):
            call()


class _Molecules:
    def __init__(self, mols):
        self.mols = mols

    def __len__(self):
        return len(self.mols)

    def __getitem__(self, i):
        return {k: v for k, v in self.mols[i].items() if k != "partial_charges"}

    def sample_sizes(self):
        return [len(m["z"]) for m in self.mols]


@pytest.mark.parametrize("buckets", [1, 3])
def test_loader_native_on_and_off(buckets):
    ds = _Molecules(_molecules(7, 23))
    kw = dict(batch_size=5, shuffle=True, seed=2, extra_atom_keys=("partial_charges",), num_buckets=buckets)
    fast, slow = PaddedLoader(ds, use_native=True, **kw), PaddedLoader(ds, use_native=False, **kw)
    assert fast._native() and not slow._native()
    assert not PaddedLoader(ds, **kw)._native()  # numpy unless asked
    n = 0
    for a, b in zip(fast, slow):
        n += 1
        assert a.num_mol == b.num_mol and a.extra.keys() == b.extra.keys() == {"partial_charges"}
        for key in FIELDS:
            x, y = getattr(a, key), getattr(b, key)
            assert x.dtype == y.dtype and torch.equal(x, y), key
        assert torch.equal(a.extra["partial_charges"], b.extra["partial_charges"])
    assert n == len(fast) == len(slow) == (5 if buckets == 1 else 6)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(native_collate, "_LIB", None)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="use_native=False"):
        native_collate.load_library()
    loader = PaddedLoader(_Molecules(_molecules(1, 4)), batch_size=2, use_native=True)
    with pytest.raises(RuntimeError, match="use_native=False"):
        next(iter(loader))
    assert not list(tmp_path.glob("*.so"))


def test_a_short_field_raises_as_numpy():
    mols = _molecules(9, 3)
    mols[1]["partial_charges"] = mols[1]["partial_charges"][:-1]
    for call in (lambda: native_collate.fast_pad_collate(mols, 64, 3, ("partial_charges",)),
                 lambda: pad_molecules(mols, num_atoms=64, num_mol=3, extra_atom_keys=("partial_charges",))):
        with pytest.raises(ValueError):
            call()
