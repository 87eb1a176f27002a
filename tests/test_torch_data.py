"""The port's data pipeline held against the JAX package's, on the CPU.

Splits index for index, the in-repo datasets' arrays, the registry's names,
and the loader's batches bitwise (z, pos, y, neg_dy, batch ids, masks; flat
and bucketed, shuffled, with and without drop_last), the standardize mean
and std, and the Atomref prior's per-atom energies.
"""

import jax
import numpy as np
import pytest
import torch

from torchmdnet_tpu.data import datasets as jds
from torchmdnet_tpu.data.loader import PaddedLoader as JaxLoader
from torchmdnet_tpu.data.module import DataModule as JaxDataModule
from torchmdnet_tpu.priors.atomref import Atomref as JaxAtomref
from torchmdnet_tpu.utils import make_splits as jax_make_splits
from torchmdnet_tpu_torch.data import datasets as pds
from torchmdnet_tpu_torch.data.loader import PaddedLoader
from torchmdnet_tpu_torch.data.module import DataModule
from torchmdnet_tpu_torch.priors import Atomref
from torchmdnet_tpu_torch.utils import make_splits, number

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("sizes", [(0.8, 0.1, 0.1), (20, 5, None), (None, 0.25, 7), (30, 10, 10)])
def test_splits_equal_jax(sizes, tmp_path):
    got = make_splits(57, *sizes, seed=3, filename=str(tmp_path / "p.npz"))
    want = jax_make_splits(57, *sizes, seed=3, filename=str(tmp_path / "j.npz"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # a splits file is read back as written
    for a, b in zip(make_splits(57, None, None, None, 0, splits=str(tmp_path / "j.npz")), want):
        np.testing.assert_array_equal(a, b)
    assert number("3") == 3 and number("0.5") == 0.5 and number("None") is None


@pytest.mark.parametrize("name,kwargs", [
    ("DummyDataset", dict(num_samples=7, num_atoms=5, has_atomref=True, seed=4)),
    ("SyntheticMorse", dict(num_samples=6, num_atoms=9, cell=5.0, seed=2)),
])
def test_datasets_bitwise_equal_jax(name, kwargs):
    got = getattr(pds, name)(None, **kwargs)
    want = getattr(jds, name)(None, **kwargs)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.sample_sizes(), want.sample_sizes())
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    if want.get_atomref() is not None:
        np.testing.assert_array_equal(got.get_atomref(), want.get_atomref())


def test_datasets_still_to_port_raise():
    """No registry name raises any more: each is a real dataset class of the
    JAX registry's name, and ``__all__`` is the JAX registry's."""
    assert pds.__all__ == jds.__all__
    for name in pds.__all__:
        cls = getattr(pds, name)
        assert isinstance(cls, type) and issubclass(cls, pds.MolecularDataset), name
        assert cls.__name__ == getattr(jds, name).__name__


class _Ragged:
    """Molecules of 3-11 atoms with energies and forces, for both packages."""

    def __init__(self, n=37, seed=5):
        rng = np.random.default_rng(seed)
        self.sizes = rng.integers(3, 12, n)
        self.mols = [dict(z=rng.integers(1, 9, s).astype(np.int64),
                          pos=rng.normal(size=(s, 3)).astype(np.float32),
                          y=rng.normal(size=(1,)).astype(np.float32),
                          neg_dy=rng.normal(size=(s, 3)).astype(np.float32)) for s in self.sizes]

    def __len__(self):
        return len(self.mols)

    def __getitem__(self, i):
        return {k: v.copy() for k, v in self.mols[i].items()}

    def sample_sizes(self):
        return self.sizes


@pytest.mark.parametrize("buckets,drop_last", [(1, False), (1, True), (3, False)])
def test_loader_batches_bitwise_equal_jax(buckets, drop_last):
    ds = _Ragged()
    kw = dict(batch_size=4, shuffle=True, seed=9, drop_last=drop_last, num_buckets=buckets)
    port, ref = PaddedLoader(ds, **kw), JaxLoader(ds, **kw)
    assert len(port) == len(ref) and port.num_atoms_pad == ref.num_atoms_pad
    for _ in range(2):  # two epochs: the shuffle order moves on with the epoch
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(ref)
        for a, b in zip(got, want):
            assert a.num_mol == b.num_mol
            for key in ("z", "pos", "batch", "atom_mask", "mol_mask", "y", "neg_dy"):
                np.testing.assert_array_equal(getattr(a, key).numpy(), np.asarray(getattr(b, key)), err_msg=key)


def test_spatial_sort_moves_force_labels_with_their_atoms():
    from torchmdnet_tpu.data.batch import spatial_sort as jax_spatial_sort
    from torchmdnet_tpu_torch.data.batch import pad_molecules, spatial_sort

    ds = _Ragged(n=6, seed=2)
    mols = [ds[i] for i in range(6)]
    batch = pad_molecules(mols, num_atoms=72, num_mol=6)
    got, order = spatial_sort(batch, cell=1.0)
    want, jorder = jax_spatial_sort(JaxLoader(ds, batch_size=6)._collate(mols, 72), cell=1.0)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    for key in ("z", "pos", "batch", "neg_dy", "y"):
        np.testing.assert_array_equal(getattr(got, key).numpy(), np.asarray(getattr(want, key)), err_msg=key)
    torch.testing.assert_close(got.neg_dy, batch.neg_dy[order], rtol=0, atol=0)


def test_standardize_and_atomref_equal_jax(tmp_path):
    h = dict(train_size=12, val_size=4, test_size=4, seed=1, batch_size=4, standardize=True,
             prior_model="Atomref", log_dir=str(tmp_path), device="cpu")
    kw = dict(num_samples=20, num_atoms=5, has_atomref=True)
    port, ref = DataModule(h, dataset=pds.DummyDataset(**kw)), JaxDataModule(h, dataset=jds.DummyDataset(**kw))
    port.setup()
    ref.setup()
    assert port.num_atoms_pad == ref.num_atoms_pad
    assert port.mean == ref.mean and port.std == ref.std
    # the prior's per-atom energies: x + atomref[z]
    pa, ja = Atomref.from_dataset(port.dataset), JaxAtomref.from_dataset(ref.dataset)
    z = np.random.default_rng(0).integers(0, 100, 40)
    x = np.random.default_rng(1).normal(size=(40, 1)).astype(np.float32)
    params = ja.init(jax.random.PRNGKey(0), x, z, None, None, None, method=ja.pre_reduce)
    want = ja.apply(params, x, z, None, None, None, method=ja.pre_reduce)
    got = pa.pre_reduce(torch.as_tensor(x), torch.as_tensor(z), None, None, None)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert pa.get_init_args() == ja.get_init_args()


def test_data_module_never_falls_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to fall back from")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataModule(dict(batch_size=4, log_dir=str(tmp_path)))
    dm = DataModule(dict(batch_size=4, train_size=4, val_size=2, test_size=2, log_dir=str(tmp_path),
                         device="cpu"), dataset=pds.DummyDataset(num_samples=8, num_atoms=3))
    dm.setup()
    assert next(iter(dm.train_dataloader())).pos.device.type == "cpu"
