"""The port's ZBL, Coulomb and D2 priors, and the partial charges that reach
Coulomb from a dataset, held against the JAX package on the CPU.

- Each prior's per-molecule energy and -dE/dpos against JAX's on a padded
  batch (an empty molecule slot, padding atoms), f64 at rtol 1e-10 and f32
  at rtol 1e-5: the same formulas, only the order of sums differs.
- The closed forms of tests/test_priors.py (rtol 1e-4, their rounded
  constants).
- Each prior's neighbor capacity checked by ``External``, ``md.Simulation``
  and the ``Trainer``; Coulomb without charges raising.
- ``create_prior_models`` taking a dataset's defaults, and the prior
  arguments through a checkpoint and ``load_model``; prior indices through
  ``state_dict_from_jax``.
- ``pq`` through ``pad_molecules``, the loader and the ``DataModule`` into
  ``batch.extra["partial_charges"]``, and through ``spatial_sort`` and
  ``.to``, bitwise as JAX carries it; a Trainer under the fused flags (which
  sort each batch in space) handing Coulomb the charges of the atoms it
  sorted.
- The infinite-cutoff cell list bitwise JAX's, the pair priors' lists at
  the smoke's training batch sizes, and ``External`` sizing ZBL's cell list
  at DHFR size.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu import priors as jax_priors
from torchmdnet_tpu.data import datasets as jds
from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules
from torchmdnet_tpu.data.batch import spatial_sort as jax_spatial_sort
from torchmdnet_tpu.data.loader import PaddedLoader as JaxLoader
from torchmdnet_tpu.data.module import DataModule as JaxDataModule
from torchmdnet_tpu.models.potential import create_model as jax_create_model
from torchmdnet_tpu.models.potential import create_prior_models as jax_create_prior_models
from torchmdnet_tpu.ops.neighbors import neighbor_list as jax_neighbor_list
from torchmdnet_tpu_torch import External, create_model, state_dict_from_jax
from torchmdnet_tpu_torch import priors
from torchmdnet_tpu_torch.data import datasets as pds
from torchmdnet_tpu_torch.data.batch import pad_molecules, spatial_sort
from torchmdnet_tpu_torch.data.loader import PaddedLoader
from torchmdnet_tpu_torch.data.module import DataModule
from torchmdnet_tpu_torch.md import Simulation
from torchmdnet_tpu_torch.models.potential import create_prior_models, load_model
from torchmdnet_tpu_torch.ops.neighbors import neighbor_list
from torchmdnet_tpu_torch.train.checkpoints import save_checkpoint
from torchmdnet_tpu_torch.train.trainer import Trainer

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
EV = 1.602176634e-19
HARTREE = 4.35974e-18
TYPES_Z = (1, 6, 7, 8, 9, 16, 17, 35)  # atom type -> atomic number
PRIOR_KWARGS = {
    "ZBL": dict(cutoff_distance=4.0, max_num_neighbors=16, atomic_number=TYPES_Z, distance_scale=1e-10,
                energy_scale=EV),
    "Coulomb": dict(alpha=1.8, max_num_neighbors=16, distance_scale=1e-10, energy_scale=EV),
    "D2": dict(cutoff_distance=10.0, max_num_neighbors=16, atomic_number=TYPES_Z, distance_scale=1e-10,
               energy_scale=HARTREE),
}
MODEL = dict(
    model="graph-network", embedding_dimension=16, num_layers=1, num_rbf=4, rbf_type="expnorm",
    trainable_rbf=False, activation="silu", cutoff_lower=0.0, cutoff_upper=3.0, max_z=100,
    max_num_neighbors=64, derivative=True, output_model="Scalar", prior_model=None, reduce_op="add",
    atom_filter=-1, aggr="add", neighbor_embedding=False,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def _mols(sizes=(14, 11, 9), seed=0):
    """Molecules of atom types 0-7 in a 6 A box, with energies, forces and
    partial charges of zero net charge."""
    rng = np.random.default_rng(seed)
    mols = []
    for n in sizes:
        pq = rng.normal(scale=0.3, size=n)
        mols.append(dict(z=rng.integers(0, len(TYPES_Z), n).astype(np.int64),
                         pos=rng.uniform(0.0, 6.0, (n, 3)).astype(np.float32),
                         y=rng.normal(size=1).astype(np.float32),
                         neg_dy=rng.normal(size=(n, 3)).astype(np.float32),
                         pq=(pq - pq.mean()).astype(np.float32)))
    return mols


def _charged(mols):
    return [dict(m, partial_charges=m["pq"]) for m in mols]


# --- each prior against JAX's --------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_priors(precision):
    """Every JAX prior's (energies, forces) on the padded batch, from one
    compiled program."""
    fdt = np.float64 if precision == 64 else np.float32
    b = jax_pad_molecules(_charged(_mols()), num_atoms=40, num_mol=4, extra_atom_keys=("partial_charges",),
                          float_dtype=fdt)
    mods = {name: getattr(jax_priors, name)(**kw) for name, kw in PRIOR_KWARGS.items()}
    y0 = jnp.zeros((4, 1), fdt)

    def fn(pos):
        out = {}
        for name, mod in mods.items():
            def energy(pos):
                return mod.apply({}, y0, b.z, pos, b.batch, b.atom_mask, 4, b.extra, method=mod.post_reduce)

            y, vjp = jax.vjp(energy, pos)
            out[name] = (y, -vjp(jnp.ones_like(y))[0])
        return out

    return _compile(fn, b.pos)(b.pos)


@pytest.mark.parametrize("precision", [64, 32])
@pytest.mark.parametrize("name", list(PRIOR_KWARGS))
def test_prior_matches_jax(name, precision):
    y_ref, f_ref = _jax_priors(precision)[name]
    fdt = np.float64 if precision == 64 else np.float32
    b = pad_molecules(_charged(_mols()), num_atoms=40, num_mol=4, extra_atom_keys=("partial_charges",),
                      float_dtype=fdt)
    prior = priors.prior_class_mapping[name](**PRIOR_KWARGS[name]).to(b.pos.dtype)
    pos = b.pos.clone().requires_grad_(True)
    y = prior.post_reduce(torch.zeros((4, 1), dtype=pos.dtype), b.z, pos, b.batch, b.atom_mask, 4, b.extra)
    (grad,) = torch.autograd.grad(y.sum(), pos)
    tol = 1e-10 if precision == 64 else 1e-5
    assert np.all(np.asarray(y_ref)[:3] != 0) and np.asarray(y_ref)[3] == 0  # the empty slot adds nothing
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=tol, atol=0)
    scale = np.abs(np.asarray(f_ref)).max()
    np.testing.assert_allclose(-grad.numpy(), np.asarray(f_ref), rtol=tol, atol=tol * scale)


def _closed_form(name):
    """(prior, pos, types, extra, expected energy): tests/test_priors.py's
    three systems and their closed forms."""
    if name == "ZBL":  # positions in Bohr, energies in kJ/mol
        pos = np.array([[1.0, 0.0, 0.0], [2.5, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, -1.0]])
        types, zmap = [0, 1, 2, 1], (1, 6, 8)
        prior = priors.ZBL(cutoff_distance=10.0, max_num_neighbors=5, atomic_number=zmap,
                           distance_scale=5.29177210903e-11, energy_scale=1000.0 / 6.02214076e23)

        def pair(i, j):
            r = np.linalg.norm(pos[i] - pos[j])
            z1, z2 = zmap[types[i]], zmap[types[j]]
            x = r / (0.8854 / (z1 ** 0.23 + z2 ** 0.23))
            phi = (0.1818 * np.exp(-3.2 * x) + 0.5099 * np.exp(-0.9423 * x) + 0.2802 * np.exp(-0.4029 * x)
                   + 0.02817 * np.exp(-0.2016 * x))
            return 0.5 * (np.cos(r * np.pi / 10.0) + 1.0) * phi * (138.935 / 5.29177210903e-2) * z1 * z2 / r

        return prior, pos, types, None, pair
    if name == "Coulomb":  # positions in nm, energies in kJ/mol
        pos = np.array([[0.5, 0.0, 0.0], [1.5, 0.0, 0.0], [0.8, 0.8, 0.0], [0.0, 0.0, -0.4]])
        charge = np.array([0.2, -0.1, 0.8, -0.9])
        prior = priors.Coulomb(alpha=1.8, max_num_neighbors=5, distance_scale=1e-9,
                               energy_scale=1000.0 / 6.02214076e23)

        def pair(i, j):
            r = np.linalg.norm(pos[i] - pos[j])
            return math.erf(1.8 * r) * 138.935 * charge[i] * charge[j] / r

        return prior, pos, [0, 1, 2, 1], {"partial_charges": torch.tensor(charge, dtype=torch.float32)}, pair
    # D2: positions in Angstrom, energies in Hartree
    pos = np.array([[0.0, 0.0, 0.0], [1.2, 0.0, 0.0], [0.0, 1.5, 0.3]])
    types, zmap = [0, 1, 1], (6, 1, 8)
    prior = priors.D2(cutoff_distance=10.0, max_num_neighbors=5, atomic_number=zmap, distance_scale=1e-10,
                      energy_scale=HARTREE)
    table = priors.d2._C6_RR

    def pair(i, j):
        zi, zj = zmap[types[i]], zmap[types[j]]
        r_nm = np.linalg.norm(pos[i] - pos[j]) * 0.1
        c6 = np.sqrt(table[zi, 0] * table[zj, 0])
        fd = 1.0 / (1.0 + np.exp(-20.0 * (r_nm / (table[zi, 1] + table[zj, 1]) - 1.0)))
        return -c6 / r_nm ** 6 * fd / (HARTREE * 6.02214076e23)

    return prior, pos, types, None, pair


@pytest.mark.parametrize("name", ["ZBL", "Coulomb", "D2"])
def test_closed_form(name):
    prior, pos, types, extra, pair = _closed_form(name)
    n = len(types)
    y = prior.post_reduce(torch.zeros((1, 1)), torch.tensor(types), torch.tensor(pos, dtype=torch.float32),
                          torch.zeros(n, dtype=torch.int64), torch.ones(n, dtype=torch.bool), 1, extra)
    expected = sum(pair(i, j) for i in range(n) for j in range(i))
    np.testing.assert_allclose(float(y[0, 0]), expected, rtol=1e-4)


# --- capacity checks and configuration ------------------------------------


def _dense_system():
    """64 atoms in a 6 A cube: every atom has 63 neighbors within D2's
    10 A cutoff, far above a capacity of 16."""
    rng = np.random.default_rng(3)
    return np.ones(64, dtype=np.int64), rng.uniform(-3.0, 3.0, (64, 3)).astype(np.float32)


@pytest.mark.parametrize("entry", ["External", "Simulation", "Trainer"])
def test_prior_capacity_is_checked(entry, tmp_path):
    prior = priors.D2(max_num_neighbors=16, atomic_number=tuple(range(100)))
    if entry == "Trainer":
        h = dict(MODEL, dataset="DummyDataset", dataset_arg={"num_samples": 8, "num_atoms": 20},
                 dataset_root=str(tmp_path), batch_size=4, num_epochs=1, log_dir=str(tmp_path), seed=1,
                 train_size=4, val_size=2, test_size=2, lr=1e-3, num_workers=0, derivative=False,
                 device="cpu")
        data = DataModule(h)
        data.setup()
        prior = priors.D2(max_num_neighbors=2, atomic_number=tuple(range(100)))
        run = functools.partial(Trainer(create_model(h, [prior], device="cpu"), h).fit, data)
    else:
        z, pos = _dense_system()
        model = create_model(MODEL, [prior], device="cpu")
        if entry == "External":
            run = functools.partial(External((model, None), z[None], device="cpu").calculate, pos)
        else:
            batch = pad_molecules([{"z": z, "pos": pos}], num_atoms=64)
            run = functools.partial(Simulation, model, batch, device="cpu")
    with pytest.raises(ValueError, match="Neighbor capacity exceeded in the D2 prior"):
        run()


def test_coulomb_without_charges_raises():
    z, pos = _dense_system()
    model = create_model(dict(MODEL, prior_model={"Coulomb": {"max_num_neighbors": 64}}), device="cpu")
    with pytest.raises(ValueError, match="partial charges"):
        model.energy(pad_molecules([{"z": z, "pos": pos}], num_atoms=64))
    with pytest.raises(ValueError, match="partial charges"):
        External((model, None), z[None], device="cpu").calculate(pos)


class _PriorDataset:
    atomic_number = list(range(100))
    distance_scale = 1e-10
    energy_scale = EV

    def get_atomref(self):
        return np.linspace(-1.0, 1.0, 100).reshape(-1, 1)


PRIOR_MODEL = [{"ZBL": {"cutoff_distance": 4.0, "max_num_neighbors": 16}}, {"D2": {"energy_scale": 2.0}},
               "Coulomb", "Atomref"]


def _init_args(prior):
    return {k: list(v) if isinstance(v, tuple) else v for k, v in prior.get_init_args().items()}


def test_create_prior_models_takes_dataset_defaults():
    got = create_prior_models({"prior_model": PRIOR_MODEL}, _PriorDataset())
    assert [type(p).__name__ for p in got] == ["ZBL", "D2", "Coulomb", "Atomref"]
    assert got[0].atomic_number == tuple(range(100)) and got[0].energy_scale == EV
    assert got[1].energy_scale == 2.0 and got[1].distance_scale == 1e-10  # the named kwarg wins
    assert got[2].energy_scale == EV
    np.testing.assert_array_equal(got[3].atomref.detach().numpy().ravel(),
                                  _PriorDataset().get_atomref().ravel().astype(np.float32))
    # JAX's parser gives the same arguments to the priors whose constructor
    # takes them all (its Coulomb takes no atomic_number and raises)
    want = jax_create_prior_models({"prior_model": [PRIOR_MODEL[i] for i in (0, 1, 3)]}, _PriorDataset())
    assert [_init_args(p) for p in want] == [_init_args(got[i]) for i in (0, 1, 3)]
    with pytest.raises(TypeError, match="atomic_number"):
        jax_create_prior_models({"prior_model": ["Coulomb"]}, _PriorDataset())


def test_prior_args_round_trip_through_a_checkpoint(tmp_path):
    prior_models = create_prior_models({"prior_model": PRIOR_MODEL}, _PriorDataset())
    prior_models[1].d = 15.0  # not among D2's init args, as in JAX: a checkpoint restores 20
    h = dict(MODEL, prior_model=PRIOR_MODEL, prior_args=[p.get_init_args() for p in prior_models])
    model = create_model(h, prior_models, device="cpu")
    path = str(tmp_path / "model.ckpt")
    save_checkpoint(path, model.module.state_dict(), h)
    reloaded = load_model(path, device="cpu")
    assert [_init_args(p) for p in reloaded.module.priors] == [_init_args(p) for p in prior_models]
    assert reloaded.module.priors[1].d == 20.0
    # atom types 1-8 are atomic numbers here (D2's table has no Z = 0)
    mols = [dict(m, z=m["z"] + 1) for m in _charged(_mols())]
    b = pad_molecules(mols, num_atoms=40, num_mol=4, extra_atom_keys=("partial_charges",))
    prior_models[1].d = 20.0
    assert torch.isfinite(model.energy(b)).all()
    torch.testing.assert_close(reloaded.energy(b), model.energy(b), rtol=0, atol=0)


def test_state_dict_from_jax_keeps_prior_indices():
    """Only Atomref has parameters: after a pair prior its table is
    priors_1 in JAX and priors.1.atomref in the port."""
    args = dict(MODEL, trainable_rbf=True, prior_model=PRIOR_MODEL[:1] + PRIOR_MODEL[3:])
    jb = jax_pad_molecules(_mols(), num_atoms=40, num_mol=4)
    jm = jax_create_model(args, jax_create_prior_models(args, _PriorDataset()))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb)
    assert "priors_1" in shapes["params"] and "priors_0" not in shapes["params"]
    params = jax.tree_util.tree_map(lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    sd = state_dict_from_jax(args, params)
    model = create_model(args, create_prior_models(args, _PriorDataset()), device="cpu")
    model.module.load_state_dict(sd)
    assert torch.all(model.module.priors[1].atomref == 0.5)


# --- partial charges from the dataset to the prior ------------------------


def _arrays(package, mols):
    """An InMemoryArrays dataset of ``mols`` in ``package`` (jds or pds)."""
    sizes = [len(m["z"]) for m in mols]
    cat = {k: np.concatenate([m[k] for m in mols]) for k in ("z", "pos", "neg_dy", "pq")}
    return package.base.InMemoryArrays(cat["z"], cat["pos"], np.concatenate([[0], np.cumsum(sizes)]),
                                  y=np.stack([m["y"] for m in mols]), neg_dy=cat["neg_dy"], pq=cat["pq"])


def _assert_batches_equal(got, want):
    for name in ("z", "pos", "batch", "atom_mask", "mol_mask", "y", "neg_dy"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert got.num_mol == want.num_mol and sorted(got.extra) == sorted(want.extra) == ["partial_charges"]
    a, b = got.extra["partial_charges"].numpy(), np.asarray(want.extra["partial_charges"])
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stage", ["pad_molecules", "loader", "DataModule"])
def test_partial_charges_collate_as_jax(stage, tmp_path):
    mols = _mols(sizes=tuple(np.random.default_rng(1).integers(3, 12, 13)), seed=2)
    if stage == "pad_molecules":
        kw = dict(num_atoms=120, num_mol=14, extra_atom_keys=("partial_charges",))
        pairs = [(pad_molecules(_charged(mols), **kw), jax_pad_molecules(_charged(mols), **kw))]
    elif stage == "loader":
        kw = dict(batch_size=4, shuffle=True, seed=3, extra_atom_keys=("partial_charges",))
        pairs = zip(PaddedLoader(_arrays(pds, mols), **kw), JaxLoader(_arrays(jds, mols), **kw))
    else:
        h = dict(batch_size=4, inference_batch_size=4, seed=2, train_size=9, val_size=2, test_size=2,
                 log_dir=str(tmp_path))
        got, want = DataModule(dict(h, device="cpu"), _arrays(pds, mols)), JaxDataModule(h, _arrays(jds, mols))
        got.setup()
        want.setup()
        pairs = zip(got.train_dataloader(), want.train_dataloader())
    n = 0
    for a, b in pairs:
        _assert_batches_equal(a, b)
        n += 1
    assert n >= 1


def test_spatial_sort_and_to_carry_extra():
    kw = dict(num_atoms=40, num_mol=4, extra_atom_keys=("partial_charges",))
    got, order = spatial_sort(pad_molecules(_charged(_mols()), **kw), cell=2.0)
    want, jorder = jax_spatial_sort(jax_pad_molecules(_charged(_mols()), **kw), cell=2.0)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    assert not np.array_equal(order.numpy(), np.arange(40))
    _assert_batches_equal(got, want)
    moved = got.to("meta")
    assert moved.extra["partial_charges"].device.type == "meta" and moved.pos.device.type == "meta"


def test_trainer_hands_coulomb_the_sorted_charges(tmp_path):
    """Under the fused flags the Trainer sorts each batch in space; the
    charges Coulomb receives must belong to the atoms at the positions it
    receives."""
    mols = _mols(sizes=(9, 8, 7, 9), seed=4)
    ds = _arrays(pds, mols)
    charge_at = {tuple(p): q for m in mols for p, q in zip(m["pos"], m["pq"])}
    h = dict(MODEL, model="equivariant-transformer", num_heads=2, attn_activation="silu",
             distance_influence="both", bf16_messages=True, fused_attention=True,
             prior_model={"Coulomb": {"max_num_neighbors": 16}}, batch_size=2, inference_batch_size=2,
             num_epochs=1, log_dir=str(tmp_path), seed=1, train_size=2, val_size=2, test_size=0, lr=1e-4,
             num_workers=0, device="cpu")
    data = DataModule(h, ds)
    data.setup()
    model = create_model(h, create_prior_models(h, data.dataset), device="cpu")
    coulomb = model.module.priors[0]
    seen = []
    post_reduce = coulomb.post_reduce

    def recording(y, z, pos, batch_ids, atom_mask, num_mol, extra=None):
        seen.append((pos.detach().numpy().copy(), atom_mask.numpy().copy(),
                     extra["partial_charges"].numpy().copy()))
        return post_reduce(y, z, pos, batch_ids, atom_mask, num_mol, extra)

    coulomb.post_reduce = recording
    Trainer(model, h).fit(data)
    assert seen
    permuted = 0
    for pos, mask, pq in seen:
        got = pq[mask]
        want = np.array([charge_at[tuple(p)] for p in pos[mask]], dtype=np.float32)
        np.testing.assert_array_equal(got, want)
        permuted += not np.array_equal(got, np.concatenate([m["pq"] for m in mols])[: len(got)])
    assert permuted  # the sort moved charges along with their atoms


# --- neighbor lists --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_inf_cell_list():
    pos, ids, mask = (jnp.asarray(a) for a in _inf_cutoff_system(70))
    return _compile(functools.partial(jax_neighbor_list, k=32, cutoff_upper=jnp.inf, strategy="cell"),
                    pos, ids, mask)


def _inf_cutoff_system(real):
    """70 atom rows in 3 molecules, the first ``real`` of them real."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 6, (70, 3)).astype(np.float32)
    mask = np.arange(70) < real
    ids = np.where(mask, np.sort(rng.integers(0, 3, 70)), 3).astype(np.int32)
    return pos, ids, mask


@pytest.mark.parametrize("real", [20, 68])
def test_infinite_cutoff_cell_list_as_jax(real):
    """Every atom falls in one cell: the list is right (equal to brute)
    while the cell holds the batch's atoms, and flags cell_overflow beyond;
    the port's is bitwise JAX's in both cases."""
    pos, ids, mask = _inf_cutoff_system(real)
    want = _jax_inf_cell_list()(pos, ids, mask)
    args = (torch.as_tensor(pos), torch.as_tensor(ids).long(), torch.as_tensor(mask))
    got = neighbor_list(*args, k=32, cutoff_upper=float("inf"), strategy="cell")
    for name in ("idx", "mask", "n_neighbors", "cell_overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    brute = neighbor_list(*args, k=32, cutoff_upper=float("inf"), strategy="brute")
    assert bool(got.cell_overflow) == (real == 68)
    if real == 20:
        assert torch.equal(got.idx, brute.idx) and torch.equal(got.mask, brute.mask)


def test_pair_prior_lists_at_the_training_batch_sizes():
    """SyntheticMorse puts every molecule in one 6 A box: at 128 molecules
    of 18 atoms (2304 atoms) a prior's own list takes the cell route with
    the default cell sizes and overflows its cells, in JAX as in the port;
    at 64 (1152 atoms) it takes the brute route and holds."""
    ds = jds.SyntheticMorse(None, num_samples=128, num_atoms=18, cell=6.0, seed=0)
    zbl = dict(cutoff_distance=4.0, max_num_neighbors=32, atomic_number=tuple(range(100)))
    jzbl, pzbl = jax_priors.ZBL(**zbl), priors.ZBL(**zbl)
    for molecules, cell_route in ((128, True), (64, False)):
        mols = [ds[i] for i in range(molecules)]
        jb = jax_pad_molecules(mols, num_atoms=18 * molecules)
        pb = pad_molecules(mols, num_atoms=18 * molecules)
        want = _compile(jzbl.build_neighbor_list, jb.pos, jb.batch, jb.atom_mask)(jb.pos, jb.batch, jb.atom_mask)
        got = pzbl.build_neighbor_list(pb.pos, pb.batch, pb.atom_mask)
        assert (got.cell_overflow is not None) == cell_route == (want.cell_overflow is not None)
        if cell_route:
            assert bool(got.cell_overflow) and bool(want.cell_overflow)
            with pytest.raises(ValueError, match="Cell-list capacity exceeded"):
                pzbl.check_neighbor_capacity(pb)
        else:
            np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
            pzbl.check_neighbor_capacity(pb)


def test_external_sizes_a_prior_cell_list():
    """ZBL's 4 A list at DHFR size overflows the cell list's default sizes
    (the JAX package's, which its External keeps); the port's External sizes
    it from the first request, as it sizes the model's, and the list is then
    the brute search's."""
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS, synthetic_system

    z, pos = synthetic_system(DHFR_ATOMS, seed=0)
    kwargs = dict(cutoff_distance=4.0, max_num_neighbors=48, atomic_number=tuple(range(100)))
    batch = pad_molecules([{"z": z, "pos": pos}], num_atoms=2496)
    defaults = priors.ZBL(**kwargs).build_neighbor_list(batch.pos, batch.batch, batch.atom_mask)
    assert bool(defaults.cell_overflow) and not bool(defaults.overflow())
    model = create_model(dict(MODEL, max_num_neighbors=32), [priors.ZBL(**kwargs)], device="cpu")
    External((model, None), z[None], device="cpu").calculate(pos)  # its checks pass
    prior = model.module.priors[0]
    assert set(prior.cell_kwargs) == {"cell_capacity", "max_cells"}
    got = prior.build_neighbor_list(batch.pos, batch.batch, batch.atom_mask)
    brute = neighbor_list(batch.pos, batch.batch, batch.atom_mask, k=48, cutoff_upper=4.0, strategy="brute")
    assert not bool(got.cell_overflow)
    assert torch.equal(got.n_neighbors, brute.n_neighbors) and torch.equal(got.mask, brute.mask)
