"""The port's dataset readers held against the JAX package's, on the CPU.

Each reader gets small files written in its real format (3-11 atoms, a few
conformers), one copy for each package, since the readers that process
their raw files write ``processed/`` beside them and reuse it.  The port's
dataset must equal JAX's: ``len``, ``sample_sizes``, the keys, the dtypes and
the values of every sample bitwise, and ``get_atomref`` where there is one.
Also: the error paths, processed files reused on reopen, the loader's
batches for the datasets with charges, and ``DataModule``'s ``Custom``
branch.  numpy, h5py and torch only; no JAX program runs.
"""

import ast
import io
import os
import tarfile

import h5py
import numpy as np
import pytest
import torch

from torchmdnet_tpu.data import datasets as jds
from torchmdnet_tpu.data.loader import PaddedLoader as JaxLoader
from torchmdnet_tpu_torch.data import datasets as pds
from torchmdnet_tpu_torch.data.datasets import mmap_base
from torchmdnet_tpu_torch.data.loader import PaddedLoader
from torchmdnet_tpu_torch.data.module import DataModule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _roots(tmp_path, write, seed=0):
    """The same files written twice, under tmp_path/port and tmp_path/jax."""
    roots = []
    for name in ("port", "jax"):
        root = tmp_path / name
        root.mkdir()
        write(str(root), np.random.default_rng(seed))
        roots.append(str(root))
    return roots


def assert_same_dataset(got, want):
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.sample_sizes(), want.sample_sizes())
    assert got.sample_sizes().dtype == want.sample_sizes().dtype
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b), i
        for key in b:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, (i, key)
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"sample {i}, {key}")
    ref_a, ref_b = got.get_atomref(), want.get_atomref()
    assert (ref_a is None) == (ref_b is None)
    if ref_b is not None:
        assert ref_a.dtype == ref_b.dtype
        np.testing.assert_array_equal(ref_a, ref_b)
    for name in ("atomic_number", "distance_scale", "energy_scale"):
        assert getattr(got, name, None) == getattr(want, name, None), name


def _mol_sizes(rng, n):
    return [int(s) for s in rng.integers(3, 12, n)]


# --- Custom ------------------------------------------------------------------


def _write_custom(root, rng, energy=True, forces=True):
    for i, n_atoms in enumerate(_mol_sizes(rng, 3)):
        frames = int(rng.integers(2, 5))
        np.save(os.path.join(root, f"coords_{i}.npy"), rng.normal(size=(frames, n_atoms, 3)))
        np.save(os.path.join(root, f"embed_{i}.npy"), rng.integers(1, 10, n_atoms))
        if energy:
            np.save(os.path.join(root, f"energy_{i}.npy"), rng.normal(size=(frames, 1)))
        if forces:
            np.save(os.path.join(root, f"force_{i}.npy"), rng.normal(size=(frames, n_atoms, 3)).astype(np.float32))


def _custom_globs(root, energy=True, forces=True):
    return dict(coordglob=os.path.join(root, "coords*"), embedglob=os.path.join(root, "embed*"),
                energyglob=os.path.join(root, "energy*") if energy else None,
                forceglob=os.path.join(root, "force*") if forces else None)


@pytest.mark.parametrize("energy,forces", [(True, True), (True, False), (False, True)])
def test_custom(tmp_path, energy, forces):
    port_root, jax_root = _roots(tmp_path, lambda r, rng: _write_custom(r, rng, energy, forces))
    assert_same_dataset(pds.Custom(**_custom_globs(port_root, energy, forces)),
                        jds.Custom(**_custom_globs(jax_root, energy, forces)))


def test_custom_needs_a_target():
    with pytest.raises(AssertionError, match="must be specified as the target"):
        pds.Custom(coordglob="*", embedglob="*")


def test_datamodule_takes_the_custom_branch(tmp_path):
    _write_custom(str(tmp_path), np.random.default_rng(3))
    globs = _custom_globs(str(tmp_path))
    hparams = dict(dataset="Custom", dataset_root=None, coord_files=globs["coordglob"],
                   embed_files=globs["embedglob"], energy_files=globs["energyglob"],
                   force_files=globs["forceglob"], train_size=4, val_size=2, test_size=None, seed=1,
                   batch_size=2, log_dir=str(tmp_path / "logs"), device="cpu")
    data = DataModule(hparams)
    data.setup()
    assert isinstance(data.dataset, pds.Custom) and data.dataset.coordfiles == sorted(
        os.path.join(str(tmp_path), f"coords_{i}.npy") for i in range(3))
    batch = next(iter(data.train_dataloader()))
    assert batch.y.shape == (2, 1) and batch.neg_dy.shape == batch.pos.shape
    assert int(batch.mol_mask.sum()) == 2


# --- MD17 and MD22 -----------------------------------------------------------

ASPIRIN_Z = np.array([6] * 9 + [8] * 4 + [1] * 8)


def _trajectory(rng, frames, z):
    return (rng.normal(size=(frames, len(z), 3)), rng.normal(size=frames) - 400.0,
            rng.normal(size=(frames, len(z), 3)))


def _write_md17(root, rng):
    # the original GDML layout, E as (frames, 1)
    raw = os.path.join(root, "aspirin", "raw")
    os.makedirs(raw)
    pos, e, f = _trajectory(rng, 4, ASPIRIN_Z[:7])
    np.savez(os.path.join(raw, "md17_aspirin.npz"), z=ASPIRIN_Z[:7], R=pos, E=e[:, None], F=f)
    # the revised layout, one archive for every molecule
    raw = os.path.join(root, "raw", "rmd17", "npz_data")
    os.makedirs(raw)
    pos, e, f = _trajectory(rng, 5, ASPIRIN_Z)
    np.savez(os.path.join(raw, "rmd17_aspirin.npz"), nuclear_charges=ASPIRIN_Z, coords=pos, energies=e,
             forces=f, old_indices=np.arange(5), old_energies=e)
    # the CCSD layout: pre-defined train and test splits
    raw = os.path.join(root, "ethanol_CCSD_T", "raw")
    os.makedirs(raw)
    z = np.array([6, 6, 8, 1, 1, 1, 1, 1, 1])
    for split, frames in (("train", 3), ("test", 2)):
        pos, e, f = _trajectory(rng, frames, z)
        np.savez(os.path.join(raw, f"ethanol_ccsd_t-{split}.npz"), z=z, R=pos, E=e[:, None], F=f)


@pytest.mark.parametrize("name,train", [("aspirin", None), ("revised_aspirin", None),
                                        ("ethanol_CCSD_T", True), ("ethanol_CCSD_T", False)])
def test_md17(tmp_path, name, train):
    port_root, jax_root = _roots(tmp_path, _write_md17)
    kw = {} if train is None else {"train": train}
    got = pds.MD17(port_root, molecules=name, **kw)
    assert_same_dataset(got, jds.MD17(jax_root, dataset_arg=name, **kw))
    assert got[0]["y"].dtype == np.float32 and got[0]["neg_dy"].shape == got[0]["pos"].shape


def test_md17_train_flag_and_names(tmp_path):
    _write_md17(str(tmp_path), np.random.default_rng(0))
    root = str(tmp_path)
    with pytest.raises(ValueError, match="pre-defined splits but 'train' was not"):
        pds.MD17(root, molecules="ethanol_CCSD_T")
    with pytest.raises(ValueError, match="does not provide pre-defined splits"):
        pds.MD17(root, molecules="revised_aspirin", train=True)
    with pytest.raises(ValueError, match="Unknown dataset name"):
        pds.MD17(root, molecules="caffeine")
    with pytest.raises(ValueError, match="Unknown dataset name"):
        pds.MD22(root, molecules="caffeine")


def _write_md22(root, rng):
    raw = os.path.join(root, "Ac-Ala3-NHMe", "raw")
    os.makedirs(raw)
    z = rng.choice([1, 6, 7, 8], 11)
    pos, e, f = _trajectory(rng, 3, z)
    np.savez(os.path.join(raw, "md22_Ac-Ala3-NHMe.npz"), z=z, R=pos, E=e[:, None], F=f)


def test_md22(tmp_path):
    port_root, jax_root = _roots(tmp_path, _write_md22)
    assert_same_dataset(pds.MD22(port_root, molecules="Ac-Ala3-NHMe"),
                        jds.MD22(jax_root, dataset_arg="Ac-Ala3-NHMe"))


# --- QM9 ---------------------------------------------------------------------

_QM9_SYMBOLS = {1: "H", 6: "C", 7: "N", 8: "O", 9: "F"}


def _qm9_xyz(rng, index):
    n = int(rng.integers(3, 8))
    z = rng.choice([1, 6, 7, 8, 9], n)
    props = " ".join(f"{v:.6f}" for v in rng.normal(size=15))
    lines = [str(n), f"gdb {index} {props}"]
    for i, zi in enumerate(z):
        x, y, w = rng.normal(size=3)
        # Mathematica's exponent notation appears in the raw files
        xs = f"{x * 1e-6:.4f}*^-6" if i == 0 else f"{x:.10f}"
        lines.append(f"{_QM9_SYMBOLS[int(zi)]}\t{xs}\t{y:.10f}\t{w:.10f}\t{rng.normal():.6f}")
    lines += ["1.0\t2.0\t3.0", "C\tC", "InChI=1S/C/c\tInChI=1S/C/c"]
    return "\n".join(lines) + "\n"


def _write_qm9(root, rng):
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    with tarfile.open(os.path.join(raw, "dsgdb9nsd.xyz.tar.bz2"), "w:bz2") as tar:
        for i in range(1, 8):
            data = _qm9_xyz(rng, i).encode()
            info = tarfile.TarInfo(f"dsgdb9nsd_{i:06d}.xyz")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    header = [f"header line {i}" for i in range(9)]
    rows = ["    3  some  columns", "    6  some  columns"]
    with open(os.path.join(raw, "uncharacterized.txt"), "w") as f:
        f.write("\n".join(header + rows + ["footer"]) + "\n")


@pytest.mark.parametrize("label", ["energy_U0", "dipole_moment", "gap"])
def test_qm9(tmp_path, label):
    port_root, jax_root = _roots(tmp_path, _write_qm9)
    got = pds.QM9(port_root, label=label)
    want = jds.QM9(jax_root, dataset_arg=label)
    assert len(got) == 5  # molecules 3 and 6 are uncharacterized
    assert_same_dataset(got, want)
    assert (got.get_atomref() is None) == (label != "energy_U0")  # atomrefs for targets 6-11
    # the processed archive is reused on reopen, without the raw files
    os.remove(os.path.join(port_root, "raw", "dsgdb9nsd.xyz.tar.bz2"))
    assert_same_dataset(pds.QM9(port_root, label=label), want)


def test_qm9_needs_a_known_label(tmp_path):
    with pytest.raises(AssertionError, match="Available properties"):
        pds.QM9(str(tmp_path), label="charge")


# --- HDF5 --------------------------------------------------------------------


def _write_hdf5(root, rng, forces=True, charges=True):
    paths = []
    for k in range(2):
        path = os.path.join(root, f"part{k}.h5")
        with h5py.File(path, "w") as f:
            for n in _mol_sizes(rng, 2):
                count = int(rng.integers(2, 4))
                g = f.create_group(f"size{n}_{k}")
                g["types"] = np.tile(rng.integers(1, 10, n), (count, 1))
                g["pos"] = rng.normal(size=(count, n, 3)).astype(np.float32)
                g["energy"] = rng.normal(size=count)
                if forces:
                    g["forces"] = rng.normal(size=(count, n, 3)).astype(np.float32)
                if charges:
                    g["partial_charges"] = rng.normal(size=(count, n)).astype(np.float32)
            if k == 0:
                meta = f.create_group("_metadata")
                meta["distance_scale"] = np.array(1e-10)
                meta["energy_scale"] = np.array(1.602176634e-19)
        paths.append(path)
    return ";".join(paths)


@pytest.mark.parametrize("forces,charges", [(True, True), (False, False)])
def test_hdf5(tmp_path, forces, charges):
    names = {}

    def write(root, rng):
        names[root] = _write_hdf5(root, rng, forces, charges)

    port_root, jax_root = _roots(tmp_path, write)
    got = pds.HDF5(names[port_root])
    assert got.index is None  # the files open at the first read
    want = jds.HDF5(names[jax_root])
    assert_same_dataset(got, want)
    assert got.index is not None
    assert float(got.distance_scale) == float(want.distance_scale) == 1e-10
    assert ("pq" in got[0]) == charges and ("neg_dy" in got[0]) == forces


# --- the mmap-processed readers ----------------------------------------------


def _write_ani1(root, rng):
    raw = os.path.join(root, "raw", "ANI-1_release")
    os.makedirs(raw)
    species = np.array([b"H", b"C", b"N", b"O"])
    for s in range(1, 9):
        with h5py.File(os.path.join(raw, f"ani_gdb_s{s:02d}.h5"), "w") as f:
            top = f.create_group(f"gdb11_s{s:02d}")
            for m, n in enumerate(_mol_sizes(rng, 1 + s % 2)):
                g = top.create_group(f"gdb11_s{s:02d}-{m}")
                g["species"] = rng.choice(species, n)
                confs = int(rng.integers(1, 3))
                g["coordinates"] = rng.normal(size=(confs, n, 3)).astype(np.float32)
                g["energies"] = rng.normal(size=confs) - 40.0


def _write_ani1x(root, rng):
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    with h5py.File(os.path.join(raw, "ani1x-release.h5"), "w") as f:
        for m, n in enumerate(_mol_sizes(rng, 3)):
            g = f.create_group(f"mol{m}")
            confs = 4
            g["atomic_numbers"] = rng.choice([1, 6, 7, 8], n)
            g["coordinates"] = rng.normal(size=(confs, n, 3)).astype(np.float32)
            e = rng.normal(size=confs) - 50.0
            forces = rng.normal(size=(confs, n, 3)).astype(np.float32)
            cc = rng.normal(size=confs) - 50.0
            e[1] = np.nan  # conformers without a label are skipped
            forces[2, 0, 1] = np.nan
            cc[3] = np.nan
            g["wb97x_dz.energy"] = e
            g["wb97x_dz.forces"] = forces
            g["ccsd(t)_cbs.energy"] = cc


@pytest.mark.parametrize("name,write", [("ANI1", _write_ani1), ("ANI1X", _write_ani1x), ("ANI1CCX", _write_ani1x)])
def test_ani(tmp_path, name, write):
    port_root, jax_root = _roots(tmp_path, write)
    got = getattr(pds, name)(port_root)
    assert_same_dataset(got, getattr(jds, name)(jax_root))
    # ANI1CCX has no forces: its neg_dy file is an empty marker
    marker = os.path.join(port_root, "processed", f"{name}.neg_dy.mmap")
    assert (os.path.getsize(marker) == 0) == (name != "ANI1X")


def test_mmap_files_are_reused_on_reopen(tmp_path, monkeypatch):
    port_root, jax_root = _roots(tmp_path, _write_ani1x)
    first = pds.ANI1X(port_root)
    processed = sorted(os.listdir(os.path.join(port_root, "processed")))
    assert processed == sorted(f"ANI1X.{f}.mmap" for f in ("idx", "z", "pos", "y", "neg_dy"))
    dtypes = {"z": np.int8, "y": np.float64, "idx": np.int64}
    for field, dtype in dtypes.items():
        size = os.path.getsize(os.path.join(port_root, "processed", f"ANI1X.{field}.mmap"))
        n = len(first) + 1 if field == "idx" else (len(first) if field == "y" else int(first.sample_sizes().sum()))
        assert size == n * np.dtype(dtype).itemsize, field

    def refuse(self):
        raise AssertionError("processed again")

    monkeypatch.setattr(mmap_base.MmapDataset, "process", refuse)
    os.remove(os.path.join(port_root, "raw", "ani1x-release.h5"))
    assert_same_dataset(pds.ANI1X(port_root), jds.ANI1X(jax_root))


def _write_spice(root, rng):
    raw = os.path.join(root, "raw", "1.1.3")
    os.makedirs(raw)
    with h5py.File(os.path.join(raw, "SPICE-1.1.3.hdf5"), "w") as f:
        for m, n in enumerate(_mol_sizes(rng, 4)):
            g = f.create_group(f"mol{m}")
            g["subset"] = [b"SPICE PubChem Set 1" if m % 2 else b"SPICE Dipeptides"]
            g["atomic_numbers"] = rng.choice([1, 6, 7, 8], n)
            confs = 3
            g["conformations"] = rng.normal(size=(confs, n, 3)).astype(np.float32)
            g["formation_energy"] = rng.normal(size=confs)
            g["dft_total_gradient"] = (rng.normal(size=(confs, n, 3)) * 0.01).astype(np.float32)


@pytest.mark.parametrize("kwargs", [{}, {"subsets": ["SPICE Dipeptides"], "subsample_molecules": 2},
                                    {"max_gradient": 1.5}])
def test_spice(tmp_path, kwargs):
    port_root, jax_root = _roots(tmp_path, _write_spice)
    got = pds.SPICE(port_root, version="1.1.3", **kwargs)
    assert_same_dataset(got, jds.SPICE(jax_root, version="1.1.3", **kwargs))
    # the filters leave some of the 12 conformers out
    assert (len(got) < 12) == bool(kwargs)


def test_spice_subset_filter_can_leave_nothing(tmp_path):
    _write_spice(str(tmp_path), np.random.default_rng(0))
    data = pds.SPICE(str(tmp_path), version="1.1.3", subsets=["nonexistent"])
    assert len(data) == 0 and len(data.sample_sizes()) == 0


def _units(group, name, data, units):
    group.create_dataset(name, data=data).attrs["units"] = units


def _write_ace(root, rng):
    with h5py.File(os.path.join(root, "ace_v1.h5"), "w") as f:
        f.attrs["layout"] = "Ace"
        f.attrs["layout_version"] = "1.0"
        f.attrs["name"] = "test"
        for m, n in enumerate(_mol_sizes(rng, 2)):
            g = f.create_group(f"mol{m}")
            g["atomic_numbers"] = rng.choice([1, 6, 8], n)
            g["formal_charges"] = rng.integers(-1, 2, n)
            confs = g.create_group("conformations")
            for c in range(3):
                cg = confs.create_group(f"conf{c}")
                _units(cg, "positions", rng.normal(size=(n, 3)).astype(np.float32), "Å")
                if c != 1:  # a conformer without an energy is skipped
                    _units(cg, "formation_energy", np.float64(rng.normal()), "eV")
                _units(cg, "forces", rng.normal(size=(n, 3)).astype(np.float32), "eV/Å")
                _units(cg, "partial_charges", rng.normal(size=n).astype(np.float32), "e")
                _units(cg, "dipole_moment", rng.normal(size=3).astype(np.float32), "e*Å")
    with h5py.File(os.path.join(root, "ace_v2.h5"), "w") as f:
        f.attrs["layout"] = "Ace"
        f.attrs["layout_version"] = "2.0"
        master = f.create_group("master")
        for m, n in enumerate(_mol_sizes(rng, 2)):
            g = master.create_group(f"mol{m}")
            confs = 3
            g["atomic_numbers"] = rng.choice([1, 6, 8], n)
            g["formal_charges"] = rng.integers(-1, 2, n)
            e = rng.normal(size=confs)
            e[2] = np.nan
            _units(g, "positions", rng.normal(size=(confs, n, 3)).astype(np.float32), "Å")
            _units(g, "formation_energies", e, "eV")
            _units(g, "forces", rng.normal(size=(confs, n, 3)).astype(np.float32), "eV/Å")
            _units(g, "partial_charges", rng.normal(size=(confs, n)).astype(np.float32), "e")
            _units(g, "dipole_moments", rng.normal(size=(confs, 3)).astype(np.float32), "e*Å")


def _write_qm9q(root, rng):
    with h5py.File(os.path.join(root, "qm9q.h5"), "w") as f:
        top = f.create_group("data")
        for m, n in enumerate(_mol_sizes(rng, 3)):
            g = top.create_group(f"mol{m}")
            z = rng.choice([1, 6, 7, 8], n)
            g["atomic_numbers"] = z
            groups = {name: g.create_group(name) for name in
                      ("positions", "energy", "gradient_vector", "electronic_charge", "dipole_moment")}
            groups["positions"].attrs["units"] = "Å : ångströms"
            groups["energy"].attrs["units"] = "E_h : hartree"
            groups["gradient_vector"].attrs["units"] = "vector : Hartree/Bohr "
            groups["electronic_charge"].attrs["units"] = "n : fractional electrons"
            groups["dipole_moment"].attrs["units"] = "\\mu : Debye "
            for c in range(3):
                charge = [0, 1, -1][(m + c) % 3]
                pq = rng.normal(size=n) * 0.1
                pq += (charge - pq.sum()) / n
                grad = rng.normal(size=(n, 3)) * 0.01
                if (m, c) == (1, 2):
                    grad[0, 0] = 10.0  # above 100 eV/A: skipped
                groups["positions"][f"c{c}"] = rng.normal(size=(n, 3))
                groups["energy"][f"c{c}"] = rng.normal() - 100.0
                groups["gradient_vector"][f"c{c}"] = grad
                groups["electronic_charge"][f"c{c}"] = pq
                groups["dipole_moment"][f"c{c}"] = rng.normal(size=3)


@pytest.mark.parametrize("name", ["Ace", "QM9q"])
def test_charged_datasets_and_their_batches(tmp_path, name):
    write = _write_ace if name == "Ace" else _write_qm9q
    port_root, jax_root = _roots(tmp_path, write)
    got = getattr(pds, name)(root=port_root, paths=port_root)
    want = getattr(jds, name)(root=jax_root, paths=jax_root)
    assert_same_dataset(got, want)
    sample = got[0]
    assert sample["q"].dtype == np.float32 and sample["pq"].shape == sample["z"].shape
    assert sample["dp"].shape == (3,)
    # the loaders: q per molecule, pq into extra["partial_charges"]
    kw = dict(batch_size=3, shuffle=True, seed=2, extra_atom_keys=("partial_charges",))
    for a, b in zip(PaddedLoader(got, **kw), JaxLoader(want, **kw)):
        for key in ("z", "pos", "batch", "y", "neg_dy", "q"):
            np.testing.assert_array_equal(getattr(a, key).numpy(), np.asarray(getattr(b, key)), err_msg=key)
        np.testing.assert_array_equal(a.extra["partial_charges"].numpy(), np.asarray(b.extra["partial_charges"]))


def test_qm9q_reference_energy_matches_jax():
    from torchmdnet_tpu.data.datasets.qm9q import compute_reference_energy as jax_reference
    from torchmdnet_tpu_torch.data.datasets.qm9q import compute_reference_energy

    for z, q in (([6, 1, 1, 1, 1], 0), ([8, 1], -1), ([7, 1, 1, 1, 1], 1), ([9, 6, 8], -2)):
        assert compute_reference_energy(z, q) == jax_reference(z, q)


_COMP6_FILES = {"ANIMD": ["ani_md_bench.h5"], "DrugBank": ["drugbank_testset.h5"],
                "GDB07to09": ["gdb11_07_test500.h5", "gdb11_08_test500.h5", "gdb11_09_test500.h5"],
                "GDB10to13": ["gdb11_10_test500.h5", "gdb11_11_test500.h5", "gdb13_12_test1000.h5",
                              "gdb13_13_test1000.h5"],
                "Tripeptides": ["tripeptide_full.h5"], "S66X8": ["s66x8_wb97x6-31gd.h5"]}


def _write_comp6(root, rng):
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    species = np.array([b"H", b"C", b"N", b"O"])
    for files in _COMP6_FILES.values():
        for name in files:
            with h5py.File(os.path.join(raw, name), "w") as f:
                top = f.create_group("top")
                n = _mol_sizes(rng, 1)[0]
                g = top.create_group("mol0")
                g["species"] = rng.choice(species, n)
                g["coordinates"] = rng.normal(size=(2, n, 3)).astype(np.float32)
                g["energies"] = rng.normal(size=2) - 100.0
                g["forces"] = rng.normal(size=(2, n, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(_COMP6_FILES) + ["COMP6v1"])
def test_comp6(tmp_path, name):
    port_root, jax_root = _roots(tmp_path, _write_comp6)
    assert_same_dataset(getattr(pds, name)(port_root), getattr(jds, name)(jax_root))


# --- the registry -------------------------------------------------------------


def test_registry_imports_without_h5py():
    """The readers of HDF5 files import h5py inside the functions that read
    one, so the registry imports on a machine without it."""
    folder = os.path.dirname(pds.__file__)
    for name in sorted(os.listdir(folder)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(folder, name)) as f:
            tree = ast.parse(f.read())
        top = [node for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))]
        names = {alias.name for node in top for alias in node.names} | {
            node.module for node in top if isinstance(node, ast.ImportFrom)}
        assert "h5py" not in names, name
