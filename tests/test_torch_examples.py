"""The published configurations (examples/*.yaml) through the port, on the CPU.

- Every file merges through the port's training CLI (``get_args --conf``)
  into the same hyperparameters as through the JAX package's, rejecting no
  key.
- ET-SPICE, TensorNet-SPICE, ET-QM9 and TensorNet-QM9, shrunk as
  tests/test_examples.py shrinks them (32 channels, 1 layer, 8 RBFs) but
  keeping each file's cutoff, K, ``derivative`` and Atomref prior, get
  random weights in the JAX model's parameter tree (shapes from
  ``jax.eval_shape``), carried into the port by ``state_dict_from_jax``;
  energies (and forces where ``derivative``) match JAX's in f32 at rtol
  1e-5, atol 1e-5, the tolerance of tests/test_torch_et_model.py.
- At the SPICE files' K 128, the fused bf16 paths of ET and TensorNet (the
  kernels' plain twins on the CPU) against JAX's bf16 composable path, at
  tests/test_torch_et_model.py's bf16 tolerance (energies rtol 2e-2, forces
  4e-2 of the largest).
- Through the port's CLI: ET-SPICE.yaml, shrunk, on Custom npy files of
  molecules of three sizes (forces), finite losses, the last step's below
  the first's on the one training batch (a warmup of one step: the file's
  10,000 would hold the rate near zero); ET-QM9.yaml, shrunk, on energy-only
  Custom files, ``derivative`` false from the file and an Atomref table that
  moved from its zeros (a nonzero gradient) on the elements present only.
- GN MD with ``remat`` is bitwise the run without (torch only).
"""

import csv
import functools
import glob
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules
from torchmdnet_tpu.models.potential import create_model as jax_create_model
from torchmdnet_tpu.scripts import train as jax_cli
from torchmdnet_tpu_torch import Simulation, create_model, state_dict_from_jax
from torchmdnet_tpu_torch.data.batch import pad_molecules
from torchmdnet_tpu_torch.scripts import train as port_cli
from torchmdnet_tpu_torch.tools import chip_configs as cc

EXAMPLES = sorted(glob.glob(os.path.join(cc.EXAMPLES, "*.yaml")))
SHRUNK = dict(embedding_dimension=32, num_layers=1, num_rbf=8)
HELD = ["ET-SPICE.yaml", "TensorNet-SPICE.yaml", "ET-QM9.yaml", "TensorNet-QM9.yaml"]
N_ATOMS = 24
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_jitted(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


@pytest.mark.parametrize("fname", EXAMPLES, ids=[os.path.basename(f) for f in EXAMPLES])
def test_cli_merge_matches_jax(fname, tmp_path):
    got = vars(port_cli.get_args(["--conf", fname, "--log-dir", str(tmp_path / "port")]))
    want = vars(jax_cli.get_args(["--conf", fname, "--log-dir", str(tmp_path / "jax")]))
    for h in (got, want):
        del h["conf"], h["log_dir"]
    assert got.pop("device") is None  # the port's own flag (PORT_ONLY_FLAGS)
    assert got == want
    with open(fname) as f:
        for key, value in yaml.safe_load(f).items():
            assert key == "log_dir" or got[key] == value, key


def _args(conf, **overrides):
    """The file's configuration shrunk; Atomref with the table size a dataset
    without one gives (100 elements)."""
    with open(os.path.join(cc.EXAMPLES, conf)) as f:
        args = dict(yaml.safe_load(f), **SHRUNK)
    if args["prior_model"] == "Atomref":
        args["prior_model"] = {"Atomref": {"max_z": 100}}
    return dict(args, **overrides)


def _mols(float_dtype=np.float32):
    rng = np.random.default_rng(0)
    return [{"z": rng.integers(1, 10, n), "pos": rng.uniform(0.0, 6.0, (n, 3)).astype(float_dtype)}
            for n in (14, 9)]


def _draw(shapes, seed=1):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        scale = {"scale": 0.1, "bias": 0.1, "embedding": 1.0}.get(name, leaf.shape[0] ** -0.5)
        return (rng.normal(scale=scale, size=leaf.shape) + (1.0 if name == "scale" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _jax_params(conf):
    args = _args(conf)
    jb = jax_pad_molecules(_mols(), num_atoms=N_ATOMS, num_mol=2)
    return _draw(jax.eval_shape(jax_create_model(args).init, jax.random.PRNGKey(0), jb))


def _both(conf, **overrides):
    """(JAX's (y, neg_dy or None), the port's) on the seeded batch, the
    port's model carrying the JAX weights."""
    args = _args(conf, **overrides)
    jm = jax_create_model({k: v for k, v in args.items() if k != "fused_attention" and k != "fused_message"})
    jb = jax_pad_molecules(_mols(), num_atoms=N_ATOMS, num_mol=2)
    params = _jax_params(conf)
    if args["derivative"]:
        want = _run_jitted(jm.energy_and_forces, params, jb)
    else:
        want = (_run_jitted(jm.energy, params, jb), None)
    pm = create_model(args, device="cpu")
    missing, unexpected = pm.module.load_state_dict(state_dict_from_jax(args, params), strict=False)
    assert not unexpected and all(k.startswith("representation_model.distance_expansion.") for k in missing)
    assert type(pm.module.priors[0]).__name__ == "Atomref" if "QM9" in conf else not pm.module.priors
    pb = pad_molecules(_mols(), num_atoms=N_ATOMS, num_mol=2)
    got = pm.energy_and_forces(pb) if args["derivative"] else (pm.energy(pb), None)
    return want, got


@pytest.mark.parametrize("conf", HELD)
def test_shrunk_example_matches_jax(conf):
    (y_ref, f_ref), (y, f) = _both(conf)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    assert (f is None) == (f_ref is None) == ("QM9" in conf)
    if f is not None:
        assert np.abs(np.asarray(f_ref)).max() > 1e-3
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("conf,fused", [("ET-SPICE.yaml", "fused_attention"),
                                        ("TensorNet-SPICE.yaml", "fused_message")])
def test_fused_bf16_at_k128_matches_jax_bf16_composable(conf, fused):
    (y_ref, f_ref), (y, f) = _both(conf, bf16_messages=True, **{fused: True})
    assert _args(conf)["max_num_neighbors"] == 128
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=2e-2, atol=2e-2)
    scale = np.abs(np.asarray(f_ref)).max()
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=4e-2 * scale)


def _train(tmp_path, conf, sizes, split, batch, forces):
    data = cc.write_custom_frames(str(tmp_path / "data"), sizes, frames=sum(split) // len(sizes) + 1,
                                  forces=forces)
    log_dir = str(tmp_path / "logs")
    model = "tensornet" if conf.startswith("TensorNet") else "equivariant-transformer"
    flags = cc.example_flags(conf, data, split, log_dir, model) + [
        "--device", "cpu", "--embedding-dimension", "32", "--num-layers", "1", "--num-rbf", "8",
        "--batch-size", str(batch), "--inference-batch-size", str(batch), "--num-workers", "0",
        "--lr-warmup-steps", "1"]
    trainer, test_metrics = port_cli.main(flags)
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        losses = [float(r["train_total_mse_loss"]) for r in csv.DictReader(f) if r.get("train_total_mse_loss")]
    values = [trainer.first_step_loss] + losses + [float(v) for v in test_metrics.values()]
    assert len(losses) == cc.EXAMPLE_EPOCHS and all(np.isfinite(values)), values
    # one training batch an epoch: the last step's loss on the first's batch
    assert trainer.state.global_step == cc.EXAMPLE_EPOCHS and losses[-1] < trainer.first_step_loss
    return trainer


def test_et_spice_yaml_through_the_cli(tmp_path):
    trainer = _train(tmp_path, "ET-SPICE.yaml", (5, 9, 12), (4, 4, 4), 4, forces=True)
    h = trainer.h
    assert (h["dataset"], h["cutoff_upper"], h["max_num_neighbors"], h["derivative"]) == ("Custom", 10.0, 128, True)
    assert h["fused_attention"] and h["bf16_messages"] and h["y_weight"] == h["neg_dy_weight"] == 0.5


def test_et_qm9_yaml_energy_only_through_the_cli(tmp_path):
    trainer = _train(tmp_path, "ET-QM9.yaml", (4, 7), (4, 4, 4), 4, forces=False)
    assert trainer.h["derivative"] is False and trainer.h["dataset"] == "Custom"
    (prior,) = trainer.model.module.priors
    table = prior.atomref.detach().reshape(-1)
    present = torch.zeros_like(table, dtype=torch.bool)
    for path in glob.glob(str(tmp_path / "data" / "embed_*.npy")):
        present[torch.as_tensor(np.load(path))] = True
    # the table starts from zeros (Custom has none) and only what the data
    # holds has a gradient
    assert bool((table[present] != 0).all()) and bool((table[~present] == 0).all())


def test_gn_md_with_remat_is_bitwise_the_run_without():
    args = dict(cc.GN_ARGS, embedding_dimension=16, num_layers=2, num_rbf=8, max_num_neighbors=16,
                cutoff_upper=3.0, precision=32)
    z, pos, _, _ = cc.morse_frames(20, 1, seed=3)
    batch = pad_molecules([{"z": z, "pos": pos[0]}], num_atoms=24)
    runs = []
    for remat in (False, True):
        model = create_model(dict(args, remat=remat), seed=0, device="cpu")
        sim = Simulation(model, batch, device="cpu", seed=0, timestep_fs=0.5, neighbor_skin=0.5, rebuild_every=2)
        sim.set_velocities_from_temperature(300.0)
        sim.step(6)
        runs.append((sim.state.pos, sim.state.energy, sim._carried[1]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert not torch.equal(runs[0][0], batch.pos)
