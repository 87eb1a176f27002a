"""The port's TensorNet training held against the JAX trainer's, on the CPU.

A tiny TensorNet (1 layer, 32 channels, 8 RBFs, K = 9) gets random weights in
the JAX model's parameter tree, carried into the port by
``state_dict_from_jax``.  One and three optimizer steps of the port's
``Trainer`` and of JAX's ``_train_step_impl`` on the same padded
``SyntheticMorse`` batch, sorted in space as both trainers sort it under
``fused_message`` (force loss by grad-of-grad, the TensorNet-ANI1X loss
weights 0.5 / 0.5, EMA smoothing, clipping that triggers, a linear warmup),
give the same losses and updated parameters to 1e-5 in f32 (the composable
path on both sides: AdamW turns any bf16 difference of a near-zero gradient
into a full step, so parameters after steps are compared in f32).

The bf16 fused path (its plain version on the CPU) is held against JAX's bf16
composable path on the force-loss gradient at the tolerance
tests/test_tn_fused.py and tests/test_torch_train.py use for such pairs: 4e-2
of each parameter tensor's largest value.

With the launches swapped for counting plain twins, a fused step of a 2-layer
port sorts the batch in space and launches (2, 4, 2): per layer one forward,
the inner force pass and the outer energy term's backward, one second order.
The CLI takes ``--model tensornet --fused-message true``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_tn_message import route_through_functions
from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules
from torchmdnet_tpu.data.datasets import SyntheticMorse as JaxMorse
from torchmdnet_tpu.models.potential import create_model as jax_create_model
from torchmdnet_tpu.train.trainer import Trainer as JaxTrainer
from torchmdnet_tpu.train.trainer import masked_mse as jax_masked_mse
from torchmdnet_tpu_torch import create_model, state_dict_from_jax
from torchmdnet_tpu_torch.data.batch import pad_molecules, spatial_sort
from torchmdnet_tpu_torch.ops.kernels import tn_message as tm
from torchmdnet_tpu_torch.scripts import train as cli
from torchmdnet_tpu_torch.train.trainer import Trainer, masked_mse

ARGS = dict(
    model="tensornet", embedding_dimension=32, num_layers=1, num_rbf=8, rbf_type="expnorm",
    trainable_rbf=False, activation="silu", cutoff_lower=0.0, cutoff_upper=4.5, max_z=100,
    max_num_neighbors=8, derivative=True, output_model="Scalar", prior_model=None,
    reduce_op="add", atom_filter=-1, equivariance_invariance_group="O(3)", precision=32,
)
FUSED = dict(bf16_messages=True, fused_message=True)
HPARAMS = dict(
    lr=2e-3, lr_warmup_steps=2, gradient_clipping=0.5, weight_decay=0.01, ema_alpha_y=0.7,
    ema_alpha_neg_dy=0.8, y_weight=0.5, neg_dy_weight=0.5, fused_message=True,
)
N_ATOMS = 24  # three molecules of 8 atoms
# LLVM's cheap pipeline at optimization level 1: level 0 compiles the train
# step faster, but its executable runs about ten times slower, and the step
# runs three times
FAST_COMPILE = {"xla_backend_optimization_level": 1, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _dataset():
    return JaxMorse(num_samples=3, num_atoms=8, seed=0)


def _mols():
    ds = _dataset()
    return [{k: np.asarray(v) for k, v in ds[i].items()} for i in range(3)]


def _jax_params(jm, jb):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb)
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        scale = {"scale": 0.1, "bias": 0.1, "embedding": 1.0}.get(name, leaf.shape[0] ** -0.5)
        return (rng.normal(scale=scale, size=leaf.shape) + (1.0 if name == "scale" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_model(args, params):
    pm = create_model(args, device="cpu")
    missing, unexpected = pm.module.load_state_dict(state_dict_from_jax(args, params), strict=False)
    assert not unexpected and all("distance_expansion" in k for k in missing)
    return pm


def test_trainer_steps_match_jax(tmp_path):
    h = dict(ARGS, **HPARAMS, log_dir=str(tmp_path))
    jtr = JaxTrainer(jax_create_model(ARGS), h)
    assert jtr._fused  # the batch is sorted as for the fused kernels
    jb = jtr._prepare_batch(jax_pad_molecules(_mols(), num_atoms=N_ATOMS, num_mol=3))
    params = _jax_params(jtr.model, jb)
    opt_state = jax.jit(jtr.optimizer.init)(params)  # one program, not one per leaf
    acc = jnp.zeros((4,), jnp.float32)
    ema = (jnp.asarray(0.0, jnp.float32), jnp.asarray(0.0, jnp.float32))
    ptr = Trainer(_port_model(ARGS, params), h)
    pb = ptr._prepare_batch(pad_molecules(_mols(), num_atoms=N_ATOMS, num_mol=3))
    np.testing.assert_array_equal(pb.pos.numpy(), np.asarray(jb.pos))  # the same sorted order
    pacc = torch.zeros(4)
    pema = (torch.zeros(()), torch.zeros(()))
    # JAX builds a gather plan for its kernels under fused_message; its
    # composable model ignores it, so the step is built without one
    jtr._fused = False
    step = None
    for i in range(3):
        lr = jtr._current_lr(type("S", (), {"lr": h["lr"], "global_step": i})())
        opt_state = jtr._set_lr(opt_state, lr)
        call = (params, opt_state, acc, jb) + ema
        if step is None:
            step = jax.jit(jtr._train_step_impl).lower(*call).compile(compiler_options=FAST_COMPILE)
        params, opt_state, acc, ly, lf = step(*call)
        ema = (ly, lf)
        pema = ptr._train_step(pb, pacc, *pema)
        if i in (0, 2):
            np.testing.assert_allclose([float(v) for v in pema], [float(ly), float(lf)], rtol=1e-5)
            np.testing.assert_allclose(pacc.numpy(), np.asarray(acc), rtol=1e-5)
            want = state_dict_from_jax(ARGS, jax.tree_util.tree_map(np.asarray, params))
            got = ptr.model.module.state_dict()
            for k, v in want.items():
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=f"{k} after step {i + 1}")
    assert float(acc[1]) > 0 and float(acc[2]) > 0  # both loss terms were live


def test_fused_bf16_grads_match_jax_bf16_composable():
    args = dict(ARGS, bf16_messages=True)
    jm = jax_create_model(args)
    jb = jax_pad_molecules(_mols(), num_atoms=N_ATOMS, num_mol=3)
    nbl = jax.jit(jm.neighbors).lower(jb).compile(compiler_options=FAST_COMPILE)(jb)
    nbl.raise_on_overflow("test")

    def loss(p):
        y, neg_dy = jm.energy_and_forces(p, jb, nbl=nbl)
        return 0.5 * jax_masked_mse(y, jb.y, jb.mol_mask) + 0.5 * jax_masked_mse(neg_dy, jb.neg_dy, jb.atom_mask)

    params = _jax_params(jm, jb)
    grads = jax.jit(jax.grad(loss)).lower(params).compile(compiler_options=FAST_COMPILE)(params)
    want = state_dict_from_jax(args, jax.tree_util.tree_map(np.asarray, grads))
    pm = _port_model(dict(args, **FUSED), params)
    pb = pad_molecules(_mols(), num_atoms=N_ATOMS, num_mol=3)
    y, neg_dy = pm.energy_and_forces(pb, create_graph=True)
    total = 0.5 * masked_mse(y, pb.y, pb.mol_mask) + 0.5 * masked_mse(neg_dy, pb.neg_dy, pb.atom_mask)
    named = {k: p for k, p in pm.module.named_parameters()}
    got = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    assert set(got) == set(want)
    for k, g in got.items():
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=4e-2 * max(scale, 1e-3), err_msg=k)


def test_fused_step_sorts_the_batch_and_launches_each_kernel(tmp_path, monkeypatch):
    route_through_functions(monkeypatch)
    args = dict(ARGS, num_layers=2, **FUSED)
    ptr = Trainer(create_model(args, device="cpu"), dict(args, **HPARAMS, log_dir=str(tmp_path)))
    # molecules listed against the grain of space: the sort must reorder them
    mols = [dict(m, pos=m["pos"] + np.array([10.0 * (2 - i), 0.0, 0.0], np.float32))
            for i, m in enumerate(_mols())]
    raw = pad_molecules(mols, num_atoms=N_ATOMS, num_mol=3)
    batch = ptr._prepare_batch(raw)
    sorted_batch, _ = spatial_sort(raw, cell=ARGS["cutoff_upper"])
    assert ptr._fused and torch.equal(batch.pos, sorted_batch.pos)
    assert not torch.equal(batch.pos, raw.pos)
    tm.reset_launch_counts()
    acc = torch.zeros(4)
    ptr._train_step(batch, acc, torch.zeros(()), torch.zeros(()))
    assert (tm.run_fwd.launches, tm.run_bwd.launches, tm.run_bwd2.launches) == (2, 4, 2)
    assert torch.isfinite(acc).all() and float(acc[2]) > 0


def test_cli_trains_tensornet_with_fused_message(tmp_path):
    trainer, test_metrics = cli.main([
        "--device", "cpu", "--model", "tensornet", "--embedding-dimension", "32", "--num-layers", "1",
        "--num-rbf", "8", "--max-num-neighbors", "16", "--cutoff-upper", "3.0", "--derivative", "true",
        "--batch-size", "4", "--train-size", "8", "--val-size", "4", "--test-size", "4",
        "--dataset", "DummyDataset", "--dataset-root", str(tmp_path), "--num-workers", "0",
        "--num-epochs", "1", "--lr", "1e-3", "--bf16-messages", "true", "--fused-message", "true",
        "--y-weight", "0.5", "--neg-dy-weight", "0.5", "--log-dir", str(tmp_path / "logs"),
    ])
    assert trainer.state.global_step == 2 and trainer._fused
    assert trainer.model.args["fused_message"] and all(v == v for v in test_metrics.values())
