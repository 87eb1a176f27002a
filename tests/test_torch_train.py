"""The port's Trainer held against the JAX trainer's step, on the CPU.

A tiny ET (1 layer, 32 channels, 4 heads, 8 RBFs, NeighborEmbedding, an
Atomref prior) gets random weights in the JAX model's parameter tree, carried
into the port by ``state_dict_from_jax``.  One and three optimizer steps of
the port's ``Trainer`` and of JAX's ``_train_step_impl`` on the same padded
``SyntheticMorse`` batch, with the force loss by grad-of-grad, EMA smoothing
(alpha < 1), global-norm clipping that triggers, weight decay and a linear
warmup, give the same losses and the same updated parameters: f64 to 1e-8,
f32 to 1e-5 (relative, with an absolute floor of the same size).

The bf16 fused path (its plain version on the CPU) is held against JAX's
bf16 composable path on the force-loss gradient at the tolerance
tests/test_et_fused.py uses for the same two paths: 4e-2 of each parameter
tensor's largest value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules
from torchmdnet_tpu.data.datasets import SyntheticMorse as JaxMorse
from torchmdnet_tpu.models.potential import create_model as jax_create_model
from torchmdnet_tpu.models.potential import create_prior_models as jax_create_prior_models
from torchmdnet_tpu.ops.rbf import ExpNormalSmearing
from torchmdnet_tpu.train.trainer import Trainer as JaxTrainer
from torchmdnet_tpu.train.trainer import masked_mse as jax_masked_mse
from torchmdnet_tpu_torch import create_model, state_dict_from_jax
from torchmdnet_tpu_torch.data.batch import pad_molecules
from torchmdnet_tpu_torch.models.potential import create_prior_models
from torchmdnet_tpu_torch.train.trainer import Trainer, masked_mse

ARGS = dict(
    model="equivariant-transformer", embedding_dimension=32, num_layers=1, num_rbf=8,
    rbf_type="expnorm", trainable_rbf=False, activation="silu", attn_activation="silu",
    neighbor_embedding=True, num_heads=4, distance_influence="both", cutoff_lower=0.0,
    cutoff_upper=5.0, max_z=100, max_num_neighbors=8, derivative=True,
    output_model="Scalar", prior_model="Atomref", reduce_op="add", atom_filter=-1,
)
HPARAMS = dict(
    lr=1e-3, lr_warmup_steps=2, weight_decay=0.01, gradient_clipping=0.5,
    ema_alpha_y=0.7, ema_alpha_neg_dy=0.8, y_weight=1.0, neg_dy_weight=0.5,
)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
N_ATOMS = 24  # three molecules of 8 atoms

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


def _mols(float_dtype):
    ds = _dataset()
    return [{k: np.asarray(v, float_dtype) if k != "z" else v for k, v in ds[i].items()} for i in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_params(precision):
    """Random weights in the JAX tree (shapes from tracing ``init``), in the
    model's precision so that both optimizers update in it."""
    fdt = np.float64 if precision == 64 else np.float32
    jb = jax_pad_molecules(_mols(np.float32), num_atoms=N_ATOMS, num_mol=3)
    jm = jax_create_model(dict(ARGS, precision=32), jax_create_prior_models(ARGS, _dataset()))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb)
    rbf = ExpNormalSmearing(0.0, 5.0, 8, buffer_dtype=np.float32)
    means, betas = (np.asarray(a) for a in rbf._initial_params())
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("means", "betas"):
            return (means if name == "means" else betas).astype(fdt)
        scale = {"scale": 0.1, "bias": 0.1, "embedding": 1.0, "atomref": 0.5}.get(name, leaf.shape[0] ** -0.5)
        value = rng.normal(scale=scale, size=leaf.shape) + (1.0 if name == "scale" else 0.0)
        return value.astype(fdt)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_model(args, precision):
    pm = create_model(args, create_prior_models(args, _dataset()), device="cpu")
    # the RBF's constants are buffers the port builds itself (trainable_rbf=False)
    missing, unexpected = pm.module.load_state_dict(state_dict_from_jax(args, _jax_params(precision)),
                                                    strict=False)
    assert not unexpected and all(k.startswith("representation_model.distance_expansion.") for k in missing)
    return pm


def _port_batch(fdt):
    return pad_molecules(_mols(fdt), num_atoms=N_ATOMS, num_mol=3, float_dtype=fdt)


def _jax_batch(fdt):
    return jax_pad_molecules(_mols(fdt), num_atoms=N_ATOMS, num_mol=3, float_dtype=fdt)


@pytest.mark.parametrize("precision,tol", [(64, 1e-8), (32, 1e-5)])
def test_trainer_steps_match_jax(precision, tol, tmp_path):
    fdt = np.float64 if precision == 64 else np.float32
    args = dict(ARGS, precision=precision)
    h = dict(args, **HPARAMS, log_dir=str(tmp_path))
    # JAX: its own train step, jitted once, fed the host loop's lr and EMA
    jtr = JaxTrainer(jax_create_model(args, jax_create_prior_models(args, _dataset())), h)
    params = _jax_params(precision)
    opt_state = jtr.optimizer.init(params)
    acc = jnp.zeros((4,), fdt)
    ema = (jnp.asarray(0.0, fdt), jnp.asarray(0.0, fdt))
    jb = _jax_batch(fdt)
    step = None
    # port
    ptr = Trainer(_port_model(args, precision), h)
    pb = _port_batch(fdt)
    pacc = torch.zeros(4, dtype=ptr.dtype)
    pema = (torch.zeros((), dtype=ptr.dtype), torch.zeros((), dtype=ptr.dtype))
    for i in range(3):
        lr = jtr._current_lr(jtr_state := type("S", (), {"lr": h["lr"], "global_step": i})())
        opt_state = jtr._set_lr(opt_state, lr)
        call = (params, opt_state, acc, jb) + ema
        if step is None:
            step = jax.jit(jtr._train_step_impl).lower(*call).compile(compiler_options=FAST_COMPILE)
        params, opt_state, acc, ly, lf = step(*call)
        ema = (ly, lf)
        pema = ptr._train_step(pb, pacc, *pema)
        assert ptr.state.global_step == i + 1 and ptr._current_lr(ptr.state) == jtr._current_lr(
            type("S", (), {"lr": h["lr"], "global_step": i + 1})())
        if i in (0, 2):
            np.testing.assert_allclose([float(v) for v in pema], [float(ly), float(lf)], rtol=tol)
            np.testing.assert_allclose(pacc.numpy(), np.asarray(acc), rtol=tol)
            want = state_dict_from_jax(args, jax.tree_util.tree_map(np.asarray, params))
            got = ptr.model.module.state_dict()
            for k, v in want.items():
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=tol, atol=tol,
                                           err_msg=f"{k} after step {i + 1}")
    assert float(acc[1]) > 0 and float(acc[2]) > 0  # both loss terms were live


def test_fused_bf16_grads_match_jax_bf16_composable():
    args = dict(ARGS, precision=32, bf16_messages=True)
    jm = jax_create_model(args, jax_create_prior_models(args, _dataset()))
    jb = _jax_batch(np.float32)
    nbl = jm.neighbors(jb)
    nbl.raise_on_overflow("test")

    def loss(p):
        y, neg_dy = jm.energy_and_forces(p, jb, nbl=nbl)
        return jax_masked_mse(y, jb.y, jb.mol_mask) + jax_masked_mse(neg_dy, jb.neg_dy, jb.atom_mask)

    params = _jax_params(32)
    grads = jax.jit(jax.grad(loss)).lower(params).compile(compiler_options=FAST_COMPILE)(params)
    want = state_dict_from_jax(args, jax.tree_util.tree_map(np.asarray, grads))

    pm = _port_model(dict(args, fused_attention=True), 32)
    pb = _port_batch(np.float32)
    y, neg_dy = pm.energy_and_forces(pb, create_graph=True)
    total = masked_mse(y, pb.y, pb.mol_mask) + masked_mse(neg_dy, pb.neg_dy, pb.atom_mask)
    named = dict(pm.module.named_parameters())
    got = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    assert set(got) == set(want)
    for k, g in got.items():
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=4e-2 * max(scale, 1e-3), err_msg=k)


def test_later_slice_options_raise(tmp_path):
    pm = create_model(dict(ARGS, precision=32), create_prior_models(ARGS, _dataset()), device="cpu")
    for over in (dict(force_grad_mode="jvp"), dict(edge_partition=True), dict(ndevices=2), dict(num_nodes=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(pm, dict(ARGS, log_dir=str(tmp_path), **over))
    # accepted: steps run one by one; the gather plan is unused
    Trainer(pm, dict(ARGS, log_dir=str(tmp_path), steps_per_dispatch=8, plan_width=256, ndevices=-1))
