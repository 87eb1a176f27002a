"""The port's Transformer (TorchMD_T) held against the JAX package's, on the CPU.

A small Transformer (2 layers, 32 channels, 4 heads, 8 trainable ExpNormal
RBFs, K = 8, NeighborEmbedding, Scalar head) gets random weights in the JAX
model's parameter tree, drawn from ``jax.eval_shape`` (no eager ``init``) and
carried into the port by ``state_dict_from_jax``.  Energies and forces of the
whole ``Potential`` through both ``energy_and_forces``, with and without a
periodic box:

- f64: rtol 1e-9 (same formulas; only the order of sums differs);
- f32: rtol 1e-5, atol 1e-5 (f32 rounding through 2 layers);
- bf16 messages: the port's composable bf16 path and its fused path (the
  plain version of the kernels on the CPU) against JAX's bf16 composable
  path.  They round every edge intermediate to bf16 (2^-8 relative) at
  different points, so they agree to bf16 accuracy: energies rtol 2e-2,
  forces 4e-2 of the largest force, the tolerances tests/test_t_fused.py and
  test_torch_et_model.py use for such pairs.

``state_dict_from_jax`` maps every leaf of the tree, for every
distance_influence; ``remat`` leaves energies, forces and force-loss
gradients unchanged (f64); one Trainer step equals JAX's
``_train_step_impl`` (f32, the composable path, 1e-5); the CLI trains
``--model transformer --fused-attention true``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules
from torchmdnet_tpu.models.potential import create_model as jax_create_model
from torchmdnet_tpu.train.trainer import Trainer as JaxTrainer
from torchmdnet_tpu_torch import create_model, state_dict_from_jax
from torchmdnet_tpu_torch.data.batch import pad_molecules
from torchmdnet_tpu_torch.scripts import train as cli
from torchmdnet_tpu_torch.train.trainer import Trainer, masked_mse

ARGS = dict(
    model="transformer", embedding_dimension=32, num_layers=2, num_rbf=8, rbf_type="expnorm",
    trainable_rbf=True, activation="silu", attn_activation="silu", neighbor_embedding=True,
    num_heads=4, distance_influence="both", cutoff_lower=0.0, cutoff_upper=3.0, max_z=100,
    max_num_neighbors=8, derivative=True, output_model="Scalar", prior_model=None,
    reduce_op="add", atom_filter=-1,
)
N_ATOMS = 24  # molecules of 14 and 9 atoms, one padding atom
BOX = 8.0 * np.eye(3)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mols(float_dtype):
    rng = np.random.default_rng(0)
    return [
        {"z": rng.integers(1, 10, n), "pos": rng.uniform(0.0, 7.0, (n, 3)).astype(float_dtype)}
        for n in (14, 9)
    ]


def _run_jitted(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


@functools.lru_cache(maxsize=None)
def _jax_params(influence="both", num_layers=2):
    """Random weights in the JAX tree at the init scales (nonzero biases),
    float32; the RBF shape constants near their initial values."""
    args = dict(ARGS, distance_influence=influence, num_layers=num_layers, precision=32)
    jb = jax_pad_molecules(_mols(np.float32), num_atoms=N_ATOMS, num_mol=2)
    shapes = jax.eval_shape(jax_create_model(args).init, jax.random.PRNGKey(0), jb)
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("means", "betas"):
            base = np.linspace(np.exp(-3.0), 1.0, leaf.shape[0]) if name == "means" else 16.0
            return (base * (1.0 + 0.1 * rng.normal(size=leaf.shape))).astype(np.float32)
        scale = {"scale": 0.1, "bias": 0.1, "embedding": 1.0}.get(name, leaf.shape[0] ** -0.5)
        value = rng.normal(scale=scale, size=leaf.shape) + (1.0 if name == "scale" else 0.0)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(precision, **overrides):
    fdt = np.float64 if precision == 64 else np.float32
    args = dict(ARGS, precision=precision, **overrides)
    pm = create_model(args, device="cpu")
    pm.module.load_state_dict(state_dict_from_jax(args, _jax_params()))
    return pm, pad_molecules(_mols(fdt), num_atoms=N_ATOMS, num_mol=2, float_dtype=fdt)


def _jax_energy_and_forces(precision, box=None, **overrides):
    fdt = np.float64 if precision == 64 else np.float32
    jb = jax_pad_molecules(_mols(fdt), num_atoms=N_ATOMS, num_mol=2, float_dtype=fdt)
    jm = jax_create_model(dict(ARGS, precision=precision, **overrides))
    params = jax.tree_util.tree_map(lambda a: a.astype(fdt), _jax_params())
    if box is None:
        return _run_jitted(jm.energy_and_forces, params, jb)
    return _run_jitted(lambda p, b, bx: jm.energy_and_forces(p, b, box=bx), params, jb, jnp.asarray(box, fdt))


@pytest.mark.parametrize("precision,box", [(64, False), (32, False), (64, True)])
def test_energy_and_forces_match_jax(precision, box):
    rtol, atol = (1e-9, 1e-12) if precision == 64 else (1e-5, 1e-5)
    bx = BOX if box else None
    y_ref, f_ref = _jax_energy_and_forces(precision, bx)
    pm, pb = _port(precision)
    y, f = pm.energy_and_forces(pb, box=None if bx is None else torch.as_tensor(bx, dtype=pb.pos.dtype))
    assert y.dtype == (torch.float64 if precision == 64 else torch.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=rtol, atol=atol)
    assert np.abs(np.asarray(f_ref)).max() > 1e-3  # the forces are not trivially zero
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=rtol, atol=atol)


def test_bf16_composable_and_fused_match_jax_bf16_composable():
    y_ref, f_ref = _jax_energy_and_forces(32, bf16_messages=True)
    scale = np.abs(np.asarray(f_ref)).max()
    for fused in (False, True):
        pm, pb = _port(32, bf16_messages=True, fused_attention=fused)
        y, f = pm.energy_and_forces(pb)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=4e-2 * scale)


@pytest.mark.parametrize("influence", ["both", "keys", "values", "none"])
def test_state_dict_from_jax_maps_every_leaf(influence):
    """Every JAX leaf lands on one port key of the same shape, and every key
    of the port's model gets one, under torchmd-net's names (q, k, v, then dk
    and dv where kept, then o; no column permutation)."""
    params = _jax_params(influence)
    args = dict(ARGS, distance_influence=influence, precision=32)
    sd = state_dict_from_jax(args, params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    port = create_model(args, device="cpu").module.state_dict()
    assert set(sd) == set(port)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    layer = params["params"]["representation"]["MultiHeadAttention_1"]
    lp = "representation_model.attention_layers.1"
    names = ["q_proj", "k_proj", "v_proj"] + (["dk_proj"] if influence in ("keys", "both") else []) \
        + (["dv_proj"] if influence in ("values", "both") else []) + ["o_proj"]
    assert len(layer) == len(names) + 1  # + LayerNorm_0
    for i, name in enumerate(names):
        np.testing.assert_array_equal(sd[f"{lp}.{name}.weight"].numpy(), np.asarray(layer[f"Dense_{i}"]["kernel"]).T)
    assert (f"{lp}.dk_proj.weight" in sd) == (influence in ("keys", "both"))


def test_remat_leaves_energies_forces_and_gradients_unchanged():
    _, pb = _port(64)
    pb = pb.replace(y=torch.ones(2, 1, dtype=torch.float64), neg_dy=torch.ones(N_ATOMS, 3, dtype=torch.float64))
    out = {}
    for remat in (False, True):
        pm = create_model(dict(ARGS, precision=64, remat=remat), device="cpu", seed=4)
        y, neg_dy = pm.energy_and_forces(pb, create_graph=True)
        loss = masked_mse(y, pb.y, pb.mol_mask) + masked_mse(neg_dy, pb.neg_dy, pb.atom_mask)
        named = dict(pm.module.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        out[remat] = [y, neg_dy] + [g for g in grads if g is not None]
    assert len(out[True]) == len(out[False]) > 2
    for a, b in zip(out[True], out[False]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_trainer_step_matches_jax(tmp_path):
    args = dict(ARGS, num_layers=1, precision=32)
    h = dict(args, lr=1e-3, lr_warmup_steps=2, weight_decay=0.01, gradient_clipping=0.5,
             ema_alpha_y=0.7, ema_alpha_neg_dy=0.8, y_weight=0.2, neg_dy_weight=0.8, log_dir=str(tmp_path))
    rng = np.random.default_rng(3)
    mols = [dict(m, y=np.array([rng.normal()], np.float32), neg_dy=rng.normal(size=m["pos"].shape).astype(np.float32))
            for m in _mols(np.float32)]
    jb = jax_pad_molecules(mols, num_atoms=N_ATOMS, num_mol=2)
    pb = pad_molecules(mols, num_atoms=N_ATOMS, num_mol=2)
    jtr = JaxTrainer(jax_create_model(args), h)
    params = _jax_params(num_layers=1)
    lr = jtr._current_lr(type("S", (), {"lr": h["lr"], "global_step": 0})())
    opt_state = jtr._set_lr(jax.jit(jtr.optimizer.init)(params), lr)  # one program, not one per leaf
    acc = jnp.zeros((4,), jnp.float32)
    ema = (jnp.asarray(0.0, jnp.float32), jnp.asarray(0.0, jnp.float32))
    port = create_model(args, device="cpu")
    port.module.load_state_dict(state_dict_from_jax(args, params))
    new_params, _, acc, ly, lf = _run_jitted(jtr._train_step_impl, params, opt_state, acc, jb, *ema)
    ptr = Trainer(port, h)
    pacc = torch.zeros(4)
    pema = ptr._train_step(pb, pacc, torch.zeros(()), torch.zeros(()))
    np.testing.assert_allclose([float(v) for v in pema], [float(ly), float(lf)], rtol=1e-5)
    np.testing.assert_allclose(pacc.numpy(), np.asarray(acc), rtol=1e-5)
    assert float(acc[1]) > 0 and float(acc[2]) > 0  # both loss terms were live
    want = state_dict_from_jax(args, jax.tree_util.tree_map(np.asarray, new_params))
    got = ptr.model.module.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)


def test_cli_trains_the_transformer_with_fused_attention(tmp_path):
    trainer, test_metrics = cli.main([
        "--device", "cpu", "--model", "transformer", "--embedding-dimension", "32", "--num-layers", "1",
        "--num-heads", "4", "--num-rbf", "8", "--max-num-neighbors", "16", "--cutoff-upper", "3.0",
        "--derivative", "true", "--batch-size", "4", "--train-size", "8", "--val-size", "4",
        "--test-size", "4", "--dataset", "DummyDataset", "--dataset-root", str(tmp_path),
        "--num-workers", "0", "--num-epochs", "1", "--lr", "1e-3", "--bf16-messages", "true",
        "--fused-attention", "true", "--log-dir", str(tmp_path / "logs"),
    ])
    rep = trainer.model.module.representation_model
    assert trainer.state.global_step == 2 and trainer._fused
    assert type(rep).__name__ == "TorchMD_T" and rep.attention_layers[0].fused_attention
    assert all(v == v for v in test_metrics.values())


def test_configuration_errors():
    with pytest.raises(ValueError, match="bf16_messages"):
        create_model(dict(ARGS, fused_attention=True), device="cpu")
    with pytest.raises(ValueError, match="distance_influence"):
        create_model(dict(ARGS, distance_influence="queries"), device="cpu")
    # every head builds (ported), and an unknown name still raises
    head = create_model(dict(ARGS, output_model="DipoleMoment"), device="cpu").module.output_model
    assert type(head).__name__ == "DipoleMoment"
    with pytest.raises(KeyError):
        create_model(dict(ARGS, output_model="Quadrupole"), device="cpu")
