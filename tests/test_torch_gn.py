"""The port's graph network held against the JAX package's, on the CPU.

A small GN (2 layers, 16 channels, 8 trainable ExpNormal RBFs, K = 16,
Scalar head) gets random weights in the JAX model's parameter tree, drawn
from ``jax.eval_shape`` (no eager ``init``) and carried into the port by
``state_dict_from_jax``.  The batch holds a molecule of one atom, which has
no neighbors (max aggregates it to 0).  Energies and forces of the whole
``Potential`` through both ``energy_and_forces``, for add/mean/max, with and
without NeighborEmbedding, with and without a periodic box:

- f64: rtol 1e-9 (same formulas; only the order of sums differs);
- f32: rtol 1e-5, atol 1e-5 (f32 rounding through 2 layers).

Under ``bf16_messages`` against JAX's bf16 model: both round the edge MLP,
the filter and the message at the same points; they differ in the order of
f32 sums and in libm's last bits, each of which can flip one bf16 rounding
(2^-8 relative) of an edge value.  Energies agree to rtol 2e-3, forces to
3e-2 of the largest force (the tolerances chip_smoke.py holds the fused ET
path to against fp32).

On a list truncated at K (bench.py's max_num_neighbors=32 at protein
density), the forward equals JAX's and forces raise.  One Trainer step
equals JAX's ``_train_step_impl`` (f32, the composable path, 1e-5).  The
``remat`` flag leaves energies, forces and force-loss gradients unchanged
(f64) for GN, ET and TensorNet.  ``External`` takes a checkpoint path,
raises when the atom filter empties a molecule, and evaluates an
``output_transform`` string, as JAX's ``External`` does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.calculators import External as JaxExternal
from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules
from torchmdnet_tpu.models.potential import create_model as jax_create_model
from torchmdnet_tpu.train.trainer import Trainer as JaxTrainer
from torchmdnet_tpu_torch import External, create_model, state_dict_from_jax
from torchmdnet_tpu_torch.data.batch import pad_molecules
from torchmdnet_tpu_torch.scripts import train as cli
from torchmdnet_tpu_torch.train.checkpoints import save_checkpoint
from torchmdnet_tpu_torch.train.trainer import Trainer, masked_mse

ARGS = dict(
    model="graph-network", embedding_dimension=16, num_layers=2, num_rbf=8, rbf_type="expnorm",
    trainable_rbf=True, activation="silu", cutoff_lower=0.0, cutoff_upper=3.0, max_z=100,
    max_num_neighbors=16, derivative=True, output_model="Scalar", prior_model=None,
    reduce_op="add", atom_filter=-1, neighbor_embedding=True, aggr="add",
)
N_ATOMS = 28  # molecules of 14, 9 and 1 atoms
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


def _mols(float_dtype, scale=1.0):
    rng = np.random.default_rng(0)
    return [
        {"z": rng.integers(1, 10, n), "pos": (scale * rng.uniform(0.0, 5.0, (n, 3))).astype(float_dtype)}
        for n in (14, 9, 1)
    ]


def _run_jitted(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


@functools.lru_cache(maxsize=None)
def _jax_params(neighbor_embedding=True, precision=32):
    """Random weights in the JAX tree at the init scales (nonzero biases)."""
    fdt = np.float64 if precision == 64 else np.float32
    args = dict(ARGS, neighbor_embedding=neighbor_embedding, precision=precision)
    jb = jax_pad_molecules(_mols(fdt), num_atoms=N_ATOMS, num_mol=3, float_dtype=fdt)
    shapes = jax.eval_shape(jax_create_model(args).init, jax.random.PRNGKey(0), jb)
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("means", "betas"):  # near the ExpNormal initial values
            base = np.linspace(np.exp(-3.0), 1.0, leaf.shape[0]) if name == "means" else 16.0
            return (base * (1.0 + 0.1 * rng.normal(size=leaf.shape))).astype(fdt)
        scale = {"bias": 0.1, "embedding": 1.0}.get(name, leaf.shape[0] ** -0.5)
        return rng.normal(scale=scale, size=leaf.shape).astype(fdt)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(args, params):
    pm = create_model(args, device="cpu")
    pm.module.load_state_dict(state_dict_from_jax(args, params))
    return pm


def _batches(fdt, scale=1.0):
    mols = _mols(fdt, scale)
    return (jax_pad_molecules(mols, num_atoms=N_ATOMS, num_mol=3, float_dtype=fdt),
            pad_molecules(mols, num_atoms=N_ATOMS, num_mol=3, float_dtype=fdt))


@pytest.mark.parametrize("aggr,precision,neighbor_embedding,box", [
    ("add", 64, True, False), ("add", 32, False, True),
    ("mean", 64, False, True), ("mean", 32, True, False),
    ("max", 64, True, True), ("max", 32, False, False),
])
def test_energy_and_forces_match_jax(aggr, precision, neighbor_embedding, box):
    fdt = np.float64 if precision == 64 else np.float32
    rtol, atol = (1e-9, 1e-12) if precision == 64 else (1e-5, 1e-5)
    args = dict(ARGS, aggr=aggr, precision=precision, neighbor_embedding=neighbor_embedding)
    params = _jax_params(neighbor_embedding, precision)
    jb, pb = _batches(fdt)
    jm = jax_create_model(args)
    jbox = np.asarray(BOX, fdt) if box else None
    y_ref, f_ref = _run_jitted(lambda p, b: jm.energy_and_forces(p, b, box=jbox), params, jb)
    pm = _port(args, params)
    y, f = pm.energy_and_forces(pb, box=torch.as_tensor(BOX, dtype=pm.dtype) if box else None)
    assert y.dtype == (torch.float64 if precision == 64 else torch.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=rtol, atol=atol)
    assert np.abs(np.asarray(f_ref)).max() > 1e-3  # the forces are not trivially zero
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("aggr", ["add", "max"])
def test_bf16_messages_match_jax_bf16(aggr):
    args = dict(ARGS, aggr=aggr, precision=32, bf16_messages=True)
    params = _jax_params()
    jb, pb = _batches(np.float32)
    jm = jax_create_model(args)
    y_ref, f_ref = _run_jitted(lambda p, b: jm.energy_and_forces(p, b), params, jb)
    y, f = _port(args, params).energy_and_forces(pb)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-3)
    scale = np.abs(np.asarray(f_ref)).max()
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=3e-2 * scale)


def test_truncated_list_forward_matches_jax_and_forces_raise():
    """K = 4 truncates rows (the reference's radius_graph semantics): the
    energy is JAX's; forces through the list raise, as the port's transpose
    needs a symmetric list (ROADMAP.md section 3)."""
    args = dict(ARGS, precision=64, max_num_neighbors=4)
    params = _jax_params(True, 64)
    jb, pb = _batches(np.float64)
    jm = jax_create_model(args)
    assert bool(_run_jitted(jm.neighbors, jb).overflow())
    y_ref = _run_jitted(lambda p, b: jm.module.apply(p, b), params, jb)
    pm = _port(args, params)
    np.testing.assert_allclose(pm.energy(pb).detach().numpy(), np.asarray(y_ref), rtol=1e-9)
    with pytest.raises(ValueError, match="not symmetric"):
        pm.energy_and_forces(pb)


def test_state_dict_from_jax_maps_every_leaf():
    """Every JAX leaf lands on one port key of the same shape (transposed for
    kernels), and every key of the port's model gets one, under torchmd-net's
    names."""
    params = _jax_params()
    sd = state_dict_from_jax(dict(ARGS, precision=32), params)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(sd) == len(leaves)
    port = create_model(dict(ARGS, precision=32), device="cpu").module.state_dict()
    assert set(sd) == set(port)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    conv = params["params"]["representation"]["InteractionBlock_1"]["CFConv_0"]
    np.testing.assert_array_equal(sd["representation_model.interactions.1.conv.lin1.weight"].numpy(),
                                  np.asarray(conv["Dense_2"]["kernel"]).T)
    assert "representation_model.interactions.1.conv.lin1.bias" not in sd


def test_trainer_step_matches_jax(tmp_path):
    args = dict(ARGS, precision=32)
    h = dict(args, lr=1e-3, lr_warmup_steps=2, weight_decay=0.01, gradient_clipping=0.5,
             ema_alpha_y=0.7, ema_alpha_neg_dy=0.8, y_weight=0.2, neg_dy_weight=0.8, log_dir=str(tmp_path))
    rng = np.random.default_rng(3)
    mols = [dict(m, y=np.array([rng.normal()], np.float32), neg_dy=rng.normal(size=m["pos"].shape).astype(np.float32))
            for m in _mols(np.float32)]
    jb = jax_pad_molecules(mols, num_atoms=N_ATOMS, num_mol=3)
    pb = pad_molecules(mols, num_atoms=N_ATOMS, num_mol=3)
    jtr = JaxTrainer(jax_create_model(args), h)
    params = _jax_params()
    opt_state = jtr._set_lr(jax.jit(jtr.optimizer.init)(params), jtr._current_lr(type("S", (), {"lr": h["lr"], "global_step": 0})()))
    acc = jnp.zeros((4,), jnp.float32)
    ema = (jnp.asarray(0.0, jnp.float32), jnp.asarray(0.0, jnp.float32))
    params, _, acc, ly, lf = _run_jitted(jtr._train_step_impl, params, opt_state, acc, jb, *ema)
    ptr = Trainer(_port(args, _jax_params()), h)
    pacc = torch.zeros(4)
    pema = ptr._train_step(pb, pacc, torch.zeros(()), torch.zeros(()))
    np.testing.assert_allclose([float(v) for v in pema], [float(ly), float(lf)], rtol=1e-5)
    np.testing.assert_allclose(pacc.numpy(), np.asarray(acc), rtol=1e-5)
    assert float(acc[1]) > 0 and float(acc[2]) > 0  # both loss terms were live
    want = state_dict_from_jax(args, jax.tree_util.tree_map(np.asarray, params))
    got = ptr.model.module.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)


REMAT_MODELS = {
    "graph-network": dict(ARGS, aggr="max"),
    "equivariant-transformer": dict(ARGS, model="equivariant-transformer", num_heads=4,
                                    attn_activation="silu", distance_influence="both"),
    "tensornet": dict(ARGS, model="tensornet", trainable_rbf=False, neighbor_embedding=False,
                      equivariance_invariance_group="O(3)"),
}


@pytest.mark.parametrize("model", sorted(REMAT_MODELS))
def test_remat_leaves_energies_forces_and_gradients_unchanged(model):
    _, pb = _batches(np.float64)
    pb = pb.replace(y=torch.ones(3, 1, dtype=torch.float64), neg_dy=torch.ones(N_ATOMS, 3, dtype=torch.float64))
    out = {}
    for remat in (False, True):
        pm = create_model(dict(REMAT_MODELS[model], precision=64, remat=remat), device="cpu", seed=4)
        y, neg_dy = pm.energy_and_forces(pb, create_graph=True)
        loss = masked_mse(y, pb.y, pb.mol_mask) + masked_mse(neg_dy, pb.neg_dy, pb.atom_mask)
        named = dict(pm.module.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        out[remat] = [y, neg_dy] + [g for g in grads if g is not None]
    assert len(out[True]) == len(out[False]) > 2
    for a, b in zip(out[True], out[False]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_external_takes_a_checkpoint_path(tmp_path):
    args = dict(ARGS, precision=32)
    pm = _port(args, _jax_params())
    path = str(tmp_path / "gn.ckpt")
    save_checkpoint(path, pm.module.state_dict(), args)
    mol = _mols(np.float32)[0]
    e_ref, f_ref = External((pm, None), mol["z"][None], device="cpu").calculate(mol["pos"])
    e, f = External(path, mol["z"][None], device="cpu").calculate(mol["pos"])
    torch.testing.assert_close(e, e_ref, rtol=0, atol=0)
    torch.testing.assert_close(f, f_ref, rtol=0, atol=0)


def test_external_raises_when_the_atom_filter_empties_a_molecule():
    args = dict(ARGS, precision=32, atom_filter=1, derivative=False)  # keep only Z > 1
    all_h, mixed = np.ones((1, 6), np.int64), np.array([[1, 6, 1, 7, 1, 8]], np.int64)
    jm = jax_create_model(args)
    pm = create_model(args, device="cpu")
    for make in (lambda z: JaxExternal((jm, None), z), lambda z: External((pm, None), z, device="cpu")):
        with pytest.raises(ValueError, match="[Aa]tom filter"):
            make(all_h)
        make(mixed)


def test_external_evaluates_an_output_transform_string():
    source = "lambda energy, forces: (2.0 * energy, -forces)"
    args = dict(ARGS, precision=32)
    jext = JaxExternal((jax_create_model(args), None), np.ones((1, 3), np.int64), output_transform=source)
    pm = _port(args, _jax_params())
    mol = _mols(np.float32)[0]
    plain = External((pm, None), mol["z"][None], device="cpu")
    ext = External((pm, None), mol["z"][None], device="cpu", output_transform=source)
    (e0, f0), (e, f) = plain.calculate(mol["pos"]), ext.calculate(mol["pos"])
    je, jf = jext.output_transformer(e0.numpy(), f0.numpy())
    np.testing.assert_array_equal(e.numpy(), je)
    np.testing.assert_array_equal(f.numpy(), jf)
    torch.testing.assert_close(e, 2.0 * e0, rtol=0, atol=0)


def test_cli_trains_graph_network_with_aggr_and_remat(tmp_path):
    trainer, test_metrics = cli.main([
        "--device", "cpu", "--model", "graph-network", "--aggr", "max", "--remat", "true",
        "--embedding-dimension", "16", "--num-layers", "1", "--num-rbf", "8",
        "--max-num-neighbors", "16", "--cutoff-upper", "3.0", "--derivative", "true",
        "--batch-size", "4", "--train-size", "8", "--val-size", "4", "--test-size", "4",
        "--dataset", "DummyDataset", "--dataset-root", str(tmp_path), "--num-workers", "0",
        "--num-epochs", "1", "--lr", "1e-3", "--bf16-messages", "true",
        "--y-weight", "0.2", "--neg-dy-weight", "0.8", "--log-dir", str(tmp_path / "logs"),
    ])
    rep = trainer.model.module.representation_model
    assert trainer.state.global_step == 2 and rep.remat
    assert [block.aggr for block in rep.interactions] == ["max"]
    assert all(v == v for v in test_metrics.values())
