"""The port's MD driver and serving evaluator, held against the JAX package's, on the CPU.

A tiny ET (1 layer, 16 channels, 2 heads, 8 RBFs, NeighborEmbedding) gets
random weights in the JAX model's parameter tree, carried into the port by
``state_dict_from_jax``; 12 atoms padded to 16.

- NVE parity: the same initial velocities (numpy) go into both
  ``Simulation``s, skin 1.0 A rebuilt every 5 steps through the cell list,
  10 steps, in f64.  Positions and energies agree at rtol 1e-9: the same
  formulas, and the port carries the end-of-step forces into the next skin
  chunk where JAX evaluates them anew on the new list (the same pairs,
  summed in another order), so only the last bits differ.
- The port's skin path against its per-step rebuild (f64, rtol 1e-9: the
  same pairs in lists of other widths, summed in another order).
- Staleness, the Langevin thermostat (padding never moves; one seed, one
  trajectory, bitwise) and ``optimize()`` with skin against
  ``energy_and_forces`` (f64, rtol 1e-9 for the same reason).
  The Langevin noise cannot match ``jax.random``, so only NVE meets JAX.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.data.batch import pad_molecules as j_pad_molecules
from torchmdnet_tpu.md import Simulation as JSimulation
from torchmdnet_tpu.models.potential import create_model as j_create_model
from torchmdnet_tpu.ops.rbf import ExpNormalSmearing
from torchmdnet_tpu_torch import Simulation, create_model, optimize, state_dict_from_jax
from torchmdnet_tpu_torch.data.batch import pad_molecules

ARGS = dict(
    model="equivariant-transformer", embedding_dimension=16, num_layers=1, num_rbf=8,
    rbf_type="expnorm", trainable_rbf=True, activation="silu", attn_activation="silu",
    neighbor_embedding=True, num_heads=2, distance_influence="both", cutoff_lower=0.0,
    cutoff_upper=3.0, max_z=10, max_num_neighbors=16, derivative=True,
    output_model="Scalar", prior_model=None, reduce_op="add", atom_filter=-1, precision=64,
)
N_REAL, N_PAD = 12, 16
RTOL = 1e-9


def _mol():
    rng = np.random.default_rng(0)
    return {"z": rng.integers(1, 9, N_REAL), "pos": rng.uniform(0.0, 4.0, (N_REAL, 3))}


@functools.lru_cache(maxsize=None)
def _jax_params():
    """JAX weights in the JAX model's parameter tree, drawn once with numpy
    at the init scales (shapes from tracing ``init``), with nonzero biases;
    the RBF shape constants keep their initial values."""
    jb = j_pad_molecules([_mol()], num_atoms=N_PAD, num_mol=1, float_dtype=np.float64)
    shapes = jax.eval_shape(j_create_model(ARGS).init, jax.random.PRNGKey(0), jb)
    rbf = ExpNormalSmearing(ARGS["cutoff_lower"], ARGS["cutoff_upper"], ARGS["num_rbf"],
                            buffer_dtype=np.float32)
    means, betas = (np.asarray(a) for a in rbf._initial_params())
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("means", "betas"):
            return means if name == "means" else betas
        scale = {"scale": 0.1, "bias": 0.1, "embedding": 1.0}.get(name, leaf.shape[0] ** -0.5)
        return (rng.normal(scale=scale, size=leaf.shape) + (1.0 if name == "scale" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_model():
    model = create_model(ARGS, device="cpu")
    model.module.load_state_dict(state_dict_from_jax(ARGS, _jax_params()))
    return model


def _batch():
    return pad_molecules([_mol()], num_atoms=N_PAD, float_dtype=np.float64)


def _sim(**kw):
    return Simulation(_port_model(), _batch(), device="cpu", timestep_fs=0.5, **kw)


def test_nve_matches_jax_simulation():
    kw = dict(timestep_fs=0.5, neighbor_skin=1.0, rebuild_every=5, neighbor_strategy="cell")
    rng = np.random.default_rng(2)
    v0 = np.zeros((N_PAD, 3))
    v0[:N_REAL] = 0.01 * rng.standard_normal((N_REAL, 3))

    jb = j_pad_molecules([_mol()], num_atoms=N_PAD, num_mol=1, float_dtype=np.float64)
    jsim = JSimulation(j_create_model(ARGS), _jax_params(), jb, **kw)
    jsim.state = jsim.state._replace(vel=jnp.asarray(v0))
    jsim.step(10)

    sim = Simulation(_port_model(), _batch(), device="cpu", **kw)
    sim.state = dataclasses.replace(sim.state, vel=torch.as_tensor(v0))
    sim.step(10)
    moved = np.abs(np.asarray(jsim.state.pos) - np.asarray(jb.pos)).max()
    assert moved > 1e-3  # the atoms moved
    np.testing.assert_allclose(sim.state.pos.numpy(), np.asarray(jsim.state.pos), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(sim.state.energy.numpy(), np.asarray(jsim.state.energy), rtol=RTOL)
    assert not bool(sim.state.stale) and not bool(jsim.state.stale)


def test_skin_matches_per_step_rebuild():
    ref, skin = _sim(), _sim(neighbor_skin=1.0, rebuild_every=5)
    for s in (ref, skin):
        s.set_velocities_from_temperature(50.0)
        s.step(10)
    np.testing.assert_allclose(skin.state.pos.numpy(), ref.state.pos.numpy(), rtol=RTOL, atol=RTOL)
    assert not bool(skin.state.stale)


def test_staleness_detected():
    sim = _sim(neighbor_skin=1e-3, rebuild_every=10)
    sim.set_velocities_from_temperature(5000.0)
    sim.step(10)
    assert bool(sim.state.stale)


def test_langevin_moves_real_atoms_only_and_repeats():
    runs = []
    for _ in range(2):
        sim = _sim(friction_per_fs=0.1, temperature_K=300.0, neighbor_skin=1.0, rebuild_every=2, seed=3)
        p0 = sim.state.pos.clone()
        sim.step(5)
        runs.append(sim.state.pos)
    real = _batch().atom_mask
    assert not torch.allclose(p0[real], runs[0][real])
    assert torch.equal(p0[~real], runs[0][~real])
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("skin", [0.0, 1.0])
def test_optimize_matches_energy_and_forces(skin):
    model, batch = _port_model(), _batch()
    opt = optimize(model, batch, skin=skin, rebuild_every=3, device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(4):
        pos = batch.pos.clone()
        pos[:N_REAL] += torch.as_tensor(0.05 * rng.standard_normal((N_REAL, 3)))
        y, f = opt(pos)
        y_ref, f_ref = model.energy_and_forces(batch.replace(pos=pos))
        torch.testing.assert_close(y, y_ref, rtol=RTOL, atol=RTOL)
        torch.testing.assert_close(f, f_ref, rtol=RTOL, atol=RTOL)
    assert not opt.stale


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _sim(edge_partition=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _sim(neighbor_skin=1.0, neighbor_kwargs={"gather_plan": True})
    if not torch.cuda.is_available():  # entry points never fall back to the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Simulation(_port_model(), _batch())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            optimize(_port_model(), _batch())
