"""The whole port slice held against the JAX package, on the CPU.

A small ET (2 layers, 32 channels, 4 heads, 8 RBFs, K = 8, NeighborEmbedding,
EquivariantScalar head) gets random weights in the JAX model's parameter tree
on a padded 2-molecule batch; they are carried into the port by
``state_dict_from_jax``.  Energies
and forces then go through both ``Potential.energy_and_forces``:

- f64: rtol 1e-9 (same formulas; only the order of sums differs);
- f32: rtol 1e-5, forces atol 1e-5 (f32 rounding through 2 layers);
- bf16 messages: the port's fused path (its plain version on the CPU) against
  JAX's bf16 composable path.  Both round every edge intermediate to bf16
  (2^-8 relative) but at different points, so they agree to bf16 accuracy:
  energies rtol 2e-2, forces atol 4e-2 of the largest force, the tolerance
  tests/test_et_fused.py uses for the same two paths inside JAX.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules
from torchmdnet_tpu.models.potential import create_model as jax_create_model
from torchmdnet_tpu.ops.rbf import ExpNormalSmearing
from torchmdnet_tpu_torch import External, create_model, state_dict_from_jax
from torchmdnet_tpu_torch.data.batch import pad_molecules

ARGS = dict(
    model="equivariant-transformer", embedding_dimension=32, num_layers=2, num_rbf=8,
    rbf_type="expnorm", trainable_rbf=True, activation="silu", attn_activation="silu",
    neighbor_embedding=True, num_heads=4, distance_influence="both", cutoff_lower=0.0,
    cutoff_upper=3.0, max_z=100, max_num_neighbors=8, derivative=True,
    output_model="Scalar", prior_model=None, reduce_op="add", atom_filter=-1,
)


def _mols(float_dtype):
    rng = np.random.default_rng(0)
    return [
        {"z": rng.integers(1, 10, n), "pos": rng.uniform(0.0, 7.0, (n, 3)).astype(float_dtype)}
        for n in (14, 9)
    ]


# these tiny programs run once: compile them with LLVM's cheap pipeline
# (numerics are unchanged; compile time halves)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _run_jitted(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """JAX weights in the JAX model's parameter tree, drawn once with numpy
    (float32 whatever the precision): shapes from tracing ``init``, values
    random at the init scales, with nonzero biases so that every tensor of
    the map is exercised; the RBF shape constants keep their initial values."""
    jb = jax_pad_molecules(_mols(np.float32), num_atoms=28, num_mol=2)
    jm = jax_create_model(dict(ARGS, precision=32))
    jm.neighbors(jb).raise_on_overflow("test")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb)
    rbf = ExpNormalSmearing(
        ARGS["cutoff_lower"], ARGS["cutoff_upper"], ARGS["num_rbf"], buffer_dtype=np.float32
    )
    means, betas = (np.asarray(a) for a in rbf._initial_params())
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("means", "betas"):
            return means if name == "means" else betas
        scale = {"scale": 0.1, "bias": 0.1, "embedding": 1.0}.get(name, leaf.shape[0] ** -0.5)
        value = rng.normal(scale=scale, size=leaf.shape) + (1.0 if name == "scale" else 0.0)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(precision, **overrides):
    """(port Potential with the JAX weights, port batch)."""
    fdt = np.float64 if precision == 64 else np.float32
    args = dict(ARGS, precision=precision, **overrides)
    pm = create_model(args, device="cpu")
    pm.module.load_state_dict(state_dict_from_jax(args, _jax_params()))
    return pm, pad_molecules(_mols(fdt), num_atoms=28, num_mol=2, float_dtype=fdt)


def _jax_energy_and_forces(precision, **overrides):
    fdt = np.float64 if precision == 64 else np.float32
    jb = jax_pad_molecules(_mols(fdt), num_atoms=28, num_mol=2, float_dtype=fdt)
    jm = jax_create_model(dict(ARGS, precision=precision, **overrides))
    return _run_jitted(jm.energy_and_forces, _jax_params(), jb)


@pytest.mark.parametrize("precision,rtol,atol", [(64, 1e-9, 1e-12), (32, 1e-5, 1e-5)])
def test_energy_and_forces_match_jax(precision, rtol, atol):
    y_ref, f_ref = _jax_energy_and_forces(precision)
    pm, pb = _port(precision)
    y, f = pm.energy_and_forces(pb)
    assert y.dtype == (torch.float64 if precision == 64 else torch.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=rtol, atol=atol)
    assert np.abs(np.asarray(f_ref)).max() > 1e-3  # the forces are not trivially zero
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=rtol, atol=atol)


def test_fused_bf16_matches_jax_bf16_composable():
    y_ref, f_ref = _jax_energy_and_forces(32, bf16_messages=True)
    fused, pb = _port(32, bf16_messages=True, fused_attention=True)
    y, f = fused.energy_and_forces(pb)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-2, atol=2e-2)
    scale = np.abs(np.asarray(f_ref)).max()
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=4e-2 * scale)


def test_external_calculate_equals_energy_and_forces():
    pm, pb = _port(32)
    y, f = pm.energy_and_forces(pb)
    # one request: both molecules as replicas would need one atom count, so
    # serve the first molecule (14 atoms) alone
    mol = _mols(np.float32)[0]
    single = pad_molecules([mol], num_atoms=32)  # External pads to a multiple of 32
    y1, f1 = pm.energy_and_forces(single)
    ext = External((pm, pm.module.state_dict()), mol["z"][None], device="cpu")
    energy, forces = ext.calculate(mol["pos"])
    assert energy.shape == (1,) and forces.shape == (1, 14, 3)
    torch.testing.assert_close(energy, y1.reshape(1), rtol=0, atol=0)
    torch.testing.assert_close(forces, f1[:14].reshape(1, 14, 3), rtol=0, atol=0)
    # the batched evaluation of the same molecule agrees too
    torch.testing.assert_close(f1[:14], f[:14], rtol=1e-5, atol=1e-6)


def test_entry_points_never_fall_back_to_the_cpu():
    # without a GPU and with no device named, the entry points raise
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to fall back from")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(dict(ARGS, precision=32))
    pm = create_model(dict(ARGS, precision=32), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        External((pm, None), np.ones((1, 3), np.int64))


def test_configuration_errors():
    with pytest.raises(ValueError, match="bf16_messages"):
        create_model(dict(ARGS, fused_attention=True), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(dict(ARGS, model="tensornet"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(dict(ARGS, prior_model="ZBL"), device="cpu")
