"""The port's TensorNet held against the JAX package's, on the CPU.

A small TensorNet (2 layers, 32 channels, 8 RBFs, K = 17, Scalar head) gets
random weights in the JAX model's parameter tree, drawn from
``jax.eval_shape`` (no eager ``init``) and carried into the port by
``state_dict_from_jax``.  Energies and forces of the whole ``Potential``
through both ``energy_and_forces``, for O(3) and SO(3), with and without a
periodic box:

- f64: rtol 1e-9 (same formulas; only the order of sums differs);
- f32: rtol 1e-5, forces atol 1e-5 (f32 rounding through 2 layers).

The fused path's plain version (the port's wrapper on CPU tensors) against
JAX's fused model, whose Pallas kernels run in interpret mode, at H = 128
(JAX's fused op takes H % 128 == 0) with one layer: both round the message
phase's intermediates to bf16 at the JAX kernel's points and differ in the
order of f32 sums and in where autograd rounds the gradients' bf16
intermediates, so energies agree to rtol 1e-3 and forces to 2e-2 of the
largest force.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules
from torchmdnet_tpu.data.batch import spatial_sort as jax_spatial_sort
from torchmdnet_tpu.models.potential import create_model as jax_create_model
from torchmdnet_tpu_torch import External, create_model, state_dict_from_jax
from torchmdnet_tpu_torch.data.batch import pad_molecules, spatial_sort

ARGS = dict(
    model="tensornet", embedding_dimension=32, num_layers=2, num_rbf=8, rbf_type="expnorm",
    trainable_rbf=False, activation="silu", cutoff_lower=0.0, cutoff_upper=3.0, max_z=100,
    max_num_neighbors=16, derivative=True, output_model="Scalar", prior_model=None,
    reduce_op="add", atom_filter=-1, equivariance_invariance_group="O(3)",
)
N_ATOMS = 28
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
        {"z": rng.integers(1, 10, n), "pos": rng.uniform(0.0, 5.0, (n, 3)).astype(float_dtype)}
        for n in (14, 9)
    ]


def _run_jitted(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def _draw(shapes, seed=1):
    """Random values at the init scales for a tree of shapes, nonzero biases
    and LayerNorm scales near 1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        scale = {"scale": 0.1, "bias": 0.1, "embedding": 1.0}.get(name, leaf.shape[0] ** -0.5)
        value = rng.normal(scale=scale, size=leaf.shape) + (1.0 if name == "scale" else 0.0)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _jax_params():
    jb = jax_pad_molecules(_mols(np.float32), num_atoms=N_ATOMS, num_mol=2)
    jm = jax_create_model(dict(ARGS, precision=32))
    _run_jitted(jm.neighbors, jb).raise_on_overflow("test")
    return _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb))


def _port(args, params, device="cpu"):
    pm = create_model(args, device=device)
    # the RBF's constants are buffers the port builds itself (trainable_rbf=False)
    missing, unexpected = pm.module.load_state_dict(state_dict_from_jax(args, params), strict=False)
    assert not unexpected and all(k.startswith("representation_model.distance_expansion.") for k in missing)
    return pm


@pytest.mark.parametrize("precision,rtol,atol", [(64, 1e-9, 1e-12), (32, 1e-5, 1e-5)])
@pytest.mark.parametrize("group,box", [("O(3)", False), ("SO(3)", True)])
def test_energy_and_forces_match_jax(precision, rtol, atol, group, box):
    fdt = np.float64 if precision == 64 else np.float32
    args = dict(ARGS, precision=precision, equivariance_invariance_group=group)
    jb = jax_pad_molecules(_mols(fdt), num_atoms=N_ATOMS, num_mol=2, float_dtype=fdt)
    jm = jax_create_model(args)
    jbox = np.asarray(BOX, fdt) if box else None
    y_ref, f_ref = _run_jitted(lambda p, b: jm.energy_and_forces(p, b, box=jbox), _jax_params(), jb)
    pm = _port(args, _jax_params())
    pb = pad_molecules(_mols(fdt), num_atoms=N_ATOMS, num_mol=2, float_dtype=fdt)
    y, f = pm.energy_and_forces(pb, box=torch.as_tensor(BOX, dtype=pm.dtype) if box else None)
    assert y.dtype == (torch.float64 if precision == 64 else torch.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=rtol, atol=atol)
    assert np.abs(np.asarray(f_ref)).max() > 1e-3  # the forces are not trivially zero
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=rtol, atol=atol)


def test_fused_plain_version_matches_jax_fused_kernels():
    h = 128
    args = dict(ARGS, embedding_dimension=h, num_layers=1, precision=32, bf16_messages=True,
                fused_message=True, cutoff_upper=4.5)
    mols = [{"z": m["z"], "pos": m["pos"] * 1.2} for m in _mols(np.float32)]
    jb, _ = jax_spatial_sort(jax_pad_molecules(mols, num_atoms=32, num_mol=2))
    jm = jax_create_model(args)
    # one compile of the list and its gather plan, not one per primitive
    nbl = _run_jitted(lambda b: jm.neighbors(b, gather_plan=True, plan_block_rows=8, plan_width=128), jb)
    nbl.raise_on_overflow("test")
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb), seed=2)
    y_ref, f_ref = _run_jitted(lambda p, b, nl: jm.energy_and_forces(p, b, nbl=nl), params, jb, nbl)
    pm = _port(args, params)
    pb, _ = spatial_sort(pad_molecules(mols, num_atoms=32, num_mol=2))
    np.testing.assert_array_equal(pb.z.numpy(), np.asarray(jb.z))
    y, f = pm.energy_and_forces(pb)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-3)
    scale = np.abs(np.asarray(f_ref)).max()
    assert scale > 1e-3
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=2e-2 * scale)


def test_state_dict_from_jax_maps_every_leaf():
    """Every JAX leaf lands on one port key of the same shape (transposed for
    kernels), and every key of the port's model gets one."""
    params = _jax_params()
    sd = state_dict_from_jax(ARGS, params)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(sd) == len(leaves)
    assert sorted(int(np.asarray(v).size) for v in leaves) == sorted(int(v.numel()) for v in sd.values())
    port = create_model(dict(ARGS, precision=32), device="cpu").module.state_dict()
    buffers = {k for k in port if k.startswith("representation_model.distance_expansion.")}
    assert set(sd) == set(port) - buffers
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    # the interaction filter keeps JAX's irrep-third column layout
    w = np.asarray(params["params"]["representation"]["Interaction_1"]["Dense_2"]["kernel"])
    np.testing.assert_array_equal(sd["representation_model.layers.1.linears_scalar.2.weight"].numpy(), w.T)


def test_external_calculate_equals_energy_and_forces():
    pm = _port(dict(ARGS, precision=32), _jax_params())
    mol = _mols(np.float32)[0]
    y1, f1 = pm.energy_and_forces(pad_molecules([mol], num_atoms=32))
    ext = External((pm, None), mol["z"][None], device="cpu")
    energy, forces = ext.calculate(mol["pos"])
    torch.testing.assert_close(energy, y1.reshape(1), rtol=0, atol=0)
    torch.testing.assert_close(forces, f1[:14].reshape(1, 14, 3), rtol=0, atol=0)


def test_configuration_errors():
    with pytest.raises(ValueError, match="bf16_messages"):
        create_model(dict(ARGS, fused_message=True), device="cpu")
    with pytest.raises(ValueError, match="equivariance group"):
        create_model(dict(ARGS, equivariance_invariance_group="E(3)"), device="cpu")
    # every head builds (ported), and an unknown name still raises
    head = create_model(dict(ARGS, output_model="DipoleMoment"), device="cpu").module.output_model
    assert type(head).__name__ == "DipoleMoment"
    with pytest.raises(KeyError):
        create_model(dict(ARGS, output_model="Quadrupole"), device="cpu")
