"""The port's output heads held against the JAX package's, on the CPU.

- Each of the seven heads alone (``pre_reduce``, the segment sum,
  ``post_reduce``) on the same random features, atom types and positions of
  a padded batch (a trash segment), with the weights carried by the map
  ``state_dict_from_jax`` uses for heads: values and the gradients to the
  features and positions, f64 at rtol 1e-10 and f32 at rtol 1e-5 (the same
  formulas; only the order of sums differs).
- Every head on every model of ``tests/test_model.py`` (the equivariant
  heads on ET, the others on the graph network, the Transformer and
  TensorNet), whole models through ``state_dict_from_jax`` in f64 and f32
  (the same tolerances, of the largest value): energies, and on ET the
  dipole's forces and the dipole with an atom filter.  One JAX program per
  model evaluates all its heads: the representation's gradients are held
  to JAX in each model's own test file.
- ``_center_of_mass`` with a trash segment and with an atom filter that
  empties a molecule: values and gradients, finite where a segment has no
  mass.
- The priors dropped with a warning where a head takes none.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules
from torchmdnet_tpu.models import output_heads as jax_heads
from torchmdnet_tpu.models.potential import create_model as jax_create_model
from torchmdnet_tpu.ops.segment import segment_reduce as jax_segment_reduce
from torchmdnet_tpu_torch import create_model, state_dict_from_jax
from torchmdnet_tpu_torch.data.batch import pad_molecules
from torchmdnet_tpu_torch.models import output_heads
from torchmdnet_tpu_torch.ops.segment import segment_reduce
from torchmdnet_tpu_torch.tools.from_jax import _head_and_priors

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
H = 16
BASE = dict(
    embedding_dimension=H, num_layers=1, num_rbf=4, rbf_type="expnorm", trainable_rbf=False,
    activation="silu", attn_activation="silu", neighbor_embedding=False, num_heads=2,
    distance_influence="both", cutoff_lower=0.0, cutoff_upper=3.0, max_z=100, max_num_neighbors=12,
    derivative=False, prior_model=None, reduce_op="add", atom_filter=-1, aggr="add",
    equivariance_invariance_group="O(3)",
)
EQUIVARIANT = ("EquivariantScalar", "EquivariantDipoleMoment", "EquivariantElectronicSpatialExtent",
               "EquivariantVectorOutput")
HEADS = ("Scalar", "DipoleMoment", "ElectronicSpatialExtent") + EQUIVARIANT
# the heads test_model.py gives each model (ET's factory prefixes "Equivariant")
MODEL_HEADS = {
    "graph-network": ("Scalar", "DipoleMoment", "ElectronicSpatialExtent"),
    "transformer": ("Scalar", "DipoleMoment", "ElectronicSpatialExtent"),
    "equivariant-transformer": ("Scalar", "DipoleMoment", "ElectronicSpatialExtent", "EquivariantVectorOutput"),
    "tensornet": ("Scalar", "DipoleMoment", "ElectronicSpatialExtent"),
}
TOL = {64: 1e-10, 32: 1e-5}
N_ATOMS, M = 20, 3  # molecules of 8, 7 and 3 atoms, two padding atoms


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def _draw(tree, seed):
    """Random weights in a parameter tree (f32 whatever the precision)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        scale = 0.3 if path[-1].key == "bias" else leaf.shape[0] ** -0.5
        return rng.normal(scale=scale, size=leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _features(precision, equivariant):
    """(x (N, H), v (N, 3, H) or None, z, pos, batch ids, loss weights) in
    numpy; padding atoms have z 0 and the trash id M."""
    fdt = np.float64 if precision == 64 else np.float32
    rng = np.random.default_rng(7)
    ids = np.repeat(np.arange(M + 1), (8, 7, 3, N_ATOMS - 18))
    z = np.where(ids < M, rng.integers(1, 20, N_ATOMS), 0)
    pos = rng.uniform(-2.0, 3.0, (N_ATOMS, 3)).astype(fdt)
    x = rng.normal(size=(N_ATOMS, H)).astype(fdt)
    v = rng.normal(size=(N_ATOMS, 3, H)).astype(fdt) if equivariant else None
    return x, v, z, pos, ids, rng.normal(size=(M, 3)).astype(fdt)


@functools.lru_cache(maxsize=None)
def _jax_heads(precision):
    """Every JAX head's weights and (y, grads), from one compiled program."""
    dtype = jnp.float64 if precision == 64 else jnp.float32
    heads = {name: jax_heads.head_class_mapping[name](hidden_channels=H, activation="silu", reduce_op="sum",
                                                      dtype=dtype) for name in HEADS}
    inputs = {name: _features(precision, name in EQUIVARIANT) for name in HEADS}
    params = {}
    for i, (name, head) in enumerate(heads.items()):
        x, v, z, pos, ids, _ = inputs[name]
        shapes = jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0), x, v, z, pos, ids, method=head.pre_reduce))
        params[name] = _draw(shapes["params"], seed=3 + i)

    def fn(params, inputs):
        out = {}
        for name, head in heads.items():
            _, _, z, _, ids, w = inputs[name]

            def loss(p, x, v, pos):
                y = head.apply({"params": p}, x, v, z, pos, ids, method=head.pre_reduce)
                y = jax_segment_reduce(y, ids, M + 1, "sum")[:M]
                y = head.apply({"params": p}, y, method=head.post_reduce)
                return (y * w[:, : y.shape[1]]).sum(), y

            x, v, _, pos, _, _ = inputs[name]
            (_, y), grads = jax.value_and_grad(loss, argnums=(1, 2, 3), has_aux=True)(params[name], x, v, pos)
            out[name] = (y, grads)
        return out

    return params, _compile(fn, params, inputs)(params, inputs)


@pytest.mark.parametrize("precision", [64, 32])
@pytest.mark.parametrize("name", HEADS)
def test_head_matches_jax(name, precision):
    params, out = _jax_heads(precision)
    params, (y_ref, grads_ref) = params[name], out[name]
    x, v, z, pos, ids, w = _features(precision, name in EQUIVARIANT)

    sd = {}
    _head_and_priors(sd, {"head": params})
    head = output_heads.head_class_mapping[name](H, "silu", generator=torch.Generator().manual_seed(0))
    head.load_state_dict({k[len("output_model."):]: t for k, t in sd.items()})
    head.to(torch.float64 if precision == 64 else torch.float32)
    tx = torch.tensor(x, requires_grad=True)
    tv = None if v is None else torch.tensor(v, requires_grad=True)
    tpos = torch.tensor(pos, requires_grad=True)
    tids = torch.as_tensor(ids)
    y = head.pre_reduce(tx, tv, torch.as_tensor(z), tpos, tids)
    y = head.post_reduce(segment_reduce(y, tids, M + 1, "sum")[:M])
    leaves = [t for t in (tx, tv, tpos) if t is not None]
    grads = torch.autograd.grad((y * torch.as_tensor(w)[:, : y.shape[1]]).sum(), leaves, allow_unused=True)
    # positions reach only the heads about the center of mass
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]

    assert head.allow_prior_model == (name in ("Scalar", "EquivariantScalar"))
    tol = TOL[precision]
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=tol, atol=tol)
    grads_ref = [g for g in grads_ref if g is not None]
    assert len(grads) == len(grads_ref) and np.abs(np.asarray(grads_ref[0])).max() > 1e-3
    for got, want in zip(grads, grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _mols():
    rng = np.random.default_rng(0)
    return [{"z": rng.integers(1, 10, n), "pos": rng.uniform(0.0, 5.0, (n, 3))} for n in (9, 6)]


@pytest.mark.parametrize("precision", [64, 32])
@pytest.mark.parametrize("model", list(MODEL_HEADS))
def test_every_head_on_every_model(model, precision):
    """Heads with the same keys share one set of weights (Scalar's lin1/lin2
    for the dipole and spatial-extent heads, EquivariantScalar's blocks for
    the equivariant dipole and vector heads), and one JAX program evaluates
    all of a model's heads."""
    heads = MODEL_HEADS[model]
    fdt = np.float64 if precision == 64 else np.float32
    args = dict(BASE, model=model, precision=precision)
    jb = jax_pad_molecules(_mols(), num_atoms=16, num_mol=2, float_dtype=fdt)
    jms = {h: jax_create_model(dict(args, output_model=h)) for h in heads}
    # the weights of each parameter layout, drawn once
    params, layout = {}, {}
    for h, jm in jms.items():
        layout[h] = "block" if hasattr(jm.module.head, "_blocks") else "lin"
        if layout[h] not in params:
            shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb)
            params[layout[h]] = _draw(shapes, seed=len(params) + 1)
    et = model == "equivariant-transformer"
    filtered = jax_create_model(dict(args, output_model="DipoleMoment", atom_filter=1)) if et else None

    def fn(params, batch):
        out = {h: jm.energy(params[layout[h]], batch) for h, jm in jms.items()}
        if et:
            dipole = params[layout["DipoleMoment"]]
            out["forces"] = jms["DipoleMoment"].energy_and_forces(dipole, batch)[1]
            out["filtered"] = filtered.energy(dipole, batch)
        return out

    ref = _compile(fn, params, jb)(params, jb)
    pb = pad_molecules(_mols(), num_atoms=16, num_mol=2, float_dtype=fdt)
    tol = TOL[precision]

    def check(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol * np.abs(want).max())

    for h in heads:
        pm = create_model(dict(args, output_model=h), device="cpu")
        # the fixed RBF shape constants stay the port's buffers
        sd = {**pm.module.state_dict(), **state_dict_from_jax(args, params[layout[h]])}
        pm.module.load_state_dict(sd)
        y = pm.energy(pb)
        assert y.shape == ((2, 3) if h == "EquivariantVectorOutput" else (2, 1))
        assert y.dtype == (torch.float64 if precision == 64 else torch.float32)
        check(y, ref[h])
        if et and h == "DipoleMoment":
            assert type(pm.module.output_model).__name__ == "EquivariantDipoleMoment"
            _, forces = pm.energy_and_forces(pb)
            assert np.abs(np.asarray(ref["forces"])).max() > 1e-3
            check(forces, ref["forces"])
            pf = create_model(dict(args, output_model=h, atom_filter=1), device="cpu")
            pf.module.load_state_dict(sd)
            check(pf.energy(pb), ref["filtered"])


@functools.lru_cache(maxsize=None)
def _jax_center_of_mass(n):
    def fn(z, pos, ids, w):
        def loss(pos):
            c = jax_heads._center_of_mass(z, pos, ids, n + 1)
            return (c * w).sum(), c

        (_, c), g = jax.value_and_grad(loss, has_aux=True)(pos)
        return c, g

    z, pos, ids, w = _com_inputs("trash")
    return _compile(fn, z, pos, ids, w)


def _com_inputs(case):
    """A padded batch of 3 molecules (trash id 3); "filter" sends molecule
    1's atoms and two of molecule 0's to the trash, as an atom filter does."""
    rng = np.random.default_rng(5)
    ids = np.repeat(np.arange(4), (6, 4, 5, 3)).astype(np.int32)
    z = np.where(ids < 3, rng.integers(1, 30, 18), 0).astype(np.int32)
    if case == "filter":
        ids = np.where((ids == 1) | (np.arange(18) < 2), 3, ids).astype(np.int32)
    return z, rng.uniform(-3.0, 3.0, (18, 3)), ids, rng.normal(size=(18, 3))


@pytest.mark.parametrize("case", ["trash", "filter"])
def test_center_of_mass_matches_jax(case):
    z, pos, ids, w = _com_inputs(case)
    c_ref, g_ref = _jax_center_of_mass(len(z))(z, pos, ids, w)
    masses = output_heads.DipoleMoment(H, generator=torch.Generator()).atomic_mass
    tpos = torch.tensor(pos, requires_grad=True)
    tids = torch.as_tensor(ids).long()
    c = output_heads._center_of_mass(masses, torch.as_tensor(z).long(), tpos, tids, len(z) + 1)
    (g,) = torch.autograd.grad((c * torch.as_tensor(w)).sum(), tpos)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(c_ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-12, atol=1e-12)
    # a segment without atoms (molecule 1 under the filter) divides nothing:
    # values and gradients stay finite
    assert (case == "filter") == bool((tids != 1).all())
    assert torch.isfinite(c).all() and torch.isfinite(g).all()


@pytest.mark.parametrize("head", ["DipoleMoment", "ElectronicSpatialExtent", "EquivariantVectorOutput"])
def test_priors_dropped_with_a_warning(head):
    model = "equivariant-transformer" if head == "EquivariantVectorOutput" else "graph-network"
    args = dict(BASE, model=model, output_model=head, prior_model={"Atomref": {"max_z": 100}})
    for build in (lambda: jax_create_model(args).module.priors,
                  lambda: list(create_model(args, device="cpu").module.priors)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert not build()
        assert any("does not allow prior" in str(w.message) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(create_model(dict(args, output_model="Scalar"), device="cpu").module.priors) == 1
