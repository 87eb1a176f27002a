"""The PyTorch port's basic ops held against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both.  Float ops are
compared in f64 at 1e-12: both sides evaluate the same formulas, so only the
last bits (operation order, libm) may differ.  Neighbor lists are integers
and must be bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules
from torchmdnet_tpu.ops import activations as j_act
from torchmdnet_tpu.ops import cutoff as j_cut
from torchmdnet_tpu.ops import neighbors as j_nb
from torchmdnet_tpu.ops import rbf as j_rbf
from torchmdnet_tpu.ops import segment as j_seg
from torchmdnet_tpu_torch.data.batch import pad_molecules
from torchmdnet_tpu_torch.ops import activations, cutoff, neighbors, rbf, segment

TOL = 1e-12  # f64 on both sides


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(
        port.detach().numpy() if isinstance(port, torch.Tensor) else port,
        np.asarray(ref), rtol=tol, atol=tol,
    )


@pytest.mark.parametrize("lower", [0.0, 1.0])
def test_cosine_cutoff(lower):
    d = np.random.default_rng(0).uniform(0.0, 6.0, 200)
    _close(cutoff.cosine_cutoff(torch.as_tensor(d), lower, 5.0),
           j_cut.cosine_cutoff(jnp.asarray(d), lower, 5.0))


@pytest.mark.parametrize("name", ["ssp", "silu", "tanh", "sigmoid"])
def test_activations(name):
    x = np.random.default_rng(1).normal(scale=6.0, size=200)
    _close(activations.act_fn_mapping[name](torch.as_tensor(x)),
           j_act.act_fn_mapping[name](jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["expnorm", "gauss"])
@pytest.mark.parametrize("trainable", [True, False])
def test_rbf(kind, trainable):
    dist = np.random.default_rng(2).uniform(0.0, 5.5, (7, 5))
    jmod = j_rbf.rbf_class_mapping[kind](
        0.0, 5.0, 16, trainable, dtype=jnp.float64, buffer_dtype=jnp.float32
    )
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(dist))
    ref = jmod.apply(params, jnp.asarray(dist))
    mod = rbf.rbf_class_mapping[kind](0.0, 5.0, 16, trainable, buffer_dtype=torch.float32)
    # the float32 shape constants are the JAX package's, bit for bit
    consts = dict(mod.named_parameters()) if trainable else dict(mod.named_buffers())
    jconsts = jmod.apply(params, method=lambda m: m._initial_params())
    for value, jvalue in zip(consts.values(), jconsts):
        assert value.dtype == torch.float32
        np.testing.assert_array_equal(value.detach().numpy(), np.asarray(jvalue))
    _close(mod.to(torch.float64)(torch.as_tensor(dist)), ref)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_segment_reduce(op):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(30, 4))
    ids = np.sort(rng.integers(0, 5, 30)).astype(np.int32)
    _close(segment.segment_reduce(torch.as_tensor(x), torch.as_tensor(ids), 6, op),
           j_seg.segment_reduce(jnp.asarray(x), jnp.asarray(ids), 6, op))


def _mols(seed, side):
    rng = np.random.default_rng(seed)
    return [
        {"z": rng.integers(1, 9, n), "pos": rng.uniform(0.0, side, (n, 3)).astype(np.float32)}
        for n in (21, 13)
    ]


_BOXES = {
    "none": None,
    "rect": np.diag([11.0, 12.0, 13.0]),
    "triclinic": np.array([[11.0, 0.0, 0.0], [1.5, 12.0, 0.0], [-2.0, 1.0, 13.0]]),
}


@pytest.mark.parametrize("box", list(_BOXES))
def test_brute_neighbor_list_bitwise(box):
    b = _BOXES[box]
    mols = _mols(4, 12.0 if b is not None else 7.0)
    jb = jax_pad_molecules(mols, num_atoms=40, num_mol=2)
    pb = pad_molecules(mols, num_atoms=40, num_mol=2)
    kw = dict(k=12, cutoff_lower=0.5, cutoff_upper=4.0, loop=True)
    ref = j_nb.neighbor_list(
        jb.pos, jb.batch, jb.atom_mask, box=None if b is None else jnp.asarray(b, jnp.float32),
        strategy="brute", **kw,
    )
    out = neighbors.neighbor_list(
        pb.pos, pb.batch, pb.atom_mask, box=None if b is None else torch.as_tensor(b, dtype=torch.float32),
        strategy="auto", **kw,
    )
    assert int(np.asarray(ref.n_neighbors).max()) > 2  # the cutoff window is exercised
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(out.n_neighbors.numpy(), np.asarray(ref.n_neighbors))
    assert bool(out.overflow()) == bool(ref.overflow())


def _f64_list(seed=5):
    mols = _mols(seed, 8.0)
    for m in mols:
        m["pos"] = m["pos"].astype(np.float64)
    pb = pad_molecules(mols, num_atoms=40, num_mol=2, float_dtype=np.float64)
    nbl = neighbors.neighbor_list(pb.pos, pb.batch, pb.atom_mask, k=16, cutoff_upper=4.0, loop=True)
    nbl.raise_on_overflow("test")
    return pb, nbl


def test_ell_gather_and_transpose_sum():
    pb, nbl = _f64_list()
    idx = nbl.idx
    rng = np.random.default_rng(6)
    x = rng.normal(size=(40, 5))
    ct = rng.normal(size=tuple(idx.shape) + (5,))
    @jax.jit
    def ref_fn(a, c):
        out, vjp = jax.vjp(lambda a: j_nb.ell_gather(a, jnp.asarray(idx.numpy())), a)
        return out, vjp(c)[0]

    out, ref_t = ref_fn(jnp.asarray(x), jnp.asarray(ct))

    xt = torch.as_tensor(x).requires_grad_(True)
    got = neighbors.ell_gather(xt, idx, nbl.transpose_perm)
    _close(got, out)
    (g1,) = torch.autograd.grad(got, xt, torch.as_tensor(ct))
    _close(g1, ref_t)
    _close(neighbors.ell_transpose_sum(torch.as_tensor(ct), idx),
           j_nb.ell_transpose_sum(jnp.asarray(ct), jnp.asarray(idx.numpy())))
    # the transpose is scatter-free and ordered: repeat runs are bitwise equal
    (g2,) = torch.autograd.grad(neighbors.ell_gather(xt, idx), xt, torch.as_tensor(ct))
    assert torch.equal(g1, g2)


@pytest.mark.parametrize("box", ["none", "triclinic"])
def test_edge_geometry_and_its_gradient(box):
    pb, nbl = _f64_list(seed=7)
    b = _BOXES[box]
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.as_tensor(b)
    jnbl = j_nb.NeighborList(
        idx=jnp.asarray(nbl.idx.numpy()), mask=jnp.asarray(nbl.mask.numpy()),
        n_neighbors=jnp.asarray(nbl.n_neighbors.numpy()), self_loops=True,
    )
    w = np.random.default_rng(8).normal(size=tuple(nbl.idx.shape))

    def jloss(p):
        (dx, dy, dz), dist = j_nb.edge_geometry_components(p, jnbl, box=jb)
        return jnp.sum(w * (dist + dx * dy - dz)), dist

    (jl, jdist), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(pb.pos.numpy()))
    pos = pb.pos.clone().requires_grad_(True)
    (dx, dy, dz), dist = neighbors.edge_geometry_components(pos, nbl, box=tb)
    loss = (torch.as_tensor(w) * (dist + dx * dy - dz)).sum()
    (g,) = torch.autograd.grad(loss, pos)
    _close(dist, jdist)
    _close(g, jg)


def test_safe_norm_and_minimum_image():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(6, 3, 4))
    x[0] = 0.0
    _close(neighbors.safe_norm(torch.as_tensor(x), dim=-2), j_nb.safe_norm(jnp.asarray(x), axis=-2))
    d = rng.uniform(-20, 20, (10, 3))
    b = _BOXES["triclinic"]
    _close(neighbors.minimum_image(torch.as_tensor(d), torch.as_tensor(b)),
           j_nb.minimum_image(jnp.asarray(d), jnp.asarray(b)))


def test_refine_and_without_self_loops_match_jax():
    pb, nbl = _f64_list(seed=10)
    jnbl = j_nb.NeighborList(
        idx=jnp.asarray(nbl.idx.numpy()), mask=jnp.asarray(nbl.mask.numpy()),
        n_neighbors=jnp.asarray(nbl.n_neighbors.numpy()), self_loops=True,
    )
    ref = jnbl.refine(jnp.asarray(pb.pos.numpy()), 1.0, 3.0)
    out = nbl.refine(pb.pos, 1.0, 3.0)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(
        nbl.without_self_loops().idx.numpy(), np.asarray(jnbl.without_self_loops().idx)
    )


def test_cell_strategy_points_to_the_roadmap():
    # the cell strategy is ported (ROADMAP.md slice C) and builds lists; what
    # its JAX counterpart adds on top and the port does not have yet, the
    # gather plan of kernels #4/#5, points to the ROADMAP
    from torchmdnet_tpu_torch import create_model

    pos = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [9.0, 0.0, 0.0], [9.5, 0.0, 0.0]])
    nbl = neighbors.neighbor_list(pos, k=2, cutoff_upper=2.0, strategy="cell")
    assert nbl.idx.tolist() == [[1, 0], [0, 1], [3, 2], [2, 3]]
    assert not bool(nbl.cell_overflow)
    with pytest.raises(ValueError, match="Unknown neighbor strategy"):
        neighbors.neighbor_list(pos, k=2, strategy="cells")
    model = create_model(dict(
        model="equivariant-transformer", embedding_dimension=8, num_layers=1, num_rbf=4,
        rbf_type="expnorm", trainable_rbf=False, activation="silu", max_z=10,
        max_num_neighbors=2, cutoff_lower=0.0, cutoff_upper=2.0, num_heads=1,
    ), device="cpu")
    batch = pad_molecules([{"z": np.ones(4, np.int64), "pos": pos.numpy()}], num_atoms=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.neighbors(batch, gather_plan=True)


def test_asymmetric_list_raises():
    idx = torch.tensor([[0, 1], [1, 1], [2, 0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="not symmetric"):
        neighbors.transpose_perm(idx)
