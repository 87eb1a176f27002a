"""The port's ELL gather and transpose-sum (kernels #4 and #5) held against
the JAX package's, on the CPU.

- The plain versions the wrappers run for CPU tensors (``gather_rows``,
  ``transpose_sum_rows``) against JAX's Pallas kernels ``onehot_gather`` and
  ``onehot_transpose_sum`` run in interpret mode on a block gather plan, bf16,
  F = 128 and 256: the gather bitwise (both copy rows), the transpose-sum
  within one bf16 ulp of each output (both add in f32 and round once, in
  other orders).
- ``ell_gather``'s grad-of-grad against JAX's ``ell_gather`` in f64 (1e-12)
  and in bf16 (one ulp), through the kernel wrappers at every order.
- A list truncated at its capacity (not symmetric): the forward runs and
  computes no transpose permutation; a gradient through it raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.ops import neighbors as j_nb
from torchmdnet_tpu.ops.pallas.onehot_gather import (
    make_block_gather_plan,
    onehot_gather,
    onehot_transpose_sum,
)
from torchmdnet_tpu_torch.ops import neighbors as nb
from torchmdnet_tpu_torch.ops.kernels import ell_gather as eg

N = 64
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit(fn, *args, **static):
    return jax.jit(fn, static_argnames=tuple(static)).lower(*args, **static).compile(
        compiler_options=FAST_COMPILE)(*args)


def _list(k=24, cutoff=3.0, seed=0):
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(0.0, 8.0, (N, 3)))
    return pos, nb.neighbor_list(pos, k=k, cutoff_upper=cutoff)


@pytest.fixture(scope="module")
def plan_list():
    """A symmetric list without self loops and JAX's gather plan for it."""
    _, nbl = _list()
    nbl.raise_on_overflow("test")
    plan = _jit(make_block_gather_plan, jnp.asarray(nbl.idx.numpy()), block_rows=8, width=128)
    assert int(plan.overflow) == 0 and int(plan.inv_overflow) == 0
    return nbl, plan


def _bf16(rng, *shape):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


def _j(t):  # bf16 torch -> bf16 jax, through exact f32
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _within_one_ulp(got, want):
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)  # bf16: 8 significant bits
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("f", [128, 256])
def test_plain_gather_equals_onehot_gather(plan_list, f):
    nbl, plan = plan_list
    x = _bf16(np.random.default_rng(f), N, f)
    want = _jit(lambda a, p: onehot_gather(a, p, interpret=True), _j(x), plan)
    got = eg.gather_rows(x, nbl.idx)
    assert got.dtype == torch.bfloat16 and got.shape == (N, nbl.k, f)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("f", [128, 256])
def test_plain_transpose_sum_within_one_ulp_of_onehot_transpose_sum(plan_list, f):
    nbl, plan = plan_list
    g = _bf16(np.random.default_rng(f + 1), N, nbl.k, f)
    want = _jit(lambda a, p: onehot_transpose_sum(a, p, interpret=True), _j(g), plan)
    got = eg.transpose_sum_rows(g, nbl.idx, nbl.transpose_perm)
    assert got.dtype == torch.bfloat16 and got.shape == (N, f)
    _within_one_ulp(got, want)


@pytest.mark.parametrize("dtype", ["f64", "bf16"])
def test_grad_of_grad_matches_jax(dtype):
    _, nbl = _list(seed=1)
    nbl.raise_on_overflow("test")
    rng = np.random.default_rng(2)
    x, v = rng.normal(size=(N, 8)), rng.normal(size=(N, 8))
    c = rng.normal(size=(N, nbl.k, 8))
    idx = nbl.idx
    tdt, jdt = (torch.float64, jnp.float64) if dtype == "f64" else (torch.bfloat16, jnp.bfloat16)

    def jax_fn(x, c, v):
        inner = lambda a: jnp.sum(c * j_nb.ell_gather(a, jnp.asarray(idx.numpy())) ** 2)
        return jax.grad(lambda a: jnp.sum(v * jax.grad(inner)(a)))(x)

    want = _jit(jax_fn, *(jnp.asarray(a).astype(jdt) for a in (x, c, v)))
    xt = torch.as_tensor(x).to(tdt).requires_grad_(True)
    ct, vt = torch.as_tensor(c).to(tdt), torch.as_tensor(v).to(tdt)
    (g,) = torch.autograd.grad((ct * nb.ell_gather(xt, idx, nbl.lazy_perm) ** 2).sum(), xt, create_graph=True)
    (gg,) = torch.autograd.grad((vt * g).sum(), xt)
    if dtype == "f64":
        np.testing.assert_allclose(gg.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    else:
        _within_one_ulp(gg, want)


def test_bf16_routes_through_the_kernel_wrappers(monkeypatch):
    """bf16 gathers and transposes go through the wrappers at every order
    (on the card: the kernels); f32 stays index_select."""
    calls = []
    real = {name: getattr(eg, name) for name in ("gather_rows", "transpose_sum_rows")}
    for name, fn in real.items():
        monkeypatch.setattr(eg, name, lambda *a, _r=fn, _n=name: calls.append(_n) or _r(*a))
    _, nbl = _list(seed=3)
    nbl.raise_on_overflow("test")
    x = torch.randn(N, 8, requires_grad=True)
    (g,) = torch.autograd.grad(nb.ell_gather(x, nbl.idx, nbl.lazy_perm).pow(2).sum(), x, create_graph=True)
    torch.autograd.grad(g.sum(), x)
    assert calls == []
    xb = x.detach().to(torch.bfloat16).requires_grad_(True)
    y = nb.ell_gather(xb, nbl.idx, nbl.lazy_perm)
    (g,) = torch.autograd.grad((y.float() ** 2).sum(), xb, create_graph=True)
    torch.autograd.grad(g.float().sum(), xb)
    assert calls == ["gather_rows", "transpose_sum_rows", "gather_rows", "transpose_sum_rows"]
    assert all(fn.launches == 0 for fn in real.values())  # CPU: no kernel launched
    with pytest.raises(ValueError, match="bf16"):
        real["gather_rows"](x.detach(), nbl.idx)


def test_truncated_list_forward_runs_and_its_gradient_raises():
    pos, nbl = _list(k=8, cutoff=4.0, seed=4)
    assert bool(nbl.overflow())  # truncated: some atom has more than 8 neighbors
    ref = j_nb.neighbor_list(jnp.asarray(pos.numpy()), jnp.zeros(N, jnp.int32), jnp.ones(N, bool),
                             k=8, cutoff_upper=4.0)
    np.testing.assert_array_equal(nbl.idx.numpy(), np.asarray(ref.idx))
    p = pos.clone().requires_grad_(True)
    _, dist = nb.edge_geometry_components(p, nbl)
    _, jdist = j_nb.edge_geometry_components(jnp.asarray(pos.numpy()), ref)
    np.testing.assert_allclose(dist.detach().numpy(), np.asarray(jdist), rtol=1e-12)
    assert nbl._perm is None  # the forward computed no permutation
    with pytest.raises(ValueError, match="not symmetric"):
        torch.autograd.grad(dist.sum(), p)


def test_derived_lists_share_one_lazy_permutation():
    pos, nbl = _list(seed=5)
    nbl.raise_on_overflow("test")
    loop = nb.neighbor_list(pos, k=24, cutoff_upper=3.0, loop=True)
    child = loop.without_self_loops().refine(pos, 0.0, 2.5)
    assert loop._perm is None and callable(child._perm)
    assert torch.equal(child.transpose_perm, nb.transpose_perm(child.idx))
    assert loop._perm is not None  # resolved once, on the parent, for both
    assert torch.equal(child.idx, nbl.idx)
