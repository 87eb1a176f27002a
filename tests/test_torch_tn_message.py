"""The port's fused TensorNet message phase held against the JAX package's, on the CPU.

- ``tn_messages_reference`` (the plain version the port's wrapper runs for
  CPU tensors, and the yardstick of the CUDA kernels on the card) against
  JAX's ``fused_tn_messages`` run in interpret mode on a block gather plan,
  in f32 at the shapes of tests/test_tn_fused.py (N = 64, H = 128, RBF = 16):
  forward 1e-5, every input gradient 2e-4 (the two sides sum in different
  orders; f32 keeps the comparison about the algorithm, not about where bf16
  rounds).  The tanh and ssp variants go against JAX's composable twin.
- ``tn_messages_bwd2_reference`` (the plain version of the second-order
  kernel) against JAX's own oracle of it, ``_composable_tn_bwd_vjp``, over all
  nine input gradients and the ct gradient, f64 and f32, rtol 1e-5 plus an
  atol of 1e-5 of each output's largest value.
- The autograd wiring of ``_TnMessages``/``_TnMessagesBwd`` with the kernel
  launches swapped for plain twins that count: grad-of-grad through the
  Functions equals grad-of-grad through the plain version and launches one
  forward, two backward and one second order; a third derivative through
  them equals the plain version's.
- The backward kernel's source-row cotangent in its gather form (``ct``
  gathered through ``idx``, times the receiver row's own edge weights), in
  plain PyTorch, equals autograd's on a symmetric list in a periodic box.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.ops.cutoff import cosine_cutoff as j_cosine_cutoff
from torchmdnet_tpu.ops.neighbors import neighbor_list as j_neighbor_list
from torchmdnet_tpu.ops.pallas.onehot_gather import make_block_gather_plan
from torchmdnet_tpu.ops.pallas.tn_message import (
    FusedTNConfig,
    _composable_tn_bwd_vjp,
    _composable_tn_reference,
    fused_tn_messages as j_fused_tn_messages,
)
from torchmdnet_tpu_torch.ops.kernels import tn_message as tm
from torchmdnet_tpu_torch.ops.neighbors import (
    edge_geometry_components,
    neighbor_list,
    transpose_perm,
)

N, H, RBF = 64, 128, 16
ORDER = list(tm.ORDER)
FWD_TOL, GRAD_TOL = 1e-5, 2e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, n=N, h=H, rbf=RBF, k_req=16, cutoff=3.0, side=9.0):
    """numpy inputs on a symmetric (not overflowing) brute-force list; each
    edge's ea is the same at both of its slots, as the fused op requires
    (``require_symmetric_edges``)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, side, (n, 3)).astype(np.float32)
    nbl = j_neighbor_list(jnp.asarray(pos), jnp.zeros(n, jnp.int32), jnp.ones(n, bool),
                          k=k_req, cutoff_lower=0.0, cutoff_upper=cutoff, loop=True)
    nbl.raise_on_overflow("test")
    idx, mask = np.array(nbl.idx), np.array(nbl.mask)
    k = idx.shape[1]
    dist = np.where(mask, np.linalg.norm(pos[idx] - pos[:, None, :], axis=-1), 0.0)
    r = lambda *s: rng.randn(*s)
    pair = r(n, n, rbf) * 0.3
    pair = (pair + pair.transpose(1, 0, 2)) / np.sqrt(2.0)
    ins = dict(
        cat=r(n, 9 * h), ea=pair[np.arange(n)[:, None], idx],
        cutm=np.asarray(j_cosine_cutoff(jnp.asarray(dist), 0.0, cutoff)) * mask,
        w1=r(rbf, h) * 0.2, b1=r(1, h) * 0.1, w2=r(h, 2 * h) * 0.08, b2=r(1, 2 * h) * 0.1,
        w3=r(2 * h, 3 * h) * 0.05, b3=r(1, 3 * h) * 0.1,
    )
    ins = {name: np.asarray(a, np.float32) for name, a in ins.items()}
    return idx, ins, r(n, 9 * h).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _plan_fn(shape, width):
    """``make_block_gather_plan`` compiled once per list shape and width and
    shared by the tests (an eager call compiles each of its primitives)."""
    spec = jax.ShapeDtypeStruct(shape, jnp.int32)
    return jax.jit(make_block_gather_plan, static_argnames=("block_rows", "width")).lower(
        spec, block_rows=8, width=width).compile(compiler_options=FAST_COMPILE)


def _plan(idx, width=128):
    return _plan_fn(tuple(idx.shape), width)(jnp.asarray(idx))


def _jax_vjp(fn, ins, ct):
    """JAX forward and input cotangents of <out, ct>, in one jitted program
    compiled with LLVM's cheap pipeline (numerics unchanged)."""

    def run(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)

    args = ([jnp.asarray(ins[n]) for n in ORDER], jnp.asarray(ct))
    out, grads = jax.jit(run).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    return out, dict(zip(ORDER, grads))


def _port(idx, ins, ct, act="silu"):
    t = {n: torch.as_tensor(a).requires_grad_(True) for n, a in ins.items()}
    m = tm.fused_tn_messages(torch.as_tensor(idx, dtype=torch.int32), *[t[n] for n in ORDER], act=act)
    grads = torch.autograd.grad(m, [t[n] for n in ORDER], torch.as_tensor(ct))
    return m, dict(zip(ORDER, grads))


def _check(m, grads, ref_m, ref_grads):
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(ref_m), rtol=FWD_TOL, atol=FWD_TOL)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_grads[n]), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"grad wrt {n}")


def test_reference_matches_jax_fused_kernel():
    """One forward and one backward of JAX's Pallas kernels (interpret mode)."""
    idx, ins, ct = _inputs(seed=1)
    plan = _plan(idx, width=256)
    assert int(plan.overflow) == 0 and int(plan.inv_overflow) == 0
    cfg = FusedTNConfig(h=H, act="silu", interpret=True)
    out, ref_grads = _jax_vjp(lambda *a: j_fused_tn_messages(cfg, plan, *a), ins, ct)
    m, grads = _port(idx, ins, ct)
    assert m.shape == (N, 9 * H) and m.dtype == torch.float32
    _check(m, grads, out, ref_grads)
    # the card's backward reads ct in gather form (bwd_reference is its
    # arithmetic); on these symmetric inputs it equals JAX's scatter form
    t = [torch.as_tensor(ins[n]) for n in ORDER]
    d_cat = tm.bwd_reference(torch.as_tensor(idx, dtype=torch.int32), *t, torch.as_tensor(ct), act="silu",
                             want_rows=False)[0]
    np.testing.assert_allclose(d_cat.numpy(), np.asarray(ref_grads["cat"]), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("act", ["tanh", "ssp"])
def test_reference_variants_match_jax_composable(act):
    idx, ins, ct = _inputs(seed=2, n=24, h=32, rbf=8, cutoff=2.5, side=6.0)
    plan = _plan(idx)
    cfg = FusedTNConfig(h=32, act=act, interpret=True)
    out, ref_grads = _jax_vjp(lambda *a: _composable_tn_reference(cfg, plan, a), ins, ct)
    m, grads = _port(idx, ins, ct, act=act)
    _check(m, grads, out, ref_grads)


@pytest.mark.parametrize("precision", [64, 32])
def test_bwd2_reference_matches_jax(precision):
    idx, ins, ct = _inputs(seed=3, n=24, h=32, rbf=8, cutoff=2.5, side=6.0)
    npd = np.float64 if precision == 64 else np.float32
    rng = np.random.RandomState(4)
    zs = {n: rng.randn(*a.shape) * 0.5 for n, a in ins.items()}
    plan = _plan(idx)
    cfg = FusedTNConfig(h=32, act="silu", interpret=True)

    def run(inputs, c, z):
        return _composable_tn_bwd_vjp(cfg, plan, inputs, c, z)

    args = (tuple(jnp.asarray(ins[n], npd) for n in ORDER), jnp.asarray(ct, jnp.float32),
            tuple(jnp.asarray(zs[n], npd) for n in ORDER))
    ref_in, ref_ct = jax.jit(run).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    t = lambda a: torch.as_tensor(np.asarray(a, npd))
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    g_in, g_ct = tm.tn_messages_bwd2_reference(
        tidx, transpose_perm(tidx), [t(ins[n]) for n in ORDER], t(ct), [t(zs[n]) for n in ORDER])
    pairs = list(zip(ORDER, g_in, ref_in)) + [("ct", g_ct, ref_ct)]
    for name, got, want in pairs:
        want = np.asarray(want)
        assert got.dtype == (torch.float64 if precision == 64 else torch.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"gradient wrt {name}")


def test_cpu_tensors_take_the_plain_version():
    idx, ins, ct = _inputs(seed=5, n=24, h=32, rbf=8, cutoff=2.5, side=6.0)
    tm.reset_launch_counts()
    t = {n: torch.as_tensor(a).to(torch.float32 if n == "cutm" else torch.bfloat16) for n, a in ins.items()}
    for n in ("cat", "ea", "w3"):
        t[n].requires_grad_(True)
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    m = tm.fused_tn_messages(tidx, *[t[n] for n in ORDER])
    assert m.dtype == torch.float32 and torch.equal(m, tm.tn_messages_reference(tidx, *[t[n] for n in ORDER]))
    m.sum().backward()
    assert t["cat"].grad.dtype == torch.bfloat16 and t["w3"].grad.shape == (64, 96)
    assert (tm.run_fwd.launches, tm.run_bwd.launches, tm.run_bwd2.launches) == (0, 0, 0)


def _asymmetric(ins, idx, name, seed):
    """``ins`` with ``name`` (ea or cutm) changed at one live slot of each of
    a few rows and not at the slot's reverse."""
    rng = np.random.RandomState(seed)
    out = dict(ins)
    a = ins[name].copy()
    live = np.argwhere((ins["cutm"] != 0) & (idx != np.arange(len(idx))[:, None]))
    for i, k in live[rng.choice(len(live), 4, replace=False)]:
        a[i, k] = a[i, k] * 1.5 + 0.1
    out[name] = a
    return out


@pytest.mark.parametrize("name", ["ea", "cutm"])
def test_cpu_twin_raises_on_asymmetric_edge_inputs(name):
    """The backward's gather-form d_cat needs each edge's ea and cutm equal at
    both of its slots; the CPU twin refuses other inputs."""
    idx, ins, _ = _inputs(seed=6, n=24, h=32, rbf=8, cutoff=2.5, side=6.0)
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    tm.fused_tn_messages(tidx, *[torch.as_tensor(ins[n]) for n in ORDER])  # symmetric: runs
    bad = _asymmetric(ins, idx, name, seed=7)
    with pytest.raises(ValueError, match="both slots of an edge"):
        tm.fused_tn_messages(tidx, *[torch.as_tensor(bad[n]) for n in ORDER])


@pytest.mark.parametrize("symmetric", [True, False])
def test_gather_form_d_cat_against_scatter_form(symmetric):
    """In f64: the card's gather-form d_cat (``bwd_reference``) equals the
    scatter form (autograd of the plain version) when ea and cutm are
    symmetric, and differs when one edge's ea is not."""
    idx, ins, ct = _inputs(seed=8, n=24, h=32, rbf=8, cutoff=2.5, side=6.0)
    if not symmetric:
        ins = _asymmetric(ins, idx, "ea", seed=9)
    t = {n: torch.as_tensor(ins[n], dtype=torch.float64) for n in ORDER}
    t["cat"].requires_grad_(True)
    tidx, tct = torch.as_tensor(idx, dtype=torch.int32), torch.as_tensor(ct, dtype=torch.float64)
    m = tm.tn_messages_reference(tidx, *[t[n] for n in ORDER])
    (scatter,) = torch.autograd.grad(m, [t["cat"]], tct)
    gather = tm.bwd_reference(tidx, *[t[n].detach() for n in ORDER], tct, act="silu", want_rows=False)[0]
    gap = float((gather - scatter).abs().max() / scatter.abs().max())
    assert (gap < 1e-12) if symmetric else (gap > 1e-3), gap


# --- the autograd wiring, with the kernel launches swapped for plain twins


def plain_fwd(idx, *inputs, act):
    tm.run_fwd.launches += 1
    return tm.tn_messages_reference(idx, *inputs, act=act)


def plain_bwd(idx, *args, act, want_weight_grads):
    """Autograd's cotangents of the plain version (the weight cotangents
    None unless wanted), counted as a backward launch."""
    tm.run_bwd.launches += 1
    *inputs, ct = args
    with torch.enable_grad():
        a = [x.detach().requires_grad_(True) for x in inputs]
        g = torch.autograd.grad(tm.tn_messages_reference(idx, *a, act=act), a, ct)
    return tuple(g[:3]) + (tuple(g[3:]) if want_weight_grads else (None,) * 6)


def plain_bwd2(idx, perm, inputs, ct, Z, *, act):
    tm.run_bwd2.launches += 1
    return tm.tn_messages_bwd2_reference(idx, perm, inputs, ct, Z, act=act)


def route_through_functions(monkeypatch):
    """Run fused_tn_messages through the autograd Functions on the CPU, with
    counting plain twins in place of the three launches."""
    monkeypatch.setattr(tm, "run_fwd", plain_fwd)
    monkeypatch.setattr(tm, "run_bwd", plain_bwd)
    monkeypatch.setattr(tm, "run_bwd2", plain_bwd2)
    monkeypatch.setattr(tm, "fused_tn_messages", lambda idx, *a, act="silu", perm=None: tm._TnMessages.apply(
        act, idx, transpose_perm(idx) if perm is None else perm, *a))
    for fn in (plain_fwd, plain_bwd, plain_bwd2):
        fn.launches = 0


def test_autograd_wiring_grad_of_grad(monkeypatch):
    idx, ins, ct = _inputs(seed=6, n=24, h=32, rbf=8, cutoff=2.5, side=6.0)
    route_through_functions(monkeypatch)
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    perm = transpose_perm(tidx)
    w = torch.as_tensor(ct, dtype=torch.float64)
    grads = {}
    for fused in (True, False):
        t = {n: torch.as_tensor(a, dtype=torch.float64).requires_grad_(True) for n, a in ins.items()}
        fn = tm.fused_tn_messages if fused else tm.tn_messages_reference
        m = fn(tidx, *[t[n] for n in ORDER], perm=perm)
        energy = (m * w).sum() + 0.1 * (m * m).sum()
        forces = torch.autograd.grad(energy, [t["ea"], t["cutm"], t["cat"]], create_graph=True)
        loss = energy + sum((f * f).sum() for f in forces)
        grads[fused] = dict(zip(ORDER, torch.autograd.grad(loss, [t[n] for n in ORDER])))
    assert (plain_fwd.launches, plain_bwd.launches, plain_bwd2.launches) == (1, 2, 1)
    for n, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][n], rtol=1e-9, atol=1e-11, msg=f"grad wrt {n}")


def test_third_derivative_raises(monkeypatch):
    """A third derivative through the Functions equals the plain version's
    in f64 (the name is kept from when it raised): the second order's
    gradient is autograd through ``tn_messages_bwd2_reference``."""
    idx, ins, _ = _inputs(seed=7, n=24, h=32, rbf=8, cutoff=2.5, side=6.0)
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    third = {}
    for fused in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if fused:
                route_through_functions(mp)
            t = {n: torch.as_tensor(a, dtype=torch.float64).requires_grad_(True) for n, a in ins.items()}
            m = tm.fused_tn_messages(tidx, *[t[n] for n in ORDER])
            (g,) = torch.autograd.grad((m * m).sum(), t["cat"], create_graph=True)
            (g2,) = torch.autograd.grad((g * g).sum(), t["ea"], create_graph=True)
            g3 = torch.autograd.grad((g2 ** 3).sum(), [t[n] for n in ORDER], allow_unused=True)
            third[fused] = {n: torch.zeros_like(t[n]) if v is None else v for n, v in zip(ORDER, g3)}
            if fused:
                assert plain_bwd2.launches >= 1
    assert max(float(v.abs().max()) for v in third[False].values()) > 1e-3
    for n, g in third[True].items():
        torch.testing.assert_close(g, third[False][n], rtol=1e-9, atol=1e-9 * float(third[False][n].abs().max()),
                                   msg=f"third derivative wrt {n}")


def test_source_cotangent_gather_form_in_a_periodic_box():
    """d_cat[j] = sum_k' ct[idx[j, k']] * w[j, k'] (the backward kernel's
    form) equals autograd's transpose-sum when ea and cutm come from the
    distances of a symmetric list, here across periodic images."""
    g = torch.Generator().manual_seed(8)
    n, h, rbf, cut, side = 40, 32, 8, 2.5, 6.5
    pos = torch.rand(n, 3, generator=g, dtype=torch.float64) * side
    box = torch.eye(3, dtype=torch.float64) * side
    nbl = neighbor_list(pos, k=40, cutoff_upper=cut, loop=True, box=box)
    nbl.raise_on_overflow("test")
    from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
    from torchmdnet_tpu_torch.ops.rbf import ExpNormalSmearing

    _, dist = edge_geometry_components(pos, nbl, box=box)
    assert bool((dist > side / 2).logical_not().all()) and bool((nbl.mask.sum(1) > 1).all())
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    ins = [r(n, 9 * h), ExpNormalSmearing(0.0, cut, rbf, buffer_dtype=torch.float64)(dist),
           cosine_cutoff(dist, 0.0, cut) * nbl.mask, r(rbf, h) * 0.4, r(1, h) * 0.1,
           r(h, 2 * h) * 0.2, r(1, 2 * h) * 0.1, r(2 * h, 3 * h) * 0.15, r(1, 3 * h) * 0.1]
    ct = r(n, 9 * h)
    cat = ins[0].requires_grad_(True)
    m = tm.tn_messages_reference(nbl.idx, cat, *ins[1:], perm=nbl.transpose_perm)
    (want,) = torch.autograd.grad(m, cat, ct)
    wb = tm._edge_weights(*ins[1:], act="silu")  # (N, K, 3, H)
    comp = [0, 1, 1, 1, 2, 2, 2, 2, 2]
    ct_j = ct[nbl.idx.long()].reshape(n, -1, 9, h)
    got = (ct_j * wb[:, :, comp]).sum(dim=1).reshape(n, 9 * h)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
