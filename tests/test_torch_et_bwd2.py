"""The second order of the port's fused ET edge phase, on the CPU.

- ``et_messages_bwd2_reference`` (the plain version of the second-order CUDA
  kernel, and its yardstick on the card) against JAX's own oracle of the
  second-order Pallas kernel, ``_composable_bwd_vjp``, over all 16 input
  gradients and both ct gradients, in f32 and f64 at rtol 1e-5 plus an atol
  of 1e-5 times each output's largest value (f32 rounding of sums over the K
  slots).  f64 cannot be held tighter: JAX's reference computes its
  activations (``_act_v``) and its filter and head-sum products
  (``preferred_element_type=float32``) in f32 and casts its outputs to f32
  whatever the operands' precision, so its "f64" second order carries f32
  roundings through second derivatives (measured: 1.3e-6 of the largest
  value); the port's plain version computes in f64 throughout.
- The autograd wiring of ``_EtMessages``/``_EtMessagesBwd`` with the three
  kernel launches swapped for their plain twins: grad-of-grad through the
  Functions equals grad-of-grad through ``et_messages_reference`` (which
  output takes which Z, the transpose-sum's adjoint, None Zs), and a third
  derivative raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.ops.cutoff import cosine_cutoff as j_cosine_cutoff
from torchmdnet_tpu.ops.neighbors import neighbor_list as j_neighbor_list
from torchmdnet_tpu.ops.pallas.et_message import FusedETConfig, _composable_bwd_vjp, _ones_block
from torchmdnet_tpu_torch.ops.kernels import et_message as em
from torchmdnet_tpu_torch.ops.neighbors import transpose_perm

N, H, HEADS, RBF = 24, 32, 4, 8
ORDER = ["q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk",
         "dir0", "dir1", "dir2", "wdk", "bdk", "wdv", "bdv"]
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _inputs(seed):
    """numpy operands, cotangents and Zs on a symmetric brute list of 24 atoms."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 6.0, (N, 3))
    nbl = j_neighbor_list(jnp.asarray(pos, jnp.float32), jnp.zeros(N, jnp.int32), jnp.ones(N, bool),
                          k=16, cutoff_lower=0.0, cutoff_upper=2.5, loop=True)
    nbl.raise_on_overflow("test")
    idx = np.array(nbl.idx)
    mask = np.array(nbl.mask)
    kk = idx.shape[1]
    r = lambda *s: rng.randn(*s)
    delta = pos[idx] - pos[:, None, :]
    dist = np.where(mask, np.linalg.norm(delta, axis=-1), 0.0)
    inv = np.where(dist > 0, 1.0, 0.0) / np.where(dist > 0, dist, 1.0)
    cutm = np.asarray(j_cosine_cutoff(jnp.asarray(dist), 0.0, 2.5)) * mask
    ins = dict(
        q=r(N, H), k=r(N, H), v=r(N, 3 * H), vec0=r(N, H), vec1=r(N, H), vec2=r(N, H),
        ea=r(N, kk, RBF) * 0.3, cutm=cutm, msk=mask.astype(np.float64),
        dir0=delta[..., 0] * inv, dir1=delta[..., 1] * inv, dir2=delta[..., 2] * inv,
        wdk=r(RBF, H) * 0.3, bdk=r(1, H) * 0.1, wdv=r(RBF, 3 * H) * 0.3, bdv=r(1, 3 * H) * 0.1,
    )
    cts = (r(N, H), r(N, 3 * H))
    zs = {n: r(*a.shape) * 0.5 for n, a in ins.items()}
    return idx, ins, cts, zs


def _jax_bwd2(idx, ins, cts, zs, cfg, dtype):
    ones = _ones_block(H, HEADS, dtype)
    jidx = jnp.asarray(idx)

    def run(inputs, ct, z):
        return _composable_bwd_vjp(cfg, None, jidx, ones, inputs, ct, z)

    args = (tuple(jnp.asarray(ins[n], dtype) for n in ORDER),
            tuple(jnp.asarray(c, jnp.float32) for c in cts),
            tuple(jnp.asarray(zs[n], dtype) for n in ORDER))
    g_in, g_ct = jax.jit(run).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    return dict(zip(ORDER, g_in)), g_ct


CASES = [("both", ("silu", "silu")), ("keys", ("ssp", "tanh")), ("values", ("tanh", "sigmoid")),
         ("none", ("sigmoid", "ssp")), ("both", ("ssp", "tanh"))]


@pytest.mark.parametrize("precision,rtol", [(64, 1e-5), (32, 1e-5)])
@pytest.mark.parametrize("influence,acts", CASES)
def test_bwd2_reference_matches_jax(influence, acts, precision, rtol):
    idx, ins, cts, zs = _inputs(seed=3)
    has_dk = influence in ("keys", "both")
    has_dv = influence in ("values", "both")
    npd, tdt = (np.float64, torch.float64) if precision == 64 else (np.float32, torch.float32)
    cfg = FusedETConfig(h=H, heads=HEADS, act=acts[0], attn_act=acts[1],
                        has_dk=has_dk, has_dv=has_dv, interpret=True)
    ref_in, ref_ct = _jax_bwd2(idx, ins, cts, zs, cfg, npd)
    absent = ([] if has_dk else ["wdk", "bdk"]) + ([] if has_dv else ["wdv", "bdv"])
    t = lambda a: torch.as_tensor(np.asarray(a, npd))
    cts = [np.asarray(c, np.float32) for c in cts]  # what JAX's reference takes
    inputs = [None if n in absent else t(ins[n]) for n in ORDER]
    Z = [None if n in absent else t(zs[n]) for n in ORDER]
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    g_in, g_ct = em.et_messages_bwd2_reference(
        tidx, transpose_perm(tidx), inputs, [t(c) for c in cts], Z,
        heads=HEADS, act=acts[0], attn_act=acts[1])
    pairs = [(n, g, ref_in[n]) for n, g in zip(ORDER, g_in) if n not in absent]
    pairs += [("ct_x", g_ct[0], ref_ct[0]), ("ct_vec", g_ct[1], ref_ct[1])]
    assert len(pairs) == 18 - len(absent)
    for name, got, want in pairs:
        want = np.asarray(want)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max(),
                                   err_msg=f"gradient wrt {name}")


# --- the autograd wiring, with the kernel launches swapped for plain twins


def _plain_fwd(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, **kw):
    em.run_fwd.launches += 1
    return em.et_messages_reference(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, *dirs,
                                    wdk, bdk, wdv, bdv, **kw)


def _plain_bwd(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv,
               ct_x, ct_vec, *, want_weight_grads, **kw):
    em.run_bwd.launches += 1
    with torch.enable_grad():
        ins = [q, k, v, vec0, vec1, vec2, ea, cutm, msk, *dirs, wdk, bdk, wdv, bdv]
        a = [None if t is None else t.detach().requires_grad_(i != 8) for i, t in enumerate(ins)]
        out = em.et_messages_reference(idx, *a, perm=perm, **kw)
        live = [i for i, t in enumerate(a) if t is not None and i != 8]
        g = torch.autograd.grad(out, [a[i] for i in live], (ct_x, ct_vec), allow_unused=True)
    full = [None] * 16
    for i, gi in zip(live, g):
        full[i] = torch.zeros_like(a[i]) if gi is None else gi
    if not want_weight_grads:
        full[12:] = [None] * 4
    return tuple(full[:8] + full[9:])


def _plain_bwd2(idx, perm, inputs, ct, Z, **kw):
    em.run_bwd2.launches += 1
    return em.et_messages_bwd2_reference(idx, perm, inputs, ct, Z, **kw)


def _force_loss(fused, t, idx, perm, w):
    """A force-training-shaped loss: the inner gradient wrt the position-like
    inputs (dirs, cutm, ea) with create_graph, then a loss on it."""
    names = ["dir0", "dir1", "dir2", "cutm", "ea"]
    args = [t[n] for n in ORDER]
    if fused:
        x, vec = em._EtMessages.apply((HEADS, "silu", "silu"), idx, perm, *args)
    else:
        x, vec = em.et_messages_reference(idx, *args, heads=HEADS, perm=perm)
    energy = (x * w[0]).sum() + (vec * w[1]).sum() + (x * x).sum() * 0.1
    forces = torch.autograd.grad(energy, [t[n] for n in names], create_graph=True)
    return energy + sum((f * f).sum() for f in forces)


def test_autograd_wiring_grad_of_grad(monkeypatch):
    idx, ins, cts, _ = _inputs(seed=5)
    monkeypatch.setattr(em, "run_fwd", _plain_fwd)
    monkeypatch.setattr(em, "run_bwd", _plain_bwd)
    monkeypatch.setattr(em, "run_bwd2", _plain_bwd2)
    for fn in (_plain_fwd, _plain_bwd, _plain_bwd2):
        fn.launches = 0
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    perm = transpose_perm(tidx)
    w = [torch.as_tensor(c) for c in cts]
    grads = {}
    for fused in (True, False):
        t = {n: torch.as_tensor(a).requires_grad_(n != "msk") for n, a in ins.items()}
        loss = _force_loss(fused, t, tidx, perm, w)
        names = [n for n in ORDER if n != "msk"]
        grads[fused] = dict(zip(names, torch.autograd.grad(loss, [t[n] for n in names])))
    # one forward, the inner backward, the outer backward (energy term) and
    # one second-order launch
    assert (_plain_fwd.launches, _plain_bwd.launches, _plain_bwd2.launches) == (1, 2, 1)
    for n, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][n], rtol=1e-9, atol=1e-11, msg=f"grad wrt {n}")


def test_third_derivative_raises(monkeypatch):
    idx, ins, cts, _ = _inputs(seed=6)
    monkeypatch.setattr(em, "run_fwd", _plain_fwd)
    monkeypatch.setattr(em, "run_bwd", _plain_bwd)
    monkeypatch.setattr(em, "run_bwd2", _plain_bwd2)
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    t = {n: torch.as_tensor(a).requires_grad_(n != "msk") for n, a in ins.items()}
    x, _ = em._EtMessages.apply((HEADS, "silu", "silu"), tidx, transpose_perm(tidx), *[t[n] for n in ORDER])
    (g,) = torch.autograd.grad((x * x).sum(), t["q"], create_graph=True)
    # a second derivative is fine without a graph; keeping its graph (the
    # way to a third) raises
    (g2,) = torch.autograd.grad((g * g).sum(), t["k"], retain_graph=True)
    assert torch.isfinite(g2).all()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch.autograd.grad((g * g).sum(), t["k"], create_graph=True)
