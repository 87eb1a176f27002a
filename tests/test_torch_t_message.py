"""The port's fused Transformer edge phase held against the JAX package's, on
the CPU.

- ``t_messages_reference`` (the plain version the port's wrapper runs for CPU
  tensors, and the yardstick of the CUDA kernels on the card) against JAX's
  ``fused_t_messages`` run in interpret mode (kernels #11 and #12), in f32 at
  the shapes tests/test_t_fused.py uses (H = 128): forward 1e-5, every input
  gradient 2e-4 (the two sides sum in different orders; f32 keeps the
  comparison about the algorithm, not about where bf16 rounds).  The other
  distance-influence and activation variants go against JAX's composable
  twin, ``_composable_t_reference``, at a smaller width.
- ``t_messages_bwd2_reference`` (the plain version of the second-order
  kernel #13) against ``_composable_t_bwd_vjp``, JAX's oracle of the
  second-order Pallas kernel, over all 9 input gradients and the ct
  gradient, for the four distance influences, in f64 and f32 at rtol 1e-5
  plus an atol of 1e-5 times each output's largest value.  JAX's reference
  computes its activations and its filter and head-sum products in f32
  whatever the operands' precision, so its "f64" holds only to f32
  precision, as for ET's #3 (tests/test_torch_et_bwd2.py).
- The autograd wiring of ``_TMessages``/``_TMessagesBwd`` with the three
  launches swapped for counting plain twins: grad-of-grad through the
  Functions equals grad-of-grad through ``t_messages_reference`` at (1, 2, 1)
  launches, a third derivative through them equals the plain version's,
  and a fused Trainer step of a
  2-layer Transformer launches (2, 4, 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.ops.cutoff import cosine_cutoff as j_cosine_cutoff
from torchmdnet_tpu.ops.neighbors import neighbor_list as j_neighbor_list
from torchmdnet_tpu.ops.pallas.et_message import _ones_block
from torchmdnet_tpu.ops.pallas.onehot_gather import make_block_gather_plan
from torchmdnet_tpu.ops.pallas.t_message import (
    FusedTConfig,
    _composable_t_bwd_vjp,
    _composable_t_reference,
    fused_t_messages as j_fused_t_messages,
)
from torchmdnet_tpu_torch import create_model
from torchmdnet_tpu_torch.data.batch import pad_molecules
from torchmdnet_tpu_torch.ops.kernels import t_message as tm
from torchmdnet_tpu_torch.ops.neighbors import transpose_perm
from torchmdnet_tpu_torch.train.trainer import Trainer

ORDER = ["q", "k", "v", "ea", "cutm", "wdk", "bdk", "wdv", "bdv"]
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


def _inputs(seed, n, h, rbf, side, cutoff, k_req=16):
    """numpy operands, cotangent and Zs on a symmetric (not overflowing)
    brute list of n atoms."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, side, (n, 3))
    nbl = j_neighbor_list(jnp.asarray(pos, jnp.float32), jnp.zeros(n, jnp.int32), jnp.ones(n, bool),
                          k=k_req, cutoff_lower=0.0, cutoff_upper=cutoff, loop=True)
    nbl.raise_on_overflow("test")
    idx = np.array(nbl.idx)
    mask = np.array(nbl.mask)
    kk = idx.shape[1]
    r = lambda *s: rng.randn(*s)
    dist = np.where(mask, np.linalg.norm(pos[idx] - pos[:, None, :], axis=-1), 0.0)
    cutm = np.asarray(j_cosine_cutoff(jnp.asarray(dist), 0.0, cutoff)) * mask
    ins = dict(q=r(n, h), k=r(n, h), v=r(n, h), ea=r(n, kk, rbf) * 0.3, cutm=cutm,
               wdk=r(rbf, h) * 0.3, bdk=r(1, h) * 0.1, wdv=r(rbf, h) * 0.3, bdv=r(1, h) * 0.1)
    ct = r(n, h)
    zs = {name: r(*np.shape(a)) * 0.5 for name, a in ins.items()}
    return idx, ins, ct, zs


def _absent(influence):
    return ([] if influence in ("keys", "both") else ["wdk", "bdk"]) + \
        ([] if influence in ("values", "both") else ["wdv", "bdv"])


def _jax_vjp(fn, ins, ct):
    """JAX forward and input cotangents of <out, ct>, in one jitted program."""

    def run(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)

    args = ([jnp.asarray(ins[n], jnp.float32) for n in ORDER], jnp.asarray(ct, jnp.float32))
    out, grads = jax.jit(run).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    return out, dict(zip(ORDER, grads))


def _port_vjp(idx, ins, ct, absent, heads, **kw):
    """Port forward + autograd gradients of <out, ct> (f32; absent filters None)."""
    t = {n: None if n in absent else torch.as_tensor(a, dtype=torch.float32).requires_grad_(True)
         for n, a in ins.items()}
    out = tm.fused_t_messages(torch.as_tensor(idx, dtype=torch.int32), *[t[n] for n in ORDER],
                              heads=heads, **kw)
    names = [n for n in ORDER if t[n] is not None]
    grads = torch.autograd.grad((out * torch.as_tensor(ct, dtype=torch.float32)).sum(),
                                [t[n] for n in names], allow_unused=True)
    # an input the variant leaves unused (ea without filters) gets zeros, as in JAX
    return out, {n: torch.zeros_like(t[n]) if g is None else g for n, g in zip(names, grads)}


def _check(out, grads, ref_out, ref_grads):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=FWD_TOL, atol=FWD_TOL)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_grads[n]), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"grad wrt {n}")


def test_reference_matches_jax_fused_kernel():
    """One forward and one backward of JAX's Pallas kernels (interpret mode)."""
    h, heads = 128, 8
    idx, ins, ct, _ = _inputs(seed=1, n=64, h=h, rbf=16, side=9.0, cutoff=3.0)
    plan = jax.jit(make_block_gather_plan, static_argnames=("block_rows", "width"))(
        jnp.asarray(idx), block_rows=32, width=128
    )
    assert int(plan.overflow) == 0 and int(plan.inv_overflow) == 0
    cfg = FusedTConfig(h=h, heads=heads, act="silu", attn_act="silu", has_dk=True, has_dv=True,
                       interpret=True)
    out, ref_grads = _jax_vjp(lambda *a: j_fused_t_messages(cfg, plan, *a), ins, ct)
    port_out, port_grads = _port_vjp(idx, ins, ct, (), heads)
    assert len(port_grads) == 9
    _check(port_out, port_grads, out, ref_grads)


@pytest.mark.parametrize(
    "influence,acts",
    [("keys", ("silu", "silu")), ("values", ("ssp", "tanh")), ("none", ("tanh", "sigmoid"))],
)
def test_reference_variants_match_jax_composable(influence, acts):
    h, heads = 32, 4
    idx, ins, ct, _ = _inputs(seed=2, n=24, h=h, rbf=8, side=6.0, cutoff=2.5)
    absent = _absent(influence)
    cfg = FusedTConfig(h=h, heads=heads, act=acts[0], attn_act=acts[1], has_dk="wdk" not in absent,
                       has_dv="wdv" not in absent, interpret=True)
    ones = _ones_block(h, heads, jnp.float32)
    jidx = jnp.asarray(idx)
    out, ref_grads = _jax_vjp(lambda *a: _composable_t_reference(cfg, None, jidx, ones, a), ins, ct)
    port_out, port_grads = _port_vjp(idx, ins, ct, absent, heads, act=acts[0], attn_act=acts[1])
    assert len(port_grads) == 9 - len(absent)
    _check(port_out, port_grads, out, ref_grads)


@pytest.mark.parametrize("influence,acts,precision", [
    ("both", ("silu", "silu"), 64), ("both", ("silu", "silu"), 32), ("keys", ("ssp", "tanh"), 32),
    ("values", ("tanh", "sigmoid"), 64), ("none", ("sigmoid", "ssp"), 32),
])
def test_bwd2_reference_matches_jax(influence, acts, precision):
    h, heads = 32, 4
    idx, ins, ct, zs = _inputs(seed=3, n=24, h=h, rbf=8, side=6.0, cutoff=2.5)
    absent = _absent(influence)
    npd, tdt = (np.float64, torch.float64) if precision == 64 else (np.float32, torch.float32)
    cfg = FusedTConfig(h=h, heads=heads, act=acts[0], attn_act=acts[1], has_dk="wdk" not in absent,
                       has_dv="wdv" not in absent, interpret=True)
    ones = _ones_block(h, heads, npd)
    jidx = jnp.asarray(idx)

    def run(inputs, c, z):
        return _composable_t_bwd_vjp(cfg, None, jidx, ones, inputs, c, z)

    args = (tuple(jnp.asarray(ins[n], npd) for n in ORDER), jnp.asarray(ct, jnp.float32),
            tuple(jnp.asarray(zs[n], npd) for n in ORDER))
    ref_in, ref_ct = jax.jit(run).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    t = lambda a: torch.as_tensor(np.asarray(a, npd))
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    inputs = [None if n in absent else t(ins[n]) for n in ORDER]
    Z = [None if n in absent else t(zs[n]) for n in ORDER]
    # JAX's reference takes ct in f32
    g_in, g_ct = tm.t_messages_bwd2_reference(tidx, transpose_perm(tidx), inputs,
                                              t(np.asarray(ct, np.float32)), Z,
                                              heads=heads, act=acts[0], attn_act=acts[1])
    pairs = [(n, g, ref) for n, g, ref in zip(ORDER, g_in, ref_in) if n not in absent]
    pairs.append(("ct", g_ct, ref_ct))
    assert len(pairs) == 10 - len(absent)
    for name, got, want in pairs:
        want = np.asarray(want)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"gradient wrt {name}")


# --- the autograd wiring, with the kernel launches swapped for plain twins


def _plain_fwd(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, **kw):
    _plain_fwd.launches += 1
    return tm.t_messages_reference(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, **kw)


def _plain_bwd(idx, perm, *args, want_weight_grads, **kw):
    _plain_bwd.launches += 1
    ins, ct = args[:9], args[9]
    with torch.enable_grad():
        a = [None if t is None else t.detach().requires_grad_(True) for t in ins]
        out = tm.t_messages_reference(idx, *a, perm=perm, **kw)
        live = [i for i, t in enumerate(a) if t is not None]
        g = torch.autograd.grad(out, [a[i] for i in live], ct, allow_unused=True)
    full = [None] * 9
    for i, gi in zip(live, g):
        full[i] = torch.zeros_like(a[i]) if gi is None else gi
    if not want_weight_grads:
        full[5:] = [None] * 4
    return tuple(full)


def _plain_bwd2(idx, perm, inputs, ct, Z, **kw):
    _plain_bwd2.launches += 1
    return tm.t_messages_bwd2_reference(idx, perm, inputs, ct, Z, **kw)


def route_through_functions(monkeypatch):
    """Run fused_t_messages through the autograd Functions on the CPU, with
    counting plain twins in place of the three launches."""
    monkeypatch.setattr(tm, "run_fwd", _plain_fwd)
    monkeypatch.setattr(tm, "run_bwd", _plain_bwd)
    monkeypatch.setattr(tm, "run_bwd2", _plain_bwd2)

    def through(idx, *a, heads, act="silu", attn_act="silu", perm=None):
        return tm._TMessages.apply((heads, act, attn_act), idx,
                                   transpose_perm(idx) if perm is None else perm, *a)

    monkeypatch.setattr("torchmdnet_tpu_torch.models.transformer.fused_t_messages", through)
    for fn in (_plain_fwd, _plain_bwd, _plain_bwd2):
        fn.launches = 0
    return through


def test_autograd_wiring_grad_of_grad(monkeypatch):
    idx, ins, ct, _ = _inputs(seed=5, n=24, h=32, rbf=8, side=6.0, cutoff=2.5)
    through = route_through_functions(monkeypatch)
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    perm = transpose_perm(tidx)
    w = torch.as_tensor(ct)
    grads = {}
    for fused in (True, False):
        t = {n: torch.as_tensor(a).requires_grad_(True) for n, a in ins.items()}
        args = [t[n] for n in ORDER]
        if fused:
            out = through(tidx, *args, heads=4, perm=perm)
        else:
            out = tm.t_messages_reference(tidx, *args, heads=4, perm=perm)
        energy = (out * w).sum() + 0.1 * (out * out).sum()
        # a force-training-shaped loss: the inner gradient wrt the
        # position-like inputs with create_graph, then a loss on it
        forces = torch.autograd.grad(energy, [t["cutm"], t["ea"]], create_graph=True)
        loss = energy + sum((f * f).sum() for f in forces)
        grads[fused] = dict(zip(ORDER, torch.autograd.grad(loss, args)))
    # one forward, the inner backward, the outer backward (energy term) and
    # one second-order launch
    assert (_plain_fwd.launches, _plain_bwd.launches, _plain_bwd2.launches) == (1, 2, 1)
    for n, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][n], rtol=1e-9, atol=1e-11, msg=f"grad wrt {n}")


def test_third_derivative_raises(monkeypatch):
    """A third derivative through the Functions equals the plain version's
    in f64 (the name is kept from when it raised): the second order's
    gradient is autograd through ``t_messages_bwd2_reference``."""
    idx, ins, _, _ = _inputs(seed=6, n=24, h=32, rbf=8, side=6.0, cutoff=2.5)
    through = route_through_functions(monkeypatch)
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    third = {}
    for fused in (True, False):
        t = {n: torch.as_tensor(a).requires_grad_(True) for n, a in ins.items()}
        fn = through if fused else tm.t_messages_reference
        out = fn(tidx, *[t[n] for n in ORDER], heads=4)
        (g,) = torch.autograd.grad((out * out).sum(), t["q"], create_graph=True)
        (g2,) = torch.autograd.grad((g * g).sum(), t["k"], create_graph=True)
        g3 = torch.autograd.grad((g2 ** 3).sum(), [t[n] for n in ORDER], allow_unused=True)
        third[fused] = {n: torch.zeros_like(t[n]) if v is None else v for n, v in zip(ORDER, g3)}
    assert _plain_bwd2.launches >= 1 and max(float(v.abs().max()) for v in third[False].values()) > 1e-3
    for n, g in third[True].items():
        torch.testing.assert_close(g, third[False][n], rtol=1e-9, atol=1e-9 * float(third[False][n].abs().max()),
                                   msg=f"third derivative wrt {n}")


def test_fused_step_launches_each_kernel_per_layer(tmp_path, monkeypatch):
    route_through_functions(monkeypatch)
    args = dict(model="transformer", embedding_dimension=32, num_layers=2, num_rbf=8,
                rbf_type="expnorm", trainable_rbf=False, activation="silu", attn_activation="silu",
                neighbor_embedding=False, num_heads=4, distance_influence="both", cutoff_lower=0.0,
                cutoff_upper=3.0, max_z=100, max_num_neighbors=16, derivative=True,
                output_model="Scalar", prior_model=None, reduce_op="add", atom_filter=-1,
                precision=32, bf16_messages=True, fused_attention=True)
    ptr = Trainer(create_model(args, device="cpu"), dict(args, lr=1e-3, log_dir=str(tmp_path)))
    rng = np.random.default_rng(0)
    mols = [{"z": rng.integers(1, 9, 8), "pos": rng.uniform(0, 4.0, (8, 3)).astype(np.float32),
             "y": np.ones(1, np.float32), "neg_dy": np.zeros((8, 3), np.float32)} for _ in range(2)]
    batch = ptr._prepare_batch(pad_molecules(mols, num_atoms=16, num_mol=2))
    assert ptr._fused
    acc = torch.zeros(4)
    ptr._train_step(batch, acc, torch.zeros(()), torch.zeros(()))
    assert (_plain_fwd.launches, _plain_bwd.launches, _plain_bwd2.launches) == (2, 4, 2)
    assert torch.isfinite(acc).all() and float(acc[2]) > 0


def test_cpu_tensors_take_the_plain_version():
    idx, ins, _, _ = _inputs(seed=7, n=24, h=32, rbf=8, side=6.0, cutoff=2.5)
    tm.reset_launch_counts()
    t = {n: torch.as_tensor(a).to(torch.float32 if n == "cutm" else torch.bfloat16) for n, a in ins.items()}
    for n in ("q", "k", "ea", "wdv"):
        t[n].requires_grad_(True)
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    out = tm.fused_t_messages(tidx, *[t[n] for n in ORDER], heads=4)
    ref = tm.t_messages_reference(tidx, *[t[n] for n in ORDER], heads=4)
    assert out.dtype == torch.float32 and out.shape == (24, 32)
    assert torch.equal(out, ref)
    out.sum().backward()
    assert t["k"].grad is not None and t["wdv"].grad.dtype == torch.bfloat16
    assert tm.run_fwd.launches == 0 and tm.run_bwd.launches == 0
