"""The port's fused ET edge phase held against the JAX package's, on the CPU.

``et_messages_reference`` (the plain version the port's wrapper runs for CPU
tensors, and the yardstick of the CUDA kernels on the card) is compared with
JAX's ``fused_et_messages`` run in interpret mode, in f32 at the shapes and
tolerances of tests/test_et_fused.py: forward 1e-5, every input gradient
2e-4 (the two sides sum in different orders; f32 keeps the comparison about
the algorithm, not about where bf16 rounds).  The other distance-influence
and activation variants go against JAX's cheap composable twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmdnet_tpu.ops.cutoff import cosine_cutoff as j_cosine_cutoff
from torchmdnet_tpu.ops.neighbors import neighbor_list as j_neighbor_list
from torchmdnet_tpu.ops.pallas.et_message import (
    FusedETConfig,
    _composable_reference,
    _ones_block,
    fused_et_messages as j_fused_et_messages,
)
from torchmdnet_tpu.ops.pallas.onehot_gather import make_block_gather_plan
from torchmdnet_tpu_torch.ops.kernels import et_message as em

N, H, HEADS, RBF, K_REQ = 64, 128, 8, 16, 16
ORDER = ["q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk",
         "dir0", "dir1", "dir2", "wdk", "bdk", "wdv", "bdv"]
FWD_TOL, GRAD_TOL = 1e-5, 2e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _inputs(seed):
    """numpy inputs on a symmetric (not overflowing) brute-force list of 64 atoms."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 9.0, (N, 3)).astype(np.float32)
    nbl = j_neighbor_list(
        jnp.asarray(pos), jnp.zeros(N, jnp.int32), jnp.ones(N, bool),
        k=K_REQ, cutoff_lower=0.0, cutoff_upper=3.0, loop=True,
    )
    nbl.raise_on_overflow("test")
    idx = np.array(nbl.idx)
    mask = np.array(nbl.mask)
    k = idx.shape[1]
    r = lambda *s: rng.randn(*s).astype(np.float32)
    delta = pos[idx] - pos[:, None, :]
    dist = np.where(mask, np.linalg.norm(delta, axis=-1), 0.0)
    inv = np.where(dist > 0, 1.0, 0.0) / np.where(dist > 0, dist, 1.0)
    cutm = np.asarray(j_cosine_cutoff(jnp.asarray(dist), 0.0, 3.0)) * mask
    ins = dict(
        q=r(N, H), k=r(N, H), v=r(N, 3 * H), vec0=r(N, H), vec1=r(N, H), vec2=r(N, H),
        ea=r(N, k, RBF) * 0.3, cutm=cutm, msk=mask.astype(np.float32),
        dir0=delta[..., 0] * inv, dir1=delta[..., 1] * inv, dir2=delta[..., 2] * inv,
        wdk=r(RBF, H) * 0.2, bdk=r(1, H) * 0.1, wdv=r(RBF, 3 * H) * 0.2, bdv=r(1, 3 * H) * 0.1,
    )
    ins = {n: np.asarray(a, np.float32) for n, a in ins.items()}
    cts = (r(N, H), r(N, 3 * H))
    return idx, ins, cts


def _jax_vjp(fn, ins, cts):
    """JAX forward and input cotangents of <out, cts>, in one jitted program
    (one compile instead of one per primitive, with LLVM's cheap pipeline:
    the numerics are unchanged and the compile time halves)."""

    def run(args, cts):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cts)

    args = ([jnp.asarray(ins[n]) for n in ORDER], tuple(jnp.asarray(c) for c in cts))
    out, grads = jax.jit(run).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    return out, dict(zip(ORDER, grads))


def _port(idx, ins, cts, drop=(), **kw):
    """Port forward + autograd gradients of <out, cts> (None for dropped filters)."""
    t = {n: torch.as_tensor(a).requires_grad_(n != "msk") for n, a in ins.items()}
    for n in drop:
        t[n] = None
    x, vec = em.fused_et_messages(
        torch.as_tensor(idx, dtype=torch.int32), *[t[n] for n in ORDER], heads=HEADS, **kw
    )
    names = [n for n in ORDER if n != "msk" and t[n] is not None]
    loss = (x * torch.as_tensor(cts[0])).sum() + (vec * torch.as_tensor(cts[1])).sum()
    grads = torch.autograd.grad(loss, [t[n] for n in names], allow_unused=True)
    # an input the variant leaves unused (ea without filters) gets zeros, as in JAX
    return (x, vec), {
        n: torch.zeros_like(t[n]) if g is None else g for n, g in zip(names, grads)
    }


def _check(port_out, port_grads, ref_out, ref_grads):
    for a, b in zip(port_out, ref_out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=FWD_TOL, atol=FWD_TOL)
    for n, g in port_grads.items():
        np.testing.assert_allclose(
            g.numpy(), np.asarray(ref_grads[n]), rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"grad wrt {n}"
        )


def test_reference_matches_jax_fused_kernel():
    """One forward and one backward of JAX's Pallas kernels (interpret mode)."""
    idx, ins, cts = _inputs(seed=1)
    plan = jax.jit(make_block_gather_plan, static_argnames=("block_rows", "width"))(
        jnp.asarray(idx), block_rows=32, width=128
    )
    assert int(plan.overflow) == 0 and int(plan.inv_overflow) == 0
    cfg = FusedETConfig(h=H, heads=HEADS, act="silu", attn_act="silu",
                        has_dk=True, has_dv=True, interpret=True)
    out, ref_grads = _jax_vjp(lambda *a: j_fused_et_messages(cfg, plan, *a), ins, cts)
    # msk is 0/1 data: neither side gives it a gradient
    assert not np.any(np.asarray(ref_grads["msk"]))
    port_out, port_grads = _port(idx, ins, cts)
    assert len(port_grads) == 15
    _check(port_out, port_grads, out, ref_grads)


@pytest.mark.parametrize(
    "influence,acts",
    [("keys", ("silu", "silu")), ("values", ("ssp", "tanh")), ("none", ("tanh", "sigmoid"))],
)
def test_reference_variants_match_jax_composable(influence, acts):
    idx, ins, cts = _inputs(seed=2)
    has_dk = influence in ("keys", "both")
    has_dv = influence in ("values", "both")
    cfg = FusedETConfig(h=H, heads=HEADS, act=acts[0], attn_act=acts[1],
                        has_dk=has_dk, has_dv=has_dv, interpret=True)
    ones = _ones_block(H, HEADS, jnp.float32)
    jidx = jnp.asarray(idx)
    out, ref_grads = _jax_vjp(lambda *a: _composable_reference(cfg, None, jidx, ones, a), ins, cts)
    drop = ([] if has_dk else ["wdk", "bdk"]) + ([] if has_dv else ["wdv", "bdv"])
    port_out, port_grads = _port(idx, ins, cts, drop=drop, act=acts[0], attn_act=acts[1])
    _check(port_out, port_grads, out, ref_grads)


def test_cpu_tensors_take_the_plain_version():
    idx, ins, cts = _inputs(seed=3)
    em.reset_launch_counts()
    t = {n: torch.as_tensor(a).to(torch.bfloat16 if n not in ("cutm", "msk", "dir0", "dir1", "dir2") else torch.float32)
         for n, a in ins.items()}
    for n in ("q", "k", "ea", "wdv"):
        t[n].requires_grad_(True)
    tidx = torch.as_tensor(idx, dtype=torch.int32)
    x, vec = em.fused_et_messages(tidx, *[t[n] for n in ORDER], heads=HEADS)
    xr, vecr = em.et_messages_reference(tidx, *[t[n] for n in ORDER], heads=HEADS)
    assert x.dtype == torch.float32 and vec.shape == (N, 3 * H)
    assert torch.equal(x, xr) and torch.equal(vec, vecr)
    (x.sum() + vec.sum()).backward()
    assert t["k"].grad is not None and t["wdv"].grad.dtype == torch.bfloat16
    assert em.run_fwd.launches == 0 and em.run_bwd.launches == 0
