"""Composable derivative rules of the fused edge phases.

The kernels of ``et_message.py``, ``t_message.py`` and ``tn_message.py``
compute the primals of three functions: the forward, its backward (a vjp)
and the backward's gradient (the second order).  Every other derivative is
composable, built by autograd from the phase's plain twin
(``et_messages_reference`` and its counterparts), as the JAX package's rules
are (``_et_dot``, ``_et_bwd_dot``, ``_et_bwd2_op_jvp``:
torchmdnet_tpu/ops/pallas/et_message.py:1085-1210):

- ``jvp``: the forward-mode tangent of a function, as the double vjp of it
  (exact: a vjp is linear in its cotangent);
- ``vjp_tangent``: the tangent of a backward, by the symmetry of second
  derivatives the gradient of <backward, tangents> + <forward, tangent of
  the cotangent>: the second order's math, once, with the tangents as Z;
- ``second_order``: the gradient of <backward, Z> (the second order's plain
  version), differentiable again when asked, so every higher order closes.

A ``jvp`` rule of an ``autograd.Function`` cannot nest forward mode (PyTorch
runs none inside one), so every rule here is written in reverse mode.
``Bwd2`` (``bwd2_apply``) is the second order as a Function: its forward
the kernels, its backward and its tangent autograd through the second
order's plain version.
"""

import torch
import torch.autograd.forward_ad as fwAD


def tangent_live(*tensors) -> bool:
    """Whether any of ``tensors`` carries a forward-mode tangent: a fused
    backward must then run through its differentiable Function, whose jvp
    carries the tangent (a kernel writes tensors without one)."""
    return any(t is not None and fwAD.unpack_dual(t).tangent is not None for t in tensors)


def _wide(t):
    """f32 for low-precision tensors, else the tensor's own dtype."""
    return t if t.dtype == torch.float64 else t.float()


def _dot(a, b):
    return (_wide(a) * _wide(b)).sum()


def _leaves(tensors, keep_history: bool):
    """Tensors to differentiate with respect to: with ``keep_history`` a
    tensor that carries autograd history is used as it is (a gradient taken
    with ``create_graph`` stays connected to it), every other one becomes a
    fresh leaf."""
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
        elif keep_history and t.requires_grad:
            out.append(t)
        else:
            out.append(t.detach().requires_grad_(True))
    return out


def _grads(outs, wrt, cts, create_graph=False):
    """torch.autograd.grad over the (output, cotangent) pairs present; None
    where an input is not reached."""
    pairs = [(o, c) for o, c in zip(outs, cts) if o is not None and c is not None and o.requires_grad]
    if not pairs or not wrt:
        return [None] * len(wrt)
    return torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs], allow_unused=True,
                               create_graph=create_graph)


def _full(primals, live, grads):
    """Gradients in the primals' slots: None for a None primal, zeros where
    the function does not reach it."""
    full = [None] * len(primals)
    for i, g in zip(live, grads):
        full[i] = torch.zeros_like(primals[i]) if g is None else g
    return full


def vjp(fn, primals, cts, create_graph: bool = False):
    """The gradients of <fn(*primals), cts> with respect to each primal
    (``fn`` returns a tuple; None primals and cotangents are left out).
    ``create_graph`` keeps the result differentiable, connected to the
    primals' own history."""
    with torch.enable_grad():
        a = _leaves(primals, keep_history=create_graph)
        live = [i for i, t in enumerate(a) if t is not None]
        g = _grads(fn(*a), [a[i] for i in live], cts, create_graph=create_graph)
    return _full(primals, live, g)


def jvp(fn, primals, tangents):
    """The tangent of ``fn``'s outputs at ``primals`` along ``tangents``
    (None: zero): the vjp of the vjp of ``fn`` with respect to its
    cotangents, which is linear in them."""
    live = [i for i, (p, t) in enumerate(zip(primals, tangents)) if p is not None and t is not None]
    with torch.enable_grad():
        a = [None if p is None else p.detach().requires_grad_(i in live) for i, p in enumerate(primals)]
        outs = list(fn(*a))
        at = [j for j, o in enumerate(outs) if o is not None and o.requires_grad]
        us = [torch.zeros_like(outs[j], requires_grad=True) for j in at]
        g = _grads([outs[j] for j in at], [a[i] for i in live], us, create_graph=True)
        pairs = [(gi, tangents[i]) for gi, i in zip(g, live) if gi is not None and gi.requires_grad]
        r = _grads([gi for gi, _ in pairs], us, [t for _, t in pairs])
    res = [None if o is None else torch.zeros_like(o) for o in outs]
    for j, rj in zip(at, r):
        if rj is not None:
            res[j] = rj
    return res


def vjp_tangent(fn, primals, cts, t_primals, t_cts):
    """The tangent along (``t_primals``, ``t_cts``) of ``vjp(fn, primals,
    cts)``.  With S = <fn(p), c>, the vjp is dS/dp and its tangent is
    d2S/dp2 . t_p + d2S/dpdc . t_c, which by the symmetry of second
    derivatives is the gradient over p of <dS/dp, t_p> + <fn(p), t_c>: one
    second-order pass of the plain version, the same math as the second
    order's with Z = t_p."""
    with torch.enable_grad():
        a = _leaves(primals, keep_history=False)
        live = [i for i, t in enumerate(a) if t is not None]
        outs = fn(*a)
        tl = [i for i in live if t_primals[i] is not None]
        terms = []
        if tl:
            g = _grads(outs, [a[i] for i in tl], cts, create_graph=True)
            terms += [_dot(gi, t_primals[i]) for gi, i in zip(g, tl) if gi is not None]
        terms += [_dot(o, t) for o, t in zip(outs, t_cts) if o is not None and t is not None]
        terms = [s for s in terms if s.requires_grad]
        g = (torch.autograd.grad(sum(terms), [a[i] for i in live], allow_unused=True) if terms
             else [None] * len(live))
    return _full(primals, live, g)


def second_order(fn, primals, cts, zs, create_graph: bool = False):
    """(g_primals, g_cts): the gradients over (primals, cts) of <vjp(fn,
    primals, cts), zs> (a None Z leaves its slot out of the product): the
    plain version of a second-order kernel.  ``create_graph`` keeps the
    result differentiable, connected to the inputs' own history."""
    with torch.enable_grad():
        a = _leaves(primals, keep_history=create_graph)
        c = _leaves(cts, keep_history=create_graph)
        live = [i for i, t in enumerate(a) if t is not None]
        g = _grads(fn(*a), [a[i] for i in live], c, create_graph=True)
        terms = [_dot(gi, zs[i]) for i, gi in zip(live, g) if gi is not None and zs[i] is not None]
        terms = [s for s in terms if s.requires_grad]
        wrt = [a[i] for i in live] + c
        grads = (torch.autograd.grad(sum(terms), wrt, allow_unused=True, create_graph=create_graph) if terms
                 else [None] * len(wrt))
    return _full(primals, live, grads[:len(live)]), _full(cts, range(len(cts)), grads[len(live):])


def flat(g):
    """A second order's (g_inputs, g_ct) as one tuple (g_ct a tensor or a
    tuple of them)."""
    g_inputs, g_ct = g
    return (*g_inputs, *((g_ct,) if torch.is_tensor(g_ct) else g_ct))


class Bwd2(torch.autograd.Function):
    """A fused phase's second order as a differentiable function of its
    arguments (the phase's inputs, the cotangents ct, the Zs on the
    backward's outputs, flat).  ``run(*args)`` runs the kernels (the primal);
    the gradient and the tangent come from ``twin(*args)``, the same function
    in plain PyTorch (``second_order`` of the phase's plain twin,
    differentiable again): a third derivative and every order above it are
    composable, as JAX's are.  Both return the same tuple of gradients (None
    for an absent input)."""

    @staticmethod
    def forward(ctx, run, twin, *args):
        ctx.twin = twin
        ctx.save_for_backward(*args)
        ctx.save_for_forward(*args)
        return tuple(run(*args))

    @staticmethod
    def backward(ctx, *ws):
        return (None, None, *vjp(ctx.twin, ctx.saved_tensors, ws, create_graph=torch.is_grad_enabled()))

    @staticmethod
    def jvp(ctx, _run, _twin, *tangents):
        return tuple(jvp(ctx.twin, ctx.saved_tensors, tangents))


def bwd2_apply(run, twin, inputs, cts, zs, expand=list):
    """The second order of a fused phase through ``Bwd2``, differentiable at
    every order: ``run(inputs, cts, Z)`` the kernels' gradients of (inputs,
    cts) as (g_inputs, g_cts), ``twin`` the phase's plain twin (a function
    of the inputs returning its outputs), ``zs`` the Zs on the backward's
    outputs, ``expand`` their map to one Z per input.  Returns the gradients
    of (inputs, cts), flat."""
    ni, nc = len(inputs), len(cts)

    def split(a):
        return a[:ni], a[ni:ni + nc], expand(a[ni + nc:])

    def run_flat(*a):
        return flat(run(*split(a)))

    def twin_flat(*a):
        ins, c, z = split(a)
        return flat(second_order(twin, ins, c, z, create_graph=True))

    return Bwd2.apply(run_flat, twin_flat, *inputs, *cts, *zs)
