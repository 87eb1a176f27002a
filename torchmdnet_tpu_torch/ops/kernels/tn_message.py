"""The TensorNet message phase as fused CUDA kernels: forward, backward and
second order.

Counterpart of torchmdnet_tpu/ops/pallas/tn_message.py.  The kernels
(``csrc/tn_message.cu``) replace the Pallas TPU kernels ``_fwd_kernel``
(tn_message.py:77), ``_bwd_kernel`` (:107) and ``_tn_bwd2_kernel`` (:455).
The source file's header says what bounds them on an H100 and what their
design does about it.

``fused_tn_messages`` computes, without any (N, K, F) tensor in device
memory,

    w   = act(L3(act(L2(act(L1(ea)))))) * cutm              (N, K, 3H)
    m_i = sum_k wb(comp)[i, k] * cat[idx[i, k], comp]        (N, 9H)

with the JAX kernel's layout (cat holds the nine irrep components
[lam, a10, a20, a21, s00, s11, s01, s02, s12]; w's thirds multiply them as
I, A x3, S x5; weights (in, out), biases (1, F)) and precision (bf16
operands, products rounded to bf16, f32 sums over K, f32 output).  Its
gradient is the backward kernel: one reverse pass (forces) runs one forward
and one backward launch per layer.  The backward is differentiable once
(``_TnMessagesBwd``): its gradient is the second-order kernel, so a
force-loss training step runs per layer one forward, two backward (the inner
force pass and the outer energy term) and one second-order launch.  A third
derivative raises.

``tn_messages_reference`` is the plain PyTorch version of the same function
(the counterpart of ``_composable_tn_reference``, tn_message.py:241), with
gradients from autograd; ``tn_messages_bwd2_reference`` is the plain version
of the second-order kernel (the counterpart of ``_composable_tn_bwd_vjp``,
:380).  ``fused_tn_messages`` uses the plain version only for tensors on the
CPU.

The backward kernel's source-row cotangent uses the symmetry of the list:
``w[i, k]`` depends only on the edge's distance and cutoff, equal for (i, j)
and (j, i), so it gathers ``ct`` through ``idx`` instead of scattering.  It
needs what the port already requires of every list, a symmetric list that did
not overflow (``transpose_perm`` raises otherwise), with ``ea`` and ``cutm``
functions of the distance (ROADMAP.md, section 3).
"""

import ctypes
from typing import Optional

import torch

from torchmdnet_tpu_torch.ops.kernels import build
from torchmdnet_tpu_torch.ops.kernels.et_message import _act_v, _check, _ptr
from torchmdnet_tpu_torch.ops.neighbors import ell_gather, transpose_perm

SOURCE = "tn_message.cu"
_ACT_CODE = {"silu": 0, "ssp": 1, "tanh": 2, "sigmoid": 3}
ORDER = ("cat", "ea", "cutm", "w1", "b1", "w2", "b2", "w3", "b3")

_P = ctypes.c_void_p
_I = ctypes.c_int
_COMMON = [_P, _I, _I, _I, _I] + [_P] * 9 + [_I]


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.tn_error_string.argtypes = [_I]
        lib.tn_error_string.restype = ctypes.c_char_p
        lib.tn_fwd.argtypes = _COMMON + [_P, _P]
        lib.tn_bwd.argtypes = _COMMON + [_P] * 6
        lib.tn_bwd2.argtypes = _COMMON + [_P] * 16
        lib.tn_src_sum.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P]
        lib.tn_wgrad.argtypes = [_P] * 4 + [_I] * 6 + [_P, _P]
        lib.tn_colsum.argtypes = [_P] + [_I] * 4 + [_P, _P]
        for fn in (lib.tn_fwd, lib.tn_bwd, lib.tn_bwd2, lib.tn_src_sum, lib.tn_wgrad, lib.tn_colsum):
            fn.restype = _I
        lib._argtypes_set = True
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.tn_error_string(err).decode()})")


def _edge_weights(ea, cutm, w1, b1, w2, b2, w3, b3, act):
    """(N, K, 3, H) per-edge multipliers wb = act(L3(act(L2(act(L1 ea))))) * cutm
    with the kernels' rounding points: each product in f32 (at least) rounded
    to the operand dtype before + b, activations in f32 rounded back."""
    n, kk, _ = ea.shape
    bf = ea.dtype
    acc = torch.float32 if bf in (torch.bfloat16, torch.float16) else bf
    t = ea.reshape(n * kk, -1)
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        t = _act_v(act, torch.matmul(t.to(acc), w.to(acc)).to(bf) + b)
    return t.reshape(n, kk, 3, -1) * cutm[..., None, None].to(bf)


def tn_messages_reference(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, *, act: str = "silu",
                          perm: Optional[torch.Tensor] = None):
    """Plain PyTorch twin of the fused kernels: the same math in the same
    precision (bf16 products, f32 sums) from composable ops.

    Args (one message dtype, normally bf16, except cutm):
        idx: (N, K) int32 ELL neighbor list (symmetric); perm its
            ``transpose_perm`` (computed when None).
        cat: (N, 9H) the nine irrep components of the source rows.
        ea: (N, K, RBF) edge RBF features; cutm: (N, K) f32 cutoff * mask.
        w1 (RBF, H), b1 (1, H), w2 (H, 2H), b2 (1, 2H), w3 (2H, 3H),
            b3 (1, 3H): the edge MLP.
    Returns m (N, 9H) in f32 (f64 for f64 inputs).
    """
    n, kk = idx.shape
    h = cat.shape[1] // 9
    acc = torch.float32 if cat.dtype in (torch.bfloat16, torch.float16) else cat.dtype
    if perm is None:
        perm = transpose_perm(idx)
    wb = _edge_weights(ea, cutm, w1, b1, w2, b2, w3, b3, act)
    g = ell_gather(cat, idx, perm).reshape(n, kk, 9, h)
    # I multiplies component 0, A components 1-3, S components 4-8
    prod = torch.cat([g[:, :, :1] * wb[:, :, 0:1], g[:, :, 1:4] * wb[:, :, 1:2],
                      g[:, :, 4:] * wb[:, :, 2:3]], dim=2)
    return prod.to(acc).sum(dim=1).reshape(n, 9 * h)


def _prepare(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3):
    """Validate the operands; return ((N, K, H, RBF), the nine operands in
    the kernels' layout: weights contiguous (in, out), w1 zero-padded to
    RBFP = RBF rounded up to 16 rows, biases flat)."""
    dev = cat.device
    n, kk = idx.shape
    h = cat.shape[1] // 9
    rbf = ea.shape[-1]
    rbfp = -(-rbf // 16) * 16
    if h % 32 or not 32 <= h <= 128 or rbfp > 128 or cat.shape[1] != 9 * h:
        raise ValueError(f"the fused TensorNet kernels take 32 <= H <= 128 with H % 32 == 0 and "
                         f"RBF <= 128; got H={cat.shape[1] / 9}, RBF={rbf}")
    bf = torch.bfloat16
    _check(idx, "idx", torch.int32, (n, kk), dev)
    _check(cat, "cat", bf, (n, 9 * h), dev)
    _check(ea, "ea", bf, (n, kk, rbf), dev)
    _check(cutm, "cutm", torch.float32, (n, kk), dev)
    w1p = torch.zeros((rbfp, h), dtype=bf, device=dev)
    w1p[:rbf] = w1
    ws = [w1p, b1.reshape(-1).contiguous(), w2.contiguous(), b2.reshape(-1).contiguous(),
          w3.contiguous(), b3.reshape(-1).contiguous()]
    for t, name, shape in zip(ws, ("w1", "b1", "w2", "b2", "w3", "b3"),
                              ((rbfp, h), (h,), (h, 2 * h), (2 * h,), (2 * h, 3 * h), (3 * h,))):
        _check(t, name, bf, shape, dev)
    return (n, kk, h, rbf), [cat, ea, cutm] + ws


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def run_fwd(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, *, act):
    """Launch the forward kernel; returns m (N, 9H) f32."""
    lib = _lib()
    (n, kk, h, rbf), ops = _prepare(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3)
    m = torch.empty((n, 9 * h), dtype=torch.float32, device=cat.device)
    with torch.cuda.device(cat.device):
        err = lib.tn_fwd(_ptr(idx), n, kk, h, rbf, *[_ptr(t) for t in ops], _ACT_CODE[act], _ptr(m),
                         _stream(cat.device))
    _raise_on(lib, err, "tn_fwd launch")
    run_fwd.launches += 1
    return m


run_fwd.launches = 0


def _splits(tiles, e_pad):
    """Edge splits of a weight-gradient reduction: about two waves of blocks."""
    return max(1, min(e_pad // 16, -(-264 // tiles)))


def _weight_grad(lib, pairs, pn, qn, e_pad, dev, stream):
    """(P, Q) f32 = sum over edges of a^T b for the given (a, b, lda, ldb)
    pairs (one or two), on the tensor cores in edge splits summed here once."""
    splits = _splits(-(-pn // 64) * -(-qn // 64), e_pad)
    part = torch.empty((splits, pn, qn), dtype=torch.float32, device=dev)
    (a1, b1, lda, ldb), *rest = pairs
    a2, b2 = (rest[0][0], rest[0][1]) if rest else (None, None)
    err = lib.tn_wgrad(_ptr(a1), _ptr(b1), _ptr(a2), _ptr(b2), lda, ldb, e_pad, pn, qn, splits,
                       _ptr(part), stream)
    _raise_on(lib, err, "tn_wgrad launch")
    return part.sum(dim=0)


def _bias_grad(lib, b, ldb, e, qn, dev, stream):
    splits = max(1, min(e, 64))
    part = torch.empty((splits, qn), dtype=torch.float32, device=dev)
    err = lib.tn_colsum(_ptr(b), ldb, e, qn, splits, _ptr(part), stream)
    _raise_on(lib, err, "tn_colsum launch")
    return part.sum(dim=0)


def _save_buffer(e, width, dev):
    """(E_pad, width) bf16 per-edge rows, E_pad = E rounded up to 16, the
    padding rows zero."""
    e_pad = -(-e // 16) * 16
    save = torch.empty((e_pad, width), dtype=torch.bfloat16, device=dev)
    save[e:].zero_()
    return save, e_pad


def _cols(save, start, width):
    """A column block of the per-edge rows (a view; the kernels take its
    pointer with the full row stride)."""
    return save[:, start:start + width]


def run_bwd(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct, *, act, want_weight_grads: bool):
    """Launch the backward kernel (and, when the weight cotangents are
    wanted, their reductions over the edges).

    Returns (d_cat, d_ea, d_cutm, dw1, db1, dw2, db2, dw3, db3) in the
    operands' dtypes; the weight cotangents are None unless
    ``want_weight_grads``."""
    lib = _lib()
    (n, kk, h, rbf), ops = _prepare(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3)
    dev = cat.device
    f32 = torch.float32
    _check(ct, "ct", f32, (n, 9 * h), dev)
    rbfp = -(-rbf // 16) * 16
    e = n * kk
    dcat = torch.empty((n, 9 * h), dtype=torch.bfloat16, device=dev)
    dea = torch.empty((n, kk, rbf), dtype=torch.bfloat16, device=dev)
    dcutm = torch.empty((n, kk), dtype=f32, device=dev)
    wgrads = (None,) * 6
    with torch.cuda.device(dev):
        stream = _stream(dev)
        save = None
        if want_weight_grads:
            width = rbfp + 9 * h
            save, e_pad = _save_buffer(e, width, dev)
        err = lib.tn_bwd(_ptr(idx), n, kk, h, rbf, *[_ptr(t) for t in ops], _ACT_CODE[act], _ptr(ct),
                         _ptr(dcat), _ptr(dea), _ptr(dcutm), _ptr(save), stream)
        _raise_on(lib, err, "tn_bwd launch")
        if want_weight_grads:
            # rows [ea | t1 | d_p1 | t2 | d_p2 | d_p3]
            o_t1, o_p1, o_t2, o_p2, o_p3 = rbfp, rbfp + h, rbfp + 2 * h, rbfp + 4 * h, rbfp + 6 * h
            c = lambda o, w: _cols(save, o, w)
            g = lambda a, wa, b, wb, pn, qn: _weight_grad(
                lib, [(c(a, wa), c(b, wb), width, width)], pn, qn, e_pad, dev, stream)
            dw1 = g(0, rbfp, o_p1, h, rbfp, h)[:rbf]
            dw2 = g(o_t1, h, o_p2, 2 * h, h, 2 * h)
            dw3 = g(o_t2, 2 * h, o_p3, 3 * h, 2 * h, 3 * h)
            db = [_bias_grad(lib, c(o, w), width, e, w, dev, stream)
                  for o, w in ((o_p1, h), (o_p2, 2 * h), (o_p3, 3 * h))]
            wgrads = (dw1.to(w1.dtype), db[0].reshape(b1.shape).to(b1.dtype),
                      dw2.to(w2.dtype), db[1].reshape(b2.shape).to(b2.dtype),
                      dw3.to(w3.dtype), db[2].reshape(b3.shape).to(b3.dtype))
    run_bwd.launches += 1
    return (dcat.to(cat.dtype), dea, dcutm) + wgrads


run_bwd.launches = 0


def run_bwd2(idx, perm, inputs, ct, Z, *, act):
    """Launch the second-order kernel, the source-row sum of its g_cat, and
    the reductions of its weight gradients.

    ``inputs`` are the nine operands, ``ct`` (N, 9H), ``Z`` the nine
    cotangents on ``run_bwd``'s outputs (None means zero).  Returns
    (g_inputs (9, in the inputs' dtypes), g_ct (N, 9H) f32)."""
    lib = _lib()
    cat, ea, cutm, w1, b1, w2, b2, w3, b3 = inputs
    (n, kk, h, rbf), ops = _prepare(idx, *inputs)
    dev = cat.device
    f32, bf = torch.float32, torch.bfloat16
    ct = ct.to(f32).contiguous()
    _check(ct, "ct", f32, (n, 9 * h), dev)
    _check(perm, "perm", torch.int32, (n * kk,), dev)
    rbfp = -(-rbf // 16) * 16

    def z(i, like, dtype):
        t = Z[i]
        return torch.zeros(like.shape, dtype=dtype, device=dev) if t is None else t.to(dtype).contiguous()

    zw1 = torch.zeros((rbfp, h), dtype=bf, device=dev)
    zw1[:rbf] = z(3, w1, bf)
    zs = [z(0, cat, bf), z(1, ea, bf), z(2, cutm, f32), zw1, z(4, b1, bf).reshape(-1),
          z(5, w2, bf), z(6, b2, bf).reshape(-1), z(7, w3, bf), z(8, b3, bf).reshape(-1)]
    e = n * kk
    gea = torch.empty((n, kk, rbf), dtype=bf, device=dev)
    gcutm = torch.empty((n, kk), dtype=f32, device=dev)
    gct = torch.empty((n, 9 * h), dtype=f32, device=dev)
    wdot = torch.empty((e, 3 * h), dtype=f32, device=dev)
    gcat = torch.empty((n, 9 * h), dtype=bf, device=dev)
    width = 2 * rbfp + 18 * h
    with torch.cuda.device(dev):
        stream = _stream(dev)
        save, e_pad = _save_buffer(e, width, dev)
        err = lib.tn_bwd2(_ptr(idx), n, kk, h, rbf, *[_ptr(t) for t in ops], _ACT_CODE[act], _ptr(ct),
                          *[_ptr(t) for t in zs], _ptr(gea), _ptr(gcutm), _ptr(gct), _ptr(wdot),
                          _ptr(save), stream)
        _raise_on(lib, err, "tn_bwd2 launch")
        err = lib.tn_src_sum(_ptr(perm), n, kk, h, _ptr(ct), _ptr(wdot), _ptr(gcat), stream)
        _raise_on(lib, err, "tn_src_sum launch")
        # rows [ea | z_ea | t1 | t1' | p1_bar | p1'_bar | t2 | t2' | p2_bar | p2'_bar | p3_bar | p3'_bar]
        o = {}
        at = 0
        for name, w in (("ea", rbfp), ("zea", rbfp), ("t1", h), ("td1", h), ("p1", h), ("pd1", h),
                        ("t2", 2 * h), ("td2", 2 * h), ("p2", 2 * h), ("pd2", 2 * h),
                        ("p3", 3 * h), ("pd3", 3 * h)):
            o[name] = (_cols(save, at, w), w)
            at += w

        def g(a, b, ad, bd):
            (ca, wa), (cb, wb) = o[a], o[b]
            return _weight_grad(lib, [(ca, cb, width, width), (o[ad][0], o[bd][0], width, width)],
                                wa, wb, e_pad, dev, stream)

        gw1 = g("ea", "p1", "zea", "pd1")[:rbf]
        gw2 = g("t1", "p2", "td1", "pd2")
        gw3 = g("t2", "p3", "td2", "pd3")
        gb = [_bias_grad(lib, o[nm][0], width, e, o[nm][1], dev, stream) for nm in ("p1", "p2", "p3")]
    run_bwd2.launches += 1
    g_inputs = (gcat.to(cat.dtype), gea.to(ea.dtype), gcutm,
                gw1.to(w1.dtype), gb[0].reshape(b1.shape).to(b1.dtype),
                gw2.to(w2.dtype), gb[1].reshape(b2.shape).to(b2.dtype),
                gw3.to(w3.dtype), gb[2].reshape(b3.shape).to(b3.dtype))
    return g_inputs, gct


run_bwd2.launches = 0


def reset_launch_counts():
    run_fwd.launches = 0
    run_bwd.launches = 0
    run_bwd2.launches = 0


def _wide(t):
    """f32 for low-precision tensors, else the tensor's own dtype."""
    return t if t.dtype == torch.float64 else t.float()


def tn_messages_bwd2_reference(idx, perm, inputs, ct, Z, *, act: str = "silu"):
    """Plain version of the second-order kernel (the counterpart of
    ``_composable_tn_bwd_vjp``, tn_message.py:380): the gradient over
    (inputs, ct) of <vjp(tn_messages_reference)(ct), Z>, from
    ``torch.autograd.grad(..., create_graph=True)``.

    ``inputs`` are the nine operands, ``ct`` (N, 9H), ``Z`` nine cotangents
    on the first-order gradients (None means zero).  Returns (g_inputs (9,
    zeros for an input that does not reach S), g_ct)."""
    with torch.enable_grad():
        a = [t.detach().requires_grad_(True) for t in inputs]
        c = ct.detach().requires_grad_(True)
        out = tn_messages_reference(idx, *a, act=act, perm=perm)
        g = torch.autograd.grad(out, a, c, create_graph=True, allow_unused=True)
        s = sum((_wide(gi) * _wide(zi)).sum() for gi, zi in zip(g, Z) if gi is not None and zi is not None)
        leaves = a + [c]
        grads = torch.autograd.grad(s, leaves, allow_unused=True) if torch.is_tensor(s) else [None] * 10
    full = tuple(torch.zeros_like(t) if gr is None else gr for t, gr in zip(leaves, grads))
    return full[:9], full[9]


_THIRD_ORDER = (
    "third derivatives of the fused TensorNet message phase are not supported: "
    "the second-order kernel is differentiable no further (JAX's composable "
    "third-order rule, torchmdnet_tpu/ops/pallas/tn_message.py:654, is queued "
    "in ROADMAP.md)"
)


class _TnMessages(torch.autograd.Function):
    """The fused message phase; its backward is the backward kernel, itself
    differentiable once through ``_TnMessagesBwd`` when grad mode is on
    (``create_graph=True``: a force-loss training step's inner pass)."""

    @staticmethod
    def forward(ctx, act, idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3):
        ctx.act = act
        ctx.save_for_backward(idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3)
        return run_fwd(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, act=act)

    @staticmethod
    def backward(ctx, ct):
        idx, perm, *inputs = ctx.saved_tensors
        # serving freezes the weights: no weight cotangents then
        want_w = any(ctx.needs_input_grad[6:12])
        ct = ct.contiguous()
        if torch.is_grad_enabled():
            g = _TnMessagesBwd.apply(ctx.act, want_w, idx, perm, *inputs, ct)
        else:
            g = run_bwd(idx, *inputs, ct, act=ctx.act, want_weight_grads=want_w)
        return (None, None, None) + tuple(g)


class _TnMessagesBwd(torch.autograd.Function):
    """The backward kernel as a function of (inputs, ct); its gradient is the
    second-order kernel.  Outputs are ``run_bwd``'s nine."""

    @staticmethod
    def forward(ctx, act, want_w, idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct):
        ctx.act = act
        ctx.save_for_backward(idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct)
        return run_bwd(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct, act=act,
                       want_weight_grads=want_w)

    @staticmethod
    def backward(ctx, *zs):
        if torch.is_grad_enabled():  # create_graph=True once more: a third derivative
            raise NotImplementedError(_THIRD_ORDER)
        idx, perm, *rest = ctx.saved_tensors
        g_inputs, g_ct = run_bwd2(idx, perm, rest[:9], rest[9], list(zs), act=ctx.act)
        return (None, None, None, None) + tuple(g_inputs) + (g_ct,)


def fused_tn_messages(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, *, act: str = "silu",
                      perm: Optional[torch.Tensor] = None):
    """Fused TensorNet message phase: m (N, 9H) in f32.

    Arguments as ``tn_messages_reference``; on the GPU the message operands
    are bf16.  CUDA tensors run the kernels (or raise); CPU tensors run the
    plain version.
    """
    if cat.device.type == "cpu":
        return tn_messages_reference(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, act=act, perm=perm)
    if cat.device.type != "cuda":
        raise ValueError(f"fused_tn_messages runs on cuda or cpu tensors, not {cat.device}")
    if act not in _ACT_CODE:
        raise ValueError(f"unsupported activation for the fused TensorNet kernel: {act}")
    if perm is None:
        perm = transpose_perm(idx)
    return _TnMessages.apply(act, idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3)
