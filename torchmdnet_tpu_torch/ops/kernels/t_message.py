"""The Transformer (TorchMD_T) attention edge phase as fused CUDA kernels:
forward, backward and second order.

Counterpart of torchmdnet_tpu/ops/pallas/t_message.py.  The kernels
(``csrc/t_message.cu``) replace the Pallas TPU kernels ``_fwd_kernel``
(t_message.py:66), ``_bwd_kernel`` (:113) and ``_t_bwd2_kernel`` (:519).  The
source file's header says what bounds them on an H100 and what their design
does about it.

``fused_t_messages`` computes, without any (N, K, H) tensor in device memory
in the forward,

    out (N, H) = sum_k v_j * dv * attn,
    attn = attn_act(per-head sum of q_i * k_j * dk) * cutm,
    dk = act(ea . Wdk + bdk),  dv = act(ea . Wdv + bdv)

with the JAX kernel's precision (bf16 operands, products rounded to bf16,
the filter pre-activation rounded to bf16 before the bias, f32 sums, f32
output).  It is ``et_message.py``'s edge phase without the vector features,
wired the same way: its gradient is the backward kernel (one forward and one
backward launch per layer in a reverse pass); the backward is differentiable
once more through ``_TMessagesBwd``, whose gradient is the second-order
kernel, so a force-loss training step runs per layer one forward, two
backward and one second-order launch; a third derivative raises.  The
per-edge source-row cotangents go onto the atoms through ``et_message.cu``'s
transpose-sum, with no float atomics.

``t_messages_reference`` is the plain PyTorch version (the counterpart of
``_composable_t_reference``, t_message.py:354), with gradients from
autograd; ``t_messages_bwd2_reference`` is the plain version of the
second-order kernel (the counterpart of ``_composable_t_bwd_vjp``, :443).
``fused_t_messages`` uses the plain version only for tensors on the CPU.
"""

import ctypes
from typing import Optional

import torch

from torchmdnet_tpu_torch.ops.kernels import build
from torchmdnet_tpu_torch.ops.kernels import et_message as em
from torchmdnet_tpu_torch.ops.neighbors import ell_gather, transpose_perm

SOURCE = "t_message.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_COMMON = [_P, _I, _I, _I, _I, _I] + [_P] * 9 + [_I, _I]


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.t_error_string.argtypes = [_I]
        lib.t_error_string.restype = ctypes.c_char_p
        lib.t_fwd.argtypes = _COMMON + [_P, _P]
        lib.t_fwd.restype = _I
        lib.t_bwd.argtypes = _COMMON + [_P] * 8
        lib.t_bwd.restype = _I
        lib.t_bwd2.argtypes = _COMMON + [_P] * 18
        lib.t_bwd2.restype = _I
        lib.t_plan.argtypes = [_I] * 6 + [_P, _P]
        lib.t_plan.restype = _I
        lib._argtypes_set = True
    return lib


def t_messages_reference(
    idx, q, k, v, ea, cutm, wdk=None, bdk=None, wdv=None, bdv=None, *, heads: int,
    act: str = "silu", attn_act: str = "silu", perm: Optional[torch.Tensor] = None,
):
    """Plain PyTorch twin of the fused kernels: the same math in the same
    precision (bf16 products, f32 sums) from composable ops.

    Args (one message dtype, normally bf16, except where noted):
        idx: (N, K) int32 ELL neighbor list (symmetric); perm its
            ``transpose_perm`` (computed when None).
        q, k, v: (N, H) node projections.
        ea: (N, K, RBF) edge RBF features.
        cutm: (N, K) f32 cosine_cutoff(dist) * mask.
        wdk (RBF, H), bdk (1, H), wdv (RBF, H), bdv (1, H): the distance
            filters; None where distance_influence leaves a filter out.
    Returns out (N, H) in f32 (f64 for f64 inputs).
    """
    n, kk = idx.shape
    h = q.shape[1]
    bf = q.dtype
    acc = torch.float32 if bf in (torch.bfloat16, torch.float16) else bf
    if perm is None:
        perm = transpose_perm(idx)
    ea2 = ea.reshape(n * kk, -1)

    def filt(w, b):
        pre = torch.matmul(ea2.to(acc), w.to(acc))
        return em._act_v(act, pre.to(bf) + b).reshape(n, kk, h)

    dk = filt(wdk, bdk) if wdk is not None else None
    dv = filt(wdv, bdv) if wdv is not None else None
    prod = q[:, None, :] * ell_gather(k, idx, perm)
    if dk is not None:
        prod = prod * dk
    hd = h // heads
    head_sum = prod.to(acc).reshape(n, kk, heads, hd).sum(dim=-1, keepdim=True)
    pre_a = head_sum.expand(n, kk, heads, hd).reshape(n, kk, h).to(bf)
    attn = em._act_v(attn_act, pre_a) * cutm[..., None].to(bf)
    vdv = ell_gather(v, idx, perm)
    if dv is not None:
        vdv = vdv * dv
    return (vdv * attn).to(acc).sum(dim=1)


def _prepare(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, heads):
    """Validate the operands; return ((N, K, H, RBF), the 9 operands in the
    kernel's order, with the filters transposed to its (H, RBF) layout)."""
    dev = q.device
    n, kk = idx.shape
    h = q.shape[1]
    rbf = ea.shape[-1]
    hd = h // heads if heads > 0 else 0
    if h % 32 or h > 1024 or heads <= 0 or h % heads or hd > 32 or hd & (hd - 1) or rbf % 2:
        raise ValueError(
            f"the fused Transformer kernel takes H % 32 == 0, H <= 1024, H/heads a power "
            f"of two <= 32 and an even RBF; got H={h}, heads={heads}, RBF={rbf}"
        )
    bf = torch.bfloat16
    check = em._check
    check(idx, "idx", torch.int32, (n, kk), dev)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check(t, name, bf, (n, h), dev)
    check(ea, "ea", bf, (n, kk, rbf), dev)
    check(cutm, "cutm", torch.float32, (n, kk), dev)
    # the kernel reads the filters as (H, RBF) rows: torch's Linear layout
    wk = bk = wv = bv = None
    if wdk is not None:
        wk, bk = wdk.t().contiguous(), bdk.reshape(-1).contiguous()
        check(wk, "wdk^T", bf, (h, rbf), dev)
        check(bk, "bdk", bf, (h,), dev)
    if wdv is not None:
        wv, bv = wdv.t().contiguous(), bdv.reshape(-1).contiguous()
        check(wv, "wdv^T", bf, (h, rbf), dev)
        check(bv, "bdv", bf, (h,), dev)
    return (n, kk, h, rbf), [q, k, v, ea, cutm, wk, bk, wv, bv]


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.t_error_string(err).decode()})")


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def run_fwd(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, *, heads, act, attn_act):
    """Launch the forward kernel; returns out (N, H) f32."""
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, heads)
    out = torch.empty((n, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.t_fwd(
            em._ptr(idx), n, kk, h, heads, rbf, *[em._ptr(t) for t in tensors],
            em._ACT_CODE[act], em._ACT_CODE[attn_act], em._ptr(out), _stream(q.device),
        )
    _raise_on(lib, err, "t_fwd launch")
    run_fwd.launches += 1
    return out


run_fwd.launches = 0


def _weight_partials(lib, kind, n, kk, h, heads, rbf, dev):
    """Per-block f32 weight-gradient partials of a kernel's grid (kind 1
    backward, 2 second order): (blocks, RBFP, 2H) and (blocks * groups, 2H)."""
    blocks, groups = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.t_plan(kind, n, kk, h, heads, rbf, ctypes.byref(blocks), ctypes.byref(groups))
    _raise_on(lib, err, "t_plan")
    rbfp = -(-rbf // 16) * 16
    return (torch.empty((blocks.value, rbfp, 2 * h), dtype=torch.float32, device=dev),
            torch.empty((blocks.value * groups.value, 2 * h), dtype=torch.float32, device=dev))


def _sum_partials(dw_part, db_part, rbf, h, wdk, bdk, wdv, bdv):
    """The per-block f32 partials summed once and rounded once to the
    weights' dtype: (dwdk, dbdk, dwdv, dbdv), None for an absent filter."""
    dw = dw_part.sum(dim=0)[:rbf]
    db = db_part.sum(dim=0)
    dwdk = dbdk = dwdv = dbdv = None
    if wdk is not None:
        dwdk = dw[:, :h].to(wdk.dtype)
        dbdk = db[:h].reshape(bdk.shape).to(bdk.dtype)
    if wdv is not None:
        dwdv = dw[:, h:].contiguous().to(wdv.dtype)
        dbdv = db[h:].reshape(bdv.shape).to(bdv.dtype)
    return dwdk, dbdk, dwdv, dbdv


def run_bwd(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct, *, heads, act, attn_act,
            want_weight_grads: bool):
    """Launch the backward kernel and the transpose-sum of its source-row
    cotangents.  The weight cotangents, when wanted, are accumulated by the
    kernel into per-block f32 partials, summed here once.

    Returns (dq, dk, dv, dea, dcutm, dwdk, dbdk, dwdv, dbdv) in the operands'
    dtypes; the weight cotangents are None unless ``want_weight_grads``."""
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, heads)
    dev = q.device
    em._check(perm, "perm", torch.int32, (n * kk,), dev)
    em._check(ct, "ct", torch.float32, (n, h), dev)
    f32 = torch.float32
    want_dw = want_weight_grads and (wdk is not None or wdv is not None)
    dq = torch.empty((n, h), dtype=f32, device=dev)
    dea = torch.empty((n, kk, rbf), dtype=torch.bfloat16, device=dev)
    dcutm = torch.empty((n, kk), dtype=f32, device=dev)
    dsrc_edge = torch.empty((n, kk, 2 * h), dtype=torch.bfloat16, device=dev)
    dw_part = db_part = None
    with torch.cuda.device(dev):
        if want_dw:
            dw_part, db_part = _weight_partials(lib, 1, n, kk, h, heads, rbf, dev)
        stream = _stream(dev)
        err = lib.t_bwd(
            em._ptr(idx), n, kk, h, heads, rbf, *[em._ptr(t) for t in tensors],
            em._ACT_CODE[act], em._ACT_CODE[attn_act], em._ptr(ct), em._ptr(dq), em._ptr(dea),
            em._ptr(dcutm), em._ptr(dsrc_edge), em._ptr(dw_part), em._ptr(db_part), stream,
        )
        _raise_on(lib, err, "t_bwd launch")
        dsrc = em._transpose_sum_rows(em._lib(), dsrc_edge, perm, n, kk, 2 * h, dev, stream)
    run_bwd.launches += 1
    dwdk = dbdk = dwdv = dbdv = None
    if want_dw:
        dwdk, dbdk, dwdv, dbdv = _sum_partials(dw_part, db_part, rbf, h, wdk, bdk, wdv, bdv)
    return (dq.to(q.dtype), dsrc[:, :h].contiguous(), dsrc[:, h:].contiguous(), dea, dcutm,
            dwdk, dbdk, dwdv, dbdv)


run_bwd.launches = 0


def _filters_all(wdk, wdv, h, rbf, like):
    """(2H, RBFP) bf16: the dk filter's columns, then the dv filter's, as
    rows; zero rows for an absent filter, zero padding columns."""
    rbfp = -(-rbf // 16) * 16
    w = torch.zeros((2 * h, rbfp), dtype=torch.bfloat16, device=like.device)
    if wdk is not None:
        w[:h, :rbf] = wdk.t()
    if wdv is not None:
        w[h:, :rbf] = wdv.t()
    return w


def run_bwd2(idx, perm, inputs, ct, Z, *, heads, act, attn_act):
    """Launch the second-order kernel and the transpose-sum of its source-row
    gradients.

    ``inputs`` are the fused op's 9 operands (filters None where absent),
    ``ct`` the f32 (N, H) cotangent, ``Z`` the 9 cotangents on ``run_bwd``'s
    outputs (None means zero).  Returns (g_inputs, g_ct): the 9 gradients in
    the inputs' dtypes (None for absent filters) and g_ct f32."""
    lib = _lib()
    q, k, v, ea, cutm, wdk, bdk, wdv, bdv = inputs
    (n, kk, h, rbf), tensors = _prepare(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, heads)
    if h > 256:
        raise ValueError(f"the second-order Transformer kernel takes H <= 256; got H={h}")
    dev = q.device
    f32, bf = torch.float32, torch.bfloat16
    ct = ct.to(f32).contiguous()
    em._check(perm, "perm", torch.int32, (n * kk,), dev)
    em._check(ct, "ct", f32, (n, h), dev)

    def z(i, like, dtype):
        t = Z[i]
        return torch.zeros(like.shape, dtype=dtype, device=dev) if t is None else t.to(dtype).contiguous()

    zs = [z(0, q, bf), z(1, k, bf), z(2, v, bf), z(3, ea, bf), z(4, cutm, f32)]
    has_w = wdk is not None or wdv is not None
    w_all = zw_all = zbk = zbv = None
    if has_w:
        w_all = _filters_all(wdk, wdv, h, rbf, q)
        zw_all = _filters_all(None if wdk is None else z(5, wdk, bf),
                              None if wdv is None else z(7, wdv, bf), h, rbf, q)
        if wdk is not None:
            zbk = z(6, bdk, bf).reshape(-1)
        if wdv is not None:
            zbv = z(8, bdv, bf).reshape(-1)
    gq = torch.empty((n, h), dtype=f32, device=dev)
    gea = torch.empty((n, kk, rbf), dtype=bf, device=dev)
    gcutm = torch.empty((n, kk), dtype=f32, device=dev)
    gsrc_edge = torch.empty((n, kk, 2 * h), dtype=f32, device=dev)
    gct = torch.empty((n, h), dtype=f32, device=dev)
    dw_part = db_part = None
    with torch.cuda.device(dev):
        if has_w:
            dw_part, db_part = _weight_partials(lib, 2, n, kk, h, heads, rbf, dev)
        stream = _stream(dev)
        err = lib.t_bwd2(
            em._ptr(idx), n, kk, h, heads, rbf, *[em._ptr(t) for t in tensors],
            em._ACT_CODE[act], em._ACT_CODE[attn_act], em._ptr(ct),
            *[em._ptr(t) for t in zs], em._ptr(w_all), em._ptr(zw_all), em._ptr(zbk), em._ptr(zbv),
            em._ptr(gq), em._ptr(gea), em._ptr(gcutm), em._ptr(gsrc_edge), em._ptr(gct),
            em._ptr(dw_part), em._ptr(db_part), stream,
        )
        _raise_on(lib, err, "t_bwd2 launch")
        gsrc = em._transpose_sum_rows(em._lib(), gsrc_edge, perm, n, kk, 2 * h, dev, stream)
    run_bwd2.launches += 1
    gw = (None,) * 4
    if has_w:
        gw = _sum_partials(dw_part, db_part, rbf, h, wdk, bdk, wdv, bdv)
    g_inputs = (gq.to(q.dtype), gsrc[:, :h].contiguous(), gsrc[:, h:].contiguous(), gea, gcutm, *gw)
    return g_inputs, gct


run_bwd2.launches = 0


def reset_launch_counts():
    run_fwd.launches = 0
    run_bwd.launches = 0
    run_bwd2.launches = 0


def t_messages_bwd2_reference(idx, perm, inputs, ct, Z, *, heads: int, act: str = "silu",
                              attn_act: str = "silu"):
    """Plain version of the second-order kernel (the counterpart of
    ``_composable_t_bwd_vjp``, t_message.py:443): the gradient over
    (inputs, ct) of <vjp(t_messages_reference)(ct), Z>, from
    ``torch.autograd.grad(..., create_graph=True)``.

    ``inputs`` are the 9 operands (filters None where absent), ``ct`` the
    (N, H) cotangent, ``Z`` 9 cotangents on the first-order gradients (None
    means zero).  Returns (g_inputs (9, zeros for an input that does not
    reach S, None for an absent filter), g_ct)."""
    with torch.enable_grad():
        a = [None if t is None else t.detach().requires_grad_(True) for t in inputs]
        c = ct.detach().requires_grad_(True)
        out = t_messages_reference(idx, *a, heads=heads, act=act, attn_act=attn_act, perm=perm)
        live = [i for i, t in enumerate(a) if t is not None]
        g = torch.autograd.grad(out, [a[i] for i in live], c, create_graph=True, allow_unused=True)
        s = sum(
            (em._wide(gi) * em._wide(Z[i])).sum()
            for i, gi in zip(live, g)
            if gi is not None and Z[i] is not None
        )
        leaves = [a[i] for i in live] + [c]
        grads = torch.autograd.grad(s, leaves, allow_unused=True) if torch.is_tensor(s) else [None] * len(leaves)
    full = [None] * 9
    for i, gr in zip(live, grads):
        full[i] = torch.zeros_like(a[i]) if gr is None else gr
    g_ct = torch.zeros_like(c) if grads[-1] is None else grads[-1]
    return tuple(full), g_ct


_THIRD_ORDER = (
    "third derivatives of the fused Transformer edge phase are not supported: "
    "the second-order kernel is differentiable no further (JAX's composable "
    "third-order rule, torchmdnet_tpu/ops/pallas/t_message.py:698, is queued "
    "in ROADMAP.md)"
)


class _TMessages(torch.autograd.Function):
    """The fused edge phase; its backward is the backward kernel, itself
    differentiable once through ``_TMessagesBwd`` when grad mode is on
    (``create_graph=True``: a force-loss training step's inner pass)."""

    @staticmethod
    def forward(ctx, cfg, idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv):
        heads, act, attn_act = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv)
        return run_fwd(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv,
                       heads=heads, act=act, attn_act=attn_act)

    @staticmethod
    def backward(ctx, ct):
        heads, act, attn_act = ctx.cfg
        idx, perm, *inputs = ctx.saved_tensors
        want_w = any(ctx.needs_input_grad[8:12])
        ct = ct.contiguous()
        if torch.is_grad_enabled():
            g = _TMessagesBwd.apply(ctx.cfg, want_w, idx, perm, *inputs, ct)
        else:
            g = run_bwd(idx, perm, *inputs, ct, heads=heads, act=act, attn_act=attn_act,
                        want_weight_grads=want_w)
        return (None, None, None, *g)


class _TMessagesBwd(torch.autograd.Function):
    """The backward kernel as a function of (inputs, ct); its gradient is the
    second-order kernel.  Outputs are ``run_bwd``'s 9."""

    @staticmethod
    def forward(ctx, cfg, want_w, idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct):
        heads, act, attn_act = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct)
        return run_bwd(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct,
                       heads=heads, act=act, attn_act=attn_act, want_weight_grads=want_w)

    @staticmethod
    def backward(ctx, *zs):
        if torch.is_grad_enabled():  # create_graph=True once more: a third derivative
            raise NotImplementedError(_THIRD_ORDER)
        heads, act, attn_act = ctx.cfg
        idx, perm, *rest = ctx.saved_tensors
        g_inputs, g_ct = run_bwd2(idx, perm, rest[:9], rest[9], list(zs),
                                  heads=heads, act=act, attn_act=attn_act)
        return (None, None, None, None, *g_inputs, g_ct)


def fused_t_messages(
    idx, q, k, v, ea, cutm, wdk=None, bdk=None, wdv=None, bdv=None, *, heads: int,
    act: str = "silu", attn_act: str = "silu", perm: Optional[torch.Tensor] = None,
):
    """Fused Transformer edge phase: out (N, H) in f32.

    Arguments as ``t_messages_reference``; on the GPU the message operands
    are bf16.  CUDA tensors run the kernels (or raise); CPU tensors run the
    plain version.
    """
    if q.device.type == "cpu":
        return t_messages_reference(
            idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv,
            heads=heads, act=act, attn_act=attn_act, perm=perm,
        )
    if q.device.type != "cuda":
        raise ValueError(f"fused_t_messages runs on cuda or cpu tensors, not {q.device}")
    if act not in em._ACT_CODE or attn_act not in em._ACT_CODE:
        raise ValueError(f"unsupported activation for the fused Transformer kernel: {act}, {attn_act}")
    if (wdk is None) != (bdk is None) or (wdv is None) != (bdv is None):
        raise ValueError("pass each filter's weight and bias together")
    if perm is None:
        perm = transpose_perm(idx)
    return _TMessages.apply((heads, act, attn_act), idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv)
