"""The ET attention edge phase as fused CUDA kernels: forward, backward and
second order.

Counterpart of torchmdnet_tpu/ops/pallas/et_message.py.  The kernels
(``csrc/et_message.cu``) replace the Pallas TPU kernels ``_fwd_kernel``
(et_message.py:227), ``_bwd_kernel`` (:296, with ``_inverse_scatter``
:603) and ``_bwd2_kernel`` (:685).  The source file's header says what
bounds them on an H100 and what their design does about it.

``fused_et_messages`` computes, without any (N, K, F) tensor in device memory
in the forward,

    x_agg (N, H)    = sum_k v_j[:H] * dv[:H] * attn
    vec_agg (N, 3H) = sum_k vec_j * vw1 * msk + vw2 * dir
    attn = attn_act(per-head sum of q_i * k_j * dk) * cutm,
    dk = act(ea . Wdk + bdk),  dv = act(ea . Wdv + bdv) = [. | vw1 | vw2] / v_j

with the JAX kernel's layout (vectors as three (N, H) components, v and dv in
global thirds) and precision (bf16 operands, products rounded to bf16, f32
sums, f32 outputs).  Its gradient is the backward kernel: one reverse pass
(forces) runs exactly one forward and one backward launch per layer.  The
backward is itself differentiable once (``_EtMessagesBwd``): its gradient is
the second-order kernel, so a force-loss training step runs per layer one
forward, two backward (the inner force pass and the outer energy term) and
one second-order launch.  A third derivative raises.

``et_messages_reference`` is the plain PyTorch version of the same function
(the counterpart of ``_composable_reference``, et_message.py:932), with
gradients from autograd; ``et_messages_bwd2_reference`` is the plain version
of the second-order kernel (the counterpart of ``_composable_bwd_vjp``,
:1069).  ``fused_et_messages`` uses the plain version only for tensors on the
CPU.
"""

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from torchmdnet_tpu_torch.ops.kernels import build
from torchmdnet_tpu_torch.ops.neighbors import ell_gather, transpose_perm

SOURCE = "et_message.cu"
_ACT_CODE = {"silu": 0, "ssp": 1, "tanh": 2, "sigmoid": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_COMMON = [_P, _I, _I, _I, _I, _I] + [_P] * 16 + [_I, _I]


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.et_error_string.argtypes = [_I]
        lib.et_error_string.restype = ctypes.c_char_p
        lib.et_fwd.argtypes = _COMMON + [_P, _P, _P]
        lib.et_fwd.restype = _I
        lib.et_bwd.argtypes = _COMMON + [_P] * 12
        lib.et_bwd.restype = _I
        lib.et_bwd2.argtypes = _COMMON + [_P] * 30
        lib.et_bwd2.restype = _I
        lib.et_plan.argtypes = [_I] * 6 + [_P, _P]
        lib.et_plan.restype = _I
        lib.ell_transpose_sum.argtypes = [_P, _I, _P, _I, _I, _I, _P, _P]
        lib.ell_transpose_sum.restype = _I
        lib._argtypes_set = True
    return lib


def _act_v(name, x):
    """The activation computed in f32 (at least), rounded to the operand dtype."""
    from torchmdnet_tpu_torch.ops.activations import act_fn_mapping

    acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    return act_fn_mapping[name](x.to(acc)).to(x.dtype)


def et_messages_reference(
    idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2,
    wdk=None, bdk=None, wdv=None, bdv=None, *, heads: int,
    act: str = "silu", attn_act: str = "silu", perm: Optional[torch.Tensor] = None,
):
    """Plain PyTorch twin of the fused kernels: the same math in the same
    precision (bf16 products, f32 sums) from composable ops.

    Args (one message dtype, normally bf16, except where noted):
        idx: (N, K) int32 ELL neighbor list (symmetric); perm its
            ``transpose_perm`` (computed when None).
        q, k: (N, H); v: (N, 3H); vec0..2: (N, H) the xyz components of the
            vector features.
        ea: (N, K, RBF) edge RBF features.
        cutm: (N, K) f32 cosine_cutoff(dist) * mask; msk: (N, K) f32 0/1.
        dir0..2: (N, K) f32 edge direction components (zero on self/invalid).
        wdk (RBF, H), bdk (1, H), wdv (RBF, 3H), bdv (1, 3H): the distance
            filters; None where distance_influence leaves a filter out.
    Returns (x_agg (N, H), vec_agg (N, 3H)) in f32 (f64 for f64 inputs).
    """
    n, kk = idx.shape
    h = q.shape[1]
    bf = q.dtype
    acc = torch.float32 if bf in (torch.bfloat16, torch.float16) else bf
    if perm is None:
        perm = transpose_perm(idx)
    ea2 = ea.reshape(n * kk, -1)

    def filt(w, b, width):
        pre = torch.matmul(ea2.to(acc), w.to(acc))
        return _act_v(act, pre.to(bf) + b).reshape(n, kk, width)

    dk = filt(wdk, bdk, h) if wdk is not None else None
    dv = filt(wdv, bdv, 3 * h) if wdv is not None else None
    prod = q[:, None, :] * ell_gather(k, idx, perm)
    if dk is not None:
        prod = prod * dk
    hd = h // heads
    head_sum = prod.to(acc).reshape(n, kk, heads, hd).sum(dim=-1, keepdim=True)
    pre_a = head_sum.expand(n, kk, heads, hd).reshape(n, kk, h).to(bf)
    attn = _act_v(attn_act, pre_a) * cutm[..., None].to(bf)
    vdv = ell_gather(v, idx, perm)
    if dv is not None:
        vdv = vdv * dv
    x_m = vdv[..., :h]
    vw1 = vdv[..., h : 2 * h] * msk[..., None].to(bf)
    vw2 = vdv[..., 2 * h :]
    x_agg = (x_m * attn).to(acc).sum(dim=1)
    vec_parts = []
    for vec_c, dir_c in ((vec0, dir0), (vec1, dir1), (vec2, dir2)):
        msg = ell_gather(vec_c, idx, perm) * vw1 + vw2 * dir_c[..., None].to(bf)
        vec_parts.append(msg.to(acc).sum(dim=1))
    return x_agg, torch.cat(vec_parts, dim=-1)


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.et_error_string(err).decode()})")


def _prepare(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, heads):
    """Validate the operands; return ((N, K, H, RBF), the 16 operands in the
    kernel's order, with the filters transposed to its (F, RBF) layout)."""
    dev = q.device
    n, kk = idx.shape
    h = q.shape[1]
    rbf = ea.shape[-1]
    if (h % 32 or h > 1024 or h % heads or (h // heads) > 32 or (h // heads) & (h // heads - 1)
            or rbf % 2 or -(-rbf // 16) * 16 > 4 * h):
        raise ValueError(
            f"the fused ET kernel takes H % 32 == 0, H <= 1024, H/heads a power of "
            f"two <= 32 and an even RBF <= 4H; got H={h}, heads={heads}, RBF={rbf}"
        )
    bf = torch.bfloat16
    _check(idx, "idx", torch.int32, (n, kk), dev)
    for t, name, width in ((q, "q", h), (k, "k", h), (v, "v", 3 * h),
                           (vec0, "vec0", h), (vec1, "vec1", h), (vec2, "vec2", h)):
        _check(t, name, bf, (n, width), dev)
    _check(ea, "ea", bf, (n, kk, rbf), dev)
    for t, name in ((cutm, "cutm"), (msk, "msk"), (dirs[0], "dir0"), (dirs[1], "dir1"), (dirs[2], "dir2")):
        _check(t, name, torch.float32, (n, kk), dev)
    # the kernel reads the filters as (F, RBF) rows: torch's Linear layout
    wk = bk = wv = bv = None
    if wdk is not None:
        wk, bk = wdk.t().contiguous(), bdk.reshape(-1).contiguous()
        _check(wk, "wdk^T", bf, (h, rbf), dev)
        _check(bk, "bdk", bf, (h,), dev)
    if wdv is not None:
        wv, bv = wdv.t().contiguous(), bdv.reshape(-1).contiguous()
        _check(wv, "wdv^T", bf, (3 * h, rbf), dev)
        _check(bv, "bdv", bf, (3 * h,), dev)
    tensors = [q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs[0], dirs[1], dirs[2], wk, bk, wv, bv]
    return (n, kk, h, rbf), tensors


def run_fwd(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, *,
            heads, act, attn_act):
    """Launch the forward kernel; returns (x_agg (N, H), vec_agg (N, 3H)) f32."""
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(
        idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, heads
    )
    x = torch.empty((n, h), dtype=torch.float32, device=q.device)
    vec = torch.empty((n, 3 * h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.et_fwd(
            _ptr(idx), n, kk, h, heads, rbf, *[_ptr(t) for t in tensors],
            _ACT_CODE[act], _ACT_CODE[attn_act], _ptr(x), _ptr(vec), ctypes.c_void_p(stream),
        )
    _raise_on(lib, err, "et_fwd launch")
    run_fwd.launches += 1
    return x, vec


run_fwd.launches = 0


def _plan(lib, kind, n, kk, h, heads, rbf):
    """(blocks, row groups per block) of a kernel's grid (kind 1 backward,
    2 second order): the shape of its per-block weight-gradient partials."""
    blocks, groups = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.et_plan(kind, n, kk, h, heads, rbf, ctypes.byref(blocks), ctypes.byref(groups))
    _raise_on(lib, err, "et_plan")
    return blocks.value, groups.value


def _weight_partials(lib, kind, n, kk, h, heads, rbf, dev):
    blocks, groups = _plan(lib, kind, n, kk, h, heads, rbf)
    rbfp = -(-rbf // 16) * 16
    return (torch.empty((blocks, rbfp, 4 * h), dtype=torch.float32, device=dev),
            torch.empty((blocks * groups, 4 * h), dtype=torch.float32, device=dev))


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


def _transpose_sum_rows(lib, g_edge, perm, n, kk, f, dev, stream):
    """(N, F) bf16 = the per-edge rows g_edge (N*K, F) summed onto their
    source atoms through ``perm`` in f32, rounded once (no atomics)."""
    out = torch.empty((n, f), dtype=torch.bfloat16, device=dev)
    err = lib.ell_transpose_sum(_ptr(g_edge), int(g_edge.dtype == torch.float32), _ptr(perm),
                                n, kk, f, _ptr(out), stream)
    _raise_on(lib, err, "ell_transpose_sum launch")
    return out


def _split_src(src, h):
    """(N, 7H) source-row gradients -> (k, v, vec0, vec1, vec2), each contiguous."""
    return (src[:, :h].contiguous(), src[:, h : 4 * h].contiguous(),
            src[:, 4 * h : 5 * h].contiguous(), src[:, 5 * h : 6 * h].contiguous(),
            src[:, 6 * h :].contiguous())


def run_bwd(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv,
            ct_x, ct_vec, *, heads, act, attn_act, want_weight_grads: bool):
    """Launch the backward kernel and the transpose-sum of its source-row
    cotangents.  The weight cotangents, when wanted, are accumulated by the
    kernel into per-block f32 partials, summed here once.

    Returns (dq, dk, dv, dvec0, dvec1, dvec2, dea, dcutm, ddir0, ddir1,
    ddir2, dwdk, dbdk, dwdv, dbdv) in the operands' dtypes; the weight
    cotangents are None unless ``want_weight_grads``."""
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(
        idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, heads
    )
    dev = q.device
    _check(perm, "perm", torch.int32, (n * kk,), dev)
    _check(ct_x, "ct_x", torch.float32, (n, h), dev)
    _check(ct_vec, "ct_vec", torch.float32, (n, 3 * h), dev)
    f32 = torch.float32
    want_dw = want_weight_grads and (wdk is not None or wdv is not None)
    dq = torch.empty((n, h), dtype=f32, device=dev)
    dea = torch.empty((n, kk, rbf), dtype=torch.bfloat16, device=dev)
    dcutm = torch.empty((n, kk), dtype=f32, device=dev)
    ddirs = [torch.empty((n, kk), dtype=f32, device=dev) for _ in range(3)]
    dsrc_edge = torch.empty((n, kk, 7 * h), dtype=torch.bfloat16, device=dev)
    dw_part = db_part = None
    with torch.cuda.device(dev):
        if want_dw:
            dw_part, db_part = _weight_partials(lib, 1, n, kk, h, heads, rbf, dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.et_bwd(
            _ptr(idx), n, kk, h, heads, rbf, *[_ptr(t) for t in tensors],
            _ACT_CODE[act], _ACT_CODE[attn_act], _ptr(ct_x), _ptr(ct_vec),
            _ptr(dq), _ptr(dea), _ptr(dcutm), *[_ptr(t) for t in ddirs],
            _ptr(dsrc_edge), _ptr(dw_part), _ptr(db_part), stream,
        )
        _raise_on(lib, err, "et_bwd launch")
        dsrc = _transpose_sum_rows(lib, dsrc_edge, perm, n, kk, 7 * h, dev, stream)
    run_bwd.launches += 1
    dwdk = dbdk = dwdv = dbdv = None
    if want_dw:
        dwdk, dbdk, dwdv, dbdv = _sum_partials(dw_part, db_part, rbf, h, wdk, bdk, wdv, bdv)
    return (dq.to(q.dtype), *_split_src(dsrc, h), dea, dcutm, *ddirs, dwdk, dbdk, dwdv, dbdv)


run_bwd.launches = 0


def _filters_all(wdk, wdv, h, rbf, like):
    """(4H, RBFP) bf16: the dk filter's columns, then the dv filter's, as
    rows; zero rows for an absent filter, zero padding columns."""
    rbfp = -(-rbf // 16) * 16
    w = torch.zeros((4 * h, rbfp), dtype=torch.bfloat16, device=like.device)
    if wdk is not None:
        w[:h, :rbf] = wdk.t()
    if wdv is not None:
        w[h:, :rbf] = wdv.t()
    return w


def run_bwd2(idx, perm, inputs, ct, Z, *, heads, act, attn_act):
    """Launch the second-order kernel and the transpose-sum of its source-row
    gradients.

    ``inputs`` are the fused op's 16 operands (filters None where absent),
    ``ct`` = (ct_x, ct_vec) f32, ``Z`` the 16 cotangents on ``run_bwd``'s
    outputs (the msk slot is ignored; None means zero).  Returns (g_inputs,
    g_ct): the 16 gradients in the inputs' dtypes (None for absent filters)
    and (g_ct_x, g_ct_vec) f32."""
    lib = _lib()
    (q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk, bdk, wdv, bdv) = inputs
    (n, kk, h, rbf), tensors = _prepare(
        idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, (dir0, dir1, dir2), wdk, bdk, wdv, bdv, heads
    )
    if h > 256:
        raise ValueError(f"the second-order ET kernel takes H <= 256; got H={h}")
    dev = q.device
    f32, bf = torch.float32, torch.bfloat16
    ct_x, ct_vec = (c.to(f32).contiguous() for c in ct)
    _check(perm, "perm", torch.int32, (n * kk,), dev)
    _check(ct_x, "ct_x", f32, (n, h), dev)
    _check(ct_vec, "ct_vec", f32, (n, 3 * h), dev)

    def z(i, like, dtype):
        t = Z[i]
        return torch.zeros(like.shape, dtype=dtype, device=dev) if t is None else t.to(dtype).contiguous()

    zs = [z(0, q, bf), z(1, k, bf), z(2, v, bf), z(3, vec0, bf), z(4, vec1, bf), z(5, vec2, bf),
          z(6, ea, bf), z(7, cutm, f32), z(9, dir0, f32), z(10, dir1, f32), z(11, dir2, f32)]
    has_w = wdk is not None or wdv is not None
    w_all = zw_all = zbk = zbv = None
    if has_w:
        w_all = _filters_all(wdk, wdv, h, rbf, q)
        zw_all = _filters_all(None if wdk is None else z(12, wdk, bf),
                              None if wdv is None else z(14, wdv, bf), h, rbf, q)
        if wdk is not None:
            zbk = z(13, bdk, bf).reshape(-1)
        if wdv is not None:
            zbv = z(15, bdv, bf).reshape(-1)
    gq = torch.empty((n, h), dtype=f32, device=dev)
    gea = torch.empty((n, kk, rbf), dtype=bf, device=dev)
    gsc = [torch.empty((n, kk), dtype=f32, device=dev) for _ in range(5)]  # cutm, msk, dir0..2
    gsrc_edge = torch.empty((n, kk, 7 * h), dtype=f32, device=dev)
    gctx = torch.empty((n, h), dtype=f32, device=dev)
    gctvec = torch.empty((n, 3 * h), dtype=f32, device=dev)
    dw_part = db_part = None
    with torch.cuda.device(dev):
        if has_w:
            dw_part, db_part = _weight_partials(lib, 2, n, kk, h, heads, rbf, dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.et_bwd2(
            _ptr(idx), n, kk, h, heads, rbf, *[_ptr(t) for t in tensors],
            _ACT_CODE[act], _ACT_CODE[attn_act], _ptr(ct_x), _ptr(ct_vec),
            *[_ptr(t) for t in zs], _ptr(w_all), _ptr(zw_all), _ptr(zbk), _ptr(zbv),
            _ptr(gq), _ptr(gea), *[_ptr(t) for t in gsc], _ptr(gsrc_edge), _ptr(gctx), _ptr(gctvec),
            _ptr(dw_part), _ptr(db_part), stream,
        )
        _raise_on(lib, err, "et_bwd2 launch")
        gsrc = _transpose_sum_rows(lib, gsrc_edge, perm, n, kk, 7 * h, dev, stream)
    run_bwd2.launches += 1
    gw = (None,) * 4
    if has_w:
        gw = _sum_partials(dw_part, db_part, rbf, h, wdk, bdk, wdv, bdv)
    g_inputs = (gq.to(q.dtype), *_split_src(gsrc, h), gea, *gsc, *gw)
    return g_inputs, (gctx, gctvec)


run_bwd2.launches = 0


def reset_launch_counts():
    run_fwd.launches = 0
    run_bwd.launches = 0
    run_bwd2.launches = 0


def _wide(t):
    """f32 for low-precision tensors, else the tensor's own dtype."""
    return t if t.dtype == torch.float64 else t.float()


def et_messages_bwd2_reference(idx, perm, inputs, ct, Z, *, heads: int, act: str = "silu",
                               attn_act: str = "silu"):
    """Plain version of the second-order kernel (the counterpart of
    ``_composable_bwd_vjp``, et_message.py:1069): the gradient over
    (inputs, ct) of <vjp(et_messages_reference)(ct), Z>, from
    ``torch.autograd.grad(..., create_graph=True)``.

    ``inputs`` are the 16 operands (filters None where absent), ``ct`` =
    (ct_x, ct_vec), ``Z`` 16 cotangents on the first-order gradients (the
    msk slot is ignored: msk's first-order gradient is zero by convention;
    None means zero).  Returns (g_inputs (16, zeros for an input that does
    not reach S, None for an absent filter), g_ct (2))."""
    with torch.enable_grad():
        a = [None if t is None else t.detach().requires_grad_(True) for t in inputs]
        c = [t.detach().requires_grad_(True) for t in ct]
        out = et_messages_reference(idx, *a, heads=heads, act=act, attn_act=attn_act, perm=perm)
        live = [i for i, t in enumerate(a) if t is not None]
        g = torch.autograd.grad(out, [a[i] for i in live], c, create_graph=True, allow_unused=True)
        s = sum(
            (_wide(gi) * _wide(Z[i])).sum()
            for i, gi in zip(live, g)
            if i != 8 and gi is not None and Z[i] is not None
        )
        leaves = [a[i] for i in live] + c
        grads = torch.autograd.grad(s, leaves, allow_unused=True) if torch.is_tensor(s) else [None] * len(leaves)
    full = [None] * 16
    for i, gr in zip(live, grads):
        full[i] = torch.zeros_like(a[i]) if gr is None else gr
    g_ct = tuple(torch.zeros_like(ci) if gr is None else gr for ci, gr in zip(c, grads[len(live):]))
    return tuple(full), g_ct


_THIRD_ORDER = (
    "third derivatives of the fused ET edge phase are not supported: the "
    "second-order kernel is differentiable no further (JAX's composable "
    "third-order rule, torchmdnet_tpu/ops/pallas/et_message.py:1166, is "
    "queued in ROADMAP.md)"
)


class _EtMessages(torch.autograd.Function):
    """The fused edge phase; its backward is the backward kernel, itself
    differentiable once through ``_EtMessagesBwd`` when grad mode is on
    (``create_graph=True``: a force-loss training step's inner pass)."""

    @staticmethod
    def forward(ctx, cfg, idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
                dir0, dir1, dir2, wdk, bdk, wdv, bdv):
        heads, act, attn_act = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
                              dir0, dir1, dir2, wdk, bdk, wdv, bdv)
        return run_fwd(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, (dir0, dir1, dir2),
                       wdk, bdk, wdv, bdv, heads=heads, act=act, attn_act=attn_act)

    @staticmethod
    def backward(ctx, ct_x, ct_vec):
        heads, act, attn_act = ctx.cfg
        idx, perm, *inputs = ctx.saved_tensors
        want_w = any(ctx.needs_input_grad[15:19])
        ct_x, ct_vec = ct_x.contiguous(), ct_vec.contiguous()
        if torch.is_grad_enabled():
            g = _EtMessagesBwd.apply(ctx.cfg, want_w, idx, perm, *inputs, ct_x, ct_vec)
        else:
            (q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk, bdk, wdv, bdv) = inputs
            g = run_bwd(
                idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk, (dir0, dir1, dir2),
                wdk, bdk, wdv, bdv, ct_x, ct_vec,
                heads=heads, act=act, attn_act=attn_act, want_weight_grads=want_w,
            )
        dq, dk, dv, dvec0, dvec1, dvec2, dea, dcutm, dd0, dd1, dd2, dwdk, dbdk, dwdv, dbdv = g
        # msk is 0/1 data: no gradient, as in the JAX op
        return (None, None, None, dq, dk, dv, dvec0, dvec1, dvec2, dea, dcutm, None,
                dd0, dd1, dd2, dwdk, dbdk, dwdv, dbdv)


class _EtMessagesBwd(torch.autograd.Function):
    """The backward kernel as a function of (inputs, ct); its gradient is the
    second-order kernel.  Outputs are ``run_bwd``'s 15 (no msk slot)."""

    @staticmethod
    def forward(ctx, cfg, want_w, idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
                dir0, dir1, dir2, wdk, bdk, wdv, bdv, ct_x, ct_vec):
        heads, act, attn_act = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
                              dir0, dir1, dir2, wdk, bdk, wdv, bdv, ct_x, ct_vec)
        return run_bwd(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk, (dir0, dir1, dir2),
                       wdk, bdk, wdv, bdv, ct_x, ct_vec,
                       heads=heads, act=act, attn_act=attn_act, want_weight_grads=want_w)

    @staticmethod
    def backward(ctx, *zs):
        if torch.is_grad_enabled():  # create_graph=True once more: a third derivative
            raise NotImplementedError(_THIRD_ORDER)
        heads, act, attn_act = ctx.cfg
        idx, perm, *rest = ctx.saved_tensors
        inputs, ct = rest[:16], rest[16:]
        # Z per input slot: the msk slot (8) has no output and takes no Z
        Z = list(zs[:8]) + [None] + list(zs[8:])
        g_inputs, g_ct = run_bwd2(idx, perm, inputs, ct, Z, heads=heads, act=act, attn_act=attn_act)
        return (None, None, None, None, *g_inputs, *g_ct)


def fused_et_messages(
    idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2,
    wdk=None, bdk=None, wdv=None, bdv=None, *, heads: int,
    act: str = "silu", attn_act: str = "silu", perm: Optional[torch.Tensor] = None,
):
    """Fused ET edge phase: (x_agg (N, H), vec_agg (N, 3H)) in f32.

    Arguments as ``et_messages_reference``; on the GPU the message operands
    are bf16.  CUDA tensors run the kernels (or raise); CPU tensors run the
    plain version.
    """
    if q.device.type == "cpu":
        return et_messages_reference(
            idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2,
            wdk, bdk, wdv, bdv, heads=heads, act=act, attn_act=attn_act, perm=perm,
        )
    if q.device.type != "cuda":
        raise ValueError(f"fused_et_messages runs on cuda or cpu tensors, not {q.device}")
    if act not in _ACT_CODE or attn_act not in _ACT_CODE:
        raise ValueError(f"unsupported activation for the fused ET kernel: {act}, {attn_act}")
    if (wdk is None) != (bdk is None) or (wdv is None) != (bdv is None):
        raise ValueError("pass each filter's weight and bias together")
    if perm is None:
        perm = transpose_perm(idx)
    return _EtMessages.apply(
        (heads, act, attn_act), idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
        dir0, dir1, dir2, wdk, bdk, wdv, bdv,
    )
