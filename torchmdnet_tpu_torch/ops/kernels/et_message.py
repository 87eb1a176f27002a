"""The ET attention edge phase as one fused CUDA kernel, forward and backward.

Counterpart of torchmdnet_tpu/ops/pallas/et_message.py.  The kernels
(``csrc/et_message.cu``) replace the Pallas TPU kernels ``_fwd_kernel``
(et_message.py:227) and ``_bwd_kernel`` (:296, with ``_inverse_scatter``
:603).  The source file's header says what bounds them on an H100 and what
their design does about it.

``fused_et_messages`` computes, without any (N, K, F) tensor in device memory
in the forward,

    x_agg (N, H)    = sum_k v_j[:H] * dv[:H] * attn
    vec_agg (N, 3H) = sum_k vec_j * vw1 * msk + vw2 * dir
    attn = attn_act(per-head sum of q_i * k_j * dk) * cutm,
    dk = act(ea . Wdk + bdk),  dv = act(ea . Wdv + bdv) = [. | vw1 | vw2] / v_j

with the JAX kernel's layout (vectors as three (N, H) components, v and dv in
global thirds) and precision (bf16 operands, products rounded to bf16, f32
sums, f32 outputs).  Its gradient is the backward kernel: one reverse pass
(forces) runs exactly one forward and one backward launch per layer.  A
second derivative (force-loss training) needs the second-order kernel, which
is not ported yet.

``et_messages_reference`` is the plain PyTorch version of the same function
(the counterpart of ``_composable_reference``, et_message.py:932), with
gradients from autograd.  ``fused_et_messages`` uses it only for tensors on
the CPU.
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
        lib.et_bwd.argtypes = _COMMON + [_P] * 11
        lib.et_bwd.restype = _I
        lib.ell_transpose_sum_bf16.argtypes = [_P, _P, _I, _I, _I, _P, _P]
        lib.ell_transpose_sum_bf16.restype = _I
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


def run_bwd(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv,
            ct_x, ct_vec, *, heads, act, attn_act, want_weight_grads: bool):
    """Launch the backward kernel and the transpose-sum of its source-row
    cotangents; the weight cotangents, when wanted, are one matrix product
    over the kernel's per-edge filter cotangents.

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
    dsrc = torch.empty((n, 7 * h), dtype=torch.bfloat16, device=dev)
    dpre = torch.empty((n * kk, 4 * h), dtype=torch.bfloat16, device=dev) if want_dw else None
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.et_bwd(
            _ptr(idx), n, kk, h, heads, rbf, *[_ptr(t) for t in tensors],
            _ACT_CODE[act], _ACT_CODE[attn_act], _ptr(ct_x), _ptr(ct_vec),
            _ptr(dq), _ptr(dea), _ptr(dcutm), *[_ptr(t) for t in ddirs],
            _ptr(dsrc_edge), _ptr(dpre), stream,
        )
        _raise_on(lib, err, "et_bwd launch")
        err = lib.ell_transpose_sum_bf16(
            _ptr(dsrc_edge), _ptr(perm), n, kk, 7 * h, _ptr(dsrc), stream
        )
        _raise_on(lib, err, "ell_transpose_sum_bf16 launch")
    run_bwd.launches += 1
    dwdk = dbdk = dwdv = dbdv = None
    if want_dw:
        # weight cotangents: one f32 product over all edges' filter
        # cotangents, rounded once to bf16 as the JAX op does
        dw = torch.matmul(ea.reshape(n * kk, rbf).t().float(), dpre.float())
        db = dpre.sum(dim=0, dtype=f32)
        if wdk is not None:
            dwdk = dw[:, :h].to(wdk.dtype)
            dbdk = db[:h].reshape(bdk.shape).to(bdk.dtype)
        if wdv is not None:
            dwdv = dw[:, h:].to(wdv.dtype)
            dbdv = db[h:].reshape(bdv.shape).to(bdv.dtype)
    bf = q.dtype
    return (
        dq.to(bf), dsrc[:, :h], dsrc[:, h : 4 * h], dsrc[:, 4 * h : 5 * h],
        dsrc[:, 5 * h : 6 * h], dsrc[:, 6 * h :], dea, dcutm, *ddirs,
        dwdk, dbdk, dwdv, dbdv,
    )


run_bwd.launches = 0


def reset_launch_counts():
    run_fwd.launches = 0
    run_bwd.launches = 0


_SECOND_ORDER = (
    "second derivatives of the fused ET edge phase (force-loss training) need "
    "the second-order kernel (torchmdnet_tpu/ops/pallas/et_message.py "
    "_bwd2_kernel), which is not ported yet (ROADMAP.md, TPU kernels to port)"
)


class _EtMessages(torch.autograd.Function):
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
        if torch.is_grad_enabled():  # create_graph=True: a second derivative
            raise NotImplementedError(_SECOND_ORDER)
        return _EtMessages._backward(ctx, ct_x, ct_vec)

    @staticmethod
    @once_differentiable
    def _backward(ctx, ct_x, ct_vec):
        heads, act, attn_act = ctx.cfg
        (idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
         dir0, dir1, dir2, wdk, bdk, wdv, bdv) = ctx.saved_tensors
        want_w = any(ctx.needs_input_grad[15:19])
        g = run_bwd(
            idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk, (dir0, dir1, dir2),
            wdk, bdk, wdv, bdv, ct_x.float().contiguous(), ct_vec.float().contiguous(),
            heads=heads, act=act, attn_act=attn_act, want_weight_grads=want_w,
        )
        dq, dk, dv, dvec0, dvec1, dvec2, dea, dcutm, dd0, dd1, dd2, dwdk, dbdk, dwdv, dbdv = g
        # msk is 0/1 data: no gradient, as in the JAX op
        return (None, None, None, dq, dk, dv, dvec0, dvec1, dvec2, dea, dcutm, None,
                dd0, dd1, dd2, dwdk, dbdk, dwdv, dbdv)


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
