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
sums, f32 outputs).  Its gradient is the backward (``run_bwd``): a receiver
pass (``et_bwd_kernel``) that leaves per edge and head only the scalars the
source side needs, a source pass (``bwd_source``) that sums each atom's K
slots of the transpose permutation in gather form, and, when the weights
want a gradient, a reduction of the per-edge filter cotangents
(``weight_grads``).  The backward is itself differentiable
(``_EtMessagesBwd``): its gradient is the second order (``run_bwd2``, the
same three parts), so a force-loss training step runs per layer one
forward, two backward and one second-order call.  Every other derivative
is composable from the plain twin (``derivatives.py``): the forward-mode
tangents of the forward and the backward (``force_grad_mode="jvp"`` runs
per layer three forward and three backward calls and no second order) and
the second order's gradient (a third derivative and above).

``et_messages_reference`` is the plain PyTorch version of the same function
(the counterpart of ``_composable_reference``, et_message.py:932), with
gradients from autograd; ``et_messages_bwd2_reference`` is the plain version
of the second order (the counterpart of ``_composable_bwd_vjp``, :1069).
Each pass has its plain twin in the kernels' arithmetic
(``bwd_receiver_reference``, ``bwd_source_reference``,
``bwd2_receiver_reference``, ``bwd2_source_reference``,
``weight_grads_reference``): ``run_bwd`` and ``run_bwd2`` run them for CPU
tensors, and ``chip_smoke.py`` holds each helper kernel against its twin.
``fused_et_messages`` uses the plain version only for tensors on the CPU.
"""

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from torchmdnet_tpu_torch.ops.kernels import build, derivatives, save_list
from torchmdnet_tpu_torch.ops.neighbors import ell_gather, transpose_perm
from torchmdnet_tpu_torch.parallel.context import ShardPlan

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
        lib.et_bwd_src.argtypes = _COMMON + [_P] * 10
        lib.et_bwd_src.restype = _I
        lib.et_bwd2.argtypes = _COMMON + [_P] * 31
        lib.et_bwd2.restype = _I
        lib.et_bwd2_src.argtypes = _COMMON + [_P] * 24
        lib.et_bwd2_src.restype = _I
        lib.et_dw.argtypes = [_P, _P] + [_I] * 5 + [_P, _P]
        lib.et_dw.restype = _I
        lib.et_plan.argtypes = [_I] * 6 + [_P, _P]
        lib.et_plan.restype = _I
        lib.et_resources.argtypes = [_I] * 6 + [_P]
        lib.et_resources.restype = _I
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


def _prepare(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, heads, ext=False):
    """Validate the operands; return ((N, K, H, RBF), the 16 operands in the
    kernel's order, with the filters transposed to its (F, RBF) layout).

    ``ext`` (a rank's shard under edge partitioning): the source tables (k,
    v, vec) may hold more rows than ``idx`` (ghost sources after the local
    rows), and so may the receiver-side tables (q, ea, cutm, msk, dirs: ghost
    receivers after the local rows, which only the source pass reads)."""
    dev = q.device
    n, kk = idx.shape
    ns, nr = (k.shape[0], q.shape[0]) if ext else (n, n)
    if ns < n or nr < n:
        raise ValueError(f"extended tables need at least the {n} rows of idx; got {ns} source, {nr} receiver rows")
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
    for t, name, rows, width in ((q, "q", nr, h), (k, "k", ns, h), (v, "v", ns, 3 * h),
                                 (vec0, "vec0", ns, h), (vec1, "vec1", ns, h), (vec2, "vec2", ns, h)):
        _check(t, name, bf, (rows, width), dev)
    _check(ea, "ea", bf, (nr, kk, rbf), dev)
    for t, name in ((cutm, "cutm"), (msk, "msk"), (dirs[0], "dir0"), (dirs[1], "dir1"), (dirs[2], "dir2")):
        _check(t, name, torch.float32, (nr, kk), dev)
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
            heads, act, attn_act, ext=False):
    """Launch the forward kernel; returns (x_agg (N, H), vec_agg (N, 3H)) f32.
    ``ext``: the source tables may hold ghost rows after the N local ones."""
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(
        idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, heads, ext=ext
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


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _plan(lib, kind, n, kk, h, heads, rbf):
    """(blocks, row groups per block) of a receiver pass's grid (kind 1 the
    backward's, 2 the second order's): the shape of its per-group bias
    partials."""
    blocks, groups = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.et_plan(kind, n, kk, h, heads, rbf, ctypes.byref(blocks), ctypes.byref(groups))
    _raise_on(lib, err, "et_plan")
    return blocks.value, groups.value


def _db_partials(lib, kind, n, kk, h, heads, rbf, dev):
    blocks, groups = _plan(lib, kind, n, kk, h, heads, rbf)
    return torch.empty((blocks * groups, 4 * h), dtype=torch.float32, device=dev)


def _split_weights(dw, db, h, wdk, bdk, wdv, bdv):
    """The filters' (RBF, F) and (F,) cotangents (dk's H columns, then
    dv's: ET's 4H, the Transformer's 2H), rounded once to the weights' dtype:
    (dwdk, dbdk, dwdv, dbdv), None for an absent filter."""
    dwdk = dbdk = dwdv = dbdv = None
    if wdk is not None:
        dwdk = dw[:, :h].to(wdk.dtype)
        dbdk = db[:h].reshape(bdk.shape).to(bdk.dtype)
    if wdv is not None:
        dwdv = dw[:, h:].contiguous().to(wdv.dtype)
        dbdv = db[h:].reshape(bdv.shape).to(bdv.dtype)
    return dwdk, dbdk, dwdv, dbdv


# --- the plain versions of the backward's and second order's passes: the
# kernels' arithmetic (rounding points included) in composable ops


def _wdt(dtype):
    """The accumulation dtype of an operand dtype."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _dact(name, x):
    """f'(x) of an activation, as the kernels compute it."""
    if name == "silu":
        s = torch.sigmoid(x)
        return s * (1 + x * (1 - s))
    if name == "ssp":
        return torch.sigmoid(x)
    if name == "tanh":
        t = torch.tanh(x)
        return 1 - t * t
    s = torch.sigmoid(x)
    return s * (1 - s)


def _act3(name, x):
    """(f, f', f'') of an activation, as the second-order kernels compute them."""
    from torchmdnet_tpu_torch.ops.activations import act_fn_mapping

    if name == "tanh":
        t = torch.tanh(x)
        return t, 1 - t * t, -2 * t * (1 - t * t)
    s = torch.sigmoid(x)
    if name == "silu":
        return x * s, s * (1 + x * (1 - s)), s * (1 - s) * (2 + x * (1 - 2 * s))
    if name == "ssp":
        return act_fn_mapping["ssp"](x), s, s * (1 - s)
    return s, s * (1 - s), s * (1 - s) * (1 - 2 * s)


def _filters_rows(wdk, wdv, h, dtype, device, cols=None):
    """(4H, cols) (cols defaults to RBF): the dk filter's columns, then the
    dv filter's, as rows; zero rows for an absent filter, zero padding
    columns."""
    rbf = (wdk if wdk is not None else wdv).shape[0]
    out = torch.zeros((4 * h, cols or rbf), dtype=dtype, device=device)
    if wdk is not None:
        out[:h, :rbf] = wdk.t()
    if wdv is not None:
        out[h:, :rbf] = wdv.t()
    return out


class _Edges:
    """The per-edge operands of a list of edges ``e`` (flat indices i*K + k)
    whose source atoms are ``src``, in the kernels' precision: ``bf`` the
    operand dtype, ``acc`` its accumulation dtype, ``r`` the rounding to
    ``bf`` (the identity in f64).  Receiver rows are gathered by e // K."""

    def __init__(self, idx, e, src, q, ea, msk, dirs, heads):
        n, kk = idx.shape
        self.h = q.shape[1]
        self.heads = heads
        self.bf = q.dtype
        self.acc = _wdt(q.dtype)
        self.e, self.src, self.recv = e, src, torch.div(e, kk, rounding_mode="floor")
        self.ea = ea.reshape(-1, ea.shape[-1])[e]  # the slots of ghost receivers too, under partitioning
        self.m = self.r(msk.reshape(-1)[e].to(self.acc))[:, None]
        self.dirs = [self.r(d.reshape(-1)[e].to(self.acc))[:, None] for d in dirs]

    def r(self, x):
        return x.to(self.bf).to(self.acc)

    def rows(self, t, which):
        """rows of an (N, F) table at the receivers or the sources, wide."""
        return t[self.recv if which == "recv" else self.src].to(self.acc)

    def heads_to_channels(self, x):
        """(E, heads) per-head values -> (E, H)."""
        return x.repeat_interleave(self.h // self.heads, dim=1)

    def head_sum(self, x):
        e = x.shape[0]
        hd = self.h // self.heads
        return x.reshape(e, self.heads, hd).sum(-1, keepdim=True).expand(e, self.heads, hd).reshape(e, self.h)

    def filters(self, wdk, bdk, wdv, bdv, act):
        """[(pre-activation, value)] of dk and the dv thirds (None where absent),
        as filter_val computes them: bf16(bf16(ea . W) + b), bf16(act(.))."""
        from torchmdnet_tpu_torch.ops.activations import act_fn_mapping

        h, out = self.h, [None] * 4
        for w, b, cols in ((wdk, bdk, [0]), (wdv, bdv, [1, 2, 3])):
            if w is None:
                continue
            pre = self.r(self.ea.to(self.acc) @ w.to(self.acc))
            for t, c in enumerate(cols):
                p = self.r(pre[:, t * h : (t + 1) * h] + b.reshape(-1)[t * h : (t + 1) * h].to(self.acc))
                out[c] = (p, self.r(act_fn_mapping[act](p)))
        return out


def bwd_receiver_reference(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv,
                           ct_x, ct_vec, *, heads, act, attn_act, want_dpre):
    """Plain version of the backward's receiver pass (``et_bwd_kernel``).

    Returns (dq (N, H), dea (N, K, RBF), dcutm (N, K), [ddir0..2] (N, K),
    hs (N*K, 2, heads): each edge's head-summed d_prod and attn, dpre (N*K,
    4H) the filter cotangents and db (4H,) their sum over the edges, both
    None unless ``want_dpre``); dq, dcutm, ddir, db in the accumulation
    dtype, the rest in the operands'."""
    n, kk = idx.shape
    e = torch.arange(n * kk, device=idx.device)
    x = _Edges(idx, e, idx.reshape(-1).long(), q, ea, msk, dirs, heads)
    r, bf, acc, h = x.r, x.bf, x.acc, q.shape[1]
    kj, vj = x.rows(k, "src"), x.rows(v, "src")
    vecj = [x.rows(t, "src") for t in (vec0, vec1, vec2)]
    qi, ctx = x.rows(q, "recv"), r(x.rows(ct_x, "recv"))
    ctv = r(x.rows(ct_vec, "recv"))
    ctv = [ctv[:, c * h : (c + 1) * h] for c in range(3)]
    filt = x.filters(wdk, bdk, wdv, bdv, act)
    cm = r(cutm.reshape(-1, 1).to(acc))
    vdv = [r(vj[:, c * h : (c + 1) * h] * filt[1 + c][1]) if filt[1] else vj[:, c * h : (c + 1) * h]
           for c in range(3)]
    prod = r(qi * kj)
    if filt[0]:
        prod = r(prod * filt[0][1])
    pre_a = r(x.head_sum(prod))
    from torchmdnet_tpu_torch.ops.activations import act_fn_mapping

    a_act = r(act_fn_mapping[attn_act](pre_a))
    attn = r(a_act * cm)
    d_attn = r(ctx * vdv[0])
    d_xm = r(ctx * attn)
    d_prea = r(r(r(_dact(attn_act, pre_a)) * cm) * d_attn)
    dcutm = r(a_act * d_attn).sum(-1)
    d_prod = r(x.head_sum(d_prea))
    qk = r(d_prod * qi)
    dq = r(r(d_prod * kj) * filt[0][1]) if filt[0] else r(d_prod * kj)
    d_vw1 = torch.zeros_like(qi)
    d_vw2 = torch.zeros_like(qi)
    ddirs = []
    for c in range(3):
        d_vw1 = r(d_vw1 + r(r(ctv[c] * vecj[c]) * x.m))
        d_vw2 = r(d_vw2 + r(ctv[c] * x.dirs[c]))
        ddirs.append(r(ctv[c] * vdv[2]).sum(-1).reshape(n, kk))
    d_vdv = [d_xm, d_vw1, d_vw2]
    zero = torch.zeros_like(qi)
    d_pre = [r(r(_dact(act, filt[0][0])) * r(qk * kj)) if filt[0] else zero]
    d_pre += [r(r(_dact(act, filt[1 + c][0])) * r(d_vdv[c] * vj[:, c * h : (c + 1) * h])) if filt[1] else zero
              for c in range(3)]
    d_pre = torch.cat(d_pre, dim=-1)
    if filt[0] or filt[1]:
        dea = (d_pre @ _filters_rows(wdk, wdv, h, acc, d_pre.device)).to(ea.dtype).reshape(ea.shape)
    else:
        dea = torch.zeros_like(ea)
    hd = h // heads
    hs = torch.stack([d_prod[:, ::hd], attn[:, ::hd]], dim=1).to(bf)
    dpre = db = None
    if want_dpre:
        dpre = d_pre.to(bf)
        db = dpre.to(acc).sum(0)
    return (dq.reshape(n, kk, h).sum(1), dea, dcutm.reshape(n, kk), ddirs, hs, dpre, db)


def _bwd_source_terms(x, q, k, v, vec0, vec1, vec2, ct_x, ct_vec, hs, filt):
    """The backward's per-edge source-row cotangents (E, 7H) of the edges of
    ``x`` (an ``_Edges``), [k | v | vec0 | vec1 | vec2]: bf16 values (in
    bf16), wide, from ``filt`` (``_Edges.filters``) and hs's d_prod, attn."""
    r, h = x.r, x.h
    vj = x.rows(v, "src")
    vecj = [x.rows(t, "src") for t in (vec0, vec1, vec2)]
    qi, ctx = x.rows(q, "recv"), r(x.rows(ct_x, "recv"))
    ctv = r(x.rows(ct_vec, "recv"))
    ctv = [ctv[:, c * h : (c + 1) * h] for c in range(3)]
    hs_e = hs.reshape(-1, 2, x.heads)[x.e].to(x.acc)
    d_prod, attn = x.heads_to_channels(hs_e[:, 0]), x.heads_to_channels(hs_e[:, 1])
    vdv = [r(vj[:, c * h : (c + 1) * h] * filt[1 + c][1]) if filt[1] else vj[:, c * h : (c + 1) * h]
           for c in range(3)]
    qk = r(d_prod * qi)
    d_k = r(qk * filt[0][1]) if filt[0] else qk
    vm1 = r(vdv[1] * x.m)
    d_vw1 = torch.zeros_like(qi)
    d_vw2 = torch.zeros_like(qi)
    d_vec = []
    for c in range(3):
        d_vw1 = r(d_vw1 + r(r(ctv[c] * vecj[c]) * x.m))
        d_vw2 = r(d_vw2 + r(ctv[c] * x.dirs[c]))
        d_vec.append(r(ctv[c] * vm1))
    d_vdv = [r(ctx * attn), d_vw1, d_vw2]
    d_v = [r(d_vdv[c] * filt[1 + c][1]) if filt[1] else d_vdv[c] for c in range(3)]
    return torch.cat([d_k, *d_v, *d_vec], dim=-1)


def _slots(idx, perm):
    """The source pass's edges: perm, and each slot's source atom."""
    n, kk = idx.shape
    return perm.long(), torch.arange(n, device=idx.device).repeat_interleave(kk)


def _split_rows(src, h):
    """(N, 7H) source-row gradients -> (k, v, vec0, vec1, vec2), each contiguous."""
    return (src[:, :h].contiguous(), src[:, h : 4 * h].contiguous(),
            src[:, 4 * h : 5 * h].contiguous(), src[:, 5 * h : 6 * h].contiguous(),
            src[:, 6 * h :].contiguous())


def bwd_source_reference(idx, perm, q, k, v, vec0, vec1, vec2, ea, msk, dirs, wdk, bdk, wdv, bdv,
                         ct_x, ct_vec, hs, *, heads, act):
    """Plain version of the backward's source pass (``et_bwd_src_kernel``):
    per atom j, the per-edge source-row cotangents of the K edges that
    ``perm`` lists for j, recomputed from their ea rows, the receivers' rows
    and hs, summed in slot order in the accumulation dtype and rounded once.
    Returns (dk, dv, dvec0, dvec1, dvec2) in the operands' dtype."""
    n, kk = idx.shape
    e, src = _slots(idx, perm)
    x = _Edges(idx, e, src, q, ea, msk, dirs, heads)
    terms = _bwd_source_terms(x, q, k, v, vec0, vec1, vec2, ct_x, ct_vec, hs,
                              x.filters(wdk, bdk, wdv, bdv, act))
    return _split_rows(terms.reshape(n, kk, -1).sum(1).to(q.dtype), q.shape[1])


def weight_grads_reference(pairs, rbf):
    """Plain version of ``et_dw_kernel``: (RBF, F) = sum over the pairs of
    a^T . b over the edges, in the accumulation dtype."""
    acc = _wdt(pairs[0][0].dtype)
    return sum(a.to(acc).t() @ b.to(acc) for a, b in pairs)[:rbf]


def dw_per_split(ne, blocks, sms):
    """Edges a split of ``et_dw_kernel`` takes: about four of its 128-thread
    blocks an SM (its resident count) over ``blocks`` blocks a split, in
    whole 64-edge tiles."""
    want = max(1, -(-4 * sms // blocks))
    return -(-(-(-ne // want)) // 64) * 64


def dw_partials(products, npairs, per_split, total):
    """Launch ``et_dw_kernel`` (uncounted: each caller counts its own
    launches).  ``products`` (at most three) are (a, b, a2, b2, pn, out,
    bias): a (E, pk) and b (E, qn) bf16 CUDA views with unit column stride
    (a2, b2 the second pair's, read when ``npairs`` is 2), pn >= pk the
    output rows (A's columns past pk count as zero), out and bias the
    offsets of the (pn, qn) product and of b's (qn) column sums in a split's
    partial (bias -1: none).  Returns the partials (splits, total) f32, one a
    split of ``per_split`` edges."""
    lib = _lib()
    a0 = products[0][0]
    dev, ne = a0.device, a0.shape[0]
    ptrs, spec = [], []
    for a, b, a2, b2, pn, out, bias in products:
        for t, name in ((a, "edge rows"), (b, "cotangents"), (a2, "edge rows"), (b2, "cotangents")):
            if t is not None and (t.device != dev or t.dtype != torch.bfloat16 or t.dim() != 2
                                  or t.shape[0] != ne or t.stride(1) != 1):
                raise ValueError(f"{name} of the weight reduction: want ({ne}, .) bf16 rows on {dev}, got "
                                 f"{tuple(t.shape)} {t.dtype} stride {t.stride()} on {t.device}")
        ptrs += [_ptr(a), _ptr(b), _ptr(a2), _ptr(b2)]
        spec += [a.stride(0), b.stride(0), a.shape[1], pn, b.shape[1], out, bias]
    part = torch.empty((-(-ne // per_split), total), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.et_dw((_P * len(ptrs))(*ptrs), (_I * len(spec))(*spec), len(products), npairs, ne, per_split,
                        total, _ptr(part), _stream(dev))
    _raise_on(lib, err, "et_dw launch")
    return part


def weight_grads(pairs, rbf):
    """The filters' weight cotangents from per-edge filter cotangents: (RBF,
    F) f32 = sum over the edges of a^T . b for each (a, b) in ``pairs``, a
    (E, RBF) edge rows (ea, z_ea), b (E, F) bf16 filter cotangents, F a
    multiple of 8 (ET's 4H, the Transformer's 2H).  CUDA tensors run
    ``et_dw_kernel`` (a fixed split of the edges, its partials summed once);
    CPU tensors the plain version."""
    a0, b0 = pairs[0]
    if a0.device.type == "cpu":
        return weight_grads_reference(pairs, rbf)
    dev = a0.device
    ne, f = b0.shape
    for a, b in pairs:
        _check(a, "edge rows", torch.bfloat16, (ne, rbf), dev)
        _check(b, "filter cotangents", torch.bfloat16, (ne, f), dev)
    rbfp = -(-rbf // 16) * 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_split = dw_per_split(ne, -(-f // 128) * -(-rbfp // 64), sms)
    a1, b1 = pairs[1] if len(pairs) > 1 else (None, None)
    part = dw_partials([(a0, b0, a1, b1, rbfp, 0, -1)], len(pairs), per_split, rbfp * f)
    weight_grads.launches += 1
    return part.sum(dim=0).reshape(rbfp, f)[:rbf]


weight_grads.launches = 0


def bwd_source(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv,
               ct_x, ct_vec, hs, *, heads, act, attn_act, ext=False):
    """The backward's source pass: (dk, dv, dvec0, dvec1, dvec2) bf16 from
    the receiver pass's hs.  CUDA tensors run ``et_bwd_src_kernel``, CPU
    tensors ``bwd_source_reference``.

    ``ext`` (edge partitioning): the N = idx rows are the target atoms, and
    the receiver-side tables (q, ea, cutm, msk, dirs, ct_x, ct_vec, hs) hold
    the ghost receivers' rows after the local ones; ``perm`` indexes their
    slots.  The kernel reads a slot's receiver as slot // K, so it runs
    unchanged."""
    if q.device.type == "cpu":
        return bwd_source_reference(idx, perm, q, k, v, vec0, vec1, vec2, ea, msk, dirs,
                                    wdk, bdk, wdv, bdv, ct_x, ct_vec, hs, heads=heads, act=act)
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(
        idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, heads, ext=ext
    )
    dev = q.device
    _check(perm, "perm", torch.int32, (n * kk,), dev)
    _check(hs, "hs", torch.bfloat16, (q.shape[0] * kk, 2, heads), dev)
    outs = [torch.empty((n, w * h), dtype=torch.bfloat16, device=dev) for w in (1, 3, 1, 1, 1)]
    with torch.cuda.device(dev):
        err = lib.et_bwd_src(
            _ptr(idx), n, kk, h, heads, rbf, *[_ptr(t) for t in tensors],
            _ACT_CODE[act], _ACT_CODE[attn_act], _ptr(perm), _ptr(ct_x), _ptr(ct_vec), _ptr(hs),
            *[_ptr(t) for t in outs], _stream(dev),
        )
    _raise_on(lib, err, "et_bwd_src launch")
    bwd_source.launches += 1
    return tuple(outs)


bwd_source.launches = 0


def bwd_receiver(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, ct_x, ct_vec,
                 *, heads, act, attn_act, want_dpre, ext=False):
    """The backward's receiver pass: (dq, dea, dcutm, [ddir0..2], hs, dpre,
    db) as ``bwd_receiver_reference`` returns them (dq, dcutm, ddir, db f32
    on the card).  CUDA tensors run ``et_bwd_kernel`` (counted by
    ``run_bwd.launches``), CPU tensors the plain version."""
    if q.device.type == "cpu":
        return bwd_receiver_reference(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk,
                                      wdv, bdv, ct_x, ct_vec, heads=heads, act=act, attn_act=attn_act,
                                      want_dpre=want_dpre)
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(
        idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, heads, ext=ext
    )
    dev = q.device
    _check(ct_x, "ct_x", torch.float32, (n, h), dev)
    _check(ct_vec, "ct_vec", torch.float32, (n, 3 * h), dev)
    f32, bf = torch.float32, torch.bfloat16
    dq = torch.empty((n, h), dtype=f32, device=dev)
    dea = torch.empty((n, kk, rbf), dtype=bf, device=dev)
    dcutm = torch.empty((n, kk), dtype=f32, device=dev)
    ddirs = [torch.empty((n, kk), dtype=f32, device=dev) for _ in range(3)]
    hs = torch.empty((n * kk, 2, heads), dtype=bf, device=dev)
    dpre = db_part = None
    with torch.cuda.device(dev):
        if want_dpre and (wdk is not None or wdv is not None):
            dpre = torch.empty((n * kk, 4 * h), dtype=bf, device=dev)
            db_part = _db_partials(lib, 1, n, kk, h, heads, rbf, dev)
        err = lib.et_bwd(
            _ptr(idx), n, kk, h, heads, rbf, *[_ptr(t) for t in tensors],
            _ACT_CODE[act], _ACT_CODE[attn_act], _ptr(ct_x), _ptr(ct_vec),
            _ptr(dq), _ptr(dea), _ptr(dcutm), *[_ptr(t) for t in ddirs], _ptr(hs),
            _ptr(dpre), _ptr(db_part), _stream(dev),
        )
    _raise_on(lib, err, "et_bwd launch")
    run_bwd.launches += 1
    return dq, dea, dcutm, ddirs, hs, dpre, None if db_part is None else db_part.sum(dim=0)


def run_bwd(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv,
            ct_x, ct_vec, *, heads, act, attn_act, want_weight_grads: bool):
    """The backward: its receiver pass (``bwd_receiver``), its source pass
    (``bwd_source``) and, when wanted, the weight cotangents from the
    receiver pass's per-edge filter cotangents (``weight_grads``).  CPU
    tensors take the passes' plain versions.

    Returns (dq, dk, dv, dvec0, dvec1, dvec2, dea, dcutm, ddir0, ddir1,
    ddir2, dwdk, dbdk, dwdv, dbdv) in the operands' dtypes; the weight
    cotangents are None unless ``want_weight_grads``."""
    want_dw = want_weight_grads and (wdk is not None or wdv is not None)
    n, kk = idx.shape
    if q.device.type != "cpu":
        _check(perm, "perm", torch.int32, (n * kk,), q.device)
    dq, dea, dcutm, ddirs, hs, dpre, db = bwd_receiver(
        idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, ct_x, ct_vec,
        heads=heads, act=act, attn_act=attn_act, want_dpre=want_dw)
    src = bwd_source(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv,
                     ct_x, ct_vec, hs, heads=heads, act=act, attn_act=attn_act)
    gw = (None,) * 4
    if want_dw:
        dw = weight_grads([(ea.reshape(n * kk, -1), dpre)], ea.shape[-1])
        gw = _split_weights(dw, db, q.shape[1], wdk, bdk, wdv, bdv)
    return (dq.to(q.dtype), *src, dea, dcutm, *ddirs, *gw)


run_bwd.launches = 0


def _z_operands(inputs, Z, bf, f32):
    """The Z operands of the second order's passes, in the kernels' order
    (zq, zk, zv, zvec0..2, zea, zcutm, zdir0..2): None becomes zeros."""
    def z(i, dtype):
        t, like = Z[i], inputs[i]
        return torch.zeros(like.shape, dtype=dtype, device=like.device) if t is None else t.to(dtype).contiguous()

    return [z(0, bf), z(1, bf), z(2, bf), z(3, bf), z(4, bf), z(5, bf), z(6, bf), z(7, f32),
            z(9, f32), z(10, f32), z(11, f32)]


class _Dual:
    """The second order's per-edge dual forward of an ``_Edges``: filters
    and their tangents (pre' = z_ea.W + ea.Z_W + z_b) with the activations'
    derivatives, as the kernels compute them."""

    def __init__(self, x, zea, inputs, Z, act):
        h, r, acc = x.h, x.r, x.acc
        wdk, bdk, wdv, bdv = inputs[12:16]
        one, zero = torch.ones_like(x.ea[:, :1], dtype=acc), torch.zeros_like(x.ea[:, :1], dtype=acc)
        self.dk, self.dk1, self.dk2, self.pkt, self.dkt = one, zero, zero, zero, zero
        self.dv = [one] * 3
        self.dv1, self.dv2, self.pvt, self.dvt = [zero] * 3, [zero] * 3, [zero] * 3, [zero] * 3
        self.has_dk, self.has_dv = wdk is not None, wdv is not None
        if not (self.has_dk or self.has_dv):
            return
        w = _filters_rows(wdk, wdv, h, acc, x.ea.device).t()
        zwm = _filters_rows(None if wdk is None else _zero_if_none(Z[12], wdk),
                            None if wdv is None else _zero_if_none(Z[14], wdv), h, acc, x.ea.device).t()
        ea, zea = x.ea.to(acc), zea.reshape(-1, zea.shape[-1])[x.e].to(acc)
        pre = r(ea @ w)
        pret = r(zea @ w + ea @ zwm)
        if self.has_dk:
            pk = r(pre[:, :h] + bdk.reshape(-1).to(acc))
            f, self.dk1, self.dk2 = _act3(act, pk)
            self.dk = r(f)
            self.pkt = r(pret[:, :h] + _zero_if_none(Z[13], bdk).reshape(-1).to(acc))
            self.dkt = self.dk1 * self.pkt
        if self.has_dv:
            for c in range(3):
                cols = slice((1 + c) * h, (2 + c) * h)
                pv = r(pre[:, cols] + bdv.reshape(-1)[c * h : (c + 1) * h].to(acc))
                f, self.dv1[c], self.dv2[c] = _act3(act, pv)
                self.dv[c] = r(f)
                self.pvt[c] = r(pret[:, cols] + _zero_if_none(Z[15], bdv).reshape(-1)[c * h : (c + 1) * h].to(acc))
                self.dvt[c] = self.dv1[c] * self.pvt[c]


def _zero_if_none(t, like):
    return torch.zeros_like(like) if t is None else t


def bwd2_receiver_reference(idx, inputs, ct, Z, *, heads, act, attn_act):
    """Plain version of the second order's receiver pass (``et_bwd2_kernel``).

    Returns (gq (N, H), gea (N, K, RBF), gcutm, gmsk (N, K), [gdir0..2] (N,
    K), gctx (N, H), gctvec (N, 3H), hs4 (N*K, 4, heads): attn, attn' and the
    head-summed reverse seeds of prod' and prod, bpre and bpret (N*K, 4H) the
    filter cotangents and their tangents' and db (4H,), the last three None
    without filters); gea, bpre, bpret in the operands' dtype, the rest in
    the accumulation dtype."""
    q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk, bdk, wdv, bdv = inputs
    n, kk = idx.shape
    h = q.shape[1]
    x = _Edges(idx, torch.arange(n * kk, device=idx.device), idx.reshape(-1).long(), q, ea, msk,
               (dir0, dir1, dir2), heads)
    r, acc = x.r, x.acc
    z = [_zero_if_none(Z[i], inputs[i]) for i in range(12)]
    d = _Dual(x, z[6], inputs, Z, act)
    xk, xv = x.rows(k, "src"), x.rows(v, "src")
    xv = [xv[:, c * h : (c + 1) * h] for c in range(3)]
    xvec = [x.rows(t, "src") for t in (vec0, vec1, vec2)]
    zk, zv = x.rows(z[1], "src"), x.rows(z[2], "src")
    zv = [zv[:, c * h : (c + 1) * h] for c in range(3)]
    zvec = [x.rows(z[3 + c], "src") for c in range(3)]
    qi, zqi = x.rows(q, "recv"), x.rows(z[0], "recv")
    ctx = r(x.rows(ct[0], "recv"))
    ctv = r(x.rows(ct[1], "recv"))
    ctv = [ctv[:, c * h : (c + 1) * h] for c in range(3)]
    cm = r(cutm.reshape(-1, 1).to(acc))
    zcm = z[7].reshape(-1, 1).to(acc)
    zdir = [z[9 + c].reshape(-1, 1).to(acc) for c in range(3)]
    m, dirs = x.m, x.dirs
    qk = r(qi * xk)
    prod = r(qk * d.dk) if d.has_dk else qk
    prodt = (zqi * xk + qi * zk) * d.dk + qi * xk * d.dkt
    pa = r(x.head_sum(prod))
    pat = x.head_sum(prodt)
    aa, a1, a2 = _act3(attn_act, pa)
    aa = r(aa)
    attn = r(aa * cm)
    attnt = a1 * pat * cm + aa * zcm
    vdv = [r(xv[c] * d.dv[c]) if d.has_dv else xv[c] for c in range(3)]
    vdvt = [zv[c] * d.dv[c] + xv[c] * d.dvt[c] for c in range(3)]
    gx = vdvt[0] * attn + vdv[0] * attnt
    gv = [(zvec[c] * vdv[1] + xvec[c] * vdvt[1]) * m + vdvt[2] * dirs[c] + vdv[2] * zdir[c] for c in range(3)]
    cv = sum(ctv[c] * xvec[c] for c in range(3))
    czv = sum(ctv[c] * zvec[c] for c in range(3))
    cd = sum(ctv[c] * dirs[c] for c in range(3))
    czd = sum(ctv[c] * zdir[c] for c in range(3))
    b_vdvt = [ctx * attn, m * cv, cd]
    b_vdv = [ctx * attnt, m * czv, czd]
    b_attnt, b_attn = ctx * vdv[0], ctx * vdvt[0]
    gdirs = [(ctv[c] * vdvt[2]).sum(-1).reshape(n, kk) for c in range(3)]
    gmsk = (czv * vdv[1] + cv * vdvt[1]).sum(-1).reshape(n, kk)
    gcutm = (b_attnt * a1 * pat + b_attn * aa).sum(-1).reshape(n, kk)
    b_prodt = x.head_sum(b_attnt * a1 * cm)
    b_prod = x.head_sum(b_attnt * (a2 * pat * cm + a1 * zcm) + b_attn * a1 * cm)
    hd = h // heads
    hs4 = torch.stack([attn[:, ::hd], attnt[:, ::hd], b_prodt[:, ::hd], b_prod[:, ::hd]], dim=1)
    gq = b_prodt * (zk * d.dk + xk * d.dkt) + b_prod * xk * d.dk
    zero = torch.zeros_like(qi)
    bpre, bpret = [zero] * 4, [zero] * 4
    if d.has_dk:
        b_dk = b_prodt * (zqi * xk + qi * zk) + b_prod * qi * xk
        b_dkt = b_prodt * qi * xk
        bpret[0] = b_dkt * d.dk1
        bpre[0] = b_dkt * d.dk2 * d.pkt + b_dk * d.dk1
    if d.has_dv:
        for c in range(3):
            b_dv = b_vdvt[c] * zv[c] + b_vdv[c] * xv[c]
            b_dvt = b_vdvt[c] * xv[c]
            bpret[1 + c] = b_dvt * d.dv1[c]
            bpre[1 + c] = b_dvt * d.dv2[c] * d.pvt[c] + b_dv * d.dv1[c]
    bpre_b = bpret_b = db = None
    if d.has_dk or d.has_dv:
        bpre_b, bpret_b = torch.cat(bpre, -1).to(x.bf), torch.cat(bpret, -1).to(x.bf)
        wm = _filters_rows(wdk, wdv, h, acc, ea.device)
        zwm = _filters_rows(None if wdk is None else _zero_if_none(Z[12], wdk),
                            None if wdv is None else _zero_if_none(Z[14], wdv), h, acc, ea.device)
        gea = (bpre_b.to(acc) @ wm + bpret_b.to(acc) @ zwm).to(ea.dtype).reshape(ea.shape)
        db = bpre_b.to(acc).sum(0)
    else:
        gea = torch.zeros_like(ea)
    return (gq.reshape(n, kk, h).sum(1), gea, gcutm, gmsk, gdirs, gx.reshape(n, kk, h).sum(1),
            torch.cat([g.reshape(n, kk, h).sum(1) for g in gv], -1), hs4, bpre_b, bpret_b, db)


def _bwd2_source_terms(x, d, inputs, ct, z, hs4):
    """The second order's per-edge source-row gradients (E, 7H) of the edges
    of ``x``, [k | v | vec0 | vec1 | vec2], wide, from ``d`` (``_Dual``) and
    hs4."""
    q, k, v, vec0, vec1, vec2 = inputs[:6]
    r, h = x.r, x.h
    xv = x.rows(v, "src")
    xv = [xv[:, c * h : (c + 1) * h] for c in range(3)]
    xvec = [x.rows(t, "src") for t in (vec0, vec1, vec2)]
    zv = x.rows(z[2], "src")
    zv = [zv[:, c * h : (c + 1) * h] for c in range(3)]
    zvec = [x.rows(z[3 + c], "src") for c in range(3)]
    qi, zqi = x.rows(q, "recv"), x.rows(z[0], "recv")
    ctx = r(x.rows(ct[0], "recv"))
    ctv = r(x.rows(ct[1], "recv"))
    ctv = [ctv[:, c * h : (c + 1) * h] for c in range(3)]
    zdir = [z[9 + c].reshape(-1)[x.e].to(x.acc)[:, None] for c in range(3)]
    hs_e = hs4.reshape(-1, 4, x.heads)[x.e].to(x.acc)
    attn, attnt, b_prodt, b_prod = (x.heads_to_channels(hs_e[:, s]) for s in range(4))
    m = x.m
    vdvt1 = zv[1] * d.dv[1] + xv[1] * d.dvt[1]
    g_vec = [ctv[c] * vdvt1 * m for c in range(3)]
    cv = sum(ctv[c] * xvec[c] for c in range(3))
    czv = sum(ctv[c] * zvec[c] for c in range(3))
    cd = sum(ctv[c] * x.dirs[c] for c in range(3))
    czd = sum(ctv[c] * zdir[c] for c in range(3))
    b_vdvt = [ctx * attn, m * cv, cd]
    b_vdv = [ctx * attnt, m * czv, czd]
    g_v = [b_vdvt[c] * d.dvt[c] + b_vdv[c] * d.dv[c] for c in range(3)]
    g_k = b_prodt * (zqi * d.dk + qi * d.dkt) + b_prod * qi * d.dk
    return torch.cat([g_k, *g_v, *g_vec], dim=-1)


def bwd2_source_reference(idx, perm, inputs, ct, Z, hs4, *, heads, act):
    """Plain version of the second order's source pass
    (``et_bwd2_src_kernel``): per atom j, the per-edge gradients of k_j, v_j
    and vec_j over the K edges ``perm`` lists for j, summed in slot order in
    the accumulation dtype and rounded once to the operands' dtype.
    Returns (gk, gv, gvec0, gvec1, gvec2)."""
    q, ea, msk = inputs[0], inputs[6], inputs[8]
    n, kk = idx.shape
    e, src = _slots(idx, perm)
    x = _Edges(idx, e, src, q, ea, msk, inputs[9:12], heads)
    z = [_zero_if_none(Z[i], inputs[i]) for i in range(12)]
    terms = _bwd2_source_terms(x, _Dual(x, z[6], inputs, Z, act), inputs, ct, z, hs4)
    return _split_rows(terms.reshape(n, kk, -1).sum(1).to(q.dtype), q.shape[1])


def bwd2_source(idx, perm, inputs, ct, Z, hs4, *, heads, act, attn_act, ext=False):
    """The second order's source pass: (gk, gv, gvec0, gvec1, gvec2) bf16
    from the receiver pass's hs4.  CUDA tensors run ``et_bwd2_src_kernel``,
    CPU tensors ``bwd2_source_reference``.  ``ext`` as ``bwd_source``'s: the
    receiver-side tables (q, ea, msk, dirs, ct, their Z and hs4) hold the
    ghost receivers' rows after the local ones, and ``perm`` indexes their
    slots."""
    q = inputs[0]
    if q.device.type == "cpu":
        return bwd2_source_reference(idx, perm, inputs, ct, Z, hs4, heads=heads, act=act)
    lib = _lib()
    (q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk, bdk, wdv, bdv) = inputs
    (n, kk, h, rbf), tensors = _prepare(
        idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, (dir0, dir1, dir2), wdk, bdk, wdv, bdv, heads, ext=ext
    )
    dev = q.device
    f32, bf = torch.float32, torch.bfloat16
    ct_x, ct_vec = (c.to(f32).contiguous() for c in ct)
    _check(perm, "perm", torch.int32, (n * kk,), dev)
    _check(hs4, "hs4", f32, (q.shape[0] * kk, 4, heads), dev)
    zs = _z_operands(inputs, Z, bf, f32)
    w_all, zw_all, zbk, zbv = _z_filters(inputs, Z, h, rbf)
    outs = [torch.empty((n, w * h), dtype=bf, device=dev) for w in (1, 3, 1, 1, 1)]
    with torch.cuda.device(dev):
        err = lib.et_bwd2_src(
            _ptr(idx), n, kk, h, heads, rbf, *[_ptr(t) for t in tensors],
            _ACT_CODE[act], _ACT_CODE[attn_act], _ptr(perm), _ptr(ct_x), _ptr(ct_vec),
            *[_ptr(t) for t in zs[:7]], *[_ptr(t) for t in zs[8:]], _ptr(w_all), _ptr(zw_all),
            _ptr(zbk), _ptr(zbv), _ptr(hs4), *[_ptr(t) for t in outs], _stream(dev),
        )
    _raise_on(lib, err, "et_bwd2_src launch")
    bwd2_source.launches += 1
    return tuple(outs)


bwd2_source.launches = 0


def _z_filters(inputs, Z, h, rbf):
    """(w_all, zw_all, zbk, zbv) of the second order's kernels: the filters
    and their Z as (4H, RBFP) bf16 rows, the Z biases flat (None without
    filters / for an absent filter)."""
    wdk, bdk, wdv, bdv = inputs[12:16]
    q = inputs[0]
    bf = torch.bfloat16
    if wdk is None and wdv is None:
        return None, None, None, None
    zt = lambda i, like: (torch.zeros(like.shape, dtype=bf, device=like.device) if Z[i] is None
                          else Z[i].to(bf).contiguous())
    rbfp = -(-rbf // 16) * 16  # the kernels' (4H, RBFP) bf16 layout
    w_all = _filters_rows(wdk, wdv, h, bf, q.device, rbfp)
    zw_all = _filters_rows(None if wdk is None else zt(12, wdk), None if wdv is None else zt(14, wdv), h,
                           bf, q.device, rbfp)
    zbk = None if wdk is None else zt(13, bdk).reshape(-1)
    zbv = None if wdv is None else zt(15, bdv).reshape(-1)
    return w_all, zw_all, zbk, zbv


def bwd2_receiver(idx, inputs, ct, Z, *, heads, act, attn_act, ext=False):
    """The second order's receiver pass: (gq, gea, gcutm, gmsk, [gdir0..2],
    gctx, gctvec, hs4, bpre, bpret, db) as ``bwd2_receiver_reference``
    returns them.  CUDA tensors run ``et_bwd2_kernel`` (counted by
    ``run_bwd2.launches``), CPU tensors the plain version.  ``ext``: the
    source tables (k, v, vec) and their Z hold ghost rows after the N local
    ones, as ``run_fwd``'s."""
    (q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk, bdk, wdv, bdv) = inputs
    if q.device.type == "cpu":
        return bwd2_receiver_reference(idx, inputs, ct, Z, heads=heads, act=act, attn_act=attn_act)
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(
        idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, (dir0, dir1, dir2), wdk, bdk, wdv, bdv, heads, ext=ext
    )
    if h > 256:
        raise ValueError(f"the second-order ET kernel takes H <= 256; got H={h}")
    dev = q.device
    f32, bf = torch.float32, torch.bfloat16
    ct_x, ct_vec = (c.to(f32).contiguous() for c in ct)
    _check(ct_x, "ct_x", f32, (n, h), dev)
    _check(ct_vec, "ct_vec", f32, (n, 3 * h), dev)
    zs = _z_operands(inputs, Z, bf, f32)
    w_all, zw_all, zbk, zbv = _z_filters(inputs, Z, h, rbf)
    gq = torch.empty((n, h), dtype=f32, device=dev)
    gea = torch.empty((n, kk, rbf), dtype=bf, device=dev)
    gsc = [torch.empty((n, kk), dtype=f32, device=dev) for _ in range(5)]  # cutm, msk, dir0..2
    gctx = torch.empty((n, h), dtype=f32, device=dev)
    gctvec = torch.empty((n, 3 * h), dtype=f32, device=dev)
    hs4 = torch.empty((n * kk, 4, heads), dtype=f32, device=dev)
    bpre = bpret = db_part = None
    with torch.cuda.device(dev):
        if w_all is not None:
            bpre = torch.empty((n * kk, 4 * h), dtype=bf, device=dev)
            bpret = torch.empty((n * kk, 4 * h), dtype=bf, device=dev)
            db_part = _db_partials(lib, 2, n, kk, h, heads, rbf, dev)
        err = lib.et_bwd2(
            _ptr(idx), n, kk, h, heads, rbf, *[_ptr(t) for t in tensors],
            _ACT_CODE[act], _ACT_CODE[attn_act], _ptr(ct_x), _ptr(ct_vec),
            *[_ptr(t) for t in zs], _ptr(w_all), _ptr(zw_all), _ptr(zbk), _ptr(zbv),
            _ptr(gq), _ptr(gea), *[_ptr(t) for t in gsc], _ptr(gctx), _ptr(gctvec), _ptr(hs4),
            _ptr(bpre), _ptr(bpret), _ptr(db_part), _stream(dev),
        )
    _raise_on(lib, err, "et_bwd2 launch")
    run_bwd2.launches += 1
    db = None if db_part is None else db_part.sum(dim=0)
    return gq, gea, gsc[0], gsc[1], gsc[2:], gctx, gctvec, hs4, bpre, bpret, db


def run_bwd2(idx, perm, inputs, ct, Z, *, heads, act, attn_act):
    """The second order: its receiver pass (``bwd2_receiver``), its source
    pass (``bwd2_source``) and the weight gradients from the receiver pass's
    per-edge filter cotangents (``weight_grads``).  CPU tensors take the
    passes' plain versions.

    ``inputs`` are the fused op's 16 operands (filters None where absent),
    ``ct`` = (ct_x, ct_vec), ``Z`` the 16 cotangents on ``run_bwd``'s
    outputs (the msk slot is ignored; None means zero).  Returns (g_inputs,
    g_ct): the 16 gradients in the inputs' dtypes (None for absent filters)
    and (g_ct_x, g_ct_vec) f32 (the accumulation dtype on the CPU)."""
    q, ea, wdk, bdk, wdv, bdv = inputs[0], inputs[6], *inputs[12:16]
    n, kk = idx.shape
    if q.device.type != "cpu":
        _check(perm, "perm", torch.int32, (n * kk,), q.device)
        ct = tuple(c.to(torch.float32).contiguous() for c in ct)
    gq, gea, gcutm, gmsk, gdirs, gctx, gctvec, hs4, bpre, bpret, db = bwd2_receiver(
        idx, inputs, ct, Z, heads=heads, act=act, attn_act=attn_act)
    src = bwd2_source(idx, perm, inputs, ct, Z, hs4, heads=heads, act=act, attn_act=attn_act)
    gw = (None,) * 4
    if bpre is not None:
        zea = _zero_if_none(Z[6], ea).to(ea.dtype).reshape(n * kk, -1).contiguous()
        dw = weight_grads([(ea.reshape(n * kk, -1), bpre), (zea, bpret)], ea.shape[-1])
        gw = _split_weights(dw, db, q.shape[1], wdk, bdk, wdv, bdv)
    g_inputs = (gq.to(q.dtype), *src, gea, gcutm, gmsk, *gdirs, *gw)
    return g_inputs, (gctx, gctvec)


run_bwd2.launches = 0


def kernel_resources(kind, n, kk, h, heads, rbf):
    """A kernel's resources at a shape, from the CUDA runtime (kind 1
    ``et_bwd_kernel``, 2 ``et_bwd2_kernel``, 3 ``et_bwd_src_kernel``, 4
    ``et_bwd2_src_kernel``, 5 ``et_dw_kernel``, 6 ``et_fwd_kernel``, 7
    ``et_dw_kernel`` with the bias sums, TensorNet's):
    {registers, spill_bytes (local memory a thread), threads, smem (dynamic
    shared memory a block), blocks_per_sm (resident)}.  Needs a CUDA device."""
    lib = _lib()
    out = (ctypes.c_int * 5)()
    _raise_on(lib, lib.et_resources(kind, n, kk, h, heads, rbf, out), "et_resources")
    return dict(zip(("registers", "spill_bytes", "threads", "smem", "blocks_per_sm"), out))


def reset_launch_counts():
    run_fwd.launches = 0
    run_bwd.launches = 0
    run_bwd2.launches = 0
    bwd_source.launches = 0
    bwd2_source.launches = 0
    weight_grads.launches = 0


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
    g_inputs, g_ct = derivatives.second_order(_twin((heads, act, attn_act), idx, perm), inputs, ct,
                                              _no_msk(Z))
    return tuple(g_inputs), tuple(g_ct)


def _twin(cfg, idx, perm):
    """``et_messages_reference`` as a function of the 16 operands: the plain
    twin every composable derivative rule differentiates (``perm`` a
    ``ShardPlan``: this rank's rows, its gathers through the exchange)."""
    heads, act, attn_act = cfg
    return lambda *a: et_messages_reference(idx, *a, heads=heads, act=act, attn_act=attn_act, perm=perm)


def _z_slots(zs):
    """The Zs on the backward's 15 outputs, one per input slot: msk (8) has
    no output and takes no Z."""
    return list(zs[:8]) + [None] + list(zs[8:])


def _no_msk(t_inputs):
    """One tensor per input with msk's dropped (a tangent, a Z): msk is 0/1
    data, without a gradient or a tangent, as in the JAX op."""
    return [None if i == 8 else t for i, t in enumerate(t_inputs)]


def _bwd_outputs(g, want_w):
    """The 16 input gradients of a composable rule as the backward's 15
    outputs (no msk slot; no weight cotangents unless ``want_w``)."""
    out = list(g[:8]) + list(g[9:])
    if not want_w:
        out[11:] = [None] * 4
    return tuple(out)


class _EtMessages(torch.autograd.Function):
    """The fused edge phase (#1); its backward is the backward kernel (#2),
    differentiable through ``_EtMessagesBwd`` when grad mode is on
    (``create_graph=True``: a force-loss training step's inner pass) or a
    forward-mode tangent is live (``force_grad_mode="jvp"``).  The tangent
    (``jvp``) is composable: the double vjp of the plain twin."""

    @staticmethod
    def forward(ctx, cfg, idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
                dir0, dir1, dir2, wdk, bdk, wdv, bdv):
        heads, act, attn_act = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
                              dir0, dir1, dir2, wdk, bdk, wdv, bdv)
        ctx.save_for_forward(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
                             dir0, dir1, dir2, wdk, bdk, wdv, bdv)
        return save_list.fused_output("et_message_fwd", lambda: run_fwd(
            idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, (dir0, dir1, dir2),
            wdk, bdk, wdv, bdv, heads=heads, act=act, attn_act=attn_act))

    @staticmethod
    def jvp(ctx, _cfg, _idx, _perm, *t_inputs):
        idx, perm, *inputs = ctx.saved_tensors
        return tuple(derivatives.jvp(_twin(ctx.cfg, idx, perm), inputs, _no_msk(t_inputs)))

    @staticmethod
    def backward(ctx, ct_x, ct_vec):
        heads, act, attn_act = ctx.cfg
        idx, perm, *inputs = ctx.saved_tensors
        want_w = any(ctx.needs_input_grad[15:19])
        ct_x, ct_vec = ct_x.contiguous(), ct_vec.contiguous()
        if torch.is_grad_enabled() or derivatives.tangent_live(*inputs, ct_x, ct_vec):
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
    """The backward kernel (#2) as a function of (inputs, ct); its gradient
    is the second-order kernel (#3) through ``derivatives.Bwd2``, its tangent
    the composable ``derivatives.vjp_tangent`` of the plain twin.  Outputs
    are ``run_bwd``'s 15 (no msk slot)."""

    @staticmethod
    def forward(ctx, cfg, want_w, idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
                dir0, dir1, dir2, wdk, bdk, wdv, bdv, ct_x, ct_vec):
        heads, act, attn_act = cfg
        ctx.cfg, ctx.want_w = cfg, want_w
        ctx.save_for_backward(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
                              dir0, dir1, dir2, wdk, bdk, wdv, bdv, ct_x, ct_vec)
        ctx.save_for_forward(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
                             dir0, dir1, dir2, wdk, bdk, wdv, bdv, ct_x, ct_vec)
        return run_bwd(idx, perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk, (dir0, dir1, dir2),
                       wdk, bdk, wdv, bdv, ct_x, ct_vec,
                       heads=heads, act=act, attn_act=attn_act, want_weight_grads=want_w)

    @staticmethod
    def jvp(ctx, _cfg, _want_w, _idx, _perm, *t):
        idx, perm, *rest = ctx.saved_tensors
        g = derivatives.vjp_tangent(_twin(ctx.cfg, idx, perm), rest[:16], rest[16:], _no_msk(t[:16]), t[16:])
        return _bwd_outputs(g, ctx.want_w)

    @staticmethod
    def backward(ctx, *zs):
        heads, act, attn_act = ctx.cfg
        idx, perm, *rest = ctx.saved_tensors
        inputs, ct = rest[:16], rest[16:]
        def run(ins, c, z):
            return run_bwd2(idx, perm, ins, c, z, heads=heads, act=act, attn_act=attn_act)

        if torch.is_grad_enabled() or derivatives.tangent_live(*rest, *zs):  # a third derivative
            g = derivatives.bwd2_apply(run, _twin(ctx.cfg, idx, perm), inputs, ct, zs, _z_slots)
            return (None, None, None, None, *g)
        return (None, None, None, None, *derivatives.flat(run(inputs, ct, _z_slots(zs))))


def _shard_bwd(cfg, plan, srcs, inputs, ct, want_w):
    """The backward (#2) on one rank's rows: the receiver pass on the local
    receivers over the extended source tables ``srcs`` (k, v, vec0..2), then
    the rows the receivers hold for other ranks' sources (q, the cotangents,
    each slot's ea, msk, dir and the receiver pass's hs) exchanged, and the
    source pass over this rank's atoms, each summing its K slots of the
    global transpose permutation, local and ghost, in order: the source rows'
    gradients are complete on their owner.  Returns (the 15 gradients of
    ``run_bwd``, this rank's share of the weight cotangents, and the
    extended receiver tables (q, ea, msk, dir0..2, ct_x, ct_vec) that the
    second order's source pass reads again)."""
    from torchmdnet_tpu_torch.parallel.edge_partition import extend_rows

    heads, act, attn_act = cfg
    q, _, _, _, _, _, ea, cutm, msk, dir0, dir1, dir2, wdk, bdk, wdv, bdv = inputs
    ct_x, ct_vec = ct
    n, kk = plan.lidx.shape
    h, rbf = q.shape[1], ea.shape[-1]
    dirs = (dir0, dir1, dir2)
    want_w = want_w and (wdk is not None or wdv is not None)
    dq, dea, dcutm, ddirs, hs, dpre, db = bwd_receiver(
        plan.lidx, q, *srcs, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, ct_x, ct_vec,
        heads=heads, act=act, attn_act=attn_act, want_dpre=want_w, ext=True)
    q_rx, ea_rx, msk_rx, d0, d1, d2, ctx_rx, ctv_rx, hs_rx = extend_rows(
        plan, [q, ea, msk, dir0, dir1, dir2, ct_x, ct_vec, hs], "rx")
    # the source pass reads no cutm: msk stands in for its shape
    src = bwd_source(plan.lidx, plan.perm_rx, q_rx, *srcs, ea_rx, msk_rx, msk_rx, (d0, d1, d2),
                     wdk, bdk, wdv, bdv, ctx_rx, ctv_rx, hs_rx, heads=heads, act=act, attn_act=attn_act, ext=True)
    gw = (None,) * 4
    if want_w:  # this rank's edges' share of the weight cotangents
        dw = weight_grads([(ea.reshape(n * kk, -1), dpre)], rbf)
        gw = _split_weights(dw, db, h, wdk, bdk, wdv, bdv)
    grads = (dq.to(q.dtype), *src, dea, dcutm, *ddirs, *gw)
    return grads, (q_rx, ea_rx, msk_rx, d0, d1, d2, ctx_rx, ctv_rx)


def _shard_bwd2(cfg, plan, srcs, inputs, ct, rx, zs):
    """The second order (#3) on one rank's rows, given the Z cotangents
    ``zs`` on ``_shard_bwd``'s 15 outputs.  The Z of the source rows reach
    the ghost copies through the forward's exchange, so the receiver pass
    computes every receiver-side gradient locally (the terms of other ranks'
    source rows included); the rows the source pass needs of the ghost
    receivers (their Z and the receiver pass's hs4) are exchanged as the
    backward's are, and the source pass completes the source rows' gradients
    on their owner.  No cotangent travels back: each gradient is whole where
    its input lives.  The Z on the weight cotangents must be the same on
    every rank (zero in a force-loss step), since a ghost receiver's edges
    read this rank's.  Returns the gradients of (inputs (16), ct_x, ct_vec)."""
    from torchmdnet_tpu_torch.parallel.edge_partition import extend_rows

    heads, act, attn_act = cfg
    n, kk = plan.lidx.shape
    q, ea = inputs[0], inputs[6]
    ct = tuple(c.to(torch.float32).contiguous() if q.device.type != "cpu" else c for c in ct)
    # Z per input slot: the msk slot (8) has no output and takes no Z
    Z = [None if z is None else z.contiguous() for z in list(zs[:8]) + [None] + list(zs[8:])]
    Z = [torch.zeros_like(inputs[i]) if Z[i] is None and i < 12 and i != 8 else Z[i] for i in range(16)]
    zsrc = extend_rows(plan, Z[1:6], "src")
    ins_ext = (q, *srcs, *inputs[6:])
    gq, gea, gcutm, gmsk, gdirs, gctx, gctvec, hs4, bpre, bpret, db = bwd2_receiver(
        plan.lidx, ins_ext, ct, [Z[0], *zsrc, *Z[6:]], heads=heads, act=act, attn_act=attn_act, ext=True)
    zq_rx, zea_rx, zd0, zd1, zd2, hs4_rx = extend_rows(plan, [Z[0], Z[6], Z[9], Z[10], Z[11], hs4], "rx")
    q_rx, ea_rx, msk_rx, d0, d1, d2, ctx_rx, ctv_rx = rx
    ins_rx = (q_rx, *srcs, ea_rx, msk_rx, msk_rx, d0, d1, d2, *inputs[12:])
    z_rx = [zq_rx, *zsrc, zea_rx, None, None, zd0, zd1, zd2, *Z[12:]]
    src = bwd2_source(plan.lidx, plan.perm_rx, ins_rx, (ctx_rx, ctv_rx), z_rx, hs4_rx, heads=heads, act=act,
                      attn_act=attn_act, ext=True)
    gw = (None,) * 4
    wdk, bdk, wdv, bdv = inputs[12:16]
    if bpre is not None:  # this rank's edges' share
        zea = Z[6].to(ea.dtype).reshape(n * kk, -1).contiguous()
        dw = weight_grads([(ea.reshape(n * kk, -1), bpre), (zea, bpret)], ea.shape[-1])
        gw = _split_weights(dw, db, q.shape[1], wdk, bdk, wdv, bdv)
    return (gq.to(q.dtype), *src, gea, gcutm, gmsk, *gdirs, *gw, gctx, gctvec)


class _EtMessagesShard(torch.autograd.Function):
    """The fused edge phase on one rank's receiver rows under edge
    partitioning (``plan`` a ``ShardPlan``).

    Forward (#1): the source rows [k | v | vec] of the ghost atoms arrive in
    one exchange and extend the local source tables; the kernel reads them
    through the plan's local ids.  Backward (#2, ``_shard_bwd``),
    differentiable through ``_EtMessagesShardBwd`` (#3, ``_shard_bwd2``).
    The composable rules (the tangent, the third order) run the plain twin
    on the rank's rows, its gathers through the exchange
    (``ring_ell_gather``), so they stay partitioned.  CPU tensors run the
    passes' plain versions."""

    @staticmethod
    def forward(ctx, cfg, plan, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk, bdk, wdv, bdv):
        from torchmdnet_tpu_torch.parallel.context import ring_scope
        from torchmdnet_tpu_torch.parallel.edge_partition import extend_rows

        heads, act, attn_act = cfg
        srcs = extend_rows(plan, [k, v, vec0, vec1, vec2], "src")
        ctx.cfg, ctx.plan = cfg, plan
        inputs = (q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk, bdk, wdv, bdv)
        ctx.save_for_backward(*inputs, *srcs)
        ctx.save_for_forward(*inputs)

        def launch():
            if q.device.type == "cpu":
                with ring_scope(None), torch.no_grad():  # local ids into the extended tables
                    return et_messages_reference(plan.lidx, q, *srcs, ea, cutm, msk, dir0, dir1, dir2,
                                                 wdk, bdk, wdv, bdv, heads=heads, act=act, attn_act=attn_act,
                                                 perm=plan.perm_rx)
            return run_fwd(plan.lidx, q, *srcs, ea, cutm, msk, (dir0, dir1, dir2), wdk, bdk, wdv, bdv,
                           heads=heads, act=act, attn_act=attn_act, ext=True)

        return save_list.fused_output("et_message_fwd", launch)

    @staticmethod
    def jvp(ctx, _cfg, _plan, *t_inputs):
        twin = _twin(ctx.cfg, ctx.plan.lidx, ctx.plan)
        return tuple(derivatives.jvp(twin, ctx.saved_tensors, _no_msk(t_inputs)))

    @staticmethod
    def backward(ctx, ct_x, ct_vec):
        saved = ctx.saved_tensors
        inputs, srcs = saved[:16], saved[16:]
        want_w = any(ctx.needs_input_grad[14:18])
        ct = (ct_x.contiguous(), ct_vec.contiguous())
        if torch.is_grad_enabled() or derivatives.tangent_live(*inputs, *ct):
            g = _EtMessagesShardBwd.apply(ctx.cfg, ctx.plan, want_w, srcs, *inputs, *ct)
        else:
            g = _shard_bwd(ctx.cfg, ctx.plan, srcs, inputs, ct, want_w)[0]
        dq, dk, dv, dvec0, dvec1, dvec2, dea, dcutm, dd0, dd1, dd2, dwdk, dbdk, dwdv, dbdv = g
        # msk is 0/1 data: no gradient, as in the JAX op
        return (None, None, dq, dk, dv, dvec0, dvec1, dvec2, dea, dcutm, None, dd0, dd1, dd2, dwdk, dbdk, dwdv, dbdv)


class _EtMessagesShardBwd(torch.autograd.Function):
    """``_shard_bwd`` as a function of this rank's (inputs, ct); its gradient
    is ``_shard_bwd2`` through ``derivatives.Bwd2``.  ``srcs`` (the extended
    source tables of the forward) is not an input: the gradients of the
    source rows are those of k, v and vec, whose ghost copies it holds.  The
    weight cotangents are this rank's share, and so are their tangent and
    gradients: only their sum over the ranks is the whole."""

    @staticmethod
    def forward(ctx, cfg, plan, want_w, srcs, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2,
                wdk, bdk, wdv, bdv, ct_x, ct_vec):
        inputs = (q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk, bdk, wdv, bdv)
        grads, rx = _shard_bwd(cfg, plan, srcs, inputs, (ct_x, ct_vec), want_w)
        ctx.cfg, ctx.plan, ctx.want_w = cfg, plan, want_w
        ctx.save_for_backward(*inputs, ct_x, ct_vec, *srcs, *rx)
        ctx.save_for_forward(*inputs, ct_x, ct_vec)
        return grads

    @staticmethod
    def jvp(ctx, _cfg, _plan, _want_w, _srcs, *t):
        saved = ctx.saved_tensors
        twin = _twin(ctx.cfg, ctx.plan.lidx, ctx.plan)
        g = derivatives.vjp_tangent(twin, saved[:16], saved[16:18], _no_msk(t[:16]), t[16:])
        return _bwd_outputs(g, ctx.want_w)

    @staticmethod
    def backward(ctx, *zs):
        saved = ctx.saved_tensors
        inputs, ct, srcs, rx = saved[:16], saved[16:18], saved[18:23], saved[23:]
        if torch.is_grad_enabled() or derivatives.tangent_live(*saved[:18], *zs):  # a third derivative
            def run(ins, c, z):
                g = _shard_bwd2(ctx.cfg, ctx.plan, srcs, ins, c, rx, z[:8] + z[9:])
                return g[:16], g[16:]

            twin = _twin(ctx.cfg, ctx.plan.lidx, ctx.plan)
            return (None, None, None, None, *derivatives.bwd2_apply(run, twin, inputs, ct, zs, _z_slots))
        g = _shard_bwd2(ctx.cfg, ctx.plan, srcs, inputs, ct, rx, zs)
        return (None, None, None, None, *g)


def fused_et_messages(
    idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2,
    wdk=None, bdk=None, wdv=None, bdv=None, *, heads: int,
    act: str = "silu", attn_act: str = "silu", perm: Optional[torch.Tensor] = None,
):
    """Fused ET edge phase: (x_agg (N, H), vec_agg (N, 3H)) in f32.

    Arguments as ``et_messages_reference``; on the GPU the message operands
    are bf16.  CUDA tensors run the kernels (or raise); CPU tensors run the
    plain version.  A ``ShardPlan`` as ``perm`` (edge partitioning: this
    rank's receiver rows, global ids in ``idx``) runs ``_EtMessagesShard``.
    """
    if isinstance(perm, ShardPlan):
        if q.device.type == "cuda" and (act not in _ACT_CODE or attn_act not in _ACT_CODE):
            raise ValueError(f"unsupported activation for the fused ET kernel: {act}, {attn_act}")
        return _EtMessagesShard.apply(
            (heads, act, attn_act), perm, q, k, v, vec0, vec1, vec2, ea, cutm, msk,
            dir0, dir1, dir2, wdk, bdk, wdv, bdv,
        )
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
