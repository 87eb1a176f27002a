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
wired the same way.  Its gradient is the backward (``run_bwd``): a receiver
pass (``t_bwd_kernel``) that leaves per edge and head only the scalars the
source side needs, a source pass (``bwd_source``) that sums each atom's K
slots of the transpose permutation in gather form (no per-edge source-row
buffer, no float atomics), and, when the weights want a gradient, ET's
reduction of the per-edge filter cotangents (``em.weight_grads``).  The
backward is differentiable through ``_TMessagesBwd``, whose gradient is
the second order (``run_bwd2``, the same three parts), so a force-loss
training step runs per layer one forward, two backward and one
second-order call; the tangents and the orders above the second are
composable, as ET's (``derivatives.py``).

``t_messages_reference`` is the plain PyTorch version (the counterpart of
``_composable_t_reference``, t_message.py:354), with gradients from
autograd; ``t_messages_bwd2_reference`` is the plain version of the
second order (the counterpart of ``_composable_t_bwd_vjp``, :443).  Each
pass has its plain twin in the kernels' arithmetic
(``bwd_receiver_reference``, ``bwd_source_reference``,
``bwd2_receiver_reference``, ``bwd2_source_reference``; the reduction's is
``em.weight_grads_reference``): ``run_bwd`` and ``run_bwd2`` run them for
CPU tensors, and ``chip_smoke.py`` holds each kernel against its twin.
``fused_t_messages`` uses the plain version only for tensors on the CPU.
"""

import ctypes
from typing import Optional

import torch

from torchmdnet_tpu_torch.ops.kernels import build, derivatives
from torchmdnet_tpu_torch.ops.kernels import et_message as em
from torchmdnet_tpu_torch.ops.neighbors import ell_gather, transpose_perm
from torchmdnet_tpu_torch.parallel.context import ShardPlan

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
        lib.t_bwd_src.argtypes = _COMMON + [_P] * 6
        lib.t_bwd_src.restype = _I
        lib.t_bwd2.argtypes = _COMMON + [_P] * 18
        lib.t_bwd2.restype = _I
        lib.t_bwd2_src.argtypes = _COMMON + [_P] * 11
        lib.t_bwd2_src.restype = _I
        lib.t_plan.argtypes = [_I] * 6 + [_P, _P]
        lib.t_plan.restype = _I
        lib.t_resources.argtypes = [_I] * 6 + [_P]
        lib.t_resources.restype = _I
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


def _prepare(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, heads, ext=False):
    """Validate the operands; return ((N, K, H, RBF), the 9 operands in the
    kernel's order, with the filters transposed to its (H, RBF) layout).

    ``ext`` (a rank's shard under edge partitioning): the source tables (k,
    v) may hold more rows than ``idx`` (ghost sources after the local rows),
    and so may the receiver-side tables (q, ea, cutm: ghost receivers after
    the local rows, which only the source passes read)."""
    dev = q.device
    n, kk = idx.shape
    ns, nr = (k.shape[0], q.shape[0]) if ext else (n, n)
    if ns < n or nr < n:
        raise ValueError(f"extended tables need at least the {n} rows of idx; got {ns} source, {nr} receiver rows")
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
    for t, name, rows in ((q, "q", nr), (k, "k", ns), (v, "v", ns)):
        check(t, name, bf, (rows, h), dev)
    check(ea, "ea", bf, (nr, kk, rbf), dev)
    check(cutm, "cutm", torch.float32, (nr, kk), dev)
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


def run_fwd(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, *, heads, act, attn_act, ext=False):
    """Launch the forward kernel; returns out (N, H) f32.  ``ext``: the
    source tables may hold ghost rows after the N local ones."""
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, heads, ext=ext)
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


def _filters_rows(wdk, wdv, h, dtype, device, cols=None):
    """(2H, cols) (cols defaults to RBF): the dk filter's columns, then the
    dv filter's, as rows; zero rows for an absent filter, zero padding
    columns."""
    rbf = (wdk if wdk is not None else wdv).shape[0]
    out = torch.zeros((2 * h, cols or rbf), dtype=dtype, device=device)
    if wdk is not None:
        out[:h, :rbf] = wdk.t()
    if wdv is not None:
        out[h:, :rbf] = wdv.t()
    return out


# --- the plain versions of the backward's and second order's passes: the
# kernels' arithmetic (rounding points included) in composable ops


class _Edges(em._Edges):
    """The per-edge operands of a list of edges ``e`` (flat indices i*K + k)
    whose source atoms are ``src``, in the kernels' precision (ET's
    ``_Edges`` without the vector features)."""

    def __init__(self, idx, e, src, q, ea, heads):
        n, kk = idx.shape
        self.h = q.shape[1]
        self.heads = heads
        self.bf = q.dtype
        self.acc = em._wdt(q.dtype)
        self.e, self.src, self.recv = e, src, torch.div(e, kk, rounding_mode="floor")
        self.ea = ea.reshape(-1, ea.shape[-1])[e]  # the slots of ghost receivers too, under partitioning

    def filters(self, wdk, bdk, wdv, bdv, act):
        """[(pre-activation, value)] of dk and dv (None where absent), as
        the kernels compute them: bf16(bf16(ea . W) + b), bf16(act(.))."""
        from torchmdnet_tpu_torch.ops.activations import act_fn_mapping

        out = []
        for w, b in ((wdk, bdk), (wdv, bdv)):
            if w is None:
                out.append(None)
                continue
            p = self.r(self.r(self.ea.to(self.acc) @ w.to(self.acc)) + b.reshape(-1).to(self.acc))
            out.append((p, self.r(act_fn_mapping[act](p))))
        return out


def _all_edges(idx, q, ea, heads):
    """``_Edges`` of every edge in row-major order (the receiver passes')."""
    return _Edges(idx, torch.arange(idx.numel(), device=idx.device), idx.reshape(-1).long(), q, ea, heads)


def _slot_sum(terms, n, kk):
    """(N, F) = each atom's K per-edge rows (rows of ``terms``, slot-major per
    atom) added one by one in slot order from 0: the order of the source
    passes' sums and of the buffer form's transpose-sum."""
    rows = terms.reshape(n, kk, -1)
    acc = torch.zeros_like(rows[:, 0])
    for s in range(kk):
        acc = acc + rows[:, s]
    return acc


def bwd_receiver_reference(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct, *, heads, act, attn_act,
                           want_dpre):
    """Plain version of the backward's receiver pass (``t_bwd_kernel``).

    Returns (dq (N, H), dea (N, K, RBF), dcutm (N, K), hs (N*K, 2, heads):
    each edge's head-summed d_prod and attn, dpre (N*K, 2H) the filter
    cotangents and db (2H,) their sum over the edges, both None unless
    ``want_dpre``); dq, dcutm, db in the accumulation dtype, the rest in the
    operands'."""
    from torchmdnet_tpu_torch.ops.activations import act_fn_mapping

    n, kk = idx.shape
    x = _all_edges(idx, q, ea, heads)
    r, bf, acc, h = x.r, x.bf, x.acc, q.shape[1]
    kj, vj = x.rows(k, "src"), x.rows(v, "src")
    qi, cti = x.rows(q, "recv"), r(x.rows(ct, "recv"))
    fk, fv = x.filters(wdk, bdk, wdv, bdv, act)
    cm = r(cutm.reshape(-1, 1).to(acc))
    vdv = r(vj * fv[1]) if fv else vj
    prod = r(qi * kj)
    if fk:
        prod = r(prod * fk[1])
    pre_a = r(x.head_sum(prod))
    a_act = r(act_fn_mapping[attn_act](pre_a))
    attn = r(a_act * cm)
    d_attn = r(cti * vdv)
    d_vdv = r(cti * attn)
    d_prea = r(r(r(em._dact(attn_act, pre_a)) * cm) * d_attn)
    dcutm = r(a_act * d_attn).sum(-1)
    d_prod = r(x.head_sum(d_prea))
    qk = r(d_prod * qi)
    dq = r(r(d_prod * kj) * fk[1]) if fk else r(d_prod * kj)
    zero = torch.zeros_like(qi)
    d_pre = torch.cat([r(r(em._dact(act, fk[0])) * r(qk * kj)) if fk else zero,
                       r(r(em._dact(act, fv[0])) * r(d_vdv * vj)) if fv else zero], dim=-1)
    if fk or fv:
        dea = (d_pre @ _filters_rows(wdk, wdv, h, acc, d_pre.device)).to(ea.dtype).reshape(ea.shape)
    else:
        dea = torch.zeros_like(ea)
    hd = h // heads
    hs = torch.stack([d_prod[:, ::hd], attn[:, ::hd]], dim=1).to(bf)
    dpre = db = None
    if want_dpre:
        dpre = d_pre.to(bf)
        db = dpre.to(acc).sum(0)
    return _slot_sum(dq, n, kk), dea, dcutm.reshape(n, kk), hs, dpre, db


def _bwd_source_terms(x, q, ct, hs, filt):
    """The backward's per-edge source-row cotangents (E, 2H) of the edges of
    ``x`` (an ``_Edges``), [k | v]: bf16 values (in bf16), wide, from
    ``filt`` (``_Edges.filters``) and hs's d_prod and attn:
    bf16(bf16(d_prod q_i) dk) and bf16(bf16(ct_i attn) dv)."""
    r = x.r
    qi, cti = x.rows(q, "recv"), r(x.rows(ct, "recv"))
    hs_e = hs.reshape(-1, 2, x.heads)[x.e].to(x.acc)
    d_prod, attn = x.heads_to_channels(hs_e[:, 0]), x.heads_to_channels(hs_e[:, 1])
    fk, fv = filt
    qk = r(d_prod * qi)
    d_vdv = r(cti * attn)
    return torch.cat([r(qk * fk[1]) if fk else qk, r(d_vdv * fv[1]) if fv else d_vdv], dim=-1)


def _split_kv(src, h):
    """(N, 2H) source-row gradients -> (k, v), each contiguous."""
    return src[:, :h].contiguous(), src[:, h:].contiguous()


def bwd_source_reference(idx, perm, q, ea, wdk, bdk, wdv, bdv, ct, hs, *, heads, act):
    """Plain version of the backward's source pass (``t_bwd_src_kernel``):
    per atom j, the per-edge source-row cotangents of the K edges that
    ``perm`` lists for j, recomputed from their ea rows, the receivers' rows
    and hs, summed in slot order in the accumulation dtype and rounded once.
    Returns (dk, dv) in the operands' dtype."""
    n, kk = idx.shape
    e, src = em._slots(idx, perm)
    x = _Edges(idx, e, src, q, ea, heads)
    terms = _bwd_source_terms(x, q, ct, hs, x.filters(wdk, bdk, wdv, bdv, act))
    return _split_kv(_slot_sum(terms, n, kk).to(q.dtype), q.shape[1])


def bwd_receiver(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct, *, heads, act, attn_act, want_dpre, ext=False):
    """The backward's receiver pass: (dq, dea, dcutm, hs, dpre, db) as
    ``bwd_receiver_reference`` returns them (dq, dcutm, db f32 on the card).
    CUDA tensors run ``t_bwd_kernel`` (counted by ``run_bwd.launches``), CPU
    tensors the plain version.  ``ext``: extended source tables, as
    ``run_fwd``'s."""
    if q.device.type == "cpu":
        return bwd_receiver_reference(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct, heads=heads, act=act,
                                      attn_act=attn_act, want_dpre=want_dpre)
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, heads, ext=ext)
    dev = q.device
    em._check(ct, "ct", torch.float32, (n, h), dev)
    f32, bf = torch.float32, torch.bfloat16
    dq = torch.empty((n, h), dtype=f32, device=dev)
    dea = torch.empty((n, kk, rbf), dtype=bf, device=dev)
    dcutm = torch.empty((n, kk), dtype=f32, device=dev)
    hs = torch.empty((n * kk, 2, heads), dtype=bf, device=dev)
    dpre = db_part = None
    with torch.cuda.device(dev):
        if want_dpre and (wdk is not None or wdv is not None):
            dpre = torch.empty((n * kk, 2 * h), dtype=bf, device=dev)
            db_part = _db_partials(lib, 1, n, kk, h, heads, rbf, dev)
        err = lib.t_bwd(
            em._ptr(idx), n, kk, h, heads, rbf, *[em._ptr(t) for t in tensors],
            em._ACT_CODE[act], em._ACT_CODE[attn_act], em._ptr(ct), em._ptr(dq), em._ptr(dea),
            em._ptr(dcutm), em._ptr(hs), em._ptr(dpre), em._ptr(db_part), _stream(dev),
        )
    _raise_on(lib, err, "t_bwd launch")
    run_bwd.launches += 1
    return dq, dea, dcutm, hs, dpre, None if db_part is None else db_part.sum(dim=0)


def bwd_source(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct, hs, *, heads, act, attn_act, ext=False):
    """The backward's source pass: (dk, dv) bf16 from the receiver pass's
    hs.  CUDA tensors run ``t_bwd_src_kernel``, CPU tensors
    ``bwd_source_reference``.

    ``ext`` (edge partitioning): the N = idx rows are the target atoms, and
    the receiver-side tables (q, ea, cutm, ct, hs) hold the ghost receivers'
    rows after the local ones; ``perm`` indexes their slots.  The kernel
    reads a slot's receiver as slot // K (and no cutm), so it runs
    unchanged."""
    if q.device.type == "cpu":
        return bwd_source_reference(idx, perm, q, ea, wdk, bdk, wdv, bdv, ct, hs, heads=heads, act=act)
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, heads, ext=ext)
    dev = q.device
    nr = q.shape[0]
    em._check(perm, "perm", torch.int32, (n * kk,), dev)
    em._check(ct, "ct", torch.float32, (nr, h), dev)
    em._check(hs, "hs", torch.bfloat16, (nr * kk, 2, heads), dev)
    outs = [torch.empty((n, h), dtype=torch.bfloat16, device=dev) for _ in range(2)]
    with torch.cuda.device(dev):
        err = lib.t_bwd_src(
            em._ptr(idx), n, kk, h, heads, rbf, *[em._ptr(t) for t in tensors],
            em._ACT_CODE[act], em._ACT_CODE[attn_act], em._ptr(perm), em._ptr(ct), em._ptr(hs),
            *[em._ptr(t) for t in outs], _stream(dev),
        )
    _raise_on(lib, err, "t_bwd_src launch")
    bwd_source.launches += 1
    return tuple(outs)


bwd_source.launches = 0


def _db_partials(lib, kind, n, kk, h, heads, rbf, dev):
    """The per-group f32 bias-gradient partials of a receiver pass's grid
    (kind 1 the backward's, 2 the second order's): (blocks * groups, 2H)."""
    blocks, groups = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.t_plan(kind, n, kk, h, heads, rbf, ctypes.byref(blocks), ctypes.byref(groups))
    _raise_on(lib, err, "t_plan")
    return torch.empty((blocks.value * groups.value, 2 * h), dtype=torch.float32, device=dev)


def run_bwd(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct, *, heads, act, attn_act,
            want_weight_grads: bool):
    """The backward: its receiver pass (``bwd_receiver``), its source pass
    (``bwd_source``) and, when wanted, the weight cotangents from the
    receiver pass's per-edge filter cotangents (``em.weight_grads``, ET's
    reduction kernel).  CPU tensors take the passes' plain versions.

    Returns (dq, dk, dv, dea, dcutm, dwdk, dbdk, dwdv, dbdv) in the operands'
    dtypes; the weight cotangents are None unless ``want_weight_grads``."""
    want_dw = want_weight_grads and (wdk is not None or wdv is not None)
    n, kk = idx.shape
    if q.device.type != "cpu":
        em._check(perm, "perm", torch.int32, (n * kk,), q.device)
    dq, dea, dcutm, hs, dpre, db = bwd_receiver(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct, heads=heads,
                                                act=act, attn_act=attn_act, want_dpre=want_dw)
    dk, dv = bwd_source(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct, hs, heads=heads, act=act,
                        attn_act=attn_act)
    gw = (None,) * 4
    if want_dw:
        dw = em.weight_grads([(ea.reshape(n * kk, -1), dpre)], ea.shape[-1])
        gw = em._split_weights(dw, db, q.shape[1], wdk, bdk, wdv, bdv)
    return (dq.to(q.dtype), dk, dv, dea, dcutm, *gw)


run_bwd.launches = 0


def _z_operands(inputs, Z):
    """The Z operands of the second order's passes (zq, zk, zv, zea bf16,
    zcutm f32): None becomes zeros."""
    def z(i, dtype):
        t, like = Z[i], inputs[i]
        return torch.zeros(like.shape, dtype=dtype, device=like.device) if t is None else t.to(dtype).contiguous()

    bf = torch.bfloat16
    return [z(0, bf), z(1, bf), z(2, bf), z(3, bf), z(4, torch.float32)]


def _z_filters(inputs, Z, h, rbf):
    """(zw_all, zbk, zbv) of the second order's kernels: the filters' Z as
    (2H, RBFP) bf16 rows, the Z biases flat (None without filters / for an
    absent filter)."""
    q, wdk, bdk, wdv, bdv = inputs[0], *inputs[5:9]
    bf = torch.bfloat16
    if wdk is None and wdv is None:
        return None, None, None
    zt = lambda i, like: (torch.zeros(like.shape, dtype=bf, device=like.device) if Z[i] is None
                          else Z[i].to(bf).contiguous())
    rbfp = -(-rbf // 16) * 16  # the kernels' (2H, RBFP) bf16 layout
    zw_all = _filters_rows(None if wdk is None else zt(5, wdk), None if wdv is None else zt(7, wdv), h, bf,
                           q.device, rbfp)
    zbk = None if wdk is None else zt(6, bdk).reshape(-1)
    zbv = None if wdv is None else zt(8, bdv).reshape(-1)
    return zw_all, zbk, zbv


class _Dual:
    """The second order's per-edge dual forward of an ``_Edges``: filters
    and their tangents (pre' = z_ea.W + ea.Z_W + z_b) with the activations'
    derivatives, as the kernels compute them."""

    def __init__(self, x, zea, inputs, Z, act):
        h, r, acc = x.h, x.r, x.acc
        wdk, bdk, wdv, bdv = inputs[5:9]
        one, zero = torch.ones_like(x.ea[:, :1], dtype=acc), torch.zeros_like(x.ea[:, :1], dtype=acc)
        self.dk, self.dk1, self.dk2, self.pkt, self.dkt = one, zero, zero, zero, zero
        self.dv, self.dv1, self.dv2, self.pvt, self.dvt = one, zero, zero, zero, zero
        self.has_dk, self.has_dv = wdk is not None, wdv is not None
        if not (self.has_dk or self.has_dv):
            return
        w = _filters_rows(wdk, wdv, h, acc, x.ea.device).t()
        zwm = _filters_rows(None if wdk is None else em._zero_if_none(Z[5], wdk),
                            None if wdv is None else em._zero_if_none(Z[7], wdv), h, acc, x.ea.device).t()
        ea, zea = x.ea.to(acc), zea.reshape(-1, zea.shape[-1])[x.e].to(acc)
        pre = r(ea @ w)
        pret = r(zea @ w + ea @ zwm)
        if self.has_dk:
            pk = r(pre[:, :h] + bdk.reshape(-1).to(acc))
            f, self.dk1, self.dk2 = em._act3(act, pk)
            self.dk = r(f)
            self.pkt = r(pret[:, :h] + em._zero_if_none(Z[6], bdk).reshape(-1).to(acc))
            self.dkt = self.dk1 * self.pkt
        if self.has_dv:
            pv = r(pre[:, h:] + bdv.reshape(-1).to(acc))
            f, self.dv1, self.dv2 = em._act3(act, pv)
            self.dv = r(f)
            self.pvt = r(pret[:, h:] + em._zero_if_none(Z[8], bdv).reshape(-1).to(acc))
            self.dvt = self.dv1 * self.pvt


def bwd2_receiver_reference(idx, inputs, ct, Z, *, heads, act, attn_act):
    """Plain version of the second order's receiver pass (``t_bwd2_kernel``).

    Returns (gq (N, H), gea (N, K, RBF), gcutm (N, K), gct (N, H), hs4 (N*K,
    4, heads): attn, attn' and the head-summed reverse seeds of prod' and
    prod, bpre and bpret (N*K, 2H) the filter cotangents and their
    tangents', and db (2H,), the last three None without filters); gea,
    bpre, bpret in the operands' dtype, the rest in the accumulation dtype."""
    q, k, v, ea, cutm, wdk, bdk, wdv, bdv = inputs
    n, kk = idx.shape
    h = q.shape[1]
    x = _all_edges(idx, q, ea, heads)
    r, acc = x.r, x.acc
    z = [em._zero_if_none(Z[i], inputs[i]) for i in range(5)]
    d = _Dual(x, z[3], inputs, Z, act)
    xk, xv, zk, zv = x.rows(k, "src"), x.rows(v, "src"), x.rows(z[1], "src"), x.rows(z[2], "src")
    qi, zqi, cti = x.rows(q, "recv"), x.rows(z[0], "recv"), r(x.rows(ct, "recv"))
    cm = r(cutm.reshape(-1, 1).to(acc))
    zcm = z[4].reshape(-1, 1).to(acc)
    qk = r(qi * xk)
    prod = r(qk * d.dk) if d.has_dk else qk
    prodt = (zqi * xk + qi * zk) * d.dk + qi * xk * d.dkt
    pa = r(x.head_sum(prod))
    pat = x.head_sum(prodt)
    aa, a1, a2 = em._act3(attn_act, pa)
    aa = r(aa)
    attn = r(aa * cm)
    attnt = a1 * pat * cm + aa * zcm
    vdv = r(xv * d.dv) if d.has_dv else xv
    vdvt = zv * d.dv + xv * d.dvt
    gct = vdvt * attn + vdv * attnt
    b_vdvt, b_vdv = cti * attn, cti * attnt
    b_attnt, b_attn = cti * vdv, cti * vdvt
    gcutm = (b_attnt * a1 * pat + b_attn * aa).sum(-1).reshape(n, kk)
    b_prodt = x.head_sum(b_attnt * a1 * cm)
    b_prod = x.head_sum(b_attnt * (a2 * pat * cm + a1 * zcm) + b_attn * a1 * cm)
    hd = h // heads
    hs4 = torch.stack([attn[:, ::hd], attnt[:, ::hd], b_prodt[:, ::hd], b_prod[:, ::hd]], dim=1)
    gq = b_prodt * (zk * d.dk + xk * d.dkt) + b_prod * xk * d.dk
    zero = torch.zeros_like(qi)
    bpre, bpret = [zero, zero], [zero, zero]
    if d.has_dk:
        b_dk = b_prodt * (zqi * xk + qi * zk) + b_prod * qi * xk
        b_dkt = b_prodt * qi * xk
        bpret[0] = b_dkt * d.dk1
        bpre[0] = b_dkt * d.dk2 * d.pkt + b_dk * d.dk1
    if d.has_dv:
        b_dv = b_vdvt * zv + b_vdv * xv
        b_dvt = b_vdvt * xv
        bpret[1] = b_dvt * d.dv1
        bpre[1] = b_dvt * d.dv2 * d.pvt + b_dv * d.dv1
    bpre_b = bpret_b = db = None
    if d.has_dk or d.has_dv:
        bpre_b, bpret_b = torch.cat(bpre, -1).to(x.bf), torch.cat(bpret, -1).to(x.bf)
        wm = _filters_rows(wdk, wdv, h, acc, ea.device)
        zwm = _filters_rows(None if wdk is None else em._zero_if_none(Z[5], wdk),
                            None if wdv is None else em._zero_if_none(Z[7], wdv), h, acc, ea.device)
        gea = (bpre_b.to(acc) @ wm + bpret_b.to(acc) @ zwm).to(ea.dtype).reshape(ea.shape)
        db = bpre_b.to(acc).sum(0)
    else:
        gea = torch.zeros_like(ea)
    return (_slot_sum(gq, n, kk), gea, gcutm, _slot_sum(gct, n, kk), hs4, bpre_b, bpret_b, db)


def _bwd2_source_terms(x, d, q, ct, z, hs4):
    """The second order's per-edge source-row gradients (E, 2H) of the edges
    of ``x``, [k | v], wide, from ``d`` (``_Dual``) and hs4."""
    qi, zqi, cti = x.rows(q, "recv"), x.rows(z[0], "recv"), x.r(x.rows(ct, "recv"))
    hs_e = hs4.reshape(-1, 4, x.heads)[x.e].to(x.acc)
    attn, attnt, b_prodt, b_prod = (x.heads_to_channels(hs_e[:, s]) for s in range(4))
    g_k = b_prodt * (zqi * d.dk + qi * d.dkt) + b_prod * qi * d.dk
    g_v = cti * attn * d.dvt + cti * attnt * d.dv
    return torch.cat([g_k, g_v], dim=-1)


def bwd2_source_reference(idx, perm, inputs, ct, Z, hs4, *, heads, act):
    """Plain version of the second order's source pass
    (``t_bwd2_src_kernel``): per atom j, the per-edge gradients of k_j and
    v_j over the K edges ``perm`` lists for j, summed in slot order in the
    accumulation dtype and rounded once to the operands' dtype.  Returns
    (gk, gv)."""
    q, ea = inputs[0], inputs[3]
    n, kk = idx.shape
    e, src = em._slots(idx, perm)
    x = _Edges(idx, e, src, q, ea, heads)
    z = [em._zero_if_none(Z[i], inputs[i]) for i in range(5)]
    terms = _bwd2_source_terms(x, _Dual(x, z[3], inputs, Z, act), q, ct, z, hs4)
    return _split_kv(_slot_sum(terms, n, kk).to(q.dtype), q.shape[1])


def bwd2_receiver(idx, inputs, ct, Z, *, heads, act, attn_act, ext=False):
    """The second order's receiver pass: (gq, gea, gcutm, gct, hs4, bpre,
    bpret, db) as ``bwd2_receiver_reference`` returns them.  CUDA tensors
    run ``t_bwd2_kernel`` (counted by ``run_bwd2.launches``), CPU tensors
    the plain version.  ``ext``: the source tables (k, v) and their Z hold
    ghost rows after the N local ones."""
    q, k, v, ea, cutm, wdk, bdk, wdv, bdv = inputs
    if q.device.type == "cpu":
        return bwd2_receiver_reference(idx, inputs, ct, Z, heads=heads, act=act, attn_act=attn_act)
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, heads, ext=ext)
    if h > 256:
        raise ValueError(f"the second-order Transformer kernel takes H <= 256; got H={h}")
    dev = q.device
    f32, bf = torch.float32, torch.bfloat16
    em._check(ct, "ct", f32, (n, h), dev)
    zs = _z_operands(inputs, Z)
    zw_all, zbk, zbv = _z_filters(inputs, Z, h, rbf)
    gq = torch.empty((n, h), dtype=f32, device=dev)
    gea = torch.empty((n, kk, rbf), dtype=bf, device=dev)
    gcutm = torch.empty((n, kk), dtype=f32, device=dev)
    gct = torch.empty((n, h), dtype=f32, device=dev)
    hs4 = torch.empty((n * kk, 4, heads), dtype=f32, device=dev)
    bpre = bpret = db_part = None
    with torch.cuda.device(dev):
        if zw_all is not None:
            bpre = torch.empty((n * kk, 2 * h), dtype=bf, device=dev)
            bpret = torch.empty((n * kk, 2 * h), dtype=bf, device=dev)
            db_part = _db_partials(lib, 2, n, kk, h, heads, rbf, dev)
        err = lib.t_bwd2(
            em._ptr(idx), n, kk, h, heads, rbf, *[em._ptr(t) for t in tensors],
            em._ACT_CODE[act], em._ACT_CODE[attn_act], em._ptr(ct), *[em._ptr(t) for t in zs],
            em._ptr(zw_all), em._ptr(zbk), em._ptr(zbv), em._ptr(gq), em._ptr(gea),
            em._ptr(gcutm), em._ptr(gct), em._ptr(hs4), em._ptr(bpre), em._ptr(bpret), em._ptr(db_part),
            _stream(dev),
        )
    _raise_on(lib, err, "t_bwd2 launch")
    run_bwd2.launches += 1
    db = None if db_part is None else db_part.sum(dim=0)
    return gq, gea, gcutm, gct, hs4, bpre, bpret, db


def bwd2_source(idx, perm, inputs, ct, Z, hs4, *, heads, act, attn_act, ext=False):
    """The second order's source pass: (gk, gv) bf16 from the receiver
    pass's hs4.  CUDA tensors run ``t_bwd2_src_kernel``, CPU tensors
    ``bwd2_source_reference``.  ``ext`` as ``bwd_source``'s (q, ea, ct,
    their Z and hs4 extended with the ghost receivers' rows)."""
    q = inputs[0]
    if q.device.type == "cpu":
        return bwd2_source_reference(idx, perm, inputs, ct, Z, hs4, heads=heads, act=act)
    lib = _lib()
    (n, kk, h, rbf), tensors = _prepare(idx, *inputs, heads, ext=ext)
    dev = q.device
    nr = q.shape[0]
    f32, bf = torch.float32, torch.bfloat16
    em._check(perm, "perm", torch.int32, (n * kk,), dev)
    em._check(ct, "ct", f32, (nr, h), dev)
    em._check(hs4, "hs4", f32, (nr * kk, 4, heads), dev)
    zs = _z_operands(inputs, Z)
    zw_all, zbk, zbv = _z_filters(inputs, Z, h, rbf)
    outs = [torch.empty((n, h), dtype=bf, device=dev) for _ in range(2)]
    with torch.cuda.device(dev):
        err = lib.t_bwd2_src(
            em._ptr(idx), n, kk, h, heads, rbf, *[em._ptr(t) for t in tensors],
            em._ACT_CODE[act], em._ACT_CODE[attn_act], em._ptr(perm), em._ptr(ct), em._ptr(zs[0]),
            em._ptr(zs[3]), em._ptr(zw_all), em._ptr(zbk), em._ptr(zbv), em._ptr(hs4),
            *[em._ptr(t) for t in outs], _stream(dev),
        )
    _raise_on(lib, err, "t_bwd2_src launch")
    bwd2_source.launches += 1
    return tuple(outs)


bwd2_source.launches = 0


def run_bwd2(idx, perm, inputs, ct, Z, *, heads, act, attn_act):
    """The second order: its receiver pass (``bwd2_receiver``), its source
    pass (``bwd2_source``) and the weight gradients from the receiver pass's
    per-edge filter cotangents (``em.weight_grads``).  CPU tensors take the
    passes' plain versions.

    ``inputs`` are the fused op's 9 operands (filters None where absent),
    ``ct`` the (N, H) cotangent, ``Z`` the 9 cotangents on ``run_bwd``'s
    outputs (None means zero).  Returns (g_inputs, g_ct): the 9 gradients in
    the inputs' dtypes (None for absent filters) and g_ct f32 (the
    accumulation dtype on the CPU)."""
    q, ea, wdk, bdk, wdv, bdv = inputs[0], inputs[3], *inputs[5:9]
    n, kk = idx.shape
    if q.device.type != "cpu":
        em._check(perm, "perm", torch.int32, (n * kk,), q.device)
        ct = ct.to(torch.float32).contiguous()
    gq, gea, gcutm, gct, hs4, bpre, bpret, db = bwd2_receiver(idx, inputs, ct, Z, heads=heads, act=act,
                                                              attn_act=attn_act)
    gk, gv = bwd2_source(idx, perm, inputs, ct, Z, hs4, heads=heads, act=act, attn_act=attn_act)
    gw = (None,) * 4
    if bpre is not None:
        zea = em._zero_if_none(Z[3], ea).to(ea.dtype).reshape(n * kk, -1).contiguous()
        dw = em.weight_grads([(ea.reshape(n * kk, -1), bpre), (zea, bpret)], ea.shape[-1])
        gw = em._split_weights(dw, db, q.shape[1], wdk, bdk, wdv, bdv)
    return (gq.to(q.dtype), gk, gv, gea, gcutm, *gw), gct


run_bwd2.launches = 0


def kernel_resources(kind, n, kk, h, heads, rbf):
    """A pass's resources at a shape, from the CUDA runtime (kind 1
    ``t_bwd_kernel``, 2 ``t_bwd2_kernel``, 3 ``t_bwd_src_kernel``, 4
    ``t_bwd2_src_kernel``, 5 ``t_fwd_kernel``): {registers, spill_bytes
    (local memory a thread), threads, smem (dynamic shared memory a block),
    blocks_per_sm (resident)}.  Needs a CUDA device."""
    lib = _lib()
    out = (ctypes.c_int * 5)()
    _raise_on(lib, lib.t_resources(kind, n, kk, h, heads, rbf, out), "t_resources")
    return dict(zip(("registers", "spill_bytes", "threads", "smem", "blocks_per_sm"), out))


def reset_launch_counts():
    run_fwd.launches = 0
    run_bwd.launches = 0
    run_bwd2.launches = 0
    bwd_source.launches = 0
    bwd2_source.launches = 0


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
    g_inputs, (g_ct,) = derivatives.second_order(_twin((heads, act, attn_act), idx, perm), inputs, (ct,), Z)
    return tuple(g_inputs), g_ct


def _twin(cfg, idx, perm):
    """``t_messages_reference`` as a function of the 9 operands: the plain
    twin every composable derivative rule differentiates (``perm`` a
    ``ShardPlan``: this rank's rows, its gathers through the exchange)."""
    heads, act, attn_act = cfg
    return lambda *a: (t_messages_reference(idx, *a, heads=heads, act=act, attn_act=attn_act, perm=perm),)


def _bwd_outputs(g, want_w):
    """The 9 input gradients of a composable rule as the backward's outputs
    (no weight cotangents unless ``want_w``)."""
    return tuple(g[:5]) + (tuple(g[5:]) if want_w else (None,) * 4)


class _TMessages(torch.autograd.Function):
    """The fused edge phase (#11); its backward is the backward kernel
    (#12), differentiable through ``_TMessagesBwd`` when grad mode is on
    (``create_graph=True``: a force-loss training step's inner pass) or a
    forward-mode tangent is live.  The tangent is composable: the double vjp
    of the plain twin."""

    @staticmethod
    def forward(ctx, cfg, idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv):
        heads, act, attn_act = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv)
        ctx.save_for_forward(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv)
        return run_fwd(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv,
                       heads=heads, act=act, attn_act=attn_act)

    @staticmethod
    def jvp(ctx, _cfg, _idx, _perm, *t_inputs):
        idx, perm, *inputs = ctx.saved_tensors
        return derivatives.jvp(_twin(ctx.cfg, idx, perm), inputs, t_inputs)[0]

    @staticmethod
    def backward(ctx, ct):
        heads, act, attn_act = ctx.cfg
        idx, perm, *inputs = ctx.saved_tensors
        want_w = any(ctx.needs_input_grad[8:12])
        ct = ct.contiguous()
        if torch.is_grad_enabled() or derivatives.tangent_live(*inputs, ct):
            g = _TMessagesBwd.apply(ctx.cfg, want_w, idx, perm, *inputs, ct)
        else:
            g = run_bwd(idx, perm, *inputs, ct, heads=heads, act=act, attn_act=attn_act,
                        want_weight_grads=want_w)
        return (None, None, None, *g)


class _TMessagesBwd(torch.autograd.Function):
    """The backward kernel (#12) as a function of (inputs, ct); its gradient
    is the second-order kernel (#13) through ``derivatives.Bwd2``, its
    tangent the composable ``derivatives.vjp_tangent`` of the plain twin.
    Outputs are ``run_bwd``'s 9."""

    @staticmethod
    def forward(ctx, cfg, want_w, idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct):
        heads, act, attn_act = cfg
        ctx.cfg, ctx.want_w = cfg, want_w
        ctx.save_for_backward(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct)
        ctx.save_for_forward(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct)
        return run_bwd(idx, perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct,
                       heads=heads, act=act, attn_act=attn_act, want_weight_grads=want_w)

    @staticmethod
    def jvp(ctx, _cfg, _want_w, _idx, _perm, *t):
        idx, perm, *rest = ctx.saved_tensors
        g = derivatives.vjp_tangent(_twin(ctx.cfg, idx, perm), rest[:9], rest[9:], t[:9], t[9:])
        return _bwd_outputs(g, ctx.want_w)

    @staticmethod
    def backward(ctx, *zs):
        heads, act, attn_act = ctx.cfg
        idx, perm, *rest = ctx.saved_tensors
        def run(ins, c, z):
            return run_bwd2(idx, perm, ins, c[0], z, heads=heads, act=act, attn_act=attn_act)

        if torch.is_grad_enabled() or derivatives.tangent_live(*rest, *zs):  # a third derivative
            g = derivatives.bwd2_apply(run, _twin(ctx.cfg, idx, perm), rest[:9], rest[9:], zs)
            return (None, None, None, None, *g)
        return (None, None, None, None, *derivatives.flat(run(rest[:9], rest[9:], list(zs))))


def _shard_bwd(cfg, plan, srcs, inputs, ct, want_w):
    """The backward (#12) on one rank's rows, as ET's ``_shard_bwd``: the
    receiver pass on the local receivers over the extended source tables
    ``srcs`` (k, v), the ghost receivers' rows (q, ct, each slot's ea and the
    receiver pass's hs) exchanged, then the source pass over this rank's
    atoms through the global transpose permutation's slots.  Returns (the 9
    gradients of ``run_bwd``, this rank's share of the weight cotangents;
    the extended receiver tables (q, ea, ct) the second order reads)."""
    from torchmdnet_tpu_torch.parallel.edge_partition import extend_rows

    heads, act, attn_act = cfg
    q, _, _, ea, cutm, wdk, bdk, wdv, bdv = inputs
    n, kk = plan.lidx.shape
    want_w = want_w and (wdk is not None or wdv is not None)
    dq, dea, dcutm, hs, dpre, db = bwd_receiver(plan.lidx, q, *srcs, ea, cutm, wdk, bdk, wdv, bdv, ct, heads=heads,
                                                act=act, attn_act=attn_act, want_dpre=want_w, ext=True)
    q_rx, ea_rx, ct_rx, hs_rx = extend_rows(plan, [q, ea, ct, hs], "rx")
    # the source passes read no cutm: a stand-in of its shape
    cut_rx = ct_rx.new_zeros(ea_rx.shape[:2])
    dk, dv = bwd_source(plan.lidx, plan.perm_rx, q_rx, *srcs, ea_rx, cut_rx, wdk, bdk, wdv, bdv, ct_rx, hs_rx,
                        heads=heads, act=act, attn_act=attn_act, ext=True)
    gw = (None,) * 4
    if want_w:  # this rank's edges' share
        dw = em.weight_grads([(ea.reshape(n * kk, -1), dpre)], ea.shape[-1])
        gw = em._split_weights(dw, db, q.shape[1], wdk, bdk, wdv, bdv)
    return (dq.to(q.dtype), dk, dv, dea, dcutm, *gw), (q_rx, ea_rx, ct_rx)


def _shard_bwd2(cfg, plan, srcs, inputs, ct, rx, zs):
    """The second order (#13) on one rank's rows, as ET's ``_shard_bwd2``:
    the Z of the source rows through the forward's exchange, the receiver
    pass on the local receivers (every receiver-side gradient whole), the
    ghost receivers' Z and hs4 exchanged, the source pass over this rank's
    atoms.  The Z on the weight cotangents must be the same on every rank.
    Returns the gradients of (inputs (9), ct)."""
    from torchmdnet_tpu_torch.parallel.edge_partition import extend_rows

    heads, act, attn_act = cfg
    n, kk = plan.lidx.shape
    q, ea = inputs[0], inputs[3]
    if q.device.type != "cpu":
        ct = ct.to(torch.float32).contiguous()
    Z = [None if z is None else z.contiguous() for z in zs]
    Z = [torch.zeros_like(inputs[i]) if Z[i] is None and i < 5 else Z[i] for i in range(9)]
    zk, zv = extend_rows(plan, Z[1:3], "src")
    gq, gea, gcutm, gct, hs4, bpre, bpret, db = bwd2_receiver(
        plan.lidx, (q, *srcs, *inputs[3:]), ct, [Z[0], zk, zv, *Z[3:]], heads=heads, act=act, attn_act=attn_act,
        ext=True)
    zq_rx, zea_rx, hs4_rx = extend_rows(plan, [Z[0], Z[3], hs4], "rx")
    q_rx, ea_rx, ct_rx = rx
    cut_rx = ct_rx.new_zeros(ea_rx.shape[:2])
    gk, gv = bwd2_source(plan.lidx, plan.perm_rx, (q_rx, *srcs, ea_rx, cut_rx, *inputs[5:]), ct_rx,
                         [zq_rx, zk, zv, zea_rx, None, *Z[5:]], hs4_rx, heads=heads, act=act, attn_act=attn_act,
                         ext=True)
    gw = (None,) * 4
    if bpre is not None:  # this rank's edges' share
        zea = Z[3].to(ea.dtype).reshape(n * kk, -1).contiguous()
        dw = em.weight_grads([(ea.reshape(n * kk, -1), bpre), (zea, bpret)], ea.shape[-1])
        gw = em._split_weights(dw, db, q.shape[1], *inputs[5:9])
    return (gq.to(q.dtype), gk, gv, gea, gcutm, *gw, gct)


class _TMessagesShard(torch.autograd.Function):
    """The fused edge phase on one rank's receiver rows under edge
    partitioning (``plan`` a ``ShardPlan``), as ET's ``_EtMessagesShard``:
    the forward (#11) over the source tables [k | v] extended with the ghost
    rows (one exchange), the backward (#12, ``_shard_bwd``), differentiable
    through ``_TMessagesShardBwd`` (#13, ``_shard_bwd2``); the composable
    rules gather through the exchange.  CPU tensors run the passes' plain
    versions."""

    @staticmethod
    def forward(ctx, cfg, plan, q, k, v, ea, cutm, wdk, bdk, wdv, bdv):
        from torchmdnet_tpu_torch.parallel.context import ring_scope
        from torchmdnet_tpu_torch.parallel.edge_partition import extend_rows

        heads, act, attn_act = cfg
        srcs = extend_rows(plan, [k, v], "src")
        ctx.cfg, ctx.plan = cfg, plan
        ctx.save_for_backward(q, k, v, ea, cutm, wdk, bdk, wdv, bdv, *srcs)
        ctx.save_for_forward(q, k, v, ea, cutm, wdk, bdk, wdv, bdv)
        if q.device.type == "cpu":
            with ring_scope(None), torch.no_grad():  # local ids into the extended tables
                return t_messages_reference(plan.lidx, q, *srcs, ea, cutm, wdk, bdk, wdv, bdv, heads=heads, act=act,
                                            attn_act=attn_act, perm=plan.perm_rx)
        return run_fwd(plan.lidx, q, *srcs, ea, cutm, wdk, bdk, wdv, bdv, heads=heads, act=act, attn_act=attn_act,
                       ext=True)

    @staticmethod
    def jvp(ctx, _cfg, _plan, *t_inputs):
        return derivatives.jvp(_twin(ctx.cfg, ctx.plan.lidx, ctx.plan), ctx.saved_tensors, t_inputs)[0]

    @staticmethod
    def backward(ctx, ct):
        saved = ctx.saved_tensors
        inputs, srcs = saved[:9], saved[9:]
        want_w = any(ctx.needs_input_grad[7:11])
        ct = ct.contiguous()
        if torch.is_grad_enabled() or derivatives.tangent_live(*inputs, ct):
            g = _TMessagesShardBwd.apply(ctx.cfg, ctx.plan, want_w, srcs, *inputs, ct)
        else:
            g = _shard_bwd(ctx.cfg, ctx.plan, srcs, inputs, ct, want_w)[0]
        return (None, None, *g)


class _TMessagesShardBwd(torch.autograd.Function):
    """``_shard_bwd`` as a function of this rank's (inputs, ct); its gradient
    is ``_shard_bwd2`` through ``derivatives.Bwd2``.  ``srcs`` (the
    forward's extended source tables) is not an input.  The weight
    cotangents, their tangent and their gradients are this rank's share."""

    @staticmethod
    def forward(ctx, cfg, plan, want_w, srcs, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, ct):
        inputs = (q, k, v, ea, cutm, wdk, bdk, wdv, bdv)
        grads, rx = _shard_bwd(cfg, plan, srcs, inputs, ct, want_w)
        ctx.cfg, ctx.plan, ctx.want_w = cfg, plan, want_w
        ctx.save_for_backward(*inputs, ct, *srcs, *rx)
        ctx.save_for_forward(*inputs, ct)
        return grads

    @staticmethod
    def jvp(ctx, _cfg, _plan, _want_w, _srcs, *t):
        saved = ctx.saved_tensors
        g = derivatives.vjp_tangent(_twin(ctx.cfg, ctx.plan.lidx, ctx.plan), saved[:9], saved[9:], t[:9], t[9:])
        return _bwd_outputs(g, ctx.want_w)

    @staticmethod
    def backward(ctx, *zs):
        saved = ctx.saved_tensors
        inputs, ct, srcs, rx = saved[:9], saved[9], saved[10:12], saved[12:]
        if torch.is_grad_enabled() or derivatives.tangent_live(*saved[:10], *zs):  # a third derivative
            def run(ins, c, z):
                g = _shard_bwd2(ctx.cfg, ctx.plan, srcs, ins, c[0], rx, z)
                return g[:9], g[9:]

            twin = _twin(ctx.cfg, ctx.plan.lidx, ctx.plan)
            return (None, None, None, None, *derivatives.bwd2_apply(run, twin, inputs, (ct,), zs))
        return (None, None, None, None, *_shard_bwd2(ctx.cfg, ctx.plan, srcs, inputs, ct, rx, zs))


def fused_t_messages(
    idx, q, k, v, ea, cutm, wdk=None, bdk=None, wdv=None, bdv=None, *, heads: int,
    act: str = "silu", attn_act: str = "silu", perm: Optional[torch.Tensor] = None,
):
    """Fused Transformer edge phase: out (N, H) in f32.

    Arguments as ``t_messages_reference``; on the GPU the message operands
    are bf16.  CUDA tensors run the kernels (or raise); CPU tensors run the
    plain version.  A ``ShardPlan`` as ``perm`` (edge partitioning: this
    rank's receiver rows, global ids in ``idx``) runs ``_TMessagesShard``.
    """
    if isinstance(perm, ShardPlan):
        if q.device.type == "cuda" and (act not in em._ACT_CODE or attn_act not in em._ACT_CODE):
            raise ValueError(f"unsupported activation for the fused Transformer kernel: {act}, {attn_act}")
        return _TMessagesShard.apply((heads, act, attn_act), perm, q, k, v, ea, cutm, wdk, bdk, wdv, bdv)
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
