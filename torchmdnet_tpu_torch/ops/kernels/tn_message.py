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
and one backward launch per layer.  The backward is differentiable
(``_TnMessagesBwd``): its gradient is the second-order kernel, so a
force-loss training step runs per layer one forward, two backward (the inner
force pass and the outer energy term) and one second-order launch.  The
tangents and the orders above the second are composable, as ET's
(``derivatives.py``).

``tn_messages_reference`` is the plain PyTorch version of the same function
(the counterpart of ``_composable_tn_reference``, tn_message.py:241), with
gradients from autograd; ``tn_messages_bwd2_reference`` is the plain version
of the second-order kernel (the counterpart of ``_composable_tn_bwd_vjp``,
:380).  ``fused_tn_messages`` uses the plain version only for tensors on the
CPU.  The weight cotangents of the backward and the second order are
reduced from per-edge rows the kernels write (``weight_grads``, a launch of
ET's ``et_dw_kernel``, which sums the biases too); ``bwd_reference`` (the
backward's outputs and rows in its arithmetic) and
``weight_grads_reference`` are their plain twins, which ``bwd_rows`` and
``weight_grads`` run for CPU tensors.

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

from torchmdnet_tpu_torch.ops.kernels import build, derivatives, save_list
from torchmdnet_tpu_torch.ops.kernels.et_message import _act3, _act_v, _check, _dact, _ptr, dw_partials, dw_per_split
from torchmdnet_tpu_torch.ops.neighbors import ell_gather, transpose_perm
from torchmdnet_tpu_torch.parallel.context import ShardPlan

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
        lib.tn_resources.argtypes = [_I] * 5 + [_P]
        for fn in (lib.tn_fwd, lib.tn_bwd, lib.tn_bwd2, lib.tn_src_sum, lib.tn_resources):
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


def _prepare(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ext=False):
    """Validate the operands; return ((N, K, H, RBF), the nine operands in
    the kernels' layout: weights contiguous (in, out), w1 zero-padded to
    RBFP = RBF rounded up to 16 rows, biases flat).  ``ext`` (a rank's shard
    under edge partitioning): ``cat`` may hold ghost source rows after the
    N local ones, which ``idx`` indexes."""
    dev = cat.device
    n, kk = idx.shape
    ns = cat.shape[0] if ext else n
    if ns < n:
        raise ValueError(f"an extended table needs at least the {n} rows of idx; got {ns}")
    h = cat.shape[1] // 9
    rbf = ea.shape[-1]
    rbfp = -(-rbf // 16) * 16
    if h % 32 or not 32 <= h <= 128 or rbfp > 128 or cat.shape[1] != 9 * h:
        raise ValueError(f"the fused TensorNet kernels take 32 <= H <= 128 with H % 32 == 0 and "
                         f"RBF <= 128; got H={cat.shape[1] / 9}, RBF={rbf}")
    bf = torch.bfloat16
    _check(idx, "idx", torch.int32, (n, kk), dev)
    _check(cat, "cat", bf, (ns, 9 * h), dev)
    _check(ea, "ea", bf, (n, kk, rbf), dev)
    _check(cutm, "cutm", torch.float32, (n, kk), dev)
    w1p = torch.zeros((rbfp, h), dtype=bf, device=dev)
    w1p[:rbf] = w1
    ws = [w1p, b1.reshape(-1).contiguous(), w2.contiguous(), b2.reshape(-1).contiguous(),
          w3.contiguous(), b3.reshape(-1).contiguous()]
    for t, name, shape in zip(ws, ("w1", "b1", "w2", "b2", "w3", "b3"),
                              ((rbfp, h), (h,), (h, 2 * h), (2 * h,), (2 * h, 3 * h), (3 * h,))):
        _check(t, name, bf, shape, dev)
    # the kernels gather cat 4 bytes at a time and copy W2 and W3 16 bytes at a time
    if cat.data_ptr() % 4:
        cat = cat.clone()
    for i in (2, 4):
        if ws[i].data_ptr() % 16:
            ws[i] = ws[i].clone()
    return (n, kk, h, rbf), [cat, ea, cutm] + ws


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def run_fwd(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, *, act, ext=False):
    """Launch the forward kernel; returns m (N, 9H) f32.  ``ext``: ``cat``
    may hold ghost rows after the N local ones."""
    lib = _lib()
    (n, kk, h, rbf), ops = _prepare(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ext=ext)
    m = torch.empty((n, 9 * h), dtype=torch.float32, device=cat.device)
    with torch.cuda.device(cat.device):
        err = lib.tn_fwd(_ptr(idx), n, kk, h, rbf, *[_ptr(t) for t in ops], _ACT_CODE[act], _ptr(m),
                         _stream(cat.device))
    _raise_on(lib, err, "tn_fwd launch")
    run_fwd.launches += 1
    return m


run_fwd.launches = 0


# --- the weight reduction: per-edge rows (E, width) bf16 -> each product's
# (pn, qn) and (qn,) f32 cotangents


def _rbfp(rbf):
    return -(-rbf // 16) * 16


def _bwd_jobs(h, rbfp):
    """The backward's rows [ea | t1 | d_p1 | t2 | d_p2 | d_p3]: (a_off, pn,
    b_off, qn) of dW1 = ea^T d_p1, dW2 = t1^T d_p2, dW3 = t2^T d_p3 (and the
    biases, the column sums of the d_p)."""
    return [(0, rbfp, rbfp + h, h), (rbfp, h, rbfp + 4 * h, 2 * h), (rbfp + 2 * h, 2 * h, rbfp + 6 * h, 3 * h)]


def _bwd2_jobs(h, rbfp):
    """The second order's rows [ea | z_ea | t1 | t1' | p1_bar | p1'_bar | t2 |
    t2' | p2_bar | p2'_bar | p3_bar | p3'_bar]: per product (a_off, pn,
    b_off, qn) of the value pair and of the tangent pair (the biases: the
    column sums of the value pair's B)."""
    o = 2 * rbfp
    return [((0, rbfp, o + 2 * h, h), (rbfp, rbfp, o + 3 * h, h)),
            ((o, h, o + 8 * h, 2 * h), (o + h, h, o + 10 * h, 2 * h)),
            ((o + 4 * h, 2 * h, o + 12 * h, 3 * h), (o + 6 * h, 2 * h, o + 15 * h, 3 * h))]


# streaming multiprocessors the reduction's splits are planned for on the
# CPU, where the plain version runs (an H100's count)
_PLAN_SMS = 132


def _pairs(job):
    """A product's (a_off, pn, b_off, qn) pairs: one, or the second order's two."""
    return job if isinstance(job[0], tuple) else (job,)


def _per_split(ne, jobs, sms):
    """Edges a split of the reduction (``dw_per_split``) over all the
    products' blocks."""
    return dw_per_split(ne, sum(-(-pn // 64) * -(-qn // 128) for (_, pn, _, qn), *_ in map(_pairs, jobs)), sms)


def weight_grads_reference(rows, jobs, per_split):
    """Plain version of the reduction (``et_dw_kernel``): for each product
    (a pair of column blocks (a_off, pn, b_off, qn) of ``rows``, or two
    pairs), (dw (pn, qn), db (qn,)) = the sums over the edge splits of
    ``per_split`` rows (the last one ragged) of A^T B (+ A2^T B2) and of B's
    column sums (the first pair's), in the accumulation dtype."""
    acc = _wide(rows[:1]).dtype
    out = []
    for job in jobs:
        pairs = _pairs(job)
        dw = db = 0
        for s0 in range(0, rows.shape[0], per_split):
            part = rows[s0:s0 + per_split].to(acc)
            for i, (ao, pn, bo, qn) in enumerate(pairs):
                b = part[:, bo:bo + qn]
                dw = dw + part[:, ao:ao + pn].t() @ b
                if i == 0:
                    db = db + b.sum(dim=0)
        out.append((dw, db))
    return out


def weight_grads(rows, jobs):
    """The weight cotangents from the per-edge rows ``rows`` (E, width) of
    the backward (``_bwd_jobs``) or the second order (``_bwd2_jobs``): per
    product (dw (pn, qn), db (qn,)) f32.  CUDA tensors run ET's
    ``et_dw_kernel`` (fixed edge splits, their partials summed here once);
    CPU tensors the plain version, split as the kernel would be on an H100."""
    ne, width = rows.shape
    if rows.device.type == "cpu":
        return weight_grads_reference(rows, jobs, _per_split(ne, jobs, _PLAN_SMS))
    _check(rows, "per-edge rows", torch.bfloat16, (ne, width), rows.device)
    npairs = len(_pairs(jobs[0]))
    second = npairs == 2
    products, shapes, at = [], [], 0
    for job in jobs:
        (ao, pn, bo, qn), (ao2, _, bo2, _) = _pairs(job)[0], _pairs(job)[-1]
        products.append((rows[:, ao:ao + pn], rows[:, bo:bo + qn], rows[:, ao2:ao2 + pn] if second else None,
                         rows[:, bo2:bo2 + qn] if second else None, pn, at, at + pn * qn))
        shapes.append((at, pn, qn))
        at += pn * qn + qn
    sms = torch.cuda.get_device_properties(rows.device).multi_processor_count
    part = dw_partials(products, npairs, _per_split(ne, jobs, sms), at)
    weight_grads.launches += 1
    total = part.sum(dim=0)
    return [(total[o:o + pn * qn].reshape(pn, qn), total[o + pn * qn:o + pn * qn + qn]) for o, pn, qn in shapes]


weight_grads.launches = 0


def bwd_reference(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct, *, act, want_rows):
    """Plain version of ``tn_bwd_kernel``, in its arithmetic (rounding points
    and f32 sums; none of the roundings in f64): (d_cat (N, 9H), d_ea (N, K,
    RBF), d_cutm (N, K) in the accumulation dtype, and with ``want_rows``
    the per-edge rows (E, RBFP + 9H) [ea | t1 | d_p1 | t2 | d_p2 | d_p3] the
    weight reduction reads, else None).  d_cat is the gather form: it needs
    a symmetric list with ea and cutm functions of the distance."""
    n, kk = idx.shape
    h = cat.shape[1] // 9
    rbf = ea.shape[-1]
    bf = cat.dtype
    acc = _wide(cat[:1]).dtype
    e = n * kk
    ea2 = ea.reshape(e, rbf)

    def layer(x, w, b):
        pre = torch.matmul(x.to(acc), w.to(acc)).to(bf) + b.reshape(-1)
        return pre, _act_v(act, pre)

    p1, t1 = layer(ea2, w1, b1)
    p2, t2 = layer(t1, w2, b2)
    p3, t3 = layer(t2, w3, b3)
    cmb = cutm.reshape(e, 1).to(bf)
    wb = (t3 * cmb).reshape(n, kk, 3, h)
    comp = [0, 1, 1, 1, 2, 2, 2, 2, 2]
    ctb = ct.to(bf).reshape(-1, 9, h)
    lidx = idx.long()
    # d_cat[i] = sum_k bf16(ct[idx[i, k]] * w[i, k]), the thirds on their components
    dcat = (ctb[lidx] * wb[:, :, comp]).to(acc).sum(dim=1).reshape(n, 9 * h)
    # d_w[third] = bf16(sum over its components of bf16(ct[i] * cat[j]))
    cat_j = cat.reshape(-1, 9, h)[lidx]  # (N, K, 9, H)
    prod = (ctb[:n, None] * cat_j).to(acc)
    dw = torch.stack([prod[:, :, 0], prod[:, :, 1:4].sum(2), prod[:, :, 4:].sum(2)], dim=2).to(bf)
    dw = dw.reshape(e, 3 * h)
    dcutm = (dw * t3).to(acc).sum(dim=1).reshape(n, kk)
    dp3 = _dact(act, p3.to(acc)).to(bf) * (dw * cmb)

    def back(d, w, pre):
        return _dact(act, pre.to(acc)).to(bf) * torch.matmul(d.to(acc), w.to(acc).t()).to(bf)

    dp2 = back(dp3, w3, p2)
    dp1 = back(dp2, w2, p1)
    dea = torch.matmul(dp1.to(acc), w1.to(acc).t()).to(bf).reshape(n, kk, rbf)
    rows = None
    if want_rows:
        pad = torch.zeros((e, _rbfp(rbf) - rbf), dtype=bf)
        rows = torch.cat([ea2, pad, t1, dp1, t2, dp2, dp3], dim=1)
    return dcat, dea, dcutm, rows


def bwd_rows(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct, *, act, want_rows: bool, ext=False):
    """The backward's edge kernel, ``tn_bwd_kernel`` (counted in
    ``run_bwd.launches``); CPU tensors take its plain twin
    (``bwd_reference``).  Returns (d_cat (N, 9H) bf16, d_ea (N, K, RBF)
    bf16, d_cutm (N, K) f32, and with ``want_rows`` the per-edge rows (E,
    RBFP + 9H) bf16 the weight reduction reads, else None).  ``ext``: ``cat``
    and ``ct`` hold the ghost source rows after the N local ones (d_cat
    gathers ct through ``idx``, the receivers' own rows come first)."""
    if cat.device.type == "cpu":
        dcat, dea, dcutm, rows = bwd_reference(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct, act=act,
                                               want_rows=want_rows)
        return dcat, dea, dcutm.to(cutm.dtype), rows
    lib = _lib()
    (n, kk, h, rbf), ops = _prepare(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ext=ext)
    dev = cat.device
    f32 = torch.float32
    _check(ct, "ct", f32, (cat.shape[0], 9 * h), dev)
    dcat = torch.empty((n, 9 * h), dtype=torch.bfloat16, device=dev)
    dea = torch.empty((n, kk, rbf), dtype=torch.bfloat16, device=dev)
    dcutm = torch.empty((n, kk), dtype=f32, device=dev)
    rows = None
    if want_rows:
        rows = torch.empty((n * kk, _rbfp(rbf) + 9 * h), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = lib.tn_bwd(_ptr(idx), n, kk, h, rbf, *[_ptr(t) for t in ops], _ACT_CODE[act], _ptr(ct),
                         _ptr(dcat), _ptr(dea), _ptr(dcutm), _ptr(rows), _stream(dev))
    _raise_on(lib, err, "tn_bwd launch")
    run_bwd.launches += 1
    return dcat, dea, dcutm, rows


def run_bwd(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct, *, act, want_weight_grads: bool, ext=False):
    """The backward: ``tn_bwd_kernel`` (``bwd_rows``) and, when the weight
    cotangents are wanted, the reduction of its per-edge rows
    (``weight_grads``).  CPU tensors take the plain versions.

    Returns (d_cat, d_ea, d_cutm, dw1, db1, dw2, db2, dw3, db3) in the
    operands' dtypes; the weight cotangents are None unless
    ``want_weight_grads``.  ``ext`` as ``bwd_rows``'."""
    rbf = ea.shape[-1]
    h = cat.shape[1] // 9
    dcat, dea, dcutm, rows = bwd_rows(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct, act=act,
                                      want_rows=want_weight_grads, ext=ext)
    wgrads = (None,) * 6
    if want_weight_grads:
        (dw1, db1), (dw2, db2), (dw3, db3) = weight_grads(rows, _bwd_jobs(h, _rbfp(rbf)))
        wgrads = (dw1[:rbf].to(w1.dtype), db1.reshape(b1.shape).to(b1.dtype),
                  dw2.to(w2.dtype), db2.reshape(b2.shape).to(b2.dtype),
                  dw3.to(w3.dtype), db3.reshape(b3.shape).to(b3.dtype))
    return (dcat.to(cat.dtype), dea.to(ea.dtype), dcutm) + wgrads


run_bwd.launches = 0


_COMP = (0, 1, 1, 1, 2, 2, 2, 2, 2)  # the third of w that each of cat's nine components takes


def bwd2_edges_reference(idx, inputs, ct, Z, *, act):
    """Plain version of ``tn_bwd2_kernel``, in the plain forward's arithmetic
    (the values rounded to the operand dtype where ``bwd_reference`` rounds
    them, tangents and cotangents in the accumulation dtype, which the
    kernel rounds at other points): the second order written as a dual
    forward of the edge MLP
    (every value x with its tangent x' driven by Z), S = sum over the edges
    of <d_w, w'> + <z_w, w> with d_w[i, k] and z_w[i, k] the per-third sums
    of ct_i * cat_j and ct_i * Z_cat_j, reversed by autograd.  ``cat``,
    ``ct`` and Z's cat may hold ghost rows after the N receivers (``idx``
    indexes them).  Returns (g_ea (N, K, RBF), g_cutm (N, K), g_ct (N, 9H),
    wdot = w' (N*K, 3H), the per-edge rows (E, 2 RBFP + 18H) of the weight
    reduction), the rows in the operand dtype, the rest in the accumulation
    dtype."""
    cat, ea, cutm, w1, b1, w2, b2, w3, b3 = inputs
    n, kk = idx.shape
    h = cat.shape[1] // 9
    rbf = ea.shape[-1]
    rbfp = _rbfp(rbf)
    bf = cat.dtype
    acc = _wide(cat[:1]).dtype
    e = n * kk
    z = [torch.zeros_like(t) if zt is None else zt for t, zt in zip(inputs, Z)]

    def r(x):
        return x.to(bf).to(acc)

    lidx = idx.long()
    comp = list(_COMP)
    cat_j = r(cat.reshape(-1, 9, h)[lidx].reshape(e, 9, h))
    zcat_j = r(z[0].reshape(-1, 9, h)[lidx].reshape(e, 9, h))
    ct_i = r(ct[:n].reshape(n, 1, 9, h).expand(n, kk, 9, h).reshape(e, 9, h))

    def thirds(x):  # (E, 9, H) -> (E, 3H): the per-third sums over the components
        return torch.cat([x[:, 0], x[:, 1:4].sum(1), x[:, 4:].sum(1)], dim=1)

    d_w = r(thirds(ct_i * cat_j))
    z_w = r(thirds(ct_i * zcat_j))
    with torch.enable_grad():
        ea_l = ea.reshape(e, rbf).to(acc).requires_grad_(True)
        cutm_l = cutm.reshape(e, 1).to(acc).requires_grad_(True)
        zea = z[1].reshape(e, rbf).to(acc)
        x, xt = ea_l, zea
        pres, ins = [], [(ea_l, zea)]
        for (w, b), (zw, zb) in zip(((w1, b1), (w2, b2), (w3, b3)), ((z[3], z[4]), (z[5], z[6]), (z[7], z[8]))):
            w, b, zw, zb = (t.to(acc) for t in (w, b, zw, zb))
            p = r(r(x @ w) + b.reshape(-1))
            pt = xt @ w + x @ zw + zb.reshape(-1)
            f, f1, _ = _act3(act, p)
            x, xt = r(f), f1 * pt
            pres.append((p, pt))
            ins.append((x, xt))
        wv = r(x * cutm_l)
        wt = xt * cutm_l + x * z[2].reshape(e, 1).to(acc)
        s = (d_w * wt).sum() + (z_w * wv).sum()
        leaves = [ea_l, cutm_l] + [t for pair in pres for t in pair]
        grads = torch.autograd.grad(s, leaves)
    wt = wt.detach()
    # g_ct_i = the tangent of m_i = sum_k w' cat_j + w Z_cat_j, each third on its components
    g_ct = (wt.reshape(e, 3, h)[:, comp] * cat_j + wv.detach().reshape(e, 3, h)[:, comp] * zcat_j
            ).reshape(n, kk, 9 * h).sum(1)
    pad = torch.zeros((e, rbfp - rbf), dtype=acc, device=ea.device)
    (t1, t1t), (t2, t2t) = ins[1], ins[2]
    bars = grads[2:]
    rows = torch.cat([ea_l.detach(), pad, zea, pad, t1.detach(), t1t.detach(), bars[0], bars[1], t2.detach(),
                      t2t.detach(), bars[2], bars[3], bars[4], bars[5]], dim=1).to(bf)
    return grads[0].to(bf).reshape(n, kk, rbf), grads[1].reshape(n, kk), g_ct, wt, rows


def src_sum_reference(perm, ct, wdot, n, kk, dtype):
    """Plain version of ``tn_src_sum_kernel``: g_cat[j, c] = the sum over the
    K slots that ``perm`` lists for atom j (slot s = i * K + k: receiver i)
    of ct[i, c] (rounded to ``dtype``) * wdot[s, third(c)], in slot order in
    the accumulation dtype, rounded once to ``dtype``.  ``ct``'s rows are
    the slots' receivers (the ghost receivers after the N local ones under
    partitioning)."""
    pe = perm.long()
    h = ct.shape[1] // 9
    acc = _wide(ct[:1]).dtype
    ct_i = ct.to(dtype).to(acc).reshape(-1, 9, h)[pe // kk]
    wd = wdot.to(acc).reshape(-1, 3, h)[pe][:, list(_COMP)]
    return (ct_i * wd).reshape(n, kk, 9 * h).sum(1).to(dtype)


def bwd2_edges(idx, inputs, ct, Z, *, act, ext=False):
    """The second order's edge kernel, ``tn_bwd2_kernel`` (counted in
    ``run_bwd2.launches``); CPU tensors take its plain twin
    (``bwd2_edges_reference``).

    ``inputs`` are the nine operands, ``ct`` (N, 9H), ``Z`` the nine
    cotangents on ``run_bwd``'s outputs (None means zero).  Returns (g_ea
    (N, K, RBF) bf16, g_cutm (N, K) f32, g_ct (N, 9H) f32, wdot (N*K, 3H)
    f32, the per-edge rows (E, 2 RBFP + 18H) bf16 of the weight
    reduction).  ``ext``: ``cat``, ``ct`` and Z's cat hold the ghost source
    rows after the N local ones.  The kernel's tiles take RBF <= 80 at H =
    128 (any RBF <= 128 below); a wider shape raises."""
    cat, ea, cutm, w1, b1, w2, b2, w3, b3 = inputs
    if cat.device.type == "cpu":
        return bwd2_edges_reference(idx, inputs, ct, Z, act=act)
    lib = _lib()
    (n, kk, h, rbf), ops = _prepare(idx, *inputs, ext=ext)
    dev = cat.device
    f32, bf = torch.float32, torch.bfloat16
    ct = ct.to(f32).contiguous()
    _check(ct, "ct", f32, (cat.shape[0], 9 * h), dev)
    rbfp = _rbfp(rbf)

    def z(i, like, dtype):
        t = Z[i]
        return torch.zeros(like.shape, dtype=dtype, device=dev) if t is None else t.to(dtype).contiguous()

    zw1 = torch.zeros((rbfp, h), dtype=bf, device=dev)
    zw1[:rbf] = z(3, w1, bf)
    zs = [z(0, cat, bf), z(1, ea, bf), z(2, cutm, f32), zw1, z(4, b1, bf).reshape(-1),
          z(5, w2, bf), z(6, b2, bf).reshape(-1), z(7, w3, bf), z(8, b3, bf).reshape(-1)]
    _check(zs[0], "Z of cat", bf, tuple(cat.shape), dev)
    # the kernel copies the Z of W2 and W3 16 bytes at a time, as W2 and W3 (_prepare)
    for i in (5, 7):
        if zs[i].data_ptr() % 16:
            zs[i] = zs[i].clone()
    e = n * kk
    gea = torch.empty((n, kk, rbf), dtype=bf, device=dev)
    gcutm = torch.empty((n, kk), dtype=f32, device=dev)
    gct = torch.empty((n, 9 * h), dtype=f32, device=dev)
    wdot = torch.empty((e, 3 * h), dtype=f32, device=dev)
    rows = torch.empty((e, 2 * rbfp + 18 * h), dtype=bf, device=dev)
    with torch.cuda.device(dev):
        err = lib.tn_bwd2(_ptr(idx), n, kk, h, rbf, *[_ptr(t) for t in ops], _ACT_CODE[act], _ptr(ct),
                          *[_ptr(t) for t in zs], _ptr(gea), _ptr(gcutm), _ptr(gct), _ptr(wdot),
                          _ptr(rows), _stream(dev))
    _raise_on(lib, err, "tn_bwd2 launch")
    run_bwd2.launches += 1
    return gea, gcutm, gct, wdot, rows


def src_sum(perm, ct, wdot, n, kk, dtype=torch.bfloat16):
    """g_cat (N, 9H) in ``dtype`` from ct (rows: the slots' receivers) and
    wdot (a row per slot) through ``perm`` (N*K): ``tn_src_sum_kernel`` for
    CUDA tensors (bf16), its plain twin ``src_sum_reference`` for CPU ones."""
    if ct.device.type == "cpu":
        return src_sum_reference(perm, ct, wdot, n, kk, dtype)
    lib = _lib()
    dev = ct.device
    h = ct.shape[1] // 9
    f32 = torch.float32
    _check(perm, "perm", torch.int32, (n * kk,), dev)
    _check(ct, "ct", f32, (ct.shape[0], 9 * h), dev)
    _check(wdot, "wdot", f32, (ct.shape[0] * kk, 3 * h), dev)
    gcat = torch.empty((n, 9 * h), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = lib.tn_src_sum(_ptr(perm), n, kk, h, _ptr(ct), _ptr(wdot), _ptr(gcat), _stream(dev))
    _raise_on(lib, err, "tn_src_sum launch")
    return gcat


def bwd2_rows(idx, perm, inputs, ct, Z, *, act):
    """The second order's edge kernel (``bwd2_edges``) and the source-row sum
    of its g_cat (``src_sum``): (g_cat (N, 9H), g_ea, g_cutm, g_ct, the
    per-edge rows of the weight reduction), as those return them."""
    n, kk = idx.shape
    gea, gcutm, gct, wdot, rows = bwd2_edges(idx, inputs, ct, Z, act=act)
    if ct.device.type != "cpu":
        ct = ct.to(torch.float32).contiguous()
    return src_sum(perm, ct, wdot, n, kk, inputs[0].dtype), gea, gcutm, gct, rows


def run_bwd2(idx, perm, inputs, ct, Z, *, act):
    """The second order: ``bwd2_rows`` and the reduction of its weight
    gradients (``weight_grads``).  Returns (g_inputs (9, in the inputs'
    dtypes), g_ct (N, 9H) f32)."""
    cat, ea, cutm, w1, b1, w2, b2, w3, b3 = inputs
    rbf, h = ea.shape[-1], cat.shape[1] // 9
    gcat, gea, gcutm, gct, rows = bwd2_rows(idx, perm, inputs, ct, Z, act=act)
    (gw1, gb1), (gw2, gb2), (gw3, gb3) = weight_grads(rows, _bwd2_jobs(h, _rbfp(rbf)))
    g_inputs = (gcat.to(cat.dtype), gea.to(ea.dtype), gcutm,
                gw1[:rbf].to(w1.dtype), gb1.reshape(b1.shape).to(b1.dtype),
                gw2.to(w2.dtype), gb2.reshape(b2.shape).to(b2.dtype),
                gw3.to(w3.dtype), gb3.reshape(b3.shape).to(b3.dtype))
    return g_inputs, gct


run_bwd2.launches = 0


def reset_launch_counts():
    run_fwd.launches = 0
    run_bwd.launches = 0
    run_bwd2.launches = 0
    weight_grads.launches = 0


def kernel_resources(n, kk, h, rbf, kind=1):
    """The resources of ``tn_fwd_kernel`` (kind 0), ``tn_bwd_kernel`` (kind
    1) or ``tn_bwd2_kernel`` (kind 2) at a shape, from the CUDA runtime:
    {registers, spill_bytes (local memory a thread), threads, smem (dynamic
    shared memory a block), blocks_per_sm (resident)}.  Needs a CUDA device; the weight reduction's
    are ET's (``et_message.kernel_resources``)."""
    lib = _lib()
    out = (ctypes.c_int * 5)()
    _raise_on(lib, lib.tn_resources(kind, n, kk, h, rbf, out), "tn_resources")
    return dict(zip(("registers", "spill_bytes", "threads", "smem", "blocks_per_sm"), out))


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
    g_inputs, (g_ct,) = derivatives.second_order(_twin(act, idx, perm), inputs, (ct,), Z)
    return tuple(g_inputs), g_ct


def _twin(act, idx, perm):
    """``tn_messages_reference`` as a function of the nine operands: the
    plain twin every composable derivative rule differentiates (``perm`` a
    ``ShardPlan``: this rank's rows, its gathers through the exchange)."""
    return lambda *a: (tn_messages_reference(idx, *a, act=act, perm=perm),)


def _bwd_outputs(g, want_w):
    """The 9 input gradients of a composable rule as the backward's outputs
    (no weight cotangents unless ``want_w``)."""
    return tuple(g[:3]) + (tuple(g[3:]) if want_w else (None,) * 6)


class _TnMessages(torch.autograd.Function):
    """The fused message phase (#8); its backward is the backward kernel
    (#9), differentiable through ``_TnMessagesBwd`` when grad mode is on
    (``create_graph=True``: a force-loss training step's inner pass) or a
    forward-mode tangent is live.  The tangent is composable: the double vjp
    of the plain twin."""

    @staticmethod
    def forward(ctx, act, idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3):
        ctx.act = act
        ctx.save_for_backward(idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3)
        ctx.save_for_forward(idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3)
        return save_list.fused_output("tn_message_fwd", lambda: run_fwd(
            idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, act=act))

    @staticmethod
    def jvp(ctx, _act, _idx, _perm, *t_inputs):
        idx, perm, *inputs = ctx.saved_tensors
        return derivatives.jvp(_twin(ctx.act, idx, perm), inputs, t_inputs)[0]

    @staticmethod
    def backward(ctx, ct):
        idx, perm, *inputs = ctx.saved_tensors
        # serving freezes the weights: no weight cotangents then
        want_w = any(ctx.needs_input_grad[6:12])
        ct = ct.contiguous()
        if torch.is_grad_enabled() or derivatives.tangent_live(*inputs, ct):
            g = _TnMessagesBwd.apply(ctx.act, want_w, idx, perm, *inputs, ct)
        else:
            g = run_bwd(idx, *inputs, ct, act=ctx.act, want_weight_grads=want_w)
        return (None, None, None) + tuple(g)


class _TnMessagesBwd(torch.autograd.Function):
    """The backward kernel (#9) as a function of (inputs, ct); its gradient
    is the second-order kernel (#10) through ``derivatives.Bwd2``, its
    tangent the composable ``derivatives.vjp_tangent`` of the plain twin.
    Outputs are ``run_bwd``'s nine."""

    @staticmethod
    def forward(ctx, act, want_w, idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct):
        ctx.act, ctx.want_w = act, want_w
        ctx.save_for_backward(idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct)
        ctx.save_for_forward(idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct)
        return run_bwd(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct, act=act,
                       want_weight_grads=want_w)

    @staticmethod
    def jvp(ctx, _act, _want_w, _idx, _perm, *t):
        idx, perm, *rest = ctx.saved_tensors
        g = derivatives.vjp_tangent(_twin(ctx.act, idx, perm), rest[:9], rest[9:], t[:9], t[9:])
        return _bwd_outputs(g, ctx.want_w)

    @staticmethod
    def backward(ctx, *zs):
        idx, perm, *rest = ctx.saved_tensors
        def run(ins, c, z):
            return run_bwd2(idx, perm, ins, c[0], z, act=ctx.act)

        if torch.is_grad_enabled() or derivatives.tangent_live(*rest, *zs):  # a third derivative
            g = derivatives.bwd2_apply(run, _twin(ctx.act, idx, perm), rest[:9], rest[9:], zs)
            return (None, None, None, None, *g)
        return (None, None, None, None, *derivatives.flat(run(rest[:9], rest[9:], list(zs))))


def _shard_bwd(act, plan, cat_ext, inputs, ct, want_w):
    """The backward (#9) on one rank's rows: ct's ghost rows arrive through
    the forward's exchange (the kernel's d_cat is the gather form, ct read at
    each receiver's sources with the receiver's own edge weights), then
    ``tn_bwd_kernel`` on the local receivers over the extended cat and ct.
    d_ea and d_cutm are local; the weight cotangents are this rank's share.
    Returns (``run_bwd``'s nine, the extended ct)."""
    from torchmdnet_tpu_torch.parallel.edge_partition import extend_rows

    (ct_ext,) = extend_rows(plan, [ct], "src")
    return run_bwd(plan.lidx, cat_ext, *inputs[1:], ct_ext, act=act, want_weight_grads=want_w, ext=True), ct_ext


def _shard_bwd2(act, plan, cat_ext, ct_ext, inputs, ct, zs):
    """The second order (#10) on one rank's rows, given the Z cotangents
    ``zs`` on ``_shard_bwd``'s nine outputs: Z on cat reaches the ghost rows
    through the forward's exchange; ``tn_bwd2_kernel`` on the local
    receivers gives g_ea, g_cutm and g_ct whole (g_ct's gather-form term
    reads Z on cat at the sources, as d_cat reads ct) and each slot's w';
    the ghost receivers' ct rows and w' slots are exchanged, and
    ``tn_src_sum_kernel`` sums each local atom's K slots of the global
    transpose permutation into g_cat.  The Z on the weight cotangents must
    be the same on every rank.  Returns the gradients of (inputs (9), ct)."""
    from torchmdnet_tpu_torch.parallel.edge_partition import extend_rows

    cat, ea, cutm, w1, b1, w2, b2, w3, b3 = inputs
    n, kk = plan.lidx.shape
    h, rbf = cat.shape[1] // 9, ea.shape[-1]
    Z = [None if z is None else z.contiguous() for z in zs]
    if Z[0] is None:
        Z[0] = torch.zeros_like(cat)
    (zcat,) = extend_rows(plan, [Z[0]], "src")
    ins_ext = (cat_ext, *inputs[1:])
    gea, gcutm, gct, wdot, rows = bwd2_edges(plan.lidx, ins_ext, ct_ext, [zcat, *Z[1:]], act=act, ext=True)
    ct_l = ct if ct.device.type == "cpu" else ct.to(torch.float32).contiguous()
    ct_rx, wdot_rx = extend_rows(plan, [ct_l, wdot], "rx")
    gcat = src_sum(plan.perm_rx, ct_rx, wdot_rx, n, kk, cat.dtype)
    (gw1, gb1), (gw2, gb2), (gw3, gb3) = weight_grads(rows, _bwd2_jobs(h, _rbfp(rbf)))
    return (gcat.to(cat.dtype), gea.to(ea.dtype), gcutm,
            gw1[:rbf].to(w1.dtype), gb1.reshape(b1.shape).to(b1.dtype),
            gw2.to(w2.dtype), gb2.reshape(b2.shape).to(b2.dtype),
            gw3.to(w3.dtype), gb3.reshape(b3.shape).to(b3.dtype), gct)


class _TnMessagesShard(torch.autograd.Function):
    """The fused message phase on one rank's receiver rows under edge
    partitioning (``plan`` a ``ShardPlan``): the forward (#8) over ``cat``
    extended with the ghost source rows (one exchange of 9H bf16 rows,
    indexed by the plan's local ids), the backward (#9, ``_shard_bwd``),
    differentiable through ``_TnMessagesShardBwd`` (#10, ``_shard_bwd2``);
    the composable rules gather through the exchange.  CPU tensors run the
    kernels' plain twins."""

    @staticmethod
    def forward(ctx, act, plan, cat, ea, cutm, w1, b1, w2, b2, w3, b3):
        from torchmdnet_tpu_torch.parallel.context import ring_scope
        from torchmdnet_tpu_torch.parallel.edge_partition import extend_rows

        (cat_ext,) = extend_rows(plan, [cat], "src")
        ctx.act, ctx.plan = act, plan
        ctx.save_for_backward(cat, ea, cutm, w1, b1, w2, b2, w3, b3, cat_ext)
        ctx.save_for_forward(cat, ea, cutm, w1, b1, w2, b2, w3, b3)

        def launch():
            if cat.device.type == "cpu":
                with ring_scope(None), torch.no_grad():  # local ids into the extended table
                    return tn_messages_reference(plan.lidx, cat_ext, ea, cutm, w1, b1, w2, b2, w3, b3, act=act,
                                                 perm=plan.perm_rx)
            return run_fwd(plan.lidx, cat_ext, ea, cutm, w1, b1, w2, b2, w3, b3, act=act, ext=True)

        return save_list.fused_output("tn_message_fwd", launch)

    @staticmethod
    def jvp(ctx, _act, _plan, *t_inputs):
        return derivatives.jvp(_twin(ctx.act, ctx.plan.lidx, ctx.plan), ctx.saved_tensors, t_inputs)[0]

    @staticmethod
    def backward(ctx, ct):
        *inputs, cat_ext = ctx.saved_tensors
        # serving freezes the weights: no weight cotangents then
        want_w = any(ctx.needs_input_grad[5:11])
        ct = ct.contiguous()
        if torch.is_grad_enabled() or derivatives.tangent_live(*inputs, ct):
            g = _TnMessagesShardBwd.apply(ctx.act, ctx.plan, want_w, cat_ext, *inputs, ct)
        else:
            g = _shard_bwd(ctx.act, ctx.plan, cat_ext, inputs, ct, want_w)[0]
        return (None, None) + tuple(g)


class _TnMessagesShardBwd(torch.autograd.Function):
    """``_shard_bwd`` as a function of this rank's (inputs, ct); its gradient
    is ``_shard_bwd2`` through ``derivatives.Bwd2``.  ``cat_ext`` (the
    forward's extended table) is not an input.  The weight cotangents, their
    tangent and their gradients are this rank's share."""

    @staticmethod
    def forward(ctx, act, plan, want_w, cat_ext, cat, ea, cutm, w1, b1, w2, b2, w3, b3, ct):
        inputs = (cat, ea, cutm, w1, b1, w2, b2, w3, b3)
        grads, ct_ext = _shard_bwd(act, plan, cat_ext, inputs, ct, want_w)
        ctx.act, ctx.plan, ctx.want_w = act, plan, want_w
        ctx.save_for_backward(*inputs, ct, cat_ext, ct_ext)
        ctx.save_for_forward(*inputs, ct)
        return grads

    @staticmethod
    def jvp(ctx, _act, _plan, _want_w, _cat_ext, *t):
        saved = ctx.saved_tensors
        g = derivatives.vjp_tangent(_twin(ctx.act, ctx.plan.lidx, ctx.plan), saved[:9], saved[9:], t[:9], t[9:])
        return _bwd_outputs(g, ctx.want_w)

    @staticmethod
    def backward(ctx, *zs):
        *inputs, ct, cat_ext, ct_ext = ctx.saved_tensors
        if torch.is_grad_enabled() or derivatives.tangent_live(*inputs, ct, *zs):  # a third derivative
            def run(ins, c, z):
                g = _shard_bwd2(ctx.act, ctx.plan, cat_ext, ct_ext, ins, c[0], z)
                return g[:9], g[9:]

            twin = _twin(ctx.act, ctx.plan.lidx, ctx.plan)
            return (None, None, None, None, *derivatives.bwd2_apply(run, twin, inputs, (ct,), zs))
        return (None, None, None, None) + _shard_bwd2(ctx.act, ctx.plan, cat_ext, ct_ext, inputs, ct, zs)


def fused_tn_messages(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, *, act: str = "silu",
                      perm: Optional[torch.Tensor] = None):
    """Fused TensorNet message phase: m (N, 9H) in f32.

    Arguments as ``tn_messages_reference``; on the GPU the message operands
    are bf16.  CUDA tensors run the kernels (or raise); CPU tensors run the
    plain version.  A ``ShardPlan`` as ``perm`` (edge partitioning: this
    rank's receiver rows, global ids in ``idx``) runs ``_TnMessagesShard``.
    """
    if isinstance(perm, ShardPlan):
        if cat.device.type == "cuda" and act not in _ACT_CODE:
            raise ValueError(f"unsupported activation for the fused TensorNet kernel: {act}")
        return _TnMessagesShard.apply(act, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3)
    if cat.device.type == "cpu":
        return tn_messages_reference(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, act=act, perm=perm)
    if cat.device.type != "cuda":
        raise ValueError(f"fused_tn_messages runs on cuda or cpu tensors, not {cat.device}")
    if act not in _ACT_CODE:
        raise ValueError(f"unsupported activation for the fused TensorNet kernel: {act}")
    if perm is None:
        perm = transpose_perm(idx)
    return _TnMessages.apply(act, idx, perm, cat, ea, cutm, w1, b1, w2, b2, w3, b3)
