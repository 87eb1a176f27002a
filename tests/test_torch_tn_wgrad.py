"""The TensorNet backward's weight cotangents through its per-edge rows and
their reduction, on the CPU.

The CUDA backward (#9) writes, when the weights want a gradient, each
edge's layer inputs and pre-activation cotangents as one row [ea | t1 | d_p1
| t2 | d_p2 | d_p3] (``bwd_reference`` is its plain twin), and
``et_dw_kernel`` reduces the rows over fixed edge splits into the six weight
and bias cotangents, the bias sums folded into the same pass
(``weight_grads_reference`` is its plain twin: split partials summed in
order, the last split ragged).  Here, in f64 (no rounding), the twins are
held to autograd of ``tn_messages_reference`` to 1e-10 of each output's
largest value, at H = 32 and 128, K = 33: a wrong column offset or a split
that drops or repeats edges shows as a wrong cotangent.  The second order's
rows (two pairs a product) are held to products of its documented column
blocks.
"""

import numpy as np
import pytest
import torch

from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
from torchmdnet_tpu_torch.ops.kernels import tn_message as tm
from torchmdnet_tpu_torch.ops.neighbors import edge_geometry_components, neighbor_list
from torchmdnet_tpu_torch.ops.rbf import ExpNormalSmearing

N, K, RBF, CUTOFF = 48, 33, 8, 2.6
ORDER = ["cat", "ea", "cutm", "w1", "b1", "w2", "b2", "w3", "b3"]
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, h):
    """f64 operands and ct on a symmetric list of 48 atoms with K = 33 slots
    (ea and cutm from the distances, as the gather form needs), from numpy."""
    rng = np.random.RandomState(seed)
    pos = torch.as_tensor(rng.uniform(0, 5.0, (N, 3)))
    nbl = neighbor_list(pos, k=K - 1, cutoff_upper=CUTOFF, loop=True, strategy="brute")  # + the self slot
    nbl.raise_on_overflow("test")
    assert tuple(nbl.idx.shape) == (N, K)
    _, dist = edge_geometry_components(pos, nbl)
    r = lambda *s: torch.as_tensor(rng.randn(*s))
    ins = dict(
        cat=r(N, 9 * h), ea=ExpNormalSmearing(0.0, CUTOFF, RBF, buffer_dtype=torch.float64)(dist).detach(),
        cutm=cosine_cutoff(dist, 0.0, CUTOFF) * nbl.mask,
        w1=r(RBF, h) * 0.4, b1=r(1, h) * 0.1, w2=r(h, 2 * h) * h ** -0.5, b2=r(1, 2 * h) * 0.1,
        w3=r(2 * h, 3 * h) * (2 * h) ** -0.5, b3=r(1, 3 * h) * 0.1,
    )
    return nbl, ins, r(N, 9 * h)


def _autograd(nbl, ins, ct):
    t = {n: v.clone().requires_grad_(True) for n, v in ins.items()}
    m = tm.tn_messages_reference(nbl.idx, *[t[n] for n in ORDER], perm=nbl.transpose_perm)
    return dict(zip(ORDER, torch.autograd.grad(m, [t[n] for n in ORDER], ct)))


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("h", [32, 128])
def test_backward_rows_reduced_in_ragged_splits_match_autograd(h):
    nbl, ins, ct = _inputs(seed=h, h=h)
    want = _autograd(nbl, ins, ct)
    rbfp = tm._rbfp(RBF)
    dcat, dea, dcutm, rows = tm.bwd_reference(nbl.idx, *[ins[n] for n in ORDER], ct, act="silu", want_rows=True)
    assert tuple(rows.shape) == (N * K, rbfp + 9 * h)
    assert bool((rows[:, RBF:rbfp] == 0).all())  # the RBF padding columns
    for name, got in (("cat", dcat), ("ea", dea), ("cutm", dcutm)):
        assert _rel(got, want[name]) < TOL, name
    jobs = tm._bwd_jobs(h, rbfp)
    # a split the kernel would take on an H100, and one of five tiles: both ragged
    for per_split in (tm._per_split(N * K, jobs, tm._PLAN_SMS), 5 * 64):
        assert (N * K) % per_split != 0
        (dw1, db1), (dw2, db2), (dw3, db3) = tm.weight_grads_reference(rows, jobs, per_split)
        got = dict(w1=dw1[:RBF], b1=db1.reshape(1, -1), w2=dw2, b2=db2.reshape(1, -1), w3=dw3,
                   b3=db3.reshape(1, -1))
        for name, g in got.items():
            assert g.shape == want[name].shape, name
            assert _rel(g, want[name]) < TOL, (name, per_split)
    # run_bwd's CPU path: the same twins, the nine cotangents in the operands' dtypes
    out = tm.run_bwd(nbl.idx, *[ins[n] for n in ORDER], ct, act="silu", want_weight_grads=True)
    for name, g in zip(ORDER, out):
        assert g.dtype == ins[name].dtype and _rel(g, want[name]) < TOL, name
    frozen = tm.run_bwd(nbl.idx, *[ins[n] for n in ORDER], ct, act="silu", want_weight_grads=False)
    assert all(x is None for x in frozen[3:])
    assert all(torch.equal(a, b) for a, b in zip(frozen[:3], out[:3]))


@pytest.mark.parametrize("h", [32, 128])
def test_second_order_rows_reduce_by_their_column_blocks(h):
    """The second order's rows [ea | z_ea | t1 | t1' | p1_bar | p1'_bar | t2 |
    t2' | p2_bar | p2'_bar | p3_bar | p3'_bar]: each weight gradient is
    value^T bar + tangent^T bar', each bias the column sum of its bar."""
    rbfp = tm._rbfp(RBF)
    widths = dict(ea=rbfp, zea=rbfp, t1=h, td1=h, p1=h, pd1=h, t2=2 * h, td2=2 * h, p2=2 * h, pd2=2 * h,
                  p3=3 * h, pd3=3 * h)
    rng = np.random.RandomState(7)
    rows = torch.as_tensor(rng.randn(N * K, sum(widths.values())))
    cols, at = {}, 0
    for name, w in widths.items():
        cols[name] = rows[:, at:at + w]
        at += w
    got = tm.weight_grads_reference(rows, tm._bwd2_jobs(h, rbfp), 3 * 64)
    for (dw, db), (a, b, ad, bd) in zip(got, (("ea", "p1", "zea", "pd1"), ("t1", "p2", "td1", "pd2"),
                                              ("t2", "p3", "td2", "pd3"))):
        want_w = cols[a].t() @ cols[b] + cols[ad].t() @ cols[bd]
        assert _rel(dw, want_w) < TOL and _rel(db, cols[b].sum(0)) < TOL, a
