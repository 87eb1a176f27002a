"""The gather form of the port's fused ET backward and second order, on the CPU.

The CUDA backward (#2) and second order (#3) run as a receiver pass, which
leaves per edge and head only the scalars the source side needs, a source
pass, which sums each atom's K slots of the transpose permutation in
gather form, and a reduction of the per-edge filter cotangents into the
weight cotangents.  Their plain versions (``bwd_receiver_reference``,
``bwd_source_reference``, ``bwd2_receiver_reference``,
``bwd2_source_reference``, ``weight_grads_reference``) are what ``run_bwd``
and ``run_bwd2`` compute for CPU tensors, and the yardsticks of the kernels
on the card.  Here they are held:

- in f64 (where no rounding happens) against autograd of
  ``et_messages_reference``: every source-row and weight cotangent (and all
  the others) to 1e-10 of each output's largest value, with both filters,
  one, or none, and in a periodic box;
- in bf16 against the per-edge buffer form they replace (each edge's
  source-row values, summed onto the atoms by ``_transpose_sum``): within
  one bf16 ulp (torch's CPU sum may add the K slots in another order), with
  the count of elements that differ printed.
"""

import numpy as np
import pytest
import torch

from torchmdnet_tpu_torch.ops.kernels import et_message as em
from torchmdnet_tpu_torch.ops.neighbors import (
    _transpose_sum,
    edge_geometry_components,
    neighbor_list,
    transpose_perm,
)

N, H, HEADS, RBF = 48, 32, 4, 8
ORDER = ["q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk",
         "dir0", "dir1", "dir2", "wdk", "bdk", "wdv", "bdv"]
FILTERS = {"both": (), "keys": ("wdv", "bdv"), "values": ("wdk", "bdk"),
           "none": ("wdk", "bdk", "wdv", "bdv")}
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, periodic, dtype):
    """Operands, cotangents and Zs on a symmetric list of 48 atoms (a
    periodic 5 A box, or a free cluster), made with numpy."""
    rng = np.random.RandomState(seed)
    side = 5.0
    pos = torch.as_tensor(rng.uniform(0, side, (N, 3)))
    box = torch.eye(3, dtype=torch.float64) * side if periodic else None
    nbl = neighbor_list(pos.float(), k=N, cutoff_upper=2.2, loop=True, strategy="brute",
                        box=None if box is None else box.float())
    nbl.raise_on_overflow("test")
    idx = nbl.idx
    kk = idx.shape[1]
    (dx, dy, dz), dist = edge_geometry_components(pos, nbl, box)
    inv = (dist > 0).double() / torch.where(dist > 0, dist, torch.ones_like(dist))
    mask = nbl.mask.double()
    r = lambda *s: torch.as_tensor(rng.randn(*s))
    ins = dict(
        q=r(N, H), k=r(N, H), v=r(N, 3 * H), vec0=r(N, H), vec1=r(N, H), vec2=r(N, H),
        ea=r(N, kk, RBF) * 0.3, cutm=0.5 * (torch.cos(dist * np.pi / 2.2) + 1) * mask, msk=mask,
        dir0=dx * inv, dir1=dy * inv, dir2=dz * inv,
        wdk=r(RBF, H) * 0.3, bdk=r(1, H) * 0.1, wdv=r(RBF, 3 * H) * 0.3, bdv=r(1, 3 * H) * 0.1,
    )
    low = {"cutm", "msk", "dir0", "dir1", "dir2"}
    ins = {n: a.to(torch.float32 if (n in low and dtype == torch.bfloat16) else dtype) for n, a in ins.items()}
    wide = torch.float32 if dtype == torch.bfloat16 else dtype
    cts = (r(N, H).to(wide), r(N, 3 * H).to(wide))
    zs = {n: (r(*a.shape) * 0.5).to(a.dtype) for n, a in ins.items()}
    return idx, transpose_perm(idx), ins, cts, zs


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("influence,periodic", [("both", False), ("none", False), ("both", True), ("keys", True)])
def test_bwd_gather_form_matches_autograd_f64(influence, periodic):
    """run_bwd on the CPU (the receiver pass's, the source pass's and the
    weight reduction's plain versions) against autograd."""
    idx, perm, ins, cts, _ = _inputs(1, periodic, torch.float64)
    absent = FILTERS[influence]
    t = {n: None if n in absent else a.clone().requires_grad_(n != "msk") for n, a in ins.items()}
    x, vec = em.et_messages_reference(idx, *[t[n] for n in ORDER], heads=HEADS, perm=perm)
    live = [n for n in ORDER if n != "msk" and t[n] is not None]
    want = dict(zip(live, torch.autograd.grad((x, vec), [t[n] for n in live], cts, allow_unused=True)))
    a = [None if n in absent else ins[n] for n in ORDER]
    em.reset_launch_counts()
    got = em.run_bwd(idx, perm, *a[:9], tuple(a[9:12]), *a[12:], *cts, heads=HEADS, act="silu",
                     attn_act="silu", want_weight_grads=True)
    assert (em.run_bwd.launches, em.bwd_source.launches, em.weight_grads.launches) == (0, 0, 0)
    names = [n for n in ORDER if n != "msk"]
    for name, g in zip(names, got):
        if name in absent:
            assert g is None
            continue
        w = want[name] if want[name] is not None else torch.zeros_like(g)  # ea without filters
        assert g.dtype == torch.float64 and _rel(g, w) < TOL, (name, _rel(g, w))


def _ulp_check(got, want, label):
    """|got - want| within one bf16 ulp of |want| elementwise; prints how many differ."""
    got, want = got.double(), want.double()
    mag = want.abs()
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag)))) - 7)
    diff = (got - want).abs()
    print(f"{label}: {int((diff > 0).sum())} of {want.numel()} elements differ")
    assert bool((diff <= torch.where(mag > 0, ulp, torch.zeros_like(ulp))).all()), label


@pytest.mark.parametrize("influence,periodic", [("both", False), ("values", True)])
def test_bwd_gather_form_within_an_ulp_of_transpose_sum_bf16(influence, periodic):
    idx, perm, ins, cts, _ = _inputs(2, periodic, torch.bfloat16)
    absent = FILTERS[influence]
    a = {n: None if n in absent else v for n, v in ins.items()}
    dirs = (a["dir0"], a["dir1"], a["dir2"])
    w = [a[n] for n in ("wdk", "bdk", "wdv", "bdv")]
    ops = [a[n] for n in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk")]
    recv = em.bwd_receiver_reference(idx, *ops, dirs, *w, *cts, heads=HEADS, act="silu", attn_act="silu",
                                     want_dpre=False)
    hs = recv[4]
    gather = em.bwd_source_reference(idx, perm, *ops[:7], a["msk"], dirs, *w, *cts, hs, heads=HEADS, act="silu")
    # the buffer form: every edge's source-row values, then the transpose-sum
    x = em._Edges(idx, torch.arange(idx.numel()), idx.reshape(-1).long(), a["q"], a["ea"], a["msk"], dirs, HEADS)
    terms = em._bwd_source_terms(x, a["q"], a["k"], a["v"], a["vec0"], a["vec1"], a["vec2"], *cts, hs,
                                 x.filters(*w, "silu"))
    assert torch.equal(terms.to(torch.bfloat16).to(terms.dtype), terms)  # bf16 values
    buffer = em._split_rows(_transpose_sum(terms.to(torch.bfloat16).reshape(*idx.shape, -1), idx, perm), H)
    for name, g, b in zip(("k", "v", "vec0", "vec1", "vec2"), gather, buffer):
        assert g.dtype == torch.bfloat16
        _ulp_check(g, b, f"#2 source cotangent of {name}")


@pytest.mark.parametrize("influence,periodic", [("both", False), ("values", False), ("none", True),
                                                ("both", True)])
def test_bwd2_gather_form_matches_autograd_f64(influence, periodic):
    """run_bwd2 on the CPU (its passes' plain versions) against autograd's
    double backward of the plain forward."""
    idx, perm, ins, cts, zs = _inputs(3, periodic, torch.float64)
    absent = FILTERS[influence]
    inputs = [None if n in absent else ins[n] for n in ORDER]
    Z = [None if (n in absent or n == "msk") else zs[n] for n in ORDER]
    em.reset_launch_counts()
    got_in, got_ct = em.run_bwd2(idx, perm, inputs, cts, Z, heads=HEADS, act="silu", attn_act="silu")
    assert (em.run_bwd2.launches, em.bwd2_source.launches, em.weight_grads.launches) == (0, 0, 0)
    want_in, want_ct = em.et_messages_bwd2_reference(idx, perm, inputs, cts, Z, heads=HEADS,
                                                      act="silu", attn_act="silu")
    for name, g, w in zip(ORDER + ["ct_x", "ct_vec"], list(got_in) + list(got_ct), list(want_in) + list(want_ct)):
        if name in absent:
            assert g is None and w is None
            continue
        assert _rel(g, w) < TOL, (name, _rel(g, w))


@pytest.mark.parametrize("influence,periodic", [("both", True), ("keys", False)])
def test_bwd2_gather_form_within_an_ulp_of_transpose_sum_bf16(influence, periodic):
    idx, perm, ins, cts, zs = _inputs(4, periodic, torch.bfloat16)
    absent = FILTERS[influence]
    inputs = [None if n in absent else ins[n] for n in ORDER]
    Z = [None if (n in absent or n == "msk") else zs[n] for n in ORDER]
    recv = em.bwd2_receiver_reference(idx, inputs, cts, Z, heads=HEADS, act="silu", attn_act="silu")
    hs4 = recv[7]
    gather = em.bwd2_source_reference(idx, perm, inputs, cts, Z, hs4, heads=HEADS, act="silu")
    x = em._Edges(idx, torch.arange(idx.numel()), idx.reshape(-1).long(), inputs[0], inputs[6], inputs[8],
                  inputs[9:12], HEADS)
    z = [em._zero_if_none(Z[i], inputs[i]) for i in range(12)]
    terms = em._bwd2_source_terms(x, em._Dual(x, z[6], inputs, Z, "silu"), inputs, cts, z, hs4)
    # the first port's buffer form: f32 per-edge values, summed in f32 and rounded once
    buffer = em._split_rows(_transpose_sum(terms.reshape(*idx.shape, -1), idx, perm).to(torch.bfloat16), H)
    for name, g, b in zip(("k", "v", "vec0", "vec1", "vec2"), gather, buffer):
        assert g.dtype == torch.bfloat16
        _ulp_check(g, b, f"#3 source gradient of {name}")
