"""The gather form of the port's fused Transformer backward and second order,
on the CPU.

The CUDA backward (#12) and second order (#13) run as a receiver pass, which
leaves per edge and head only the scalars the source side needs, a source
pass, which sums each atom's K slots of the transpose permutation in
gather form, and a reduction of the per-edge filter cotangents into the
weight cotangents (ET's ``weight_grads``).  Their plain versions
(``bwd_receiver_reference``, ``bwd_source_reference``,
``bwd2_receiver_reference``, ``bwd2_source_reference``,
``em.weight_grads_reference``) are what ``run_bwd`` and ``run_bwd2`` compute
for CPU tensors, and the yardsticks of the kernels on the card.  Here they
are held:

- in f64 (where no rounding happens) against autograd of
  ``t_messages_reference`` (#12) and against ``t_messages_bwd2_reference``
  (#13): every output to 1e-10 of its largest value, for the four distance
  influences and in a periodic box;
- in bf16 against the per-edge buffer form they replace (each edge's
  source-row values, summed onto the atoms by ``_transpose_sum``): within
  one bf16 ulp (torch's CPU sum may add the K slots in another order), with
  the count of elements that differ printed, and bitwise against the same
  values summed in slot order (the buffer form's transpose-sum order).
"""

import numpy as np
import pytest
import torch

from torchmdnet_tpu_torch.ops.kernels import t_message as tm
from torchmdnet_tpu_torch.ops.neighbors import (
    _transpose_sum,
    edge_geometry_components,
    neighbor_list,
    transpose_perm,
)

N, H, HEADS, RBF = 48, 32, 4, 8
ORDER = ["q", "k", "v", "ea", "cutm", "wdk", "bdk", "wdv", "bdv"]
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
    """Operands, cotangent and Zs on a symmetric list of 48 atoms (a periodic
    5 A box, or a free cluster), made with numpy."""
    rng = np.random.RandomState(seed)
    side = 5.0
    pos = torch.as_tensor(rng.uniform(0, side, (N, 3)))
    box = torch.eye(3, dtype=torch.float64) * side if periodic else None
    nbl = neighbor_list(pos.float(), k=N, cutoff_upper=2.2, loop=True, strategy="brute",
                        box=None if box is None else box.float())
    nbl.raise_on_overflow("test")
    idx = nbl.idx
    kk = idx.shape[1]
    _, dist = edge_geometry_components(pos, nbl, box)
    r = lambda *s: torch.as_tensor(rng.randn(*s))
    ins = dict(
        q=r(N, H), k=r(N, H), v=r(N, H), ea=r(N, kk, RBF) * 0.3,
        cutm=0.5 * (torch.cos(dist * np.pi / 2.2) + 1) * nbl.mask.double(),
        wdk=r(RBF, H) * 0.3, bdk=r(1, H) * 0.1, wdv=r(RBF, H) * 0.3, bdv=r(1, H) * 0.1,
    )
    ins = {n: a.to(torch.float32 if (n == "cutm" and dtype == torch.bfloat16) else dtype) for n, a in ins.items()}
    ct = r(N, H).to(torch.float32 if dtype == torch.bfloat16 else dtype)
    zs = {n: (r(*a.shape) * 0.5).to(a.dtype) for n, a in ins.items()}
    return idx, transpose_perm(idx), ins, ct, zs


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("influence,periodic", [("both", False), ("keys", False), ("values", True),
                                                ("none", False), ("both", True)])
def test_bwd_gather_form_matches_autograd_f64(influence, periodic):
    """run_bwd on the CPU (the receiver pass's, the source pass's and the
    weight reduction's plain versions) against autograd."""
    idx, perm, ins, ct, _ = _inputs(1, periodic, torch.float64)
    absent = FILTERS[influence]
    t = {n: None if n in absent else a.clone().requires_grad_(True) for n, a in ins.items()}
    out = tm.t_messages_reference(idx, *[t[n] for n in ORDER], heads=HEADS, perm=perm)
    live = [n for n in ORDER if t[n] is not None]
    want = dict(zip(live, torch.autograd.grad(out, [t[n] for n in live], ct, allow_unused=True)))
    tm.reset_launch_counts()
    got = tm.run_bwd(idx, perm, *[None if n in absent else ins[n] for n in ORDER], ct, heads=HEADS,
                     act="silu", attn_act="silu", want_weight_grads=True)
    assert (tm.run_bwd.launches, tm.bwd_source.launches) == (0, 0)
    for name, g in zip(ORDER, got):
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


@pytest.mark.parametrize("influence,periodic", [("both", False), ("values", True), ("keys", True)])
def test_bwd_gather_form_equals_the_buffer_form_bf16(influence, periodic):
    idx, perm, ins, ct, _ = _inputs(2, periodic, torch.bfloat16)
    absent = FILTERS[influence]
    a = {n: None if n in absent else v for n, v in ins.items()}
    w = [a[n] for n in ("wdk", "bdk", "wdv", "bdv")]
    recv = tm.bwd_receiver_reference(idx, *[a[n] for n in ORDER[:5]], *w, ct, heads=HEADS, act="silu",
                                     attn_act="silu", want_dpre=False)
    hs = recv[3]
    gather = tm.bwd_source_reference(idx, perm, a["q"], a["ea"], *w, ct, hs, heads=HEADS, act="silu")
    # the buffer form: every edge's source-row values, then the transpose-sum
    x = tm._all_edges(idx, a["q"], a["ea"], HEADS)
    terms = tm._bwd_source_terms(x, a["q"], ct, hs, x.filters(*w, "silu"))
    assert torch.equal(terms.to(torch.bfloat16).to(terms.dtype), terms)  # bf16 values
    edge = terms.to(torch.bfloat16).reshape(*idx.shape, -1)
    buffer = tm._split_kv(_transpose_sum(edge, idx, perm), H)
    ordered = edge.reshape(-1, 2 * H)[perm.long()].float()
    slot_order = tm._split_kv(tm._slot_sum(ordered, *idx.shape).to(torch.bfloat16), H)
    for name, g, b, s in zip(("k", "v"), gather, buffer, slot_order):
        assert g.dtype == torch.bfloat16
        _ulp_check(g, b, f"#12 source cotangent of {name}")
        assert torch.equal(g, s), f"#12 source cotangent of {name} against the slot-order sum"


@pytest.mark.parametrize("influence,periodic", [("both", False), ("keys", False), ("values", True),
                                                ("none", True), ("both", True)])
def test_bwd2_gather_form_matches_reference_f64(influence, periodic):
    """run_bwd2 on the CPU (its passes' plain versions) against autograd's
    double backward of the plain forward."""
    idx, perm, ins, ct, zs = _inputs(3, periodic, torch.float64)
    absent = FILTERS[influence]
    inputs = [None if n in absent else ins[n] for n in ORDER]
    Z = [None if n in absent else zs[n] for n in ORDER]
    tm.reset_launch_counts()
    got_in, got_ct = tm.run_bwd2(idx, perm, inputs, ct, Z, heads=HEADS, act="silu", attn_act="silu")
    assert (tm.run_bwd2.launches, tm.bwd2_source.launches) == (0, 0)
    want_in, want_ct = tm.t_messages_bwd2_reference(idx, perm, inputs, ct, Z, heads=HEADS, act="silu",
                                                    attn_act="silu")
    for name, g, w in zip(ORDER + ["ct"], list(got_in) + [got_ct], list(want_in) + [want_ct]):
        if name in absent:
            assert g is None and w is None
            continue
        assert g.dtype == torch.float64 and _rel(g, w) < TOL, (name, _rel(g, w))


@pytest.mark.parametrize("influence,periodic", [("both", True), ("keys", False)])
def test_bwd2_gather_form_within_an_ulp_of_transpose_sum_bf16(influence, periodic):
    idx, perm, ins, ct, zs = _inputs(4, periodic, torch.bfloat16)
    absent = FILTERS[influence]
    inputs = [None if n in absent else ins[n] for n in ORDER]
    Z = [None if n in absent else zs[n] for n in ORDER]
    hs4 = tm.bwd2_receiver_reference(idx, inputs, ct, Z, heads=HEADS, act="silu", attn_act="silu")[4]
    gather = tm.bwd2_source_reference(idx, perm, inputs, ct, Z, hs4, heads=HEADS, act="silu")
    x = tm._all_edges(idx, inputs[0], inputs[3], HEADS)
    z = [tm.em._zero_if_none(Z[i], inputs[i]) for i in range(5)]
    terms = tm._bwd2_source_terms(x, tm._Dual(x, z[3], inputs, Z, "silu"), inputs[0], ct, z, hs4)
    # the first port's buffer form: f32 per-edge values, summed in f32 and rounded once
    buffer = tm._split_kv(_transpose_sum(terms.reshape(*idx.shape, -1), idx, perm).to(torch.bfloat16), H)
    for name, g, b in zip(("k", "v"), gather, buffer):
        assert g.dtype == torch.bfloat16
        _ulp_check(g, b, f"#13 source gradient of {name}")
