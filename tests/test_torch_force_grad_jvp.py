"""The force loss's gradient in forward mode (``force_grad_mode="jvp"``) and
the forward-mode rules of the port's autograd Functions, on the CPU.

- One ``Trainer`` step's gradients with ``force_grad_mode="jvp"`` (the JAX
  trainer's three passes: the forces without a graph, the energy loss by one
  reverse pass, the energy's parameter gradient with ``pos`` a dual tensor
  along the force loss's gradient) against the same step by grad-of-grad,
  from the same weights and batch: the four models' composable paths in f64
  to 1e-9 of each tensor's largest value (measured: 1.2e-15 at most).
- The fused ET, Transformer and TensorNet Functions, with every kernel
  launch replaced by a plain twin that takes and returns tensors WITHOUT
  tangents, as a kernel does (a CUDA launch writes fresh tensors): a
  backward that dropped a live tangent (the bare backward launch of a
  Function's no-grad branch) loses it here as on the card.  In f64 the
  Functions' forward-over-reverse gradient equals their grad-of-grad to
  1e-10 (measured: 5e-16), with one forward, one backward and no
  second-order launch against grad-of-grad's (1, 2, 1).  Through the
  fused models, a jvp step against a gradgrad step with (3L, 3L, 0)
  launches for L layers: at their bf16 messages within JVP_BF16_TOL (bf16
  noise: a backward whose tangent was zeroed moved ET's gap only from
  5.8e-3 to 1.6e-2), and with the models' message dtypes read as f64
  (``f64_messages``) to 1e-9, where such a fault shows.
- The second order's tangent (forward mode over grad-of-grad: the
  ``jvp`` of ``derivatives.Bwd2``) through each family's Functions against
  the plain twin's, f64 to 1e-10.
- The CLI with ``--force-grad-mode jvp`` trains, and its first epoch's
  losses equal a gradgrad run's.
"""

import csv
import os

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from torchmdnet_tpu_torch import create_model
from torchmdnet_tpu_torch.data.batch import pad_molecules, spatial_sort
from torchmdnet_tpu_torch.data.datasets import SyntheticMorse
from torchmdnet_tpu_torch.ops.cutoff import cosine_cutoff
from torchmdnet_tpu_torch.ops.kernels import et_message as em
from torchmdnet_tpu_torch.ops.kernels import t_message as tmk
from torchmdnet_tpu_torch.ops.kernels import tn_message as tnm
from torchmdnet_tpu_torch.ops.neighbors import neighbor_list, transpose_perm
from torchmdnet_tpu_torch.ops.rbf import ExpNormalSmearing
from torchmdnet_tpu_torch.train.trainer import Trainer

BASE = dict(activation="silu", atom_filter=-1, cutoff_lower=0.0, cutoff_upper=5.0, derivative=True,
            embedding_dimension=16, max_num_neighbors=16, max_z=100, neighbor_embedding=True, num_heads=4,
            num_layers=2, num_rbf=8, output_model="Scalar", precision=64, prior_model=None, rbf_type="expnorm",
            reduce_op="sum", trainable_rbf=False, attn_activation="silu", distance_influence="both", aggr="add",
            equivariance_invariance_group="O(3)")
HPARAMS = dict(lr=1e-3, ema_alpha_y=0.7, ema_alpha_neg_dy=0.8, y_weight=1.0, neg_dy_weight=0.5)
MODELS = ["graph-network", "transformer", "equivariant-transformer", "tensornet"]
FUSED = {"et": dict(model="equivariant-transformer", fused_attention=True),
         "t": dict(model="transformer", fused_attention=True),
         "tn": dict(model="tensornet", fused_message=True)}
KERNEL_MODULES = {"et": em, "t": tmk, "tn": tnm}
# The fused models' jvp step against their gradgrad step, both through the
# Functions with bf16 messages: the two modes round the bf16 operands'
# cotangents and tangents at different points (measured at most 5.8e-3 of a
# tensor's largest value, 8.4e-3 for the bf16 copies of the distance filters
# and TensorNet's edge MLP, whose cotangents are rounded to bf16).
JVP_BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run fastest on one thread, and the suite often runs several
    test workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(fdt):
    ds = SyntheticMorse(num_samples=3, num_atoms=8, seed=0)
    return pad_molecules([ds[i] for i in range(3)], num_atoms=24, num_mol=3, float_dtype=fdt)


def _step_grads(args, mode, batch, log_dir, seed=1):
    """One step's gradients ({name: tensor}) and losses of a fresh model."""
    h = dict(args, **HPARAMS, force_grad_mode=mode, log_dir=str(log_dir))
    tr = Trainer(create_model(args, device="cpu", seed=seed), h)
    ema = torch.tensor(0.25, dtype=tr.dtype)
    total, loss_y, loss_f, _ = tr.step_gradients(tr._prepare_batch(batch), ema, ema)
    losses = [float(v.detach()) for v in (total, loss_y, loss_f)]
    return {n: p.grad.clone() for n, p in zip(tr.param_names, tr.params)}, losses


def _gap(got, want, keys=None):
    assert got.keys() == want.keys()
    return max(float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30)
               for k in (keys or want))


@pytest.mark.parametrize("model,remat", [pytest.param(m, False, id=m) for m in MODELS]
                         + [pytest.param("equivariant-transformer", True, id="equivariant-transformer-remat")])
def test_jvp_step_matches_gradgrad_composable(model, remat, tmp_path):
    """(with ``remat``, the layers recomputed in the backward: the
    non-reentrant checkpoint carries the tangents)"""
    args = dict(BASE, model=model, max_z=128 if model == "tensornet" else 100, remat=remat)
    batch = _batch(np.float64)
    g_jvp, l_jvp = _step_grads(args, "jvp", batch, tmp_path)
    g_gg, l_gg = _step_grads(args, "gradgrad", batch, tmp_path)
    gap = _gap(g_jvp, g_gg)
    print(f"{model} (remat {remat}): jvp against gradgrad, largest gradient gap {gap:.3e}")
    assert gap <= 1e-9 and len(g_gg) > 10
    np.testing.assert_allclose(l_jvp, l_gg, rtol=1e-12)


# --- the Functions, their kernel launches replaced by tangent-free twins ----


def _strip(x):
    """``x`` (a tensor, or a list or tuple of them) without forward-mode
    tangents, as a kernel's operands and outputs are."""
    if isinstance(x, (list, tuple)):
        return type(x)(_strip(t) for t in x)
    return fwAD.unpack_dual(x).primal if torch.is_tensor(x) else x


def _tangent_free(fn, counts, key):
    def launch(*a, **kw):
        counts[key] += 1
        with torch.no_grad():
            return _strip(fn(*_strip(a), **{k: _strip(v) for k, v in kw.items()}))

    return launch


def _et_fwd(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, *, heads, act, attn_act):
    return em.et_messages_reference(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, *dirs, wdk, bdk, wdv, bdv,
                                    heads=heads, act=act, attn_act=attn_act, perm=idx)


def _t_fwd(idx, *inputs, heads, act, attn_act):
    return tmk.t_messages_reference(idx, *inputs, heads=heads, act=act, attn_act=attn_act, perm=idx)


def _tn_fwd(idx, *inputs, act):
    return tnm.tn_messages_reference(idx, *inputs, act=act, perm=idx)


PLAIN_FWD = {"et": _et_fwd, "t": _t_fwd, "tn": _tn_fwd}


def tangent_free_kernels(monkeypatch, family):
    """Replace the family's three launches (forward, backward, second order)
    by plain twins that strip tangents and count; returns the counts."""
    km = KERNEL_MODULES[family]
    counts = dict.fromkeys(("fwd", "bwd", "bwd2"), 0)
    monkeypatch.setattr(km, "run_fwd", _tangent_free(PLAIN_FWD[family], counts, "fwd"))
    monkeypatch.setattr(km, "run_bwd", _tangent_free(km.run_bwd, counts, "bwd"))
    monkeypatch.setattr(km, "run_bwd2", _tangent_free(km.run_bwd2, counts, "bwd2"))
    return counts


def route_models_through_functions(monkeypatch):
    """The models' fused calls through the Functions (on CPU tensors they
    would run the plain version directly)."""
    import torchmdnet_tpu_torch.models.et as et_model
    import torchmdnet_tpu_torch.models.transformer as t_model

    def perm_of(idx, perm):
        return transpose_perm(idx) if perm is None else perm

    monkeypatch.setattr(et_model, "fused_et_messages", lambda idx, *a, heads, act="silu", attn_act="silu", perm=None:
                        em._EtMessages.apply((heads, act, attn_act), idx, perm_of(idx, perm), *a))
    monkeypatch.setattr(t_model, "fused_t_messages", lambda idx, *a, heads, act="silu", attn_act="silu", perm=None:
                        tmk._TMessages.apply((heads, act, attn_act), idx, perm_of(idx, perm), *a))
    monkeypatch.setattr(tnm, "fused_tn_messages", lambda idx, *a, act="silu", perm=None:
                        tnm._TnMessages.apply(act, idx, perm_of(idx, perm), *a))


def _phase_inputs(family, seed, n=24, h=16, rbf=8):
    """f64 operands of one fused phase on a symmetric brute list of ``n``
    atoms: {name: tensor}, the list and its permutation.  The per-edge
    operands are functions of the pair's distance, the same both ways of an
    edge, as a model's are: TensorNet's backward kernel (and its twin) reads
    a source row's cotangent with the receiver's own edge weights."""
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(0, 6.0, (n, 3)))
    nbl = neighbor_list(pos, torch.zeros(n, dtype=torch.long), torch.ones(n, dtype=torch.bool), k=16,
                        cutoff_upper=2.5, loop=True, strategy="brute")
    idx, mask = nbl.idx, nbl.mask
    delta = pos[idx.long()] - pos[:, None, :]
    dist = torch.where(mask, delta.norm(dim=-1), torch.zeros(()))
    inv = torch.where(dist > 0, 1.0 / dist.clamp_min(1e-9), torch.zeros(()))
    r = lambda *s, scale=1.0: torch.as_tensor(rng.normal(size=s) * scale)
    cutm = cosine_cutoff(dist, 0.0, 2.5) * mask
    ea = ExpNormalSmearing(0.0, 2.5, rbf, trainable=False, buffer_dtype=torch.float64)(dist) * mask[..., None]
    if family == "et":
        ins = dict(q=r(n, h), k=r(n, h), v=r(n, 3 * h), vec0=r(n, h), vec1=r(n, h), vec2=r(n, h),
                   ea=ea, cutm=cutm, msk=mask.double(), dir0=delta[..., 0] * inv,
                   dir1=delta[..., 1] * inv, dir2=delta[..., 2] * inv, wdk=r(rbf, h, scale=0.3),
                   bdk=r(1, h, scale=0.1), wdv=r(rbf, 3 * h, scale=0.3), bdv=r(1, 3 * h, scale=0.1))
    elif family == "t":
        ins = dict(q=r(n, h), k=r(n, h), v=r(n, h), ea=ea, cutm=cutm,
                   wdk=r(rbf, h, scale=0.3), bdk=r(1, h, scale=0.1), wdv=r(rbf, h, scale=0.3),
                   bdv=r(1, h, scale=0.1))
    else:
        ins = dict(cat=r(n, 9 * h), ea=ea, cutm=cutm, w1=r(rbf, h, scale=0.2),
                   b1=r(1, h, scale=0.1), w2=r(h, 2 * h, scale=0.08), b2=r(1, 2 * h, scale=0.1),
                   w3=r(2 * h, 3 * h, scale=0.05), b3=r(1, 3 * h, scale=0.1))
    return ins, idx, transpose_perm(idx)


# the inputs that play the positions (they carry the tangent) per family
POS_LIKE = {"et": ("dir0", "dir1", "dir2", "cutm", "ea", "vec0"), "t": ("cutm", "ea", "k"),
            "tn": ("cutm", "ea", "cat")}


def _phase_energy(family, t, idx, perm):
    """A scalar of the fused phase's output through its Function, with
    second derivatives in every input."""
    if family == "et":
        x, vec = em._EtMessages.apply((4, "silu", "silu"), idx, perm, *t.values())
        return (x * x).sum() * 0.1 + (vec ** 3).sum() * 0.05 + x.sum()
    if family == "t":
        out = tmk._TMessages.apply((4, "silu", "silu"), idx, perm, *t.values())
    else:
        out = tnm._TnMessages.apply("silu", idx, perm, *t.values())
    return (out * out).sum() * 0.1 + (out ** 3).sum() * 0.05 + out.sum()


@pytest.mark.parametrize("family", ["et", "t", "tn"])
def test_functions_jvp_matches_gradgrad(monkeypatch, family):
    counts = tangent_free_kernels(monkeypatch, family)
    ins, idx, perm = _phase_inputs(family, seed=3)
    pos_like = POS_LIKE[family]
    theta = [n for n in ins if n not in pos_like and n != "msk"]
    rng = np.random.default_rng(4)
    g = {n: torch.as_tensor(rng.normal(size=tuple(ins[n].shape))) for n in pos_like}
    # grad-of-grad: the "forces" with their graph, then the loss's gradient
    t = {n: a.clone().requires_grad_(n != "msk") for n, a in ins.items()}
    forces = torch.autograd.grad(_phase_energy(family, t, idx, perm), [t[n] for n in pos_like], create_graph=True)
    loss = sum((f * g[n]).sum() for f, n in zip(forces, pos_like))
    want = dict(zip(theta, torch.autograd.grad(loss, [t[n] for n in theta])))
    assert tuple(counts.values()) == (1, 2, 1)
    # forward over reverse, without create_graph: a backward must route
    # through its differentiable Function because a tangent is live
    counts.update(dict.fromkeys(counts, 0))
    with fwAD.dual_level():
        t = {n: a.clone().requires_grad_(n in theta) for n, a in ins.items()}
        for n in pos_like:
            t[n] = fwAD.make_dual(t[n], g[n])
        grads = torch.autograd.grad(_phase_energy(family, t, idx, perm), [t[n] for n in theta])
        got = {n: fwAD.unpack_dual(gr).tangent for n, gr in zip(theta, grads)}
    assert tuple(counts.values()) == (1, 1, 0)
    assert all(v is not None for v in got.values())
    gap = _gap(got, want)
    print(f"{family}: Functions' jvp against grad-of-grad, largest gap {gap:.3e}")
    assert gap <= 1e-10


def f64_messages(monkeypatch):
    """The models' fused calls in f64: their message dtypes (bf16 operands,
    f32 sums) read as f64 in the three model modules, so the Functions (the
    kernels' plain twins) run on f64 operands and the two force-gradient
    modes agree to rounding."""
    import types

    import torchmdnet_tpu_torch.models.et as et_model
    import torchmdnet_tpu_torch.models.tensornet as tn_model
    import torchmdnet_tpu_torch.models.transformer as t_model

    f64 = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch) if not k.startswith("__")})
    f64.bfloat16 = f64.float32 = torch.float64
    for module in (et_model, t_model, tn_model):
        monkeypatch.setattr(module, "torch", f64)


@pytest.mark.parametrize("messages,tol", [("bf16", JVP_BF16_TOL), ("f64", 1e-9)])
@pytest.mark.parametrize("family", ["et", "t", "tn"])
def test_fused_jvp_step_matches_gradgrad(monkeypatch, tmp_path, family, messages, tol):
    counts = tangent_free_kernels(monkeypatch, family)
    route_models_through_functions(monkeypatch)
    precision = 32
    if messages == "f64":
        f64_messages(monkeypatch)
        precision = 64
    args = dict(BASE, precision=precision, bf16_messages=True, max_z=128 if family == "tn" else 100,
                **FUSED[family])
    fdt = np.float64 if precision == 64 else np.float32
    batch = spatial_sort(_batch(fdt), cell=5.0)[0]
    layers = BASE["num_layers"]
    want, _ = _step_grads(args, "gradgrad", batch, tmp_path)
    assert tuple(counts.values()) == (layers, 2 * layers, layers)
    counts.update(dict.fromkeys(counts, 0))
    got, _ = _step_grads(args, "jvp", batch, tmp_path)
    # JAX's three passes: the forces (one forward, one backward), the energy
    # loss (one each), the jvp pass (one each); no second order
    assert tuple(counts.values()) == (3 * layers, 3 * layers, 0)
    copies = [k for k in want if any(c in k for c in ("dk_proj", "dv_proj", "linears_scalar"))]
    gap = _gap(got, want, [k for k in want if k not in copies])
    gap_copies = _gap(got, want, copies) if copies else 0.0
    print(f"{family} fused, {messages} messages: jvp against gradgrad, largest gap {gap:.3e}, bf16 copies "
          f"{gap_copies:.3e}")
    assert gap <= tol and gap_copies <= tol


CLI = ["--device", "cpu", "--model", "equivariant-transformer", "--embedding-dimension", "16", "--num-layers", "1",
       "--num-rbf", "8", "--num-heads", "4", "--max-num-neighbors", "16", "--cutoff-upper", "3.0",
       "--derivative", "true", "--batch-size", "4", "--train-size", "8", "--val-size", "4", "--test-size", "4",
       "--dataset", "DummyDataset", "--save-interval", "1", "--num-workers", "0", "--lr", "1e-3",
       "--precision", "64", "--num-epochs", "1", "--neg-dy-weight", "0.5"]


def test_cli_force_grad_mode_jvp_matches_gradgrad(tmp_path):
    from torchmdnet_tpu_torch.scripts import train as cli

    rows = {}
    for mode in ("jvp", "gradgrad"):
        log_dir = tmp_path / mode
        trainer, test_metrics = cli.main(CLI + ["--force-grad-mode", mode, "--log-dir", str(log_dir),
                                                "--dataset-root", str(tmp_path / "data")])
        assert trainer.h["force_grad_mode"] == mode and trainer.state.global_step == 2
        with open(os.path.join(log_dir, "metrics.csv")) as f:
            rows[mode] = [{k: float(v) for k, v in r.items() if v not in ("", None)} for r in csv.DictReader(f)]
    assert len(rows["jvp"]) == len(rows["gradgrad"]) >= 2  # the epoch and the test
    for a, b in zip(rows["jvp"], rows["gradgrad"]):
        assert a.keys() == b.keys() and "train_neg_dy_mse_loss" in rows["jvp"][0]
        for key in a:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-9, err_msg=key)


@pytest.mark.parametrize("family", ["et", "t", "tn"])
def test_functions_jvp_of_second_order(monkeypatch, family):
    """Forward mode over grad-of-grad: the tangent of a force-loss gradient
    (the second order, ``derivatives.Bwd2``, differentiated forwards: its
    ``jvp``) through the Functions with tangent-free kernel twins, against
    the same through the plain twin, in f64."""
    counts = tangent_free_kernels(monkeypatch, family)
    ins, idx, perm = _phase_inputs(family, seed=6)
    pos_like = POS_LIKE[family]
    theta = [n for n in ins if n not in pos_like and n != "msk"]
    rng = np.random.default_rng(7)
    g = {n: torch.as_tensor(rng.normal(size=tuple(ins[n].shape))) for n in pos_like}
    w = {n: torch.as_tensor(rng.normal(size=tuple(ins[n].shape))) for n in pos_like}
    got = {}
    for fused in (True, False):
        with fwAD.dual_level():
            t = {n: a.clone().requires_grad_(n != "msk") for n, a in ins.items()}
            for n in pos_like:
                t[n] = fwAD.make_dual(t[n], g[n])
            if fused:
                energy = _phase_energy(family, t, idx, perm)
            else:
                with monkeypatch.context() as mp:  # the plain twin through the same energy
                    mp.setattr(em._EtMessages, "apply", lambda cfg, i, p, *a: em.et_messages_reference(
                        i, *a, heads=cfg[0], act=cfg[1], attn_act=cfg[2], perm=p))
                    mp.setattr(tmk._TMessages, "apply", lambda cfg, i, p, *a: tmk.t_messages_reference(
                        i, *a, heads=cfg[0], act=cfg[1], attn_act=cfg[2], perm=p))
                    mp.setattr(tnm._TnMessages, "apply", lambda act, i, p, *a: tnm.tn_messages_reference(
                        i, *a, act=act, perm=p))
                    energy = _phase_energy(family, t, idx, perm)
            forces = torch.autograd.grad(energy, [t[n] for n in pos_like], create_graph=True)
            loss = sum((f * w[n]).sum() + (f * f).sum() for f, n in zip(forces, pos_like))
            grads = torch.autograd.grad(loss, [t[n] for n in theta], create_graph=True)
            got[fused] = {n: fwAD.unpack_dual(gr).tangent for n, gr in zip(theta, grads)}
    assert counts["bwd2"] >= 1 and all(v is not None for v in got[True].values())
    gap = _gap(got[True], got[False])
    print(f"{family}: the second order's tangent through the Functions against the plain twin's, gap {gap:.3e}")
    assert gap <= 1e-10
