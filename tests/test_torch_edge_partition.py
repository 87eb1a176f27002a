"""Edge partitioning of the port (``torchmdnet_tpu_torch.parallel``), on the CPU.

One 61-atom molecule padded to 64 and spatially sorted (the shapes of the
JAX package's tests/test_ring_model.py:30-44), two layers at 32 channels.
Two ranks on gloo run ``torchmdnet_tpu_torch.tools.partition_run`` once for
the whole file (a ``python -m`` entry of the package: the ranks import
torch only); this process computes the single-process references meanwhile.

- energies and forces of the four models' composable paths and of the
  fused ET, Transformer and TensorNet (the kernels' plain twins, routed
  through the same passes in the single-process reference) against one
  process: energy rtol 1e-5, forces rtol 1e-4 (JAX's ring test's
  tolerance, tests/test_ring_model.py:47-53; they agree to the last bit in
  practice);
- the force-loss gradient (``partition_run.force_loss``) through the
  partitioned forces, summed over the ranks, against one process's, for
  the same seven paths (GRAD_TOL), and a third derivative of that loss
  (``partition_run.third_derivative``), composable and fused ET (the
  composable third-order rule on each rank's rows), against one process's;
- ET partitioned against the JAX package at the same weights
  (``state_dict_from_jax``): JAX's single-device ``energy_and_forces``, to
  which JAX's tests hold its ``ring_apply``, f32 rtol 1e-5, forces atol
  1e-5; and its force-loss gradient against JAX's ``jax.grad`` of the same
  loss;
- ``Trainer.fit`` with ``edge_partition`` on two ranks against one process's
  plain training (``metrics.csv`` and the first step's gradients), and the
  ranks' first step in ``force_grad_mode="jvp"`` (the tangents exchanged
  as the rows are) against it;
- a ZBL prior under partitioning, MD with ``Simulation(mesh,
  edge_partition=True)`` (its trajectory, and each force evaluation
  against one process's on the same list), bitwise repeatability and the
  boundary capacity check;
- the exchange plan itself in one process: two ranks' tables, with the
  exchange done by hand, give the global gather and transpose-sum bitwise;
  and ``DataModule``'s capacity under edge partitioning.
"""

import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from torchmdnet_tpu.data.batch import pad_molecules as jax_pad_molecules
from torchmdnet_tpu.models.potential import create_model as jax_create_model
from torchmdnet_tpu.ops.rbf import ExpNormalSmearing
from torchmdnet_tpu_torch import Simulation, create_model, state_dict_from_jax
from torchmdnet_tpu_torch.data.batch import pad_molecules, spatial_sort
from torchmdnet_tpu_torch.models.potential import create_prior_models
from torchmdnet_tpu_torch.ops.neighbors import ell_gather, ell_transpose_sum, neighbor_list, transpose_perm
from torchmdnet_tpu_torch.parallel.edge_partition import make_ring_plan
from torchmdnet_tpu_torch.parallel.mesh import Mesh
from torchmdnet_tpu_torch.tools.partition_run import force_loss, third_derivative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(activation="silu", atom_filter=-1, cutoff_lower=0.0, cutoff_upper=5.0, derivative=True,
            embedding_dimension=32, max_num_neighbors=32, max_z=100, neighbor_embedding=True, num_heads=4,
            num_layers=2, num_rbf=8, output_model="Scalar", precision=32, prior_model=None, rbf_type="expnorm",
            reduce_op="sum", trainable_rbf=False, attn_activation="silu", distance_influence="both", aggr="add",
            equivariance_invariance_group="O(3)")
MODELS = ["graph-network", "transformer", "equivariant-transformer", "tensornet"]
ZBL = {"ZBL": {"cutoff_distance": 3.0, "max_num_neighbors": 32, "atomic_number": list(range(100)),
               "distance_scale": 1e-10, "energy_scale": 1.60218e-19}}
MD = dict(steps=10, neighbor_skin=0.5, rebuild_every=5, timestep_fs=0.5, temperature_K=300.0,
          friction_per_fs=0.01, seed=3, velocity_seed=4)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# The force-loss gradients' largest gap over each tensor's largest value.
# Sound runs (this file's shapes, CPU): composable f32 6.8e-7 at most, the
# fused paths (plain twins on both sides) 1.3e-6 but for the weights the
# kernels read as bf16 copies (BF16_COPIES: ET's and the Transformer's
# distance filters, TensorNet's edge MLP), where each rank's share of the
# gradient is rounded to bf16 before the ranks' sum: up to 7.4e-3 (as under
# data parallelism, chip_smoke.py's DP_BF16_FILTER_GRAD_TOL); ET against
# JAX 1.4e-6.  Planted faults: the ghost rows of Z on ET's source rows
# dropped 7.6e-3, TensorNet's ghost receivers' w' slots dropped 1.0e-3, the
# Transformer's ghost receivers' hs4 dropped 2.9e-4, the exchange's
# transpose left non-differentiable (composable) 1.2e-3 to 2.7e-2, the
# energy loss's gradient taken through every rank's partials 1.0.  Limits
# between:
GRAD_TOL = 1e-5
BF16_COPIES = ("dk_proj", "dv_proj", "linears_scalar")
BF16_COPY_TOL = 2 ** -6
# A third derivative of force_loss (quadratic in the replicated energy)
# under partitioning against one process's.  Sound (CPU): composable ET
# within GRAD_TOL; fused ET 3.4e-4 (the bf16 operands' roundings, carried
# one differentiation further; the copies 5.9e-3, within BF16_COPY_TOL).
# Planted: the replicated readout's cotangent sliced to the rank's row
# without the gather back (the cross terms between ranks' partials lost)
# 0.46-0.64 on the fused ET.  Limit between:
THIRD_BF16_TOL = 2e-3
# Trainer.fit on two ranks against one process: the ranks sort the batch in
# space and one process does not, so float sums differ in order.  Sound:
# first-step gradients 5.1e-6, logged metrics 2.7e-6 (relative); planted
# (the force loss normalised by the rank's own atoms): 0.25 and 1.0.  JAX's
# test holds the metrics at 1e-3 (tests/test_ring_model.py:231-235).
TRAIN_GRAD_TOL = 5e-5
TRAIN_METRIC_RTOL = 5e-5
TRAIN = dict(batch_size=2, inference_batch_size=2, num_epochs=2, train_size=4, val_size=2, test_size=2, seed=1,
             lr=1e-3, lr_warmup_steps=0, save_interval=100, test_interval=-1, num_workers=0, y_weight=1.0,
             neg_dy_weight=1.0, ema_alpha_y=1.0, ema_alpha_neg_dy=1.0, early_stopping_patience=50,
             lr_patience=10)


def _args(model, **over):
    return dict(BASE, model=model, max_z=128 if model == "tensornet" else 100, **over)


def _molecule():
    rng = np.random.default_rng(5)
    return {"z": rng.integers(1, 10, 61).astype(np.int32),
            "pos": (4.0 * rng.standard_normal((61, 3))).astype(np.float32)}


def _batch():
    return spatial_sort(pad_molecules([_molecule()], num_atoms=64, num_mol=1))[0]


def _jax_params(args, jb):
    """Random JAX weights of the JAX model's tree (numpy draws on
    ``eval_shape``'s shapes; the RBF constants at their initial values)."""
    shapes = jax.eval_shape(jax_create_model(args).init, jax.random.PRNGKey(0), jb)
    rbf = ExpNormalSmearing(args["cutoff_lower"], args["cutoff_upper"], args["num_rbf"], buffer_dtype=np.float32)
    means, betas = (np.asarray(a) for a in rbf._initial_params())
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("means", "betas"):
            return means if name == "means" else betas
        scale = {"scale": 0.1, "bias": 0.1, "embedding": 1.0}.get(name, leaf.shape[0] ** -0.5)
        return (rng.normal(scale=scale, size=leaf.shape) + (1.0 if name == "scale" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_batch(batch):
    """The JAX batch of the port's sorted batch (its 61 real atoms lead)."""
    n = int(batch.atom_mask.sum())
    mol = {"z": batch.z[:n].numpy().astype(np.int32), "pos": batch.pos[:n].numpy()}
    return jax_pad_molecules([mol], num_atoms=batch.num_atoms, num_mol=1)


FUSED = {"et_fused": dict(model="equivariant-transformer", fused_attention=True),
         "t_fused": dict(model="transformer", fused_attention=True),
         "tn_fused": dict(model="tensornet", fused_message=True)}


def _targets(batch):
    """Seeded (y, neg_dy) labels of the global batch for the force loss."""
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.normal(size=(batch.num_mol, 1)).astype(np.float32))
    f = torch.from_numpy(rng.normal(size=(batch.num_atoms, 3)).astype(np.float32))
    return y, f


def _frames(n=8):
    """``n`` perturbed frames of the molecule with seeded labels, as an
    ``InMemoryArrays`` dataset (the ranks unpickle it)."""
    from torchmdnet_tpu_torch.data.datasets.base import InMemoryArrays

    mol = _molecule()
    rng = np.random.default_rng(11)
    a = len(mol["z"])
    pos = np.concatenate([mol["pos"] + 0.05 * rng.standard_normal((a, 3)).astype(np.float32) for _ in range(n)])
    return InMemoryArrays(z=np.tile(mol["z"], n).astype(np.int64), pos=pos.astype(np.float32),
                          offsets=np.arange(n + 1) * a, y=rng.normal(size=(n, 1)).astype(np.float32),
                          neg_dy=rng.normal(size=(n * a, 3)).astype(np.float32))


def _train_hparams():
    return dict(_args("equivariant-transformer"), **TRAIN)


def _cases(batch, et_state, tmp):
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    targets = _targets(batch)
    cases = [dict(name=m, kind="forces", args=_args(m), seed=1, batch=fields, targets=targets,
                  third=m == "equivariant-transformer") for m in MODELS]
    cases[2]["state_dict"] = et_state
    cases += [dict(name=name, kind="forces", seed=1, batch=fields, targets=targets, third=name == "et_fused",
                   args=_args(f["model"], bf16_messages=True, **{k: v for k, v in f.items() if k != "model"}))
              for name, f in FUSED.items()]
    cases += [
        dict(name="zbl", kind="forces", seed=1, batch=fields, args=_args("equivariant-transformer", prior_model=ZBL)),
        dict(name="md", kind="md", args=_args("equivariant-transformer"), seed=1, batch=fields, md=MD, record=True),
        dict(name="overflow", kind="raises", what="overflow", args=_args("graph-network"), seed=1, batch=fields,
             boundary_capacity=8),
        dict(name="training", kind="train", hparams=_train_hparams(), dataset=_frames(), log_dir=str(tmp / "ranks"),
             jvp_grads=True),
    ]
    return cases


def _through_passes(monkeypatch):
    """Route the single-process fused ops through ``_EtMessages``,
    ``_TMessages`` and ``_TnMessages`` with the kernels' plain twins (the
    CPU has no kernel), as the partitioned ops run."""
    import torchmdnet_tpu_torch.models.et as et_model
    import torchmdnet_tpu_torch.models.transformer as t_model
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    def plain_fwd(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, *, heads, act, attn_act):
        with torch.no_grad():
            return em.et_messages_reference(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, *dirs, wdk, bdk, wdv,
                                            bdv, heads=heads, act=act, attn_act=attn_act, perm=idx)

    def fused(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk=None, bdk=None, wdv=None,
              bdv=None, *, heads, act="silu", attn_act="silu", perm=None):
        return em._EtMessages.apply((heads, act, attn_act), idx, transpose_perm(idx) if perm is None else perm,
                                    q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk, bdk, wdv, bdv)

    def plain_t_fwd(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, *, heads, act, attn_act):
        with torch.no_grad():
            return tmk.t_messages_reference(idx, q, k, v, ea, cutm, wdk, bdk, wdv, bdv, heads=heads, act=act,
                                            attn_act=attn_act, perm=idx)

    def fused_t(idx, q, k, v, ea, cutm, wdk=None, bdk=None, wdv=None, bdv=None, *, heads, act="silu",
                attn_act="silu", perm=None):
        return tmk._TMessages.apply((heads, act, attn_act), idx, transpose_perm(idx) if perm is None else perm,
                                    q, k, v, ea, cutm, wdk, bdk, wdv, bdv)

    def plain_tn_fwd(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, *, act):
        with torch.no_grad():
            return tm.tn_messages_reference(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, act=act, perm=idx)

    def fused_tn(idx, cat, ea, cutm, w1, b1, w2, b2, w3, b3, *, act="silu", perm=None):
        return tm._TnMessages.apply(act, idx, transpose_perm(idx) if perm is None else perm, cat, ea, cutm,
                                    w1, b1, w2, b2, w3, b3)

    monkeypatch.setattr(em, "run_fwd", plain_fwd)
    monkeypatch.setattr(et_model, "fused_et_messages", fused)
    monkeypatch.setattr(tmk, "run_fwd", plain_t_fwd)
    monkeypatch.setattr(t_model, "fused_t_messages", fused_t)
    monkeypatch.setattr(tm, "run_fwd", plain_tn_fwd)
    monkeypatch.setattr(tm, "fused_tn_messages", fused_tn)


def _force_grads(model, batch, targets):
    """One process's force-loss gradient, {parameter name: gradient}."""
    y, f = model.energy_and_forces(batch, create_graph=True)
    force_loss(y, f, *targets, batch.atom_mask, float(batch.atom_mask.sum())).backward()
    return {n: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
            for n, p in model.module.named_parameters() if p.requires_grad}


def _third_grads(model, batch, targets):
    """One process's ``third_derivative``, {parameter name: gradient}."""
    y, f = model.energy_and_forces(batch, create_graph=True)
    named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
    loss = force_loss(y, f, *targets, batch.atom_mask, float(batch.atom_mask.sum()))
    third = third_derivative(loss, [p for _, p in named])
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, third)}


def _jax_force_grads(args, params, jb, targets):
    """JAX's single-device ``jax.grad`` of ``force_loss`` at ``params``, in
    the port's parameter names (``state_dict_from_jax`` maps the gradient
    tree as it maps the weights: transposes and column permutations)."""
    import jax.numpy as jnp

    jm = jax_create_model(args)
    n = int(np.asarray(jb.atom_mask).sum())
    y_t = jnp.asarray(targets[0].numpy())
    f_t = jnp.zeros((jb.num_atoms, 3), jnp.float32).at[:n].set(jnp.asarray(targets[1][:n].numpy()))

    def loss(p):
        y, f = jm.energy_and_forces(p, jb)
        err = jnp.where(jb.atom_mask, ((f - f_t) ** 2).sum(-1), 0.0)
        return ((y - y_t) ** 2).sum() + err.sum() / n

    g = jax.jit(jax.grad(loss)).lower(params).compile(compiler_options=FAST_COMPILE)(params)
    return {k: v for k, v in state_dict_from_jax(args, jax.tree_util.tree_map(np.asarray, g)).items()}


def _train_one_process(tmp):
    """One process's plain training of the ranks' case: (metrics.csv rows,
    the first step's gradients)."""
    import csv

    from torchmdnet_tpu_torch.data.module import DataModule
    from torchmdnet_tpu_torch.train.trainer import Trainer

    h = dict(_train_hparams(), device="cpu", log_dir=str(tmp / "one"))
    data = DataModule(h, dataset=_frames())
    data.setup()
    grads = {}

    class Recording(Trainer):
        def on_before_optimizer_step(self):
            if self.state.global_step == 0:
                grads.update({n: p.grad.detach().clone() for n, p in zip(self.param_names, self.params)})

    Recording(create_model(h, device="cpu", seed=1), h).fit(data)
    with open(tmp / "one" / "metrics.csv") as f:
        rows = [{k: float(v) for k, v in r.items() if v not in ("", None)} for r in csv.DictReader(f)]
    return rows, grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two gloo ranks on the CPU run every case once, while this process
    computes the references: (rank results, single-process results)."""
    from torchmdnet_tpu_torch.parallel.distributed import launch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("edge_partition")
    batch = _batch()
    et_args = _args("equivariant-transformer")
    jb = _jax_batch(batch)
    params = _jax_params(et_args, jb)
    # the RBF's fixed buffers are not JAX parameters: keep the port's
    et_state = create_model(et_args, device="cpu").module.state_dict()
    et_state.update(state_dict_from_jax(et_args, params))
    cases = _cases(batch, et_state, tmp)
    torch.save({"device": "cpu", "threads": 1, "cases": cases}, tmp / "spec.pt")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    status = {}
    worker = threading.Thread(target=lambda: status.update(rc=launch(
        ["-m", "torchmdnet_tpu_torch.tools.partition_run", "--spec", str(tmp / "spec.pt"),
         "--out", str(tmp / "out{rank}.pt")], 2, env=env, timeout=240)))
    worker.start()
    ref = {}
    try:
        jm = jax_create_model(et_args)
        ref["jax"] = jax.jit(jm.energy_and_forces).lower(params, jb).compile(compiler_options=FAST_COMPILE)(params, jb)
        targets = _targets(batch)
        ref["jax_grads"] = _jax_force_grads(et_args, params, jb, targets)
        for case in cases:
            if case["kind"] == "forces" and case["name"] not in FUSED:
                a = case["args"]
                model = create_model(a, create_prior_models(a) if a.get("prior_model") else None, device="cpu",
                                     seed=case["seed"])
                if case.get("state_dict") is not None:
                    model.module.load_state_dict(case["state_dict"])
                ref[case["name"]] = model.energy_and_forces(batch)
                if case.get("targets") is not None:
                    ref[case["name"] + "_grads"] = _force_grads(model, batch, targets)
                if case.get("third"):
                    ref[case["name"] + "_third"] = _third_grads(model, batch, targets)
        with pytest.MonkeyPatch.context() as mp:
            _through_passes(mp)
            for case in cases:
                if case["name"] in FUSED:
                    model = create_model(case["args"], device="cpu", seed=1)
                    ref[case["name"]] = model.energy_and_forces(batch)
                    ref[case["name"] + "_grads"] = _force_grads(model, batch, targets)
                    if case.get("third"):
                        ref[case["name"] + "_third"] = _third_grads(model, batch, targets)
        md = dict(MD)
        steps, vel_seed = md.pop("steps"), md.pop("velocity_seed")
        sim = Simulation(create_model(et_args, device="cpu", seed=1), batch, device="cpu", **md)
        sim.set_velocities_from_temperature(md["temperature_K"], seed=vel_seed)
        ref["md"] = sim.step(steps)
        ref["md_sim"] = sim
        ref["training"] = _train_one_process(tmp)
    finally:
        worker.join()
        torch.set_num_threads(threads)
    assert status.get("rc") == 0, f"a rank failed (exit code {status.get('rc')})"
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(2)]
    return outs, ref


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _grad_gap(got, want, keys=None):
    """The largest |got - want| of a gradient tensor over its largest |want|,
    over the tensors ``keys`` (all by default)."""
    assert got.keys() == want.keys() and len(want) > 5
    return max(_rel(got[k], want[k]) for k in (want if keys is None else keys))


@pytest.mark.parametrize("name", MODELS + list(FUSED))
def test_partitioned_energy_and_forces_match_one_process(runs, name):
    outs, ref = runs
    y_ref, f_ref = ref[name]
    assert outs[0]["backend"] == "gloo" and outs[0]["size"] == 2
    for out in outs:  # the energy is replicated, the forces gathered on both ranks
        r = out["cases"][name]
        np.testing.assert_allclose(r["energy"].numpy(), y_ref.numpy(), rtol=1e-5, atol=1e-6)
        assert np.abs(f_ref.numpy()).max() > 1e-3
        np.testing.assert_allclose(r["forces"].numpy(), f_ref.numpy(), rtol=1e-4, atol=1e-6)
    stats = outs[0]["cases"][name]["stats"]
    # a surface term of the ranks' rows ships, not the other rank's whole table
    assert 0 < stats["ghost_rows"] < 32 and 0 < stats["boundary_fraction"] < 1


@pytest.mark.parametrize("name", MODELS + list(FUSED))
def test_partitioned_force_loss_gradients_match_one_process(runs, name):
    """The force-loss gradient through the partitioned forces (second order
    through the exchanges; the fused ops' second-order passes on each
    rank's rows), summed over the ranks, against one process's."""
    outs, ref = runs
    want = ref[name + "_grads"]
    tol = GRAD_TOL
    for out in outs:
        r = out["cases"][name]
        copies = [k for k in want if any(c in k for c in BF16_COPIES)] if name in FUSED else []
        gap = _grad_gap(r["grads"], want, [k for k in want if k not in copies])
        gap_copies = _grad_gap(r["grads"], want, copies) if copies else 0.0
        print(f"{name}: force-loss gradients, largest gap {gap:.3e} of a tensor's largest (tol {tol}); "
              f"the {len(copies)} weights the kernels read as bf16 copies {gap_copies:.3e} (tol {BF16_COPY_TOL})")
        assert gap <= tol and gap_copies <= BF16_COPY_TOL, (name, gap, gap_copies)


@pytest.mark.parametrize("name", ["equivariant-transformer", "et_fused"])
def test_partitioned_third_derivative_raises(runs, name):
    """A third derivative of ``force_loss`` (quadratic in the replicated
    energy) under partitioning, composable and fused ET, summed over the
    ranks, against one process's (the name is kept from when it raised):
    the fused second order's gradient is autograd through its plain twin on
    each rank's rows, its gathers through the exchange, and the readout's
    cross terms between the ranks' partials go through the gather back."""
    outs, ref = runs
    want = ref[name + "_third"]
    copies = [k for k in want if any(c in k for c in BF16_COPIES)] if name in FUSED else []
    tol = THIRD_BF16_TOL if name in FUSED else GRAD_TOL
    for out in outs:
        got = out["cases"][name]["third"]
        gap = _grad_gap(got, want, [k for k in want if k not in copies])
        gap_copies = _grad_gap(got, want, copies) if copies else 0.0
        print(f"{name}: third derivative under partitioning, largest gap {gap:.3e} (tol {tol}); the bf16 copies "
              f"{gap_copies:.3e} (tol {BF16_COPY_TOL})")
        assert max(float(v.abs().max()) for v in want.values()) > 1e-6
        assert gap <= tol and gap_copies <= BF16_COPY_TOL


def test_partitioned_et_matches_jax(runs):
    outs, ref = runs
    y_ref, f_ref = (np.asarray(t) for t in ref["jax"])
    r = outs[0]["cases"]["equivariant-transformer"]
    np.testing.assert_allclose(r["energy"].numpy(), y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["forces"].numpy(), f_ref, rtol=1e-5, atol=1e-5)


def test_partitioned_et_force_loss_gradients_match_jax(runs):
    """ET's partitioned force-loss gradient against JAX's single-device
    ``jax.grad`` of the same loss at the same weights."""
    outs, ref = runs
    want = {k: torch.as_tensor(v) for k, v in ref["jax_grads"].items()}
    got = {k: v for k, v in outs[0]["cases"]["equivariant-transformer"]["grads"].items() if k in want}
    gap = _grad_gap(got, want)
    print(f"ET partitioned vs JAX: force-loss gradients, largest gap {gap:.3e} (tol {GRAD_TOL})")
    assert gap <= GRAD_TOL


def test_edge_partition_training_matches_one_process(runs):
    """``Trainer.fit`` with ``edge_partition`` on two ranks (each sorting the
    global batch and training on its rows) against one process's plain
    training on the same batches: the first step's gradients and every
    logged metric (the epoch losses and the validation)."""
    outs, ref = runs
    rows_one, g_one = ref["training"]
    r = outs[0]["cases"]["training"]
    assert r["steps"] == 4 and len(r["rows"]) == len(rows_one) == 2
    gap = _grad_gap(r["grads"], g_one)
    losses = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(r["rows"], rows_one) for k in b if k != "epoch")
    print(f"edge-partitioned training: first-step gradients {gap:.3e}, logged metrics {losses:.3e}")
    assert all(a.keys() == b.keys() for a, b in zip(r["rows"], rows_one))
    assert gap <= TRAIN_GRAD_TOL and losses <= TRAIN_METRIC_RTOL


def test_edge_partition_jvp_step_matches_one_process(runs):
    """The ranks' first training step in ``force_grad_mode="jvp"`` (the
    forward-mode tangents of the positions exchanged with the rows, the
    replicated energy's tangent through each rank's partials), summed over
    the ranks, against one process's grad-of-grad step."""
    outs, ref = runs
    _, g_one = ref["training"]
    got = outs[0]["cases"]["training"]["jvp_grads"]
    gap = _grad_gap(got, g_one)
    print(f"edge-partitioned jvp step: first-step gradients {gap:.3e} (tol {TRAIN_GRAD_TOL})")
    assert gap <= TRAIN_GRAD_TOL


def test_partitioned_forces_repeat_bitwise(runs):
    outs, _ = runs
    for out in outs:
        for name, r in out["cases"].items():
            if "repeat_bitwise" in r:
                assert r["repeat_bitwise"], name


def test_zbl_prior_partitioned(runs):
    outs, ref = runs
    y_ref, f_ref = ref["zbl"]
    r = outs[1]["cases"]["zbl"]
    np.testing.assert_allclose(r["energy"].numpy(), y_ref.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["forces"].numpy(), f_ref.numpy(), rtol=1e-4, atol=1e-6)


def test_partitioned_md_matches_one_process(runs):
    outs, ref = runs
    state = ref["md"]
    for out in outs:
        r = out["cases"]["md"]
        assert not r["stale"] and not bool(state.stale)
        # 10 Langevin steps from the same random streams: positions within 1e-5 A
        np.testing.assert_allclose(r["pos"].numpy(), state.pos.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["energy"].numpy(), state.energy.numpy(), rtol=1e-5, atol=1e-6)


def test_partitioned_md_evaluations_match_one_process(runs):
    """Every force evaluation of the partitioned run (the start and one a
    step) against one process's on the same skin list (built at the same
    positions), at the same positions: forces within 1e-4 of the largest."""
    outs, ref = runs
    sim = ref["md_sim"]
    for out in outs:
        records = out["cases"]["md"]["records"]
        assert len(records) == MD["steps"] + 1
        for built_at, at, f_ranks in records:
            nbl = sim._build_nbl(built_at).refine(at, sim._lo, sim._hi, sim.box)
            f_one = sim._forces(at, nbl)[1]
            assert _rel(f_ranks, f_one) <= 1e-4


def test_boundary_overflow_raises(runs):
    outs, _ = runs
    r = outs[0]["cases"]["overflow"]
    assert r["raised"] == "ValueError" and "boundary capacity" in r["message"]


@pytest.mark.parametrize("ranks", [3, 6])
def test_edge_partition_capacity_divides_over_ranks(tmp_path, monkeypatch, ranks):
    """Under edge partitioning every rank loads the whole batch and keeps
    1/D of its atom rows: the capacity is a multiple of lcm(8, D) while the
    loader stays unsharded (the arithmetic, with no rank started)."""
    from torchmdnet_tpu_torch.data.module import DataModule
    from torchmdnet_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "process_info", lambda: (1, ranks))
    h = dict(TRAIN, device="cpu", log_dir=str(tmp_path), edge_partition=True)
    data = DataModule(h, dataset=_frames())
    data.setup()
    assert data.num_atoms_pad % ranks == 0 and data.num_atoms_pad % 8 == 0 and data.num_atoms_pad >= 2 * 61
    batch = next(iter(data.train_dataloader()))
    assert batch.num_atoms == data.num_atoms_pad and batch.num_mol == 2 and bool(batch.mol_mask.all())
    assert int(batch.atom_mask.sum()) == 2 * 61


@pytest.mark.parametrize("self_loops", [True, False])
def test_plan_tables_give_the_global_gather_and_transpose(self_loops):
    """Both ranks' plans of one global list, with the exchange done by hand,
    gather and transpose-sum bitwise as the single-process ops, and the
    fused source pass's receiver tables list each atom's slots in the global
    transpose permutation's order; also after dropping the self loops."""
    batch = _batch()
    nbl = neighbor_list(batch.pos, batch.batch, batch.atom_mask, k=24, cutoff_upper=4.0, loop=True)
    perm = transpose_perm(nbl.idx)
    n, k = nbl.idx.shape
    plans = [make_ring_plan(nbl.idx, Mesh(2, r, torch.device("cpu"), "none"), perm=perm) for r in range(2)]
    idx = nbl.idx
    if not self_loops:
        plans = [p.without_self_loops() for p in plans]
        idx, perm = nbl.without_self_loops().idx, nbl.without_self_loops().transpose_perm
        k -= 1
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, 5, generator=g, dtype=torch.float64)
    ct = torch.randn(n, k, 5, generator=g, dtype=torch.float64)
    full_gather, full_t = ell_gather(x, idx, perm), ell_transpose_sum(ct, idx, perm)
    nl = n // 2
    for r, p in enumerate(plans):
        ghosts = torch.cat([x[o * nl:(o + 1) * nl][plans[o].src_send[r]] for o in range(2)])
        table = torch.cat([x[r * nl:(r + 1) * nl], ghosts])
        assert torch.equal(table[p.lidx.long()], full_gather[r * nl:(r + 1) * nl])
        flat = [ct[o * nl:(o + 1) * nl].reshape(nl * k, 5) for o in range(2)]
        slots = torch.cat([flat[r]] + [flat[o][plans[o].slot_send[r]] for o in range(2)])
        mine = slots[p.perm_ext].reshape(nl, k, 5).sum(dim=1)
        assert torch.equal(mine, full_t[r * nl:(r + 1) * nl])
        if self_loops:  # the ghost receivers' slots: receiver and column of each global slot
            recv = torch.cat([torch.arange(r * nl, (r + 1) * nl)]
                             + [torch.arange(o * nl, (o + 1) * nl)[plans[o].rx_send[r]] for o in range(2)])
            rx = p.perm_rx.long()
            want = perm.long().reshape(n, k)[r * nl:(r + 1) * nl].reshape(-1)
            assert torch.equal(recv[rx // k] * k + rx % k, want)


def test_one_rank_entry_points_equal_one_process():
    """On a degenerate one-rank partition (no process group) the JAX-named
    entry points give one process's numbers bitwise: ``ring_apply``,
    ``edge_sharded_apply``, ``two_stage_molecular_reduce`` and the
    all-gather reference ``sharded_gather_aggregate``."""
    from torchmdnet_tpu_torch.ops.segment import segment_reduce
    from torchmdnet_tpu_torch.parallel import (
        edge_sharded_apply,
        make_mesh,
        sharded_gather_aggregate,
        two_stage_molecular_reduce,
    )
    from torchmdnet_tpu_torch.parallel.edge_partition import ring_apply

    batch = _batch()
    mesh = make_mesh(allow_single=True, device="cpu")
    model = create_model(_args("graph-network"), device="cpu", seed=1)
    y_ref, f_ref = model.energy_and_forces(batch)
    y, f = ring_apply(model, batch, mesh, boundary_capacity=0)  # one rank: no boundary edge
    assert torch.equal(y, y_ref) and torch.equal(f, f_ref)
    assert torch.equal(edge_sharded_apply(model, batch, mesh), y_ref)
    g = torch.Generator().manual_seed(2)
    per_atom = torch.randn(batch.num_atoms, generator=g)
    torch.testing.assert_close(two_stage_molecular_reduce(per_atom, batch.batch, 1, mesh),
                               segment_reduce(per_atom, batch.batch, 2)[:1], rtol=0, atol=0)
    nbl = model.neighbors(batch)
    x, w = torch.randn(batch.num_atoms, 4, generator=g), torch.randn(nbl.idx.shape, generator=g)
    want = torch.where(nbl.mask[..., None], x[nbl.idx.long()] * w[..., None], torch.zeros(())).sum(dim=1)
    torch.testing.assert_close(sharded_gather_aggregate(x, nbl.idx, nbl.mask, w, mesh), want, rtol=0, atol=0)
