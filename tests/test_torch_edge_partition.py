"""Edge partitioning of the port (``torchmdnet_tpu_torch.parallel``), on the CPU.

One 61-atom molecule padded to 64 and spatially sorted (the shapes of the
JAX package's tests/test_ring_model.py:30-44), two layers at 32 channels.
Two ranks on gloo run ``torchmdnet_tpu_torch.tools.partition_run`` once for
the whole file (a ``python -m`` entry of the package: the ranks import
torch only); this process computes the single-process references meanwhile.

- energies and forces of the four models' composable paths and of ET's
  fused path (the kernels' plain twins, routed through the same passes in
  the single-process reference) against one process: energy rtol 1e-5,
  forces rtol 1e-4 (JAX's ring test's tolerance, tests/test_ring_model.py:47-53;
  they agree to the last bit in practice);
- ET partitioned against the JAX package at the same weights
  (``state_dict_from_jax``): JAX's single-device ``energy_and_forces``, to
  which JAX's tests hold its ``ring_apply``; f32 rtol 1e-5, forces atol 1e-5;
- a ZBL prior under partitioning, MD with ``Simulation(mesh,
  edge_partition=True)`` (its trajectory, and each force evaluation
  against one process's on the same list), bitwise repeatability, the boundary capacity
  check, and the paths of the next slice raising with ROADMAP's G2 item;
- the exchange plan itself in one process: two ranks' tables, with the
  exchange done by hand, give the global gather and transpose-sum bitwise.
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


def _cases(batch, et_state):
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    cases = [dict(name=m, kind="forces", args=_args(m), seed=1, batch=fields) for m in MODELS]
    cases[2]["state_dict"] = et_state
    cases += [
        dict(name="et_fused", kind="forces", seed=1, batch=fields,
             args=_args("equivariant-transformer", bf16_messages=True, fused_attention=True)),
        dict(name="zbl", kind="forces", seed=1, batch=fields, args=_args("equivariant-transformer", prior_model=ZBL)),
        dict(name="md", kind="md", args=_args("equivariant-transformer"), seed=1, batch=fields, md=MD, record=True),
        dict(name="overflow", kind="raises", what="overflow", args=_args("graph-network"), seed=1, batch=fields,
             boundary_capacity=8),
        dict(name="fused_transformer", kind="raises", what="fused", seed=1, batch=fields,
             args=_args("transformer", bf16_messages=True, fused_attention=True)),
        dict(name="fused_tensornet", kind="raises", what="fused", seed=1, batch=fields,
             args=_args("tensornet", bf16_messages=True, fused_message=True)),
        dict(name="training", kind="raises", what="trainer", seed=1, batch=fields, args=_args("equivariant-transformer")),
    ]
    return cases


def _through_passes(monkeypatch):
    """Route the single-process fused ET op through ``_EtMessages`` with the
    passes' plain twins (the CPU has no kernel), as the partitioned op runs."""
    import torchmdnet_tpu_torch.models.et as et_model
    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    def plain_fwd(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dirs, wdk, bdk, wdv, bdv, *, heads, act, attn_act):
        with torch.no_grad():
            return em.et_messages_reference(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, *dirs, wdk, bdk, wdv,
                                            bdv, heads=heads, act=act, attn_act=attn_act, perm=idx)

    def fused(idx, q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk=None, bdk=None, wdv=None,
              bdv=None, *, heads, act="silu", attn_act="silu", perm=None):
        return em._EtMessages.apply((heads, act, attn_act), idx, transpose_perm(idx) if perm is None else perm,
                                    q, k, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1, dir2, wdk, bdk, wdv, bdv)

    monkeypatch.setattr(em, "run_fwd", plain_fwd)
    monkeypatch.setattr(et_model, "fused_et_messages", fused)


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
    cases = _cases(batch, et_state)
    for case in cases:
        if case["kind"] == "raises" and case["what"] == "trainer":
            case["log_dir"] = str(tmp / "logs")
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
        for case in cases:
            if case["kind"] == "forces" and case["name"] != "et_fused":
                a = case["args"]
                model = create_model(a, create_prior_models(a) if a.get("prior_model") else None, device="cpu",
                                     seed=case["seed"])
                if case.get("state_dict") is not None:
                    model.module.load_state_dict(case["state_dict"])
                ref[case["name"]] = model.energy_and_forces(batch)
        with pytest.MonkeyPatch.context() as mp:
            _through_passes(mp)
            model = create_model(cases[4]["args"], device="cpu", seed=1)
            ref["et_fused"] = model.energy_and_forces(batch)
        md = dict(MD)
        steps, vel_seed = md.pop("steps"), md.pop("velocity_seed")
        sim = Simulation(create_model(et_args, device="cpu", seed=1), batch, device="cpu", **md)
        sim.set_velocities_from_temperature(md["temperature_K"], seed=vel_seed)
        ref["md"] = sim.step(steps)
        ref["md_sim"] = sim
    finally:
        worker.join()
        torch.set_num_threads(threads)
    assert status.get("rc") == 0, f"a rank failed (exit code {status.get('rc')})"
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(2)]
    return outs, ref


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", MODELS + ["et_fused"])
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


def test_partitioned_et_matches_jax(runs):
    outs, ref = runs
    y_ref, f_ref = (np.asarray(t) for t in ref["jax"])
    r = outs[0]["cases"]["equivariant-transformer"]
    np.testing.assert_allclose(r["energy"].numpy(), y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["forces"].numpy(), f_ref, rtol=1e-5, atol=1e-5)


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


@pytest.mark.parametrize("name", ["fused_transformer", "fused_tensornet", "training"])
def test_next_slice_raises_naming_g2(runs, name):
    outs, _ = runs
    for out in outs:
        r = out["cases"][name]
        assert r["raised"] == "NotImplementedError" and "item G2" in r["message"], r


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
