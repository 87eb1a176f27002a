"""One rank of an edge-partitioned run, driven by a spec file.

    python -m torchmdnet_tpu_torch.tools.partition_run --spec spec.pt --out out.pt

Started once per rank (``parallel.distributed.launch`` sets ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE`` and the coordinator), each rank joins the process
group, builds the same models and global batches from the spec
(``torch.save`` of a dict) and runs its cases:

- ``forces``: ``ring_potential`` once, then ``repeat`` partitioned
  energy+forces calls (bitwise repeatability, wall time, the fused kernels'
  and the cell list's selection launches per call, the rank's peak device memory, its exchange
  statistics); the forces of every rank are gathered.  With "targets" (the
  global (y, neg_dy)), also the force-loss gradient (``force_loss``) through
  the partitioned forces, summed over the ranks, with its launches, and with
  "third" a third derivative (``third_derivative``), summed over the ranks;
- ``train``: ``Trainer.fit`` with ``edge_partition`` on "dataset" with
  "hparams" (its first step's gradients, and rank 0's ``metrics.csv``); with
  "jvp_grads", also the first step's gradients in
  ``force_grad_mode="jvp"``, taken before that step;
- ``md``: ``Simulation(mesh, edge_partition=True)`` for ``steps`` steps; the
  positions of every rank are gathered, with ``stale``; with ``record``,
  every force evaluation's positions and forces (gathered) and the positions
  its list was built at, so that a single-process evaluation on the same
  list can be held against each;
- ``raises``: a call that must raise (``overflow``: a boundary capacity too
  small); the exception is recorded;
- ``probe``: which collectives of the backend take CUDA tensors as they are.

Each rank writes ``out`` with ``{rank}`` replaced by its rank: {"rank",
"size", "backend", "device", "cases": {name: result}}.  A case spec holds
"name", "kind", "args" (the model's hyperparameters), "seed" or
"state_dict" (and optionally "std", the output's scale), "batch" (``AtomicBatch`` fields of the global batch), and the
kind's options.
"""

import argparse
import time

import torch


def _batch(fields, device):
    from torchmdnet_tpu_torch.data.batch import AtomicBatch

    return AtomicBatch(**fields).to(device)


def _model(case, device):
    from torchmdnet_tpu_torch.models.potential import create_model, create_prior_models

    args = dict(case["args"])
    priors = create_prior_models(args) if args.get("prior_model") else None
    model = create_model(args, priors, device=device, seed=case.get("seed", 0))
    if case.get("state_dict") is not None:
        model.module.load_state_dict(case["state_dict"])
    if case.get("std") is not None:  # the output's scale (EnergyModel.std)
        model.module.std = float(case["std"])
    return model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernel_modules():
    from torchmdnet_tpu_torch.ops.kernels import et_message, t_message, tn_message

    return {"et_message": et_message, "t_message": t_message, "tn_message": tn_message}


def _launches():
    """The fused kernels' launches (each module's forward, backward, source
    passes and second order) and the cell list's selection launches."""
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    out = {}
    for name, km in _kernel_modules().items():
        for kind, fn in (("fwd", "run_fwd"), ("bwd", "run_bwd"), ("bwd_src", "bwd_source"), ("bwd2", "run_bwd2"),
                         ("bwd2_src", "bwd2_source")):
            if hasattr(km, fn):
                out[f"{name}_{kind}"] = getattr(km, fn).launches
    out["select_topk"] = select_topk.launches
    return {k: v for k, v in out.items() if v or k in ("et_message_fwd", "et_message_bwd", "et_message_bwd_src",
                                                      "select_topk")}


def _reset_launches():
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    for km in _kernel_modules().values():
        km.reset_launch_counts()
    select_topk.launches = 0


def force_loss(y, neg_dy, y_t, f_t, atom_mask, atoms):
    """A force-training loss of energies ``y`` (replicated under edge
    partitioning) and forces ``neg_dy`` (a rank's rows, or all of them):
    sum (y - y_t)^2 + (the sum over the valid rows of |neg_dy - f_t|^2) /
    ``atoms``, the global count of valid atoms."""
    err = ((neg_dy - f_t) ** 2).sum(dim=-1)
    return ((y - y_t) ** 2).sum() + torch.where(atom_mask, err, torch.zeros_like(err)).sum() / atoms


def third_derivative(loss, params, seed: int = 0):
    """A third derivative of ``loss`` (``force_loss``: once in the positions
    through the forces, quadratic in the replicated energy): the gradient
    over ``params`` of <the gradient of ``loss`` over ``params``, r>, with
    one seeded direction r a parameter (the same on every rank).  None
    where a parameter is not reached."""
    gen = torch.Generator().manual_seed(seed)
    r = [torch.randn(p.shape, generator=gen, dtype=p.dtype).to(p.device) for p in params]
    grads = torch.autograd.grad(loss, params, create_graph=True, allow_unused=True)
    probe = sum((g * d).sum() for g, d in zip(grads, r) if g is not None)
    return torch.autograd.grad(probe, params, allow_unused=True)


def _force_grads(case, model, sharded, ex, ctx, mesh):
    """The force-loss gradient (summed over the ranks) through the
    partitioned forces, its launches, and with ``case["third"]`` a third
    derivative of the same loss (``third_derivative``), summed over the
    ranks."""
    from torchmdnet_tpu_torch.parallel.distributed import sum_gradients
    from torchmdnet_tpu_torch.parallel.edge_partition import _rows

    dev = mesh.device
    y_t, f_t = (t.to(dev) for t in case["targets"])
    f_t = f_t[_rows(mesh, f_t.shape[0])]
    named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    atoms = float(case["batch"]["atom_mask"].sum())
    for p in params:
        p.grad = None
    _reset_launches()
    y, f = ex.energy_and_forces(sharded, ctx, create_graph=True)
    loss = force_loss(y, f, y_t, f_t, sharded.atom_mask, atoms)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    sum_gradients(mesh, params)
    _sync(dev)
    out = {"grads": {n: p.grad.detach().cpu() for n, p in named}, "grad_launches": _launches()}
    if case.get("third"):
        y, f = ex.energy_and_forces(sharded, ctx, create_graph=True)
        third = third_derivative(force_loss(y, f, y_t, f_t, sharded.atom_mask, atoms), params)
        for p, g in zip(params, third):
            p.grad = torch.zeros_like(p) if g is None else g
        sum_gradients(mesh, params)
        out["third"] = {n: p.grad.detach().cpu() for n, p in named}
    return out


def run_forces(case, mesh):
    from torchmdnet_tpu_torch.parallel.edge_partition import gather_atom_rows, ring_comm_stats, ring_potential

    dev = mesh.device
    model = _model(case, dev)
    batch = _batch(case["batch"], dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, sharded, (ex, ctx) = ring_potential(model, batch, mesh, boundary_capacity=case.get("boundary_capacity", 2048))
    _sync(dev)
    build_ms = 1e3 * (time.perf_counter() - t0)
    del batch
    out, ms = [], []
    for rep in range(case.get("repeat", 2)):
        _reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        y, f = ex.energy_and_forces(sharded, ctx)
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        if rep == 0:
            launches = _launches()
        out.append((y, f))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    y0, f0 = out[0]
    repeat_equal = all(torch.equal(y, y0) and torch.equal(f, f0) for y, f in out[1:])
    plan = ctx.nbl.transpose_perm
    h = model.args["embedding_dimension"]
    stats = ring_comm_stats(ctx.nbl.idx, ctx.nbl.mask, mesh, row_bytes=7 * h * 2, plan=plan)
    out = {
        "energy": y0.cpu(), "forces": gather_atom_rows(mesh, f0).cpu(), "repeat_bitwise": repeat_equal,
        "ms": ms, "build_ms": build_ms, "launches": launches, "peak_bytes": peak, "stats": stats._asdict(),
    }
    if case.get("targets") is not None:
        out.update(_force_grads(case, model, sharded, ex, ctx, mesh))
    return out


def run_md(case, mesh):
    from torchmdnet_tpu_torch.md import Simulation

    dev = mesh.device
    model = _model(case, dev)
    batch = _batch(case["batch"], dev)
    md = dict(case["md"])
    steps = md.pop("steps")
    vel_seed = md.pop("velocity_seed", None)
    sim = Simulation(model, batch, mesh=mesh, edge_partition=True, device=dev, **md)
    if vel_seed is not None:
        sim.set_velocities_from_temperature(md.get("temperature_K") or 300.0, seed=vel_seed)
    records = []
    if case.get("record"):
        from torchmdnet_tpu_torch.parallel.edge_partition import gather_atom_rows

        build, forces, built_at = sim._build_ctx, sim._forces_ring, []

        def build_recorded(pos):
            built_at.append(gather_atom_rows(mesh, pos).cpu())
            return build(pos)

        def forces_recorded(pos, ctx):
            y, f = forces(pos, ctx)
            records.append((built_at[-1], gather_atom_rows(mesh, pos).cpu(), gather_atom_rows(mesh, f).cpu()))
            return y, f

        sim._build_ctx, sim._forces_ring = build_recorded, forces_recorded
    _reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    state = sim.step(steps)
    _sync(dev)
    ms = 1e3 * (time.perf_counter() - t0) / steps
    return {"pos": sim.global_positions().cpu(), "energy": state.energy.cpu(), "stale": bool(state.stale),
            "ms_per_step": ms, "launches": _launches(), "records": records,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None}


def run_raises(case, mesh):
    from torchmdnet_tpu_torch.parallel.edge_partition import ring_apply

    dev = mesh.device
    model = _model(case, dev)
    try:
        ring_apply(model, _batch(case["batch"], dev), mesh, boundary_capacity=case.get("boundary_capacity", 2048))
    except Exception as e:  # the case records what was raised
        return {"raised": type(e).__name__, "message": str(e)}
    return {"raised": None, "message": ""}


def run_train(case, mesh):
    """``Trainer.fit`` with ``edge_partition`` (the rank's hyperparameters:
    case["hparams"] on the mesh's device, the log in case["log_dir"]): the
    first step's gradients (summed over the ranks; with case["jvp_grads"]
    also in ``force_grad_mode="jvp"``), rank 0's metrics.csv rows, the
    fit's seconds and its launches."""
    import csv
    import os

    from torchmdnet_tpu_torch.data.module import DataModule
    from torchmdnet_tpu_torch.models.potential import create_model
    from torchmdnet_tpu_torch.train.trainer import Trainer

    h = dict(case["hparams"], device=str(mesh.device), log_dir=case["log_dir"], edge_partition=True)
    data = DataModule(h, dataset=case["dataset"])
    data.setup()
    model = create_model(h, device=mesh.device, seed=h.get("seed", 1))
    recording, grads, jvp_grads = first_step_recorder(Trainer, jvp=case.get("jvp_grads", False))
    trainer = recording(model, h, mesh=mesh)
    _reset_launches()
    _sync(mesh.device)
    t0 = time.perf_counter()
    trainer.fit(data)
    _sync(mesh.device)
    seconds = time.perf_counter() - t0
    rows = None
    if mesh.rank == 0:
        with open(os.path.join(case["log_dir"], "metrics.csv")) as f:
            rows = [{k: float(v) for k, v in r.items() if v not in ("", None)} for r in csv.DictReader(f)]
    peak = torch.cuda.max_memory_allocated(mesh.device) if mesh.device.type == "cuda" else None
    return {"grads": grads, "jvp_grads": jvp_grads, "rows": rows, "seconds": seconds,
            "steps": trainer.state.global_step, "launches": _launches(), "peak_bytes": peak}


def first_step_recorder(trainer_class, jvp: bool = False):
    """(a subclass of ``trainer_class`` that records the first step's
    gradients, as {name: CPU tensor} in the second item; with ``jvp``, the
    same step's gradients in ``force_grad_mode="jvp"``, taken before it, in
    the third)."""
    grads, jvp_grads = {}, {}

    def record(trainer, into):
        into.update({n: p.grad.detach().cpu() for n, p in zip(trainer.param_names, trainer.params)})

    class Recording(trainer_class):
        def _train_step(self, batch, acc, ema_y, ema_f):
            if self.state.global_step == 0 and jvp:
                mode = self.h.get("force_grad_mode", "gradgrad")
                self.h["force_grad_mode"] = "jvp"
                self.step_gradients(batch, ema_y, ema_f)
                record(self, jvp_grads)
                self.h["force_grad_mode"] = mode
            return super()._train_step(batch, acc, ema_y, ema_f)

        def on_before_optimizer_step(self):
            if self.state.global_step == 0:
                record(self, grads)

    return Recording, grads, jvp_grads


def run_probe(case, mesh, seconds: float = 10.0):
    """Which collectives of the mesh's backend take CUDA tensors as they are
    (the port stages every collective through host copies under gloo): for
    each, "ok" with the right values, else what went wrong.  Each waits at
    most ``seconds``."""
    import datetime

    import torch.distributed as dist

    dev, d = mesh.device, mesh.size
    out = {}

    def attempt(name, start, check):
        try:
            works = start()
            for w in works if isinstance(works, list) else [works]:
                if w is not None:
                    w.wait(timeout=datetime.timedelta(seconds=seconds))
            _sync(dev)
            out[name] = "ok" if check() else "wrong values"
        except Exception as e:  # the probe records what the backend refuses
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160] if str(e) else ''}"

    a = torch.full((2 * d,), float(mesh.rank + 1), device=dev)
    attempt("all_reduce", lambda: dist.all_reduce(a, async_op=True), lambda: bool((a == d * (d + 1) / 2).all()))
    parts = [torch.empty(2, device=dev) for _ in range(d)]
    b = torch.full((2,), float(mesh.rank), device=dev)
    attempt("all_gather", lambda: dist.all_gather(parts, b, async_op=True),
            lambda: all(bool((p == i).all()) for i, p in enumerate(parts)))
    c = torch.full((2,), float(mesh.rank), device=dev)
    attempt("broadcast", lambda: dist.broadcast(c, 0, async_op=True), lambda: bool((c == 0).all()))
    e_in = torch.full((2 * d,), float(mesh.rank), device=dev)
    e_out = torch.empty(2 * d, device=dev)
    attempt("all_to_all_single", lambda: dist.all_to_all_single(e_out, e_in, async_op=True),
            lambda: bool((e_out == torch.arange(d, device=dev).repeat_interleave(2)).all()))
    # not probed: gloo's isend/irecv on CUDA tensors, which raised ("writev:
    # Bad address") or aborted the process on an H100 (the port uses neither)
    return out


RUNNERS = {"forces": run_forces, "md": run_md, "raises": run_raises, "probe": run_probe, "train": run_train}


def main(argv=None):
    from torchmdnet_tpu_torch.parallel.distributed import initialize_distributed, shutdown
    from torchmdnet_tpu_torch.parallel.mesh import make_mesh

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--spec", required=True)
    parser.add_argument("--out", required=True, help="output path; '{rank}' is replaced by the rank")
    args = parser.parse_args(argv)
    spec = torch.load(args.spec, weights_only=False)
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    device = spec.get("device")
    initialize_distributed(1, device=device)
    try:
        mesh = make_mesh(allow_single=True, device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        results = {}
        for case in spec["cases"]:
            results[case["name"]] = RUNNERS[case["kind"]](case, mesh)
        torch.save({"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend, "device": str(mesh.device),
                    "cases": results}, args.out.replace("{rank}", str(mesh.rank)))
    finally:
        shutdown()


if __name__ == "__main__":
    main()
