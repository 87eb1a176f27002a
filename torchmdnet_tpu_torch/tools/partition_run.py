"""One rank of an edge-partitioned run, driven by a spec file.

    python -m torchmdnet_tpu_torch.tools.partition_run --spec spec.pt --out out.pt

Started once per rank (``parallel.distributed.launch`` sets ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE`` and the coordinator), each rank joins the process
group, builds the same models and global batches from the spec
(``torch.save`` of a dict) and runs its cases:

- ``forces``: ``ring_potential`` once, then ``repeat`` partitioned
  energy+forces calls (bitwise repeatability, wall time, the ET kernels'
  and the cell list's selection launches per call, the rank's peak device memory, its exchange
  statistics); the forces of every rank are gathered;
- ``md``: ``Simulation(mesh, edge_partition=True)`` for ``steps`` steps; the
  positions of every rank are gathered, with ``stale``; with ``record``,
  every force evaluation's positions and forces (gathered) and the positions
  its list was built at, so that a single-process evaluation on the same
  list can be held against each;
- ``raises``: a call that must raise (``overflow``: a boundary capacity too
  small; ``trainer``: ``--edge-partition`` training; ``fused``: a fused
  Transformer or TensorNet under partitioning); the exception is recorded;
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


def _launches():
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    return {"et_message_fwd": em.run_fwd.launches, "et_message_bwd": em.run_bwd.launches,
            "et_message_bwd_src": em.bwd_source.launches, "select_topk": select_topk.launches}


def _reset_launches():
    from torchmdnet_tpu_torch.ops.kernels import et_message as em
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    em.reset_launch_counts()
    select_topk.launches = 0


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
    return {
        "energy": y0.cpu(), "forces": gather_atom_rows(mesh, f0).cpu(), "repeat_bitwise": repeat_equal,
        "ms": ms, "build_ms": build_ms, "launches": launches, "peak_bytes": peak, "stats": stats._asdict(),
    }


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
    from torchmdnet_tpu_torch.train.trainer import Trainer

    dev = mesh.device
    model = _model(case, dev)
    what = case["what"]
    try:
        if what == "trainer":
            Trainer(model, dict(model.args, edge_partition=True, log_dir=case.get("log_dir", "/tmp/logs")),
                    mesh=mesh)
        else:
            ring_apply(model, _batch(case["batch"], dev), mesh, boundary_capacity=case.get("boundary_capacity", 2048))
    except Exception as e:  # the case records what was raised
        return {"raised": type(e).__name__, "message": str(e)}
    return {"raised": None, "message": ""}


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


RUNNERS = {"forces": run_forces, "md": run_md, "raises": run_raises, "probe": run_probe}


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
