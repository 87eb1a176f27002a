"""Time the fused ET forward (#1), backward (#2) with and without weight
cotangents and second order (#3), the Transformer's (#11-#13) and
TensorNet's (#8-#10), for the port in a given checkout.

    python3 torchmdnet_tpu_torch/tools/time_bwd.py [--tree DIR] [--label NAME] [--dump DIR] [--shapes A,B]
    python3 torchmdnet_tpu_torch/tools/time_bwd.py --compare DIR LABEL_A LABEL_B

``--tree`` names the root of a checkout whose ``torchmdnet_tpu_torch`` is
imported and built (default: the checkout holding this file), so that two
commits (or two builds of one kernel source) are timed on one card back to
back, one process each, in the order parent, change, change, parent.  The
operands are chip_smoke.py's (the chip_smoke.py beside this package): the
DHFR shapes (N = 2496, K = 81, H = 128, RBF = 50) and the training shapes
(N = 2304, K = 33, H = 256, RBF = 64, a batch of 128 SyntheticMorse
molecules, drawn with this checkout's package, so that a tree without the
datasets is timed on the same batch), and #1 and #2 without weight
cotangents at ET MD's STMV skin list (N = 30,336, K = 112, H = 128, RBF =
50).  The Transformer's operands are chip_smoke.py's too
(``_t_kernel_inputs``): #12 with and without weight cotangents at DHFR (K =
81, H = 128, RBF = 50), #12 with weight cotangents and #13 at the training
shapes.  TensorNet's (``_tn_system``, ``_tn_kernel_inputs``): #8 and #9
without weight cotangents at DHFR (N = 2496, K = 65, H = 128, RBF = 32);
#8, #9 without and with them (the edge kernel, then with its weight
reduction), the reduction alone where the tree has one
(``bwd_rows``, the edge kernel apart from it), and #10 at the
TensorNet-ANI1X training shapes (64 molecules of 18 atoms, K = 33), with
each of its kernels' device time apart (the edge kernel, the source-row
sum, the weight reduction; torch.profiler, mean of 20).  ``topk`` is #6
at each cell-list build a path runs (chip_smoke.py's ``select_cases``:
the DHFR builds of External's models, GN's STMV forward, the STMV skin
build of MD).  ``ell`` is the ELL gather #4 and transpose-sum #5 (F = 128)
at each shape a GN path runs them (chip_smoke.py's ``_gn_lists``: DHFR,
the STMV skin list, the STMV forward's K = 32 list, #4 only, and a
GN-aspirin training batch), each with its library call (``index_select``,
``index_add_``), timed three ways: CUDA events as below, the device time
alone (torch.profiler, mean of 20, L2 flushed) and the host's enqueue
(host clock without a synchronise, median of 200).  ``compaction`` is
the fused brute search #7 at chip_smoke.py's ``compaction_shapes`` (the
DHFR row shape, K 80 without the loop, and the Transformer MD build's, K
112 at 5.5 A with the self loop) on the synthetic DHFR system: the
kernel's wrapper (with the loop where the tree's takes one) and the whole
``neighbor_list(strategy="brute-pallas")`` build, each timed those three
ways, the device time that of ``compact_kernel`` alone, beside the time
and launches of the call's other kernels.  ``md_stmv``
is chip_smoke.py's ET MD at STMV size in bench.py's configuration
(``MD_ARGS``) through the tree's ``Simulation``: after its warm-up, three
windows of ``MD_TIMED_STEPS`` steps, each a mean ms/step on the host clock
with the card synchronised.  Prints the card's name and power limit, then one
JSON line of CUDA-event medians of 20 launches (5 at STMV) with the L2
flushed.  ``--dump DIR`` also saves one
call's outputs per shape and kernel (the forwards #1, #8 and #11, the
selections and #4/#5 too) to DIR/LABEL.pt; ``--compare DIR A B``
then prints, per output, whether two labels' outputs are bitwise equal and
their largest difference over the largest value.  ``--shapes`` times only
the named shapes (dhfr, train, stmv, t_dhfr, t_train, tn_dhfr, tn_train, md_stmv, topk,
ell, compaction).  Needs a CUDA device (``--compare`` does not).
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Time the port's fused edge kernels and the cell list's selection.")
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default=None, help="name printed with the result")
    ap.add_argument("--dump", default=None, help="directory for one call's outputs per shape")
    ap.add_argument("--compare", nargs=3, metavar=("DIR", "A", "B"), help="compare two dumps")
    ap.add_argument("--shapes", default=None, help="comma-separated shapes to time (default: all)")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    tree = os.path.abspath(args.tree)
    here = os.path.dirname(os.path.abspath(__file__))
    rest = [p for p in sys.path if os.path.abspath(p or os.curdir) != here]
    cs = _chip_smoke()
    # the training molecules from this checkout's datasets, then the tree's package
    sys.path[:] = [ROOT] + rest
    train_ds = cs._train_dataset()
    train_mols = [train_ds[i] for i in range(cs.TRAIN_BATCH)]
    tn_ds = cs._train_dataset(cs.TN_TRAIN_SPLIT)
    tn_mols = [tn_ds[i] for i in range(cs.TN_TRAIN_BATCH)]
    for name in [m for m in sys.modules if m.split(".")[0] == "torchmdnet_tpu_torch"]:
        del sys.modules[name]
    sys.path[:] = [tree] + rest

    if not torch.cuda.is_available():
        print("time_bwd: no CUDA device", file=sys.stderr)
        return 1
    import torchmdnet_tpu_torch
    from torchmdnet_tpu_torch.ops.kernels import build
    from torchmdnet_tpu_torch.ops.kernels import et_message as em

    if not os.path.abspath(torchmdnet_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {torchmdnet_tpu_torch.__file__}, not the package under {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    build.build()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    a = cs.TRAIN_ARGS
    shapes = {
        "dhfr": dict(n_atoms=2489, k=80, h=128, heads=8, rbf=50, cutoff=5.0, batch=None),
        "train": dict(n_atoms=None, k=a["max_num_neighbors"], h=a["embedding_dimension"],
                      heads=a["num_heads"], rbf=a["num_rbf"], cutoff=a["cutoff_upper"],
                      batch=cs._train_batch(train_mols, "cuda")),
        "stmv": dict(heads=cs.ET_ARGS["num_heads"]),
        "t_dhfr": dict(n_atoms=2489, k=cs.T_ARGS["max_num_neighbors"], h=128, heads=8, rbf=50, cutoff=5.0,
                       batch=None),
        "t_train": dict(n_atoms=None, k=cs.T_TRAIN_ARGS["max_num_neighbors"], h=a["embedding_dimension"],
                        heads=a["num_heads"], rbf=a["num_rbf"], cutoff=a["cutoff_upper"],
                        batch=cs._train_batch(train_mols, "cuda")),
        "tn_dhfr": dict(system="DHFR"),
        "tn_train": dict(system=cs._train_batch(tn_mols, "cuda", cs.TN_TRAIN_BATCH,
                                                cs.TN_TRAIN_ARGS["cutoff_upper"])),
        "md_stmv": {},
        "topk": {},
        "ell": {},
        "compaction": {},
    }
    label = args.label or tree
    result = dict(label=label, tree=tree)
    dumped = {}
    only = set(args.shapes.split(",")) if args.shapes else set(shapes)
    for name, s in shapes.items():
        if name not in only:
            continue
        if name == "md_stmv":
            result[name] = _time_md(cs)
            torch.cuda.empty_cache()
            continue
        if name in ("ell", "compaction"):
            timer = {"ell": _time_ell, "compaction": _time_compaction}
            result[name] = timer[name](cs, flush, dumped if args.dump else None)
            torch.cuda.empty_cache()
            continue
        if name == "topk":
            result[name], calls = _time_topk(cs, flush)
            if args.dump:
                for k, fn in calls.items():
                    dumped[f"{name}/{k}"] = _flat_cpu(fn())
            del calls
            torch.cuda.empty_cache()
            continue
        if name.startswith("t_") or name.startswith("tn_"):
            row, calls = (_time_t if name.startswith("t_") else _time_tn)(cs, name, s, flush)
            result[name] = row
            if args.dump:
                for k, fn in calls.items():
                    dumped[f"{name}/{k}"] = _flat_cpu(fn())
            del calls
            torch.cuda.empty_cache()
            continue
        if name == "stmv":
            nbl, ins, cts = cs._stmv_kernel_inputs(cs.SEED)
        else:
            nbl, ins, cts = cs._kernel_inputs(s["n_atoms"], s["k"], s["h"], s["rbf"], s["cutoff"], cs.SEED,
                                              batch=s["batch"])
        kw = dict(heads=s["heads"], act="silu", attn_act="silu")
        ops = [ins[x] for x in ("q", "k", "v", "vec0", "vec1", "vec2", "ea", "cutm", "msk")]
        dirs = (ins["dir0"], ins["dir1"], ins["dir2"])
        w = [ins[x] for x in ("wdk", "bdk", "wdv", "bdv")]

        def bwd(want):
            return lambda: em.run_bwd(nbl.idx, nbl.transpose_perm, *ops, dirs, *w, cts[0], cts[1],
                                      want_weight_grads=want, **kw)

        def bwd2():
            z = cs._z_like(ins, cs.SEED)
            return lambda: em.run_bwd2(nbl.idx, nbl.transpose_perm, [ins[x] for x in cs.ORDER], cts, z, **kw)

        if name == "stmv":  # MD freezes the weights: no weight cotangents, no second order
            calls = dict(fwd=lambda: em.run_fwd(nbl.idx, *ops, dirs, *w, **kw), bwd=bwd(False))
            row = {f"{k}_ms": cs.profiling.event_ms(fn, flush=flush, reps=5) for k, fn in calls.items()}
        else:
            calls = dict(fwd=lambda: em.run_fwd(nbl.idx, *ops, dirs, *w, **kw), bwd=bwd(False),
                         bwd_weights=bwd(True))
            if hasattr(em, "run_bwd2"):
                calls["bwd2"] = bwd2()
            row = {f"{k}_ms": cs.profiling.event_ms(fn, flush=flush) for k, fn in calls.items()}
        result[name] = row
        if args.dump:
            for k, fn in calls.items():
                dumped[f"{name}/{k}"] = _flat_cpu(fn())
        del nbl, ins, cts, calls
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
        torch.save(dumped, os.path.join(args.dump, f"{label}.pt"))
    return 0


def _time_t(cs, name, s, flush):
    """The Transformer's #11, #12 (with and without weight cotangents at
    DHFR, with them at training) and #13 (training): ({kernel_ms: median},
    the calls)."""
    from torchmdnet_tpu_torch.ops.kernels import t_message as tmk

    nbl, ins, ct = cs._t_kernel_inputs(s["n_atoms"], s["k"], s["h"], s["rbf"], s["cutoff"], cs.SEED,
                                       batch=s["batch"])
    kw = dict(heads=s["heads"], act="silu", attn_act="silu")
    args = [ins[x] for x in cs.T_ORDER]
    idx, perm = nbl.idx, nbl.transpose_perm

    def bwd(want):
        return lambda: tmk.run_bwd(idx, perm, *args, ct, want_weight_grads=want, **kw)

    calls = dict(fwd=lambda: tmk.run_fwd(idx, *args, **kw))
    if name == "t_dhfr":
        calls.update(bwd=bwd(False), bwd_weights=bwd(True))
    else:
        z = cs._t_z_like(ins, cs.SEED)
        calls.update(bwd_weights=bwd(True), bwd2=lambda: tmk.run_bwd2(idx, perm, args, ct, z, **kw))
    return {f"{k}_ms": cs.profiling.event_ms(fn, flush=flush) for k, fn in calls.items()}, calls


def _time_tn(cs, name, s, flush):
    """TensorNet's #8 and #9 (frozen weights) at DHFR; #8, #9 without and
    with weight cotangents, #9's reduction alone (where the tree has
    ``bwd_rows``) and #10 at the training shapes: ({kernel_ms: median}, the
    calls)."""
    from torchmdnet_tpu_torch.ops.kernels import tn_message as tm

    h, rbf = cs.TN_ARGS["embedding_dimension"], cs.TN_ARGS["num_rbf"]
    nbl, pos, box = cs._tn_system(s["system"], cs.SEED)
    ins, ct = cs._tn_kernel_inputs(nbl, pos, h, rbf, cs.TN_ARGS["cutoff_upper"], cs.SEED, box=box)
    args = [ins[x] for x in cs.TN_ORDER]
    idx, perm = nbl.idx, nbl.transpose_perm

    def bwd(want):
        return lambda: tm.run_bwd(idx, *args, ct, act="silu", want_weight_grads=want)

    if name == "tn_dhfr":
        calls = dict(fwd=lambda: tm.run_fwd(idx, *args, act="silu"), bwd=bwd(False))
        return {f"{k}_ms": cs.profiling.event_ms(fn, flush=flush) for k, fn in calls.items()}, calls
    z = cs._tn_z_like(ins, cs.SEED)
    calls = dict(fwd=lambda: tm.run_fwd(idx, *args, act="silu"), bwd=bwd(False), bwd_weights=bwd(True),
                 bwd2=lambda: tm.run_bwd2(idx, perm, args, ct, z, act="silu"))
    row = {f"{k}_ms": cs.profiling.event_ms(fn, flush=flush) for k, fn in calls.items()}
    if hasattr(tm, "bwd_rows"):  # the reduction alone, on the rows of one backward
        row["bwd_reduction_ms"] = cs._tn_pass_split(idx, args, ct, flush)["reduction (et_dw_kernel)"]
    # #10 kernel by kernel (device time from the profiler, mean of 20)
    row.update({f"bwd2_{k}_ms": v for k, v in cs._tn_bwd2_split(idx, perm, args, ct, z, flush).items()})
    return row, calls


def _time_topk(cs, flush):
    """#6 at each cell-list build a path runs (chip_smoke.py's
    ``select_cases``: the DHFR builds at 5 and 4.5 A, GN's STMV forward
    and the STMV skin build): ({label_ms: median}, the calls)."""
    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS
    from torchmdnet_tpu_torch.ops.kernels.select_topk import select_topk

    stmv = cs._stmv_batch()
    keys, k, _ = cs.stmv_skin_keys(stmv)
    cases, _ = cs.select_cases(cs._synthetic_batch(DHFR_ATOMS, cs.SEED, "cuda")[2], stmv, keys, k)
    calls = {label: (lambda c=c: select_topk(*c)) for label, c in cases.items()}
    return {f"{label}_ms": cs.profiling.event_ms(fn, flush=flush) for label, fn in calls.items()}, calls


def _time_ell(cs, flush, dumped=None):
    """#4 and #5 at each shape of chip_smoke.py's ``_gn_lists``, with their
    library calls: {shape/kind: {event, device and enqueue ms}}; each
    kernel's output into ``dumped`` where given."""
    row = {}
    for where, shape, calls in cs.ell_cases(cs._gn_lists()):
        for kind, (kern, _, lib) in calls.items():
            row[f"{where}/{kind}"] = dict(
                shape=shape, ms=cs.profiling.event_ms(kern, flush=flush), device_ms=cs.profiling.device_ms(kern, flush),
                enqueue_ms=cs.profiling.enqueue_ms(kern), library_ms=cs.profiling.event_ms(lib, flush=flush),
                library_device_ms=cs.profiling.device_ms(lib, flush), library_enqueue_ms=cs.profiling.enqueue_ms(lib))
            if dumped is not None:
                dumped[f"ell/{where}/{kind}"] = _flat_cpu(kern())
    return row


def _time_compaction(cs, flush, dumped=None):
    """#7 at chip_smoke.py's ``compaction_shapes``: the kernel's wrapper and
    the whole brute-pallas build, {shape/call: three-way times}; each
    call's output into ``dumped`` where given."""
    import inspect

    from torchmdnet_tpu_torch.data.systems import DHFR_ATOMS
    from torchmdnet_tpu_torch.ops.kernels.compaction import compact_neighbors
    from torchmdnet_tpu_torch.ops.neighbors import neighbor_list

    batch = cs._synthetic_batch(DHFR_ATOMS, cs.SEED, "cuda")[2]
    args = (batch.pos, batch.batch, batch.atom_mask)
    takes_loop = "loop" in inspect.signature(compact_neighbors).parameters
    row = {}
    for where, s in cs.compaction_shapes().items():
        kw = {key: s[key] for key in ("k", "cutoff_lower", "cutoff_upper")}
        kern_kw = dict(kw, loop=s["loop"]) if takes_loop else kw
        calls = dict(kernel=lambda: compact_neighbors(*args, **kern_kw),
                     build=lambda: neighbor_list(*args, loop=s["loop"], strategy="brute-pallas", **kw))
        for what, fn in calls.items():
            loop = s["loop"] and (what == "build" or takes_loop)
            row[f"{where}/{what}"] = dict(cs._three_ways(fn, flush, "compact_kernel"), k=s["k"], loop=loop)
            if dumped is not None:
                out = fn()
                dumped[f"compaction/{where}/{what}"] = _flat_cpu(
                    (out.idx, out.mask, out.n_neighbors) if what == "build" else out)
    return row


def _time_md(cs, windows=3):
    """ET MD at STMV size (chip_smoke.py's md_stmv configuration): ms/step
    of each timed window and their median."""
    import statistics
    import time

    from torchmdnet_tpu_torch import Simulation, create_model

    sim = Simulation(create_model(cs.ET_ARGS, seed=cs.SEED), cs._stmv_batch(), seed=cs.SEED, **cs.MD_ARGS)
    sim.set_velocities_from_temperature(300.0)
    every = cs.MD_ARGS["rebuild_every"]
    for _ in range(cs.MD_WARMUP_STEPS // every):
        sim.step(every)
    ms = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cs.MD_TIMED_STEPS // every):
            sim.step(every)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / cs.MD_TIMED_STEPS)
    return {"ms_per_step": ms, "median_ms_per_step": statistics.median(ms)}


def _flat_cpu(out):
    """A call's outputs as a flat list of CPU tensors (None kept)."""
    if isinstance(out, torch.Tensor):
        return [out.detach().cpu()]
    flat = []
    for o in out:
        if isinstance(o, (tuple, list)):
            flat.extend(_flat_cpu(o))
        else:
            flat.append(None if o is None else o.detach().cpu())
    return flat


def compare(directory, a, b):
    """Per shape, kernel and output: bitwise equal, or max|a - b| / max|b|."""
    da = torch.load(os.path.join(directory, f"{a}.pt"))
    db = torch.load(os.path.join(directory, f"{b}.pt"))
    for key in sorted(set(da) & set(db)):
        parts = []
        for i, (x, y) in enumerate(zip(da[key], db[key])):
            if x is None or y is None:
                continue
            if x.shape != y.shape:
                parts.append(f"{i}: shapes {tuple(x.shape)} and {tuple(y.shape)}")
            elif torch.equal(x, y):
                parts.append(f"{i}: equal")
            else:
                diff = (x.double() - y.double()).abs()
                parts.append(f"{i}: {float(diff.max() / y.double().abs().max().clamp_min(1e-300)):.2e} "
                             f"({int((diff > 0).sum())} of {y.numel()} differ)")
        print(f"{key} {a} vs {b}: " + ", ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
