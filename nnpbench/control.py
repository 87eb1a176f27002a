"""The controls of the correctness check, at a cell's own size, on the
seeds given: the numbers that the limits in ``workloads/<cell>.json`` were
set between.

    python3 nnpbench/control.py --workload et-md-calls --seeds 1 2 3
    python3 nnpbench/control.py --workload et-md-calls --seeds 1 2 3 --program --seconds 10

prints one JSON line a seed.  Each stand-in is the reference put in the
program's place, at the walk's first call and at its
``checked_calls_within``-th, as a run compares two calls; its forces are
held against float32's by the check's own numbers:

- ``fp8``: the edge phase rounded through float8 (e4m3), the precision
  below the bfloat16 the configuration states for it: the control;
- ``tf32``: the edge phase in bfloat16 as stated, the float32 parts' matrix
  products in TF32, the precision below float32 with TF32 off;
- ``bf16_node``: the same with the float32 parts' products in bfloat16;
- ``bf16``: the edge phase in bfloat16 as the port rounds it, the rest in
  float32 (the configuration's own precision).

``--program`` reads the program's own runs instead (the harness's run with
a short window, every seed in this one process): the readings a limit's
lower end is set from.  The benchmark's own runs run none of this.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from nnpbench import harness  # noqa: E402

STAND_INS = {"fp8": (torch.float8_e4m3fn, None), "tf32": (torch.bfloat16, "tf32"),
             "bf16_node": (torch.bfloat16, torch.bfloat16), "bf16": (torch.bfloat16, None)}


def calls_numbers(cell, stand_in="fp8"):
    """The calls cell's numbers for the stand-in ``stand_in`` (a key of
    ``STAND_INS``) in the program's place."""
    from nnpbench.drivers import calls
    from nnpbench.reference import et as ref
    from nnpbench.reference import weights

    walk = calls.Walk(cell.traffic, cell.seed, cell.device)
    positions = [walk.next()]
    for _ in range(cell.traffic["checked_calls_within"] - 1):
        walk.next()
    positions.append(walk.pos)
    sd = weights.fill(ref.build(cell.model_args, cell.device, std=cell.config.get("energy_std", 1.0)),
                      cell.seed).state_dict()
    c = dict(z=walk.z, side=walk.side, weights=sd, calls=[(pos, None) for pos in positions])
    edge, node = STAND_INS[stand_in]
    forces = calls.truth_of(cell, c, edge, node)
    c["calls"] = [(pos, f) for pos, f in zip(positions, forces)]
    return calls.gaps(c, calls.truth_of(cell, c))


def cell_of(name, seed, tmpdir):
    entry = {w["name"]: w for w in harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]}[name]
    workload, traffic, config = harness.load_cell_files(ROOT, entry)
    return harness.Cell(name=name, seed=seed, seconds=0.0, trace=False, workload=workload, traffic=traffic,
                        config=config, chips=entry["chips"], device=torch.device("cuda", 0), tmpdir=tmpdir)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--stand-ins", nargs="+", default=list(STAND_INS), choices=list(STAND_INS))
    p.add_argument("--program", action="store_true", help="the program's runs instead of the stand-ins")
    p.add_argument("--seconds", type=float, default=10.0, help="the window of --program's runs")
    args = p.parse_args(argv)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="nnpbench-control-") as tmpdir:
            cell = cell_of(args.workload, seed, tmpdir)
            rows = {}
            if args.program:
                result = harness.run(dataclasses.replace(cell, seconds=args.seconds), bench, ROOT, time.perf_counter())
                rows["program"] = {k: v["value"] for k, v in result["checks"].items()}
                rows["steps"] = result["attempted"]
            else:
                for name in args.stand_ins:
                    rows[name] = calls_numbers(cell, name)
            print(json.dumps({"workload": args.workload, "seed": seed, **rows}), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
